"""Host ms a generation enqueuing the launch and the fitness reduction and waiting for their readback (PhaseClock launch + fitness_reduce + readback)."""
from perfbench import readers


def read(run):
    return readers.phase_ms(run, ("launch", "fitness_reduce", "readback"), "generations")
