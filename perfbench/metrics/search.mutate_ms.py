"""Host ms a generation in mutation and selection (PhaseClock mutate + host_select)."""
from perfbench import readers


def read(run):
    return readers.phase_ms(run, ("mutate", "host_select"), "generations")
