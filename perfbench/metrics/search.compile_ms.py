"""Host ms a generation compiling live-gate programs and copying them to the card (PhaseClock compile + program_h2d)."""
from perfbench import readers


def read(run):
    return readers.phase_ms(run, ("compile", "program_h2d"), "generations")
