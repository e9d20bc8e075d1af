"""Host ms a tick in encode, pack and decode (ServerStats phase totals)."""
from perfbench import readers


def read(run):
    return readers.phase_ms(run, ("encode", "pack", "decode"), "ticks")
