"""Host ms a tick in the device phases: the copy in, the launch and the readback (ServerStats phase totals)."""
from perfbench import readers


def read(run):
    return readers.phase_ms(run, ("device_put", "launch", "readback"), "ticks")
