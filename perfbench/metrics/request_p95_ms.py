"""95th percentile of the latency of every request due in the window, from its due time."""
from perfbench import readers


def read(run):
    return readers.p95_ms(run.latencies_s)
