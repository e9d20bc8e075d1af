"""Generations completed in the window, over all its searches, a second."""
from perfbench import readers


def read(run):
    return readers.per(run.counters.get("generations", 0), run.window_s)
