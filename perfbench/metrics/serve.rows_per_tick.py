"""Rows served a tick."""
from perfbench import readers


def read(run):
    return readers.per(run.counters.get("rows", 0), run.counters.get("ticks", 0))
