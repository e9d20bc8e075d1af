"""Per cent of the card's INT32 logic peak that the window's launches needed, over the traced window."""
from perfbench import readers


def read(run):
    return readers.mfu_pct(run)
