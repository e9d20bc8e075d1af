"""Per cent of the traced window in which nothing ran on the card."""
from perfbench import readers


def read(run):
    return readers.idle_share_pct(run)
