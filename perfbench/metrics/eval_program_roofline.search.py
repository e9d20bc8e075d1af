"""Per cent of its roofline that eval_program_kernel reaches over the search window's launches."""
from perfbench import readers


def read(run):
    return readers.roofline_pct(run)
