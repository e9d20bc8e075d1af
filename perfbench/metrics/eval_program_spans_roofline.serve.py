"""Per cent of its roofline that eval_program_spans_kernel reaches over the serving window's launches."""
from perfbench import readers


def read(run):
    return readers.roofline_pct(run)
