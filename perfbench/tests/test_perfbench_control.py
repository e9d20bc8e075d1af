"""The control: the reference in the precision below the configuration's, put
in the program's place on the same sample, comes out as not correct, while
the program's own run is correct (the card's readings are in `PERF.md`).

The seeds are ones whose drawn circuits read a continuous feature: a circuit
that reads only the bucketed integer columns encodes exactly in bfloat16, and
there the control has nothing to get wrong."""
import time

import pytest

from perfbench import harness
from perfbench.tests.conftest import MIXES, SMALL


@pytest.mark.parametrize("workload", ["higgs.search", "higgs.serve"])
@pytest.mark.parametrize("seed", [11, 2**31 + 3])
def test_control_fails_where_the_program_passes(workload, seed):
    cell = harness.mix_cell(*MIXES[workload], SMALL)
    run = harness.driver(cell).run(harness.Context(cell, seed, 1.0, False, "cpu", time.perf_counter()))
    assert run.correct, run.checks
    control = run.control()
    assert any(c["value"] > c["limit"] for c in control.values()), control
