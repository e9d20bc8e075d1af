"""Every traffic mix, and the table under it, is a function of the seed."""
import numpy as np

from perfbench import harness, tabular
from perfbench.drivers import common, search, serve_open
from perfbench.tests.conftest import SMALL

SEED = 2**31 + 977


def test_table_is_deterministic_in_the_seed():
    a = tabular.make_table("clickpred", 5000, 10, 2, SEED)
    b = tabular.make_table("clickpred", 5000, 10, 2, SEED)
    c = tabular.make_table("clickpred", 5000, 10, 2, SEED + 1)
    assert all(np.array_equal(u, v) for u, v in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert a[0].shape == (5000, 10) and a[0].dtype == np.float32 and set(a[1]) <= {0, 1}


def schedule(seed):
    cell = harness.mix_cell("higgs", "serve_open", SMALL)
    return serve_open.schedule(cell.traffic, 500.0, 4.0, tabular.rng_for(seed, 12), 3000)


def test_open_loop_schedule_is_the_seeds_order_of_one_workload():
    a, b, c = schedule(SEED), schedule(SEED), schedule(SEED + 1)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["tenant"], c["tenant"])
    # every seed offers the same gaps, sizes and tenants, in its own order
    for k in ("rows", "tenant"):
        np.testing.assert_array_equal(np.sort(a[k]), np.sort(c[k]))
    ga, gc = np.sort(np.diff(a["due"])), np.sort(np.diff(c["due"]))
    q = [0.1, 0.5, 0.9]
    np.testing.assert_allclose(np.quantile(ga, q), np.quantile(gc, q), rtol=1e-2)
    assert abs(ga.sum() - gc.sum()) < ga.max()
    n = len(a["due"])
    assert n == 2000 and a["due"][0] == 0 and a["due"][-1] < 4.0
    assert np.all(np.diff(a["due"]) > 0)
    assert a["rows"].min() >= 1 and a["rows"].max() <= 3000
    assert np.all(a["offset"] + a["rows"] <= 3000)
    counts = np.bincount(a["tenant"], minlength=10)
    assert np.all(np.diff(counts) <= 0)            # Zipf: the first tenant most popular
    assert abs(np.median(a["rows"]) - 64) <= 2


def test_search_streams_and_sample_are_deterministic_in_the_seed():
    cell = harness.mix_cell("higgs", "search", SMALL)
    ctx = harness.Context(cell, SEED, 1.0, False, "cpu", 0.0)
    other = harness.Context(cell, SEED + 1, 1.0, False, "cpu", 0.0)
    assert search._split_seed(ctx) == search._split_seed(ctx) != search._split_seed(other)
    assert search._torch_seed(ctx, 3) == search._torch_seed(ctx, 3) != search._torch_seed(ctx, 2)
    draws = []
    for _ in range(2):
        r = common.Reservoir(4, common.rng(ctx, 4), draws=64)
        for i in range(100):
            r.offer(i)
        draws.append(r.items)
    assert draws[0] == draws[1] and len(set(draws[0])) == 4


def test_served_circuits_are_deterministic_in_the_seed():
    cfg = harness.mix_cell("higgs", "serve_open", SMALL).config
    a = common.seeded_genome(tabular.rng_for(SEED, 11), 116, cfg)
    b = common.seeded_genome(tabular.rng_for(SEED, 11), 116, cfg)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    hi = 116 + np.arange(cfg["n_gates"])
    assert np.all(a["edge_src"] < hi[:, None]) and np.all(a["edge_src"] >= 0)
    assert a["out_src"].tolist() == [116 + cfg["n_gates"] - 1]
