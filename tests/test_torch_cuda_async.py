"""The async front end and the autoscale controller on the card.

Marked ``cuda``: each test skips when no CUDA device is present (decided
inside the fixture, never at import).  This file imports neither JAX nor
the reference package, so it runs where only torch is installed; its
registry is `chip_smoke.py`'s serving registry (the golden bundles, a
nomao-width tenant, six synthetic tenants and a 3-member ensemble):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_async.py

Every comparison of ids is exact, against each tenant's members'
``predict`` on the card.
"""
import asyncio

import numpy as np
import pytest
import torch

from chip_smoke import build_registry, golden
from repro_torch.kernels import circuit_eval
from repro_torch.serve.async_frontend import AsyncCircuitServer
from repro_torch.serve.autoscale import AutoscaleController, HysteresisPolicy
from repro_torch.serve.circuits import CircuitServer, TenantQoS
from repro_torch.serve.planning import PlacementPolicy, ensemble_vote

LAZY = TenantQoS(max_batch=10**6, max_wait_s=100.0, default_deadline_s=1.0)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def timed_steps(server, clock, latency_s=0.004):
    """Each step (one fire) advances the fake clock by ``latency_s``: the
    wall time the scheduler's latency EWMAs observe."""
    step = server.step

    def timed(work):
        out = step(work)
        clock.t += latency_s
        return out

    server.step = timed


@pytest.fixture(scope="module")
def stack():
    """The serving registry and its request rows (made once per module,
    on the CPU; each test builds its own servers)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    reg, sources = build_registry(golden())
    for t in reg:
        reg.set_qos(t, LAZY)
    return reg, sources


def _want(reg, tenant, x):
    ms = reg.members(tenant)
    return ensemble_vote(np.stack([m.predict(x, device="cuda") for m in ms]), ms[0].n_classes)


def _spans():
    return circuit_eval.EVAL_POPULATION_SPANS.launches


@pytest.mark.cuda
def test_frontend_on_the_card_matches_predict(stack):
    reg, sources = stack
    clock = FakeClock()
    fe = AsyncCircuitServer(CircuitServer(reg, device="cuda"), clock=clock)
    futs = {t: fe.enqueue(t, sources[t][0][:40], deadline_s=1.0) for t in reg}
    assert not fe.pump().batch
    clock.t = 0.999
    before = _spans()
    d = fe.pump()
    assert d.reason == "deadline" and len(d.batch) == len(futs)
    assert _spans() == before + 1  # one shard with work, one launch
    for t, fut in futs.items():
        np.testing.assert_array_equal(fut.result(0), _want(reg, t, sources[t][0][:40]))
        gold = sources[t][1]
        if gold is not None:
            np.testing.assert_array_equal(fut.result(0), gold[:40])
    rep = fe.stats.report()
    assert rep["backend"] == "cuda" and rep["miss_rate"] == 0.0 and rep["fires"] == 1


@pytest.mark.cuda
def test_each_fire_launches_once_per_shard_with_work(stack):
    reg, sources = stack
    clock = FakeClock()
    server = CircuitServer(reg, device="cuda", policy=PlacementPolicy(n_shards=2))
    fe = AsyncCircuitServer(server, clock=clock)
    plan = server.plan()
    one_shard = [t for t in reg if {r.shard for r in plan.placement[t]} == {0}]
    rounds = [one_shard[:2], list(reg)]
    for r, tenants in enumerate(rounds):
        clock.t = 10.0 * r
        futs = {t: fe.enqueue(t, sources[t][0][:25], deadline_s=1.0) for t in tenants}
        clock.t += 0.999
        busy = {ref.shard for t in tenants for ref in plan.placement[t]}
        before, fired = _spans(), sum(fe.stats.shard_fires.values())
        fe.pump()
        assert _spans() - before == len(busy) == sum(fe.stats.shard_fires.values()) - fired
        for t, fut in futs.items():
            np.testing.assert_array_equal(fut.result(0), _want(reg, t, sources[t][0][:25]))


@pytest.mark.cuda
def test_controller_grows_on_the_card_with_an_explicit_device_cap(stack):
    reg, sources = stack
    clock = FakeClock()
    server = CircuitServer(reg, device="cuda")
    timed_steps(server, clock)
    fe = AsyncCircuitServer(server, clock=clock)
    x = {t: sources[t][0][:30] for t in reg}
    for t in reg:
        fe.enqueue(t, x[t], deadline_s=1.0)
    clock.t = 0.999
    fe.pump()
    # headroom is at most 1, so grow_headroom=1.5 asks for a grow every step
    auto = AutoscaleController(fe, HysteresisPolicy(patience=1, cooldown_s=0.0,
                                                    grow_headroom=1.5), clock=clock)
    if torch.cuda.device_count() == 1:  # the automatic cap is the card count
        assert auto.step() is None and server.plan().n_shards == 1
    ctl = AutoscaleController(fe, HysteresisPolicy(patience=1, cooldown_s=0.0, max_shards=2,
                                                   device_cap=2, grow_headroom=1.5),
                              clock=clock)
    warms = server.aot_stats["exec_warms"]
    event = ctl.step()
    assert event is not None and event.action == "grow"
    assert (event.from_shards, event.to_shards) == (1, 2)
    assert server.aot_stats["exec_warms"] > warms  # the new shards warmed before the fence
    assert all(fe.latency_est(s) > 0.0 for s in range(2))  # EWMAs carried, not cold
    clock.t = 10.0
    futs = {t: fe.enqueue(t, x[t], deadline_s=1.0) for t in reg}
    clock.t = 10.999
    before = _spans()
    d = fe.pump()
    assert len(d.batch) == len(futs) and _spans() == before + 2
    for t, fut in futs.items():
        np.testing.assert_array_equal(fut.result(0), _want(reg, t, x[t]))


@pytest.mark.cuda
def test_serve_async_defaults_to_the_card(stack):
    reg, sources = stack
    sc = reg.get("higgs")
    x, gold = sources["higgs"]

    async def main():
        async with sc.serve_async() as fe:
            got = await asyncio.gather(*(fe.submit("default", x[lo:lo + 500], deadline_s=30.0)
                                         for lo in range(0, 3000, 500)))
            return fe, got

    fe, got = asyncio.run(main())
    assert fe.server.device.type == "cuda" and fe._thread is None
    np.testing.assert_array_equal(np.concatenate(got), gold[:3000])
    assert fe.stats.report()["completed"] == 6
