"""The deadline-aware async front end of the PyTorch port, on the CPU.

Two halves:

  * the reference's own cases (`tests/test_serve_async.py`), each run
    against the port with ``device="cpu"`` — the scheduler under a fake
    clock, the front end under a fake clock with manual ``pump``, and the
    background thread and asyncio facade on real time (parity only);
  * exact parity with the reference: one scripted sequence of ``enqueue``
    and ``pump(now)`` calls under a fake clock goes through both packages'
    `AsyncCircuitServer` over equal registries (1 and 2 shards, with an
    ensemble whose members straddle shards) and must give the same
    decisions, ids, `FrontendStats` reports (but ``backend``) and
    bitwise-equal per-shard latency EWMAs.

Circuits are made by the reference and carried into the port
(`tests/torch_parity.py`).
"""
import asyncio
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from repro.serve.async_frontend import AdmissionError as RefAdmissionError
from repro.serve.async_frontend import AsyncCircuitServer as RefFrontend
from repro.serve.circuits import CircuitServer as RefServer
from repro.serve.circuits import TenantQoS as RefQoS
from repro.serve.planning import PlacementPolicy as RefPolicy
from repro_torch import runtime
from repro_torch.serve.async_frontend import (
    AdmissionError,
    AsyncCircuitServer,
    DeadlineExceededError,
    DeadlineScheduler,
    Request,
)
from repro_torch.serve.circuits import (
    DEFAULT_QOS,
    CircuitRegistry,
    CircuitServer,
    TenantQoS,
)
from repro_torch.serve.planning import PlacementPolicy, ensemble_vote
from tests.torch_parity import (
    SERVE_TENANTS, make_ref_servable, rows_for, serving_registries, to_port)

RNG = np.random.RandomState(7)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def make_servable(seed, n_feats, bits, n_nodes, n_classes):
    """A port servable carrying a reference-made circuit."""
    return to_port(make_ref_servable(seed, n_feats, bits, n_nodes, n_classes))


def predict(sc, x):
    return sc.predict(x, device="cpu")


def req(tenant, rows, deadline, *, now=0.0, n_feats=4) -> Request:
    return Request(
        tenant_id=tenant,
        features=np.zeros((rows, n_feats), np.float32),
        deadline=deadline, future=Future(), submitted_at=now,
    )


def sched(qos: TenantQoS, **kw) -> DeadlineScheduler:
    kw.setdefault("safety_margin_s", 0.0)
    return DeadlineScheduler(lambda t: qos, **kw)


# ---------------------------------------------------------------------------
# DeadlineScheduler (pure, fake time)
# ---------------------------------------------------------------------------

LAZY = TenantQoS(max_batch=10**6, max_wait_s=100.0, default_deadline_s=1.0)


def test_scheduler_fires_on_deadline_minus_latency_estimate():
    s = sched(LAZY, latency_est_s=0.1)
    s.push(req("a", 4, deadline=1.0))
    d = s.poll(0.5)
    assert not d.batch and not d.expired and d.reason == ""
    assert d.next_wake == pytest.approx(0.9)  # deadline - est latency
    assert not s.poll(0.89).batch
    d = s.poll(0.9)
    assert d.reason == "deadline" and len(d.batch) == 1
    assert s.pending_requests() == 0


def test_scheduler_batch_full_fast_path():
    s = sched(TenantQoS(max_batch=8, max_wait_s=100.0))
    for _ in range(3):
        s.push(req("a", 3, deadline=1000.0))
    d = s.poll(0.0)  # 9 rows >= max_batch: fire immediately
    assert d.reason == "batch_full"
    # whole requests only: 3 + 3 fit in 8, the third would overflow
    assert [r.rows for r in d.batch] == [3, 3]
    assert s.pending_requests() == 1
    assert s.poll(0.0).reason == ""


def test_scheduler_oversized_request_fires_alone():
    s = sched(TenantQoS(max_batch=8, max_wait_s=100.0))
    s.push(req("a", 20, deadline=1000.0))
    d = s.poll(0.0)
    assert d.reason == "batch_full" and [r.rows for r in d.batch] == [20]


def test_scheduler_max_wait_bounds_staleness():
    s = sched(TenantQoS(max_batch=10**6, max_wait_s=0.5))
    s.push(req("a", 1, deadline=1000.0, now=0.0))
    d = s.poll(0.3)
    assert d.reason == "" and d.next_wake == pytest.approx(0.5)
    d = s.poll(0.5)
    assert d.reason == "max_wait" and len(d.batch) == 1


def test_scheduler_sheds_expired_requests():
    s = sched(LAZY)
    r = req("a", 2, deadline=1.0)
    s.push(r)
    d = s.poll(1.5)
    assert d.expired == [r] and not d.batch
    assert s.pending_requests() == 0


def test_scheduler_tenant_isolation_under_backlog():
    qos = {"a": TenantQoS(max_batch=4, max_wait_s=100.0),
           "b": TenantQoS(max_batch=4, max_wait_s=100.0)}
    s = DeadlineScheduler(qos.__getitem__, safety_margin_s=1e-3)
    for _ in range(10):
        s.push(req("a", 4, deadline=1000.0))
    rb = req("b", 1, deadline=0.05)
    s.push(rb)
    d = s.poll(0.049)
    assert d.reason in ("deadline", "batch_full")
    assert rb in d.batch
    assert sum(r.rows for r in d.batch if r.tenant_id == "a") <= 4
    assert s.queue_rows() == 9 * 4


def test_scheduler_latency_ewma_moves_fire_time():
    s = sched(LAZY, latency_est_s=0.0, latency_ewma=0.5)
    s.observe_latency(0.2)
    assert s.latency_est_s == pytest.approx(0.1)
    s.push(req("a", 1, deadline=1.0))
    assert s.poll(0.0).next_wake == pytest.approx(0.9)


def test_scheduler_pending_for_and_drain_all_match_reference():
    """The unconditional drains (a tenant's migration, shutdown) take whole
    requests in FIFO order, max_batch at a time, as the reference's do."""
    from repro.serve.async_frontend import DeadlineScheduler as RefScheduler
    from repro.serve.async_frontend import Request as RefRequest

    qos = {"a": TenantQoS(max_batch=5), "b": TenantQoS(max_batch=3)}
    ref_qos = {t: RefQoS(max_batch=q.max_batch) for t, q in qos.items()}
    port, ref = DeadlineScheduler(qos.__getitem__), RefScheduler(ref_qos.__getitem__)
    sizes = [("a", 2), ("b", 4), ("a", 4), ("b", 1), ("a", 1), ("b", 2)]
    for seq, (t, n) in enumerate(sizes, 1):
        port.push(Request(t, np.zeros((n, 1), np.float32), 9.0, Future(), 0.0, seq=seq))
        ref.push(RefRequest(t, np.zeros((n, 1), np.float32), 9.0, Future(), 0.0, seq=seq))
    got, want = port.pending_for("b"), ref.pending_for("b")
    assert [r.seq for r in got] == [r.seq for r in want] == [2, 4, 6]
    assert port.pending_for("nope") == ref.pending_for("nope") == []
    got, want = port.drain_all(), ref.drain_all()
    assert [r.seq for r in got] == [r.seq for r in want] == [1, 3, 5]
    assert port.pending_requests() == ref.pending_requests() == 0


SHARD_OF = {"a": 0, "b": 1}.get


def test_scheduler_fires_only_the_due_shard():
    s = DeadlineScheduler(lambda t: LAZY, shard_of=SHARD_OF,
                          safety_margin_s=0.0, latency_est_s=0.1)
    s.push(req("a", 2, deadline=1.0))
    s.push(req("b", 3, deadline=5.0))
    d = s.poll(0.9)
    assert d.reason == "deadline" and d.shards == (0,)
    assert [r.tenant_id for r in d.batch] == ["a"]
    assert s.queue_rows() == 3
    d = s.poll(4.9)
    assert d.shards == (1,) and [r.tenant_id for r in d.batch] == ["b"]


def test_scheduler_both_shards_due_fire_together():
    s = DeadlineScheduler(lambda t: LAZY, shard_of=SHARD_OF,
                          safety_margin_s=0.0, latency_est_s=0.1)
    s.push(req("a", 1, deadline=1.0))
    s.push(req("b", 1, deadline=1.0))
    d = s.poll(0.9)
    assert d.shards == (0, 1) and len(d.batch) == 2


def test_scheduler_per_shard_latency_estimates():
    s = DeadlineScheduler(lambda t: LAZY, shard_of=SHARD_OF,
                          safety_margin_s=0.0, latency_est_s=0.1,
                          latency_ewma=1.0)
    s.observe_latency(0.5, shard=1)
    assert s.latency_est(0) == pytest.approx(0.1)
    assert s.latency_est(1) == pytest.approx(0.5)
    s.push(req("a", 1, deadline=2.0))
    s.push(req("b", 1, deadline=2.0))
    d = s.poll(1.4)
    assert d.reason == "" and d.next_wake == pytest.approx(1.5)
    d = s.poll(1.5)
    assert d.shards == (1,) and [r.tenant_id for r in d.batch] == ["b"]
    d = s.poll(1.6)
    assert d.reason == "" and d.next_wake == pytest.approx(1.9)
    d = s.poll(1.9)
    assert d.shards == (0,)


def test_scheduler_shard_backlog_cannot_displace_other_shard():
    qos = TenantQoS(max_batch=4, max_wait_s=100.0)
    s = DeadlineScheduler(lambda t: qos, shard_of=SHARD_OF,
                          safety_margin_s=0.0)
    s.push(req("a", 1, deadline=1000.0))
    for _ in range(3):
        s.push(req("b", 4, deadline=1000.0))
    d = s.poll(0.0)
    assert d.reason == "batch_full" and d.shards == (1,)
    assert all(r.tenant_id == "b" for r in d.batch)
    assert sum(r.rows for r in d.batch) == 4
    assert s.queue_rows() == 1 + 8


# ---------------------------------------------------------------------------
# AsyncCircuitServer, manual pump under a fake clock
# ---------------------------------------------------------------------------

@pytest.fixture
def registry():
    reg = CircuitRegistry()
    for i, shape in enumerate(SERVE_TENANTS):
        reg.add(f"t{i}", make_servable(40 + i, *shape))
    return reg


def frontend(registry, clock):
    fe = AsyncCircuitServer(CircuitServer(registry, device="cpu"), clock=clock)
    assert fe.scheduler.safety_margin_s == pytest.approx(1e-3)
    return fe


def test_frontend_serves_at_deadline_and_matches_predict(registry):
    clock = FakeClock()
    for tenant in registry:
        registry.set_qos(tenant, LAZY)
    fe = frontend(registry, clock)
    futs = {}
    for tenant in registry:
        n_feats = registry.get(tenant).encoder.n_features
        x = RNG.randn(6, n_feats).astype(np.float32)
        futs[tenant] = (fe.enqueue(tenant, x, deadline_s=1.0), x)
    d = fe.pump()
    assert not d.batch and d.next_wake == pytest.approx(0.999)
    clock.t = 0.999
    d = fe.pump()
    assert d.reason == "deadline" and len(d.batch) == len(futs)
    for tenant, (fut, x) in futs.items():
        np.testing.assert_array_equal(fut.result(0), predict(registry.get(tenant), x))
    rep = fe.stats.report()
    assert rep["miss_rate"] == 0.0 and rep["fires"] == 1
    assert rep["completed"] == len(futs)
    assert rep["backend"] == "torch-ref"


def test_frontend_admission_rejects_passed_deadline(registry):
    clock = FakeClock(5.0)
    fe = frontend(registry, clock)
    x = RNG.randn(2, 4).astype(np.float32)
    with pytest.raises(AdmissionError):
        fe.enqueue("t0", x, deadline=5.0)
    with pytest.raises(AdmissionError):
        fe.enqueue("t0", x, deadline_s=-1.0)
    assert fe.stats.rejected == 2 and fe.stats.submitted == 0
    with pytest.raises(KeyError):
        fe.enqueue("nope", x)
    with pytest.raises(ValueError):
        fe.enqueue("t0", RNG.randn(2, 99).astype(np.float32))


def test_frontend_sheds_expired_and_fails_future(registry):
    clock = FakeClock()
    fe = frontend(registry, clock)
    fut = fe.enqueue("t0", RNG.randn(3, 4).astype(np.float32), deadline_s=0.5)
    clock.t = 2.0
    d = fe.pump()
    assert len(d.expired) == 1 and not d.batch
    with pytest.raises(DeadlineExceededError):
        fut.result(0)
    rep = fe.stats.report()
    assert rep["shed"] == 1 and rep["deadline_misses"] == 1
    assert rep["miss_rate"] == 1.0


def test_frontend_batch_full_fires_without_waiting(registry):
    clock = FakeClock()
    registry.set_qos("t0", TenantQoS(max_batch=8, max_wait_s=100.0,
                                     default_deadline_s=100.0))
    fe = frontend(registry, clock)
    x = RNG.randn(8, 4).astype(np.float32)
    fut = fe.enqueue("t0", x)
    d = fe.pump()
    assert d.reason == "batch_full"
    np.testing.assert_array_equal(fut.result(0), predict(registry.get("t0"), x))
    assert fe.stats.report()["mean_batch_fill"] == pytest.approx(1.0)


def test_frontend_tenant_isolation_end_to_end(registry):
    clock = FakeClock()
    registry.set_qos("t0", TenantQoS(max_batch=4, max_wait_s=100.0,
                                     default_deadline_s=100.0))
    fe = frontend(registry, clock)
    backlog = [
        (fe.enqueue("t0", x), x)
        for x in (RNG.randn(4, 4).astype(np.float32) for _ in range(5))
    ]
    xb = RNG.randn(2, 7).astype(np.float32)
    fb = fe.enqueue("t1", xb, deadline_s=0.05)
    clock.t = 0.049
    d = fe.pump()
    assert any(r.tenant_id == "t1" for r in d.batch)
    assert sum(r.rows for r in d.batch if r.tenant_id == "t0") <= 4
    np.testing.assert_array_equal(fb.result(0), predict(registry.get("t1"), xb))
    assert clock() <= 0.05
    for _ in range(10):
        if not fe.pending_requests():
            break
        fe.pump()
    for fut, x in backlog:
        np.testing.assert_array_equal(fut.result(0), predict(registry.get("t0"), x))


def test_frontend_sharded_per_shard_fires(registry):
    clock = FakeClock()
    for tenant in registry:
        registry.set_qos(tenant, LAZY)
    server = CircuitServer(registry, device="cpu", policy=PlacementPolicy(n_shards=2))
    fe = AsyncCircuitServer(server, clock=clock)
    assert server.shard_of("t0") == 0 and server.shard_of("t1") == 1
    x0 = RNG.randn(3, 4).astype(np.float32)
    x1 = RNG.randn(5, 7).astype(np.float32)
    f0 = fe.enqueue("t0", x0, deadline_s=1.0)
    f1 = fe.enqueue("t1", x1, deadline_s=5.0)
    clock.t = 0.999
    d = fe.pump()
    assert d.shards == (0,)
    np.testing.assert_array_equal(f0.result(0), predict(registry.get("t0"), x0))
    assert not f1.done() and fe.pending_requests() == 1
    clock.t = 4.999
    d = fe.pump()
    assert d.shards == (1,)
    np.testing.assert_array_equal(f1.result(0), predict(registry.get("t1"), x1))
    rep = fe.stats.report()
    assert rep["shard_fires"] == {"0": 1, "1": 1}
    assert rep["miss_rate"] == 0.0


def test_frontend_ensemble_latency_attributed_to_member_shards(registry):
    clock = FakeClock()
    registry.add_ensemble("ens", [make_servable(500 + i, 5, 2, 30, 2) for i in range(2)])
    server = CircuitServer(registry, device="cpu", policy=PlacementPolicy(n_shards=2))
    refs = server.plan().placement["ens"]
    assert {r.shard for r in refs} == {0, 1}
    fe = AsyncCircuitServer(server, clock=clock)
    fut = fe.enqueue("ens", RNG.randn(4, 5).astype(np.float32), deadline_s=1.0)
    clock.t = 0.999
    d = fe.pump()
    assert d.shards == (0,)
    assert fut.result(0).shape == (4,)
    assert set(fe.scheduler._shard_latency) == {0, 1}
    assert fe.stats.report()["shard_fires"] == {"0": 1, "1": 1}


def test_frontend_hot_remove_fails_queued_requests_individually(registry):
    clock = FakeClock()
    fe = frontend(registry, clock)
    x0 = RNG.randn(3, 4).astype(np.float32)
    f_live = fe.enqueue("t0", x0, deadline_s=1.0)
    f_dead = fe.enqueue("t1", RNG.randn(2, 7).astype(np.float32), deadline_s=1.0)
    registry.remove("t1")
    clock.t = 0.999
    fe.pump()
    np.testing.assert_array_equal(f_live.result(0), predict(registry.get("t0"), x0))
    with pytest.raises(KeyError, match="t1"):
        f_dead.result(0)


def test_frontend_zero_row_request_completes(registry):
    clock = FakeClock()
    fe = frontend(registry, clock)
    fut = fe.enqueue("t0", np.zeros((0, 4), np.float32), deadline_s=1.0)
    clock.t = 0.999
    fe.pump()
    assert fut.result(0).shape == (0,)


def test_frontend_stop_drains_pending(registry):
    fe = AsyncCircuitServer(CircuitServer(registry, device="cpu"))
    x = RNG.randn(3, 4).astype(np.float32)
    fut = fe.enqueue("t0", x, deadline_s=3600.0)
    fe.stop()  # never started: drain path only
    np.testing.assert_array_equal(fut.result(0), predict(registry.get("t0"), x))


def test_frontend_failed_launch_fails_its_futures(registry, monkeypatch):
    clock = FakeClock()
    fe = frontend(registry, clock)
    boom = RuntimeError("backend exploded")
    monkeypatch.setattr(fe.server, "step", lambda work: (_ for _ in ()).throw(boom))
    fut = fe.enqueue("t0", RNG.randn(2, 4).astype(np.float32), deadline_s=0.5)
    clock.t = 0.499
    with pytest.raises(RuntimeError, match="backend exploded"):
        fe.pump()
    assert fut.exception(0) is boom


def test_server_step_hook_isolates_per_item_errors(registry):
    server = CircuitServer(registry, device="cpu")
    x = RNG.randn(4, 4).astype(np.float32)
    out = server.step([("t0", x), ("nope", x)])
    np.testing.assert_array_equal(out[0], predict(registry.get("t0"), x))
    assert isinstance(out[1], KeyError)
    assert server.stats.launches == 1


def test_registry_qos_lifecycle(registry):
    assert registry.qos("t0") == DEFAULT_QOS
    tight = TenantQoS(max_batch=8, max_wait_s=0.001, default_deadline_s=0.01)
    gen = registry.generation
    registry.set_qos("t0", tight)
    assert registry.qos("t0") == tight
    assert registry.generation == gen
    registry.remove("t0")
    with pytest.raises(KeyError):
        registry.qos("t0")
    registry.add("t0", make_servable(40, *SERVE_TENANTS[0]), qos=tight)
    assert registry.qos("t0") == tight
    with pytest.raises(ValueError):
        TenantQoS(max_batch=0)
    with pytest.raises(ValueError):
        TenantQoS(default_deadline_s=0.0)


def test_frontend_background_thread_parity(registry):
    with AsyncCircuitServer(CircuitServer(registry, device="cpu")) as fe:
        futs = {}
        for tenant in registry:
            n_feats = registry.get(tenant).encoder.n_features
            x = RNG.randn(5, n_feats).astype(np.float32)
            futs[tenant] = (fe.enqueue(tenant, x, deadline_s=30.0), x)
        for tenant, (fut, x) in futs.items():
            np.testing.assert_array_equal(fut.result(30), predict(registry.get(tenant), x))
    assert fe._thread is None  # joined by the context exit
    assert fe.stats.report()["completed"] == len(futs)


def test_servable_serve_async_asyncio_facade():
    sc = make_servable(77, *SERVE_TENANTS[0])
    x = RNG.randn(6, SERVE_TENANTS[0][0]).astype(np.float32)

    async def main():
        async with sc.serve_async(device="cpu") as fe:
            ids = await fe.submit("default", x, deadline_s=30.0)
            more = await asyncio.gather(
                fe.submit("default", x[:2], deadline_s=30.0),
                fe.submit("default", x[2:], deadline_s=30.0),
            )
            return fe, ids, more

    fe, ids, more = asyncio.run(main())
    assert fe.server.device == torch.device("cpu")
    np.testing.assert_array_equal(ids, predict(sc, x))
    np.testing.assert_array_equal(np.concatenate(more), predict(sc, x))


def test_serve_async_without_a_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = make_servable(78, *SERVE_TENANTS[0])
    with pytest.raises(runtime.NoCudaDeviceError):
        sc.serve_async()
    qos = TenantQoS(max_batch=16)
    fe = sc.serve_async(device="cpu", tenant="mine", qos=qos, clock=FakeClock(3.0))
    assert fe.server.registry.qos("mine") == qos and fe.clock() == 3.0
    assert fe._thread is None  # returned unstarted


# ---------------------------------------------------------------------------
# Exact parity with the reference: one scripted fake-clock sequence
# ---------------------------------------------------------------------------

# (max_batch, max_wait_s, default_deadline_s) cycled over the tenants
TIERS = [(32, 0.010, 0.030), (128, 0.050, 0.200), (512, 0.400, 1.000)]


def _script(tenants, n_events=140, seed=11):
    """``(time, op, args)`` events: enqueues (some with explicit, some with
    past deadlines), pumps, and per-fire step latencies."""
    rng = np.random.RandomState(seed)
    t, events = 0.0, []
    for k in range(n_events):
        t += float(rng.exponential(0.006))
        if rng.rand() < 0.65:
            tenant = tenants[int(rng.randint(len(tenants)))]
            rows = 1 + int(rng.poisson(8))
            kind = rng.rand()
            deadline_s = (None if kind < 0.6 else float(rng.uniform(0.002, 0.05))
                          if kind < 0.95 else -0.01)
            events.append((t, "enqueue", (tenant, rows, 1000 + k, deadline_s)))
        else:
            events.append((t, "pump", float(rng.uniform(0.0005, 0.02))))
    events.append((t + 5.0, "pump", 0.001))
    return events


def _drive(fe, reg, clock, events, rejected_type):
    """Run the script on one front end; returns decisions, outcomes by
    request seq, the number of admission rejects, and each admitted
    request's (tenant, rows) by seq."""
    real_step = fe.server.step
    step_latency = [0.0]

    def step(work):
        out = real_step(work)
        clock.t += step_latency[0]  # the fire's scripted latency
        return out

    fe.server.step = step
    decisions, futures, inputs, rejected = [], {}, {}, 0
    for t, op, arg in events:
        clock.t = t
        if op == "enqueue":
            tenant, rows, seed, deadline_s = arg
            x = rows_for(reg, tenant, seed, rows)
            try:
                fut = fe.enqueue(tenant, x, deadline_s=deadline_s)
            except rejected_type:
                rejected += 1
                continue
            futures[fut.request_id] = fut
            inputs[fut.request_id] = (tenant, x)
        else:
            step_latency[0] = arg
            d = fe.pump(t)
            decisions.append((
                tuple(r.seq for r in d.batch), tuple(r.seq for r in d.expired),
                d.reason, d.next_wake, d.queue_rows, d.shards, d.shard_reasons,
            ))
    outcomes = {}
    for seq, fut in futures.items():
        assert fut.done()
        err = fut.exception(0)
        outcomes[seq] = type(err).__name__ if err is not None else fut.result(0)
    return decisions, outcomes, rejected, inputs


@pytest.mark.parametrize("n_shards", [1, 2])
def test_scripted_sequence_matches_reference(n_shards):
    ref_reg, reg = serving_registries()
    tenants = list(reg)
    for i, t in enumerate(tenants):
        mb, mw, dl = TIERS[i % len(TIERS)]
        ref_reg.set_qos(t, RefQoS(max_batch=mb, max_wait_s=mw, default_deadline_s=dl))
        reg.set_qos(t, TenantQoS(max_batch=mb, max_wait_s=mw, default_deadline_s=dl))
    ref_clock, clock = FakeClock(), FakeClock()
    ref_fe = RefFrontend(RefServer(ref_reg, backend="ref", policy=RefPolicy(n_shards=n_shards)),
                         clock=ref_clock)
    fe = AsyncCircuitServer(CircuitServer(reg, device="cpu",
                                          policy=PlacementPolicy(n_shards=n_shards)),
                            clock=clock)
    if n_shards == 2:  # the ensemble's members straddle both shards
        assert {r.shard for r in fe.server.plan().placement["ens"]} == {0, 1}
    events = _script(tenants)
    want = _drive(ref_fe, ref_reg, ref_clock, events, RefAdmissionError)
    got = _drive(fe, reg, clock, events, AdmissionError)
    assert got[0] == want[0]  # every decision, field by field
    assert got[2] == want[2] > 0  # admission rejects
    assert got[1].keys() == want[1].keys()
    outcomes = set()
    for seq, out in got[1].items():
        ref_out = want[1][seq]
        if isinstance(ref_out, str):
            assert out == ref_out, seq
            outcomes.add(out)
        else:
            np.testing.assert_array_equal(out, ref_out)
            outcomes.add("served")
    assert outcomes == {"served", "DeadlineExceededError"}
    reasons = {r for d in got[0] for _, r in d[6]}
    assert {"deadline", "max_wait"} <= reasons
    rep_r, rep_t = ref_fe.stats.report(), fe.stats.report()
    assert (rep_r.pop("backend"), rep_t.pop("backend")) == ("ref", "torch-ref")
    assert rep_t == rep_r
    assert rep_t["served_late"] > 0 and rep_t["shed"] > 0
    # per-shard latency EWMAs, bitwise
    assert fe.scheduler._shard_latency == ref_fe.scheduler._shard_latency
    assert set(fe.scheduler._shard_latency) == set(range(n_shards))
    # served ids are also the tenants' own predict (spot check)
    for seq in sorted(got[1])[::9]:
        if isinstance(got[1][seq], np.ndarray):
            tenant, x = got[3][seq]
            members = reg.members(tenant)
            np.testing.assert_array_equal(got[1][seq], ensemble_vote(
                np.stack([predict(m, x) for m in members]), members[0].n_classes))
