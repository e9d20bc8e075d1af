"""Autoscaling on the PyTorch port, on the CPU: policy, controller,
`carry_map`, EWMA rebinds, the churn soak, and the locked scheduler reads.

Three parts:

  * the reference's own policy, controller, `carry_map` and rebind cases
    (`tests/test_autoscale.py`; its ``recompile`` and ``swap_plan`` cases
    are held by `tests/test_torch_swap.py`), run against the port with
    ``device="cpu"``, the churn soak included;
  * exact parity with the reference: `HysteresisPolicy.decide` over one
    seeded stream of 500 telemetry snapshots, and a controller driven by
    scripted skewed traffic under a fake clock — the same
    `RebalanceEvent`s (but ``swap_ms``), placements, content hashes,
    carry maps and rebound EWMAs;
  * the repair of the reference's unlocked reads: with the scheduler
    wrapped so that every access asserts the front end's lock is held by
    the caller, the port's ``collect()`` and ``stop()`` pass, and the
    reference's own trip the assertion.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro.serve.async_frontend import AsyncCircuitServer as RefFrontend
from repro.serve.autoscale import AutoscaleController as RefController
from repro.serve.autoscale import HysteresisPolicy as RefPolicy
from repro.serve.autoscale import ShardTelemetry as RefTelemetry
from repro.serve.circuits import CircuitServer as RefServer
from repro.serve.circuits import TenantQoS as RefQoS
from repro.serve.planning import PlacementPolicy as RefPlacement
from repro_torch.serve.async_frontend import AsyncCircuitServer, DeadlineScheduler
from repro_torch.serve.autoscale import (
    AutoscaleController,
    AutoscaleDecision,
    HysteresisPolicy,
    ShardTelemetry,
    carry_map,
)
from repro_torch.serve.circuits import CircuitRegistry, CircuitServer, StalePlanError, TenantQoS
from repro_torch.serve.planning import PlacementPolicy, PlanCompiler, ensemble_vote
from tests.torch_parity import (
    SERVE_TENANTS, make_ref_servable, rows_for, serving_registries, to_port)

RNG = np.random.RandomState(23)


def make_servable(seed, n_feats, bits, n_nodes, n_classes):
    """A port servable carrying a reference-made circuit."""
    return to_port(make_ref_servable(seed, n_feats, bits, n_nodes, n_classes))


def predict(sc, x):
    return sc.predict(x, device="cpu")


def fleet(n: int = 6, seed0: int = 300) -> CircuitRegistry:
    reg = CircuitRegistry()
    for i in range(n):
        reg.add(f"t{i}", make_servable(seed0 + i, *SERVE_TENANTS[i % len(SERVE_TENANTS)]))
    return reg


def server_of(reg, n_shards):
    return CircuitServer(reg, device="cpu", policy=PlacementPolicy(n_shards=n_shards))


def telemetry(**kw) -> ShardTelemetry:
    base = dict(
        now=0.0, n_shards=2, occupancy={0: 0.1, 1: 0.1},
        shard_load={0: 100.0, 1: 100.0}, latency_s={},
        miss_rate=0.0, p99_latency_s=0.0, min_deadline_s=1.0,
        queue_rows=0, tenant_rows={},
    )
    base.update(kw)
    return ShardTelemetry(**base)


# ---------------------------------------------------------------------------
# Swaps under the controller: nothing lost, ensembles co-resident
# ---------------------------------------------------------------------------

def test_no_request_lost_or_double_answered_across_swap():
    reg = fleet(6)
    server = server_of(reg, 2)
    tickets = {}
    for tenant in reg:
        n_feats = reg.get(tenant).encoder.n_features
        x = RNG.randn(7, n_feats).astype(np.float32)
        tickets[tenant] = (server.submit(tenant, x), x)
    compiler = PlanCompiler(server.backend, PlacementPolicy(n_shards=3))
    event = server.swap_plan(compiler.recompile(reg.catalog(), server.plan()),
                             compiler=compiler, action="grow")
    assert event.inflight_requests == len(tickets)
    server.tick()
    for tenant, (ticket, x) in tickets.items():
        np.testing.assert_array_equal(server.result(ticket), predict(reg.get(tenant), x))
        with pytest.raises(KeyError):
            server.result(ticket)
    assert not server._results


def test_ensemble_stays_coresident_across_rebalance():
    reg = fleet(4)
    members = [make_servable(600 + i, 6, 2, 40, 3) for i in range(3)]
    reg.add_ensemble("ens", members)
    server = server_of(reg, 2)
    x = RNG.randn(21, 6).astype(np.float32)
    want = ensemble_vote(np.stack([predict(m, x) for m in members]), 3)
    np.testing.assert_array_equal(server.predict("ens", x), want)
    compiler = PlanCompiler(server.backend, PlacementPolicy(n_shards=3))
    server.swap_plan(compiler.recompile(reg.catalog(), server.plan()),
                     compiler=compiler, action="grow")
    plan = server.plan()
    refs = plan.placement["ens"]
    assert len(refs) == 3 and all(r is not None for r in refs)
    assert len(plan.members("ens")) == 3
    np.testing.assert_array_equal(server.predict("ens", x), want)


# ---------------------------------------------------------------------------
# Scheduler EWMA carry-over
# ---------------------------------------------------------------------------

def test_scheduler_rebind_carries_ewmas():
    s = DeadlineScheduler(lambda t: TenantQoS(), latency_ewma=1.0)
    s.observe_latency(0.2, shard=0)
    s.observe_latency(0.6, shard=1)
    s.rebind_shards({0: 0, 1: 1, 2: 1}, n_shards=3)
    assert s.latency_est(0) == pytest.approx(0.2)
    assert s.latency_est(1) == pytest.approx(0.6)
    assert s.latency_est(2) == pytest.approx(0.6)
    s.rebind_shards({0: 2}, n_shards=2)
    assert s.latency_est(0) == pytest.approx(0.6)
    assert s.latency_est(1) == pytest.approx((0.2 + 0.6 + 0.6) / 3)


def test_controller_swap_rebinds_frontend_ewmas():
    reg = fleet(6)
    server = server_of(reg, 2)
    clock = [0.0]
    fe = AsyncCircuitServer(server, clock=lambda: clock[0])
    fe.scheduler.observe_latency(0.05, shard=0)
    fe.scheduler.observe_latency(0.09, shard=1)
    ctl = AutoscaleController(fe, clock=lambda: clock[0])
    event = ctl.apply(AutoscaleDecision("grow", 3, "test"))
    assert event.to_shards == 3
    ests = [fe.latency_est(s) for s in range(3)]
    assert all(e > 0.0 for e in ests)
    assert ests[0] == pytest.approx(fe.scheduler.latency_ewma * 0.05)
    assert ctl.events == [event]


def test_carry_map_follows_majority_of_slots():
    reg = fleet(6)
    comp = PlanCompiler("torch-ref", PlacementPolicy(n_shards=2))
    prev = comp.compile(reg.catalog())
    plan = comp.recompile(reg.catalog(), prev, PlacementPolicy(n_shards=3))
    carry = carry_map(prev, plan)
    assert carry[0] == 0 and carry[1] == 1
    assert carry[2] in (0, 1)


# ---------------------------------------------------------------------------
# HysteresisPolicy: pure decisions over synthetic telemetry
# ---------------------------------------------------------------------------

def test_policy_validation():
    with pytest.raises(ValueError, match="min_shards"):
        HysteresisPolicy(min_shards=0)
    with pytest.raises(ValueError, match="imbalance_low"):
        HysteresisPolicy(imbalance_low=2.0, imbalance_high=1.5)
    with pytest.raises(ValueError, match="patience"):
        HysteresisPolicy(patience=0)


def test_policy_rebalance_needs_patience_and_rearm():
    pol = HysteresisPolicy(patience=2, cooldown_s=0.0, imbalance_high=1.5, imbalance_low=1.1)
    skew = telemetry(shard_load={0: 300.0, 1: 20.0})
    d = pol.decide(skew)
    assert d.action == "none" and "breach 1/2" in d.reason
    d = pol.decide(skew._replace(now=0.1))
    assert d.action == "rebalance" and d.n_shards == 2
    assert d.max_imbalance == pol.rebalance_target
    pol.notify_swap(0.1)
    for i in range(4):
        assert pol.decide(skew._replace(now=1.0 + i)).action == "none"
    balanced = telemetry(now=6.0)
    assert pol.decide(balanced).action == "none"
    d1 = pol.decide(skew._replace(now=7.0))
    d2 = pol.decide(skew._replace(now=8.0))
    assert (d1.action, d2.action) == ("none", "rebalance")


def test_policy_grow_on_miss_rate_and_headroom():
    pol = HysteresisPolicy(patience=1, cooldown_s=0.0, max_shards=4, device_cap=4)
    d = pol.decide(telemetry(miss_rate=0.05))
    assert d.action == "grow" and d.n_shards == 3
    d = pol.decide(telemetry(p99_latency_s=0.9, min_deadline_s=1.0))
    assert d.action == "grow"
    assert pol.decide(
        telemetry(n_shards=4, miss_rate=0.5,
                  occupancy={s: 0.1 for s in range(4)},
                  shard_load={s: 100.0 for s in range(4)})
    ).action == "none"


def test_policy_grow_capped_at_device_count():
    pol = HysteresisPolicy(patience=1, cooldown_s=0.0, max_shards=8, device_cap=2)
    assert pol.decide(telemetry(n_shards=2, miss_rate=0.5)).action == "none"
    pol2 = HysteresisPolicy(patience=1, cooldown_s=0.0, max_shards=8, device_cap=3)
    d = pol2.decide(telemetry(n_shards=2, miss_rate=0.5))
    assert d.action == "grow" and d.n_shards == 3
    pol3 = HysteresisPolicy(patience=1, cooldown_s=0.0, device_cap=2)
    d = pol3.decide(telemetry(n_shards=2, shard_load={0: 500.0, 1: 10.0}))
    assert d.action == "rebalance"
    # default (None) resolves to the live CUDA device count at decide time
    n_dev = max(torch.cuda.device_count(), 1)
    auto = HysteresisPolicy(patience=1, cooldown_s=0.0, max_shards=64)
    assert auto.decide(
        telemetry(n_shards=n_dev, miss_rate=0.5,
                  occupancy={s: 0.1 for s in range(n_dev)},
                  shard_load={s: 100.0 for s in range(n_dev)})
    ).action == "none"
    with pytest.raises(ValueError):
        HysteresisPolicy(device_cap=0)


@pytest.mark.parametrize("count,cap", [(0, 1), (1, 1), (4, 4)])
def test_device_cap_counts_cuda_devices_and_never_drops_below_one(monkeypatch, count, cap):
    """No CUDA (a count of 0) and one card both cap at 1, so the default
    policy never grows there; an explicit cap always wins."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    auto = HysteresisPolicy(patience=1, cooldown_s=0.0, max_shards=8)
    assert auto._device_cap() == cap
    one = telemetry(n_shards=1, miss_rate=0.5, occupancy={0: 0.1}, shard_load={0: 100.0})
    assert auto.decide(one).action == ("grow" if cap > 1 else "none")
    explicit = HysteresisPolicy(patience=1, cooldown_s=0.0, max_shards=8, device_cap=3)
    assert explicit._device_cap() == 3
    d = explicit.decide(one)
    assert d.action == "grow" and d.n_shards == 2


def test_policy_shrink_only_when_idle_and_safe():
    pol = HysteresisPolicy(patience=1, cooldown_s=0.0, min_shards=1)
    idle = telemetry(occupancy={0: 0.001, 1: 0.001},
                     shard_load={0: 10.0, 1: 10.0}, p99_latency_s=0.01)
    d = pol.decide(idle)
    assert d.action == "shrink" and d.n_shards == 1
    assert pol.decide(idle._replace(queue_rows=50)).action == "none"
    assert pol.decide(idle._replace(n_shards=1)).action == "none"


def test_policy_cooldown_quiets_every_trigger():
    pol = HysteresisPolicy(patience=1, cooldown_s=10.0, device_cap=8)
    pol.notify_swap(100.0)
    assert pol.decide(telemetry(miss_rate=1.0, now=105.0)).reason == "cooldown"
    assert pol.decide(telemetry(miss_rate=1.0, now=111.0)).action == "grow"


def _telemetry_stream(n=500, seed=5):
    """Seeded telemetry snapshots that walk through every trigger: skewed
    and balanced loads, misses, p99 near and far from the deadline, idle
    stretches, queued rows, and a shard count that moves."""
    rng = np.random.RandomState(seed)
    out, now, n_shards = [], 0.0, 2
    for _ in range(n):
        now += float(rng.uniform(0.01, 0.3))
        if rng.rand() < 0.1:
            n_shards = int(rng.randint(1, 5))
        hot = float(rng.choice([1.0, 1.2, 2.0, 6.0]))
        load = {s: float(rng.uniform(50, 150)) * (hot if s == 0 else 1.0)
                for s in range(n_shards)}
        idle = rng.rand() < 0.2
        out.append(dict(
            now=now, n_shards=n_shards,
            occupancy={s: (0.001 if idle else float(rng.uniform(0.05, 0.6)))
                       for s in range(n_shards)},
            shard_load=load, latency_s={s: 0.002 for s in range(n_shards)},
            miss_rate=float(rng.choice([0.0, 0.0, 0.005, 0.05])),
            p99_latency_s=float(rng.uniform(0.0, 0.01 if idle else 1.2)),
            min_deadline_s=float(rng.choice([1.0, 1.0, np.inf])),
            queue_rows=0 if idle else int(rng.randint(0, 40)),
            tenant_rows={"a": int(rng.randint(0, 99))},
        ))
    return out


@pytest.mark.parametrize("kw", [
    dict(patience=2, cooldown_s=0.5, max_shards=4, device_cap=4),
    dict(patience=1, cooldown_s=0.2, max_shards=3, device_cap=3, imbalance_high=1.3),
    dict(patience=3, cooldown_s=0.0, min_shards=2, max_shards=8, device_cap=8),
    dict(patience=1, cooldown_s=0.3),  # device_cap=None: 1 on this CPU host in both
])
def test_policy_decisions_match_reference_over_a_seeded_stream(kw):
    ref, port = RefPolicy(**kw), HysteresisPolicy(**kw)
    actions = set()
    for snap in _telemetry_stream():
        want = ref.decide(RefTelemetry(**snap))
        got = port.decide(ShardTelemetry(**snap))
        assert tuple(got) == tuple(want), snap
        actions.add(got.action)
        if got.action != "none":
            ref.notify_swap(snap["now"])
            port.notify_swap(snap["now"])
    assert {"none", "rebalance"} <= actions
    assert len(actions) >= 3


# ---------------------------------------------------------------------------
# Controller end to end: telemetry-driven rebalance over a live stack
# ---------------------------------------------------------------------------

def test_controller_detects_skew_and_rebalances():
    reg = fleet(6)
    server = server_of(reg, 3)
    ctl = AutoscaleController(
        server, HysteresisPolicy(patience=2, cooldown_s=0.0, imbalance_high=1.5),
        clock=time.monotonic,
    )
    hot = [t for t in reg if server.plan().shard_of(t) == 0]
    assert ctl.step() is None
    prev_hash = server.plan().content_hash
    event = None
    for _ in range(6):
        for tenant in reg:
            rows = 48 if tenant in hot else 1
            n_feats = reg.get(tenant).encoder.n_features
            server.submit(tenant, RNG.randn(rows, n_feats).astype(np.float32))
        server.tick()
        event = ctl.step()
        if event is not None:
            break
    assert event is not None and event.action == "rebalance"
    assert event.from_shards == event.to_shards == 3
    assert event.shards_reused >= 1
    assert server.plan().content_hash != prev_hash
    for tenant in reg:
        n_feats = reg.get(tenant).encoder.n_features
        x = RNG.randn(5, n_feats).astype(np.float32)
        np.testing.assert_array_equal(server.predict(tenant, x), predict(reg.get(tenant), x))


def test_controller_retries_generation_fence(monkeypatch):
    reg = fleet(4)
    server = server_of(reg, 2)
    ctl = AutoscaleController(server)
    real_swap = server.swap_plan
    raced = {"done": False}

    def racing_swap(plan, **kw):
        if not raced["done"]:
            raced["done"] = True
            reg.add("raced", make_servable(555, 4, 2, 30, 2))
        return real_swap(plan, **kw)

    monkeypatch.setattr(server, "swap_plan", racing_swap)
    event = ctl.apply(AutoscaleDecision("grow", 3, "test"))
    assert event.to_shards == 3
    assert "raced" in server.plan().placement


# ---------------------------------------------------------------------------
# Exact parity: a controller over scripted skewed traffic, fake clock
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _controller_stack(package: str):
    ref_reg, reg = serving_registries()
    clock = FakeClock()
    if package == "reference":
        for t in ref_reg:
            ref_reg.set_qos(t, RefQoS(max_batch=256, max_wait_s=0.02, default_deadline_s=0.5))
        fe = RefFrontend(RefServer(ref_reg, backend="ref", policy=RefPlacement(n_shards=2)),
                         clock=clock)
        ctl = RefController(fe, RefPolicy(patience=1, cooldown_s=0.2, max_shards=3,
                                          device_cap=3, imbalance_high=1.3), clock=clock)
        return fe, ctl, ref_reg, clock
    for t in reg:
        reg.set_qos(t, TenantQoS(max_batch=256, max_wait_s=0.02, default_deadline_s=0.5))
    fe = AsyncCircuitServer(CircuitServer(reg, device="cpu", policy=PlacementPolicy(n_shards=2)),
                            clock=clock)
    ctl = AutoscaleController(fe, HysteresisPolicy(patience=1, cooldown_s=0.2, max_shards=3,
                                                   device_cap=3, imbalance_high=1.3),
                              clock=clock)
    return fe, ctl, reg, clock


def _run_controller(package: str, rounds=36, seed=3):
    """Skewed traffic (85 % of rows to shard 0's tenants at the start),
    a pump and a control step each round, a scripted grow and shrink; each
    fire's latency is scripted from its rows."""
    fe, ctl, reg, clock = _controller_stack(package)
    real_step, rebinds, ids = fe.server.step, [], []

    def step(work):
        out = real_step(work)
        clock.t += 1e-4 * sum(len(x) for _, x in work)  # rows-proportional latency
        return out

    fe.server.step = step
    real_rebind = fe.rebind_shards

    def rebind(carry, n_shards):
        real_rebind(carry, n_shards)
        rebinds.append((dict(carry), n_shards, dict(fe.scheduler._shard_latency)))

    fe.rebind_shards = rebind
    rng = np.random.RandomState(seed)
    hot = [t for t in reg if fe.server.shard_of(t) == 0]
    cold = [t for t in reg if t not in hot]
    events, futs = [], []
    for r in range(rounds):
        clock.t = 0.05 * r
        for k in range(6):
            tenant = (hot if rng.rand() < 0.85 else cold)[int(rng.randint(3))]
            futs.append(fe.enqueue(tenant, rows_for(reg, tenant, 100 * r + k,
                                                    1 + int(rng.poisson(4)))))
        clock.t += 0.03
        fe.pump()
        fe.pump()
        events.append(ctl.step())
        if r == 12:
            events.append(ctl.apply(AutoscaleDecision("grow", 3, "scripted")))
        if r == 24:
            events.append(ctl.apply(AutoscaleDecision("shrink", 2, "scripted")))
    fe.stop()
    for fut in futs:
        ids.append(fut.result(0))
    plan = fe.server.peek_plan()
    return ([None if e is None else {k: v for k, v in dataclasses.asdict(e).items()
                                     if k != "swap_ms"} for e in events],
            rebinds, ids, plan, fe.stats.report(), ctl)


def test_controller_over_scripted_traffic_matches_reference():
    want = _run_controller("reference")
    got = _run_controller("port")
    assert got[0] == want[0]  # every RebalanceEvent but swap_ms, None where none
    assert got[1] == want[1]  # carry maps and the EWMAs they rebound, bitwise
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, b)
    plan, ref_plan = got[3], want[3]
    assert plan.content_hash == ref_plan.content_hash
    assert [s.content_hash for s in plan.shards] == [s.content_hash for s in ref_plan.shards]
    assert ({t: [tuple(map(int, r)) for r in refs] for t, refs in plan.placement.items()}
            == {t: [tuple(map(int, r)) for r in refs] for t, refs in ref_plan.placement.items()})
    rep_t, rep_r = got[4], want[4]
    rep_t.pop("backend"), rep_r.pop("backend")
    assert rep_t == rep_r
    actions = [e["action"] for e in got[0] if e is not None]
    reasons = [e["reason"] for e in got[0] if e is not None]
    assert "rebalance" in actions and "scripted" in reasons
    assert any(a == "rebalance" and r != "scripted" for a, r in zip(actions, reasons))
    assert len(got[1]) == len(actions)  # every swap rebound the EWMAs


# ---------------------------------------------------------------------------
# The locked reads: the repair of the reference's soak race
# ---------------------------------------------------------------------------

class OwnedLock:
    """A lock that knows which thread holds it (used with ``with`` only,
    as the front ends use theirs)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.owner = None

    def __enter__(self):
        self._lock.acquire()
        self.owner = threading.get_ident()
        return self

    def __exit__(self, *exc):
        self.owner = None
        self._lock.release()

    def held(self) -> bool:
        return self.owner == threading.get_ident()


class GuardedScheduler:
    """Every access to the scheduler asserts that the calling thread holds
    the front end's lock."""

    def __init__(self, inner, lock: OwnedLock):
        self.__dict__.update(_inner=inner, _guard=lock)

    def __getattr__(self, name):
        assert self._guard.held(), f"scheduler.{name} read without the front end's lock"
        return getattr(self._inner, name)


def _guarded(fe):
    fe._lock = OwnedLock()
    fe.scheduler = GuardedScheduler(fe.scheduler, fe._lock)
    return fe


@pytest.mark.parametrize("package", ["port", "reference"])
def test_collect_and_stop_read_the_scheduler_under_the_lock(package):
    ref_reg, reg = serving_registries()
    if package == "port":
        fe = AsyncCircuitServer(server_of(reg, 2))
        ctl = AutoscaleController(fe, HysteresisPolicy(device_cap=3))
    else:
        fe = RefFrontend(RefServer(ref_reg, backend="ref", policy=RefPlacement(n_shards=2)))
        ctl = RefController(fe, RefPolicy(device_cap=3))
        reg = ref_reg
    _guarded(fe)
    futs = [fe.enqueue(t, rows_for(reg, t, i, 3), deadline_s=60.0) for i, t in enumerate(reg)]
    if package == "reference":
        # the reference reads queue rows and EWMAs, and stop() reads the
        # pending count, without the lock: each trips the guard
        with pytest.raises(AssertionError, match="without the front end's lock"):
            ctl.collect()
        with pytest.raises(AssertionError, match="without the front end's lock"):
            fe.stop()
        return
    snap = ctl.collect()
    assert snap.queue_rows == 3 * len(futs) and set(snap.latency_s) == {0, 1}
    assert fe.queue_rows() == 3 * len(futs) and fe.pending_requests() == len(futs)
    fe.stop()  # never started: the drain reads the pending count locked
    assert all(f.done() and f.exception(0) is None for f in futs)
    assert fe.pending_requests() == 0


# ---------------------------------------------------------------------------
# Churn soak: swaps under live threaded traffic and tenant churn
# ---------------------------------------------------------------------------

def test_soak_churn_swaps_never_lose_requests():
    soak_s = 1.5
    reg = fleet(6, seed0=400)
    server = server_of(reg, 2)
    server.step([(t, RNG.randn(3, reg.get(t).encoder.n_features).astype(np.float32))
                 for t in reg])
    fe = AsyncCircuitServer(server)
    ctl = AutoscaleController(fe, HysteresisPolicy(patience=1, cooldown_s=0.05, max_shards=4,
                                                   device_cap=4, imbalance_high=1.3))
    circuits = {t: reg.get(t) for t in reg}
    extra = {f"x{i}": make_servable(450 + i, 5, 2, 35, 2) for i in range(4)}
    results: list = []  # (future, ServableCircuit, x)
    stop = threading.Event()
    errors: list = []

    def traffic(seed):
        rng = np.random.RandomState(seed)
        i = 0
        while not stop.is_set():
            live = [t for t in list(circuits) if t in reg]
            tenant = live[i % len(live)]
            sc = circuits.get(tenant)
            if sc is None:
                continue
            rows = 1 + (i * 7) % 24
            x = rng.randn(rows, sc.encoder.n_features).astype(np.float32)
            try:
                results.append((fe.enqueue(tenant, x, deadline_s=30.0), sc, x))
            except KeyError:
                pass  # lost the race with a churn remove: rejected at the door
            i += 1
            time.sleep(0.002)

    def churn():
        names = list(extra)
        j = 0
        while not stop.is_set():
            name = names[j % len(names)]
            if name in reg:
                reg.remove(name)
                circuits.pop(name, None)
            else:
                reg.add(name, extra[name])
                circuits[name] = extra[name]
            j += 1
            time.sleep(0.05)

    threads = [threading.Thread(target=traffic, args=(s,)) for s in (1, 2)]
    threads.append(threading.Thread(target=churn))
    scripted = [
        AutoscaleDecision("grow", 3, "soak"),
        AutoscaleDecision("rebalance", 3, "soak", 1.2),
        AutoscaleDecision("grow", 4, "soak"),
        AutoscaleDecision("shrink", 3, "soak"),
    ]
    forced = iter(scripted)
    n_steps = 2 * len(scripted)
    with fe:
        for t in threads:
            t.start()
        try:
            for _ in range(n_steps):
                ctl.step()
                decision = next(forced, None)
                if decision is not None:
                    for _ in range(5):
                        try:
                            ctl.apply(decision)
                            break
                        except StalePlanError:
                            continue
                time.sleep(soak_s / n_steps)
        except Exception as exc:  # noqa: BLE001 — fail the test, not the threads
            errors.append(exc)
        finally:
            stop.set()
            for t in threads:
                t.join(10.0)
    assert not any(t.is_alive() for t in threads)
    assert fe._thread is None  # the scheduler thread was joined by the context exit
    assert not errors, errors
    assert len(ctl.events) >= 3
    served = failed = 0
    for fut, sc, x in results:
        assert fut.done()
        if fut.exception() is not None:
            assert isinstance(fut.exception(), KeyError)  # a churned-away tenant
            failed += 1
            continue
        served += 1
        np.testing.assert_array_equal(fut.result(), predict(sc, x))
    assert served > 0
    assert served + failed == len(results)
    assert not server._results
    report = server.stats.report()
    assert report["n_rebalances"] == len(ctl.events)
    assert report["shards_reused_frac"] > 0.0
