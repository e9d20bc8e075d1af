"""The multi-host fleet on the PyTorch port, against the reference, on the CPU.

Both packages drive the same cases; circuits are made by the reference and
cross as the reference's bundles through the port's `load_bundle` (its
`load_servable`).  Exact wherever the reference is deterministic:

  * **plan** — ring owners, `FleetPlan` assignments, pins and content
    hashes, the planner's LPT moves;
  * **workload** — generated traces, the bytes `save_trace` writes, the
    committed ``benchmarks/workloads/fleet_smoke.jsonl.gz`` and its
    feature rows;
  * **transport** — frames for the same payload, byte for byte;
  * **cadence** — fire decisions and reports under one fake clock;
  * **host** — every RPC reply but its timing fields (rates, latencies,
    wall times) and the backend's name (``torch-ref`` against ``ref``);
    exported bundles compared decoded;
  * **router** — replay ids on two hosts and on one, `MigrationEvent`s
    but ``duration_s``, the routing table across join and leave, and the
    fleet manifest each package exports, read by the other.

The port runs with ``device="cpu"``, the reference with ``backend="ref"``.
"""
import dataclasses
import gzip
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from repro.serve import fleet as RF
from repro.serve.artifacts import ArtifactStore as RefStore
from repro.serve.circuits import CircuitRegistry as RefRegistry
from repro.serve.fleet import transport as ref_transport
from repro.serve.fleet.workload import chunked as ref_chunked
from repro_torch.device import NoCudaDeviceError
from repro_torch.serve import fleet as PF
from repro_torch.serve.artifacts import ArtifactStore
from repro_torch.serve.circuits import CircuitRegistry
from repro_torch.serve.fleet import transport as port_transport
from repro_torch.serve.fleet.workload import chunked
from repro_torch.serve.observability import TraceRecorder
from tests.test_fleet import make_circuits, make_servable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_TRACE = os.path.join(REPO, "benchmarks", "workloads", "fleet_smoke.jsonl.gz")
# reply keys that time something (wall and tick times, rates, the tick's
# phase split), and the backend label, left out of the RPC comparisons
UNTIMED_OUT = {"qps", "phase_breakdown", "backend"}


def timed(key: str) -> bool:
    return key in UNTIMED_OUT or key.endswith(("_ms", "_s"))


def carry(sc):
    """A reference circuit as the port loads it: the reference's bundle
    bytes through the port's `load_bundle`."""
    return PF.load_bundle(RF.dump_bundle(sc, "ref"))


def same_circuit(a, b) -> bool:
    """Decoded equality of two circuits of either package."""
    return (all(np.array_equal(np.asarray(x), np.asarray(y))
                for x, y in zip(a.genome, b.genome))
            and dataclasses.astuple(a.spec) == dataclasses.astuple(b.spec)
            and a.n_classes == b.n_classes
            and np.asarray(a.encoder.thresholds).tobytes()
            == np.asarray(b.encoder.thresholds).tobytes()
            and np.asarray(a.encoder.codes).tobytes() == np.asarray(b.encoder.codes).tobytes()
            and (a.encoder.strategy, a.encoder.bits) == (b.encoder.strategy, b.encoder.bits)
            and a.lineage == b.lineage)


def untimed(obj):
    """A reply with its timing fields and backend label removed."""
    if isinstance(obj, dict):
        return {k: untimed(v) for k, v in obj.items() if not timed(k)}
    if isinstance(obj, (list, tuple)):
        return [untimed(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return ("nd", obj.dtype.str, obj.shape, obj.tobytes())
    return obj


def ids_equal(a, b) -> bool:
    return (len(a) == len(b) and all(
        isinstance(x, np.ndarray) and isinstance(y, np.ndarray) and x.dtype == y.dtype
        and np.array_equal(x, y) for x, y in zip(a, b)))


def migrations(router):
    return [dataclasses.replace(m, duration_s=0.0).__dict__ for m in router.migrations]


def ref_fleet(host_ids=("h0", "h1"), tracer=None, circuits=None):
    router = RF.FleetRouter(tracer=tracer)
    for hid in host_ids:
        router.add_host(hid, RF.InProcTransport(RF.ServingHost(hid, RefRegistry(),
                                                               tracer=tracer)))
    for name, sc in (circuits or make_circuits()).items():
        router.register(name, [sc])
    return router


def port_fleet(host_ids=("h0", "h1"), tracer=None, circuits=None):
    router = PF.FleetRouter(tracer=tracer)
    for hid in host_ids:
        router.add_host(hid, PF.InProcTransport(PF.ServingHost(
            hid, CircuitRegistry(), device="cpu", tracer=tracer)))
    for name, sc in (circuits or make_circuits()).items():
        router.register(name, [carry(sc)])
    return router


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

RING_CASES = [
    (["h0", "h1"], [f"t{i}" for i in range(40)], 256),
    (["a", "b", "c", "d", "e"], [f"tenant{i}" for i in range(200)], 32),
    (["00", "1"], ["0"], 32),            # the reference's failing property input
    (["00", "1", "0"], ["0"], 32),       # ... with its joiner
    (["solo"], ["x", "y", "z"], 1),
]


@pytest.mark.parametrize("hosts,tenants,vnodes", RING_CASES)
def test_ring_owners_and_plan_hashes_equal_the_reference(hosts, tenants, vnodes):
    ref, port = RF.HashRing(hosts, vnodes=vnodes), PF.HashRing(hosts, vnodes=vnodes)
    assert port.hosts == ref.hosts
    assert port._points == ref._points and port._owners == ref._owners
    assert [port.owner(t) for t in tenants] == [ref.owner(t) for t in tenants]
    a = PF.FleetPlanner(vnodes=vnodes).plan(hosts, tenants, generation=3)
    b = RF.FleetPlanner(vnodes=vnodes).plan(hosts, tenants, generation=3)
    assert (a.hosts, a.assignment, a.pins, a.generation, a.content_hash) == (
        b.hosts, b.assignment, b.pins, b.generation, b.content_hash)


def test_ring_moves_on_the_reference_failing_input_equal_the_reference():
    """The input `test_join_moves_only_to_the_joiner` fails on in the
    reference (hosts '00' and '1', tenant '0', joiner '0'): the port's
    ring moves exactly the reference's tenants, to the same hosts."""
    hosts, tenants, joiner = ["00", "1"], ["0"], "0"
    moves = {}
    for name, pkg in (("ref", RF), ("port", PF)):
        before = pkg.HashRing(hosts, vnodes=32)
        after = pkg.HashRing(hosts + [joiner], vnodes=32)
        moves[name] = [(t, before.owner(t), after.owner(t)) for t in tenants]
    assert moves["port"] == moves["ref"]


PLANNER_CASES = {
    "ring_only": dict(loads=None, prev=None, imbalance_high=1.25),
    "skewed_loads": dict(loads="skew", prev=None, imbalance_high=1.25),
    "equal_loads": dict(loads="equal", prev=None, imbalance_high=1.0),
    "pins_carried": dict(loads=None, prev="pins", imbalance_high=1.25),
    "pins_and_loads": dict(loads="skew", prev="pins", imbalance_high=1.05),
}


@pytest.mark.parametrize("case", sorted(PLANNER_CASES))
def test_planner_equals_the_reference(case):
    """Pins survive while tenant and host do; LPT moves are the reference's."""
    kw = PLANNER_CASES[case]
    hosts = ["h0", "h1", "h2"]
    tenants = [f"t{i}" for i in range(12)]
    loads = {"skew": {t: 100.0 / (i + 1) for i, t in enumerate(tenants)},
             "equal": {t: 3.0 for t in tenants}, None: None}[kw["loads"]]
    plans = {}
    for name, pkg in (("ref", RF), ("port", PF)):
        planner = pkg.FleetPlanner(vnodes=64, imbalance_high=kw["imbalance_high"])
        prev = None
        if kw["prev"] == "pins":
            base = planner.plan(hosts + ["h3"], tenants, generation=1)
            prev = pkg.FleetPlan(hosts=base.hosts, assignment=base.assignment,
                                 pins={"t0": "h3", "t1": "h2", "ghost": "h0"},
                                 generation=1, content_hash=base.content_hash)
        plans[name] = planner.plan(hosts, tenants, loads=loads, prev=prev, generation=2)
        plans[name + "_moves"] = (planner._lpt_moves(plans[name].assignment, loads)
                                  if loads else [])
    a, b = plans["port"], plans["ref"]
    assert (a.hosts, a.assignment, a.pins, a.generation, a.content_hash) == (
        b.hosts, b.assignment, b.pins, b.generation, b.content_hash)
    assert plans["port_moves"] == plans["ref_moves"]
    assert a.tenants_of("h1") == b.tenants_of("h1") and a.n_hosts == b.n_hosts
    with pytest.raises(ValueError):
        PF.FleetPlanner(imbalance_high=0.9)
    with pytest.raises(ValueError):
        PF.HashRing([], vnodes=4).owner("t")


# ---------------------------------------------------------------------------
# workload
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["skew", "diurnal", "spike"])
def test_generated_traces_and_saved_bytes_equal_the_reference(shape, tmp_path):
    kw = dict(n_events=700, tenants=[f"tenant{i}" for i in range(6)], seed=11,
              duration_s=42.0)
    ref, port = RF.generate(shape, **kw), PF.generate(shape, **kw)
    assert port.meta == ref.meta
    assert [dataclasses.astuple(e) for e in port.events] == [
        dataclasses.astuple(e) for e in ref.events]
    assert port.tenants() == ref.tenants() and port.total_rows == ref.total_rows
    for e_port, e_ref in zip(port.events[:20], ref.events[:20]):
        assert e_port.features(5).tobytes() == e_ref.features(5).tobytes()
    for suffix in (".jsonl", ".jsonl.gz"):
        paths = {n: str(tmp_path / f"{n}{suffix}") for n in ("ref", "port")}
        assert RF.save_trace(ref, paths["ref"]) == PF.save_trace(port, paths["port"]) == 700
        raw = {}
        for n, p in paths.items():
            with open(p, "rb") as f:
                raw[n] = f.read()
            if suffix.endswith(".gz"):   # the gzip header stamps the time
                raw[n] = gzip.decompress(raw[n])
        assert raw["port"] == raw["ref"]
        back = PF.load_trace(paths["ref"])
        assert back.events == port.events and back.meta == port.meta
    assert [len(c) for c in chunked(port.events, 300)] == [
        len(c) for c in ref_chunked(ref.events, 300)] == [300, 300, 100]
    with pytest.raises(ValueError):
        PF.generate("flat", **kw)
    with pytest.raises(ValueError):
        list(chunked(port.events, 0))


def test_the_committed_trace_loads_in_the_port(tmp_path):
    """The CI leg's trace: 2,000 events, 7,436 rows, read from the
    repository without a download, and the reference's own reading."""
    port, ref = PF.load_trace(SMOKE_TRACE), RF.load_trace(SMOKE_TRACE)
    assert port.meta["format"] == "fleet-workload-v1"
    assert (port.n_events, port.total_rows) == (2000, 7436)
    assert port.events == tuple(PF.WorkloadEvent(*dataclasses.astuple(e))
                                for e in ref.events)
    assert all(p.features(7).tobytes() == r.features(7).tobytes()
               for p, r in zip(port.events[::97], ref.events[::97]))
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"format": "other"}\n')
    with pytest.raises(ValueError, match="not a fleet-workload-v1"):
        PF.load_trace(str(bad))


# ---------------------------------------------------------------------------
# transport codec
# ---------------------------------------------------------------------------

PAYLOADS = {
    "rows": {"tenant": "t0", "x": np.arange(12, dtype=np.float32).reshape(3, 4) / 7},
    "ids": {"y": [np.array([0, 3, 1], np.int32), np.array([], np.int64)]},
    "bundle": {"bundles": [b"\x00\x01npz", bytearray(b"xyz")], "qos": None},
    "scalars": {"n": np.int64(7), "f": np.float32(0.25), "ok": True, "none": None},
    "nested": {"work": [["t0", np.ones((2, 2), np.float32)], ["t1", np.zeros((1, 3))]],
               "k": {"deep": (1, 2.5, "s")}},
    "error": {"error": "StalePlanError", "message": "stale"},
    "uint32": {"w": np.array([[2**32 - 1, 5]], np.uint32)},
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_codec_frames_equal_the_reference_byte_for_byte(name):
    payload = PAYLOADS[name]
    frame = port_transport.encode_frame(payload)
    assert frame == ref_transport.encode_frame(payload)
    a, b = socket.socketpair()
    try:
        a.sendall(frame)
        got = port_transport.recv_frame(b)
    finally:
        a.close()
        b.close()
    assert untimed(got) == untimed(ref_transport._dec(ref_transport._enc(payload)))


def test_remote_errors_raise_as_their_local_types():
    for etype, cls in (("KeyError", KeyError), ("StalePlanError", PF.host.StalePlanError),
                       ("AdmissionError", port_transport.AdmissionError)):
        with pytest.raises(cls):
            port_transport._raise_remote({"error": etype, "message": "m"})
    with pytest.raises(PF.TransportError, match="remote Boom"):
        port_transport._raise_remote({"error": "Boom", "message": "m"})


# ---------------------------------------------------------------------------
# cadence
# ---------------------------------------------------------------------------

class FakeRouter:
    def __init__(self):
        self.rows_routed = 0
        self.calls = []

    def rebalance(self, reason):
        self.calls.append(reason)
        return ["moved"] if len(self.calls) % 2 else []


def test_cadence_fires_as_the_reference_does():
    now = [0.0]
    runs = {}
    for name, pkg in (("ref", RF), ("port", PF)):
        router, now[0] = FakeRouter(), 0.0
        cad = pkg.RebalanceCadence(router, interval_s=10.0, min_rows=50,
                                   clock=lambda: now[0])
        fired = []
        for step in range(40):
            now[0] = step * 1.7
            router.rows_routed += (step * 13) % 40
            fired.append(cad.tick())
        runs[name] = (fired, cad.report(), router.calls)
    assert runs["port"] == runs["ref"]
    assert runs["port"][1]["fires"] >= 2
    with pytest.raises(ValueError):
        PF.RebalanceCadence(FakeRouter(), interval_s=0)


# ---------------------------------------------------------------------------
# host RPCs
# ---------------------------------------------------------------------------

def rpc_script(sc_bytes, x):
    """The RPC sequence both hosts answer (method, payload)."""
    return [
        ("ping", {}),
        ("add_tenant", {"tenant": "t0", "bundles": [sc_bytes[0]],
                        "qos": {"max_batch": 16, "max_wait_s": 0.01,
                                "default_deadline_s": 0.5}}),
        ("add_tenant", {"tenant": "m1", "bundles": [sc_bytes[1]], "qos": None,
                        "action": "migrate_in"}),
        ("tenants", {}),
        ("step", {"work": [["t0", x[0]], ["ghost", x[0]], ["m1", x[1]], ["t0", x[0][:1]]]}),
        ("drain_tenant", {"tenant": "t0"}),
        ("stats", {}),
        ("remove_tenant", {"tenant": "m1", "action": "migrate_out"}),
        ("reset_stats", {}),
        ("stats", {}),
        ("ping", {}),
        ("evolution_step", {}),
        ("evolution_report", {}),
        ("feedback", {"tenant": "t0", "request_id": 1, "labels": np.zeros(1, np.int64)}),
    ]


def test_host_rpc_replies_equal_the_reference():
    rng = np.random.RandomState(1)
    circuits = [make_servable(1, 4, 2, 40, 2, rng), make_servable(2, 3, 2, 25, 4, rng)]
    raw = [RF.dump_bundle(sc, "ref") for sc in circuits]
    x = [rng.randn(5, 4).astype(np.float32), rng.randn(3, 3).astype(np.float32)]
    ref_tr = RF.InProcTransport(RF.ServingHost("hx", RefRegistry()))
    port_host = PF.ServingHost("hx", CircuitRegistry(), device="cpu")
    port_tr = PF.InProcTransport(port_host)
    for method, payload in rpc_script(raw, x):
        want, got = ref_tr.call(method, payload), port_tr.call(method, payload)
        assert untimed(got) == untimed(want), method
    assert port_tr.call("ping")["backend"] == "torch-ref"
    # the outbound half of a migration: the same circuit, decoded
    exp = port_tr.call("export_tenant", {"tenant": "t0"})
    ref_exp = ref_tr.call("export_tenant", {"tenant": "t0"})
    assert exp["qos"] == ref_exp["qos"]
    assert same_circuit(PF.load_bundle(exp["bundles"][0]), RF.load_bundle(ref_exp["bundles"][0]))
    assert same_circuit(RF.load_bundle(exp["bundles"][0]), circuits[0])
    for tr in (port_tr, ref_tr):
        tr.call("add_tenant", {"tenant": "m2", "bundles": [raw[1]], "action": "migrate_in"})
    assert [ev.action for ev in port_host.server.stats.rebalances] == ["migrate_in"]
    for tr in (port_tr, ref_tr):
        with pytest.raises(ValueError):
            tr.call("no_such_method", {})
        with pytest.raises(KeyError):
            tr.call("export_tenant", {"tenant": "ghost"})


def test_host_evolution_rpcs_equal_the_reference():
    """The reference's evolution RPC round trip (watch, submit, feedback,
    step, report) on both hosts: the same replies but timing."""
    from tests.test_evolution import make_servable as evo_servable
    from tests.test_evolution import stationary_rows

    sc = evo_servable(23, n_feats=4, n_classes=2, n_nodes=30)
    replies = {}
    for name, pkg, kw, reg in (("ref", RF, {"backend": "ref"}, RefRegistry()),
                               ("port", PF, {"device": "cpu"}, CircuitRegistry())):
        host = pkg.ServingHost("h0", reg, **kw)
        tr = pkg.InProcTransport(host)
        tr.call("add_tenant", {"tenant": "t", "bundles": [RF.dump_bundle(sc, "ref")]})
        host.start()
        try:
            out = [tr.call("evolution_watch", {"tenant": "t", "synchronous_refit": True,
                                               "accuracy_baseline": 0.9})]
            served = tr.call("submit", {"tenant": "t", "deadline_s": 5.0,
                                        "x": stationary_rows(32, n_feats=4, seed=1)})
            out.append(served)
            out.append(tr.call("feedback", {"tenant": "t", "request_id": served["request_id"],
                                            "labels": np.asarray(served["y"])}))
            out.append(tr.call("evolution_step", {}))
            out.append(tr.call("evolution_report", {}))
            replies[name] = out
            assert host.evolution.worker.synchronous
        finally:
            host.stop()
    assert untimed(replies["port"]) == untimed(replies["ref"])
    assert replies["port"][2]["accepted"] == 32 and replies["port"][4]["watched"] == 1


def test_host_refit_follows_the_host_device_and_defaults_to_the_card():
    host = PF.ServingHost("h0", CircuitRegistry(), device="cpu")
    mgr = host.enable_evolution(synchronous_refit=True)
    assert mgr.refit_cfg.device == torch.device("cpu")
    host.stop()
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDeviceError):
            PF.ServingHost("h1", CircuitRegistry())


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

def migrate_at_chunk(chunk, tenant_index=0):
    def on_chunk(ci, r):
        if ci == chunk:
            t = sorted(r.tenants())[tenant_index]
            dst = "h1" if r.owner_of(t) == "h0" else "h0"
            assert r.migrate(t, dst, reason="test") is not None
    return on_chunk


@pytest.mark.parametrize("hosts", [("h0", "h1"), ("solo",)], ids=["two_hosts", "one_host"])
def test_router_replay_ids_equal_the_reference(hosts):
    """Replay ids, bit for bit, on two hosts (a migration mid-replay) and on
    one; the two-host ids also equal the one-host ones."""
    tracer = TraceRecorder(capacity=50_000)
    ref, port = ref_fleet(hosts), port_fleet(hosts, tracer=tracer)
    assert {t: port.owner_of(t) for t in port.tenants()} == {
        t: ref.owner_of(t) for t in ref.tenants()}
    wl = PF.generate("skew", n_events=600, tenants=list(port.tenants()), seed=7)
    hook = migrate_at_chunk(1) if len(hosts) == 2 else None
    got = port.replay(wl.events, chunk_size=150, on_chunk=hook)
    want = ref.replay(wl.events, chunk_size=150, on_chunk=hook)
    assert ids_equal(got, want)
    assert migrations(port) == migrations(ref)
    assert len(port.migrations) == (1 if len(hosts) == 2 else 0)
    solo = port_fleet(("solo",))
    assert ids_equal(solo.replay(wl.events, chunk_size=600), got)
    rep, ref_rep = port.report(), ref.report()
    assert untimed(rep) == untimed(ref_rep)
    assert rep["router"]["requests_routed"] == wl.n_events
    names = {e.name for e in tracer.events()}
    assert {"fleet.router.chunk", "fleet.host.step"} <= names
    for r in (port, ref, solo):
        r.close(shutdown_hosts=False)


def test_router_cadence_rebalance_on_the_committed_trace_equals_the_reference():
    """The CI leg's configuration: the committed trace at chunk 500 on two
    hosts, a `RebalanceCadence` on the trace's clock; the migrations, ids
    and per-host reports equal the reference's."""
    wl = PF.load_trace(SMOKE_TRACE)
    circuits = {f"tenant{i}": make_servable(i, *shape, np.random.RandomState(i))
                for i, shape in enumerate([(4, 2, 40, 2), (7, 4, 80, 3), (3, 2, 25, 4),
                                           (10, 4, 120, 5)] * 2)}
    assert set(wl.tenants()) <= set(circuits)
    runs = {}
    for name, build, pkg in (("ref", ref_fleet, RF), ("port", port_fleet, PF)):
        router = build(circuits=circuits)
        now = [0.0]
        cad = pkg.RebalanceCadence(router, interval_s=wl.events[-1].t / 3, min_rows=500,
                                   clock=lambda: now[0])

        def on_chunk(ci, r, cad=cad, now=now):
            now[0] = wl.events[min((ci + 1) * 500, wl.n_events) - 1].t
            cad.tick()

        ids = router.replay(wl.events, chunk_size=500, on_chunk=on_chunk)
        runs[name] = (ids, migrations(router), cad.report(), untimed(router.report()),
                      router.plan.content_hash)
        router.close(shutdown_hosts=False)
    assert ids_equal(runs["port"][0], runs["ref"][0])
    assert runs["port"][1:] == runs["ref"][1:]
    assert runs["port"][2]["fires"] >= 1


def test_router_join_leave_and_load_rebalance_equal_the_reference():
    events = {}
    for name, build, pkg, host in (
            ("ref", ref_fleet, RF, lambda h: RF.ServingHost(h, RefRegistry())),
            ("port", port_fleet, PF, lambda h: PF.ServingHost(h, CircuitRegistry(),
                                                              device="cpu"))):
        router = build()
        joined = router.add_host("h2", pkg.InProcTransport(host("h2")))
        owners = {t: router.owner_of(t) for t in router.tenants()}
        left = router.remove_host("h2")
        hot = [t for t in router.tenants() if router.owner_of(t) == "h0"]
        wl = RF.generate("skew", n_events=400, tenants=hot, seed=5)
        router.replay(wl.events, chunk_size=200)
        moved = router.rebalance(reason="load-test")   # consumes the load window
        loads = router.observed_loads()
        events[name] = (joined.content_hash, owners, left.content_hash, loads,
                        [dataclasses.replace(m, duration_s=0.0) .__dict__ for m in moved],
                        migrations(router), dict(router.plan.pins))
        with pytest.raises(ValueError):
            router.add_host("h0", pkg.InProcTransport(host("h0")))
        router.close(shutdown_hosts=False)
    assert events["port"] == events["ref"]
    assert events["port"][4], "the skewed load must move a tenant"


def test_prometheus_fleet_section_takes_the_port_router():
    """`prometheus_text(fleet=router)` renders the port's live router as
    the reference renders the same report: on one fake clock, the reports
    are equal but for the host stats' rates, and the text of one report
    is the reference's byte for byte."""
    from repro.serve.observability import prometheus_text as ref_prometheus
    from repro_torch.serve.observability import prometheus_text

    wl = RF.generate("skew", n_events=200, tenants=[f"t{i}" for i in range(4)], seed=4)
    reports = {}
    for name, build in (("ref", ref_fleet), ("port", port_fleet)):
        router = build()
        router.clock = lambda: 5.0
        router.reset_stats()
        router.replay(wl.events, chunk_size=100)
        reports[name] = router
    port = reports["port"]
    text = prometheus_text(fleet=port)
    assert "repro_fleet_router_requests_routed 200" in text
    assert 'repro_fleet_host_requests_routed{host="h0"}' in text
    rep = port.report()
    assert prometheus_text(fleet=rep) == ref_prometheus(fleet=rep)
    assert untimed(rep) == untimed(reports["ref"].report())
    assert rep["router"]["qps"] == reports["ref"].report()["router"]["qps"]
    for r in reports.values():
        r.close(shutdown_hosts=False)


def test_router_refusals_match_the_reference():
    for pkg, host in ((RF, lambda h: RF.ServingHost(h, RefRegistry())),
                      (PF, lambda h: PF.ServingHost(h, CircuitRegistry(), device="cpu"))):
        router = pkg.FleetRouter()
        with pytest.raises(RuntimeError):
            router.register("t0", [])
        router.add_host("only", pkg.InProcTransport(host("only")))
        with pytest.raises(ValueError):
            router.add_host("other", pkg.InProcTransport(host("only")))
        sc = make_servable(0, 4, 2, 40, 2, np.random.RandomState(3))
        router.register("t0", [sc if pkg is RF else carry(sc)])
        with pytest.raises(ValueError):
            router.remove_host("only")
        with pytest.raises(KeyError):
            router.submit("ghost", np.zeros((1, 4), np.float32))
        with pytest.raises(KeyError):
            router.migrate("t0", "nowhere")
        router.close(shutdown_hosts=False)


def test_router_live_submit_and_migration_buffering():
    """Submits racing a migration park router-side and complete against
    the new owner (the reference's case on the port)."""
    router = port_fleet()
    hosts = {h: router._transports[h].host for h in router.hosts}
    for host in hosts.values():
        host.start()
    try:
        tenant = router.tenants()[0]
        src = router.owner_of(tenant)
        dst = "h1" if src == "h0" else "h0"
        x = np.zeros((2, make_circuits()[tenant].encoder.n_features), np.float32)
        baseline = router.submit(tenant, x, deadline_s=5.0).result(30.0)
        hold, release = threading.Event(), threading.Event()

        class SlowExport(PF.Transport):
            def __init__(self, inner):
                self.inner = inner

            def call(self, method, payload=None):
                if method == "export_tenant":
                    hold.set()
                    assert release.wait(30.0)
                return self.inner.call(method, payload)

        with router._lock:
            router._transports[src] = SlowExport(router._transports[src])
        mover = threading.Thread(target=router.migrate, args=(tenant, dst),
                                 kwargs={"reason": "buffer-test"}, daemon=True)
        mover.start()
        assert hold.wait(30.0)
        parked = router.submit(tenant, x, deadline_s=30.0)
        # the submit parks on a router thread: release the export only once
        # it has (the reference's test releases at once and races it)
        deadline = time.monotonic() + 30.0
        while True:
            with router._lock:
                if router._migrating.get(tenant):
                    break
            assert time.monotonic() < deadline, "the submit never parked"
            time.sleep(0.001)
        release.set()
        mover.join(30.0)
        assert not mover.is_alive() and router.owner_of(tenant) == dst
        np.testing.assert_array_equal(parked.result(30.0), baseline)
        assert router.migrations[-1].buffered >= 1
        np.testing.assert_array_equal(
            router.submit(tenant, x, deadline_s=30.0).result(30.0), baseline)
        np.testing.assert_array_equal(
            baseline, make_circuits()[tenant].predict(x))
    finally:
        for host in hosts.values():
            host.stop()
        router.close(shutdown_hosts=False)


# ---------------------------------------------------------------------------
# the fleet artifact
# ---------------------------------------------------------------------------

def test_fleet_manifests_are_read_by_the_other_package(tmp_path):
    """Each package exports its fleet; the other reads the section back
    (plan, pins, host configs), its registry holds the same circuits, and
    a port fleet booted from either store answers the live fleet's ids."""
    wl = RF.generate("skew", n_events=300, tenants=[f"t{i}" for i in range(4)], seed=3)
    ref, port = ref_fleet(), port_fleet()
    for r in (ref, port):
        r.replay(wl.events, chunk_size=100, on_chunk=migrate_at_chunk(0, 1))
    live = port.replay(wl.events, chunk_size=100)
    paths = {"ref": str(tmp_path / "ref"), "port": str(tmp_path / "port")}
    summaries = {"ref": ref.export_fleet(paths["ref"]), "port": port.export_fleet(paths["port"])}
    assert summaries["port"] == {**summaries["ref"], "path": paths["port"]}
    arts = {n: [pkg.FleetArtifact.load(store(paths[n])) for pkg, store in
                ((RF, RefStore), (PF, ArtifactStore))]
            for n in paths}
    for name, (read_by_ref, read_by_port) in arts.items():
        assert read_by_ref.to_manifest() == read_by_port.to_manifest()
    a, b = arts["port"][1], arts["ref"][1]
    assert (a.generation, a.content_hash, a.hosts, a.assignment, a.pins) == (
        b.generation, b.content_hash, b.hosts, b.assignment, b.pins)
    for h in a.host_configs:
        ca, cb = a.host_configs[h].to_manifest(), b.host_configs[h].to_manifest()
        assert (ca.pop("backend"), cb.pop("backend")) == ("torch-ref", "ref")
        assert ca == cb
    reg_ref = RefStore(paths["port"]).load_registry()
    reg_port = ArtifactStore(paths["ref"]).load_registry()
    for t in reg_ref:
        assert same_circuit(reg_ref.get(t), reg_port.get(t))
    for path in paths.values():
        booted = PF.FleetRouter.boot_from_artifact(path, device="cpu", start_hosts=False)
        assert booted.plan.content_hash == port.plan.content_hash
        assert ids_equal(booted.replay(wl.events, chunk_size=100), live)
        booted.close(shutdown_hosts=False)
    with pytest.raises(ValueError, match="no fleet section"):
        PF.FleetArtifact.load(ArtifactStore(str(tmp_path / "empty")))
    with pytest.raises(KeyError):
        PF.ServingHost.boot_from_artifact("ghost", paths["port"], device="cpu")
    for r in (ref, port):
        r.close(shutdown_hosts=False)


# ---------------------------------------------------------------------------
# socket and subprocess hosts
# ---------------------------------------------------------------------------

def test_socket_transport_answers_as_in_process():
    host = PF.ServingHost("sock0", CircuitRegistry(), device="cpu")
    ready = threading.Event()
    thread = threading.Thread(target=PF.serve_socket, args=(host,),
                              kwargs={"ready": ready}, daemon=True)
    thread.start()
    assert ready.wait(30.0)
    tr = PF.SocketTransport(ready.addr)
    rng = np.random.RandomState(4)
    sc = make_servable(4, 4, 2, 40, 2, rng)
    tr.call("add_tenant", {"tenant": "t0", "bundles": [RF.dump_bundle(sc, "ref")],
                           "qos": None})
    x = rng.randn(6, 4).astype(np.float32)
    out = tr.call("step", {"work": [["t0", x]]})["y"][0]
    assert out.dtype == sc.predict(x).dtype
    np.testing.assert_array_equal(out, sc.predict(x))
    with pytest.raises(KeyError):
        tr.call("export_tenant", {"tenant": "ghost"})
    assert tr.call("shutdown") == {"ok": True}
    thread.join(30.0)
    assert not thread.is_alive()
    tr.close()


def test_subprocess_host_serves_a_migrated_bundle():
    """A process host on the CPU starts empty, receives a reference-made
    bundle over the wire as a migration, and answers the reference's ids."""
    proc, addr = PF.spawn_host_process("proc0", device="cpu", timeout_s=120.0)
    try:
        tr = PF.SocketTransport(addr, connect_timeout_s=30.0)
        rng = np.random.RandomState(5)
        sc = make_servable(5, 3, 2, 25, 4, rng)
        tr.call("add_tenant", {"tenant": "t0", "bundles": [RF.dump_bundle(sc, "ref")],
                               "qos": None, "action": "migrate_in"})
        x = rng.randn(4, 3).astype(np.float32)
        out = tr.call("step", {"work": [["t0", x]]})["y"][0]
        np.testing.assert_array_equal(out, sc.predict(x))
        assert tr.call("ping")["backend"] == "torch-ref"
        assert tr.call("stats")["migrations_in"] == 1
        tr.call("shutdown")
        tr.close()
        assert proc.wait(60.0) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_a_host_process_that_fails_to_boot_raises(monkeypatch):
    monkeypatch.setattr(port_transport, "_HOST_MAIN",
                        "import sys; sys.stderr.write('no boot'); sys.exit(4)")
    with pytest.raises(PF.TransportError, match="exited with 4: no boot"):
        PF.spawn_host_process("bad", device="cpu", timeout_s=60.0)
