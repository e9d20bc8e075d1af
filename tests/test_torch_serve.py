"""The PyTorch port's serving tick against the reference's, on the same
registry and traffic: class ids per ticket, plan digests and content
hashes, and TickReport fields, all exactly."""
import numpy as np
import pytest
import torch

from repro.serve.circuits import CircuitRegistry as RefRegistry
from repro.serve.circuits import CircuitServer as RefServer
from repro.serve.planning import PlacementPolicy as RefPolicy
from repro.serve.planning import PlanCompiler as RefCompiler
from repro.serve.planning import circuit_digest as ref_digest
from repro.serve.planning import ensemble_vote as ref_vote
from repro_torch import runtime
from repro_torch.serve.circuits import CircuitRegistry, CircuitServer
from repro_torch.serve.observability import TraceRecorder
from repro_torch.serve.planning import PlacementPolicy, PlanCompiler, circuit_digest, ensemble_vote
from tests.torch_parity import make_ref_servable, to_port

# (features, bits/input, gates, classes) — the reference serving tests' mix
TENANT_SHAPES = [(4, 2, 40, 2), (7, 4, 80, 3), (3, 2, 25, 4), (10, 4, 120, 5)]
ENSEMBLE = [(7, 2, 30, 3), (7, 4, 50, 3), (7, 2, 64, 3)]  # one tenant, 3 voters


def _registries():
    """The same tenants in both packages: reference genomes, carried over."""
    ref, port = RefRegistry(), CircuitRegistry()
    for i, shape in enumerate(TENANT_SHAPES):
        sc = make_ref_servable(i, *shape)
        ref.add(f"t{i}", sc)
        port.add(f"t{i}", to_port(sc))
    members = [make_ref_servable(10 + k, *s, strategy=("quantize", "quantile", "gray")[k])
               for k, s in enumerate(ENSEMBLE)]
    ref.add_ensemble("ens", members)
    port.add_ensemble("ens", [to_port(m) for m in members])
    return ref, port


def _traffic(reg, seed, n_req=3):
    rng = np.random.RandomState(seed)
    work = []
    for tenant in reg:
        f = reg.get(tenant).encoder.n_features
        for _ in range(n_req):
            work.append((tenant, rng.randn(rng.randint(1, 90), f).astype(np.float32)))
    return work


def _serve(server, work):
    tickets = [server.submit(t, x) for t, x in work]
    report = server.tick()
    return [server.result(k) for k in tickets], report


@pytest.mark.parametrize("n_shards,assignment", [(1, "round_robin"), (2, "round_robin"),
                                                 (2, "balanced"), (3, "contiguous")])
def test_server_matches_reference(n_shards, assignment):
    ref_reg, reg = _registries()
    ref = RefServer(ref_reg, backend="ref",
                    policy=RefPolicy(n_shards=n_shards, assignment=assignment))
    port = CircuitServer(reg, device="cpu",
                         policy=PlacementPolicy(n_shards=n_shards, assignment=assignment))
    for seed in range(2):
        work = _traffic(reg, seed)
        want, rep_r = _serve(ref, work)
        got, rep_t = _serve(port, work)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for field in ("launches", "span_words", "occupancy", "rows", "tenants",
                      "requests", "plan_shards", "max_slots_per_launch",
                      "shard_stats", "tenant_rows", "generation"):
            assert getattr(rep_t, field) == getattr(rep_r, field), field
        assert rep_t.launches == n_shards  # one launch per shard with work
    assert port.stats.launches == ref.stats.launches


@pytest.mark.parametrize("span_align", [1, 8])
@pytest.mark.parametrize("n_shards", [1, 2])
def test_plan_hashes_match_reference(span_align, n_shards):
    ref_reg, reg = _registries()
    rp = RefCompiler("ref", RefPolicy(n_shards=n_shards, span_align=span_align)).compile(
        ref_reg.catalog())
    tp = PlanCompiler("torch-ref", PlacementPolicy(n_shards=n_shards, span_align=span_align)
                      ).compile(reg.catalog())
    assert tp.content_hash == rp.content_hash
    assert [s.content_hash for s in tp.shards] == [s.content_hash for s in rp.shards]
    for s_t, s_r in zip(tp.shards, rp.shards):
        for name in ("opcodes", "edge_src", "out_src", "in_width", "out_width", "n_classes"):
            np.testing.assert_array_equal(getattr(s_t, name), getattr(s_r, name))
    assert dict(tp.placement) == {t: tuple(tuple(r) for r in refs)
                                  for t, refs in rp.placement.items()}
    for tenant in reg:
        for a, b in zip(reg.members(tenant), ref_reg.members(tenant)):
            assert circuit_digest(a) == ref_digest(b)


def test_incremental_recompile_matches_reference():
    """Hot add / remove / replace keep both packages' plans identical."""
    ref_reg, reg = _registries()
    ref_c, port_c = (RefCompiler("ref", RefPolicy(n_shards=2)),
                     PlanCompiler("torch-ref", PlacementPolicy(n_shards=2)))
    rp, tp = ref_c.compile(ref_reg.catalog()), port_c.compile(reg.catalog())
    extra = make_ref_servable(42, 5, 2, 33, 2)
    ref_reg.add("new", extra)
    reg.add("new", to_port(extra))
    ref_reg.remove("t1")
    reg.remove("t1")
    swap = make_ref_servable(43, 4, 2, 40, 2)
    ref_reg.add("t0", swap, replace=True)
    reg.add("t0", to_port(swap), replace=True)
    rp2 = ref_c.recompile(ref_reg.catalog(), rp, max_imbalance=1.0)
    tp2 = port_c.recompile(reg.catalog(), tp, max_imbalance=1.0)
    assert tp2.content_hash == rp2.content_hash != tp.content_hash
    assert [s.content_hash for s in tp2.shards] == [s.content_hash for s in rp2.shards]


def test_removed_tenant_request_gets_key_error():
    _, reg = _registries()
    server = CircuitServer(reg, device="cpu")
    x = np.zeros((3, reg.get("t2").encoder.n_features), np.float32)
    ticket = server.submit("t2", x)
    keep = server.submit("t0", np.zeros((2, 4), np.float32))
    reg.remove("t2")
    report = server.tick()
    with pytest.raises(KeyError, match="removed"):
        server.result(ticket)
    assert server.result(keep).shape == (2,)
    assert report.requests == 2 and report.tenants == 1
    with pytest.raises(KeyError, match="unknown tenant"):
        server.submit("t2", x)


def test_step_isolates_bad_items_and_empty_ticks():
    _, reg = _registries()
    server = CircuitServer(reg, device="cpu")
    out = server.step([("t0", np.zeros((2, 4), np.float32)), ("nope", np.zeros((1, 4))),
                       ("t1", np.zeros((1, 3), np.float32)), ("t3", np.zeros((0, 10)))])
    assert out[0].shape == (2,)
    assert isinstance(out[1], KeyError) and isinstance(out[2], ValueError)
    assert out[3].shape == (0,)
    empty = server.tick()
    assert empty.launches == 0 and empty.rows == 0


def test_predict_and_ensemble_vote_match_reference():
    ref_reg, reg = _registries()
    x = np.random.RandomState(9).randn(200, 7).astype(np.float32)
    ref = RefServer(ref_reg, backend="ref")
    port = CircuitServer(reg, device="cpu")
    np.testing.assert_array_equal(port.predict("ens", x), ref.predict("ens", x))
    members = [m.predict(x, device="cpu") for m in reg.members("ens")]
    np.testing.assert_array_equal(port.predict("ens", x), ensemble_vote(np.stack(members), 3))
    ids = np.random.RandomState(1).randint(0, 4, (4, 50))
    np.testing.assert_array_equal(ensemble_vote(ids, 4), ref_vote(ids, 4))


def test_tick_records_trace_spans():
    _, reg = _registries()
    tracer = TraceRecorder()
    server = CircuitServer(reg, device="cpu", tracer=tracer,
                           policy=PlacementPolicy(n_shards=2))
    _serve(server, _traffic(reg, 3, n_req=1))
    names = [e.name for e in tracer.events() if e.phase == "B"]
    assert names.count("backend.eval_population_spans") == 2
    for phase in ("tick", "tick.encode_pack", "tick.device_put", "tick.launch",
                  "tick.readback", "tick.decode"):
        assert phase in names
    report = server.stats.report()
    assert report["backend"] == "torch-ref" and report["launches"] == 2


def test_server_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(runtime.NoCudaDeviceError):
        CircuitServer(CircuitRegistry())
