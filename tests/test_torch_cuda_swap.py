"""Span-launch units, prewarmed plan swaps and export → preload on the card.

Marked ``cuda``: each test skips when no CUDA device is present (decided
inside the fixture, never at import).  This file imports neither JAX nor
the reference package, so it runs where only torch is installed; its
registry is `chip_smoke.py`'s serving registry (the golden bundles, a
nomao-width tenant, six synthetic tenants and a 3-member ensemble):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_swap.py

Every comparison is exact (class ids, output words).
"""
import os

import numpy as np
import pytest
import torch

from chip_smoke import build_registry, golden
from repro_torch import runtime
from repro_torch.kernels import circuit_eval
from repro_torch.kernels import ref as plain
from repro_torch.runtime import aot
from repro_torch.serve.artifacts import ArtifactStore
from repro_torch.serve.circuits import CircuitServer
from repro_torch.serve.planning import PlacementPolicy, PlanCompiler, ensemble_vote


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def stack():
    """The serving registry and its request rows (made once per module,
    on the CPU; each test builds its own servers)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return build_registry(golden())


def _serve_all(server, reg, sources, rows=40):
    """One request per tenant, all in one tick, each held to the tenant's
    members' predict on the card (run first, so the programs those
    predicts compile are not the tick's).  Returns the ids per tenant and
    the programs the tick compiled."""
    want = {}
    for t in reg:
        ms = reg.members(t)
        want[t] = ensemble_vote(np.stack([m.predict(sources[t][0][:rows], device="cuda")
                                          for m in ms]), ms[0].n_classes)
    tickets = {t: server.submit(t, sources[t][0][:rows]) for t in reg}
    count = aot.compile_count()
    server.tick()
    compiled = aot.compile_count() - count
    out = {t: server.result(k) for t, k in tickets.items()}
    for t in reg:
        np.testing.assert_array_equal(out[t], want[t])
    return out, compiled


@pytest.mark.cuda
def test_ticks_launch_a_cached_span_launch_unit(cuda, stack):
    reg, sources = stack
    server = CircuitServer(reg, device="cuda")
    first, compiled = _serve_all(server, reg, sources)
    assert compiled == 1  # the one shard's program, at its first launch
    compiles = server.aot_stats["compiles"]
    assert compiles >= 1 and server.spans_seen()
    before = circuit_eval.EVAL_POPULATION_SPANS.launches
    hits = server.aot_stats["exec_hits"]
    again, compiled = _serve_all(server, reg, sources)
    assert server.aot_stats["compiles"] == compiles and compiled == 0  # no unit built again
    assert server.aot_stats["exec_hits"] > hits
    assert circuit_eval.EVAL_POPULATION_SPANS.launches == before + 1  # one launch, one shard
    for t in reg:
        np.testing.assert_array_equal(again[t], first[t])


@pytest.mark.cuda
def test_prewarmed_swap_builds_units_before_the_fence(cuda, stack):
    reg, sources = stack
    server = CircuitServer(reg, device="cuda")
    _serve_all(server, reg, sources)
    grow = PlanCompiler(server.backend, PlacementPolicy(n_shards=2))
    plan = grow.recompile(reg.catalog(), server.peek_plan())
    before = dict(server.aot_stats)
    count = aot.compile_count()
    event = server.swap_plan(plan, compiler=grow, action="grow")
    assert event.to_shards == 2
    assert server.aot_stats["compiles"] - before["compiles"] == 2  # both new shards
    assert server.aot_stats["exec_warms"] - before["exec_warms"] == 2  # and run dead
    assert aot.compile_count() == count + 2
    compiles = server.aot_stats["compiles"]
    _, compiled = _serve_all(server, reg, sources)  # the same span: every unit a hit
    assert server.aot_stats["compiles"] == compiles and compiled == 0


@pytest.mark.cuda
def test_export_then_preload_into_a_fresh_server_compiles_nothing(cuda, stack, tmp_path):
    reg, sources = stack
    server = CircuitServer(reg, device="cuda", policy=PlacementPolicy(n_shards=2))
    warm, _ = _serve_all(server, reg, sources)
    store = ArtifactStore(str(tmp_path))
    store.put_registry(reg)
    keys = server.export_executables(store)
    assert len(keys) == 2 * len(server.spans_seen())
    for key in keys:
        entry = store.executable_entries()[key]
        assert (entry["backend"], entry["format"]) == ("cuda", aot.AOT_FORMAT)
    loaded = ArtifactStore(str(tmp_path)).load_registry()
    cold = CircuitServer(loaded, device="cuda", policy=PlacementPolicy(n_shards=2))
    count = aot.compile_count()
    summary = cold.preload_executables(ArtifactStore(str(tmp_path)))
    assert summary["loaded"] == len(keys) == summary["exec_warmed"]
    assert summary["compiled"] == 0 and summary["load_failures"] == 0
    assert aot.compile_count() == count  # loading compiled nothing
    out, compiled = _serve_all(cold, loaded, sources)
    assert cold.aot_stats["compiles"] == 0 and compiled == 0
    for t in reg:
        np.testing.assert_array_equal(out[t], warm[t])


@pytest.mark.cuda
@pytest.mark.parametrize("damage", ["corrupt", "missing"])
def test_a_damaged_stored_unit_is_compiled_instead(cuda, stack, tmp_path, damage):
    reg, sources = stack
    server = CircuitServer(reg, device="cuda")
    warm, _ = _serve_all(server, reg, sources)
    store = ArtifactStore(str(tmp_path))
    store.put_registry(reg)
    keys = server.export_executables(store)
    target = os.path.join(str(tmp_path), store.executable_entries()[keys[0]]["path"])
    if damage == "corrupt":
        with open(target, "wb") as f:
            f.write(b"not a unit")
    else:
        os.unlink(target)
    cold = CircuitServer(ArtifactStore(str(tmp_path)).load_registry(), device="cuda")
    summary = cold.preload_executables(ArtifactStore(str(tmp_path)))
    assert summary["load_failures"] == 1 == cold.aot_stats["load_failures"]
    assert summary["compiled"] == 1 and summary["loaded"] == len(keys) - 1
    out, _ = _serve_all(cold, reg, sources)
    for t in reg:
        np.testing.assert_array_equal(out[t], warm[t])


@pytest.mark.cuda
def test_preload_skips_foreign_entries(cuda, stack, tmp_path):
    reg, sources = stack
    server = CircuitServer(reg, device="cuda")
    _serve_all(server, reg, sources)
    store = ArtifactStore(str(tmp_path))
    store.put_registry(reg)
    (key,) = server.export_executables(store, spans=[256])
    body = key.split("--", 1)[1]
    store.put_executable("pallas--" + body, b"xla", backend="pallas",
                         aot_format="xla-serialized-executable", aot_format_version=1, spec=(1,))
    store.put_executable("cuda--" + body.replace("--s256", "--s512"), b"xla", backend="cuda",
                         aot_format="xla-serialized-executable", aot_format_version=1, spec=(1,))
    cold = CircuitServer(store.load_registry(), device="cuda")
    summary = cold.preload_executables(ArtifactStore(str(tmp_path)))
    assert summary["loaded"] == 1 and summary["load_failures"] == 0
    assert cold.spans_seen() == (256,)


@pytest.mark.cuda
def test_a_unit_that_cannot_be_built_fails_the_tick(cuda, stack, monkeypatch):
    reg, sources = stack
    server = CircuitServer(reg, device="cuda")

    def refuse(*args, **kw):
        raise circuit_eval.CudaKernelError("refused")

    monkeypatch.setattr(server.backend, "compile_spans", refuse)
    before = circuit_eval.EVAL_POPULATION_SPANS.launches
    server.submit("tenant0", sources["tenant0"][0][:5])
    with pytest.raises(circuit_eval.CudaKernelError, match="refused"):
        server.tick()
    assert circuit_eval.EVAL_POPULATION_SPANS.launches == before  # nothing else ran


@pytest.mark.cuda
@pytest.mark.parametrize("span", [1, 256])
def test_span_launch_matches_the_plain_version_at_the_serve_shape(cuda, stack, span):
    reg, _ = stack
    shard = PlanCompiler("cuda").compile(reg.catalog()).shards[0]
    unit = runtime.get_backend("cuda").compile_spans(aot.shard_spec(shard, span), shard,
                                                     device="cuda")
    back = aot.deserialize_executable(aot.serialize_executable(unit), device="cuda")
    g = torch.Generator().manual_seed(span)
    k = shard.n_slots
    x = torch.randint(-2**31, 2**31 - 1, (shard.n_inputs_max, k * span), generator=g,
                      dtype=torch.int32)
    slots = torch.randperm(k, generator=g).to(torch.int32)
    woff = torch.arange(k, dtype=torch.int32) * span
    live = (torch.arange(k) % 5 != 4).to(torch.int32)
    want = plain.eval_program_spans(unit.program.to("cpu"), x, slots, woff,
                                    torch.from_numpy(np.array(shard.in_width, np.int32)), live,
                                    span_words=span)
    args = [t.to(cuda) for t in (x, slots, woff, live)]
    before = circuit_eval.EVAL_POPULATION_SPANS.launches
    for u in (unit, back):
        got = u(*args)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
    assert circuit_eval.EVAL_POPULATION_SPANS.launches == before + 2
    assert unit.config.threads == circuit_eval.threads_per_block(
        unit.program, span, k, torch.cuda.get_device_properties(0).multi_processor_count)
    with pytest.raises(ValueError, match="x_words"):  # a launch checks its words
        unit(args[0][:, :-1].contiguous(), *args[1:])
