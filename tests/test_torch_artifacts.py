"""The port's `ArtifactStore` and span-launch units against the reference,
on the CPU.

  * stores: a store either package writes, the other reads — the same
    tenants in the same order, the same pinned QoS, the same
    content-addressed objects, manifests equal as JSON; unknown versions
    are refused;
  * servers: a ``"torch-ref"`` server exports nothing and prewarms by
    running each launch shape once dead, as the reference's ``"ref"``
    does; preload skips the reference's ``"pallas"`` executables by
    backend and by format;
  * units (`repro_torch.runtime.aot`): a stored unit's program is
    bitwise the one `compile_program` makes of its shard, loading it
    compiles nothing, and corrupt bytes, a spec that does not match the
    arrays and a foreign kernel library are each refused.

Every comparison is exact.
"""
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from repro.runtime import aot as ref_aot
from repro.runtime import get_backend as ref_get_backend
from repro.runtime.base import BackendCapabilityError as RefCapabilityError
from repro.serve.artifacts import ArtifactStore as RefStore
from repro.serve.circuits import CircuitServer as RefServer
from repro.serve.circuits import TenantQoS as RefQoS
from repro.serve.planning import PlacementPolicy as RefPolicy
from repro.serve.planning import PlanCompiler as RefCompiler
from repro.serve.planning import circuit_digest as ref_digest
from repro_torch import runtime
from repro_torch.kernels import ref as plain
from repro_torch.kernels.program import compile_program
from repro_torch.runtime import aot
from repro_torch.serve.artifacts import STORE_FORMAT_VERSION, ArtifactStore
from repro_torch.serve.circuits import CircuitRegistry, CircuitServer, TenantQoS
from repro_torch.serve.planning import PlacementPolicy, PlanCompiler, circuit_digest
from tests.torch_parity import rows_for, serving_registries

QOS = dict(max_batch=64, max_wait_s=0.002, default_deadline_s=0.02)


def _pinned_registries():
    ref, port = serving_registries()
    ref.set_qos("t2", RefQoS(**QOS))
    port.set_qos("t2", TenantQoS(**QOS))
    return ref, port


def _manifest(root) -> dict:
    with open(os.path.join(str(root), "manifest.json")) as f:
        return json.load(f)


def _digests(reg) -> list:
    """Each tenant's name, pinned QoS and member digests (each package's
    own `circuit_digest`, equal for equal circuits)."""
    digest = ref_digest if type(reg).__module__.startswith("repro.") else circuit_digest
    return [(t, dataclasses.asdict(reg.qos(t)), [digest(m) for m in reg.members(t)])
            for t in reg]


def _check_loaded(loaded, source) -> None:
    """``loaded`` (read by one package) holds ``source``'s tenants in
    order, their pinned QoS and the same circuits."""
    assert _digests(loaded) == _digests(source)
    assert loaded.qos("t2").max_batch == QOS["max_batch"]


def test_port_store_loads_in_the_reference(tmp_path):
    ref, port = _pinned_registries()
    written = ArtifactStore(str(tmp_path)).put_registry(port)
    assert len(written) == sum(len(port.members(t)) for t in port)
    loaded = RefStore(str(tmp_path)).load_registry()
    _check_loaded(loaded, port)
    _check_loaded(loaded, ref)
    # the objects are the reference's own content addresses
    want = RefStore(str(tmp_path / "ref"))
    want.put_registry(ref)
    assert _manifest(tmp_path)["registry"] == _manifest(tmp_path / "ref")["registry"]


def test_reference_store_loads_in_the_port(tmp_path):
    ref, port = _pinned_registries()
    RefStore(str(tmp_path)).put_registry(ref)
    loaded = ArtifactStore(str(tmp_path)).load_registry()
    assert isinstance(loaded, CircuitRegistry)
    _check_loaded(loaded, ref)
    _check_loaded(loaded, port)
    server = CircuitServer(loaded, device="cpu")
    for tenant in loaded:
        x = rows_for(loaded, tenant, 4, 9)
        np.testing.assert_array_equal(server.predict(tenant, x),
                                      CircuitServer(port, device="cpu").predict(tenant, x))


def test_manifests_from_one_registry_are_equal(tmp_path):
    ref, port = _pinned_registries()
    RefStore(str(tmp_path / "ref")).put_registry(ref)
    ArtifactStore(str(tmp_path / "port")).put_registry(port)
    assert _manifest(tmp_path / "ref") == _manifest(tmp_path / "port")
    assert (sorted(os.listdir(tmp_path / "ref" / "objects"))
            == sorted(os.listdir(tmp_path / "port" / "objects")))
    # re-putting after a removal collects the orphaned object in both
    for reg, store in ((ref, RefStore(str(tmp_path / "ref"))),
                       (port, ArtifactStore(str(tmp_path / "port")))):
        reg.remove("t0")
        store.put_registry(reg)
    assert _manifest(tmp_path / "ref") == _manifest(tmp_path / "port")
    assert (sorted(os.listdir(tmp_path / "ref" / "objects"))
            == sorted(os.listdir(tmp_path / "port" / "objects")))


@pytest.mark.parametrize("field,value,match", [
    ("format_version", STORE_FORMAT_VERSION + 1, "unsupported store format"),
    ("format_version", 0, "unsupported store format"),
    ("kind", "something-else", "not an artifact-store manifest"),
])
def test_unknown_store_versions_are_refused(tmp_path, field, value, match):
    ArtifactStore(str(tmp_path)).flush()
    m = _manifest(tmp_path)
    m[field] = value
    (tmp_path / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(ValueError, match=match):
        ArtifactStore(str(tmp_path))
    with pytest.raises(ValueError, match=match):  # the reference refuses it too
        RefStore(str(tmp_path))


def test_store_executables_round_trip_and_survive_gc(tmp_path):
    _, port = _pinned_registries()
    store = ArtifactStore(str(tmp_path))
    store.put_registry(port)
    store.put_executable("cuda--cafe--s2", b"\x00\x01unit\xff", backend="cuda",
                         aot_format=aot.AOT_FORMAT,
                         aot_format_version=aot.AOT_FORMAT_VERSION,
                         spec=(4, 4, 40, 2, 10, 2))
    again = ArtifactStore(str(tmp_path))
    assert again.get_executable("cuda--cafe--s2") == b"\x00\x01unit\xff"
    entry = again.executable_entries()["cuda--cafe--s2"]
    assert (entry["backend"], entry["format"], entry["format_version"], entry["spec"]) == (
        "cuda", aot.AOT_FORMAT, aot.AOT_FORMAT_VERSION, [4, 4, 40, 2, 10, 2])
    with pytest.raises(KeyError):
        again.get_executable("cuda--unknown--s1")
    again.put_registry(port)  # gc keeps referenced executables
    assert again.get_executable("cuda--cafe--s2") == b"\x00\x01unit\xff"
    with pytest.raises(ValueError, match="filesystem-safe"):
        again.put_executable("../x", b"", backend="cuda", aot_format="", aot_format_version=1,
                             spec=())
    assert RefStore(str(tmp_path)).get_executable("cuda--cafe--s2") == b"\x00\x01unit\xff"


def test_torch_ref_server_exports_nothing_and_prewarm_runs_each_shape_dead(tmp_path):
    ref, port = serving_registries()
    server = CircuitServer(port, device="cpu", policy=PlacementPolicy(n_shards=2))
    ref_server = RefServer(ref, backend="ref", policy=RefPolicy(n_shards=2))
    store = ArtifactStore(str(tmp_path))
    store.put_registry(port)
    assert server.export_executables(store) == [] == ref_server.export_executables(
        RefStore(str(tmp_path / "ref")))
    assert store.executable_entries() == {}
    got = server.prewarm_plan(server.plan(), spans=[1, 4])
    want = ref_server.prewarm_plan(ref_server.plan(), spans=[1, 4])
    assert got == want and got["trace_warmed"] == 4
    assert server.aot_stats["trace_warms"] == 4 and server.aot_stats["compiles"] == 0
    # a repeat prewarm of the same shapes is a no-op
    assert server.prewarm_plan(server.plan(), spans=[1, 4])["trace_warmed"] == 0
    for tenant in port:
        x = rows_for(port, tenant, 5, 6)
        np.testing.assert_array_equal(server.predict(tenant, x), ref_server.predict(tenant, x))


def test_preload_skips_the_reference_executables(tmp_path):
    """A store holding the reference's "pallas" executables (by backend)
    and an entry of the reference's format under the port's backend name
    (by format): the port loads, compiles and fails nothing."""
    ref_reg, port = serving_registries()
    small = type(ref_reg)()
    small.add("t0", ref_reg.get("t0"))
    store_root = str(tmp_path)
    RefStore(store_root).put_registry(small)
    keys = RefServer(small, backend="pallas").export_executables(RefStore(store_root),
                                                                  spans=[1])
    assert keys and all(k.startswith("pallas--") for k in keys)
    store = ArtifactStore(store_root)
    assert store.executable_entries()[keys[0]]["format"] == ref_aot.AOT_FORMAT
    store.put_executable("torch-ref--" + keys[0].split("--", 1)[1], b"xla bytes",
                         backend="torch-ref", aot_format=ref_aot.AOT_FORMAT,
                         aot_format_version=ref_aot.AOT_FORMAT_VERSION, spec=(1,))
    reg = store.load_registry()
    server = CircuitServer(reg, device="cpu")
    summary = server.preload_executables(ArtifactStore(store_root))
    assert summary == {"loaded": 0, "compiled": 0, "trace_warmed": 0, "exec_warmed": 0,
                       "load_failures": 0, "skipped": 0}
    assert server.spans_seen() == ()
    x = rows_for(reg, "t0", 8, 5)
    np.testing.assert_array_equal(server.predict("t0", x), port.get("t0").predict(
        x, device="cpu"))


# -- span-launch units -------------------------------------------------------

def _plan(n_shards=2):
    _, port = serving_registries()
    return PlanCompiler("cuda", PlacementPolicy(n_shards=n_shards)).compile(port.catalog())


def _unit(shard, span, device="cpu"):
    return aot.compile_span_launch(runtime.get_backend("cuda"), aot.shard_spec(shard, span),
                                   shard, device=device)


def _launch_args(shard, span, seed):
    """A tick's launch buffers for ``shard``: random words, the slots in a
    shuffled order with one dead pad slot, back-to-back spans."""
    g = torch.Generator().manual_seed(seed)
    k = shard.n_slots
    x = torch.randint(-2**31, 2**31 - 1, (shard.n_inputs_max, k * span), generator=g,
                      dtype=torch.int32)
    slots = torch.randperm(k, generator=g).to(torch.int32)
    woff = torch.arange(k, dtype=torch.int32) * span
    live = torch.ones(k, dtype=torch.int32)
    live[-1] = 0
    return x, slots, woff, live


@pytest.mark.parametrize("span", [1, 8])
def test_unit_payload_round_trips_bitwise_without_a_compile(span):
    plan = _plan()
    for shard in plan.shards:
        before = aot.compile_count()
        unit = _unit(shard, span)
        assert aot.compile_count() == before + 1
        want = compile_program(shard.opcodes, shard.edge_src, shard.out_src,
                               shard.n_inputs_max)
        payload = aot.serialize_executable(unit)
        assert isinstance(payload, bytes) and payload[:2] == b"PK"  # an npz
        count = aot.compile_count()
        back = aot.deserialize_executable(payload, device="cpu")
        assert aot.compile_count() == count  # loading compiles nothing
        assert back.spec == unit.spec == aot.shard_spec(shard, span)
        for name in ("gates", "n_live", "rows", "n_rows", "taps"):
            assert torch.equal(getattr(back.program, name), getattr(want, name)), name
        assert back.program.n_inputs == want.n_inputs
        np.testing.assert_array_equal(back.in_width.numpy(), shard.in_width)
        # the loaded unit launches what the reference's fused tick computes
        args = _launch_args(shard, span, seed=shard.shard)
        x, slots, woff, live = args
        got = back(*args)
        assert torch.equal(got, unit(*args))
        sl = slots.numpy()
        ref_out = ref_get_backend("ref").eval_population_spans(
            shard.opcodes[sl], shard.edge_src[sl], shard.out_src[sl],
            x.numpy().view(np.uint32), woff.numpy(), shard.in_width[sl] * live.numpy(),
            span_words=span)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(ref_out))


def test_unit_spec_and_key_follow_the_reference():
    plan = _plan()
    ref_reg = serving_registries()[0]
    ref_plan = RefCompiler("ref", RefPolicy(n_shards=2)).compile(ref_reg.catalog())
    ref_server = RefServer(ref_reg, backend="ref")
    for shard, ref_shard in zip(plan.shards, ref_plan.shards):
        for span in (1, 64):
            assert tuple(aot.shard_spec(shard, span)) == tuple(
                ref_server._span_spec(ref_shard, span))
            assert aot.executable_key("cuda", shard.content_hash, span) == \
                ref_aot.executable_key("cuda", ref_shard.content_hash, span)
    assert aot.shard_spec(plan.shards[0], 4).x_words == plan.shards[0].n_slots * 4


def test_unit_respan_shares_the_program_and_checks_its_buffers():
    shard = _plan(1).shards[0]
    unit = _unit(shard, 4)
    count = aot.compile_count()
    wide = unit.respan(16)
    assert aot.compile_count() == count
    assert wide.program is unit.program and wide.spec.span_words == 16
    args = _launch_args(shard, 16, seed=3)
    assert torch.equal(wide(*args), plain.eval_program_spans(
        unit.program, *args[:3], unit.in_width, args[3], span_words=16))
    with pytest.raises(ValueError, match="launch slots"):
        unit(*args)  # a span-16 buffer for a span-4 unit
    with pytest.raises(ValueError, match="not shard"):
        aot.compile_span_launch(runtime.get_backend("cuda"),
                                aot.shard_spec(shard, 4)._replace(n_outputs=9), shard,
                                device="cpu")


def test_torch_ref_refuses_span_launch_units_as_the_reference_refuses():
    shard = _plan(1).shards[0]
    spec = aot.shard_spec(shard, 1)
    with pytest.raises(runtime.BackendCapabilityError, match="supports_aot=False"):
        runtime.get_backend("torch-ref").compile_spans(spec, shard, device="cpu")
    with pytest.raises(runtime.BackendCapabilityError, match="supports_aot=False"):
        runtime.get_backend("torch-ref").instrument(lambda *a, **k: None).compile_spans(
            spec, shard, device="cpu")
    with pytest.raises(RefCapabilityError, match="supports_aot=False"):
        ref_get_backend("ref").compile_spans(ref_aot.SpanLaunchSpec(*spec))
    # the kernels' backend makes one, and its proxy passes the call through
    unit = runtime.get_backend("cuda").instrument(lambda *a, **k: None).compile_spans(
        spec, shard, device="cpu")
    assert isinstance(unit, aot.SpanLaunch) and unit.spec == spec


def _rewrite(payload: bytes, header=None, arrays=None) -> bytes:
    """A payload with some header fields or arrays replaced."""
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        parts = {k: np.array(z[k]) for k in z.files}
    head = json.loads(str(parts["header"]))
    head.update(header or {})
    parts["header"] = np.array(json.dumps(head))
    parts.update(arrays or {})
    buf = io.BytesIO()
    np.savez(buf, **parts)
    return buf.getvalue()


def _corrupt(case: str, payload: bytes, unit) -> bytes:
    spec = list(unit.spec)
    taps = unit.program.taps.numpy().copy()
    taps[0, 0] = unit.program.zero_code + 1
    return {
        "garbage": lambda: b"not a unit at all",
        "truncated": lambda: payload[: len(payload) // 2],
        "empty": lambda: b"",
        "spec_slots": lambda: _rewrite(payload, {"spec": [spec[0] + 1, *spec[1:]]}),
        "spec_outputs": lambda: _rewrite(payload, {"spec": [*spec[:3], spec[3] + 1,
                                                           *spec[4:]]}),
        "spec_inputs": lambda: _rewrite(payload, {"n_inputs": spec[4] + 1}),
        "spec_short": lambda: _rewrite(payload, {"spec": spec[:5]}),
        "foreign_library": lambda: _rewrite(payload, {
            "library": "circuit_eval_0000000000000000.so:sm_90a"}),
        "foreign_format": lambda: _rewrite(payload, {"format": ref_aot.AOT_FORMAT}),
        "newer_version": lambda: _rewrite(payload, {"format_version": 2}),
        "program_format": lambda: _rewrite(payload, {"program_format": "genome"}),
        "code_out_of_range": lambda: _rewrite(payload, arrays={"taps": taps}),
        "int64_arrays": lambda: _rewrite(payload, arrays={
            "gates": unit.program.gates.numpy().astype(np.int64)}),
        "missing_array": lambda: _rewrite(payload, arrays={"rows": np.zeros(0, np.int32)}),
    }[case]()


@pytest.mark.parametrize("case", ["garbage", "truncated", "empty", "spec_slots",
                                  "spec_outputs", "spec_inputs", "spec_short",
                                  "foreign_library", "foreign_format", "newer_version",
                                  "program_format", "code_out_of_range", "int64_arrays",
                                  "missing_array"])
def test_a_bad_payload_is_refused(case):
    unit = _unit(_plan(1).shards[0], 2)
    payload = aot.serialize_executable(unit)
    count = aot.compile_count()
    with pytest.raises(ValueError):
        aot.deserialize_executable(_corrupt(case, payload, unit), device="cpu")
    assert aot.compile_count() == count
    aot.deserialize_executable(payload, device="cpu")  # the intact one loads


def test_cold_work_counters_reset():
    aot.reset_compile_count()
    assert aot.compile_count() == 0
    compile_program(*(np.asarray(a) for a in (
        [[0]], [[[0, 1]]], [[2]])), 2)
    assert aot.compile_count() == 1
    aot.reset_compile_count()
    aot.reset_build_count()
    assert aot.compile_count() == 0 and aot.build_count() == 0
    assert aot.library_key().endswith(".so:sm_90a")


def test_span_launch_spec_is_the_reference_tuple():
    assert aot.SpanLaunchSpec._fields == ref_aot.SpanLaunchSpec._fields
    spec = aot.SpanLaunchSpec(3, 3, 40, 2, 10, 8)
    assert spec.x_words == ref_aot.SpanLaunchSpec(*spec).x_words == 24


def test_unit_entry_points_default_to_the_card(monkeypatch):
    shard = _plan(1).shards[0]
    unit = _unit(shard, 2)
    payload = aot.serialize_executable(unit)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = aot.shard_spec(shard, 2)
    with pytest.raises(runtime.NoCudaDeviceError):
        aot.compile_span_launch(runtime.get_backend("cuda"), spec, shard)
    with pytest.raises(runtime.NoCudaDeviceError):
        runtime.get_backend("cuda").compile_spans(spec, shard)
    with pytest.raises(runtime.NoCudaDeviceError):
        aot.deserialize_executable(payload)
    with pytest.raises(runtime.NoCudaDeviceError):
        CircuitServer(CircuitRegistry())


# ---------------------------------------------------------------------------
# legacy flat directories
# ---------------------------------------------------------------------------

def _legacy_layout(case, tmp_path):
    """A directory as the reference left it: flat ``<tenant>.circuit.npz``
    bundles (what `CircuitRegistry.save_dir` wrote before the store, one
    reference bundle per member), or today's `save_dir`."""
    from repro.core.api import save_servable as ref_save
    from repro.serve.circuits import CircuitRegistry as RefRegistry
    from tests.test_planning import make_servable

    sc = make_servable(33, 4, 2, 30, 2)
    names = {
        "at_sign_names": ["model@v2", "exp@2", "pad@m00", "ens@m0", "ens@m1",
                          "a", "a@m0", "a@m1"],
        "ensemble": ["e@m0", "e@m1", "e@m2", "plain"],
    }
    if case == "incoherent_group":   # different widths and classes: plain tenants
        ref_save(make_servable(41, 4, 2, 30, 2), str(tmp_path / "y@m0.circuit.npz"))
        ref_save(make_servable(42, 7, 2, 30, 3), str(tmp_path / "y@m1.circuit.npz"))
    elif case == "save_dir":
        reg = RefRegistry()
        reg.add("t0", sc)
        reg.add_ensemble("ens", [sc, make_servable(34, 4, 2, 40, 2)])
        with pytest.warns(DeprecationWarning):
            reg.save_dir(str(tmp_path))
    else:
        for name in names[case]:
            ref_save(sc, str(tmp_path / f"{name}.circuit.npz"))
    return str(tmp_path)


@pytest.mark.parametrize("case", ["at_sign_names", "ensemble", "incoherent_group", "save_dir"])
def test_legacy_registry_dir_loads_as_in_the_reference(case, tmp_path):
    """`load_legacy_registry_dir` restores the tenants, member groups and
    circuits the reference's reader restores from the same directory (a
    store written by today's `save_dir` holds no flat bundles: both read
    nothing, and the store itself loads)."""
    from repro.serve.artifacts import load_legacy_registry_dir as ref_load_legacy
    from repro_torch.serve.artifacts import load_legacy_registry_dir

    path = _legacy_layout(case, tmp_path)
    ref, port = ref_load_legacy(path), load_legacy_registry_dir(path)
    assert list(port) == list(ref)
    for t in ref:
        want, got = ref.members(t), port.members(t)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert ref_digest(b) == circuit_digest(a)
            x = np.random.RandomState(7).randn(9, b.encoder.n_features).astype(np.float32)
            np.testing.assert_array_equal(a.predict(x, device="cpu"), b.predict(x))
    if case == "save_dir":
        assert len(port) == 0
        stored = ArtifactStore(path).load_registry()
        assert list(stored) == ["t0", "ens"] and len(stored.members("ens")) == 2
    else:
        assert len(port) >= 2
