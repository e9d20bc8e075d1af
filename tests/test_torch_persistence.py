"""The deprecated persistence aliases of the port against the reference.

`ServableCircuit.save`/`load` and `CircuitRegistry.save_dir`/`load_dir`
are the reference's one-more-release aliases over `save_servable` /
`load_servable` and `ArtifactStore` / `load_legacy_registry_dir`.  The
reference's cases (`tests/test_planning.py`: the digest across a save and
load, legacy ``@`` tenant names, an incoherent member group, the
``@m<digits>`` refusal, an ensemble fleet's round trip) run here on the
port, with circuits made by the reference and carried across; then a
directory written by either package is loaded by the other and must
predict bitwise the same class ids.
"""
import os
import warnings

import numpy as np
import pytest

from repro.core.api import ServableCircuit as RefServable
from repro.serve.circuits import CircuitRegistry as RefRegistry
from repro.serve.circuits import CircuitServer as RefServer
from repro_torch.core.api import ServableCircuit, load_servable, save_servable
from repro_torch.serve.circuits import CircuitRegistry, CircuitServer
from repro_torch.serve.planning import circuit_digest
from tests.torch_parity import SERVE_TENANTS, make_ref_servable, to_port

RNG = np.random.RandomState(11)


def make_servable(seed, n_feats, bits, n_nodes, n_classes) -> ServableCircuit:
    """A port servable carrying a reference-made circuit."""
    return to_port(make_ref_servable(seed, n_feats, bits, n_nodes, n_classes))


def predict(sc, x) -> np.ndarray:
    return sc.predict(x, device="cpu")


def _fleet_with_ensemble(make=make_servable, registry=CircuitRegistry):
    reg = registry()
    for i, shape in enumerate(SERVE_TENANTS):
        reg.add(f"t{i}", make(80 + i, *shape))
    reg.add_ensemble("ens", [make(90 + i, 6, 2, 50, 3) for i in range(3)])
    return reg


def test_each_alias_warns_and_wraps_the_canonical_call(tmp_path):
    sc = make_servable(5, 4, 2, 30, 2)
    with pytest.warns(DeprecationWarning, match="save_servable"):
        path = sc.save(str(tmp_path / "a"))
    assert path.endswith(".npz")
    with pytest.warns(DeprecationWarning, match="load_servable"):
        back = ServableCircuit.load(path)
    canonical = load_servable(save_servable(sc, str(tmp_path / "b.npz")))
    assert circuit_digest(back) == circuit_digest(canonical) == circuit_digest(sc)
    reg = CircuitRegistry()
    reg.add("t", sc)
    with pytest.warns(DeprecationWarning, match="put_registry"):
        written = reg.save_dir(str(tmp_path / "store"))
    assert len(written) == 1
    with pytest.warns(DeprecationWarning, match="load_registry"):
        assert list(CircuitRegistry.load_dir(str(tmp_path / "store"))) == ["t"]


def test_circuit_digest_tracks_content(tmp_path):
    a = make_servable(5, 4, 2, 30, 2)
    b = ServableCircuit.load(a.save(str(tmp_path / "a.npz")))
    c = make_servable(6, 4, 2, 30, 2)
    # bit-identical artifact (save/load roundtrip) → identical digest
    assert circuit_digest(a) == circuit_digest(b)
    assert circuit_digest(a) != circuit_digest(c)


def test_load_dir_accepts_legacy_at_sign_tenant_names(tmp_path):
    """Directories written before '@m<idx>' was reserved restore their
    names verbatim; only a well-formed member group parses as an
    ensemble; the restored fleet saves again, and a name in the reserved
    member shape is refused."""
    sc = make_servable(33, 4, 2, 30, 2)
    for stem in ("model@v2", "exp@2", "pad@m00", "ens@m0", "ens@m1", "a", "a@m0", "a@m1"):
        sc.save(str(tmp_path / f"{stem}.circuit.npz"))
    restored = CircuitRegistry.load_dir(str(tmp_path))
    assert set(restored) == {"model@v2", "exp@2", "pad@m00", "ens", "a", "a@m0", "a@m1"}
    assert len(restored.members("exp@2")) == 1
    assert len(restored.members("ens")) == 2
    x = RNG.randn(5, 4).astype(np.float32)
    np.testing.assert_array_equal(predict(restored.get("model@v2"), x), predict(sc, x))
    keep = CircuitRegistry()
    for t in ("model@v2", "exp@2", "pad@m00"):
        keep.add(t, restored.get(t))
    out = tmp_path / "resaved"
    keep.save_dir(str(out))
    assert set(CircuitRegistry.load_dir(str(out))) == set(keep)
    reg = CircuitRegistry()
    reg.add("bad@m7", sc)
    with pytest.raises(ValueError, match="reserved"):
        reg.save_dir(str(tmp_path / "nope"))


def test_load_dir_incoherent_member_group_restores_plain_tenants(tmp_path):
    a = make_servable(41, 4, 2, 30, 2)
    b = make_servable(42, 7, 2, 30, 3)  # different width AND classes
    a.save(str(tmp_path / "y@m0.circuit.npz"))
    b.save(str(tmp_path / "y@m1.circuit.npz"))
    restored = CircuitRegistry.load_dir(str(tmp_path))
    assert set(restored) == {"y@m0", "y@m1"}
    x = RNG.randn(3, 7).astype(np.float32)
    np.testing.assert_array_equal(predict(restored.get("y@m1"), x), predict(b, x))


def test_ensemble_fleet_persistence_roundtrip(tmp_path):
    reg = _fleet_with_ensemble()
    reg.save_dir(str(tmp_path))
    restored = CircuitRegistry.load_dir(str(tmp_path))
    assert set(restored) == set(reg)
    assert len(restored.members("ens")) == 3
    x = RNG.randn(12, 6).astype(np.float32)
    np.testing.assert_array_equal(
        CircuitServer(restored, device="cpu").predict("ens", x),
        CircuitServer(reg, device="cpu").predict("ens", x))


def _ids(server_of, reg, tenants) -> dict:
    server = server_of(reg)
    return {t: server.predict(t, np.random.RandomState(7 + i).randn(
        9, reg.get(t).encoder.n_features).astype(np.float32)) for i, t in enumerate(tenants)}


def _port_server(reg):
    return CircuitServer(reg, device="cpu")


def _ref_server(reg):
    return RefServer(reg, backend="ref")


@pytest.mark.parametrize("legacy", [False, True], ids=["store", "legacy_dir"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_directory_written_by_either_package_loads_in_the_other(tmp_path, writer, legacy):
    """The same circuits in both packages; one writes a directory (a store
    by ``save_dir``, or a legacy flat directory of ``save`` bundles), the
    other loads it with ``load_dir``: the same tenants and members, and
    class ids equal bitwise to the writer's own registry."""
    ref = _fleet_with_ensemble(make_ref_servable, RefRegistry)
    port = CircuitRegistry()
    for t in ref:
        members = [to_port(m) for m in ref.members(t)]
        if len(members) > 1:
            port.add_ensemble(t, members)
        else:
            port.add(t, members[0])
    src = ref if writer == "reference" else port
    path = str(tmp_path / "dir")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        if legacy:
            os.makedirs(path)
            for t in src:
                members = src.members(t)
                for i, m in enumerate(members):
                    stem = t if len(members) == 1 else f"{t}@m{i}"
                    m.save(f"{path}/{stem}.circuit.npz")
        else:
            src.save_dir(path)
        if writer == "reference":
            loaded = CircuitRegistry.load_dir(path)
            got = _ids(_port_server, loaded, list(ref))
        else:
            loaded = RefRegistry.load_dir(path)
            got = _ids(_ref_server, loaded, list(ref))
    want = _ids(_ref_server, ref, list(ref))
    # the port's own registry answers as the reference's does
    assert all(np.array_equal(v, want[t]) for t, v in _ids(_port_server, port, list(ref)).items())
    assert set(loaded) == set(src)
    assert {t: len(loaded.members(t)) for t in loaded} == {t: len(src.members(t)) for t in src}
    for t in want:
        np.testing.assert_array_equal(got[t], want[t], err_msg=t)


def test_a_reference_bundle_loads_through_the_ports_alias(tmp_path):
    ref = make_ref_servable(3, 5, 2, 40, 3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        path = ref.save(str(tmp_path / "r.npz"))
        port = ServableCircuit.load(path)
        back = RefServable.load(port.save(str(tmp_path / "p.npz")))
    x = RNG.randn(16, 5).astype(np.float32)
    np.testing.assert_array_equal(predict(port, x), np.asarray(ref.predict(x)))
    np.testing.assert_array_equal(np.asarray(back.predict(x)), np.asarray(ref.predict(x)))
