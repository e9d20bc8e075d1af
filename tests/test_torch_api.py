"""ServableCircuit, its bundles and decode in the PyTorch port, against the
reference, bitwise."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as RA
from repro_torch import runtime
from repro_torch.core import api as A
from repro_torch.core import encoding as E
from repro_torch.core.genome import active_nodes, opcodes, validate_genome
from repro_torch.data import load_dataset
from repro_torch.kernels import ref as TR
from repro_torch.serve.planning import circuit_digest
from tests.torch_parity import bundle_of, make_ref_servable, to_port

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_golden")
SHAPES = [(4, 2, 40, 2), (7, 4, 80, 3), (10, 4, 120, 10)]


@pytest.fixture(params=range(len(SHAPES)))
def ref_sc(request):
    return make_ref_servable(request.param, *SHAPES[request.param])


def _rows(sc, n=77, seed=0):
    return np.random.RandomState(seed).randn(n, sc.encoder.n_features).astype(np.float32)


def test_servable_from_arrays_carries_every_field(ref_sc):
    sc = to_port(ref_sc)
    arrays, meta = bundle_of(ref_sc)
    assert sc.spec.n_inputs == ref_sc.spec.n_inputs
    assert sc.spec.fn_set == tuple(ref_sc.spec.fn_set)
    assert sc.n_classes == ref_sc.n_classes
    for name in ("gate_fn", "edge_src", "out_src"):
        t = getattr(sc.genome, name)
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), arrays[name])
    np.testing.assert_array_equal(sc.encoder.thresholds, arrays["enc_thresholds"])
    assert validate_genome(sc.genome, sc.spec)
    x = _rows(sc)
    np.testing.assert_array_equal(
        sc.predict(x, device="cpu"), ref_sc.predict(x, backend="ref"))


def test_port_bundle_round_trip(ref_sc, tmp_path):
    sc = to_port(ref_sc)
    sc = A.ServableCircuit(sc.spec, sc.genome, sc.encoder, sc.n_classes,
                           lineage={"parent_hash": "abc", "refit_generation": 1},
                           ref_stats=np.linspace(0, 1, sc.n_inputs, dtype=np.float32))
    path = A.save_servable(sc, str(tmp_path / "c"))
    assert path.endswith(".npz")
    back = A.load_servable(path)
    assert circuit_digest(back) == circuit_digest(sc)
    assert back.lineage == sc.lineage
    np.testing.assert_array_equal(back.ref_stats, sc.ref_stats)
    meta = A.read_servable_meta(path)
    assert meta["format_version"] == 2 and meta["validated_backend"] == "torch-ref"
    x = _rows(sc)
    np.testing.assert_array_equal(back.predict(x, device="cpu"), sc.predict(x, device="cpu"))


def test_reference_bundle_loads_in_port(ref_sc, tmp_path):
    path = RA.save_servable(ref_sc, str(tmp_path / "ref"))
    sc = A.load_servable(path)
    assert A.read_servable_meta(path) == RA.read_servable_meta(path)
    x = _rows(sc, 301, seed=1)
    np.testing.assert_array_equal(sc.predict(x, device="cpu"),
                                  ref_sc.predict(x, backend="ref"))


def test_port_bundle_loads_in_reference(ref_sc, tmp_path):
    sc = to_port(ref_sc)
    path = A.save_servable(sc, str(tmp_path / "port"))
    back = RA.load_servable(path)
    x = _rows(sc, 65, seed=2)
    np.testing.assert_array_equal(back.predict(x, backend="ref"),
                                  sc.predict(x, device="cpu"))
    np.testing.assert_array_equal(np.asarray(back.genome.edge_src),
                                  sc.genome.edge_src.numpy())


def test_bundle_bytes_match_reference(tmp_path):
    """Both writers produce the same arrays and the same metadata (up to
    the name of the backend each validated on)."""
    ref_sc = make_ref_servable(4, 5, 2, 30, 3)
    p_ref = RA.save_servable(ref_sc, str(tmp_path / "a"))
    p_port = A.save_servable(to_port(ref_sc), str(tmp_path / "b"))
    with np.load(p_ref) as za, np.load(p_port) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            if k == "meta":
                ma, mb = json.loads(str(za[k])), json.loads(str(zb[k]))
                ma.pop("validated_backend"), mb.pop("validated_backend")
                assert ma == mb
            else:
                assert za[k].dtype == zb[k].dtype
                assert za[k].tobytes() == zb[k].tobytes()


def test_load_rejects_foreign_files(tmp_path):
    np.savez(tmp_path / "x.npz", meta=json.dumps({"kind": "other"}))
    with pytest.raises(ValueError, match="not a ServableCircuit"):
        A.load_servable(str(tmp_path / "x.npz"))
    np.savez(tmp_path / "y.npz", meta=json.dumps(
        {"kind": A.SERVABLE_FORMAT_KIND, "format_version": 99}))
    with pytest.raises(ValueError, match="unsupported bundle format"):
        A.load_servable(str(tmp_path / "y.npz"))


@pytest.mark.parametrize("name", ["higgs", "led"])
def test_golden_bundles_predict_committed_ids(name):
    """Reference-fitted bundles predict the reference's committed ids on
    every row of the full dataset, through the plain version."""
    sc = A.load_servable(os.path.join(GOLDEN, f"{name}.circuit.npz"))
    want = np.load(os.path.join(GOLDEN, f"{name}.ids.npy"))
    ds = load_dataset(name)
    assert want.shape == (ds.n_rows,)
    got = sc.predict(ds.x, device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert active_nodes(sc.genome, sc.spec).any()


def test_golden_led_exercises_the_clamp():
    """The led bundle's raw output codes reach past its 10 classes, so the
    committed ids pin the clamp of codes 10-15 to class 9."""
    sc = A.load_servable(os.path.join(GOLDEN, "led.circuit.npz"))
    ds = load_dataset("led")
    bits = E.encode(sc.encoder, ds.x)
    xw = torch.from_numpy(E.pack_bits_rows(bits, E.n_words(ds.n_rows)).view(np.int32))
    out = TR.eval_circuit_packed(opcodes(sc.genome, sc.spec), sc.genome.edge_src,
                                 sc.genome.out_src, xw)
    raw = A.decode_predictions(out.numpy(), ds.n_rows, 16)
    assert sc.spec.n_outputs == 4 and (raw >= 10).any()
    want = np.load(os.path.join(GOLDEN, "led.ids.npy"))
    np.testing.assert_array_equal(want, np.minimum(raw, 9))


@pytest.mark.parametrize("n_out,n_classes,rows", [(1, 2, 70), (4, 10, 200), (3, 5, 33)])
def test_decode_predictions_matches_reference(n_out, n_classes, rows):
    rng = np.random.RandomState(n_out)
    w = E.n_words(rows)
    words = rng.randint(0, 2**32, (n_out, w), dtype=np.uint64).astype(np.uint32)
    words[0, 0] |= np.uint32(0x80000000)
    want = RA.decode_predictions(jnp.asarray(words), rows, n_classes)
    got_u32 = A.decode_predictions(words, rows, n_classes)
    got_i32 = A.decode_predictions(words.view(np.int32), rows, n_classes)
    np.testing.assert_array_equal(got_u32, want)
    np.testing.assert_array_equal(got_i32, want)
    assert got_u32.shape == (rows,) and got_u32.max() <= n_classes - 1


def test_predict_without_device_raises_without_cuda(monkeypatch):
    sc = to_port(make_ref_servable(0, *SHAPES[0]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(runtime.NoCudaDeviceError):
        sc.predict(_rows(sc))
