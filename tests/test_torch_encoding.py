"""Encode / pack / unpack and the dataset substrate against the reference."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import encoding as RE
from repro.data import tabular as RT
from repro_torch.core import encoding as E
from repro_torch.data import tabular as T
from tests.torch_parity import i32

DATASETS = [("iris", None), ("led", None), ("vehicle", None),
            ("higgs", 4096), ("nomao", 1500)]
STRATEGIES = ["quantize", "quantile", "gray", "onehot"]


@pytest.mark.parametrize("name,max_rows", DATASETS)
def test_load_dataset_is_byte_identical(name, max_rows):
    a = RT.load_dataset(name, max_rows=max_rows)
    b = T.load_dataset(name, max_rows=max_rows)
    assert (a.name, a.n_classes) == (b.name, b.n_classes)
    assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype
    assert a.x.tobytes() == b.x.tobytes() and a.y.tobytes() == b.y.tobytes()


def test_dataset_table_and_splits_match():
    assert T.DATASETS == RT.DATASETS
    ds_r, ds_t = RT.load_dataset("led"), T.load_dataset("led")
    for (a, b) in zip(RT.train_test_split(ds_r, seed=3),
                      T.train_test_split(ds_t, seed=3)):
        assert a.x.tobytes() == b.x.tobytes() and a.y.tobytes() == b.y.tobytes()
    for (ra, rb), (ta, tb) in zip(RT.kfold(ds_r, k=3), T.kfold(ds_t, k=3)):
        assert ra.y.tobytes() == ta.y.tobytes()
        assert rb.x.tobytes() == tb.x.tobytes()


@pytest.mark.parametrize("name,max_rows", DATASETS)
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("bits", [2, 4])
def test_encoder_and_packing_match(name, max_rows, strategy, bits):
    ds = T.load_dataset(name, max_rows=max_rows)
    enc_r = RE.fit_encoder(ds.x, RE.EncodingConfig(strategy, bits))
    enc_t = E.fit_encoder(ds.x, E.EncodingConfig(strategy, bits))
    np.testing.assert_array_equal(enc_t.thresholds, enc_r.thresholds)
    np.testing.assert_array_equal(enc_t.codes, enc_r.codes)
    assert enc_t.thresholds.dtype == enc_r.thresholds.dtype
    bits_r, bits_t = RE.encode(enc_r, ds.x), E.encode(enc_t, ds.x)
    assert bits_t.dtype == bits_r.dtype and bits_t.tobytes() == bits_r.tobytes()
    r = bits_t.shape[0]
    w = E.n_words(r)
    assert w == RE.n_words(r)
    packed_r = RE.pack_bits_rows(bits_r, w)
    packed_t = E.pack_bits_rows(bits_t, w)
    assert packed_t.dtype == np.uint32 and packed_t.flags.c_contiguous
    np.testing.assert_array_equal(packed_t, packed_r)
    unpacked_r = np.asarray(RE.unpack_words(jnp.asarray(packed_r), r))
    unpacked_t = E.unpack_words(i32(packed_t), r).numpy()
    np.testing.assert_array_equal(unpacked_t, unpacked_r)
    np.testing.assert_array_equal(unpacked_t.T, bits_t)


def test_encode_batched_matches():
    ds = T.load_dataset("vehicle")
    enc = E.fit_encoder(ds.x, E.EncodingConfig("quantile", 4))
    enc_r = RE.fit_encoder(ds.x, RE.EncodingConfig("quantile", 4))
    blocks = [ds.x[:7], ds.x[7:7], ds.x[7:100], ds.x[100:101]]
    bits_t, off_t = E.encode_batched(enc, blocks)
    bits_r, off_r = RE.encode_batched(enc_r, blocks)
    np.testing.assert_array_equal(bits_t, bits_r)
    np.testing.assert_array_equal(off_t, off_r)
    empty_t, eoff_t = E.encode_batched(enc, [])
    empty_r, eoff_r = RE.encode_batched(enc_r, [])
    assert empty_t.shape == empty_r.shape
    np.testing.assert_array_equal(eoff_t, eoff_r)


def test_unpack_high_bit_words():
    """Words with bit 31 set: the arithmetic shift on int32 must be masked."""
    words = np.array([[0x80000000, 0xFFFFFFFF, 0x7FFFFFFF]], np.uint32)
    want = np.asarray(RE.unpack_words(jnp.asarray(words), 90))
    got = E.unpack_words(i32(words), 90).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 31] == 1 and got[0, 30] == 0
