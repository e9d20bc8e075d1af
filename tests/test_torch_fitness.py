"""Fitness in the PyTorch port against the reference, bitwise.

Popcount, confusion counts and plain accuracy are integer work and must
match exactly.  Balanced accuracy is float32 and must match to the bit:
the search accepts a child on ``>=``, so one ulp changes its path.

The reference is held to its fitness as its search loop computes it:
jitted and vmapped over a population, from the circuit's output words,
with the dataset and mask as operands.  Op by op (as its `init_state`
scores the first parent) it sums the classes in another order when C is
a power of two of at least 4, and differs by an ulp there; the port's
``in_loop=False`` is held to that form (see `fitness._class_sum`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as RE
from repro.core import fitness as RF
from repro_torch.core import encoding as E
from repro_torch.core import fitness as F
from tests.torch_parity import i32, u32


def _packed(rows: int, n_classes: int, pop: int, seed: int):
    """Reference and port datasets of random labels, random circuit output
    words i32[P, O, W] and a random row mask.  From C = 3 on, the last
    class has no row at all and the first has none inside the mask, so
    absent classes are counted too."""
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 2, (rows, 5)).astype(np.uint8)
    y = rng.randint(0, n_classes - (n_classes > 2), rows)
    ref = RE.pack_dataset(bits, y, n_classes)
    port = E.pack_dataset(bits, y, n_classes, device="cpu")
    w = ref.x_words.shape[1]
    out = rng.randint(0, 2**32, (pop, ref.n_outputs, w), dtype=np.uint64).astype(np.uint32)
    # plant the right answer on some words so every class has hits
    out[:, :, ::3] = np.asarray(ref.y_words)[None, :, ::3]
    mask = np.asarray(RE.split_masks(rows, w, 0.5, seed)[0])
    if n_classes > 2:
        mask = mask & ~np.asarray(ref.class_words)[0]
    return ref, port, out, mask


def test_popcount_matches_population_count_with_the_high_bit_set():
    rng = np.random.RandomState(0)
    words = rng.randint(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    words[:8] = [0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFF,
                 0xAAAAAAAA, 0x55555555]
    assert (words >= 0x80000000).sum() > 1000
    want = np.asarray(jax.lax.population_count(jnp.asarray(words)))
    got = F.popcount(i32(words))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("rows,n_classes", [(33, 2), (200, 3), *((61 * c, c) for c in range(4, 11))])
def test_confusion_counts_match_reference_over_a_population(rows, n_classes):
    ref, port, out, mask = _packed(rows, n_classes, pop=5, seed=rows)
    correct, count = F.confusion_counts(i32(out), port, i32(mask))
    assert correct.shape == count.shape == (5, n_classes)
    for p in range(5):
        rc, rn = RF.confusion_counts(jnp.asarray(out[p]), ref, jnp.asarray(mask))
        np.testing.assert_array_equal(correct[p].numpy(), np.asarray(rc))
        np.testing.assert_array_equal(count[p].numpy(), np.asarray(rn))


@pytest.mark.parametrize("count_once", [False, True])
def test_confusion_counts_broadcast_masks_against_the_population(count_once):
    """(train, val) masks i32[2, 1, W] against outputs i32[P, O, W] give
    i32[2, P, C], each entry the single-mask count; also with the class
    counts of the masks passed in, counted once by `class_counts`, as the
    search passes them."""
    ref, port, out, mask = _packed(300, 3, pop=4, seed=7)
    masks = i32(np.stack([mask, ~mask & np.asarray(ref.mask_words)]))[:, None]
    pre = F.class_counts(port, masks) if count_once else None
    correct, count = F.confusion_counts(i32(out), port, masks, pre)
    assert correct.shape == count.shape == (2, 4, 3)
    masks = masks[:, 0].numpy().view(np.uint32)
    for s in range(2):
        for p in range(4):
            rc, rn = RF.confusion_counts(jnp.asarray(out[p]), ref, jnp.asarray(masks[s]))
            np.testing.assert_array_equal(correct[s, p].numpy(), np.asarray(rc))
            np.testing.assert_array_equal(count[s, p].numpy(), np.asarray(rn))


ROWS_PER_CLASS = 64


def _words_with_counts(ref, correct, count):
    """Output words i32[P, O, W] and a mask u32[W] over ``ref`` (class c on
    rows [64c, 64c + 64)) whose confusion counts are ``correct`` [P, C]
    and ``count`` [C]: the first count[c] rows of class c are in the mask,
    and the first correct[p, c] of those predict c, the rest c + 1."""
    n_classes = count.shape[0]
    codes = RE.class_code_bits(n_classes, ref.n_outputs)
    rank = np.arange(n_classes * ROWS_PER_CLASS) % ROWS_PER_CLASS
    cls = np.arange(n_classes * ROWS_PER_CLASS) // ROWS_PER_CLASS
    w = ref.x_words.shape[1]
    mask = RE.pack_bits_rows((rank < count[cls])[:, None].astype(np.uint8), w)[0]
    right = rank[None] < correct[:, cls]                       # (P, rows)
    pred = np.where(right, cls, (cls + 1) % n_classes)
    out = np.stack([RE.pack_bits_rows(codes[p], w) for p in pred])
    return out, mask


@pytest.mark.parametrize("n_classes", range(2, 11))
def test_balanced_accuracy_from_counts_is_bitwise_the_reference(n_classes):
    """250 random count vectors per C, four correct-count vectors each
    (absent classes, and no class or one class present, included), held to
    the reference's search form."""
    rows = n_classes * ROWS_PER_CLASS
    y = np.arange(rows) // ROWS_PER_CLASS
    ref = RE.pack_dataset(np.zeros((rows, 1), np.uint8), y, n_classes)
    search_form = jax.jit(jax.vmap(RF.balanced_accuracy, in_axes=(0, None, None)))
    rng = np.random.RandomState(n_classes)
    for trial in range(250):
        count = rng.randint(0, ROWS_PER_CLASS + 1, n_classes)
        count[rng.rand(n_classes) < 0.2] = 0                  # absent classes
        if trial < 2:
            count[trial:] = 0                                 # none, or one, present
        correct = (count * rng.rand(4, n_classes)).astype(np.int64)
        out, mask = _words_with_counts(ref, correct, count)
        want = np.asarray(search_form(jnp.asarray(out), ref, jnp.asarray(mask)))
        c, n = (np.asarray(a) for a in RF.confusion_counts(jnp.asarray(out[0]), ref,
                                                           jnp.asarray(mask)))
        np.testing.assert_array_equal((c, n), (correct[0], count))
        got = F.balanced_accuracy_from_counts(correct.astype(np.int32),
                                              count.astype(np.int32))
        assert got.dtype == np.float32 and got.shape == (4,)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n_classes", range(2, 11))
def test_balanced_accuracy_from_counts_op_by_op_is_bitwise_the_reference(n_classes):
    """``in_loop=False``: the reference's fitness op by op (as its
    `init_state` computes the first parent's), which sums left to right
    for every C; 4,000 random count vectors per C."""
    rng = np.random.RandomState(n_classes)
    count = rng.randint(0, 60000, (4000, n_classes)).astype(np.int32)
    count[rng.rand(4000, n_classes) < 0.2] = 0        # absent classes
    count[:3] = 0                                     # no class present
    count[3:6, 1:] = 0                                # one class present
    correct = (count * rng.rand(4000, n_classes)).astype(np.int32)
    want = np.asarray(jax.vmap(RF.balanced_accuracy_from_counts)(correct, count))
    got = F.balanced_accuracy_from_counts(correct, count, in_loop=False)
    assert got.dtype == np.float32 and got.shape == (4000,)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_balanced_accuracy_from_counts_takes_tensors():
    correct = torch.tensor([[3, 0, 5]], dtype=torch.int32)
    count = torch.tensor([[7, 0, 9]], dtype=torch.int32)
    want = RF.balanced_accuracy_from_counts(jnp.asarray(correct[0].numpy()),
                                            jnp.asarray(count[0].numpy()))
    got = F.balanced_accuracy_from_counts(correct, count)
    assert got.view(np.uint32)[0] == np.float32(want).view(np.uint32)


@pytest.mark.parametrize("rows,n_classes", [(64, 2), (250, 3), *((70 * c, c) for c in range(4, 11))])
def test_balanced_and_plain_accuracy_match_reference(rows, n_classes):
    ref, port, out, mask = _packed(rows, n_classes, pop=3, seed=rows + 1)
    ba = F.balanced_accuracy(i32(out), port, i32(mask))
    pa = F.plain_accuracy(i32(out), port, i32(mask))
    assert ba.shape == pa.shape == (3,)
    for p in range(3):
        o = jnp.asarray(out[p])
        want_ba = np.float32(jax.jit(RF.balanced_accuracy)(o, ref, jnp.asarray(mask)))
        want_pa = np.float32(RF.plain_accuracy(o, ref, jnp.asarray(mask)))
        assert ba[p].view(np.uint32) == want_ba.view(np.uint32)
        assert pa[p].view(np.uint32) == want_pa.view(np.uint32)


def test_predicted_class_ids_and_row_accuracy_match_reference():
    rows = 77
    rng = np.random.RandomState(3)
    words = rng.randint(0, 2**32, (3, E.n_words(rows)), dtype=np.uint64).astype(np.uint32)
    got = F.predicted_class_ids(i32(words), rows)
    want = np.asarray(RF.predicted_class_ids(jnp.asarray(words), rows))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    y = rng.randint(0, 8, rows)
    valid = rng.rand(rows) < 0.7
    assert F.balanced_accuracy_rows(got.numpy(), y, valid, 8) == \
        RF.balanced_accuracy_rows(want, y, valid, 8)


def test_words_cross_unchanged():
    """The port's words are the reference's bits (a sanity check of the
    helpers the comparisons above rest on)."""
    _, port, out, _ = _packed(40, 3, pop=1, seed=0)
    np.testing.assert_array_equal(u32(i32(out)), out)
    assert port.x_words.dtype == torch.int32
