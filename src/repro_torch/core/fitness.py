"""Fitness = balanced accuracy (paper §3.3) on packed words, PyTorch port.

The packed path reduces circuit outputs to per-class (correct, count)
confusion sums with a popcount, on whatever device the words lie.  The
sums cross to the host, where the balanced accuracy is computed in
float32 exactly as the reference computes it (`_class_sum`): one recall
per class, summed over the classes in the reference's order, divided by
the number of classes present.  One ulp matters: a child
replaces the parent on ``>=`` (neutral drift), so a fitness that differs
in its last bit can change the search.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.encoding import PackedDataset, unpack_words

_M1, _M2, _M4 = 0x55555555, 0x33333333, 0x0F0F0F0F


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each ``int32`` word (its ``uint32`` pattern) → int32.

    Torch has no popcount and no usable ``uint32``, so this is the SWAR
    count of the low 31 bits plus the sign bit.  Every shifted value is
    masked and every intermediate is non-negative and below 2**31, so the
    arithmetic ``>>`` of int32 acts as a logical shift and no step
    overflows.  After the nibble step each byte holds its own count, and
    the four bytes of a word are summed through a byte view."""
    x = x.to(torch.int32)
    v = x & 0x7FFFFFFF
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v & _M4) + ((v >> 4) & _M4)                 # per byte: <= 8
    per_byte = v.unsqueeze(-1).view(torch.uint8)     # (..., 4)
    return per_byte.sum(-1, dtype=torch.int32) + (x < 0).to(torch.int32)


def _eq_words(out_words: torch.Tensor, y_words: torch.Tensor) -> torch.Tensor:
    """i32[..., W] with bit r set iff all O predicted bits equal the label
    code bits for row r (``out_words`` is i32[..., O, W])."""
    eq = ~(out_words ^ y_words)            # per-bit equality, (..., O, W)
    acc = eq[..., 0, :]
    for o in range(1, eq.shape[-2]):
        acc = acc & eq[..., o, :]
    return acc


def class_counts(data: PackedDataset, mask_words: torch.Tensor) -> torch.Tensor:
    """Rows per class, int32[..., C], over the masked rows (i32[..., W])."""
    sel = data.class_words & mask_words[..., None, :]  # (..., C, W)
    return popcount(sel).sum(-1, dtype=torch.int32)


def confusion_counts(
    out_words: torch.Tensor,   # i32[..., O, W] circuit outputs
    data: PackedDataset,
    mask_words: torch.Tensor,  # i32[..., W] row subset (train or val split)
    count: "torch.Tensor | None" = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-class (correct, count) int32[..., C] over the masked rows.

    Leading axes of the outputs (a population) and of the masks broadcast
    against each other, so the search reduces λ children under both of
    its masks in one call; ``count`` comes out in ``correct``'s shape.
    ``count`` depends only on the labels and the masks: a caller that
    reduces many populations under the same masks passes it in, computed
    once by `class_counts`, and only ``correct`` is counted here."""
    eq = _eq_words(out_words, data.y_words)            # (..., W)
    sel = data.class_words & mask_words[..., None, :]  # (..., C, W)
    correct = popcount(sel & eq[..., None, :]).sum(-1, dtype=torch.int32)
    if count is None:
        count = class_counts(data, mask_words)
    return correct, count.expand_as(correct)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _class_sum(recall: np.ndarray, in_loop: bool) -> np.ndarray:
    """Sum float32 recalls over the class axis in the reference's order.

    Inside its jitted loop the reference computes fitness from the
    circuit's words, and XLA's CPU backend reduces a row whose length is a
    power of two by recursive halving (``r[:h] + r[h:]`` until one is
    left), any other row left to right (checked for C = 2 … 16).  Op by
    op, as its `init_state` evaluates the first parent, or jitted with the
    counts as operands, it sums left to right for every C.  The two differ
    by an ulp at C = 4, 8 and 16.  ``numpy.sum`` and ``torch.sum`` pair
    their terms differently again."""
    c = recall.shape[-1]
    if in_loop and c & (c - 1) == 0:  # a power of two; C = 1, 2 agree either way
        while recall.shape[-1] > 1:
            h = recall.shape[-1] // 2
            recall = recall[..., :h] + recall[..., h:]
        return recall[..., 0]
    total = np.zeros(recall.shape[:-1], np.float32)
    for k in range(c):
        total = total + recall[..., k]
    return total


def balanced_accuracy_from_counts(correct, count, *, in_loop: bool = True) -> np.ndarray:
    """Mean per-class recall over the classes present, float32[...] on the
    host, from (correct, count) int[..., C] (tensors or arrays).

    Each recall is ``f32(correct) / f32(max(count, 1))``, or 0 where the
    class is absent; the recalls are summed in float32 in the reference's
    order (`_class_sum`: as its search loop sums them, or with
    ``in_loop=False`` as it sums them op by op); the sum is divided by
    ``f32(max(present, 1))``.  That is the reference's fitness, bit for
    bit."""
    correct, count = np.broadcast_arrays(_host(correct), _host(count))
    present = count > 0
    recall = np.where(
        present,
        correct.astype(np.float32) / np.maximum(count, 1).astype(np.float32),
        np.float32(0),
    )
    total = _class_sum(recall, in_loop)
    return total / np.maximum(present.sum(-1), 1).astype(np.float32)


def balanced_accuracy(out_words, data: PackedDataset, mask_words) -> np.ndarray:
    c, n = confusion_counts(out_words, data, mask_words)
    return balanced_accuracy_from_counts(c, n)


def plain_accuracy(out_words, data: PackedDataset, mask_words) -> np.ndarray:
    """Unbalanced accuracy (reported alongside, e.g. Fig. 9 comparisons),
    float32 on the host: ``f32(hits) / f32(max(rows, 1))``."""
    eq = _eq_words(out_words, data.y_words)
    num = _host(popcount(eq & mask_words).sum(-1))
    den = _host(popcount(mask_words).sum(-1))
    return num.astype(np.float32) / np.maximum(den, 1).astype(np.float32)


# ---------------------------------------------------------------------------
# Unpacked rows (scores and tests)
# ---------------------------------------------------------------------------

def balanced_accuracy_rows(pred_ids, y_ids, valid, n_classes: int) -> float:
    """Numpy reference on unpacked per-row class ids."""
    pred_ids, y_ids, valid = map(np.asarray, (pred_ids, y_ids, valid))
    recalls = []
    for c in range(n_classes):
        m = (y_ids == c) & valid
        if m.sum() == 0:
            continue
        recalls.append(float(((pred_ids == y_ids) & m).sum() / m.sum()))
    return float(np.mean(recalls)) if recalls else 0.0


def predicted_class_ids(out_words: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Decode packed output bits i32[O, W] → int32[n_rows] class ids."""
    bits = unpack_words(out_words, n_rows).to(torch.int32)  # (O, R)
    weights = (1 << torch.arange(bits.shape[0], dtype=torch.int32,
                                 device=bits.device))[:, None]
    return (bits * weights).sum(0, dtype=torch.int32)
