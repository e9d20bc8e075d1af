"""Plain NumPy reference of a tiny classifier circuit (arXiv:2303.00031, §3).

From the raw float rows and a genome's arrays it fits equal-frequency
(quantile) bucket edges, encodes each feature as the binary code of its
bucket, packs 32 rows to a word, evaluates in index order every gate that an
output reaches, and reads the output bits back as class codes; `balanced_accuracy`
is the search's fitness, the mean per-class recall in float32.

``dtype="bfloat16"`` rounds the features and the edges (and, for the fitness,
every quantity) to bfloat16 first: the lower precision that the control runs
in, never the benchmark's own check.
"""
from __future__ import annotations

import numpy as np
import torch

WORD = 32

# two-input gates on packed words; a one-input gate reads its first operand
GATES = {
    "AND": lambda a, b: a & b,
    "OR": lambda a, b: a | b,
    "NAND": lambda a, b: ~(a & b),
    "NOR": lambda a, b: ~(a | b),
    "XOR": lambda a, b: a ^ b,
    "XNOR": lambda a, b: ~(a ^ b),
    "NOT": lambda a, b: ~a,
    "BUF": lambda a, b: a,
}


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round float values to bfloat16 and back to float32."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def quantile_edges(x: np.ndarray, bits: int) -> np.ndarray:
    """float32[F, 2**bits - 1]: the k/2**bits quantiles of each feature
    (NumPy's linear rule, in float64), made non-decreasing."""
    q = np.arange(1, 2 ** bits) / 2 ** bits
    edges = np.quantile(np.asarray(x, np.float64), q, axis=0).T
    return np.maximum.accumulate(edges, axis=1).astype(np.float32)


def encode(x: np.ndarray, edges: np.ndarray, bits: int,
           dtype: str = "float32") -> np.ndarray:
    """bool[R, F*bits]: bit b of feature j's bucket (the number of its
    edges at or below the value) at column j*bits + b."""
    x = np.asarray(x, np.float32)
    if dtype == "bfloat16":
        x, edges = _bf16(x), _bf16(edges)
    r, f = x.shape
    out = np.empty((r, f * bits), bool)
    for j in range(f):
        bucket = np.searchsorted(edges[j], x[:, j], side="right")
        for b in range(bits):
            out[:, j * bits + b] = (bucket >> b) & 1
    return out


def pack(bits: np.ndarray) -> np.ndarray:
    """bool[R, B] -> uint32[B, ceil(R/32)]: row r at bit r % 32 of word r // 32."""
    r, b = bits.shape
    w = -(-r // WORD)
    padded = np.zeros((b, w * WORD), np.uint8)
    padded[:, :r] = bits.T
    return np.packbits(padded, axis=1, bitorder="little").view("<u4").astype(np.uint32)


def evaluate(gate_names, fn_index, edge_src, out_src, x_words: np.ndarray) -> np.ndarray:
    """uint32[O, W]: the circuit's output words over packed inputs
    ``x_words`` [I, W].  Gate i applies ``gate_names[fn_index[i]]`` to the
    values of ids ``edge_src[i]``; ids below I are inputs, id I + k is gate
    k; each output reads id ``out_src[o]``."""
    n_in, w = x_words.shape
    fn_index, edge_src, out_src = (np.asarray(a, np.int64) for a in (fn_index, edge_src, out_src))
    n = len(fn_index)
    # only gates that some output reaches change the answer
    needed = np.zeros(n_in + n, bool)
    needed[out_src] = True
    for i in range(n - 1, -1, -1):
        if needed[n_in + i]:
            needed[edge_src[i]] = True
    vals = np.empty((n_in + n, w), np.uint32)
    vals[:n_in] = x_words
    for i in np.flatnonzero(needed[n_in:]):
        a, b = edge_src[i]
        vals[n_in + i] = GATES[gate_names[fn_index[i]]](vals[a], vals[b])
    return vals[out_src]


def codes(out_words: np.ndarray, n_rows: int) -> np.ndarray:
    """int64[R]: each row's output bits read as a binary class code."""
    bits = np.unpackbits(np.ascontiguousarray(out_words, "<u4").view(np.uint8),
                         axis=1, bitorder="little")[:, :n_rows]
    weights = np.left_shift(1, np.arange(bits.shape[0], dtype=np.int64))
    return (bits.astype(np.int64) * weights[:, None]).sum(0)


def class_ids(code: np.ndarray, n_classes: int) -> np.ndarray:
    """Served class ids: a code past the last class answers the last class."""
    return np.minimum(code, n_classes - 1)


def balanced_accuracy(code: np.ndarray, y: np.ndarray, mask: np.ndarray,
                      n_classes: int, dtype: str = "float32") -> float:
    """Mean recall over the classes present among the masked rows: per
    class correct / rows in float32, the recalls summed in float32 (in
    halves where the class count is a power of two, else left to right),
    over the classes present.  A row is correct where its code is its
    label."""
    hit = (code == y) & mask
    correct = np.array([np.count_nonzero(hit & (y == c)) for c in range(n_classes)])
    count = np.array([np.count_nonzero(mask & (y == c)) for c in range(n_classes)])
    present = count > 0
    if dtype == "bfloat16":
        def cast(a):
            return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
        recall = torch.where(torch.from_numpy(present), cast(correct) / cast(np.maximum(count, 1)),
                             cast(0.0))
        while recall.shape[0] > 1 and recall.shape[0] % 2 == 0:
            h = recall.shape[0] // 2
            recall = recall[:h] + recall[h:]
        total = recall.sum() if recall.shape[0] > 1 else recall[0]
        return float(total / cast(max(int(present.sum()), 1)))
    recall = np.where(present, correct.astype(np.float32)
                      / np.maximum(count, 1).astype(np.float32), np.float32(0))
    if n_classes & (n_classes - 1) == 0:
        while recall.shape[0] > 1:
            h = recall.shape[0] // 2
            recall = recall[:h] + recall[h:]
        total = recall[0]
    else:
        total = np.float32(0)
        for r in recall:
            total = np.float32(total + r)
    return float(np.float32(total / np.float32(max(int(present.sum()), 1))))
