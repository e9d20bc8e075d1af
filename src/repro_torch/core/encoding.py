"""Feature → bit encoders and bit-packing (PyTorch port).

Encoding strategies (paper names):
  * ``quantize``  — equal-width buckets, binary code
  * ``quantile``  — equal-frequency buckets, binary code
  * ``gray``      — equal-width buckets, Gray code
  * ``onehot``    — equal-frequency buckets, one-hot code (bits == buckets)

Encoders are fitted and applied on the host in numpy, exactly as the
reference does, so encoded bits are byte-identical.  Packing layout:
``x_words[b, w]`` bit ``j`` is encoded input bit ``b`` of row ``32*w + j``.
Host words stay ``uint32``; they cross into torch as ``int32`` with the
same bits (``.view(np.int32)``).  A `PackedDataset` and its train/val
masks are packed on the host and uploaded once to the device the search
runs on.

Under `recording` (`serve/observability/trace.py`) the work records spans:
``encoding.fit_encoder``, ``encoding.encode``, ``encoding.pack`` (each
`pack_bits_rows`), ``encoding.h2d`` (the copies to the device; the first
on the card also makes the CUDA context) and ``encoding.split_masks``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.serve.observability.trace import active

STRATEGIES = ("quantize", "quantile", "gray", "onehot")
WORD = 32


@dataclasses.dataclass(frozen=True)
class EncodingConfig:
    strategy: str = "quantize"
    bits: int = 2

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if not 1 <= self.bits <= 8:
            raise ValueError(f"bits must be in [1, 8], got {self.bits}")

    @property
    def n_buckets(self) -> int:
        return self.bits if self.strategy == "onehot" else 2 ** self.bits


class Encoder(NamedTuple):
    """Fitted per-feature thresholds + code table (host numpy)."""

    thresholds: np.ndarray  # float32[F, n_buckets-1], ascending per feature
    codes: np.ndarray       # uint8[n_buckets, bits]
    strategy: str
    bits: int

    @property
    def n_features(self) -> int:
        return self.thresholds.shape[0]

    @property
    def n_bits_total(self) -> int:
        return self.n_features * self.bits


def _gray(i: int) -> int:
    return i ^ (i >> 1)


def _code_table(cfg: EncodingConfig) -> np.ndarray:
    nb, bits = cfg.n_buckets, cfg.bits
    table = np.zeros((nb, bits), dtype=np.uint8)
    for i in range(nb):
        if cfg.strategy == "onehot":
            table[i, i] = 1
        else:
            v = _gray(i) if cfg.strategy == "gray" else i
            for b in range(bits):
                table[i, b] = (v >> b) & 1
    return table


def fit_encoder(x_train: np.ndarray, cfg: EncodingConfig) -> Encoder:
    """Fit per-feature bucket thresholds on training data only."""
    x = np.asarray(x_train, dtype=np.float64)
    if x.ndim != 2:
        raise ValueError(f"expected a 2-D feature matrix, got {x.shape}")
    nb = cfg.n_buckets
    with active().span("encoding.fit_encoder", cat="encoding"):
        if cfg.strategy in ("quantize", "gray"):
            lo, hi = x.min(axis=0), x.max(axis=0)
            span = np.where(hi > lo, hi - lo, 1.0)
            edges = lo[:, None] + span[:, None] * (np.arange(1, nb) / nb)[None, :]
        else:  # equal-frequency
            edges = np.quantile(x, np.arange(1, nb) / nb, axis=0).T  # (F, nb-1)
        # strictly non-decreasing thresholds per feature
        edges = np.maximum.accumulate(edges, axis=1)
    return Encoder(edges.astype(np.float32), _code_table(cfg), cfg.strategy, cfg.bits)


def encode(enc: Encoder, x: np.ndarray) -> np.ndarray:
    """Encode raw features → bit matrix uint8[R, F*bits]."""
    x = np.asarray(x, dtype=np.float32)
    r, f = x.shape
    if f != enc.n_features:
        raise ValueError(f"encoder expects {enc.n_features} features, got {f}")
    with active().span("encoding.encode", cat="encoding"):
        buckets = np.empty((r, f), dtype=np.int64)
        for j in range(f):
            buckets[:, j] = np.searchsorted(enc.thresholds[j], x[:, j], side="right")
        bits = enc.codes[buckets]                 # (R, F, bits)
        return bits.reshape(r, f * enc.bits).astype(np.uint8)


def encode_batched(
    enc: Encoder, arrays: "list[np.ndarray]"
) -> tuple[np.ndarray, np.ndarray]:
    """Encode several row blocks through one vectorized `encode` call.

    Returns (bits uint8[R_total, F*bits], offsets int64[len(arrays)+1])
    with block k at rows [offsets[k], offsets[k+1]).
    """
    arrays = [np.asarray(a, np.float32) for a in arrays]
    offsets = np.zeros(len(arrays) + 1, np.int64)
    if arrays:
        offsets[1:] = np.cumsum([a.shape[0] for a in arrays])
    if not arrays or offsets[-1] == 0:
        return np.zeros((0, enc.n_bits_total), np.uint8), offsets
    bits = encode(enc, np.concatenate(arrays, axis=0))
    return bits, offsets


def class_code_bits(n_classes: int, n_out_bits: int | None = None) -> np.ndarray:
    """Binary class codes uint8[C, O] (paper §3.6: outputs encode the class)."""
    o = n_out_bits or max(1, int(np.ceil(np.log2(max(n_classes, 2)))))
    if 2 ** o < n_classes:
        raise ValueError(f"{o} output bits cannot code {n_classes} classes")
    table = np.zeros((n_classes, o), dtype=np.uint8)
    for c in range(n_classes):
        for b in range(o):
            table[c, b] = (c >> b) & 1
    return table


def n_words(n_rows: int, pad_to: int = 1) -> int:
    w = (n_rows + WORD - 1) // WORD
    return ((w + pad_to - 1) // pad_to) * pad_to


def pack_bits_rows(bits: np.ndarray, w: int) -> np.ndarray:
    """uint8[R, B] {0,1} → uint32[B, w] packed along rows (C-contiguous, so
    it crosses into torch as one dense block)."""
    r, b = bits.shape
    pad = w * WORD - r
    if pad < 0:
        raise ValueError(f"{r} rows do not fit in {w} words")
    with active().span("encoding.pack", cat="encoding"):
        x = np.concatenate([bits, np.zeros((pad, b), np.uint8)], axis=0)
        x = x.T.reshape(b, w, WORD).astype(np.uint32)
        return np.ascontiguousarray((x << np.arange(WORD, dtype=np.uint32)[None, None, :]).sum(
            axis=-1, dtype=np.uint32
        ))


def unpack_words(words: torch.Tensor, n_rows: int) -> torch.Tensor:
    """int32[…, W] → uint8[…, n_rows] (inverse of pack_bits_rows).

    ``>>`` on int32 is arithmetic (it copies the sign bit), so each shifted
    word is masked with ``& 1`` to keep only the wanted bit."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[..., None] >> shifts) & 1
    flat = bits.reshape(*words.shape[:-1], -1)
    return flat[..., :n_rows].to(torch.uint8)


def _words(device, *host: np.ndarray) -> "list[torch.Tensor]":
    """uint32 host words → int32 tensors with the same bits on ``device``."""
    with active().span("encoding.h2d", cat="encoding"):
        return [torch.from_numpy(np.ascontiguousarray(h).view(np.int32)).to(device)
                for h in host]


class PackedDataset(NamedTuple):
    """Bit-packed dataset as ``int32`` tensors (the reference's ``uint32``
    bits) on one device; all share the word axis W."""

    x_words: torch.Tensor      # i32[I, W] encoded input bits
    y_words: torch.Tensor      # i32[O, W] class-code bits of the label
    class_words: torch.Tensor  # i32[C, W] row mask per class (y == c)
    mask_words: torch.Tensor   # i32[W]    valid (non-padding) rows

    @property
    def n_inputs(self) -> int:
        return self.x_words.shape[0]

    @property
    def n_outputs(self) -> int:
        return self.y_words.shape[0]

    @property
    def n_classes(self) -> int:
        return self.class_words.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x_words.device


def pack_dataset(
    bits: np.ndarray,
    y: np.ndarray,
    n_classes: int,
    n_out_bits: int | None = None,
    pad_words_to: int = 1,
    *,
    device: "str | torch.device | None" = None,
) -> PackedDataset:
    """Pack an encoded bit matrix and labels on the host, then put the four
    arrays on ``device`` (``None``: the card; ``"cpu"`` for the plain
    versions).  ``pad_words_to`` rounds W up to a multiple."""
    device = resolve_device(device)
    r = bits.shape[0]
    y = np.asarray(y, dtype=np.int64)
    if y.shape != (r,):
        raise ValueError(f"labels {y.shape} do not match {r} rows")
    w = n_words(r, pad_words_to)
    codes = class_code_bits(n_classes, n_out_bits)        # (C, O)
    y_bits = codes[y]                                     # (R, O)
    cls_bits = (y[:, None] == np.arange(n_classes)[None, :]).astype(np.uint8)
    mask_bits = np.ones((r, 1), dtype=np.uint8)
    return PackedDataset(*_words(
        device, pack_bits_rows(bits, w), pack_bits_rows(y_bits, w),
        pack_bits_rows(cls_bits, w), pack_bits_rows(mask_bits, w)[0]))


def split_masks(
    n_rows: int, w: int, val_fraction: float, seed: int,
    *, device: "str | torch.device | None" = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Random row-level train/val masks as packed words i32[W] on
    ``device`` (``None``: the card).  Paper §3.3: 50/50 by default; train
    fitness selects, val fitness picks the best-discovered solution.  Rows
    are drawn from numpy's ``RandomState(seed)``, as the reference draws
    them."""
    device = resolve_device(device)
    with active().span("encoding.split_masks", cat="encoding"):
        rng = np.random.RandomState(seed)
        is_val = rng.rand(n_rows) < val_fraction
        tr = (~is_val)[:, None].astype(np.uint8)
        va = is_val[:, None].astype(np.uint8)
        m_tr, m_va = _words(device, pack_bits_rows(tr, w)[0], pack_bits_rows(va, w)[0])
    return m_tr, m_va
