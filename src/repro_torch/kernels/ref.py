"""Plain PyTorch versions of bit-packed circuit evaluation.

These are the readable oracles the CUDA kernels (`kernels/circuit_eval.py`)
are held to, bit for bit, and what the kernel wrappers run for tensors
that lie on the CPU.  They run on any device; the population axis is an
explicit leading dimension rather than a `vmap`.

Words are ``int32`` tensors with the reference's ``uint32`` bit patterns.

Genome contract: gate ``i`` reads ids in ``[0, I+i)`` and output taps
read ids in ``[0, I+n)`` (what `validate_genome` checks).  An id outside
that range reads an all-zero word, so even a corrupt genome never reads
anything but its own circuit's values; the kernels do the same.
"""
from __future__ import annotations

import torch

from repro_torch.core import gates


def _eval_table(opcodes, edge_src, out_src, x):
    """Evaluate P circuits, circuit p on inputs ``x[p]`` (or a shared
    ``x[0]`` when x has a leading axis of 1) → int32[P, O, W]."""
    pop, n = opcodes.shape
    _, n_in, w = x.shape
    dev = x.device
    zero_id = n_in + n  # an always-zero row for out-of-contract ids
    vals = torch.zeros((pop, n_in + n + 1, w), dtype=torch.int32, device=dev)
    vals[:, :n_in] = x.to(torch.int32)
    edge = edge_src.to(device=dev, dtype=torch.int64)
    hi = n_in + torch.arange(n, device=dev)[None, :, None]
    edge = torch.where((edge >= 0) & (edge < hi), edge, zero_id)
    taps = out_src.to(device=dev, dtype=torch.int64)
    taps = torch.where((taps >= 0) & (taps < n_in + n), taps, zero_id)
    ops = opcodes.to(device=dev, dtype=torch.int32)
    rows = torch.arange(pop, device=dev)
    for i in range(n):
        a = vals[rows, edge[:, i, 0]]
        b = vals[rows, edge[:, i, 1]]
        vals[:, n_in + i] = gates.apply_gates_packed(ops[:, i], a, b)
    return vals[rows[:, None], taps]


def eval_circuit_packed(
    opcodes: torch.Tensor,   # int32[n]    raw gate opcodes
    edge_src: torch.Tensor,  # int32[n,2]  operand ids, < I+i for node i
    out_src: torch.Tensor,   # int32[O]    output taps, < I+n
    x_words: torch.Tensor,   # int32[I,W]  packed input bits
) -> torch.Tensor:           # int32[O,W]  packed output bits
    """Evaluate one circuit on all packed rows."""
    return _eval_table(
        opcodes[None], edge_src[None], out_src[None], x_words[None]
    )[0]


def eval_population_packed(opcodes, edge_src, out_src, x_words):
    """Population of circuits (leading axis on the genome arrays) over one
    shared packed dataset → int32[P, O, W]."""
    return _eval_table(opcodes, edge_src, out_src, x_words[None])


def _span_inputs(x_words, word_off, in_width, span_words):
    """Per-circuit input slices int32[P, I, span]: the words
    ``[word_off[p], word_off[p] + span)`` with rows ``>= in_width[p]``
    zeroed.  Offsets follow the reference's ``dynamic_slice``: a negative
    offset counts from the end of the buffer, then any window that would
    run past either end is clamped into it."""
    n_in, w_total = x_words.shape
    if not 1 <= span_words <= w_total:
        raise ValueError(
            f"span_words={span_words} must be in [1, {w_total}] "
            "(the fused buffer's word count)"
        )
    dev = x_words.device
    off = word_off.to(device=dev, dtype=torch.int64)
    off = torch.where(off < 0, off + w_total, off).clamp(0, w_total - span_words)
    cols = off[:, None] + torch.arange(span_words, device=dev)[None, :]
    xs = x_words.to(torch.int32)[:, cols].permute(1, 0, 2)  # (P, I, span)
    row = torch.arange(n_in, device=dev)[None, :, None]
    width = in_width.to(device=dev, dtype=torch.int64)[:, None, None]
    return torch.where(row < width, xs, torch.zeros_like(xs))


def eval_circuit_span(
    opcodes, edge_src, out_src, x_words, word_off, in_width, *, span_words: int
):
    """One circuit on the ``span_words`` words starting at ``word_off``,
    with input rows >= ``in_width`` masked to zero → int32[O, span]."""
    return eval_population_spans_packed(
        opcodes[None], edge_src[None], out_src[None], x_words,
        torch.as_tensor(word_off).reshape(1),
        torch.as_tensor(in_width).reshape(1),
        span_words=span_words,
    )[0]


def eval_population_spans_packed(
    opcodes, edge_src, out_src, x_words, word_off, in_width, *, span_words: int
):
    """Per-circuit word spans: circuit p reads words
    [word_off[p], word_off[p] + span_words) of the shared buffer, input
    rows >= in_width[p] masked to zero → int32[P, O, span_words]."""
    xs = _span_inputs(x_words, word_off, in_width, span_words)
    return _eval_table(opcodes, edge_src, out_src, xs)


def eval_circuit_rows(opcodes, edge_src, out_src, x_bits):
    """Unpacked row-wise reference (uint8[R, I] → uint8[R, O]).

    Slow O(R·n) path used only by tests to validate the packed layout."""
    out = _eval_table(
        opcodes[None], edge_src[None], out_src[None],
        x_bits.to(torch.int32).T[None],
    )[0]
    return (out & 1).T.to(torch.uint8)
