"""Plain PyTorch versions of bit-packed circuit evaluation.

These are the readable oracles the CUDA kernels (`kernels/circuit_eval.py`)
are held to, bit for bit, and what the ``torch-ref`` backend runs.  They
run on any device; the population axis is an explicit leading dimension
rather than a `vmap`.  Two levels:

  * genome level (``eval_*_packed``): walk every gate of the genome, as
    the reference's oracle walks it;
  * program level (``eval_program*``): walk a `CircuitProgram`'s live
    gates (`kernels/program.py`), which is what the kernels run.

Words are ``int32`` tensors with the reference's ``uint32`` bit patterns.

Ids outside the genome contract (gate ``i`` reads ``[0, I+i)``, taps read
``[0, I+n)``) are read as the reference's ``vals[id]`` reads them: a
negative id gets ``+ (I+n)`` (``I_max+n`` for spans), then every id is
clamped into ``[0, I+n-1]``.  An operand that lands at or past ``I+i``
reads the row not yet written, which is zero; a tap reads its landed node;
in spans, a landed input row at or past the circuit's width reads zero.
"""
from __future__ import annotations

import torch

from repro_torch.core import gates
from repro_torch.kernels.program import CircuitProgram


def _land(ids: torch.Tensor, total: int) -> torch.Tensor:
    """The reference's ``vals[id]`` index: negative wraps once, then clamps."""
    ids = ids.to(torch.int64)
    return torch.where(ids < 0, ids + total, ids).clamp(0, total - 1)


def _eval_table(opcodes, edge_src, out_src, x):
    """Evaluate P circuits, circuit p on inputs ``x[p]`` (or a shared
    ``x[0]`` when x has a leading axis of 1) → int32[P, O, W]."""
    pop, n = opcodes.shape
    _, n_in, w = x.shape
    dev = x.device
    total = n_in + n
    vals = torch.zeros((pop, total, w), dtype=torch.int32, device=dev)
    vals[:, :n_in] = x.to(torch.int32)
    edge = _land(edge_src.to(dev), total)
    taps = _land(out_src.to(dev), total)
    ops = opcodes.to(device=dev, dtype=torch.int32)
    rows = torch.arange(pop, device=dev)
    for i in range(n):  # rows >= I+i are still zero here, as in the reference
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


def _span_windows(x_words, word_off, span_words):
    """Per-circuit windows int32[P, I, span] of the words
    ``[word_off[p], word_off[p] + span)``.  Offsets follow the reference's
    ``dynamic_slice``: a negative offset counts from the end of the buffer,
    then any window that would run past either end is clamped into it."""
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
    return x_words.to(torch.int32)[:, cols].permute(1, 0, 2)  # (P, I, span)


def _span_inputs(x_words, word_off, in_width, span_words):
    """`_span_windows` with rows ``>= in_width[p]`` zeroed."""
    xs = _span_windows(x_words, word_off, span_words)
    row = torch.arange(x_words.shape[0], device=xs.device)[None, :, None]
    width = in_width.to(device=xs.device, dtype=torch.int64)[:, None, None]
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


def _program_table(program: CircuitProgram, xs, width):
    """Run P programs, program p on inputs ``xs[p]`` (or a shared ``xs[0]``)
    with input rows at or past ``width[p]`` read as zero → int32[P, O, W]."""
    dev = xs.device
    prog = program.to(dev)
    ops, code_a, code_b = prog.gates.to(torch.int64).unbind(-1)
    rows = prog.rows.to(torch.int64)
    pop, n_r, n_l = prog.pop, prog.n_rows_max, prog.n_gates
    p = torch.arange(pop, device=dev)
    table = torch.zeros((pop, n_r + n_l + 1, xs.shape[-1]), dtype=torch.int32,
                        device=dev)
    staged = xs.to(torch.int32).expand(pop, -1, -1)[p[:, None], rows]
    keep = (rows < width[:, None]) & (
        torch.arange(n_r, device=dev)[None, :] < prog.n_rows.to(dev)[:, None])
    table[:, :n_r] = torch.where(keep[..., None], staged, torch.zeros_like(staged))
    for j in range(n_l):
        a = table[p, code_a[:, j]]
        b = table[p, code_b[:, j]]
        table[:, n_r + j] = gates.apply_gates_packed(ops[:, j], a, b)
    return table[p[:, None], prog.taps.to(torch.int64)]


def eval_program(program: CircuitProgram, x_words: torch.Tensor) -> torch.Tensor:
    """The programs over one shared packed dataset int32[I, W] →
    int32[P, O, W]; equal to `eval_population_packed` on the genomes the
    program was compiled from."""
    if x_words.shape[0] != program.n_inputs:
        raise ValueError(
            f"the program was compiled for {program.n_inputs} input rows, "
            f"the words have {x_words.shape[0]}"
        )
    width = torch.full((program.pop,), program.n_inputs, dtype=torch.int64,
                       device=x_words.device)
    return _program_table(program, x_words[None], width)


def land_slots(slots: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Slot indices as the reference's gather ``opcodes[slots]`` takes
    them: negative wraps once, then clamps into ``[0, S-1]``."""
    return _land(slots, n_slots)


def eval_program_spans(
    program: CircuitProgram,  # a shard's resident programs, S circuits
    x_words: torch.Tensor,    # int32[I_max, W_total] fused buffer
    slots: torch.Tensor,      # int32[K] program circuit each launch slot runs
    word_off: torch.Tensor,   # int32[K] word offset of slot k's span
    in_width: torch.Tensor,   # int32[S] live input rows of each circuit
    live: torch.Tensor,       # int32[K] 0 masks slot k's inputs off
    *,
    span_words: int,
) -> torch.Tensor:            # int32[K, O, span_words]
    """Launch slot k runs circuit ``slots[k]`` over its own span; exactly
    ``eval_population_spans_packed(opc[slots], edge[slots], outs[slots],
    x, word_off, in_width[slots] * live)`` on the compiled genomes, pad
    slots (``live == 0``) included."""
    if x_words.shape[0] != program.n_inputs:
        raise ValueError(
            f"the program was compiled for {program.n_inputs} input rows, "
            f"the words have {x_words.shape[0]}"
        )
    dev = x_words.device
    slot = land_slots(slots.to(dev), program.pop)
    prog = program.to(dev)
    picked = CircuitProgram(*(t[slot] for t in prog[:5]), prog.n_inputs)
    width = in_width.to(device=dev, dtype=torch.int32)[slot] * live.to(
        device=dev, dtype=torch.int32)
    xs = _span_windows(x_words, word_off, span_words)
    return _program_table(picked, xs, width.to(torch.int64))


def eval_circuit_rows(opcodes, edge_src, out_src, x_bits):
    """Unpacked row-wise reference (uint8[R, I] → uint8[R, O]).

    Slow O(R·n) path used only by tests to validate the packed layout."""
    out = _eval_table(
        opcodes[None], edge_src[None], out_src[None],
        x_bits.to(torch.int32).T[None],
    )[0]
    return (out & 1).T.to(torch.uint8)
