"""Module-level circuit-evaluation wrappers.

Each call goes where its tensors lie, through the one device → backend
decision of the port (`runtime.backend_for`): words on a CUDA device launch
the hand-written kernel (`kernels/circuit_eval.py`) or raise; words on the
CPU run the plain PyTorch version (`kernels/ref.py`).  Nothing catches a
kernel failure and carries on elsewhere.  The genome-level entry points
compile a `CircuitProgram` (`kernels/program.py`) and evaluate it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.program import CircuitProgram
from repro_torch.runtime import backend_for


def eval_program(program: CircuitProgram, x_words: torch.Tensor) -> torch.Tensor:
    """Live-gate programs over a shared packed dataset → i32[P, O, W]."""
    return backend_for(x_words.device).eval_program(program, x_words)


def eval_program_spans(program, x_words, slots, word_off, in_width, live, *,
                       span_words: int) -> torch.Tensor:
    """Launch slot k runs program circuit ``slots[k]`` over its own span,
    input rows ``>= in_width[slots[k]] * live[k]`` read as zero →
    i32[K, O, span_words]."""
    return backend_for(x_words.device).eval_program_spans(
        program, x_words, slots, word_off, in_width, live, span_words=span_words)


def eval_population(
    opcodes: torch.Tensor,   # i32[P, n]
    edge_src: torch.Tensor,  # i32[P, n, 2]
    out_src: torch.Tensor,   # i32[P, O]
    x_words: torch.Tensor,   # i32[I, W]
) -> torch.Tensor:           # i32[P, O, W]
    """Evaluate a population of circuits on a shared packed dataset."""
    return backend_for(x_words.device).eval_population(opcodes, edge_src, out_src, x_words)


def eval_population_spans(
    opcodes: torch.Tensor,   # i32[P, n]
    edge_src: torch.Tensor,  # i32[P, n, 2]
    out_src: torch.Tensor,   # i32[P, O]
    x_words: torch.Tensor,   # i32[I_max, W_total] fused multi-tenant buffer
    word_off: torch.Tensor,  # i32[P] word offset of circuit p's span
    in_width: torch.Tensor,  # i32[P] live input rows of circuit p
    *,
    span_words: int,
) -> torch.Tensor:           # i32[P, O, span_words]
    """Multi-tenant population eval: circuit p reads only its own span of
    ``span_words`` words, with per-circuit input-width masking."""
    return backend_for(x_words.device).eval_population_spans(
        opcodes, edge_src, out_src, x_words, word_off, in_width,
        span_words=span_words,
    )


def eval_circuit(opcodes, edge_src, out_src, x_words) -> torch.Tensor:
    """Single-circuit convenience wrapper → i32[O, W]."""
    return backend_for(x_words.device).eval_circuit(opcodes, edge_src, out_src, x_words)
