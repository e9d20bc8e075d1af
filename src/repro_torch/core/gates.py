"""Logic-gate function sets on bit-packed words (PyTorch port).

Packed words are ``int32`` tensors carrying the same 32 bits as the
reference's ``uint32`` words: one word holds one logical signal for 32
dataset rows.  Every gate is a pure bitwise function, and ``~`` on an
``int32`` tensor is a bitwise complement, so the bit patterns agree with
the ``uint32`` reference exactly (compare patterns, not values).
"""
from __future__ import annotations

import torch

# Opcode table.  Order is load-bearing: genomes store indices into a function
# set which maps to these opcodes, and saved bundles carry the raw opcodes.
AND, OR, NAND, NOR, XOR, XNOR, NOT_A, BUF_A = range(8)

GATE_NAMES = ("AND", "OR", "NAND", "NOR", "XOR", "XNOR", "NOT", "BUF")
N_OPCODES = 8

# Verilog expression templates per opcode (a, b are operand expressions).
VERILOG_EXPR = (
    "({a} & {b})",
    "({a} | {b})",
    "~({a} & {b})",
    "~({a} | {b})",
    "({a} ^ {b})",
    "~({a} ^ {b})",
    "~{a}",
    "{a}",
)

# C expression templates (single-bit operands).
C_EXPR = (
    "({a} & {b})",
    "({a} | {b})",
    "(!({a} & {b}))",
    "(!({a} | {b}))",
    "({a} ^ {b})",
    "(!({a} ^ {b}))",
    "(!{a})",
    "({a})",
)

# NAND2-equivalent gate count per opcode (standard-cell gate equivalents;
# NAND2/NOR2 = 1.0, AND2/OR2 = 1.5 (gate + inverter), XOR2/XNOR2 = 2.5,
# INV = 0.5, BUF = 0.5).  Used by repro_torch.core.hardware.
NAND2_EQUIV = (1.5, 1.5, 1.0, 1.0, 2.5, 2.5, 0.5, 0.5)

# The paper's function sets.
FULL_FS = (AND, OR, NAND, NOR)
NAND_FS = (NAND,)
EXTENDED_FS = (AND, OR, NAND, NOR, XOR, XNOR)  # beyond-paper option

FUNCTION_SETS = {
    "full": FULL_FS,
    "nand": NAND_FS,
    "extended": EXTENDED_FS,
}


def apply_gates_packed(
    opcodes: torch.Tensor, a: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Apply per-node gate opcodes to packed ``int32`` operand words.

    opcodes: int tensor broadcastable against a/b's leading dims — one
             opcode per *gate*, shared across the trailing word axis.
    a, b:    int32 words (…, W).

    Returns int32 words of the same shape as ``a``; an opcode outside the
    table yields all-zero words, as the reference's select chain does.
    """
    a = a.to(torch.int32)
    b = b.to(torch.int32)
    ops = opcodes[..., None] if opcodes.dim() == a.dim() - 1 else opcodes
    r = torch.where(ops == AND, a & b, torch.zeros_like(a))
    r = torch.where(ops == OR, a | b, r)
    r = torch.where(ops == NAND, ~(a & b), r)
    r = torch.where(ops == NOR, ~(a | b), r)
    r = torch.where(ops == XOR, a ^ b, r)
    r = torch.where(ops == XNOR, ~(a ^ b), r)
    r = torch.where(ops == NOT_A, ~a, r)
    r = torch.where(ops == BUF_A, a, r)
    return r


def apply_gate_bool(opcode: int, a, b) -> int:
    """Scalar boolean reference for a single opcode (python ints 0/1)."""
    table = (
        lambda x, y: x & y,
        lambda x, y: x | y,
        lambda x, y: 1 - (x & y),
        lambda x, y: 1 - (x | y),
        lambda x, y: x ^ y,
        lambda x, y: 1 - (x ^ y),
        lambda x, y: 1 - x,
        lambda x, y: x,
    )
    return table[opcode](int(a), int(b))
