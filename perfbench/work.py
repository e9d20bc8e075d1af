"""The yardstick of the kernels: what a launch needs, and the card's peaks.

`live_work` is a frozen copy of the count that bounds the circuit-eval
kernels: the gates reached back from a circuit's output taps and the distinct
input rows they read.  `program_work` and `spans_work` turn it into the bytes
and 32-bit logic operations one launch of each kernel needs, counting each
input byte read once and each output byte written once; `bound_s` is the least
time the card could take for them.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM, at its 700 W power limit: HBM3 bandwidth from the data
# sheet; INT32 logic rate as 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
PEAKS_SOURCE = ("NVIDIA H100 SXM5 data sheet (HBM3 3.35 TB/s); INT32 = "
                "132 SMs x 64 lanes x 1.98 GHz")

NOT_A, BUF_A = 6, 7  # the one-operand opcodes
WORD = 32


def live_set(opc, edge, outs, n_in: int, width: int) -> tuple[int, frozenset]:
    """`live_work` with the rows read as a set, so that circuits sharing
    their words count a row once."""
    opc, edge, outs = (np.asarray(a).tolist() for a in (opc, edge, outs))
    n = len(opc)
    live, rows, stack = [False] * n, set(), list(outs)
    while stack:
        a = int(stack.pop())
        if a < n_in:
            if 0 <= a < width:
                rows.add(a)
        elif a < n_in + n and not live[a - n_in]:
            i = a - n_in
            live[i] = True
            stack.extend(edge[i][:1] if opc[i] in (NOT_A, BUF_A) else edge[i])
    return sum(live), frozenset(rows)


def live_work(opc, edge, outs, n_in: int, width: int) -> tuple[int, int]:
    """(gates, input rows) that one circuit's outputs depend on: the gates
    reached back from its taps (a NOT_A or BUF_A gate needs only its first
    operand) and the distinct input rows below ``width`` that they or the
    taps read.  Rows at or past ``width`` read as zero and are never
    fetched, and dead gates are work the function does not need."""
    gates, rows = live_set(opc, edge, outs, n_in, width)
    return gates, len(rows)


def n_words(rows: int) -> int:
    return -(-int(rows) // WORD)


def program_work(circuits: "list[tuple[int, frozenset]]", n_out: int,
                 words: int) -> tuple[int, int]:
    """(bytes, ops) of one ``eval_program`` launch of P circuits over one
    shared block of ``words`` words, from each circuit's `live_set`: per
    circuit its live gates' (opcode, a, b), its taps and its output words,
    and the input rows that any circuit reads, once; one logic op per live
    gate and word."""
    live = sum(g for g, _ in circuits)
    rows = len(frozenset().union(*(r for _, r in circuits)))
    pop = len(circuits)
    nbytes = 4 * (3 * live + pop * n_out + rows * words + pop * n_out * words)
    return nbytes, live * words


def spans_work(slots: "list[tuple[int, int, int]]", n_out: int) -> tuple[int, int]:
    """(bytes, ops) of one ``eval_program_spans`` launch, from each live
    slot's (live gates, rows read, words its rows need): per slot its live
    gates, taps, launch slot, offset and width, the rows it reads over its
    own words, and its output words.  Pad slots, whose outputs are never
    read, need nothing."""
    nbytes = ops = 0
    for gates, rows, words in slots:
        nbytes += 4 * (3 * gates + n_out + 3 + rows * words + n_out * words)
        ops += gates * words
    return nbytes, ops


def bound_s(nbytes: int, ops: int) -> float:
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and ops over the INT32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)
