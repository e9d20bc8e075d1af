"""Live-gate programs: what the circuit-eval kernels actually walk.

A genome holds n gates, but only the gates reached back from its output
taps change what it computes; at the fitted bundles of this repository a
few percent of them.  `compile_program` turns a population's genome
arrays into a `CircuitProgram` — each circuit's live gates in
topological order, the distinct input rows they read, and its taps — in
the index space of one per-circuit value table:

    codes [0, R)        the staged input rows ``rows[p, :n_rows[p]]``
    codes [R, R + L)    the live gates ``gates[p, :n_live[p]]``
    code  R + L         an all-zero word (`CircuitProgram.zero_code`)

where ``R`` and ``L`` are the population's largest row and gate counts.
It is the counterpart of the reference's active-node extraction
(``core/netlist.py`` ``extract``: arity-aware, a ``NOT_A``/``BUF_A`` gate
needs only operand a) and evaluates the same function as the genome.

Ids are canonicalised here as the reference's ``vals[id]`` reads them: a
negative id gets ``+ (I + n)``, then every id is clamped into
``[0, I + n - 1]``; an operand of gate i that lands at or past ``I + i``
reads the row that is not written yet, which is zero; a tap reads its
landed node.  An opcode outside the gate table yields zero, so it is
stored as `ZERO_GATE` with both operands zero.  The kernels therefore only
ever see in-range codes.  Input rows at or past a circuit's width are the
evaluator's business (the spans entry point takes the widths at launch).
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import gates as G

ZERO_GATE = G.N_OPCODES  # opcode of a gate whose output is all zeros

# calls of `compile_program` in this process: the serving stack's cold
# work, which a boot from stored span-launch units must not repeat
_count_lock = threading.Lock()
_compiles = 0


def compile_count() -> int:
    """Calls that ran `compile_program` since the last reset."""
    return _compiles


def reset_compile_count() -> None:
    global _compiles
    with _count_lock:
        _compiles = 0


class CircuitProgram(NamedTuple):
    """A population's live-gate programs as contiguous ``int32`` tensors."""

    gates: torch.Tensor    # i32[P, L, 3]  (opcode, code a, code b); padding: (ZERO_GATE, zero, zero)
    n_live: torch.Tensor   # i32[P]        live gates of circuit p
    rows: torch.Tensor     # i32[P, R]     input rows circuit p reads, ascending; padding 0
    n_rows: torch.Tensor   # i32[P]
    taps: torch.Tensor     # i32[P, O]     output codes
    n_inputs: int          # I (I_max for spans): the input rows of the words it runs on

    @property
    def pop(self) -> int:
        return self.gates.shape[0]

    @property
    def n_gates(self) -> int:
        """L, the live-gate axis (padded to the population's largest)."""
        return self.gates.shape[1]

    @property
    def n_rows_max(self) -> int:
        """R, the staged-row axis (padded to the population's largest)."""
        return self.rows.shape[1]

    @property
    def n_outputs(self) -> int:
        return self.taps.shape[1]

    @property
    def zero_code(self) -> int:
        return self.n_rows_max + self.n_gates

    def to(self, device) -> "CircuitProgram":
        """A copy of the tensors on ``device`` (the same object if there)."""
        device = torch.device(device)
        if self.gates.device == device:
            return self
        return self._replace(**{
            k: getattr(self, k).to(device)
            for k in ("gates", "n_live", "rows", "n_rows", "taps")
        })


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.int64)


def compile_program(
    opcodes,    # i32[P, n]     raw gate opcodes
    edge_src,   # i32[P, n, 2]  operand ids
    out_src,    # i32[P, O]     output taps
    n_inputs: int,
    *,
    compact: bool = True,
) -> CircuitProgram:
    """Compile genome arrays (tensors or arrays, any device) into a
    `CircuitProgram` on the CPU.

    ``compact=False`` is for measurement only: it keeps every gate, in
    index order (the identity compaction, which walks what the genome
    walks), so a timing can split what compaction buys from the rest.
    No serving or predict path passes it."""
    opc, edge, outs = _np(opcodes), _np(edge_src), _np(out_src)
    pop, n = opc.shape
    n_in = int(n_inputs)
    if pop < 1 or n_in < 1 or n < 1:
        raise ValueError(
            f"a program needs circuits, inputs and gates (P={pop}, I={n_in}, n={n})")
    if edge.shape != (pop, n, 2) or outs.ndim != 2 or outs.shape[0] != pop:
        raise ValueError(
            f"genome arrays disagree: opcodes {opc.shape}, edge_src "
            f"{edge.shape}, out_src {outs.shape}"
        )
    global _compiles
    with _count_lock:
        _compiles += 1
    total = n_in + n

    def land(ids):  # the reference's vals[id]
        return np.clip(np.where(ids < 0, ids + total, ids), 0, total - 1)

    ops = np.where((opc >= 0) & (opc < G.N_OPCODES), opc, ZERO_GATE)
    arity = np.where(ops < G.NOT_A, 2, np.where(ops < ZERO_GATE, 1, 0))
    src = land(edge)
    needed = (src < n_in + np.arange(n)[None, :, None]) & (
        np.arange(2)[None, None, :] < arity[..., None])
    src = np.where(needed, src, -1)  # -1: reads zero
    taps = land(outs)

    circuits = []  # per circuit: (live gate ids, input rows read)
    for p in range(pop):
        if compact:
            live = np.zeros(n, bool)
            stack = [int(s) - n_in for s in taps[p] if s >= n_in]
            while stack:
                i = stack.pop()
                if not live[i]:
                    live[i] = True
                    stack.extend(int(s) - n_in for s in src[p, i] if s >= n_in)
        else:
            live = np.ones(n, bool)
        ids = np.flatnonzero(live)
        read = np.concatenate([src[p, ids].ravel(), taps[p]])
        circuits.append((ids, np.unique(read[(read >= 0) & (read < n_in)])))

    n_r = max(len(r) for _, r in circuits)
    n_l = max(len(i) for i, _ in circuits)
    zero = n_r + n_l
    gates = np.zeros((pop, n_l, 3), np.int32)
    gates[..., 0] = ZERO_GATE
    gates[..., 1:] = zero
    rows = np.zeros((pop, n_r), np.int32)
    n_live = np.zeros(pop, np.int32)
    n_rows = np.zeros(pop, np.int32)
    out = np.zeros(taps.shape, np.int32)
    for p, (ids, read) in enumerate(circuits):
        code = np.full(total + 1, zero, np.int64)  # landed id → code; [-1] → zero
        code[read] = np.arange(len(read))
        code[n_in + ids] = n_r + np.arange(len(ids))
        gates[p, :len(ids), 0] = ops[p, ids]
        gates[p, :len(ids), 1:] = code[src[p, ids]]
        rows[p, :len(read)] = read
        n_live[p], n_rows[p] = len(ids), len(read)
        out[p] = code[taps[p]]
    as_t = torch.from_numpy
    return CircuitProgram(as_t(gates), as_t(n_live), as_t(rows), as_t(n_rows),
                          as_t(out), n_in)
