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

Two routes compute the same programs, bit for bit.  The native route
(`csrc/program.cc`, plain host C++ built with the system's ``c++`` at
first use and loaded with `ctypes`) compiles the whole population in one
call, the fn-set lookup of a genome's stored indices included, straight
into one ``int32`` buffer laid out as

    gates [P, L, 3] | n_live [P] | rows [P, R] | n_rows [P] | taps [P, O]

and `program_views` reads a `CircuitProgram` off such a buffer on any
device: the search (`core/evolve.py`) compiles into the pinned buffer of
a `PopulationCompiler`, which checks its buffer, scratch and table once,
and sends the used prefix to the card in one copy.  The other callers
(serving's shards, `runtime/aot`, `runtime/base`, predict) call
`compile_program`, which makes a `PopulationCompiler` for one compile,
and copy its program with ``.to(device)``.  `_compile_numpy` is the
plain version: the tests hold the native route to it, and a
`PopulationCompiler` takes it wherever no C++ compiler is found.
`compile_counts` counts the compiles by route.
"""
from __future__ import annotations

import ctypes
import shutil
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import gates as G
from repro_torch.kernels import native
from repro_torch.serve.observability.trace import active

ZERO_GATE = G.N_OPCODES  # opcode of a gate whose output is all zeros

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "program.cc"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")
ROUTES = ("native", "numpy")

# compiles in this process by route: the serving stack's cold work, which
# a boot from stored span-launch units must not repeat
_count_lock = threading.Lock()
_compiles = dict.fromkeys(ROUTES, 0)

_lib_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None
_lib_loaded = False  # load_library has decided, for this process


class ProgramBuildError(RuntimeError):
    """The C++ compiler failed on the native program compiler."""


def compile_counts() -> dict[str, int]:
    """Compiles since the last reset, by route (`ROUTES`)."""
    with _count_lock:
        return dict(_compiles)


def compile_count() -> int:
    """Compiles since the last reset, both routes."""
    return sum(compile_counts().values())


def reset_compile_count() -> None:
    with _count_lock:
        for route in ROUTES:
            _compiles[route] = 0


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


def program_words(pop: int, n_gates: int, n_inputs: int, n_outputs: int) -> int:
    """``int32`` words of the largest program of ``pop`` genomes of
    ``n_gates`` gates: every gate live and every input row staged."""
    return pop * (3 * n_gates + n_inputs + n_outputs + 2)


def used_words(pop: int, n_live_max: int, n_rows_max: int, n_outputs: int) -> int:
    """``int32`` words a program of these sizes takes in its buffer."""
    return pop * (3 * n_live_max + n_rows_max + n_outputs + 2)


def program_views(buf: torch.Tensor, pop: int, n_live_max: int, n_rows_max: int,
                  n_outputs: int, n_inputs: int) -> CircuitProgram:
    """The `CircuitProgram` laid out at the start of ``buf`` (1-D
    ``int32``, any device): contiguous views, no copy."""
    sizes = (pop * n_live_max * 3, pop, pop * n_rows_max, pop, pop * n_outputs)
    g, n_live, rows, n_rows, taps = buf[:sum(sizes)].split(sizes)
    return CircuitProgram(g.view(pop, n_live_max, 3), n_live,
                          rows.view(pop, n_rows_max), n_rows,
                          taps.view(pop, n_outputs), n_inputs)


def _cxx() -> "str | None":
    return shutil.which("c++")


def library_path() -> Path:
    """Where the native compiler built from the current source lives."""
    return native.library_path(SOURCE, CXX_FLAGS)


def load_library() -> "ctypes.CDLL | None":
    """The native compiler, built at first use and loaded once per
    process; ``None`` where it is not built and no ``c++`` is found (the
    NumPy route).  A library whose ``NOT_A`` and ``ZERO_GATE`` are not
    `core/gates`'s is refused.  The load is a span
    ``kernels.load_program_library`` of the `active` recorder, whose
    ``built`` says whether ``c++`` ran."""
    global _lib, _lib_loaded
    if _lib_loaded:
        return _lib
    with _lib_lock:
        if not _lib_loaded:
            rec = active()
            t0 = rec.clock()
            so, built = library_path(), False
            if not so.exists():
                cxx = _cxx()
                if cxx is None:
                    _lib_loaded = True
                    return None
                native.build(so, cxx, CXX_FLAGS, SOURCE, ProgramBuildError)
                built = True
            lib = ctypes.CDLL(str(so))
            table = tuple(ctypes.c_int32.in_dll(lib, k).value
                          for k in ("program_not_a", "program_zero_gate"))
            if table != (G.NOT_A, ZERO_GATE):
                raise ProgramBuildError(
                    f"{so.name} has NOT_A, ZERO_GATE = {table}; core/gates has "
                    f"{(G.NOT_A, ZERO_GATE)}")
            p, i, q = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            lib.program_compile.argtypes = [p] * 4 + [i] * 6 + [p, q, p, q, p]
            lib.program_compile.restype = i
            lib.program_scratch_words.argtypes = [i] * 3
            lib.program_scratch_words.restype = q
            _lib, _lib_loaded = lib, True
            rec.complete("kernels.load_program_library", t0, rec.clock(),
                         cat="kernels", built=built)
        return _lib


def _count(route: str) -> None:
    with _count_lock:
        _compiles[route] += 1


def _i32(a, lo: int, hi: int) -> torch.Tensor:
    """``a`` (a tensor on any device, or an array) as a contiguous
    ``int32`` CPU tensor; wider values are clamped into ``[lo, hi]``,
    where they read as they did before."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype != torch.int32:
            a = a.to(torch.int64).clamp(lo, hi).to(torch.int32)
        return a.cpu().contiguous()
    a = np.asarray(a)
    if a.dtype != np.int32:
        a = np.clip(a.astype(np.int64), lo, hi).astype(np.int32)
    elif not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy()
    return torch.from_numpy(a)


def _plain(a) -> bool:
    """``a`` is a contiguous ``int32`` host tensor: the native pass reads it
    as it is."""
    return isinstance(a, torch.Tensor) and a.dtype == torch.int32 and a.is_cpu \
        and a.is_contiguous()


def _shapes(gate_fn, edge_src, out_src, n_inputs: int) -> tuple[int, int, int]:
    """``(P, n, O)`` of genome arrays, which must agree."""
    if (gate_fn.ndim != 2 or tuple(edge_src.shape) != (*gate_fn.shape, 2)
            or out_src.ndim != 2 or out_src.shape[0] != gate_fn.shape[0]):
        raise ValueError(
            f"genome arrays disagree: opcodes {tuple(gate_fn.shape)}, edge_src "
            f"{tuple(edge_src.shape)}, out_src {tuple(out_src.shape)}"
        )
    pop, n = gate_fn.shape
    if pop < 1 or int(n_inputs) < 1 or n < 1:
        raise ValueError(f"a program needs circuits, inputs and gates "
                         f"(P={pop}, I={int(n_inputs)}, n={n})")
    return pop, n, out_src.shape[1]


class PopulationCompiler:
    """The program compiler bound to what stays the same from one compile
    to the next: a host buffer ``buf`` for up to ``pop`` genomes of
    ``n_gates`` gates and ``n_outputs`` taps (pinned where ``pinned``, so a
    copy out of it can be asynchronous), the native pass's scratch, and
    the fn-set table, all checked once here.  The search makes one and
    calls it every generation; `compile_program` makes one a compile."""

    def __init__(self, pop: int, n_gates: int, n_inputs: int, n_outputs: int,
                 fn_table=None, *, pinned: bool = False):
        self.pop, self.n_gates, self.n_outputs = pop, n_gates, n_outputs
        self.n_inputs = int(n_inputs)
        if min(pop, n_gates, self.n_inputs, n_outputs) < 1:
            raise ValueError(f"a program needs circuits, gates, inputs and taps "
                             f"(P={pop}, n={n_gates}, I={self.n_inputs}, O={n_outputs})")
        self.buf = torch.empty(program_words(pop, n_gates, self.n_inputs, n_outputs),
                               dtype=torch.int32, pin_memory=pinned)
        self.fn_table = None if fn_table is None else _i32(fn_table, -1, ZERO_GATE)
        self._lib = load_library()
        if self._lib is not None:
            self._scratch = torch.empty(
                self._lib.program_scratch_words(pop, n_gates, self.n_inputs),
                dtype=torch.int32)
            self._lr = (ctypes.c_int32 * 2)()
            table = self.fn_table
            self._args = (  # program_compile's arguments that never change
                None if table is None else table.data_ptr(),
                0 if table is None else len(table),
                self.buf.data_ptr(), self.buf.numel(), self._scratch.data_ptr(),
                self._scratch.numel(), ctypes.addressof(self._lr))

    def fits(self, pop: int, n_gates: int, n_outputs: int) -> bool:
        """Whether genomes of these sizes compile into ``buf``."""
        return pop <= self.pop and n_gates == self.n_gates and n_outputs == self.n_outputs

    def __call__(self, gate_fn: torch.Tensor, edge_src: torch.Tensor,
                 out_src: torch.Tensor, *, compact: bool = True) -> tuple[int, int]:
        """Compile genome arrays, contiguous ``int32`` host tensors
        (``gate_fn`` [P, n]: fn-set indices with a table, else opcodes;
        ``edge_src`` [P, n, 2]; ``out_src`` [P, O]; P at most ``pop``), into
        the start of ``buf``; returns the program's ``(L, R)``
        (`program_views` reads it).  ``compact`` as `compile_program`'s."""
        pop, n = gate_fn.shape if gate_fn.ndim == 2 else (0, 0)
        if not (_plain(gate_fn) and _plain(edge_src) and _plain(out_src)
                and 1 <= pop <= self.pop and n == self.n_gates
                and edge_src.shape == (pop, n, 2) and out_src.shape == (pop, self.n_outputs)):
            raise ValueError(
                f"the compiler takes contiguous int32 host tensors of up to "
                f"{self.pop} genomes of {self.n_gates} gates and {self.n_outputs} taps; "
                f"got {gate_fn.dtype} {tuple(gate_fn.shape)}, {edge_src.dtype} "
                f"{tuple(edge_src.shape)}, {out_src.dtype} {tuple(out_src.shape)}")
        if self._lib is None:
            return self._numpy(gate_fn, edge_src, out_src, compact)
        table, n_fn, *out = self._args
        rc = self._lib.program_compile(
            gate_fn.data_ptr(), edge_src.data_ptr(), out_src.data_ptr(), table, n_fn,
            pop, n, self.n_outputs, self.n_inputs, int(compact), *out)
        if rc == -1:
            raise IndexError(f"a gate's fn-set index is outside the table of {n_fn}")
        if rc != 0:  # the buffers are sized above for the largest program
            raise RuntimeError(f"program_compile refused its buffers ({rc})")
        _count("native")
        return self._lr[0], self._lr[1]

    def _numpy(self, gate_fn, edge_src, out_src, compact: bool) -> tuple[int, int]:
        """The route where no C++ compiler is found: `_compile_numpy`,
        written into ``buf`` as the native pass writes it."""
        opc = gate_fn.numpy()
        if self.fn_table is not None:
            opc = self.fn_table.numpy()[opc]  # IndexError past the table, as native
        prog = _compile_numpy(opc, edge_src, out_src, self.n_inputs, compact=compact)
        size = used_words(len(opc), prog.n_gates, prog.n_rows_max, self.n_outputs)
        self.buf[:size] = torch.cat([t.reshape(-1) for t in prog[:5]])
        _count("numpy")
        return prog.n_gates, prog.n_rows_max


def compile_program(
    opcodes,    # i32[P, n]     raw gate opcodes
    edge_src,   # i32[P, n, 2]  operand ids
    out_src,    # i32[P, O]     output taps
    n_inputs: int,
    *,
    compact: bool = True,
) -> CircuitProgram:
    """Compile genome arrays (tensors or arrays, any device) into a
    `CircuitProgram` on the CPU: views of the buffer of a
    `PopulationCompiler` made for this one compile.

    ``compact=False`` is for measurement only: it keeps every gate, in
    index order (the identity compaction, which walks what the genome
    walks), so a timing can split what compaction buys from the rest.
    No serving or predict path passes it."""
    arrays = [a if isinstance(a, torch.Tensor) else np.asarray(a)
              for a in (opcodes, edge_src, out_src)]
    pop, n, n_out = _shapes(*arrays, n_inputs)
    total = int(n_inputs) + n
    opc = _i32(arrays[0], -1, ZERO_GATE)
    edge, outs = (_i32(a, -total - 1, total) for a in arrays[1:])
    compiler = PopulationCompiler(pop, n, n_inputs, n_out)
    n_l, n_r = compiler(opc, edge, outs, compact=compact)
    return program_views(compiler.buf, pop, n_l, n_r, n_out, int(n_inputs))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.int64)


def _compile_numpy(
    opcodes,    # i32[P, n]     raw gate opcodes
    edge_src,   # i32[P, n, 2]  operand ids
    out_src,    # i32[P, O]     output taps
    n_inputs: int,
    *,
    compact: bool = True,
) -> CircuitProgram:
    """The plain version of `compile_program`, in NumPy: separate CPU
    tensors, not counted."""
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
