"""Hand-written CUDA kernels for bit-packed circuit evaluation on Hopper.

`csrc/circuit_eval.cu` holds one ``__global__`` per TPU kernel of the
reference package (`eval_population_kernel`, `eval_population_spans_kernel`
in the reference's `kernels/circuit_eval.py`); the source says what each
computes and how it is laid out for the card.  This module builds that
source with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface at first use, loads it with `ctypes`, and wraps each kernel:

  * the wrappers take a `CircuitProgram` (`kernels/program.py`: each
    circuit's live gates, the input rows they read, its taps), compiled
    once on the host, and the words;
  * they take CUDA ``int32`` tensors only (words carry the
    reference's ``uint32`` bits) and raise on anything else — a CPU tensor
    is the plain version's business (`kernels/ref.py`, via `kernels/ops.py`);
  * outputs are allocated with `torch.empty`; launches go on the current
    stream of the input's device and are not synchronised;
  * a launch that CUDA refuses raises `CudaKernelError`;
  * each kernel counts its launches in ``KERNEL.launches``.

The spans wrapper comes in two halves: `resolve_spans` checks a resident
program once and fixes its launch configuration (`SpansConfig`), and
`launch_spans` checks only the words and the launch slots, then launches.
A serving shard's span-launch unit (`runtime/aot.py`) resolves once and
calls only the launch half on every tick; `eval_program_spans` is the two
in one call.

The build goes to ``build/repro_torch/`` at the repository root, keyed by
a hash of the source and flags, so an edited source rebuilds
(`kernels/native.py`).
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import native
from repro_torch.kernels.program import CircuitProgram
from repro_torch.serve.observability.trace import active

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "circuit_eval.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# dynamic shared memory one CTA may hold on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448
H100_SMS = 132


class CudaKernelError(RuntimeError):
    """A kernel failed to build, or its launch was refused."""


class CudaKernel:
    """One ``__global__`` of the library: its C launcher and launch count."""

    def __init__(self, name: str, symbol: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.replaces = replaces  # the TPU kernel this one ports
        self.launches = 0


EVAL_POPULATION = CudaKernel(
    "eval_population", "circuit_eval_program",
    "src/repro/kernels/circuit_eval.py:182",
)
EVAL_POPULATION_SPANS = CudaKernel(
    "eval_population_spans", "circuit_eval_program_spans",
    "src/repro/kernels/circuit_eval.py:137",
)
KERNELS = (EVAL_POPULATION, EVAL_POPULATION_SPANS)

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None
_builds = 0  # build_library calls that ran nvcc in this process


def build_count() -> int:
    """Calls of `build_library` that ran ``nvcc`` since the last reset."""
    return _builds


def reset_build_count() -> None:
    global _builds
    _builds = 0


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            return os.path.join(os.environ[env], "bin", "nvcc")
    return "/usr/local/cuda/bin/nvcc"  # the toolkit's default install prefix


def library_path() -> Path:
    """Where the built library for the current source and flags lives."""
    return native.library_path(SOURCE, NVCC_FLAGS)


def build_library() -> Path:
    """Compile the source unless this exact build exists; returns the .so.

    The compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside the library as ``.log``."""
    global _builds
    so = library_path()
    if so.exists():
        return so
    _builds += 1
    return native.build(so, _nvcc(), NVCC_FLAGS, SOURCE, CudaKernelError)


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, once per process.
    The load is a span ``kernels.load_library`` of the `active` recorder,
    whose ``built`` says whether ``nvcc`` ran for it (`build_count`)."""
    global _lib
    with _lock:
        if _lib is None:
            rec = active()
            t0, builds = rec.clock(), _builds
            lib = ctypes.CDLL(str(build_library()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.circuit_eval_program.argtypes = (
                [p] * 5 + [i] * 4 + [p] * 2 + [i] * 3 + [p])
            lib.circuit_eval_program.restype = i
            lib.circuit_eval_program_spans.argtypes = (
                [p] * 5 + [i] * 4 + [p] * 6 + [i] * 5 + [p])
            lib.circuit_eval_program_spans.restype = i
            lib.circuit_eval_error_string.argtypes = [i]
            lib.circuit_eval_error_string.restype = ctypes.c_char_p
            _lib = lib
            rec.complete("kernels.load_library", t0, rec.clock(), cat="kernels",
                         built=_builds > builds)
        return _lib


def smem_bytes(table_rows: int, n_gates: int, n_outputs: int, threads: int) -> int:
    """Dynamic shared memory of one CTA: the ``[R+L+1][T]`` value table
    (``table_rows`` = R+L+1), the packed gates and the taps."""
    return 4 * (table_rows * threads + n_gates + n_outputs)


def threads_per_block(program: CircuitProgram, words: int, circuits: int,
                      sms: int = H100_SMS) -> int:
    """Words (threads) per CTA for ``circuits`` circuits of ``words`` words
    each: the largest of 128, 64, 32 that still gives two CTAs per SM
    (else 32, the most CTAs), and no more than the program's table leaves
    room for in 227 KB."""
    rows = program.zero_code + 1
    fits = [t for t in (128, 64, 32) if smem_bytes(
        rows, program.n_gates, program.n_outputs, t) <= MAX_SMEM_BYTES]
    if not fits:
        raise ValueError(
            f"a program of {program.n_rows_max} staged rows and "
            f"{program.n_gates} live gates does not fit one CTA's shared "
            f"memory at 32 words per CTA ({MAX_SMEM_BYTES} bytes)"
        )
    for t in fits:
        if circuits * -(-words // t) >= 2 * sms:
            return t
    return fits[-1]


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        where = t.device if isinstance(t, torch.Tensor) else type(t).__name__
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, got {where}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, the words on {device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name}: expected int32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _words_device(x_words) -> torch.device:
    if not isinstance(x_words, torch.Tensor) or x_words.dim() != 2:
        raise ValueError("x_words must be a 2-D tensor")
    return x_words.device


def _check_program(program: CircuitProgram, dev) -> list:
    """Validate a program for a launch on ``dev``; returns its launch
    arguments (pointers and sizes)."""
    if not isinstance(program, CircuitProgram):
        raise ValueError(f"expected a CircuitProgram, got {type(program).__name__}")
    if program.gates.dim() != 3 or program.taps.dim() != 2:
        raise ValueError("program.gates must be 3-D and program.taps 2-D")
    pop, n_l, n_r, n_out = (program.pop, program.n_gates, program.n_rows_max,
                            program.n_outputs)
    _check("program.gates", program.gates, (pop, n_l, 3), dev)
    _check("program.n_live", program.n_live, (pop,), dev)
    _check("program.rows", program.rows, (pop, n_r), dev)
    _check("program.n_rows", program.n_rows, (pop,), dev)
    _check("program.taps", program.taps, (pop, n_out), dev)
    ptrs = [getattr(program, k).data_ptr()
            for k in ("gates", "n_live", "rows", "n_rows", "taps")]
    return [*ptrs, pop, n_l, n_r, n_out]


def _launch(kernel: CudaKernel, device, *args) -> None:
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, kernel.symbol)(*args, stream)
    if rc != 0:
        msg = lib.circuit_eval_error_string(rc).decode()
        raise CudaKernelError(f"{kernel.name}: launch failed ({rc}: {msg})")
    with _count_lock:  # a front end's scheduler thread and a swap's prewarm launch together
        kernel.launches += 1


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def eval_program(
    program: CircuitProgram,  # P circuits, compiled for I input rows
    x_words: torch.Tensor,    # i32[I, W]
) -> torch.Tensor:            # i32[P, O, W]
    """P live-gate programs over one shared packed dataset, on the card."""
    dev = _words_device(x_words)
    prog_args = _check_program(program, dev)
    _check("x_words", x_words, (program.n_inputs, x_words.shape[1]), dev)
    n_in, w = x_words.shape
    pop, n_out = program.pop, program.n_outputs
    out = torch.empty((pop, n_out, w), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    _launch(
        EVAL_POPULATION, dev, *prog_args, x_words.data_ptr(), out.data_ptr(),
        n_in, w, threads_per_block(program, w, pop, _sms(dev)),
    )
    return out


class SpansConfig(NamedTuple):
    """One resident program's spans launch, resolved: everything a launch
    passes besides the words and the launch-slot buffers."""

    device: torch.device
    program_args: tuple    # the program's pointers and sizes
    in_width_ptr: int
    n_inputs: int          # I_max, the words' rows
    n_outputs: int
    n_slots: int           # K launch slots
    w_total: int           # the words' columns, K * span for a tick
    span_words: int
    sms: int
    threads: int
    tensors: tuple         # the program and in_width, kept alive


def resolve_spans(
    program: CircuitProgram,  # a shard's S resident programs
    in_width: torch.Tensor,   # i32[S] live input rows of each circuit
    *,
    n_slots: int,
    w_total: int,
    span_words: int,
) -> SpansConfig:
    """Check a resident program and its input widths on their device once,
    and fix the launch configuration of ``n_slots`` launch slots of
    ``span_words`` words over a ``[I, w_total]`` buffer: the SM count and
    the threads per CTA."""
    if not isinstance(program, CircuitProgram):
        raise ValueError(f"expected a CircuitProgram, got {type(program).__name__}")
    dev = program.gates.device
    prog_args = _check_program(program, dev)
    _check("in_width", in_width, (program.pop,), dev)
    span, w_total = int(span_words), int(w_total)
    if not 1 <= span <= w_total:
        raise ValueError(
            f"span_words={span} must be in [1, {w_total}] (the buffer's words)"
        )
    sms = _sms(dev)
    return SpansConfig(
        dev, tuple(prog_args), in_width.data_ptr(), program.n_inputs,
        program.n_outputs, int(n_slots), w_total, span, sms,
        threads_per_block(program, span, int(n_slots), sms), (program, in_width),
    )


def launch_spans(
    cfg: SpansConfig,
    x_words: torch.Tensor,    # i32[I_max, W_total] fused multi-tenant buffer
    slots: torch.Tensor,      # i32[K] program circuit of launch slot k
    word_off: torch.Tensor,   # i32[K] word offset of slot k's span
    live: torch.Tensor,       # i32[K] 0 masks slot k's inputs off
) -> torch.Tensor:            # i32[K, O, span_words]
    """One spans launch of a resolved program: checks only the words and
    the launch-slot buffers, then launches."""
    dev, k = cfg.device, cfg.n_slots
    _check("x_words", x_words, (cfg.n_inputs, cfg.w_total), dev)
    _check("slots", slots, (k,), dev)
    _check("word_off", word_off, (k,), dev)
    _check("live", live, (k,), dev)
    out = torch.empty((k, cfg.n_outputs, cfg.span_words), dtype=torch.int32,
                      device=dev)
    if out.numel() == 0:
        return out
    _launch(
        EVAL_POPULATION_SPANS, dev, *cfg.program_args, x_words.data_ptr(),
        slots.data_ptr(), word_off.data_ptr(), cfg.in_width_ptr,
        live.data_ptr(), out.data_ptr(), k, cfg.n_inputs, cfg.w_total,
        cfg.span_words, cfg.threads,
    )
    return out


def eval_program_spans(
    program: CircuitProgram,  # a shard's S resident programs
    x_words: torch.Tensor,    # i32[I_max, W_total] fused multi-tenant buffer
    slots: torch.Tensor,      # i32[K] program circuit of launch slot k
    word_off: torch.Tensor,   # i32[K] word offset of slot k's span
    in_width: torch.Tensor,   # i32[S] live input rows of each circuit
    live: torch.Tensor,       # i32[K] 0 masks slot k's inputs off
    *,
    span_words: int,
) -> torch.Tensor:            # i32[K, O, span_words]
    """Launch slot k runs circuit ``slots[k]`` over its own word span of the
    fused buffer, input rows ``>= in_width[slots[k]] * live[k]`` read as
    zero; the slot gather happens inside the kernel.  Any offset is served
    as the reference's ``dynamic_slice`` serves it (negative from the end,
    then clamped into the buffer).  `resolve_spans` then `launch_spans`."""
    dev = _words_device(x_words)
    _check_program(program, dev)
    _check("x_words", x_words, (program.n_inputs, x_words.shape[1]), dev)
    if not isinstance(slots, torch.Tensor) or slots.dim() != 1:
        raise ValueError("slots must be a 1-D tensor")
    cfg = resolve_spans(program, in_width, n_slots=slots.shape[0],
                        w_total=x_words.shape[1], span_words=span_words)
    return launch_spans(cfg, x_words, slots, word_off, live)
