"""Hand-written CUDA kernels for bit-packed circuit evaluation on Hopper.

`csrc/circuit_eval.cu` holds one ``__global__`` per TPU kernel of the
reference package (`eval_population_kernel`, `eval_population_spans_kernel`
in the reference's `kernels/circuit_eval.py`); the source says what each
computes and how it is laid out for the card.  This module builds that
source with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface at first use, loads it with `ctypes`, and wraps each kernel:

  * the wrappers take CUDA ``int32`` tensors only (words carry the
    reference's ``uint32`` bits) and raise on anything else — a CPU tensor
    is the plain version's business (`kernels/ref.py`, via `kernels/ops.py`);
  * outputs are allocated with `torch.empty`; launches go on the current
    stream of the input's device and are not synchronised;
  * a launch that CUDA refuses raises `CudaKernelError`;
  * each kernel counts its launches in ``KERNEL.launches``.

The build goes to ``build/repro_torch/`` at the repository root, keyed by
a hash of the source and flags, so an edited source rebuilds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "circuit_eval.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# dynamic shared memory one CTA may hold on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448
MAX_THREADS = 128


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
    "eval_population", "circuit_eval_population",
    "src/repro/kernels/circuit_eval.py:182",
)
EVAL_POPULATION_SPANS = CudaKernel(
    "eval_population_spans", "circuit_eval_population_spans",
    "src/repro/kernels/circuit_eval.py:137",
)
KERNELS = (EVAL_POPULATION, EVAL_POPULATION_SPANS)

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None


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
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(repr(NVCC_FLAGS).encode())
    return BUILD_DIR / f"circuit_eval_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the source unless this exact build exists; returns the .so.

    The compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside the library as ``.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as err:
        raise CudaKernelError(f"cannot run nvcc ({cmd[0]}): {err}") from err
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise CudaKernelError(
            f"nvcc failed ({proc.returncode}) building {SOURCE.name}:\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, so)  # atomic: a concurrent build never sees a half file
    return so


def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library, once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.circuit_eval_population.argtypes = [p] * 5 + [i] * 6 + [p]
            lib.circuit_eval_population.restype = i
            lib.circuit_eval_population_spans.argtypes = (
                [p] * 7 + [i] * 7 + [p]
            )
            lib.circuit_eval_population_spans.restype = i
            lib.circuit_eval_error_string.argtypes = [i]
            lib.circuit_eval_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def threads_per_block(n_nodes: int, n_outputs: int) -> int:
    """Words (threads) per CTA: up to 128, as many as the [n][T] gate table
    plus the staged genome leave room for in 227 KB, in whole warps."""
    genome_bytes = 4 * (3 * n_nodes + n_outputs)
    t = (MAX_SMEM_BYTES - genome_bytes) // (4 * n_nodes) // 32 * 32
    if t < 32:
        raise ValueError(
            f"a circuit of {n_nodes} gates does not fit one CTA's shared "
            f"memory at 32 words per CTA ({MAX_SMEM_BYTES} bytes)"
        )
    return min(MAX_THREADS, t)


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


def _check_circuits(opcodes, edge_src, out_src, x_words):
    """Validate the genome arrays and the words for a launch; returns
    (P, n, O, I, W, device)."""
    for name, t, dims in (("x_words", x_words, 2), ("opcodes", opcodes, 2),
                          ("out_src", out_src, 2)):
        if not isinstance(t, torch.Tensor) or t.dim() != dims:
            raise ValueError(f"{name} must be a {dims}-D tensor")
    n_in, w = x_words.shape
    pop, n = opcodes.shape
    n_out = out_src.shape[1]
    if n < 1:
        raise ValueError("a circuit needs at least one gate")
    dev = x_words.device
    _check("x_words", x_words, (n_in, w), dev)
    _check("opcodes", opcodes, (pop, n), dev)
    _check("edge_src", edge_src, (pop, n, 2), dev)
    _check("out_src", out_src, (pop, n_out), dev)
    return pop, n, n_out, n_in, w, dev


def _launch(kernel: CudaKernel, device, *args) -> None:
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, kernel.symbol)(*args, stream)
    if rc != 0:
        msg = lib.circuit_eval_error_string(rc).decode()
        raise CudaKernelError(f"{kernel.name}: launch failed ({rc}: {msg})")
    kernel.launches += 1


def eval_population(
    opcodes: torch.Tensor,   # i32[P, n]
    edge_src: torch.Tensor,  # i32[P, n, 2]
    out_src: torch.Tensor,   # i32[P, O]
    x_words: torch.Tensor,   # i32[I, W]
) -> torch.Tensor:           # i32[P, O, W]
    """P circuits over one shared packed dataset, on the card."""
    pop, n, n_out, n_in, w, dev = _check_circuits(opcodes, edge_src, out_src, x_words)
    out = torch.empty((pop, n_out, w), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    _launch(
        EVAL_POPULATION, dev,
        opcodes.data_ptr(), edge_src.data_ptr(), out_src.data_ptr(),
        x_words.data_ptr(), out.data_ptr(),
        pop, n, n_out, n_in, w, threads_per_block(n, n_out),
    )
    return out


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
    """Circuit p over its own word span of the fused buffer, input rows
    ``>= in_width[p]`` read as zero; any offset is served as the
    reference's ``dynamic_slice`` serves it (negative from the end, then
    clamped into the buffer)."""
    pop, n, n_out, n_in, w_total, dev = _check_circuits(
        opcodes, edge_src, out_src, x_words)
    _check("word_off", word_off, (pop,), dev)
    _check("in_width", in_width, (pop,), dev)
    span = int(span_words)
    if not 1 <= span <= w_total:
        raise ValueError(
            f"span_words={span} must be in [1, {w_total}] (the buffer's words)"
        )
    out = torch.empty((pop, n_out, span), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    _launch(
        EVAL_POPULATION_SPANS, dev,
        opcodes.data_ptr(), edge_src.data_ptr(), out_src.data_ptr(),
        x_words.data_ptr(), word_off.data_ptr(), in_width.data_ptr(),
        out.data_ptr(),
        pop, n, n_out, n_in, w_total, span, threads_per_block(n, n_out),
    )
    return out
