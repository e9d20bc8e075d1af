"""Span-launch units: a serving shard's launch, resolved once, storable.

The serving tick's hot path is one spans-kernel launch per plan shard.
Before that launch can run, a shard needs cold work that depends only on
its content, never on the traffic:

  * the kernel library, built once per source hash by ``nvcc``
    (`kernels/circuit_eval.py` `build_library`);
  * the shard's live-gate program (`kernels/program.py`
    `compile_program`, a host pass over the genome) and its upload;
  * the launch configuration: the program's checks, the SM count and the
    threads per CTA.

A `SpanLaunch` is all of that done once for one (shard content hash, span
bucket, device): the program and input widths resident on the device and
the resolved `SpansConfig`.  Called with the fused words and the tick's
launch-slot buffers it checks only those and makes exactly one spans
launch (`circuit_eval.launch_spans`).  On a CPU device it runs the plain
version (`kernels/ref.py`), the one place a CPU tensor goes.

`serialize_executable` writes a unit as an ``npz`` (no pickle): the
program's host arrays, the input widths, the `SpanLaunchSpec`, the
program format and the key of the kernel library it was compiled against.
It carries no binary: the kernels are always built from this tree's
sources.  `deserialize_executable` rebuilds the unit without running
`compile_program`, and refuses a payload whose arrays do not match its
spec or whose library key is not this tree's build.

Cold-work accounting: `compile_count` counts the calls that ran
`compile_program` and `build_count` the library builds that ran ``nvcc``
(both bumped where the work happens); a boot from stored units must leave
both at zero.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import circuit_eval, program, ref
from repro_torch.kernels.program import ZERO_GATE, CircuitProgram

AOT_FORMAT = "repro-torch-span-launch"
AOT_FORMAT_VERSION = 1
# the layout of `CircuitProgram` a payload's arrays follow
PROGRAM_FORMAT = "live-gate-program-v1"
TARGET = "sm_90a"
_PROGRAM_ARRAYS = ("gates", "n_live", "rows", "n_rows", "taps")

compile_count = program.compile_count
reset_compile_count = program.reset_compile_count
build_count = circuit_eval.build_count
reset_build_count = circuit_eval.reset_build_count


def library_key() -> str:
    """The kernel library a unit runs against: this tree's build (source
    and flags hash) and its target."""
    return f"{circuit_eval.library_path().name}:{TARGET}"


class SpanLaunchSpec(NamedTuple):
    """Static shape tuple of one shard's fused span launch.

    ``n_slots`` is the shard's slot axis, ``k_pad`` the launch slot axis
    (equal to ``n_slots`` under the server's stable-shapes policy), and
    ``span_words`` the power-of-2, alignment-rounded word bucket of the
    tick."""

    n_slots: int     # S: the shard's circuits
    k_pad: int       # K: launch slot axis (== n_slots when shapes are stable)
    n_nodes: int     # n: padded gate count per slot
    n_outputs: int   # O: padded output count per slot
    n_inputs: int    # I: padded input-row count of the fused x buffer
    span_words: int  # static span bucket (words per launch slot)

    @property
    def x_words(self) -> int:
        """Word width of the fused input buffer: one span per launch slot."""
        return self.k_pad * self.span_words


def executable_key(backend_name: str, content_hash: str, span_words: int) -> str:
    """Content-addressed cache key of one span-launch unit:
    ``(backend, shard content hash, span bucket)`` — the reference's
    format, so the two packages' keys for one shard differ only in the
    backend's name."""
    return f"{backend_name}--{content_hash}--s{int(span_words)}"


class SpanLaunch:
    """One shard's span launch, resolved on its device (see module doc).

    ``unit(x_words, slots, word_off, live)`` → ``i32[K, O, span_words]``,
    with ``x_words`` of shape ``[spec.n_inputs, spec.x_words]`` and the
    three launch-slot buffers of length ``spec.k_pad``, all on ``device``.
    """

    def __init__(self, spec: SpanLaunchSpec, prog: CircuitProgram,
                 in_width: torch.Tensor, device):
        self.spec = SpanLaunchSpec(*(int(v) for v in spec))
        self.device = torch.device(device)
        self.program = prog.to(self.device)
        self.in_width = in_width.to(device=self.device, dtype=torch.int32).contiguous()
        _check_spec(self.spec, self.program, self.in_width)
        self.config = None
        if self.device.type == "cuda":
            self.config = circuit_eval.resolve_spans(
                self.program, self.in_width, n_slots=self.spec.k_pad,
                w_total=self.spec.x_words, span_words=self.spec.span_words,
            )

    def respan(self, span_words: int) -> "SpanLaunch":
        """The same resident program at another span bucket (no compile)."""
        return SpanLaunch(self.spec._replace(span_words=int(span_words)),
                          self.program, self.in_width, self.device)

    def __call__(self, x_words, slots, word_off, live) -> torch.Tensor:
        if self.config is not None:
            return circuit_eval.launch_spans(self.config, x_words, slots, word_off, live)
        # the plain version takes any shape; a unit takes only its own
        k = self.spec.k_pad
        if (tuple(x_words.shape) != (self.spec.n_inputs, self.spec.x_words)
                or any(tuple(t.shape) != (k,) for t in (slots, word_off, live))):
            raise ValueError(
                f"a unit of spec {tuple(self.spec)} takes words "
                f"{(self.spec.n_inputs, self.spec.x_words)} and {k} launch slots"
            )
        return ref.eval_program_spans(
            self.program, x_words, slots, word_off, self.in_width, live,
            span_words=self.spec.span_words,
        )

    def __repr__(self) -> str:
        return f"<SpanLaunch {tuple(self.spec)} on {self.device}>"


def _check_spec(spec: SpanLaunchSpec, prog: CircuitProgram, in_width) -> None:
    if min(spec) < 1 or prog.n_gates > spec.n_nodes:
        raise ValueError(f"span launch spec {tuple(spec)} is invalid for a "
                         f"program of {prog.n_gates} live gates")
    got = (prog.pop, prog.n_outputs, prog.n_inputs, tuple(in_width.shape))
    want = (spec.n_slots, spec.n_outputs, spec.n_inputs, (spec.n_slots,))
    if got != want:
        raise ValueError(
            f"spec {tuple(spec)} does not match the program: (circuits, "
            f"outputs, inputs, in_width shape) = {got}, expected {want}"
        )


def shard_spec(shard, span_words: int, k_pad: "int | None" = None) -> SpanLaunchSpec:
    """The spec of one plan shard's launch at ``span_words`` (``k_pad``
    defaults to the shard's slot count, the stable-shapes launch)."""
    return SpanLaunchSpec(
        n_slots=shard.n_slots,
        k_pad=shard.n_slots if k_pad is None else int(k_pad),
        n_nodes=int(shard.opcodes.shape[1]),
        n_outputs=int(shard.out_src.shape[1]),
        n_inputs=int(shard.n_inputs_max),
        span_words=int(span_words),
    )


def compile_span_launch(backend, spec: SpanLaunchSpec, shard, *, device=None) -> SpanLaunch:
    """Compile one plan shard (a `LaunchPlan`) into its span-launch unit on
    ``device`` (``None``: the card, raising without one): the shard's
    live-gate program, uploaded with its input widths, and the launch
    resolved for ``spec``.  ``backend`` is the `EvalBackend` that asked
    (`EvalBackend.compile_spans`); the port has one spans kernel, and
    every unit launches it, so the argument selects nothing."""
    del backend
    device = resolve_device(device)
    if tuple(spec) != tuple(shard_spec(shard, spec.span_words, spec.k_pad)):
        raise ValueError(
            f"spec {tuple(spec)} is not shard {shard.shard}'s "
            f"{tuple(shard_spec(shard, spec.span_words, spec.k_pad))}"
        )
    prog = program.compile_program(shard.opcodes, shard.edge_src, shard.out_src,
                                   shard.n_inputs_max)
    return SpanLaunch(spec, prog, torch.from_numpy(np.array(shard.in_width, np.int32)),
                      device)


def serialize_executable(unit: SpanLaunch) -> bytes:
    """A unit as ``npz`` bytes: the program's host arrays, the input widths
    and a JSON header (format, spec, program format, library key)."""
    header = {
        "format": AOT_FORMAT, "format_version": AOT_FORMAT_VERSION,
        "spec": list(unit.spec), "program_format": PROGRAM_FORMAT,
        "n_inputs": int(unit.program.n_inputs), "library": library_key(),
    }
    arrays = {k: getattr(unit.program, k).cpu().numpy() for k in _PROGRAM_ARRAYS}
    buf = io.BytesIO()
    np.savez(buf, header=np.array(json.dumps(header, sort_keys=True)),
             in_width=unit.in_width.cpu().numpy(), **arrays)
    return buf.getvalue()


def _well_formed(prog: CircuitProgram) -> bool:
    """Shapes and codes a kernel may read: every count, row and code
    inside its table (what `compile_program` guarantees)."""
    g = prog.gates
    if g.dim() != 3 or g.shape[2] != 3 or prog.rows.dim() != 2 or prog.taps.dim() != 2:
        return False
    pop, n_l, n_r = g.shape[0], g.shape[1], prog.rows.shape[1]
    if not (tuple(prog.n_live.shape) == tuple(prog.n_rows.shape) == (pop,)
            and prog.rows.shape[0] == prog.taps.shape[0] == pop):
        return False

    def within(t, hi):  # every value in [0, hi]
        return bool(((t >= 0) & (t <= hi)).all())

    return (within(prog.n_live, n_l) and within(prog.n_rows, n_r)
            and within(prog.rows, prog.n_inputs - 1) and within(g[..., 0], ZERO_GATE)
            and within(g[..., 1:], n_r + n_l) and within(prog.taps, n_r + n_l))


def deserialize_executable(payload: bytes, *, device=None) -> SpanLaunch:
    """Rebuild a stored unit on ``device`` (``None``: the card, raising
    without one) without compiling its program.

    Raises ValueError on bytes that are not a unit, on another format or
    program format, on arrays that do not match the spec, and on a
    library key other than this tree's build; callers log the reason and
    compile the shard instead."""
    device = resolve_device(device)
    try:
        with np.load(io.BytesIO(payload), allow_pickle=False) as z:
            header = json.loads(str(z["header"]))
            arrays = {k: np.array(z[k]) for k in (*_PROGRAM_ARRAYS, "in_width")}
        spec = SpanLaunchSpec(*(int(v) for v in header["spec"]))
        n_inputs = int(header["n_inputs"])
    except (OSError, EOFError, KeyError, TypeError, ValueError, zipfile.BadZipFile) as err:
        raise ValueError(f"not a span-launch unit ({type(err).__name__}: {err})") from err
    if (header.get("format"), header.get("format_version")) != (AOT_FORMAT,
                                                              AOT_FORMAT_VERSION):
        raise ValueError(f"unit format {header.get('format')!r} "
                         f"v{header.get('format_version')}, expected {AOT_FORMAT!r} "
                         f"v{AOT_FORMAT_VERSION}")
    if header.get("program_format") != PROGRAM_FORMAT:
        raise ValueError(f"program format {header.get('program_format')!r}, "
                         f"expected {PROGRAM_FORMAT!r}")
    if header.get("library") != library_key():
        raise ValueError(f"unit compiled against kernel library "
                         f"{header.get('library')!r}, this tree builds {library_key()!r}")
    if any(a.dtype != np.int32 for a in arrays.values()):
        raise ValueError("unit arrays must be int32")
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}
    prog = CircuitProgram(*(t[k] for k in _PROGRAM_ARRAYS), n_inputs)
    if not _well_formed(prog):
        raise ValueError("unit arrays are not a well-formed live-gate program")
    return SpanLaunch(spec, prog, t["in_width"], device)
