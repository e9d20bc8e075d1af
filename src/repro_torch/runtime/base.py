"""EvalBackend abstraction: the execution seam of the port.

A backend owns *how* a population of sea-of-gates circuits is evaluated
on bit-packed ``int32`` words.  It implements two entry points over
live-gate programs (`kernels/program.py`, compiled once on the host):

  * ``eval_program(program, x_words)`` → i32[P, O, W]
  * ``eval_program_spans(program, x_words, slots, word_off, in_width,
    live, *, span_words)`` → i32[K, O, span_words]: launch slot k runs
    program circuit ``slots[k]`` over its own span, input rows
    ≥ ``in_width[slots[k]] * live[k]`` masked to zero (the slot gather is
    part of the entry point, so a shard's tick is one call)

and, on top of them, three genome-level entry points whose contracts are
fixed (each compiles a program, then evaluates it):

  * ``eval_population(opcodes, edge_src, out_src, x_words)``
      i32[P, n], i32[P, n, 2], i32[P, O], i32[I, W] → i32[P, O, W]
  * ``eval_population_spans(..., word_off, in_width, *, span_words)``
      multi-tenant serving path: circuit p reads only words
      [word_off[p], word_off[p]+span_words) with input rows ≥ in_width[p]
      masked to zero → i32[P, O, span_words]
  * ``eval_circuit(...)`` single-circuit convenience → i32[O, W]

All backends are bit-identical on these contracts; they differ only in
speed and in the devices they run on, which `capabilities()` describes.
A backend that declares ``supports_aot`` also compiles a plan shard into
a storable span-launch unit (`compile_spans`, `runtime/aot.py`).
"""
from __future__ import annotations

import abc
import dataclasses

import torch

from repro_torch.kernels.program import CircuitProgram, compile_program
from repro_torch.runtime import aot


class BackendCapabilityError(NotImplementedError):
    """A backend was asked for something it declares it cannot do (a
    span-launch unit from a backend without ``supports_aot``)."""


@dataclasses.dataclass(frozen=True)
class BackendCapabilities:
    """Static descriptor of what an execution backend can do.

    ``word_alignment`` is the word-axis granularity the backend needs
    (1 = none).  ``span_offset_contract`` documents the constraint on
    ``word_off`` entries for the spans entry point.  ``supports_aot``
    declares whether `compile_spans` can make a storable span-launch unit
    (`runtime/aot.py`); ``aot_format``/``aot_format_version`` name its
    stored form, so an artifact store can skip payloads it cannot load."""

    name: str
    device_kinds: tuple[str, ...]   # e.g. ("cpu", "cuda")
    supports_spans: bool
    word_alignment: int
    span_offset_contract: str = "none"
    supports_aot: bool = False
    aot_format: str = ""
    aot_format_version: int = 0


class EvalBackend(abc.ABC):
    """One execution strategy for circuit evaluation (stateless w.r.t. the
    data it evaluates, so safe to share across threads)."""

    name: str = "abstract"

    @abc.abstractmethod
    def capabilities(self) -> BackendCapabilities:
        """Static descriptor: spans support, alignment, device kinds."""

    @abc.abstractmethod
    def eval_program(
        self,
        program: CircuitProgram,  # P circuits compiled for I input rows
        x_words: torch.Tensor,    # i32[I, W]
    ) -> torch.Tensor:            # i32[P, O, W]
        """Evaluate live-gate programs on a shared packed dataset."""

    @abc.abstractmethod
    def eval_program_spans(
        self,
        program: CircuitProgram,  # S resident circuits (a plan shard)
        x_words: torch.Tensor,    # i32[I_max, W_total] fused buffer
        slots: torch.Tensor,      # i32[K] program circuit of launch slot k
        word_off: torch.Tensor,   # i32[K] word offset of slot k's span
        in_width: torch.Tensor,   # i32[S] live input rows per circuit
        live: torch.Tensor,       # i32[K] 0 masks slot k's inputs off
        *,
        span_words: int,
    ) -> torch.Tensor:            # i32[K, O, span_words]
        """Multi-tenant eval: slot gather, span windows and width masks."""

    def eval_population(
        self,
        opcodes: torch.Tensor,   # i32[P, n]
        edge_src: torch.Tensor,  # i32[P, n, 2]
        out_src: torch.Tensor,   # i32[P, O]
        x_words: torch.Tensor,   # i32[I, W]
    ) -> torch.Tensor:           # i32[P, O, W]
        """Evaluate a population of circuits on a shared packed dataset."""
        program = compile_program(opcodes, edge_src, out_src, x_words.shape[0])
        return self.eval_program(program.to(x_words.device), x_words)

    def eval_population_spans(
        self,
        opcodes: torch.Tensor,   # i32[P, n]
        edge_src: torch.Tensor,  # i32[P, n, 2]
        out_src: torch.Tensor,   # i32[P, O]
        x_words: torch.Tensor,   # i32[I_max, W_total] fused buffer
        word_off: torch.Tensor,  # i32[P] word offset of circuit p's span
        in_width: torch.Tensor,  # i32[P] live input rows of circuit p
        *,
        span_words: int,
    ) -> torch.Tensor:           # i32[P, O, span_words]
        """Multi-tenant population eval over per-circuit word spans."""
        dev = x_words.device
        program = compile_program(opcodes, edge_src, out_src, x_words.shape[0])
        slots = torch.arange(program.pop, dtype=torch.int32, device=dev)
        return self.eval_program_spans(
            program.to(dev), x_words, slots, word_off, in_width,
            torch.ones_like(slots), span_words=span_words,
        )

    def eval_circuit(
        self,
        opcodes: torch.Tensor,   # i32[n]
        edge_src: torch.Tensor,  # i32[n, 2]
        out_src: torch.Tensor,   # i32[O]
        x_words: torch.Tensor,   # i32[I, W]
    ) -> torch.Tensor:           # i32[O, W]
        """Single-circuit convenience wrapper (a population of 1)."""
        out = self.eval_population(
            opcodes[None], edge_src[None], out_src[None], x_words
        )
        return out[0]

    def compile_spans(self, spec, shard, *, device=None) -> "aot.SpanLaunch":
        """Compile one plan shard (a `LaunchPlan`) into its span-launch unit
        for ``spec`` (an `aot.SpanLaunchSpec`) on ``device`` (``None``: the
        card, raising without one): the shard's
        program resident there and the launch resolved, so a tick's launch
        checks only its words and launch slots.  A backend that declares
        ``supports_aot=False`` raises `BackendCapabilityError`."""
        if not self.capabilities().supports_aot:
            raise BackendCapabilityError(
                f"backend {self.name!r} declares supports_aot=False: it makes "
                "no span-launch units; its launches run eagerly"
            )
        return aot.compile_span_launch(self, spec, shard, device=device)

    def instrument(self, hook) -> "EvalBackend":
        """Wrap this backend so every ``eval_*`` launch runs inside a
        caller-supplied context: ``hook(kind, **meta)`` returns a context
        manager (a `TraceRecorder.span` fits directly).  The proxy keeps
        ``name``, ``capabilities`` and ``span_alignment``."""
        return _InstrumentedBackend(self, hook)

    def span_alignment(self, requested: int | None = None) -> int:
        """Resolve a requested word-span alignment: ``None`` means the
        backend's own ``word_alignment``; an explicit int is honoured."""
        if requested is None:
            return max(int(self.capabilities().word_alignment), 1)
        return max(int(requested), 1)

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class _InstrumentedBackend(EvalBackend):
    """Delegating proxy reporting every launch through a hook context.

    The hook runs on the dispatching thread around the launch call; with
    asynchronous CUDA launches it measures the enqueue, and the wait shows
    up wherever the caller reads the result back."""

    def __init__(self, inner: EvalBackend, hook):
        self._inner = inner
        self._hook = hook
        self.name = inner.name

    def capabilities(self) -> BackendCapabilities:
        return self._inner.capabilities()

    def span_alignment(self, requested: int | None = None) -> int:
        return self._inner.span_alignment(requested)

    def compile_spans(self, spec, shard, *, device=None):
        # compiling is control-plane work, not a launch: uninstrumented;
        # the tick wraps each call of the unit in its own span
        return self._inner.compile_spans(spec, shard, device=device)

    # program entry points report under the kernel they reach
    def eval_program(self, program, x_words):
        with self._hook("eval_population", population=program.pop,
                        words=int(x_words.shape[-1])):
            return self._inner.eval_program(program, x_words)

    def eval_program_spans(self, program, x_words, slots, word_off, in_width,
                           live, *, span_words: int):
        with self._hook("eval_population_spans",
                        population=int(slots.shape[0]),
                        span_words=int(span_words)):
            return self._inner.eval_program_spans(
                program, x_words, slots, word_off, in_width, live,
                span_words=span_words,
            )

    def eval_population(self, opcodes, edge_src, out_src, x_words):
        with self._hook("eval_population", population=int(opcodes.shape[0]),
                        words=int(x_words.shape[-1])):
            return self._inner.eval_population(
                opcodes, edge_src, out_src, x_words
            )

    def eval_population_spans(self, opcodes, edge_src, out_src, x_words,
                              word_off, in_width, *, span_words: int):
        with self._hook("eval_population_spans",
                        population=int(opcodes.shape[0]),
                        span_words=int(span_words)):
            return self._inner.eval_population_spans(
                opcodes, edge_src, out_src, x_words, word_off, in_width,
                span_words=span_words,
            )

    def eval_circuit(self, opcodes, edge_src, out_src, x_words):
        with self._hook("eval_circuit", words=int(x_words.shape[-1])):
            return self._inner.eval_circuit(
                opcodes, edge_src, out_src, x_words
            )

    def __repr__(self) -> str:
        return f"<_InstrumentedBackend over {self._inner!r}>"
