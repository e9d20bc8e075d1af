"""The 1+λ evolutionary loop with neutral drift (paper §3), PyTorch port.

Selection uses ``>=`` (a child with *equal* training fitness replaces the
parent): the neutral-drift random walk over equivalent solutions.  Training
fitness selects the next parent; validation fitness picks the
best-discovered solution; the search stops when validation fitness has not
improved by ≥ γ within κ generations, or after G generations (§3.3–3.4).

The loop runs on the host.  The packed data and both masks stay resident
on the device they were packed to.  Each generation:

  1. mutate λ children on the host (`core/mutate.py`, a CPU generator);
  2. compile them to live-gate programs (`kernels/program.py`) and copy
     the programs to the device;
  3. one ``eval_program`` launch of the backend over all W words;
  4. reduce to ``correct[2, λ, C]`` (train, val) on the device with
     `fitness.confusion_counts`, read them back, compute both
     fitnesses in float32 on the host (`fitness.balanced_accuracy_from_counts`)
     and select on the host.

A step is its draws (`draw_step`: the children, then the tie-break
uniforms) followed by the pure `advance`, which does replacement, best
tracking and the γ/κ bookkeeping, so a caller can feed it any draws.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.core import fitness as F
from repro_torch.core.encoding import PackedDataset
from repro_torch.core.genome import CircuitSpec, Genome, init_genome, opcodes
from repro_torch.core.mutate import mutate_children
from repro_torch.kernels.program import compile_program
from repro_torch.serve.observability.trace import NOOP_SPAN, NULL_TRACER, active

# The phases of one generation that `PhaseClock` books, in loop order.
FIT_PHASES = ("mutate", "compile", "program_h2d", "launch", "fitness_reduce",
              "readback", "host_select")


@dataclasses.dataclass(frozen=True)
class EvolveConfig:
    lam: int = 4
    p: float | None = None   # mutation rate; None → 1/n (paper §3.5)
    gamma: float = 0.01
    kappa: int = 300
    max_gens: int = 8000

    def rate(self, spec: CircuitSpec) -> float:
        return self.p if self.p is not None else 1.0 / spec.n_nodes


class EvolveState(NamedTuple):
    parent: Genome
    parent_fit: np.float32   # training fitness of the parent
    best: Genome             # best-discovered solution (by validation fitness)
    best_val: np.float32
    best_train: np.float32   # training fitness of `best` (reporting)
    ref_val: np.float32      # γ-improvement reference (§3.4)
    since: np.int32          # generations since the last ≥γ val improvement
    gen: np.int32            # generation counter


_SPAN_NAMES = {p: f"search.{p}" for p in FIT_PHASES}
# Spans read the process CPU clock on one generation in this many (and on
# each search's first parent).  On the card's host a read beside torch's
# spinning intra-op pool costs 70-100 µs and the clock steps in 10 ms
# ticks: read on every lap, it slowed the search by a sixth (PERF.md §6).
CPU_SAMPLE_EVERY = 16


class PhaseClock:
    """Host seconds per phase of the search (`FIT_PHASES`), summed over
    generations.  `lap(phase)` books the time since the previous lap (or
    `start`) to ``phase``.  Device work is asynchronous, so ``launch`` and
    ``fitness_reduce`` are the host's enqueue time and ``readback``
    includes the wait for the device.

    The clock reads the clock of the recorder that was `active` when it
    was made (``time.perf_counter`` unless a test injects another).  While
    that recorder is enabled, each lap is also a span ``search.<phase>``
    from the same two reads, with ``gen`` (the generation it belongs to,
    0 for a search's first parent) and ``search`` (`init_state` calls so
    far); `init_span` and `generation_span` give the spans that enclose
    them.  On a search's first parent and on every `CPU_SAMPLE_EVERY`-th
    generation each of these spans also carries ``cpu_ns``, the process's
    CPU time over it (`time.process_time_ns`: every thread, torch's
    intra-op pool too).  Off, a lap adds one branch on the recorder's
    ``enabled``."""

    def __init__(self):
        self.tracer = active()
        self._now = self.tracer.clock
        self.seconds = dict.fromkeys(FIT_PHASES, 0.0)
        self.laps = dict.fromkeys(FIT_PHASES, 0)
        self.searches = 0
        self._gen = 0
        self._cpu_on = False
        self._t = self._t0 = self._now()
        self._cpu = self._cpu0 = 0

    def start(self) -> None:
        self._t = self._t0 = self._now()
        if self._cpu_on:
            self._cpu = self._cpu0 = time.process_time_ns()

    def lap(self, phase: str) -> None:
        t = self._now()
        self.seconds[phase] += t - self._t
        self.laps[phase] += 1
        if self.tracer.enabled:
            if self._cpu_on:
                cpu = time.process_time_ns()
                self.tracer.complete(_SPAN_NAMES[phase], self._t, t, cat="search",
                                     gen=self._gen, search=self.searches,
                                     cpu_ns=cpu - self._cpu)
                self._cpu = cpu
            else:
                self.tracer.complete(_SPAN_NAMES[phase], self._t, t, cat="search",
                                     gen=self._gen, search=self.searches)
        self._t = t

    def init_span(self):
        """``with clock.init_span():`` around the evaluation of a search's
        first parent: counts the search and records ``search.init`` (see
        `generation_span`) at ``gen`` 0."""
        self.searches += 1
        if not self.tracer.enabled:
            return NOOP_SPAN
        return _GenerationSpan(self, "search.init", 0)

    def generation_span(self, state_gen):
        """``with clock.generation_span(state.gen):`` around one
        generation: on exit it records ``search.generation`` from the
        block's `start` to its last lap, with ``gen`` (``state_gen + 1``,
        the count the generation reaches), ``search`` and, on a sampled
        generation, ``cpu_ns``; the laps inside carry the same ``gen``.
        Without an enabled recorder it is one shared no-op."""
        if not self.tracer.enabled:
            return NOOP_SPAN
        return _GenerationSpan(self, "search.generation", int(state_gen) + 1)

    def mean_ms(self) -> dict[str, float]:
        """Mean milliseconds per lap of each phase."""
        return {k: 1e3 * s / max(self.laps[k], 1) for k, s in self.seconds.items()}

    def __getstate__(self) -> dict:
        # a clock is pickled (in a fitted classifier's records) as its sums;
        # its recorder stays in the process that recorded
        state = dict(self.__dict__)
        del state["tracer"], state["_now"]
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state, tracer=NULL_TRACER, _now=NULL_TRACER.clock)


class _GenerationSpan:
    __slots__ = ("clock", "name", "gen")

    def __init__(self, clock: PhaseClock, name: str, gen: int):
        self.clock, self.name, self.gen = clock, name, gen

    def __enter__(self) -> "_GenerationSpan":
        self.clock._gen = self.gen
        self.clock._cpu_on = self.gen % CPU_SAMPLE_EVERY == 0
        return self

    def __exit__(self, *exc) -> bool:
        c = self.clock
        args = {"gen": self.gen, "search": c.searches}
        if c._cpu_on:
            args["cpu_ns"] = c._cpu - c._cpu0
        c._cpu_on = False
        c.tracer.complete(self.name, c._t0, c._t, cat="search", **args)
        return False


class make_eval_fn:  # named as the reference's factory, which it replaces
    """The batched fitness function of one packed dataset: a single forward
    pass over *all* packed rows; train and val fitness are two masked
    confusion reductions over the same circuit outputs.

    A call compiles the genomes, makes one ``eval_program`` launch, reduces
    its outputs under both masks to ``correct[2, λ, C]`` on the data's
    device (`fitness.confusion_counts`, with the per-class row counts of
    both masks counted once here by `fitness.class_counts`), reads them
    back and computes both fitnesses on the host.  ``backend=None`` is the
    backend of the data's device (the kernels on the card, the plain
    versions on the CPU); naming one here is the only way to run the plain
    versions on the card.  ``clock`` books the search's phases; the loop
    laps it too.

    ``reduce_counts`` sums host count tensors across the shards of a
    sharded dataset (the island program's data ``all_reduce``, in
    `core/islands.py`): it is applied to the class counts once here and to
    ``correct`` after every readback, before the host fitness.  Counts are
    linear in the words, so the sharded fitness is exactly the unsharded
    one.  The default leaves the counts as they are."""

    def __init__(self, spec: CircuitSpec, data: PackedDataset,
                 mask_train: torch.Tensor, mask_val: torch.Tensor,
                 backend: "str | runtime.EvalBackend | None" = None,
                 reduce_counts: "Callable[[torch.Tensor], torch.Tensor] | None" = None):
        self.spec, self.data = spec, data
        self.backend = (runtime.backend_for(data.device) if backend is None
                        else runtime.resolve_backend(backend))
        self.clock = PhaseClock()
        self._reduce = reduce_counts or (lambda counts: counts)
        self._masks = torch.stack([mask_train, mask_val])[:, None]  # (2, 1, W)
        self._count = F.class_counts(data, self._masks)              # (2, 1, C)
        self._count_host = self._reduce(self._count.cpu().clone()).numpy()

    def __call__(self, genomes: Genome, *, in_loop: bool = True
                 ) -> tuple[np.ndarray, np.ndarray]:
        clock, data = self.clock, self.data
        program = compile_program(opcodes(genomes, self.spec), genomes.edge_src,
                                  genomes.out_src, self.spec.n_inputs)
        clock.lap("compile")
        program = program.to(data.device)
        clock.lap("program_h2d")
        out = self.backend.eval_program(program, data.x_words)  # (λ, O, W)
        clock.lap("launch")
        correct, _ = F.confusion_counts(out, data, self._masks, self._count)
        clock.lap("fitness_reduce")
        correct = self._reduce(correct.cpu()).numpy()           # (2, λ, C)
        clock.lap("readback")
        fit = F.balanced_accuracy_from_counts(correct, self._count_host,
                                              in_loop=in_loop)  # (2, λ)
        return fit[0], fit[1]


def _stack1(genome: Genome) -> Genome:
    return Genome(*(a[None] for a in genome))


def _pick(children: Genome, i: int) -> Genome:
    return Genome(*(a[i].clone() for a in children))


def _select(fits: np.ndarray, u: np.ndarray) -> int:
    """argmax with uniform tie-breaking (paper §3: ties at random): the
    first index of the largest ``u`` among the fittest."""
    return int(np.argmax(np.where(fits == fits.max(), u, np.float32(-1))))


def init_state(
    generator: torch.Generator,
    spec: CircuitSpec,
    eval_fn: "make_eval_fn",
    seed_genome: "Genome | None" = None,
) -> EvolveState:
    """Initial 1+λ state.  ``seed_genome`` (when given) becomes the first
    parent instead of a random genome drawn from ``generator``."""
    clock = eval_fn.clock
    parent = init_genome(generator, spec) if seed_genome is None else seed_genome
    with clock.init_span():
        clock.start()
        # the reference evaluates its first parent op by op, outside its loop
        ft, fv = eval_fn(_stack1(parent), in_loop=False)
        clock.lap("host_select")
    zero = np.int32(0)
    return EvolveState(
        parent=parent, parent_fit=ft[0], best=parent, best_val=fv[0],
        best_train=ft[0], ref_val=fv[0], since=zero, gen=zero,
    )


def draw_step(
    generator: torch.Generator, parent: Genome, spec: CircuitSpec, cfg: EvolveConfig
) -> tuple[Genome, np.ndarray]:
    """One generation's draws: λ children, then λ tie-break uniforms."""
    children = mutate_children(generator, parent, spec, cfg.rate(spec), cfg.lam)
    u = torch.rand(cfg.lam, generator=generator).numpy()
    return children, u


def advance(
    state: EvolveState, children: Genome, ft: np.ndarray, fv: np.ndarray,
    u: np.ndarray, cfg: EvolveConfig,
) -> EvolveState:
    """The pure part of a generation: parent replacement, best tracking and
    the γ/κ bookkeeping, given the children, their float32 fitnesses and
    the tie-break uniforms."""
    # --- parent replacement: any child with f_i >= f_S; highest wins ---
    sel = _select(ft, u)
    accept = ft[sel] >= state.parent_fit
    parent = _pick(children, sel) if accept else state.parent
    parent_fit = ft[sel] if accept else state.parent_fit

    # --- best-discovered solution by validation fitness ---
    bidx = int(np.argmax(fv))
    improved = fv[bidx] > state.best_val
    best = _pick(children, bidx) if improved else state.best
    best_val = np.maximum(state.best_val, fv[bidx])
    best_train = ft[bidx] if improved else state.best_train

    # --- γ/κ termination bookkeeping ---
    big_improve = best_val >= np.float32(state.ref_val + np.float32(cfg.gamma))
    ref_val = best_val if big_improve else state.ref_val
    since = np.int32(0) if big_improve else np.int32(state.since + 1)

    return EvolveState(
        parent=parent, parent_fit=parent_fit, best=best, best_val=best_val,
        best_train=best_train, ref_val=ref_val, since=since,
        gen=np.int32(state.gen + 1),
    )


def generation_step(
    state: EvolveState, generator: torch.Generator, spec: CircuitSpec,
    cfg: EvolveConfig, eval_fn: "make_eval_fn",
) -> EvolveState:
    clock = eval_fn.clock
    with clock.generation_span(state.gen):
        clock.start()
        children, u = draw_step(generator, state.parent, spec, cfg)
        clock.lap("mutate")
        ft, fv = eval_fn(children)  # (λ,), (λ,)
        state = advance(state, children, ft, fv, u, cfg)
        clock.lap("host_select")
    return state


def not_terminated(state: EvolveState, cfg: EvolveConfig) -> bool:
    return bool(state.gen < cfg.max_gens) and bool(state.since < cfg.kappa)


def evolve(
    generator: torch.Generator, spec: CircuitSpec, cfg: EvolveConfig,
    eval_fn: "make_eval_fn", seed_genome: "Genome | None" = None,
) -> EvolveState:
    """Run to termination."""
    state = init_state(generator, spec, eval_fn, seed_genome=seed_genome)
    while not_terminated(state, cfg):
        state = generation_step(state, generator, spec, cfg, eval_fn)
    return state


def evolve_with_history(
    generator: torch.Generator, spec: CircuitSpec, cfg: EvolveConfig,
    eval_fn: "make_eval_fn",
):
    """Fixed-length variant recording per-generation curves: returns the
    final state and ``(parent_fit f32[G], best_val f32[G], live bool[G])``
    for G = ``cfg.max_gens``.  Terminated states pass through unchanged
    (and no more generations are drawn or evaluated)."""
    state = init_state(generator, spec, eval_fn)
    g = cfg.max_gens
    parent_fit = np.empty(g, np.float32)
    best_val = np.empty(g, np.float32)
    live = np.zeros(g, bool)
    for i in range(g):
        live[i] = not_terminated(state, cfg)
        if live[i]:
            state = generation_step(state, generator, spec, cfg, eval_fn)
        parent_fit[i], best_val[i] = state.parent_fit, state.best_val
    return state, (parent_fit, best_val, live)


def evolve_packed(
    generator: torch.Generator,
    spec: CircuitSpec,
    cfg: EvolveConfig,
    data: PackedDataset,
    mask_train: torch.Tensor,
    mask_val: torch.Tensor,
    seed_genome: "Genome | None" = None,
) -> EvolveState:
    """Convenience: evolve directly on a PackedDataset (on its device).
    ``seed_genome`` warm-starts the search from an existing circuit."""
    eval_fn = make_eval_fn(spec, data, mask_train, mask_val)
    return evolve(generator, spec, cfg, eval_fn, seed_genome=seed_genome)
