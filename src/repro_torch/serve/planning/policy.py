"""PlacementPolicy: the declarative half of launch planning.

A policy says *where* tenant circuits should land — how many plan shards
the catalog is split over, how slots are assigned to shards, and what
word-span alignment launches must honour — without saying anything about
*which* circuits exist (the catalog) or *how* they are evaluated (the
backend).  `PlanCompiler` combines all three into immutable `LaunchPlan`
shards; new placement scenarios are new policies, not server rewrites.
"""
from __future__ import annotations

import dataclasses

ASSIGNMENTS = ("round_robin", "contiguous", "balanced")


@dataclasses.dataclass(frozen=True)
class PlacementPolicy:
    """Declarative placement of a circuit catalog onto fused launches.

    ``n_shards`` — how many independent `LaunchPlan` shards the slot
    population is split over.  Each shard is one fused
    ``eval_population_spans`` launch per tick; on CUDA, shard *s* is
    dispatched on ``cuda:{s % torch.cuda.device_count()}``, so with several
    cards shards run in parallel (on one card every shard goes to
    ``cuda:0``).  The compiler never builds more shards than slots.

    ``span_align`` — word-span granularity of every launch built from the
    plan: per-tenant spans are padded up to a multiple of this.  ``None``
    derives it from the backend (``capabilities().word_alignment``, 1 for
    both of the port's backends); an explicit int is used as requested.

    ``assignment`` — how slots map to shards on a *full* compile:

      * ``"round_robin"`` — slot *i* → shard ``i % n_shards`` (default;
        deterministic, spreads ensemble members across shards);
      * ``"contiguous"`` — catalog order split into ``n_shards`` runs
        (keeps a tenant's ensemble members on as few shards as possible);
      * ``"balanced"`` — longest-processing-time greedy on per-slot gate
        cost, so one giant circuit cannot make its shard the straggler.

    The strategy shapes the initial layout only: once a plan exists,
    registry mutations recompile *incrementally*
    (`PlanCompiler.recompile`) — surviving slots stay put and new slots
    go to the lightest shard, deliberately trading strict adherence to
    the strategy for launch-cache reuse (an unchanged shard keeps its
    content hash and device upload).  Compile from a fresh
    `PlanCompiler` to re-impose the strategy wholesale.
    """

    n_shards: int = 1
    span_align: int | None = 1
    assignment: str = "round_robin"

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.span_align is not None and self.span_align < 1:
            raise ValueError(
                f"span_align must be None or >= 1, got {self.span_align}"
            )
        if self.assignment not in ASSIGNMENTS:
            raise ValueError(
                f"assignment must be one of {ASSIGNMENTS}, "
                f"got {self.assignment!r}"
            )


DEFAULT_POLICY = PlacementPolicy()
