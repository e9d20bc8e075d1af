"""Launch planning: catalog → compiler → immutable plan shards.

A declarative `PlacementPolicy` (shard count, span alignment, slot
assignment), the `PlanCompiler` that combines a `Catalog` snapshot with a
policy and a backend's capabilities, and the compiled artifacts —
`LaunchPlan` shards carrying stacked genome arrays and a content hash,
tied together by a `CompiledPlan` with the tenant → (shard, slot) map.
"""
from repro_torch.serve.planning.compiler import PlanCompiler
from repro_torch.serve.planning.plan import (
    Catalog,
    CompiledPlan,
    LaunchPlan,
    SlotRef,
    circuit_digest,
    ensemble_vote,
    pad_genome,
)
from repro_torch.serve.planning.policy import DEFAULT_POLICY, PlacementPolicy

__all__ = [
    "Catalog",
    "CompiledPlan",
    "DEFAULT_POLICY",
    "LaunchPlan",
    "PlacementPolicy",
    "PlanCompiler",
    "SlotRef",
    "circuit_digest",
    "ensemble_vote",
    "pad_genome",
]
