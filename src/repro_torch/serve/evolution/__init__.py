"""Online evolution: drift-aware background refit with shadow evaluation
and canary promotion (PyTorch port of the reference package's loop; the
refit's 1+λ search launches `eval_program` on the card while the
serving ticks launch the spans kernel).

The serving stack freezes circuits at deploy time; this package closes
the loop so they keep up with moving traffic, without ever blocking the
serving thread:

  * `drift` — per-tenant `DriftDetector`s: streaming per-bit activation
    frequencies of encoded request batches vs the fit-time reference
    snapshot (windowed divergence + Page-Hinkley), plus a label-feedback
    accuracy EWMA fed by `AsyncCircuitServer.submit_feedback`;
  * `refit` — `RefitWorker`: on a drift trip, re-evolves the tenant's
    circuit on a `ReplayBuffer` of recent labeled traffic, seeded from
    the live genome (`evolve_packed(seed_genome=...)`), in a child
    process of its own driven from a background thread, rate-limited and
    cancellable;
  * `promote` — the candidate rides the fused launch as a hidden shadow
    slot (`CircuitServer.set_shadow`), scored on live traffic by the
    `ShadowScorer`; a `PromotionPolicy` drives promotion through the
    generation-fenced plan swap, with a `PromotionRecord` audit trail
    and auto-rollback on canary regression;
  * `manager` — `EvolutionManager`, the facade wiring all of it to one
    `AsyncCircuitServer`.
"""
from repro_torch.serve.evolution.drift import (
    DriftConfig,
    DriftDetector,
    DriftVerdict,
    bit_activation_stats,
)
from repro_torch.serve.evolution.manager import EvolutionManager
from repro_torch.serve.evolution.promote import (
    PromotionPolicy,
    PromotionRecord,
    Promoter,
    ShadowScorer,
    ShadowStats,
)
from repro_torch.serve.evolution.refit import (
    RefitConfig,
    RefitResult,
    RefitWorker,
    ReplayBuffer,
    refit_circuit,
)

__all__ = [
    "DriftConfig",
    "DriftDetector",
    "DriftVerdict",
    "EvolutionManager",
    "PromotionPolicy",
    "PromotionRecord",
    "Promoter",
    "RefitConfig",
    "RefitResult",
    "RefitWorker",
    "ReplayBuffer",
    "ShadowScorer",
    "ShadowStats",
    "bit_activation_stats",
    "refit_circuit",
]
