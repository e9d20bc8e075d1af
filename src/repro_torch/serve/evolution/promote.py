"""Shadow evaluation and canary promotion of refit candidates (PyTorch
port).

A refit candidate never replaces the live circuit on faith.  It first
joins the tenant's fused launch as a **hidden shadow slot** — installed
as a trailing ensemble member through the ordinary registry/planning
plumbing, so it costs one more slot in a launch that was happening
anyway — while `CircuitServer.set_shadow` keeps it out of the served
vote and routes its per-row predictions to the `ShadowScorer` instead.
The scorer accumulates two views of candidate quality:

  * **agreement** with the served output on all live traffic (free,
    unlabeled, from inside the launch);
  * **labeled accuracy**, candidate vs live, on the rows for which
    `submit_feedback` later delivered ground truth.

A `PromotionPolicy` turns those stats into a verdict: *promote* once the
shadow window is long enough and the candidate's labeled accuracy beats
the live circuit's by the configured margin; *reject* once the window is
exhausted without clearing the bar.  `Promoter` executes verdicts
through `PlanCompiler.recompile` + the generation-fenced
`CircuitServer.swap_plan` — the same zero-loss cutover autoscaling and
migration use — and writes an append-only `PromotionRecord` audit trail
(also stamped into the promoted circuit's v2 bundle lineage).  After a
promotion the canary is still on probation: a labeled-accuracy
regression within the rollback window triggers `rollback`, which
reinstalls the retained parent through the same fenced swap.

Departure from the reference: the scorer re-predicts labeled blocks on
the serving stack's device (`Promoter` hands it ``server.device``), where
the reference predicts through its plain backend.  A port `predict` with
no device means the card, so a CPU-served stack scores on the CPU and a
card-served one launches `eval_program` on the card.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.api import ServableCircuit
from repro_torch.serve.circuits.registry import CircuitRegistry
from repro_torch.serve.circuits.server import CircuitServer, StalePlanError
from repro_torch.serve.observability.trace import NULL_TRACER, TraceRecorder
from repro_torch.serve.planning import circuit_digest

_SWAP_RETRIES = 8


@dataclasses.dataclass
class ShadowStats:
    """Accumulated evidence about one tenant's shadow candidate."""

    rows: int = 0            # live rows the shadow scored (fused launch)
    agree_rows: int = 0      # ... on which it agreed with served output
    labeled_rows: int = 0    # rows with ground-truth feedback
    shadow_correct: int = 0
    live_correct: int = 0

    @property
    def agreement(self) -> float:
        return self.agree_rows / self.rows if self.rows else 0.0

    @property
    def shadow_accuracy(self) -> "float | None":
        return (self.shadow_correct / self.labeled_rows
                if self.labeled_rows else None)

    @property
    def live_accuracy(self) -> "float | None":
        return (self.live_correct / self.labeled_rows
                if self.labeled_rows else None)

    @property
    def accuracy_delta(self) -> "float | None":
        if not self.labeled_rows:
            return None
        return (self.shadow_correct - self.live_correct) / self.labeled_rows

    def as_dict(self) -> dict:
        return {
            "rows": self.rows,
            "agreement": round(self.agreement, 4),
            "labeled_rows": self.labeled_rows,
            "shadow_accuracy": self.shadow_accuracy,
            "live_accuracy": self.live_accuracy,
            "accuracy_delta": self.accuracy_delta,
        }


class ShadowScorer:
    """Collects shadow evidence; registered as the server's
    ``shadow_hook`` (launch-side, serving thread — so the hot-path hook
    does nothing but integer accumulation under a short lock).  Labeled
    blocks are re-predicted on ``device`` (``None``: the card)."""

    def __init__(self, device: "str | torch.device | None" = None):
        self.device = device
        self._lock = threading.Lock()
        self._stats: dict[str, ShadowStats] = {}
        self._candidates: dict[str, ServableCircuit] = {}

    def track(self, tenant: str, candidate: ServableCircuit) -> None:
        with self._lock:
            self._stats[tenant] = ShadowStats()
            self._candidates[tenant] = candidate

    def drop(self, tenant: str) -> "ShadowStats | None":
        with self._lock:
            self._candidates.pop(tenant, None)
            return self._stats.pop(tenant, None)

    def candidate(self, tenant: str) -> "ServableCircuit | None":
        with self._lock:
            return self._candidates.get(tenant)

    def stats(self, tenant: str) -> "ShadowStats | None":
        with self._lock:
            return self._stats.get(tenant)

    def tracked(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(self._stats)

    # -- launch-side hook ---------------------------------------------
    def __call__(self, tenant: str, shadow_ids, served_ids) -> None:
        """`CircuitServer.shadow_hook` signature: the shadow members'
        decoded ids and the served (voted) ids for one tick's rows."""
        ids = np.asarray(shadow_ids[0])
        served = np.asarray(served_ids)
        with self._lock:
            st = self._stats.get(tenant)
            if st is None:
                return
            st.rows += int(ids.shape[0])
            st.agree_rows += int((ids == served).sum())

    # -- feedback-side scoring ----------------------------------------
    def observe_labels(
        self, tenant: str, x: np.ndarray, y: np.ndarray,
        live_pred: np.ndarray,
    ) -> None:
        """Score one labeled feedback block: the live circuit's served
        predictions are already known; the candidate re-predicts the
        rows (tiny circuit, off the serving thread)."""
        with self._lock:
            cand = self._candidates.get(tenant)
            st = self._stats.get(tenant)
        if cand is None or st is None or len(y) == 0:
            return
        shadow_pred = cand.predict(np.asarray(x, np.float32),
                                   device=self.device)
        y = np.asarray(y).reshape(-1)
        sc = int((shadow_pred == y).sum())
        lc = int((np.asarray(live_pred).reshape(-1) == y).sum())
        with self._lock:
            # tenant may have been dropped while predicting
            st2 = self._stats.get(tenant)
            if st2 is st:
                st.labeled_rows += int(y.shape[0])
                st.shadow_correct += sc
                st.live_correct += lc


@dataclasses.dataclass(frozen=True)
class PromotionPolicy:
    """When is a shadow candidate good enough — and when has a promoted
    canary regressed enough to roll back.

    ``min_shadow_rows`` live rows and ``min_labeled_rows`` labeled rows
    must accumulate before any promote verdict; the candidate's labeled
    accuracy must beat the live circuit's by ``min_accuracy_delta``.
    ``max_shadow_rows`` bounds the experiment: a candidate that hasn't
    cleared the bar by then is rejected (the slot is not free forever).
    After promotion, a labeled-accuracy drop of ``rollback_margin``
    below the pre-promotion live accuracy, measured over at least
    ``min_labeled_rows`` post-promotion rows within
    ``rollback_window_rows``, triggers auto-rollback."""

    min_shadow_rows: int = 256
    min_labeled_rows: int = 64
    min_accuracy_delta: float = 0.0
    max_shadow_rows: int = 100_000
    rollback_margin: float = 0.05
    rollback_window_rows: int = 2048

    def decide(self, stats: ShadowStats) -> str:
        """'promote' | 'reject' | 'wait'."""
        if (stats.rows >= self.min_shadow_rows
                and stats.labeled_rows >= self.min_labeled_rows
                and stats.accuracy_delta is not None
                and stats.accuracy_delta >= self.min_accuracy_delta):
            return "promote"
        if stats.rows >= self.max_shadow_rows:
            return "reject"
        return "wait"


@dataclasses.dataclass(frozen=True)
class PromotionRecord:
    """One audit-trail entry: what was decided about a candidate and on
    what evidence.  ``verdict`` ∈ {promoted, rejected, rolled_back}."""

    tenant: str
    verdict: str
    parent_hash: str
    candidate_hash: str
    shadow: dict           # ShadowStats.as_dict() at decision time
    generation: int        # registry generation after the action
    swap_ms: float
    at: float              # manager clock


class Promoter:
    """Executes shadow installs, promotions, rejections and rollbacks
    against one serving stack, through the generation-fenced swap."""

    def __init__(
        self,
        server: CircuitServer,
        *,
        policy: PromotionPolicy = PromotionPolicy(),
        clock: Callable[[], float] = time.monotonic,
        tracer: "TraceRecorder | None" = None,
    ):
        self.server = server
        self.registry: CircuitRegistry = server.registry
        self.policy = policy
        self.clock = clock
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.scorer = ShadowScorer(server.device)
        server.shadow_hook = self.scorer
        self.records: list[PromotionRecord] = []
        # parent ensembles retained while their candidate shadows/canaries
        self._parents: dict[str, tuple[ServableCircuit, ...]] = {}

    # -- the fenced swap ----------------------------------------------
    def _swap(self, action: str, reason: str) -> float:
        """Recompile the current catalog and install it, retrying when a
        concurrent registry mutation outruns the compile.  Returns the
        swap's wall-clock ms."""
        for _ in range(_SWAP_RETRIES):
            compiled = self.server.compiler.recompile(
                self.registry.catalog(), self.server.peek_plan()
            )
            try:
                event = self.server.swap_plan(
                    compiled, action=action, reason=reason
                )
                return event.swap_ms
            except StalePlanError:
                continue
        raise StalePlanError(
            f"registry outran {_SWAP_RETRIES} recompile attempts "
            f"during {action!r}"
        )

    # -- shadow lifecycle ---------------------------------------------
    def install_shadow(self, tenant: str, candidate: ServableCircuit) -> None:
        """Add the candidate as a hidden trailing ensemble member.  The
        vote exclusion is armed *before* the registry mutation — keyed
        on the post-mutation member count, so ticks on the old plan are
        untouched (see `CircuitServer.set_shadow`)."""
        parents = self.registry.members(tenant)
        if tenant in self._parents:
            raise ValueError(f"tenant {tenant!r} already has a shadow")
        self._parents[tenant] = parents
        self.scorer.track(tenant, candidate)
        self.server.set_shadow(tenant, len(parents) + 1, 1)
        try:
            self.registry.add_ensemble(
                tenant, parents + (candidate,), replace=True
            )
            self._swap("shadow", f"shadow candidate for {tenant!r}")
        except Exception:
            self.server.clear_shadow(tenant)
            self.scorer.drop(tenant)
            del self._parents[tenant]
            raise
        self.tracer.instant(
            "evolution.shadow", cat="evolution", track="evolution",
            tenant=tenant,
            candidate_hash=circuit_digest(candidate)[:12],
        )

    def shadowing(self, tenant: str) -> bool:
        return tenant in self._parents and self.scorer.candidate(
            tenant) is not None

    def evaluate(self, tenant: str) -> "PromotionRecord | None":
        """Apply the policy to the tenant's shadow evidence; executes
        the verdict when it is promote/reject.  Returns the audit record
        (None while the verdict is 'wait')."""
        stats = self.scorer.stats(tenant)
        if stats is None:
            return None
        verdict = self.policy.decide(stats)
        if verdict == "promote":
            return self.promote(tenant)
        if verdict == "reject":
            return self.reject(tenant)
        return None

    def _record(self, tenant: str, verdict: str, parent_hash: str,
                candidate_hash: str, shadow: dict,
                swap_ms: float) -> PromotionRecord:
        rec = PromotionRecord(
            tenant=tenant, verdict=verdict, parent_hash=parent_hash,
            candidate_hash=candidate_hash, shadow=shadow,
            generation=self.registry.generation, swap_ms=swap_ms,
            at=self.clock(),
        )
        self.records.append(rec)
        self.tracer.instant(
            f"evolution.{verdict}", cat="evolution", track="evolution",
            tenant=tenant, parent_hash=parent_hash[:12],
            candidate_hash=candidate_hash[:12],
            shadow_rows=shadow.get("rows", 0),
            labeled_rows=shadow.get("labeled_rows", 0),
            accuracy_delta=shadow.get("accuracy_delta"),
            swap_ms=round(swap_ms, 3),
        )
        return rec

    def promote(self, tenant: str) -> PromotionRecord:
        """Candidate becomes the tenant's served circuit; the parent is
        retained for rollback.  The shadow exclusion is cleared *after*
        the swap, so no tick ever votes the candidate twice."""
        candidate = self.scorer.candidate(tenant)
        if candidate is None:
            raise KeyError(f"tenant {tenant!r} has no shadow candidate")
        parents = self._parents[tenant]
        stats = self.scorer.stats(tenant)
        shadow = stats.as_dict() if stats else {}
        parent_hash = circuit_digest(parents[0])
        promoted = dataclasses.replace(
            candidate,
            lineage={
                **(candidate.lineage or {}),
                "parent_hash": parent_hash,
                "shadow": shadow,
                "verdict": "promoted",
            },
        )
        self.registry.add_ensemble(tenant, (promoted,), replace=True)
        swap_ms = self._swap("promote", f"canary promotion for {tenant!r}")
        self.server.clear_shadow(tenant)
        self.scorer.drop(tenant)
        self._parents[tenant] = parents  # retained for rollback
        return self._record(
            tenant, "promoted", parent_hash, circuit_digest(promoted),
            shadow, swap_ms,
        )

    def reject(self, tenant: str) -> PromotionRecord:
        """Drop the shadow member and restore the parent-only ensemble."""
        candidate = self.scorer.candidate(tenant)
        if candidate is None:
            raise KeyError(f"tenant {tenant!r} has no shadow candidate")
        parents = self._parents.pop(tenant)
        stats = self.scorer.drop(tenant)
        self.registry.add_ensemble(tenant, parents, replace=True)
        swap_ms = self._swap("unshadow", f"candidate rejected for {tenant!r}")
        self.server.clear_shadow(tenant)
        return self._record(
            tenant, "rejected", circuit_digest(parents[0]),
            circuit_digest(candidate),
            stats.as_dict() if stats else {}, swap_ms,
        )

    def rollback(self, tenant: str, reason: str = "regression",
                 shadow: "dict | None" = None) -> PromotionRecord:
        """Reinstall the retained parent over a regressed canary."""
        parents = self._parents.pop(tenant, None)
        if parents is None:
            raise KeyError(f"tenant {tenant!r} has no retained parent")
        canary = self.registry.members(tenant)[0]
        self.registry.add_ensemble(tenant, parents, replace=True)
        swap_ms = self._swap("rollback", f"{reason} for {tenant!r}")
        self.server.clear_shadow(tenant)
        return self._record(
            tenant, "rolled_back", circuit_digest(parents[0]),
            circuit_digest(canary), shadow or {}, swap_ms,
        )

    def forget_parent(self, tenant: str) -> None:
        """Release the rollback retention (canary survived probation)."""
        self._parents.pop(tenant, None)
