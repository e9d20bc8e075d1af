"""EvolutionManager: the closed loop that keeps served circuits learning
(PyTorch port).

One manager watches one serving stack (an `AsyncCircuitServer` and the
`CircuitServer`/`CircuitRegistry` behind it) and runs the full online
evolution pipeline per watched tenant:

    serve → observe (per-bit drift + label feedback)
          → trigger (DriftDetector)
          → background refit seeded from the live genome (RefitWorker)
          → shadow the candidate inside the fused launch (Promoter)
          → promote / reject on live evidence (PromotionPolicy)
          → probation with auto-rollback.

Division of labor with the serving threads:

  * the front-end's completion hook (`observe`) and `submit_feedback`
    are the only entry points touched by serving/caller threads, and
    both do bounded O(1) work (deque/dict appends, one tiny re-predict
    for shadow scoring off the launch path);
  * everything that mutates serving state — encoding observations into
    the detectors, scheduling refits, installing shadows, executing
    verdicts, rollback probation — happens in `step()`, the control
    cadence the owner drives (a timer, a serving loop, a benchmark
    chunk boundary).  `step()` is safe to call from exactly one thread.

Every state transition lands on the shared `TraceRecorder` timeline as
an ``evolution.*`` instant and in `report()` for `prometheus_text`.

Departure from the reference: every update of ``counters`` happens under
the manager's lock.  The reference increments ``refits_completed`` on the
worker thread and ``feedback_rows`` on caller threads unlocked while
`step()` writes other keys; `report()` copies the counters under the
same lock.  The refit's device is ``refit.device`` (`RefitConfig`;
``None``: the card, so constructing a manager without one raises
`NoCudaDeviceError`).
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Callable

import numpy as np

from repro_torch.core import encoding as E
from repro_torch.serve.evolution.drift import DriftConfig, DriftDetector
from repro_torch.serve.evolution.promote import (
    PromotionPolicy,
    PromotionRecord,
    Promoter,
)
from repro_torch.serve.evolution.refit import (
    RefitConfig,
    RefitResult,
    RefitWorker,
    ReplayBuffer,
)
from repro_torch.serve.observability.trace import NULL_TRACER


class EvolutionManager:
    """Per-host online-evolution control loop (see module docstring)."""

    def __init__(
        self,
        frontend,
        *,
        drift: DriftConfig = DriftConfig(),
        refit: RefitConfig = RefitConfig(),
        policy: PromotionPolicy = PromotionPolicy(),
        replay_capacity: int = 4096,
        observation_capacity: int = 4096,
        prediction_cache: int = 8192,
        observe_every: int = 1,
        clock: "Callable[[], float] | None" = None,
        synchronous_refit: bool = False,
    ):
        if observe_every < 1:
            raise ValueError(
                f"observe_every must be >= 1, got {observe_every}"
            )
        self.frontend = frontend
        self.server = frontend.server
        self.registry = self.server.registry
        self.clock = clock if clock is not None else frontend.clock
        self.tracer = (self.server.tracer
                       if self.server.tracer is not None else NULL_TRACER)
        self.drift_cfg = drift
        self.refit_cfg = refit
        self.policy = policy
        self.replay_capacity = int(replay_capacity)
        self.promoter = Promoter(
            self.server, policy=policy, clock=self.clock, tracer=self.tracer
        )
        self.worker = RefitWorker(
            refit, clock=self.clock, tracer=self.tracer,
            synchronous=synchronous_refit,
        )
        # covariate-channel sampling: park every k-th request's features
        # for the detector (the encode in step() is the loop's dominant
        # steady-state cost); the label-feedback path still sees every
        # request — only drift telemetry is thinned
        self.observe_every = int(observe_every)
        self._obs_seen: dict[str, int] = {}
        self._lock = threading.Lock()
        self._detectors: dict[str, DriftDetector] = {}
        self._buffers: dict[str, ReplayBuffer] = {}
        # serving-thread → control-thread handoff buffers
        self._obs: deque = deque(maxlen=int(observation_capacity))
        self._pred: "OrderedDict[int, tuple]" = OrderedDict()
        self._pred_cap = int(prediction_cache)
        # finished refits parked until the next step() installs them
        self._candidates: deque[RefitResult] = deque()
        # promoted canaries on probation: tenant → rollback bookkeeping
        self._probation: dict[str, dict] = {}
        self.counters: dict[str, int] = {
            "observed_rows": 0,
            "feedback_rows": 0,
            "drift_triggers": 0,
            "refits_scheduled": 0,
            "refits_completed": 0,
            "shadows_installed": 0,
            "promotions": 0,
            "rejections": 0,
            "rollbacks": 0,
        }
        frontend.attach_evolution(self)

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] += n

    # -- tenant registration -------------------------------------------
    def watch(
        self,
        tenant: str,
        *,
        reference: "np.ndarray | None" = None,
        accuracy_baseline: "float | None" = None,
    ) -> DriftDetector:
        """Start drift-watching a registered tenant.  ``reference``
        defaults to the fit-time snapshot carried by the tenant's v2
        bundle (`ServableCircuit.ref_stats`); v1 artifacts must pass one
        explicitly."""
        live = self.registry.get(tenant)  # KeyError for unknown tenants
        if reference is None:
            reference = live.ref_stats
        if reference is None:
            raise ValueError(
                f"tenant {tenant!r}: no fit-time reference stats in the "
                f"bundle (format v1?) — pass reference= explicitly"
            )
        det = DriftDetector(
            reference, self.drift_cfg,
            accuracy_baseline=accuracy_baseline, clock=self.clock,
        )
        with self._lock:
            self._detectors[tenant] = det
            self._buffers[tenant] = ReplayBuffer(self.replay_capacity)
            self._obs_seen[tenant] = 0
        return det

    def unwatch(self, tenant: str) -> None:
        with self._lock:
            self._detectors.pop(tenant, None)
            self._buffers.pop(tenant, None)
            self._probation.pop(tenant, None)
            self._obs_seen.pop(tenant, None)
        self.worker.cancel(tenant)

    def watched(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(self._detectors)

    def detector(self, tenant: str) -> "DriftDetector | None":
        with self._lock:
            return self._detectors.get(tenant)

    # -- serving-thread entry points ------------------------------------
    def observe(self, tenant: str, request_id: int,
                x: np.ndarray, ids: np.ndarray) -> None:
        """Completion hook (called by the front-end per served request).
        Bounded O(1): park the observation for the next `step()`."""
        with self._lock:
            if tenant not in self._detectors:
                return
            seen = self._obs_seen.get(tenant, 0)
            self._obs_seen[tenant] = seen + 1
            if seen % self.observe_every == 0:
                self._obs.append((tenant, x))
            self._pred[request_id] = (tenant, x, ids)
            while len(self._pred) > self._pred_cap:
                self._pred.popitem(last=False)

    def submit_feedback(self, tenant: str, request_id: int, labels) -> int:
        """Join late ground truth back to a served request.  ``labels``
        is one label per served row (or a scalar broadcast across the
        request).  Returns the number of labeled rows accepted (0 when
        the request has aged out of the cache or isn't watched)."""
        with self._lock:
            entry = self._pred.pop(request_id, None)
            det = self._detectors.get(tenant)
            buf = self._buffers.get(tenant)
            prob = self._probation.get(tenant)
        if entry is None or det is None or buf is None:
            return 0
        ent_tenant, x, ids = entry
        if ent_tenant != tenant:
            return 0
        ids = np.asarray(ids).reshape(-1)
        y = np.asarray(labels, np.int64).reshape(-1)
        if y.shape[0] == 1 and ids.shape[0] > 1:
            y = np.repeat(y, ids.shape[0])
        if y.shape[0] != ids.shape[0]:
            raise ValueError(
                f"tenant {tenant!r}: request {request_id} served "
                f"{ids.shape[0]} rows, feedback has {y.shape[0]} labels"
            )
        correct = int((ids == y).sum())
        det.observe_accuracy(correct, int(y.shape[0]))
        buf.extend(x, y)
        self._count("feedback_rows", int(y.shape[0]))
        # score an active shadow on the same labeled rows (off the
        # launch path — the candidate re-predicts this tiny block)
        if self.promoter.shadowing(tenant):
            self.promoter.scorer.observe_labels(tenant, x, y, ids)
        if prob is not None:
            with self._lock:
                prob["labeled"] += int(y.shape[0])
                prob["correct"] += correct
        return int(y.shape[0])

    # -- refit delivery (worker thread) --------------------------------
    def _on_refit_done(self, result: RefitResult) -> None:
        with self._lock:
            self.counters["refits_completed"] += 1
            self._candidates.append(result)

    # -- the control cadence -------------------------------------------
    def step(self, now: "float | None" = None) -> dict:
        """One control iteration; returns a summary of what it did.
        Call from exactly one thread (a timer or the owner's loop)."""
        del now  # time enters through self.clock; kept for timer APIs
        summary = {"drift": [], "refits": [], "shadows": [],
                   "verdicts": [], "rollbacks": []}
        self._ingest_observations()
        self._trigger_refits(summary)
        self._install_candidates(summary)
        self._evaluate_shadows(summary)
        self._check_probation(summary)
        return summary

    def _ingest_observations(self) -> None:
        """Drain parked request observations into the detectors (the
        encode happens here, on the control thread)."""
        with self._lock:
            batch: list = []
            while self._obs:
                batch.append(self._obs.popleft())
        per_tenant: dict[str, list] = {}
        for tenant, x in batch:
            per_tenant.setdefault(tenant, []).append(x)
        for tenant, xs in per_tenant.items():
            det = self.detector(tenant)
            if det is None:
                continue
            try:
                enc = self.registry.get(tenant).encoder
            except KeyError:
                continue
            x = np.concatenate([np.atleast_2d(b) for b in xs])
            bits = E.encode(enc, np.asarray(x, np.float32))
            det.observe_bits(bits)
            self._count("observed_rows", int(x.shape[0]))

    def _trigger_refits(self, summary: dict) -> None:
        for tenant in self.watched():
            det = self.detector(tenant)
            if det is None or not det.drifted:
                continue
            trig = det.trigger
            if trig is not None and not getattr(det, "_announced", False):
                det._announced = True
                self._count("drift_triggers")
                summary["drift"].append((tenant, trig.reason))
                self.tracer.instant(
                    "evolution.drift", cat="evolution", track="evolution",
                    tenant=tenant, reason=trig.reason,
                    divergence=round(trig.divergence, 4),
                    accuracy=trig.accuracy,
                    rows_seen=trig.rows_seen,
                )
            with self._lock:
                parked = any(c.tenant == tenant for c in self._candidates)
            if (parked
                    or self.promoter.shadowing(tenant)
                    or tenant in self._probation
                    or self.worker.busy(tenant)):
                continue  # a candidate is already delivered or in flight
            with self._lock:
                buf = self._buffers.get(tenant)
            if buf is None:
                continue
            try:
                live = self.registry.get(tenant)
            except KeyError:
                continue
            if self.worker.request(tenant, live, buf, self._on_refit_done):
                self._count("refits_scheduled")
                summary["refits"].append(tenant)

    def _install_candidates(self, summary: dict) -> None:
        while True:
            with self._lock:
                if not self._candidates:
                    return
                result = self._candidates.popleft()
            tenant = result.tenant
            if (self.detector(tenant) is None
                    or self.promoter.shadowing(tenant)
                    or tenant not in self.registry):
                continue  # unwatched/removed while the search ran
            self.promoter.install_shadow(tenant, result.candidate)
            self._count("shadows_installed")
            summary["shadows"].append(tenant)

    def _evaluate_shadows(self, summary: dict) -> None:
        for tenant in self.promoter.scorer.tracked():
            rec = self.promoter.evaluate(tenant)
            if rec is None:
                continue
            summary["verdicts"].append((tenant, rec.verdict))
            det = self.detector(tenant)
            if rec.verdict == "promoted":
                self._count("promotions")
                promoted = self.registry.get(tenant)
                if det is not None:
                    # rebaseline: the canary has its own fit-time
                    # snapshot, and its shadow accuracy is the new bar
                    det.reset(
                        promoted.ref_stats,
                        accuracy_baseline=rec.shadow.get("shadow_accuracy"),
                    )
                    det._announced = False
                with self._lock:
                    self._probation[tenant] = {
                        "record": rec, "labeled": 0, "correct": 0,
                        # the canary is judged against its own shadow-
                        # window accuracy — the promise the promotion
                        # was made on (pre-promotion *live* accuracy is
                        # exactly what drift broke, so it is no bar)
                        "baseline": rec.shadow.get("shadow_accuracy"),
                    }
            else:
                self._count("rejections")
                if det is not None:
                    det.reset()  # same reference; re-arm the trigger
                    det._announced = False

    def _check_probation(self, summary: dict) -> None:
        with self._lock:
            items = list(self._probation.items())
        for tenant, prob in items:
            if prob["labeled"] < self.policy.min_labeled_rows:
                continue
            baseline = prob["baseline"]
            post_acc = prob["correct"] / prob["labeled"]
            regressed = (
                baseline is not None
                and post_acc < baseline - self.policy.rollback_margin
            )
            if regressed:
                parents = self.promoter._parents.get(tenant)
                rec = self.promoter.rollback(
                    tenant, reason="canary regression",
                    shadow={"post_accuracy": round(post_acc, 4),
                            "baseline": baseline,
                            "labeled_rows": prob["labeled"]},
                )
                self._count("rollbacks")
                summary["rollbacks"].append(tenant)
                det = self.detector(tenant)
                if det is not None and parents:
                    det.reset(parents[0].ref_stats, # may be None → keep ref
                              accuracy_baseline=baseline)
                    det._announced = False
                with self._lock:
                    self._probation.pop(tenant, None)
            elif prob["labeled"] >= self.policy.rollback_window_rows:
                self.promoter.forget_parent(tenant)
                with self._lock:
                    self._probation.pop(tenant, None)

    # -- telemetry ------------------------------------------------------
    @property
    def records(self) -> "list[PromotionRecord]":
        return self.promoter.records

    def report(self) -> dict:
        """Numeric snapshot for `prometheus_text(evolution=...)`."""
        with self._lock:
            counters = dict(self.counters)
            watched = len(self._detectors)
            probation = len(self._probation)
            pending_candidates = len(self._candidates)
        divergence = {}
        for tenant in self.watched():
            det = self.detector(tenant)
            if det is not None:
                divergence[tenant] = round(det.divergence, 5)
        return {
            **counters,
            "watched": watched,
            "shadowing": len(self.promoter.scorer.tracked()),
            "probation": probation,
            "pending_candidates": pending_candidates,
            "audit_records": len(self.promoter.records),
            "divergence": divergence,
        }

    def stop(self) -> None:
        self.worker.stop()


# re-exported names the package __init__ gathers
__all__ = [
    "EvolutionManager",
]
