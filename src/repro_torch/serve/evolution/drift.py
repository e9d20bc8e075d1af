"""Per-tenant drift detection from serving telemetry (PyTorch port).

Numpy host code, a copy of the reference package's detector: the float64
window sums and the Page-Hinkley update are the reference's, so the same
bit batches give the same verdicts and `state()`.

A frozen circuit decays silently when its input distribution moves: the
encoder's thresholds were fit on yesterday's data, so today's rows light
up different bit patterns and the evolved gates see inputs they were
never selected on.  Two complementary signals catch this:

  * **Covariate channel** — streaming per-bit activation frequencies of
    the encoded request batches, compared against the fit-time reference
    snapshot (`ServableCircuit.ref_stats`, bundle format v2).  The
    window divergence (mean absolute per-bit frequency shift) trips the
    detector directly when it clears ``divergence_threshold``
    (windowed-divergence style), and feeds a Page-Hinkley accumulator
    that catches slow ramps the window statistic alone would ride
    through.  No labels needed — this fires the moment traffic moves.
  * **Label-feedback channel** — ground truth often arrives late (a
    chargeback, a lab result).  `submit_feedback` on the front-end joins
    labels back to served predictions; the detector folds per-row
    correctness into an accuracy EWMA and trips when it falls
    ``min_accuracy_drop`` below the fit-time baseline.

Detector state is **pure**: transitions depend only on the observation
sequence, never on the clock (the injected clock only timestamps
verdicts), so a replay of the same stream reproduces the same state.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Callable, NamedTuple

import numpy as np

from repro_torch.core import encoding as E


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Knobs for one tenant's detector.

    ``window`` rows of encoded traffic form the sliding comparison
    window; no verdict fires before ``min_rows`` rows have been seen
    (early windows are all sampling noise).  ``divergence_threshold``
    is the direct trip wire on the window divergence; ``ph_delta`` /
    ``ph_lambda`` parameterize the Page-Hinkley ramp detector on the
    same signal (allowed per-step slack and trip threshold).  The
    accuracy channel trips when the per-row EWMA (half-life
    ``accuracy_halflife`` rows) falls ``min_accuracy_drop`` below the
    baseline, after ``min_labeled_rows`` labeled rows."""

    window: int = 512
    min_rows: int = 256
    divergence_threshold: float = 0.12
    ph_delta: float = 0.02
    ph_lambda: float = 0.60
    accuracy_halflife: float = 64.0
    min_accuracy_drop: float = 0.05
    min_labeled_rows: int = 64

    def __post_init__(self):
        if self.window < 1 or self.min_rows < 1:
            raise ValueError(
                f"window/min_rows must be >= 1, got "
                f"({self.window}, {self.min_rows})"
            )
        if self.divergence_threshold <= 0 or self.ph_lambda <= 0:
            raise ValueError("thresholds must be positive")


class DriftVerdict(NamedTuple):
    """One detector reading: did it trip, and on what evidence."""

    drifted: bool
    reason: str          # "" | "divergence" | "page_hinkley" | "accuracy"
    divergence: float    # current window divergence vs reference
    accuracy: "float | None"  # label-feedback EWMA (None before feedback)
    rows_seen: int
    at: float            # clock timestamp (cosmetic — never state)


class DriftDetector:
    """Streaming drift monitor for one tenant.

    ``reference`` is the fit-time per-bit activation frequency vector
    (f32[n_bits]); ``accuracy_baseline`` the fit-time accuracy the EWMA
    is judged against (None disables the accuracy trip).  Feed encoded
    request batches through `observe_bits` and late labels through
    `observe_accuracy`; both return a `DriftVerdict`.  Once tripped the
    detector stays tripped (`drifted`) until `reset` — the refit loop
    reads the latch, refits, and rebaselines."""

    def __init__(
        self,
        reference: np.ndarray,
        cfg: DriftConfig = DriftConfig(),
        *,
        accuracy_baseline: "float | None" = None,
        clock: "Callable[[], float] | None" = None,
    ):
        self.cfg = cfg
        self.clock = clock if clock is not None else (lambda: 0.0)
        self.reset(reference, accuracy_baseline=accuracy_baseline)

    # -- lifecycle -----------------------------------------------------
    def reset(
        self,
        reference: "np.ndarray | None" = None,
        *,
        accuracy_baseline: "float | None" = None,
    ) -> None:
        """Fresh detector state, optionally against a new reference —
        called after a promotion installs a circuit with a new fit-time
        snapshot."""
        if reference is not None:
            ref = np.asarray(reference, np.float64).reshape(-1)
            if ref.size == 0:
                raise ValueError("reference must be non-empty")
            self._ref = ref
        self._batches: deque[tuple[int, np.ndarray]] = deque()
        self._win_rows = 0
        self._win_sum = np.zeros_like(self._ref)
        self._rows_seen = 0
        # Page-Hinkley accumulator over the divergence signal
        self._ph_n = 0
        self._ph_mean = 0.0
        self._ph_m = 0.0
        self._ph_min = 0.0
        # label-feedback accuracy EWMA
        self._acc: "float | None" = None
        self._labeled_rows = 0
        if accuracy_baseline is not None or reference is not None:
            self._acc_baseline = accuracy_baseline
        self._latched: "DriftVerdict | None" = None

    # -- observation ---------------------------------------------------
    def observe_bits(self, bits: np.ndarray) -> DriftVerdict:
        """Fold one encoded request batch (u8[rows, n_bits]) into the
        sliding window and re-evaluate the covariate channel."""
        bits = np.asarray(bits)
        if bits.ndim != 2 or bits.shape[1] != self._ref.size:
            raise ValueError(
                f"expected bits[rows, {self._ref.size}], got {bits.shape}"
            )
        rows = bits.shape[0]
        if rows:
            s = bits.sum(axis=0, dtype=np.float64)
            self._batches.append((rows, s))
            self._win_rows += rows
            self._win_sum += s
            self._rows_seen += rows
            while (self._win_rows - self._batches[0][0] >= self.cfg.window
                   and len(self._batches) > 1):
                r0, s0 = self._batches.popleft()
                self._win_rows -= r0
                self._win_sum -= s0
        div = self.divergence
        reason = ""
        if self._rows_seen >= self.cfg.min_rows:
            # direct windowed-divergence trip
            if div > self.cfg.divergence_threshold:
                reason = "divergence"
            # Page-Hinkley on the divergence signal: accumulate positive
            # excursions above the running mean (plus slack); a sustained
            # ramp accumulates, sampling noise cancels
            self._ph_n += 1
            self._ph_mean += (div - self._ph_mean) / self._ph_n
            self._ph_m += div - self._ph_mean - self.cfg.ph_delta
            self._ph_min = min(self._ph_min, self._ph_m)
            if not reason and (self._ph_m - self._ph_min
                               > self.cfg.ph_lambda):
                reason = "page_hinkley"
        return self._verdict(reason, div)

    def observe_accuracy(self, correct: int, total: int) -> DriftVerdict:
        """Fold label feedback (``correct`` of ``total`` served rows were
        right) into the accuracy EWMA and re-evaluate that channel."""
        if total <= 0:
            return self._verdict("", self.divergence)
        frac = correct / total
        # per-row exponential decay with the configured half-life
        alpha = 1.0 - math.pow(0.5, total / self.cfg.accuracy_halflife)
        self._acc = frac if self._acc is None else (
            self._acc + alpha * (frac - self._acc)
        )
        self._labeled_rows += total
        reason = ""
        if (self._acc_baseline is not None
                and self._labeled_rows >= self.cfg.min_labeled_rows
                and self._acc
                < self._acc_baseline - self.cfg.min_accuracy_drop):
            reason = "accuracy"
        return self._verdict(reason, self.divergence)

    def _verdict(self, reason: str, div: float) -> DriftVerdict:
        v = DriftVerdict(
            drifted=bool(reason) or self._latched is not None,
            reason=reason or (self._latched.reason if self._latched else ""),
            divergence=div,
            accuracy=self._acc,
            rows_seen=self._rows_seen,
            at=self.clock(),
        )
        if reason and self._latched is None:
            self._latched = v
        return v

    # -- queries -------------------------------------------------------
    @property
    def divergence(self) -> float:
        """Mean absolute per-bit frequency shift, window vs reference."""
        if self._win_rows == 0:
            return 0.0
        freq = self._win_sum / self._win_rows
        return float(np.abs(freq - self._ref).mean())

    @property
    def drifted(self) -> bool:
        return self._latched is not None

    @property
    def trigger(self) -> "DriftVerdict | None":
        """The first tripping verdict (None while healthy)."""
        return self._latched

    @property
    def accuracy(self) -> "float | None":
        return self._acc

    @property
    def rows_seen(self) -> int:
        return self._rows_seen

    def state(self) -> dict:
        """Replayable state snapshot — everything the transition
        function depends on, no timestamps.  Two detectors fed the same
        observation sequence produce equal snapshots regardless of their
        clocks (the purity property the tests pin)."""
        return {
            "rows_seen": self._rows_seen,
            "win_rows": self._win_rows,
            "win_sum": self._win_sum.tolist(),
            "ph": (self._ph_n, self._ph_mean, self._ph_m, self._ph_min),
            "accuracy": self._acc,
            "labeled_rows": self._labeled_rows,
            "latched_reason": (self._latched.reason
                               if self._latched else None),
        }


def bit_activation_stats(encoder, x: np.ndarray) -> np.ndarray:
    """Per-bit activation frequency of ``x`` under ``encoder`` — the
    fit-time snapshot saved as `ServableCircuit.ref_stats`, and what the
    refit loop recomputes on the replay window for a candidate."""
    bits = E.encode(encoder, np.asarray(x, np.float32))
    if bits.shape[0] == 0:
        return np.zeros(encoder.n_bits_total, np.float32)
    return bits.mean(axis=0).astype(np.float32)
