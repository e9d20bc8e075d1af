"""Autoscale policies: telemetry in, placement decision out.

An `AutoscalePolicy` is the pluggable brain of the autoscaler: it reads
one `ShardTelemetry` snapshot per control step and answers a single
question — leave the plan alone, rebalance slot assignment across the
current shards, or grow/shrink the shard count.  Policies are pure
decision cores (no clock of their own, no server handles), so tests
drive them with synthetic telemetry exactly like the deadline scheduler
is driven with a fake clock.

`HysteresisPolicy` is the default: thresholds on occupancy imbalance and
p99-vs-deadline headroom, guarded by the three classic anti-flap
mechanisms — a breach must persist for ``patience`` consecutive
observations, every swap is followed by a ``cooldown_s`` quiet period,
and the imbalance trigger re-arms only after the ratio falls back below
a lower exit threshold (true hysteresis, not a single cutoff).
"""
from __future__ import annotations

import abc
import dataclasses
import math
from typing import Mapping, NamedTuple

import torch


class ShardTelemetry(NamedTuple):
    """One control-step snapshot of the serving stack's health.

    Occupancy and tenant rows are *windowed* (deltas since the previous
    controller step), so the policy reacts to what traffic is doing now,
    not to the whole run's history; latency estimates are the
    scheduler's live per-shard EWMAs."""

    now: float                          # controller clock
    n_shards: int                       # shards in the live plan
    occupancy: Mapping[int, float]      # fused-lane occupancy per shard
    # rows served per shard over the window — the *load* signal.  Lane
    # occupancy alone cannot see skew: span bucketing grows a busy
    # shard's buffer with its traffic, so its fill fraction stays flat
    # while its row throughput (and launch latency) balloons.
    shard_load: Mapping[int, float]
    latency_s: Mapping[int, float]      # per-shard launch-latency EWMA
    miss_rate: float                    # deadline misses / admitted (window)
    p99_latency_s: float                # request p99 (trailing window)
    min_deadline_s: float               # tightest default deadline, inf if none
    queue_rows: int                     # rows queued at snapshot time
    tenant_rows: Mapping[str, int]      # rows served per tenant (window)


class AutoscaleDecision(NamedTuple):
    """What one policy step decided."""

    action: str                  # "none" | "grow" | "shrink" | "rebalance"
    n_shards: int                # target shard count for the new plan
    reason: str                  # human-readable trigger (lands in the
    #                              RebalanceEvent)
    max_imbalance: float | None = None  # rebalance target for recompile


class AutoscalePolicy(abc.ABC):
    """Decision interface the `AutoscaleController` polls."""

    @abc.abstractmethod
    def decide(self, t: ShardTelemetry) -> AutoscaleDecision:
        """One control step: telemetry snapshot → decision."""

    def notify_swap(self, now: float) -> None:
        """Called after a decision was actually installed (the swap can
        fail on the generation fence and be retried) — the hook cooldown
        timers key off."""


@dataclasses.dataclass
class HysteresisPolicy(AutoscalePolicy):
    """Threshold policy with patience, cooldown, and re-arm hysteresis.

    Decision priority per step (first match wins):

      1. **grow** — the windowed deadline-miss rate exceeds
         ``miss_rate_high``, or headroom (``1 - p99/min_deadline``)
         fell below ``grow_headroom``: the fleet is close to missing
         deadlines, add a shard so launches shrink and overlap more.
      2. **rebalance** — the busiest shard's share of served rows
         exceeds ``imbalance_high`` × the mean share: same shard count,
         move slots (weighted by observed per-tenant rows) until within
         ``rebalance_target``.  Re-arms only after the ratio drops
         below ``imbalance_low``.
      3. **shrink** — headroom above ``shrink_headroom``, mean occupancy
         below ``shrink_occupancy``, nothing queued and nothing missing:
         the fleet is over-provisioned, drop a shard.

    Any candidate must persist for ``patience`` consecutive steps, and
    no decision fires within ``cooldown_s`` of the last installed swap.

    ``device_cap`` makes the policy topology-aware: grow decisions never
    target more shards than the host has CUDA devices, because an extra
    shard beyond that point time-shares a card with an existing one — it
    adds a program compile and a span-launch unit but no parallelism.
    The default (``None``) reads the count at decide time (see
    `_device_cap`): 1 on a host without CUDA, and 1 on a one-card host,
    where the default policy therefore **never grows** (rebalances and
    shrinks still fire).  Pass an explicit cap to let shards time-share
    one card, or to model another topology (tests do).
    """

    min_shards: int = 1
    max_shards: int = 8
    device_cap: "int | None" = None
    grow_headroom: float = 0.25
    miss_rate_high: float = 0.01
    imbalance_high: float = 1.5
    imbalance_low: float = 1.15
    rebalance_target: float = 1.10
    shrink_headroom: float = 0.85
    shrink_occupancy: float = 0.02
    patience: int = 2
    cooldown_s: float = 0.5

    def __post_init__(self):
        if not 1 <= self.min_shards <= self.max_shards:
            raise ValueError(
                f"need 1 <= min_shards <= max_shards, got "
                f"({self.min_shards}, {self.max_shards})"
            )
        if not self.imbalance_low <= self.imbalance_high:
            raise ValueError(
                f"imbalance_low must not exceed imbalance_high, got "
                f"({self.imbalance_low}, {self.imbalance_high})"
            )
        if self.patience < 1 or self.cooldown_s < 0:
            raise ValueError(
                f"patience must be >= 1 and cooldown_s >= 0, got "
                f"({self.patience}, {self.cooldown_s})"
            )
        if self.device_cap is not None and self.device_cap < 1:
            raise ValueError(
                f"device_cap must be >= 1 (or None for auto), got "
                f"{self.device_cap}"
            )
        self._streak = {"grow": 0, "rebalance": 0, "shrink": 0}
        self._armed = True
        self._last_swap: float | None = None

    def decide(self, t: ShardTelemetry) -> AutoscaleDecision:
        if (self._last_swap is not None
                and t.now - self._last_swap < self.cooldown_s):
            return AutoscaleDecision("none", t.n_shards, "cooldown")

        shards = range(max(t.n_shards, 1))
        occ = [t.occupancy.get(s, 0.0) for s in shards]
        mean_occ = sum(occ) / len(occ)
        load = [t.shard_load.get(s, 0.0) for s in shards]
        mean_load = sum(load) / len(load)
        ratio = max(load) / mean_load if mean_load > 0 else 1.0
        if ratio <= self.imbalance_low:
            self._armed = True  # imbalance trigger re-arms below the exit
        headroom = 1.0
        if math.isfinite(t.min_deadline_s) and t.min_deadline_s > 0:
            headroom = 1.0 - t.p99_latency_s / t.min_deadline_s

        want, why = "none", ""
        if t.n_shards < min(self.max_shards, self._device_cap()) and (
                t.miss_rate > self.miss_rate_high
                or headroom < self.grow_headroom):
            want = "grow"
            why = (f"miss_rate={t.miss_rate:.4f}, "
                   f"headroom={headroom:.2f}")
        elif (t.n_shards > 1 and self._armed
                and ratio > self.imbalance_high):
            want = "rebalance"
            why = f"shard load imbalance {ratio:.2f}x mean"
        elif (t.n_shards > self.min_shards
                and headroom > self.shrink_headroom
                and mean_occ < self.shrink_occupancy
                and t.miss_rate == 0.0 and t.queue_rows == 0):
            want = "shrink"
            why = f"headroom={headroom:.2f}, occupancy={mean_occ:.4f}"

        for action in self._streak:
            self._streak[action] = (
                self._streak[action] + 1 if action == want else 0
            )
        if want == "none":
            return AutoscaleDecision("none", t.n_shards, "within thresholds")
        if self._streak[want] < self.patience:
            return AutoscaleDecision(
                "none", t.n_shards,
                f"breach {self._streak[want]}/{self.patience} ({why})",
            )
        self._streak[want] = 0
        if want == "rebalance":
            self._armed = False  # stay quiet until the ratio exits low
            return AutoscaleDecision(
                "rebalance", t.n_shards, why, self.rebalance_target
            )
        delta = 1 if want == "grow" else -1
        return AutoscaleDecision(want, t.n_shards + delta, why)

    def _device_cap(self) -> int:
        """Most shards a grow may target: the explicit ``device_cap``, or
        else ``torch.cuda.device_count()`` read now, but never below 1.

        On a host without CUDA the count is 0, and taken raw it would
        veto every grow, so the cap is 1 there: a CPU server is one
        device.  On a one-card host the cap is 1 as well, so the default
        policy never grows there; pass ``device_cap`` to let up to that
        many shards time-share the card."""
        if self.device_cap is not None:
            return self.device_cap
        return max(torch.cuda.device_count(), 1)

    def notify_swap(self, now: float) -> None:
        self._last_swap = now
