"""AutoscaleController: closes the loop from telemetry to placement.

The serving stack already emits everything an autoscaler needs — the
server's per-shard lane occupancy and per-tenant rows (`ServerStats`),
the deadline scheduler's per-shard launch-latency EWMAs, and the front
end's deadline-miss accounting (`FrontendStats`).  The controller
windows those counters into one `ShardTelemetry` snapshot per `step()`,
asks its `AutoscalePolicy` what to do, and when the answer is not
"none":

  1. snapshots the catalog and incrementally recompiles
     (`PlanCompiler.recompile`) under the decision's target shard count,
     weighting slots by *observed* per-tenant rows for rebalances so the
     migration equalizes traffic, not just gate counts;
  2. installs the plan with the generation-fenced
     `CircuitServer.swap_plan` (prewarmed: on the card the new shards'
     span-launch units are built before the fence) — a registry mutation
     racing the compile trips the fence and the controller re-snapshots
     and retries;
  3. rebinds the scheduler's per-shard latency EWMAs onto the new shard
     layout (`rebind_shards`) so deadline fire times stay calibrated
     across the swap instead of cold-starting.

The controller reads the front end only through its locked accessors
(`queue_rows`, `latency_est`, and `FrontendStats.snapshot`), never the
scheduler's queues directly: a submitting thread may be pushing into them
at the same moment.

Driving it is the caller's business: call ``step()`` from a serving
loop, a background timer, or a benchmark's control cadence.  The
controller holds no thread of its own.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import numpy as np

from repro_torch.serve.async_frontend.frontend import AsyncCircuitServer
from repro_torch.serve.autoscale.policy import (
    AutoscaleDecision,
    AutoscalePolicy,
    HysteresisPolicy,
    ShardTelemetry,
)
from repro_torch.serve.circuits.metrics import RebalanceEvent
from repro_torch.serve.circuits.server import CircuitServer, StalePlanError
from repro_torch.serve.planning import CompiledPlan, PlanCompiler


def carry_map(prev: CompiledPlan, new: CompiledPlan) -> "dict[int, int]":
    """new shard → the previous shard that contributed most of its slots
    (ties toward the lower previous shard) — what the scheduler's latency
    EWMAs rebind along, since a shard mostly made of old shard ``o``'s
    slots will launch most like ``o`` did."""
    prev_ref = {
        (t, m): r
        for t, refs in prev.placement.items()
        for m, r in enumerate(refs)
        if r is not None
    }
    votes: dict[int, dict[int, int]] = {}
    for t, refs in new.placement.items():
        for m, r in enumerate(refs):
            old = prev_ref.get((t, m))
            if r is None or old is None:
                continue
            tally = votes.setdefault(r.shard, {})
            tally[old.shard] = tally.get(old.shard, 0) + 1
    return {
        s: max(tally, key=lambda o: (tally[o], -o))
        for s, tally in votes.items()
    }


class CounterWindow:
    """Delta-windows a monotone counter, re-baselining on stats resets.

    Shared telemetry primitive: the autoscale controller windows
    per-shard/per-tenant row counters with it."""

    def __init__(self):
        self._last: dict = {}

    def delta(self, key, value: float) -> float:
        last = self._last.get(key, 0)
        if value < last:  # the stats object was reset — re-baseline
            last = 0
        self._last[key] = value
        return value - last


_Window = CounterWindow  # in-module name


class AutoscaleController:
    """Telemetry-driven online rebalancing over one serving stack.

    ``target`` is either a bare `CircuitServer` (occupancy-driven
    rebalancing only — there is no deadline telemetry without a front
    end) or an `AsyncCircuitServer`, in which case miss-rate and
    p99-headroom triggers activate and scheduler EWMAs are rebound
    across every swap."""

    def __init__(
        self,
        target: "CircuitServer | AsyncCircuitServer",
        policy: AutoscalePolicy | None = None,
        *,
        clock: Callable[[], float] = time.monotonic,
        max_retries: int = 3,
    ):
        if isinstance(target, AsyncCircuitServer):
            self.frontend: AsyncCircuitServer | None = target
            self.server = target.server
        else:
            self.frontend = None
            self.server = target
        self.policy = policy if policy is not None else HysteresisPolicy()
        self.clock = clock
        self.max_retries = int(max_retries)
        self.events: list[RebalanceEvent] = []
        self._shard_win = _Window()
        self._tenant_win = _Window()
        self._frontend_win = _Window()

    # -- telemetry ------------------------------------------------------
    def collect(self, now: float | None = None) -> ShardTelemetry:
        """One windowed snapshot: per-shard occupancy and per-tenant rows
        since the last collect, live scheduler EWMAs, and the front end's
        miss rate over the same window."""
        now = self.clock() if now is None else now
        stats = self.server.stats
        plan = self.server.plan()
        n_shards = max(plan.n_shards, 1)

        # C-level dict copies: atomic under the GIL, so a serving thread
        # inserting a new shard/tenant key mid-collect cannot blow up the
        # iteration below
        shard_rows = dict(stats.shard_rows)
        shard_cells = dict(stats.shard_cells)
        occupancy: dict[int, float] = {}
        shard_load: dict[int, float] = {}
        for s in range(n_shards):
            d_rows = self._shard_win.delta(
                ("rows", s), shard_rows.get(s, 0)
            )
            d_cells = self._shard_win.delta(
                ("cells", s), shard_cells.get(s, 0)
            )
            occupancy[s] = d_rows / d_cells if d_cells > 0 else 0.0
            shard_load[s] = float(d_rows)
        tenant_rows = {
            t: int(self._tenant_win.delta(t, rows))
            for t, rows in dict(stats.tenant_rows).items()
        }

        latency_s: dict[int, float] = {}
        miss_rate, p99, queue_rows = 0.0, 0.0, 0
        if self.frontend is not None:
            fe = self.frontend
            # every read of scheduler state goes through the front end's
            # lock: submitting threads push into the queues concurrently
            latency_s = {s: fe.latency_est(s) for s in range(n_shards)}
            submitted, missed, latencies = fe.stats.snapshot()
            d_admitted = self._frontend_win.delta("submitted", submitted)
            d_missed = self._frontend_win.delta("missed", missed)
            if d_admitted > 0:
                miss_rate = d_missed / d_admitted
            lat = np.asarray(latencies or [0.0])
            p99 = float(np.percentile(lat, 99))
            queue_rows = fe.queue_rows()

        deadlines = []
        for tenant in list(self.server.registry):
            try:
                deadlines.append(
                    self.server.registry.qos(tenant).default_deadline_s
                )
            except KeyError:  # removed between iteration and lookup
                continue
        return ShardTelemetry(
            now=now,
            n_shards=n_shards,
            occupancy=occupancy,
            shard_load=shard_load,
            latency_s=latency_s,
            miss_rate=miss_rate,
            p99_latency_s=p99,
            min_deadline_s=min(deadlines, default=math.inf),
            queue_rows=queue_rows,
            tenant_rows=tenant_rows,
        )

    # -- the control step ----------------------------------------------
    def step(self, now: float | None = None) -> RebalanceEvent | None:
        """One control step: collect → decide → (maybe) swap.  Returns
        the installed `RebalanceEvent`, or None when the policy held."""
        now = self.clock() if now is None else now
        telemetry = self.collect(now)
        decision = self.policy.decide(telemetry)
        tracer = self.server.tracer
        tracer.counter(
            "autoscale.miss_rate", round(telemetry.miss_rate, 6),
            cat="autoscale", track="autoscale",
        )
        tracer.counter(
            "autoscale.queue_rows", telemetry.queue_rows,
            cat="autoscale", track="autoscale",
        )
        if decision.action == "none":
            return None
        tracer.instant(
            "autoscale.decision", cat="autoscale", track="autoscale",
            action=decision.action, reason=decision.reason,
            n_shards=decision.n_shards, from_shards=telemetry.n_shards,
            miss_rate=round(telemetry.miss_rate, 6),
            queue_rows=telemetry.queue_rows,
        )
        weights = None
        if decision.action == "rebalance" and any(
                telemetry.tenant_rows.values()):
            weights = {
                t: float(r) for t, r in telemetry.tenant_rows.items()
            }
        event = self.apply(decision, weights=weights)
        self.policy.notify_swap(now)
        return event

    def apply(
        self,
        decision: AutoscaleDecision,
        *,
        weights: "dict[str, float] | None" = None,
    ) -> RebalanceEvent:
        """Compile and install a plan for ``decision``, retrying the
        generation fence a bounded number of times.  Usable directly for
        operator-scripted swaps."""
        target_policy = dataclasses.replace(
            self.server.policy, n_shards=max(int(decision.n_shards), 1)
        )
        compiler = PlanCompiler(self.server.backend, target_policy)
        err: StalePlanError | None = None
        for _ in range(self.max_retries):
            # peek, don't refresh: the stickiness hint may be one
            # generation stale (placement quality only, never
            # correctness), and refreshing would compile a plan this swap
            # immediately replaces
            prev = self.server.peek_plan()
            if prev is None:
                prev = self.server.plan()
            catalog = self.server.registry.catalog()
            plan = compiler.recompile(
                catalog, prev,
                weights=weights, max_imbalance=decision.max_imbalance,
            )
            carry = carry_map(prev, plan)
            try:
                event = self.server.swap_plan(
                    plan, compiler=compiler,
                    action=decision.action, reason=decision.reason,
                )
            except StalePlanError as stale:
                err = stale  # registry churned mid-compile: re-snapshot
                continue
            if self.frontend is not None:
                self.frontend.rebind_shards(carry, plan.n_shards)
            self.events.append(event)
            return event
        raise err if err is not None else StalePlanError(
            "swap retries exhausted"
        )
