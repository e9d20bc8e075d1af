"""Throughput / latency accounting for the circuit serving engine.

Every `CircuitServer.tick()` reports one `TickReport`; `ServerStats`
accumulates them into the numbers an operator actually watches: QPS,
rows/s, p50/p99 tick latency, and kernel occupancy (the fraction of
row-lanes in the fused launch that carried real requests rather than
word-boundary or span padding).

`FrontendStats` is the request-level companion for the async front end
(`repro_torch.serve.async_frontend`): per-request latency percentiles, the
deadline-miss rate (shed + served-late), admission rejects, queue depth,
and batch fill (how full the deadline scheduler's coalesced launches run
against the tenants' `max_batch` budgets).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import threading
import time
from typing import Callable

import numpy as np

# samples kept per percentile window — long-running servers must not grow
# memory per request/poll; report() percentiles cover the trailing window
STATS_WINDOW = 8192
_window = functools.partial(collections.deque, maxlen=STATS_WINDOW)

# tick phases charged to the host CPU vs the device path.  encode/pack/
# decode are numpy on the host; device_put is the host→device copy, launch
# the kernel enqueue, readback the wait for the device and the copy back.
HOST_PHASES = ("encode", "pack", "decode")
DEVICE_PHASES = ("device_put", "launch", "readback")
TICK_PHASES = HOST_PHASES[:2] + DEVICE_PHASES + HOST_PHASES[2:]


@dataclasses.dataclass(frozen=True)
class TickReport:
    """What one micro-batch tick did."""

    generation: int        # registry generation served
    tenants: int           # logical tenants with pending rows this tick
    requests: int          # requests completed
    rows: int              # feature rows predicted
    launches: int          # fused kernel launches (one per shard
    #                        with work; 0 on an empty tick)
    span_words: int        # words per slot span (max across shards)
    latency_s: float       # wall-clock tick duration
    occupancy: float       # rows / (padded slots * span_words * 32)
    plan_shards: int = 1   # shards in the compiled plan this tick ran
    max_slots_per_launch: int = 0  # busiest single shard launch (slots)
    # per-launch (shard, slot-rows, padded bit-lanes) — slot-rows counts
    # each ensemble member's rows once per slot it occupies, i.e. the
    # lanes that actually carried data in that shard's launch
    shard_stats: tuple = ()
    tenant_rows: tuple = ()  # per-tenant (name, rows) served this tick
    # wall time per tick phase, seconds: encode / pack / device_put /
    # launch / readback / decode (see TICK_PHASES) — the breakdown behind
    # the host-vs-kernel share in ServerStats.report()
    phase_s: dict = dataclasses.field(default_factory=dict)

    @property
    def empty(self) -> bool:
        return self.rows == 0

    @property
    def host_s(self) -> float:
        """Host-CPU time this tick (encode + pack + decode)."""
        return sum(self.phase_s.get(p, 0.0) for p in HOST_PHASES)

    @property
    def device_s(self) -> float:
        """Device-path time this tick (device_put + launch + readback)."""
        return sum(self.phase_s.get(p, 0.0) for p in DEVICE_PHASES)


@dataclasses.dataclass(frozen=True)
class RebalanceEvent:
    """One generation-fenced plan swap (`CircuitServer.swap_plan`).

    ``shards_reused`` counts new-plan shards whose device state was
    satisfied by the content-hash cache (unchanged shards are never
    rebuilt); ``shards_rebuilt`` counts the ones that were not.
    ``inflight_requests`` is how many requests were queued on the server
    across the swap — they land on the new plan at their next tick, none
    are lost."""

    action: str            # "grow" | "shrink" | "rebalance" | "swap"
    reason: str            # the caller's human-readable trigger
    generation: int        # catalog generation the new plan serves
    from_shards: int
    to_shards: int
    shards_reused: int
    shards_rebuilt: int
    inflight_requests: int
    swap_ms: float         # wall-clock install latency (fence → plan live)
    prev_hash: str         # content hash of the plan swapped out
    plan_hash: str         # content hash of the plan swapped in


@dataclasses.dataclass
class ServerStats:
    """Running aggregate over ticks (host-side, cheap).

    ``backend`` is the resolved execution-backend name the server
    dispatches through, so reports stay comparable across backends.
    ``clock`` is injectable so the timestamped QPS window is
    fake-clock-testable.

    Thread-safety: ticks are recorded by whichever thread drives the
    server while ``report()`` is read from other threads — both sides
    take the internal lock, so a percentile pass can never iterate a
    deque mid-append."""

    backend: str = "torch-ref"
    clock: Callable[[], float] = time.perf_counter
    started_at: float | None = None
    ticks: int = 0
    empty_ticks: int = 0
    launches: int = 0
    requests: int = 0
    rows: int = 0
    tick_latencies_s: collections.deque = dataclasses.field(
        default_factory=_window
    )
    occupancies: collections.deque = dataclasses.field(
        default_factory=_window
    )
    max_tenants_per_launch: int = 0
    plan_shards: int = 1
    # cumulative per-shard lane accounting and per-tenant rows served
    shard_rows: dict = dataclasses.field(default_factory=dict)
    shard_cells: dict = dataclasses.field(default_factory=dict)
    tenant_rows: dict = dataclasses.field(default_factory=dict)
    # (timestamp, cumulative requests) marks — the trailing-window QPS
    # basis.  Lifetime QPS divides by elapsed-since-construction, which
    # understates throughput after any idle period; the window covers
    # only the last STATS_WINDOW ticks of actual serving.
    request_marks: collections.deque = dataclasses.field(
        default_factory=_window
    )
    # cumulative seconds per tick phase (see TICK_PHASES)
    phase_totals: dict = dataclasses.field(default_factory=dict)
    rebalances: list = dataclasses.field(default_factory=list)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False
    )

    def __post_init__(self) -> None:
        if self.started_at is None:
            self.started_at = self.clock()

    def record(self, report: TickReport) -> None:
        with self._lock:
            self.ticks += 1
            self.plan_shards = max(self.plan_shards, report.plan_shards)
            # Requests count even on launch-free ticks: zero-row
            # submissions and requests failed by a hot remove still
            # complete this tick.
            self.requests += report.requests
            self.request_marks.append((self.clock(), self.requests))
            if report.empty:
                self.empty_ticks += 1
                return
            self.launches += report.launches
            self.rows += report.rows
            self.tick_latencies_s.append(report.latency_s)
            self.occupancies.append(report.occupancy)
            for phase, s in report.phase_s.items():
                self.phase_totals[phase] = (
                    self.phase_totals.get(phase, 0.0) + s
                )
            for shard, rows, cells in report.shard_stats:
                self.shard_rows[shard] = self.shard_rows.get(shard, 0) + rows
                self.shard_cells[shard] = (
                    self.shard_cells.get(shard, 0) + cells
                )
            for tenant, rows in report.tenant_rows:
                self.tenant_rows[tenant] = (
                    self.tenant_rows.get(tenant, 0) + rows
                )
            # per *launch*, not per tick: a sharded tick's busiest single
            # launch (falls back to the tick's tenant count for reports
            # that predate the field)
            self.max_tenants_per_launch = max(
                self.max_tenants_per_launch,
                report.max_slots_per_launch or report.tenants,
            )

    def record_rebalance(self, event: RebalanceEvent) -> None:
        with self._lock:
            self.rebalances.append(event)

    def phase_breakdown(self) -> dict:
        """Per-phase tick cost: mean ms per non-empty tick, each phase's
        share of total phase time, and the host-vs-device split.  Callers
        must hold the lock or tolerate a racing tick."""
        total = sum(self.phase_totals.values())
        nonempty = max(self.ticks - self.empty_ticks, 1)
        host = sum(self.phase_totals.get(p, 0.0) for p in HOST_PHASES)
        return {
            "per_tick_ms": {
                p: round(self.phase_totals.get(p, 0.0) / nonempty * 1e3, 4)
                for p in TICK_PHASES
            },
            "share": {
                p: round(self.phase_totals.get(p, 0.0) / max(total, 1e-12), 4)
                for p in TICK_PHASES
            },
            "host_share": round(host / max(total, 1e-12), 4),
            "kernel_share": round((total - host) / max(total, 1e-12), 4),
        }

    def report(self) -> dict:
        # snapshot every mutable container under the lock, then compute
        # percentiles on the copies — a tick recorded mid-report cannot
        # mutate a deque we are iterating
        with self._lock:
            elapsed = self.clock() - self.started_at
            lat = list(self.tick_latencies_s)
            occ = list(self.occupancies)
            marks = list(self.request_marks)
            shard_rows = dict(self.shard_rows)
            shard_cells = dict(self.shard_cells)
            phases = self.phase_breakdown()
            rebalances = list(self.rebalances)
        lat = np.asarray(lat or [0.0])
        occ = np.asarray(occ or [0.0])
        if len(marks) >= 2 and marks[-1][0] > marks[0][0]:
            qps_window = ((marks[-1][1] - marks[0][1])
                          / (marks[-1][0] - marks[0][0]))
            window_s = marks[-1][0] - marks[0][0]
        else:  # too few ticks for a window — fall back to lifetime
            qps_window = self.requests / max(elapsed, 1e-9)
            window_s = elapsed
        return {
            "backend": self.backend,
            "ticks": self.ticks,
            "empty_ticks": self.empty_ticks,
            "launches": self.launches,
            "requests": self.requests,
            "rows": self.rows,
            "qps": round(self.requests / max(elapsed, 1e-9), 1),
            # trailing-window QPS over the last STATS_WINDOW ticks of
            # actual serving: unlike lifetime `qps`, idle time before the
            # window does not dilute it
            "qps_window": round(qps_window, 1),
            "window_s": round(window_s, 3),
            "rows_per_s": round(self.rows / max(elapsed, 1e-9), 1),
            "p50_tick_ms": round(float(np.percentile(lat, 50)) * 1e3, 3),
            "p99_tick_ms": round(float(np.percentile(lat, 99)) * 1e3, 3),
            "mean_occupancy": round(float(occ.mean()), 4),
            "phase_breakdown": phases,
            "max_tenants_per_launch": self.max_tenants_per_launch,
            "plan_shards": self.plan_shards,
            "shard_occupancy": {
                str(s): round(
                    shard_rows.get(s, 0)
                    / max(shard_cells.get(s, 1), 1), 4,
                )
                for s in sorted(shard_cells)
            },
            "n_rebalances": len(rebalances),
            "mean_swap_ms": round(
                sum(e.swap_ms for e in rebalances)
                / max(len(rebalances), 1), 3,
            ),
            "shards_reused_frac": round(
                sum(e.shards_reused for e in rebalances)
                / max(sum(e.shards_reused + e.shards_rebuilt
                          for e in rebalances), 1), 4,
            ),
        }


@dataclasses.dataclass
class FrontendStats:
    """Request-level accounting for the deadline-aware async front end.

    A request ends in exactly one of four states: ``rejected`` (admission
    control: its deadline had already passed at submit), ``shed`` (expired
    in the queue before any launch could carry it), ``served_late``
    (completed, but after its deadline), or on-time.  The miss rate counts
    shed + served-late over every admitted request.

    Thread-safety mirrors `ServerStats`: the background scheduler thread
    records fires and requests while callers read ``report()`` or
    ``snapshot()`` — every mutation and every read of more than one field
    takes the internal lock, so the deques are never iterated mid-append
    and a reader never sees one counter moved without the other."""

    backend: str = "torch-ref"
    submitted: int = 0         # admitted into the queue
    completed: int = 0         # futures resolved with a result or error
    rejected: int = 0          # admission control turned the submit away
    shed: int = 0              # expired in queue, future failed
    served_late: int = 0       # served, but past the deadline
    fires: int = 0             # scheduler-initiated launches
    fire_reasons: dict = dataclasses.field(default_factory=dict)
    shard_fires: dict = dataclasses.field(default_factory=dict)
    request_latencies_s: collections.deque = dataclasses.field(
        default_factory=_window
    )
    batch_fills: collections.deque = dataclasses.field(
        default_factory=_window
    )
    queue_depth_rows: collections.deque = dataclasses.field(
        default_factory=_window
    )
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False
    )

    @property
    def deadline_misses(self) -> int:
        return self.shed + self.served_late

    def record_submitted(self) -> None:
        with self._lock:
            self.submitted += 1

    def record_poll(self, queue_rows: int) -> None:
        with self._lock:
            self.queue_depth_rows.append(queue_rows)

    def record_shed(self, n: int) -> None:
        with self._lock:
            self.shed += n

    def record_rejected(self) -> None:
        with self._lock:
            self.rejected += 1

    def record_fire(
        self,
        reason: str,
        fill: float,
        shards: tuple = (),
        reasons: "list[str] | None" = None,
    ) -> None:
        """One scheduler-initiated launch.  ``reasons`` carries each fired
        shard's own trigger when shards fired together for different
        reasons; without it the single ``reason`` is counted once."""
        with self._lock:
            self.fires += 1
            for r in (reasons or [reason]):
                self.fire_reasons[r] = self.fire_reasons.get(r, 0) + 1
            for s in shards:
                self.shard_fires[s] = self.shard_fires.get(s, 0) + 1
            self.batch_fills.append(fill)

    def record_request(self, latency_s: float, late: bool) -> None:
        with self._lock:
            self.completed += 1
            self.request_latencies_s.append(latency_s)
            if late:
                self.served_late += 1

    def snapshot(self) -> "tuple[int, int, list[float]]":
        """``(submitted, deadline_misses, request latencies)`` read as one
        consistent snapshot — what the autoscale controller windows."""
        with self._lock:
            return (self.submitted, self.shed + self.served_late,
                    list(self.request_latencies_s))

    def report(self) -> dict:
        # snapshot under the lock, percentile on the copies (the scheduler
        # thread appends concurrently)
        with self._lock:
            lat = list(self.request_latencies_s)
            fill = list(self.batch_fills)
            depth = list(self.queue_depth_rows)
            submitted = self.submitted
            completed = self.completed
            rejected = self.rejected
            shed = self.shed
            served_late = self.served_late
            fires = self.fires
            fire_reasons = dict(self.fire_reasons)
            shard_fires = dict(self.shard_fires)
        lat = np.asarray(lat or [0.0])
        fill = np.asarray(fill or [0.0])
        depth = np.asarray(depth or [0])
        admitted = max(submitted, 1)
        return {
            "backend": self.backend,
            "submitted": submitted,
            "completed": completed,
            "rejected": rejected,
            "shed": shed,
            "served_late": served_late,
            "deadline_misses": shed + served_late,
            "miss_rate": round((shed + served_late) / admitted, 4),
            "fires": fires,
            "fire_reasons": fire_reasons,
            "shard_fires": {str(k): v for k, v in shard_fires.items()},
            "p50_latency_ms": round(float(np.percentile(lat, 50)) * 1e3, 3),
            "p99_latency_ms": round(float(np.percentile(lat, 99)) * 1e3, 3),
            "mean_batch_fill": round(float(fill.mean()), 4),
            "max_queue_depth_rows": int(depth.max()),
        }
