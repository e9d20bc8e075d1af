"""Deadline-aware tick scheduler: decides *when* each shard's launch fires.

The synchronous `CircuitServer` serves whatever is pending the moment the
caller ticks it.  The scheduler inverts that: requests accumulate in
per-tenant `RequestQueue`s and every `poll(now)` answers one question —
fire a launch now, or sleep until when?  Three triggers fire a launch, in
this order for each tenant of a shard:

  * **deadline** — the earliest queued deadline, minus the EWMA estimate
    of launch latency and a safety margin, has arrived.  Firing early is
    the whole game: a launch started at the deadline has already missed.
  * **batch_full** — some tenant has at least ``max_batch`` rows queued;
    waiting longer cannot improve its batch fill.
  * **max_wait** — the oldest queued request has waited its tenant's
    ``max_wait_s``; bounded staleness even with lazy deadlines.

Scheduling is **per plan shard**: ``shard_of`` maps tenants to their
compiled-plan shard, every shard gets its own EWMA launch-latency
estimate and its own fire decision, and only tenants on *fired* shards
ride the resulting launch — one shard's backlog can delay its own
tenants, never another shard's deadlines.  Without a ``shard_of`` (the
single-shard default) everything lives on shard 0.

The scheduler is a pure decision core: no threads, no asyncio, no real
clock, no lock.  Time enters only through ``poll(now)`` / ``push``; tests
drive it with a fake clock, the front end drives it with
``time.monotonic`` and calls every method under its own lock.  The same
inputs give the reference scheduler's decisions and floats exactly.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.serve.async_frontend.queue import Request, RequestQueue
from repro_torch.serve.circuits.registry import TenantQoS


class FireDecision(NamedTuple):
    """What one scheduler poll decided."""

    batch: list[Request]     # requests to serve in one fused launch now
    expired: list[Request]   # requests shed this poll (deadline passed)
    reason: str              # "deadline" | "batch_full" | "max_wait" | ""
    next_wake: float | None  # absolute time of the next scheduled action
    queue_rows: int          # rows queued at poll time (pre-drain)
    shards: tuple[int, ...] = ()  # plan shards fired this poll
    # each fired shard's own trigger ((shard, reason), ...): two shards
    # can fire in one poll for different reasons
    shard_reasons: tuple = ()


class DeadlineScheduler:
    """Pure per-shard deadline/batching policy over per-tenant queues."""

    def __init__(
        self,
        qos_for: Callable[[str], TenantQoS],
        *,
        shard_of: Callable[[str], int] | None = None,
        latency_est_s: float = 0.0,
        latency_ewma: float = 0.25,
        safety_margin_s: float = 1e-3,
    ):
        self._qos_for = qos_for
        self._shard_of = shard_of
        self._queues: dict[str, RequestQueue] = {}
        self._latency_init = float(latency_est_s)
        self._shard_latency: dict[int, float] = {}
        self.latency_ewma = float(latency_ewma)
        self.safety_margin_s = float(safety_margin_s)

    # -- queue interface ----------------------------------------------
    def push(self, req: Request) -> None:
        q = self._queues.get(req.tenant_id)
        if q is None:
            q = self._queues[req.tenant_id] = RequestQueue(req.tenant_id)
        q.push(req)

    def queue_rows(self) -> int:
        return sum(q.rows() for q in self._queues.values())

    def pending_requests(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def pending_for(self, tenant: str) -> list[Request]:
        """Unconditionally drain one tenant's queued requests — the
        migration path: before a tenant's ownership moves elsewhere,
        everything already queued here must be served here, so the
        cutover loses nothing and reorders nothing."""
        q = self._queues.get(tenant)
        if q is None:
            return []
        batch: list[Request] = []
        while len(q):
            batch.extend(q.take(self._qos_for(tenant).max_batch))
        return batch

    def drain_all(self) -> list[Request]:
        """Unconditionally drain every queued request — shutdown path,
        where the only alternatives are serving early or dropping work on
        the floor."""
        batch: list[Request] = []
        for q in self._queues.values():
            while len(q):
                batch.extend(q.take(self._qos_for(q.tenant_id).max_batch))
        return batch

    # -- latency model -------------------------------------------------
    def shard(self, tenant: str) -> int:
        """The shard a tenant's launches ride (0 without a shard map;
        the plan's own shard_of already maps tenants removed mid-flight
        to 0, so they still fire and the server fails them per-request).
        A raising shard map is a programming error and propagates."""
        if self._shard_of is None:
            return 0
        return int(self._shard_of(tenant))

    def latency_est(self, shard: int = 0) -> float:
        """EWMA launch-latency estimate for one shard (shards start from
        the constructor seed until they observe their own launches)."""
        return self._shard_latency.get(shard, self._latency_init)

    @property
    def latency_est_s(self) -> float:
        """Scalar view: shard 0's estimate (the only shard in unsharded
        deployments)."""
        return self.latency_est(0)

    def observe_latency(self, latency_s: float, shard: int = 0) -> None:
        """Fold one measured launch latency into the shard's EWMA the
        deadline trigger subtracts when deciding how early to fire."""
        a = self.latency_ewma
        cur = self.latency_est(shard)
        self._shard_latency[shard] = (1 - a) * cur + a * latency_s

    def rebind_shards(self, carry: "dict[int, int]", n_shards: int) -> None:
        """Re-key the per-shard latency EWMAs across a plan swap.

        ``carry[new_shard] = old_shard`` names the pre-swap shard whose
        launches most resemble the new shard's (the one that contributed
        most of its slots).  Each new shard inherits its ancestor's
        estimate; a shard with no ancestor (or an unobserved one) seeds
        from the mean of the known estimates, so a freshly grown shard
        does not cold-start at zero and fire too late.  Estimates for
        shards beyond the new plan are dropped.  Fire times need no
        rebind — they are recomputed from queue state every poll."""
        old = self._shard_latency
        seed = sum(old.values()) / len(old) if old else None
        fresh: dict[int, float] = {}
        for s in range(n_shards):
            src = carry.get(s)
            if src is not None and src in old:
                fresh[s] = old[src]
            elif seed is not None:
                fresh[s] = seed
        self._shard_latency = fresh

    # -- the decision --------------------------------------------------
    def poll(self, now: float) -> FireDecision:
        """Shed expired requests, then fire due shards or report when to
        wake.  Each shard's triggers are evaluated against its own latency
        estimate; a fired shard drains only its own tenants' queues (each
        capped at its max_batch), so a backlog on shard A cannot displace
        or delay shard B's deadline-critical rows."""
        queue_rows = self.queue_rows()
        expired: list[Request] = []
        for q in self._queues.values():
            expired.extend(q.expire(now))

        by_shard: dict[int, list[tuple[str, RequestQueue]]] = {}
        for tenant, q in self._queues.items():
            if len(q):
                by_shard.setdefault(self.shard(tenant), []).append((tenant, q))

        fired: dict[int, str] = {}   # shard → trigger reason
        next_wake: float | None = None
        for shard in sorted(by_shard):
            est = self.latency_est(shard)
            reason = ""
            for tenant, q in by_shard[shard]:
                qos = self._qos_for(tenant)
                t_deadline = (
                    q.earliest_deadline() - est - self.safety_margin_s
                )
                t_wait = q.oldest_arrival() + qos.max_wait_s
                if t_deadline <= now:
                    reason = "deadline"
                    break
                if q.rows() >= qos.max_batch:
                    reason = "batch_full"
                    break
                if t_wait <= now:
                    reason = "max_wait"
                    break
                t_next = min(t_deadline, t_wait)
                next_wake = (t_next if next_wake is None
                             else min(next_wake, t_next))
            if reason:
                fired[shard] = reason

        if not fired:
            return FireDecision([], expired, "", next_wake, queue_rows, ())

        batch: list[Request] = []
        for shard in sorted(fired):
            for tenant, q in by_shard[shard]:
                batch.extend(q.take(self._qos_for(tenant).max_batch))
        # leftovers (beyond max_batch) and unfired shards exist: the
        # front end re-polls right after a fire, so they get a fresh
        # decision immediately
        shards = tuple(sorted(fired))
        return FireDecision(
            batch, expired, fired[shards[0]], None, queue_rows, shards,
            tuple((s, fired[s]) for s in shards),
        )

    def batch_fill(self, batch: list[Request]) -> float:
        """Fired rows over the fired tenants' max_batch budget (can top 1.0
        only when a single oversized request exceeds its tenant's budget)."""
        if not batch:
            return 0.0
        tenants = {r.tenant_id for r in batch}
        cap = sum(self._qos_for(t).max_batch for t in tenants)
        return sum(r.rows for r in batch) / cap
