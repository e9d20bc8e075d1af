"""FleetPlan: tenant → host placement for a routed serving cluster.

The hierarchical tier above `repro_torch.serve.planning`: a `LaunchPlan`
says which *slot of which shard* a circuit occupies inside one process; a
`FleetPlan` says which *host* owns the tenant in the first place.  Two
forces shape it:

  * **Consistent hashing** is the base layout.  Each host projects
    ``vnodes`` points onto a hash ring and a tenant belongs to the first
    host point clockwise of its own hash.  The payoff is *stability
    under membership change*: when a host joins, the only tenants that
    move are the ones the new host now owns; when a host leaves, the
    only tenants that move are the ones it owned — a tenant is never
    shuffled between two surviving hosts.  With ``K`` tenants on ``n``
    hosts a join/leave relocates ~``K/n`` of them, not all of them
    (pinned by the hypothesis suite in ``tests/test_torch_fleet_properties``).
  * **LPT override** corrects what hashing cannot see: load.  Given
    observed per-tenant row loads (windowed from each host's
    `ServerStats.tenant_rows`, the same telemetry the autoscaler
    windows per shard), the planner greedily moves the heaviest movable
    tenants off the most loaded host until no move still helps — each
    move recorded as a *pin* that overrides the ring.  Pins survive
    replanning while their tenant and host survive, so a migration is
    never silently undone by the next membership change.

Everything here is a pure decision core: no sockets, no hosts, no
clock.  The `FleetRouter` owns the live cluster and asks the planner
what the layout *should* be; shipping bundles and cutting traffic over
is the router's job.

The port's own copy of the reference's planner: ring points, plan hashes
and LPT moves are the reference's, bit for bit.
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
from typing import Mapping, Sequence


def _point(label: str) -> int:
    """Deterministic 64-bit ring position (stable across processes and
    Python hash randomization — this is a placement contract, not a
    hash table)."""
    return int.from_bytes(
        hashlib.sha256(label.encode()).digest()[:8], "big"
    )


class HashRing:
    """Consistent-hash ring with ``vnodes`` virtual points per host
    (256 keeps the per-host share within a few percent of fair)."""

    def __init__(self, hosts: Sequence[str], *, vnodes: int = 256):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.hosts = tuple(sorted(set(hosts)))
        self.vnodes = int(vnodes)
        points = []
        for host in self.hosts:
            points.extend(
                (_point(f"{host}#{v}"), host) for v in range(self.vnodes)
            )
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [h for _, h in points]

    def owner(self, tenant: str) -> str:
        """The host owning ``tenant``: first ring point clockwise of the
        tenant's hash (wrapping past the top)."""
        if not self._points:
            raise ValueError("hash ring has no hosts")
        i = bisect.bisect_right(self._points, _point(tenant))
        return self._owners[i % len(self._owners)]


@dataclasses.dataclass(frozen=True)
class FleetPlan:
    """Immutable tenant → host assignment for one cluster membership.

    ``pins`` is the subset of ``assignment`` that overrides the hash
    ring (LPT moves and explicit migrations); everything else follows
    consistent hashing over ``hosts``.  ``generation`` is the router's
    monotonic plan counter; ``content_hash`` addresses the assignment by
    value, mirroring `CompiledPlan.content_hash` one tier down."""

    hosts: tuple[str, ...]
    assignment: Mapping[str, str]
    pins: Mapping[str, str]
    generation: int
    content_hash: str

    @property
    def tenants(self) -> tuple[str, ...]:
        return tuple(self.assignment)

    @property
    def n_hosts(self) -> int:
        return len(self.hosts)

    def owner(self, tenant: str) -> str:
        """Owning host (KeyError for tenants not in the plan)."""
        return self.assignment[tenant]

    def tenants_of(self, host: str) -> tuple[str, ...]:
        return tuple(
            t for t, h in self.assignment.items() if h == host
        )


def _plan_hash(hosts, assignment, pins) -> str:
    h = hashlib.sha256()
    h.update(repr((
        tuple(hosts),
        tuple(sorted(assignment.items())),
        tuple(sorted(pins.items())),
    )).encode())
    return h.hexdigest()


class FleetPlanner:
    """Pure placement policy: (hosts, tenants, loads, prior pins) → plan.

    ``imbalance_high`` arms the LPT override: while the most loaded
    host carries more than ``imbalance_high ×`` the mean host load, the
    heaviest tenant whose move actually reduces the maximum is pinned to
    the least loaded host.  Ties everywhere break by name, so two
    planners fed the same inputs emit byte-identical plans — equal
    loads leave the override nothing but tie-breaks, and those are
    deterministic."""

    def __init__(self, *, vnodes: int = 256, imbalance_high: float = 1.25):
        if imbalance_high < 1.0:
            raise ValueError(
                f"imbalance_high must be >= 1.0, got {imbalance_high}"
            )
        self.vnodes = int(vnodes)
        self.imbalance_high = float(imbalance_high)

    def plan(
        self,
        hosts: Sequence[str],
        tenants: Sequence[str],
        *,
        loads: "Mapping[str, float] | None" = None,
        prev: "FleetPlan | None" = None,
        generation: int = 0,
    ) -> FleetPlan:
        """Compute the assignment for one membership + tenant set.

        Pins are carried from ``prev`` while both their tenant and their
        host survive; ``loads`` (observed rows per tenant over a
        telemetry window) enables the LPT override — without it the plan
        is pure consistent hashing plus carried pins."""
        ring = HashRing(hosts, vnodes=self.vnodes)
        live = set(ring.hosts)
        pins: dict[str, str] = {}
        if prev is not None:
            pins = {
                t: h for t, h in prev.pins.items()
                if t in set(tenants) and h in live
            }
        assignment = {
            t: pins.get(t, ring.owner(t)) for t in sorted(tenants)
        }
        if loads:
            for t, h in self._lpt_moves(assignment, loads):
                assignment[t] = pins[t] = h
        return FleetPlan(
            hosts=ring.hosts,
            assignment=assignment,
            pins=pins,
            generation=generation,
            content_hash=_plan_hash(ring.hosts, assignment, pins),
        )

    def _lpt_moves(
        self, assignment: Mapping[str, str], loads: Mapping[str, float]
    ) -> list[tuple[str, str]]:
        """Greedy longest-processing-time correction: moves (tenant,
        to_host) that shrink the maximum host load, heaviest first."""
        hosts = sorted(set(assignment.values()))
        if len(hosts) < 2:
            return []
        host_load = {h: 0.0 for h in hosts}
        by_host: dict[str, list[str]] = {h: [] for h in hosts}
        for t, h in sorted(assignment.items()):
            host_load[h] += float(loads.get(t, 0.0))
            by_host[h].append(t)
        mean = sum(host_load.values()) / len(hosts)
        moves: list[tuple[str, str]] = []
        for _ in range(len(assignment)):
            # ties break toward the *name* so equal loads stay put
            busy = max(hosts, key=lambda h: (host_load[h], h))
            idle = min(hosts, key=lambda h: (host_load[h], h))
            if mean <= 0 or host_load[busy] <= self.imbalance_high * mean:
                break
            gap = host_load[busy] - host_load[idle]
            # heaviest tenant whose move still lowers the maximum: after
            # the move the donor drops by w and the recipient rises by w,
            # so any 0 < w < gap is an improvement; prefer the largest
            candidates = sorted(
                (t for t in by_host[busy]
                 if 0.0 < float(loads.get(t, 0.0)) < gap),
                key=lambda t: (-float(loads.get(t, 0.0)), t),
            )
            if not candidates:
                break
            t = candidates[0]
            w = float(loads.get(t, 0.0))
            by_host[busy].remove(t)
            by_host[idle].append(t)
            host_load[busy] -= w
            host_load[idle] += w
            moves.append((t, idle))
        return moves
