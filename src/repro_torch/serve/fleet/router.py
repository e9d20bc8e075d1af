"""FleetRouter: the routed front-end over a set of `ServingHost`s.

The router is the only component that sees the whole cluster.  It owns
the authoritative `FleetPlan` (who serves whom), a transport per host,
and the migration machinery that moves a tenant between hosts without
losing a request:

  1. **buffer** — new submits for the tenant park router-side;
  2. **export** — the source host ships the tenant's npz+JSON bundles
     and QoS pins (`export_tenant`);
  3. **install** — the target host rehydrates them and cuts its live
     plan over through the generation-fenced `swap_plan`
     (``action="migrate_in"``);
  4. **drain** — the source host serves everything the tenant still had
     queued locally (`drain_tenant`), so nothing in flight is stranded;
  5. **cut over** — the source host drops the tenant
     (``action="migrate_out"``), the router repoints ownership and
     replays the parked submits against the new owner.

A submit that races the cutover and lands on the source host after the
tenant left fails remotely with `KeyError`; the router re-resolves the
owner and retries, so callers never see the race.  Every migration is
a `MigrationEvent` plus a ``fleet.migrate`` span on the shared trace
timeline.

Two serving paths, mirroring the single-host stack:

  * ``submit()`` → `Future`, proxied to the owning host's deadline
    front-end through a router thread pool (the transport itself is one
    serial connection per host);
  * ``replay()`` — the cluster load harness's path: consecutive trace
    chunks are grouped by owning host and served as one fused ``step``
    RPC per host per chunk, hosts in parallel.  Results come back in
    event order, which is what makes the fleet-vs-single-host parity
    criterion a bitwise array compare.

Departures from the reference: `register` ships bundles labelled with the
port's ``"torch-ref"`` where the reference writes ``"ref"`` (the label is
provenance; a bundle decodes to the same circuit either way), and
`boot_from_artifact` takes the hosts' ``device`` (``None``: the card).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Mapping, Sequence

import numpy as np

from repro_torch.serve.autoscale.controller import CounterWindow
from repro_torch.serve.circuits.registry import CircuitRegistry
from repro_torch.serve.fleet.host import dump_bundle
from repro_torch.serve.fleet.plan import FleetPlan, FleetPlanner, _plan_hash
from repro_torch.serve.fleet.transport import Transport, _ERROR_TYPES
from repro_torch.serve.fleet.workload import WorkloadEvent, chunked
from repro_torch.serve.observability.trace import NULL_TRACER, TraceRecorder

_ROUTE_RETRIES = 5


@dataclasses.dataclass(frozen=True)
class MigrationEvent:
    """One completed cross-host tenant move (the fleet-level analogue
    of the server's `RebalanceEvent`)."""

    tenant: str
    from_host: str
    to_host: str
    reason: str
    drained: int        # requests the source served during the cutover
    buffered: int       # submits parked router-side and replayed after
    duration_s: float


def _decode_step_item(item):
    """A ``step`` RPC result item: ndarray, or an error dict → the
    matching local exception instance (per-item isolation survives the
    wire)."""
    if isinstance(item, dict) and "error" in item:
        exc_cls = _ERROR_TYPES.get(item["error"], RuntimeError)
        return exc_cls(item.get("message", ""))
    return np.asarray(item)


class FleetRouter:
    """Routed front-end: one `FleetPlan`, one transport per host."""

    def __init__(
        self,
        *,
        planner: "FleetPlanner | None" = None,
        tracer: "TraceRecorder | None" = None,
        clock: Callable[[], float] = time.monotonic,
        max_workers: int = 8,
    ):
        self.planner = planner or FleetPlanner()
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.clock = clock
        self._lock = threading.RLock()
        self._transports: "dict[str, Transport]" = {}
        self._owners: "dict[str, str]" = {}     # live routing table
        self._features: "dict[str, int]" = {}   # tenant → feature width
        self._plan = FleetPlan(
            hosts=(), assignment={}, pins={}, generation=0,
            content_hash=_plan_hash((), {}, {}),
        )
        self._migrating: "dict[str, list]" = {}
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="fleet-router"
        )
        self.migrations: "list[MigrationEvent]" = []
        self.requests_routed: "dict[str, int]" = {}
        self.rows_routed = 0
        self._load_win = CounterWindow()
        self._t0 = self.clock()

    # -- membership ----------------------------------------------------
    @property
    def hosts(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._transports))

    @property
    def plan(self) -> FleetPlan:
        with self._lock:
            return self._plan

    def add_host(self, host_id: str, transport: Transport) -> FleetPlan:
        """Join a host and rebalance onto it: consistent hashing moves
        only the tenants the new host now owns, each shipped over with
        the full zero-lost migration protocol."""
        pong = transport.call("ping")
        if pong.get("host_id") != host_id:
            raise ValueError(
                f"transport answers as {pong.get('host_id')!r}, "
                f"expected {host_id!r}"
            )
        with self._lock:
            if host_id in self._transports:
                raise ValueError(f"host {host_id!r} already joined")
            self._transports[host_id] = transport
            self.requests_routed.setdefault(host_id, 0)
            hosts = tuple(sorted(self._transports))
            tenants = tuple(self._owners)
            prev = self._plan
        target = self.planner.plan(
            hosts, tenants, prev=prev, generation=prev.generation + 1
        )
        self.tracer.instant(
            "fleet.host_join", cat="fleet", track="router",
            host=host_id, n_hosts=len(hosts),
        )
        return self._transition(target, reason=f"host {host_id!r} joined")

    def remove_host(self, host_id: str) -> FleetPlan:
        """Leave a host: every tenant it owns migrates out (zero-lost),
        then the transport closes.  Survivor-to-survivor moves cannot
        happen — consistent hashing only reassigns the leaver's
        tenants."""
        with self._lock:
            if host_id not in self._transports:
                raise KeyError(f"unknown host {host_id!r}")
            if len(self._transports) == 1 and self._owners:
                raise ValueError(
                    f"cannot remove last host {host_id!r} while "
                    f"{len(self._owners)} tenant(s) are registered"
                )
            hosts = tuple(sorted(h for h in self._transports
                                 if h != host_id))
            tenants = tuple(self._owners)
            prev = self._plan
        target = self.planner.plan(
            hosts, tenants, prev=prev, generation=prev.generation + 1
        )
        plan = self._transition(target, reason=f"host {host_id!r} leaving")
        with self._lock:
            transport = self._transports.pop(host_id)
        transport.call("shutdown")
        transport.close()
        self.tracer.instant(
            "fleet.host_leave", cat="fleet", track="router",
            host=host_id, n_hosts=len(hosts),
        )
        return plan

    # -- tenants -------------------------------------------------------
    def register(self, tenant: str, circuits: Sequence,
                 qos: "dict | None" = None) -> str:
        """Register a tenant fleet-wide: the planner picks the owner,
        the bundles ship over the transport (the same path a migration
        uses — a registration is a migration from nowhere).  Returns
        the owning host id."""
        with self._lock:
            if not self._transports:
                raise RuntimeError("no hosts joined; add_host first")
            if tenant in self._owners:
                raise ValueError(f"tenant {tenant!r} already registered")
            hosts = tuple(sorted(self._transports))
            prev = self._plan
            tenants = tuple(self._owners) + (tenant,)
        target = self.planner.plan(
            hosts, tenants, prev=prev, generation=prev.generation + 1
        )
        owner = target.owner(tenant)
        backend = "torch-ref"
        with self._lock:
            transport = self._transports[owner]
        transport.call("add_tenant", {
            "tenant": tenant,
            "bundles": [dump_bundle(sc, backend) for sc in circuits],
            "qos": qos,
            "action": "add",
        })
        with self._lock:
            self._owners[tenant] = owner
            self._features[tenant] = int(circuits[0].encoder.n_features)
            self._plan = target
        return owner

    def owner_of(self, tenant: str) -> str:
        with self._lock:
            return self._owners[tenant]

    def tenants(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._owners))

    # -- serving: deadline path ---------------------------------------
    def submit(self, tenant: str, x: np.ndarray,
               *, deadline_s: "float | None" = None) -> Future:
        """Route one request to the owning host's deadline front-end.

        Returns a `concurrent.futures.Future` resolving to class ids.
        During a migration of this tenant the request parks router-side
        and replays against the new owner after the cutover."""
        with self._lock:
            if tenant not in self._owners:
                raise KeyError(f"unknown tenant {tenant!r}")
        x = np.atleast_2d(np.asarray(x, np.float32))
        fut: Future = Future()
        self._dispatch(tenant, x, deadline_s, fut)
        return fut

    def _dispatch(self, tenant: str, x: np.ndarray,
                  deadline_s: "float | None", fut: Future) -> None:
        def run():
            last_err: "Exception | None" = None
            for _ in range(_ROUTE_RETRIES):
                with self._lock:
                    parked = self._migrating.get(tenant)
                    if parked is not None:
                        parked.append((x, deadline_s, fut))
                        return
                    owner = self._owners.get(tenant)
                    transport = (self._transports.get(owner)
                                 if owner else None)
                if transport is None:
                    fut.set_exception(
                        KeyError(f"unknown tenant {tenant!r}"))
                    return
                try:
                    out = transport.call("submit", {
                        "tenant": tenant, "x": x,
                        "deadline_s": deadline_s,
                    })
                except KeyError as err:
                    # raced a cutover: the tenant left this host between
                    # owner resolution and the RPC — re-resolve and retry
                    last_err = err
                    time.sleep(0.005)
                    continue
                except Exception as err:  # noqa: BLE001 — fail the future
                    fut.set_exception(err)
                    return
                with self._lock:
                    self.requests_routed[owner] = (
                        self.requests_routed.get(owner, 0) + 1
                    )
                    self.rows_routed += int(x.shape[0])
                # the owning host's front-end request id — the handle
                # late label feedback joins back on (submit_feedback)
                fut.request_id = out.get("request_id")
                fut.set_result(np.asarray(out["y"]))
                return
            fut.set_exception(last_err or KeyError(tenant))

        self._pool.submit(run)

    # -- online evolution ----------------------------------------------
    def submit_feedback(self, tenant: str, request_id: int, labels) -> int:
        """Deliver late ground truth to the tenant's owning host
        (``request_id`` from the submit future's ``request_id``).
        Returns labeled rows accepted — 0 when the request has aged out
        of the host's cache or ownership moved since it was served."""
        with self._lock:
            owner = self._owners.get(tenant)
            transport = self._transports.get(owner) if owner else None
        if transport is None:
            raise KeyError(f"unknown tenant {tenant!r}")
        out = transport.call("feedback", {
            "tenant": tenant, "request_id": int(request_id),
            "labels": np.asarray(labels, np.int64),
        })
        return int(out.get("accepted", 0))

    def evolution_watch(self, tenant: str, **payload) -> dict:
        """Start drift-watching a tenant on its owning host."""
        with self._lock:
            owner = self._owners.get(tenant)
            transport = self._transports.get(owner) if owner else None
        if transport is None:
            raise KeyError(f"unknown tenant {tenant!r}")
        return transport.call(
            "evolution_watch", {"tenant": tenant, **payload}
        )

    def evolution_step(self) -> "dict[str, dict]":
        """Drive one evolution control-loop iteration on every host."""
        with self._lock:
            transports = dict(self._transports)
        return {h: tr.call("evolution_step", {})
                for h, tr in sorted(transports.items())}

    def evolution_report(self) -> "dict[str, dict]":
        with self._lock:
            transports = dict(self._transports)
        return {h: tr.call("evolution_report", {})
                for h, tr in sorted(transports.items())}

    # -- serving: fused replay path -----------------------------------
    def replay(
        self,
        events: "Sequence[WorkloadEvent]",
        *,
        chunk_size: int = 1024,
        on_chunk: "Callable[[int, FleetRouter], None] | None" = None,
    ) -> "list[np.ndarray | Exception]":
        """Replay a workload trace through the cluster, results in event
        order.

        Each chunk groups its events by owning host and rides one fused
        ``step`` RPC per host (hosts in parallel) — the path that makes
        a 10⁵-request trace affordable, and deterministic: per-item
        results never depend on scheduler timing.  ``on_chunk`` fires
        between chunks (chunk index, router) — the load harness's hook
        for mid-replay migrations and membership churn."""
        results: "list" = [None] * len(events)
        base = 0
        for ci, chunk in enumerate(chunked(events, chunk_size)):
            with self._lock:
                groups: "dict[str, list[tuple[int, WorkloadEvent]]]" = {}
                for off, ev in enumerate(chunk):
                    owner = self._owners[ev.tenant]
                    groups.setdefault(owner, []).append((base + off, ev))
                transports = {h: self._transports[h] for h in groups}
            with self.tracer.span(
                "fleet.router.chunk", cat="fleet", track="router",
                chunk=ci, events=len(chunk), hosts=len(groups),
            ):
                futs = {}
                for host, items in sorted(groups.items()):
                    work = [
                        [ev.tenant,
                         ev.features(self._features[ev.tenant])]
                        for _, ev in items
                    ]
                    futs[host] = self._pool.submit(
                        transports[host].call, "step", {"work": work}
                    )
                for host, items in sorted(groups.items()):
                    outs = futs[host].result()["y"]
                    for (idx, ev), item in zip(items, outs):
                        results[idx] = _decode_step_item(item)
                    with self._lock:
                        self.requests_routed[host] = (
                            self.requests_routed.get(host, 0) + len(items)
                        )
                        self.rows_routed += sum(
                            ev.rows for _, ev in items
                        )
            base += len(chunk)
            if on_chunk is not None:
                on_chunk(ci, self)
        return results

    # -- migration -----------------------------------------------------
    def migrate(self, tenant: str, to_host: str,
                reason: str = "manual") -> "MigrationEvent | None":
        """Move one tenant to ``to_host`` with the zero-lost protocol
        and pin it there (the pin survives replanning).  No-op when the
        tenant already lives there."""
        with self._lock:
            if to_host not in self._transports:
                raise KeyError(f"unknown host {to_host!r}")
            from_host = self._owners[tenant]
            if from_host == to_host:
                return None
            prev = self._plan
            assignment = dict(prev.assignment)
            pins = dict(prev.pins)
            assignment[tenant] = pins[tenant] = to_host
            self._plan = FleetPlan(
                hosts=prev.hosts, assignment=assignment, pins=pins,
                generation=prev.generation + 1,
                content_hash=_plan_hash(prev.hosts, assignment, pins),
            )
        return self._transfer(tenant, from_host, to_host, reason)

    def rebalance(self, reason: str = "load") -> "list[MigrationEvent]":
        """Replan with observed per-tenant loads (the LPT override) and
        migrate whatever moved.  The load signal is windowed rows per
        tenant summed across hosts — current traffic, not history."""
        loads = self.observed_loads()
        with self._lock:
            hosts = tuple(sorted(self._transports))
            tenants = tuple(self._owners)
            prev = self._plan
        target = self.planner.plan(
            hosts, tenants, loads=loads, prev=prev,
            generation=prev.generation + 1,
        )
        before = len(self.migrations)
        self._transition(target, reason=reason)
        return self.migrations[before:]

    def _transition(self, target: FleetPlan,
                    reason: str) -> FleetPlan:
        """Make the live cluster match ``target``: migrate every tenant
        whose owner differs, then install the plan."""
        with self._lock:
            moves = [
                (t, self._owners[t], h)
                for t, h in target.assignment.items()
                if t in self._owners and self._owners[t] != h
            ]
        for tenant, from_host, to_host in moves:
            self._transfer(tenant, from_host, to_host, reason)
        with self._lock:
            self._plan = target
        return target

    def _transfer(self, tenant: str, from_host: str,
                  to_host: str, reason: str) -> MigrationEvent:
        """The zero-lost cutover (see module docstring for the five
        steps).  Ownership repoints under the router lock only after
        the target host holds the tenant and the source has drained."""
        t0 = self.clock()
        with self._lock:
            self._migrating[tenant] = []
            src = self._transports[from_host]
            dst = self._transports[to_host]
        with self.tracer.span(
            "fleet.migrate", cat="fleet", track="router",
            tenant=tenant, src=from_host, dst=to_host, reason=reason,
        ):
            export = src.call("export_tenant", {"tenant": tenant})
            dst.call("add_tenant", {
                "tenant": tenant,
                "bundles": export["bundles"],
                "qos": export["qos"],
                "action": "migrate_in",
            })
            drained = int(
                src.call("drain_tenant", {"tenant": tenant})["drained"]
            )
            src.call("remove_tenant",
                     {"tenant": tenant, "action": "migrate_out"})
            with self._lock:
                self._owners[tenant] = to_host
                parked = self._migrating.pop(tenant)
        event = MigrationEvent(
            tenant=tenant, from_host=from_host, to_host=to_host,
            reason=reason, drained=drained, buffered=len(parked),
            duration_s=self.clock() - t0,
        )
        self.migrations.append(event)
        for x, deadline_s, fut in parked:
            self._dispatch(tenant, x, deadline_s, fut)
        return event

    # -- AOT artifacts -------------------------------------------------
    def export_fleet(self, path: str, *, spans=None) -> dict:
        """Freeze the live cluster into one bootable `FleetArtifact`.

        Three serial passes over one `ArtifactStore` at ``path``:
        every tenant's bundles ship router-side over the same
        ``export_tenant`` RPC a migration uses and land in the store's
        registry section; each host then writes its compiled launch
        executables (``export_artifact`` RPC — hosts and router must
        share the filesystem at ``path``) and reports its boot config;
        finally the fleet plan + host configs become the manifest's
        fleet section.  Returns a summary dict."""
        from repro_torch.serve.artifacts import ArtifactStore
        from repro_torch.serve.circuits.registry import TenantQoS
        from repro_torch.serve.fleet.artifact import FleetArtifact, HostConfig
        from repro_torch.serve.fleet.host import load_bundle

        with self._lock:
            transports = dict(self._transports)
            owners = dict(self._owners)
            plan = self._plan
        merged = CircuitRegistry()
        for tenant in sorted(owners):
            export = transports[owners[tenant]].call(
                "export_tenant", {"tenant": tenant}
            )
            merged.add_ensemble(
                tenant,
                [load_bundle(raw) for raw in export["bundles"]],
                qos=TenantQoS(**export["qos"]),
            )
        store = ArtifactStore(path)
        store.put_registry(merged)
        host_configs: "dict[str, HostConfig]" = {}
        exported = 0
        for host_id, transport in sorted(transports.items()):
            out = transport.call("export_artifact", {
                "path": path,
                "spans": None if spans is None else [int(s) for s in spans],
            })
            host_configs[host_id] = HostConfig.from_manifest(
                host_id, out["config"]
            )
            exported += len(out["exported"])
        artifact = FleetArtifact(
            generation=plan.generation,
            content_hash=plan.content_hash,
            hosts=tuple(sorted(transports)),
            assignment=dict(owners),
            pins={t: h for t, h in plan.pins.items() if t in owners},
            host_configs=host_configs,
        )
        # reopen: each export_artifact RPC appended executables through
        # its own store handle, so this handle's manifest is stale — a
        # flush from it would wipe their entries
        artifact.save(ArtifactStore(path))
        self.tracer.instant(
            "fleet.export", cat="fleet", track="router",
            path=path, tenants=len(merged), hosts=len(host_configs),
            executables=exported,
        )
        return {
            "path": path,
            "tenants": len(merged),
            "hosts": len(host_configs),
            "executables": exported,
        }

    @classmethod
    def boot_from_artifact(
        cls,
        path: str,
        *,
        device: "str | None" = None,
        transport_factory: "Callable | None" = None,
        planner: "FleetPlanner | None" = None,
        tracer: "TraceRecorder | None" = None,
        clock: Callable[[], float] = time.monotonic,
        max_workers: int = 8,
        start_hosts: bool = True,
    ) -> "FleetRouter":
        """Boot a whole cluster from a `FleetArtifact` — the cold-start
        path: no fitting, no migrations, and on the card no program
        compiled (the hosts load the stored span-launch units).

        By default every host boots in-process
        (`ServingHost.boot_from_artifact` behind an `InProcTransport`).
        ``transport_factory(host_id, path, host_config) → Transport``
        overrides that for real deployments where each host process
        boots itself from the shared artifact and the router merely
        connects.  The routing table installs verbatim from the exported
        plan — ownership, pins and plan generation come back exactly,
        with no re-derivation that could shuffle deliberately migrated
        tenants."""
        from repro_torch.serve.artifacts import ArtifactStore
        from repro_torch.serve.fleet.artifact import FleetArtifact

        store = ArtifactStore(path)
        artifact = FleetArtifact.load(store)
        router = cls(
            planner=planner, tracer=tracer, clock=clock,
            max_workers=max_workers,
        )
        for host_id in artifact.hosts:
            if transport_factory is not None:
                transport = transport_factory(
                    host_id, path, artifact.host_configs[host_id]
                )
            else:
                from repro_torch.serve.fleet.host import ServingHost
                from repro_torch.serve.fleet.transport import InProcTransport

                host = ServingHost.boot_from_artifact(
                    host_id, path, device=device, tracer=tracer, clock=clock
                )
                if start_hosts:
                    host.start()
                transport = InProcTransport(host)
            pong = transport.call("ping")
            if pong.get("host_id") != host_id:
                raise ValueError(
                    f"transport answers as {pong.get('host_id')!r}, "
                    f"expected {host_id!r}"
                )
            with router._lock:
                router._transports[host_id] = transport
                router.requests_routed.setdefault(host_id, 0)
        registry = store.load_registry()
        with router._lock:
            router._owners = dict(artifact.assignment)
            router._features = {
                t: int(registry.get(t).encoder.n_features)
                for t in artifact.assignment
            }
            router._plan = FleetPlan(
                hosts=tuple(artifact.hosts),
                assignment=dict(artifact.assignment),
                pins=dict(artifact.pins),
                generation=artifact.generation,
                content_hash=artifact.content_hash,
            )
        router.tracer.instant(
            "fleet.boot", cat="fleet", track="router",
            path=path, hosts=len(artifact.hosts),
            tenants=len(artifact.assignment),
        )
        return router

    # -- telemetry -----------------------------------------------------
    def host_stats(self) -> "dict[str, dict]":
        """One ``stats`` RPC per host (serial; telemetry cadence is not
        a hot path)."""
        with self._lock:
            transports = dict(self._transports)
        return {h: tr.call("stats") for h, tr in sorted(transports.items())}

    def observed_loads(self) -> "dict[str, float]":
        """Windowed rows served per tenant since the last call, summed
        across hosts — the `FleetPlanner`'s LPT input."""
        totals: "dict[str, float]" = {}
        for stats in self.host_stats().values():
            for tenant, rows in stats.get("tenant_rows", {}).items():
                totals[tenant] = totals.get(tenant, 0.0) + float(rows)
        return {
            t: self._load_win.delta(t, total)
            for t, total in sorted(totals.items())
        }

    def report(self) -> dict:
        """Fleet-level snapshot: the Prometheus exporter's ``fleet=``
        input and the benchmark's record body."""
        now = self.clock()
        host_stats = self.host_stats()
        with self._lock:
            routed = dict(self.requests_routed)
            elapsed = max(now - self._t0, 1e-9)
            router = {
                "requests_routed": sum(routed.values()),
                "rows_routed": self.rows_routed,
                "qps": round(sum(routed.values()) / elapsed, 2),
                "migrations": len(self.migrations),
                "n_hosts": len(self._transports),
                "n_tenants": len(self._owners),
                "plan_generation": self._plan.generation,
            }
        hosts = {}
        for h, stats in host_stats.items():
            hosts[h] = {
                "requests_routed": routed.get(h, 0),
                "queue_rows": stats.get("queue_rows", 0),
                "tenants": len(self._plan.tenants_of(h)),
                "migrations_in": stats.get("migrations_in", 0),
                "migrations_out": stats.get("migrations_out", 0),
                "qps": stats.get("server", {}).get("qps", 0.0),
                "rows_served": sum(
                    stats.get("tenant_rows", {}).values()
                ),
            }
        return {"router": router, "hosts": hosts}

    def reset_stats(self) -> None:
        """Zero router counters and every host's stats — benchmark
        warmup boundary."""
        with self._lock:
            transports = dict(self._transports)
            self.requests_routed = {h: 0 for h in transports}
            self.rows_routed = 0
            self._t0 = self.clock()
        for tr in transports.values():
            tr.call("reset_stats")

    # -- lifecycle -----------------------------------------------------
    def close(self, *, shutdown_hosts: bool = True) -> None:
        with self._lock:
            transports = dict(self._transports)
            self._transports.clear()
        for tr in transports.values():
            if shutdown_hosts:
                try:
                    tr.call("shutdown")
                except Exception:  # noqa: BLE001 — best-effort teardown
                    pass
            tr.close()
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
