"""ServingHost: one cluster member, addressable only through RPCs.

A host owns one `CircuitRegistry` + `CircuitServer` +
`AsyncCircuitServer` stack and exposes it as a flat
``handle(method, payload)`` surface — the single entry point both
transports dispatch into.  Everything a router needs to run a cluster
is a method here:

  * ``submit`` / ``step`` — serve requests (deadline path / fused
    synchronous replay path);
  * ``add_tenant`` / ``remove_tenant`` — tenant arrival and departure,
    each cutting the live plan over through the generation-fenced
    `swap_plan` (actions ``migrate_in`` / ``migrate_out`` on the
    `RebalanceEvent` stream, so migrations are first-class citizens of
    the same audit trail autoscaling writes);
  * ``export_tenant`` / ``drain_tenant`` — the migration halves: ship
    the tenant's npz bundles + QoS out, and serve everything it still
    has queued *here* before ownership moves, so a cutover loses
    nothing;
  * ``stats`` / ``ping`` / ``tenants`` — telemetry the router's
    planner and the Prometheus exporter read.

Payloads are plain dicts with numpy/bytes leaves (the transport codec's
domain); no method signature mentions a socket, which is what keeps the
in-process and subprocess deployments behaviorally identical.

Departures from the reference: `ServingHost` and `boot_from_artifact`
take ``device`` where the reference takes ``backend`` (``None``: the
card, raising `NoCudaDeviceError` without one; ``"cpu"``: the plain
versions).  `enable_evolution` gives the manager a `RefitConfig` on the
host's own device unless the caller passes one (the reference's default
config is the reference's default backend, the port's default is the
card), and starts its refit worker's process there, so a host's first
``evolution_watch`` pays the child's boot instead of the first refit.
The ``stats`` RPC reads the queue through the front end's lock, as the
port's other readers of scheduler state do.  Exported units are
span-launch units (`repro_torch.runtime.aot`).
"""
from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.api import ServableCircuit, load_servable, save_servable
from repro_torch.serve.async_frontend.frontend import AsyncCircuitServer
from repro_torch.serve.circuits.metrics import FrontendStats
from repro_torch.serve.circuits.registry import CircuitRegistry, TenantQoS
from repro_torch.serve.circuits.server import CircuitServer, StalePlanError
from repro_torch.serve.fleet.artifact import FleetArtifact, HostConfig
from repro_torch.serve.observability.trace import TraceRecorder
from repro_torch.serve.planning import DEFAULT_POLICY, PlacementPolicy

_SWAP_RETRIES = 8

_log = logging.getLogger("repro_torch.serve.aot")


def load_bundle(raw: bytes) -> ServableCircuit:
    """Rehydrate a `ServableCircuit` from in-flight bundle bytes.

    The npz format is file-shaped, so the bytes touch a temp file for
    the duration of one `load` — the cost of reusing the persistence
    format (and its validation) as the migration wire format."""
    fd, path = tempfile.mkstemp(suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(raw)
        return load_servable(path)
    finally:
        os.unlink(path)


def dump_bundle(circuit: ServableCircuit, backend: str = "torch-ref") -> bytes:
    """A `ServableCircuit` as in-flight bundle bytes (the npz format,
    ``validated_backend`` recorded as ``backend``)."""
    fd, path = tempfile.mkstemp(suffix=".npz")
    os.close(fd)
    try:
        save_servable(circuit, path, validated_backend=backend)
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)


class ServingHost:
    """One serving process behind the transport seam."""

    def __init__(
        self,
        host_id: str,
        registry: CircuitRegistry,
        *,
        device: "str | torch.device | None" = None,
        policy: "PlacementPolicy | None" = None,
        tracer: "TraceRecorder | None" = None,
        clock: Callable[[], float] = time.monotonic,
        latency_est_s: float = 0.0,
    ):
        self.host_id = host_id
        self.registry = registry
        self.server = CircuitServer(
            registry, device=device, policy=policy or DEFAULT_POLICY,
            tracer=tracer,
        )
        self.frontend = AsyncCircuitServer(
            self.server, clock=clock, latency_est_s=latency_est_s
        )
        self.tracer = self.server.tracer
        self.migrations_in = 0
        self.migrations_out = 0
        self.evolution = None  # EvolutionManager, once enabled
        self._started = False

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "ServingHost":
        """Start the deadline scheduler's thread (needed for ``submit``; the
        fused ``step`` path works without it)."""
        if not self._started:
            self.frontend.start()
            self._started = True
        return self

    def stop(self) -> None:
        if self._started:
            self.frontend.stop(drain=True)
            self._started = False
        if self.evolution is not None:
            self.evolution.stop()

    def enable_evolution(self, **kwargs):
        """Construct this host's `EvolutionManager` (idempotent); kwargs
        pass through to its constructor (drift=, refit=, policy=, ...).
        Without ``refit=`` the refit searches on the host's device; a
        background worker's process starts here."""
        if self.evolution is None:
            from repro_torch.serve.evolution import EvolutionManager, RefitConfig

            kwargs.setdefault("refit", RefitConfig(device=self.server.device))
            self.evolution = EvolutionManager(self.frontend, **kwargs)
            if not self.evolution.worker.synchronous:
                self.evolution.worker.start()
        return self.evolution

    def __enter__(self) -> "ServingHost":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- AOT artifacts -------------------------------------------------
    def host_config(self) -> HostConfig:
        """This host's serving shape for a `FleetArtifact`: backend,
        shard policy, the *exact* live placement (possibly a sticky-
        recompiled layout no fresh compile would reproduce), and the
        span buckets traffic actually used."""
        plan = self.server.plan()
        return HostConfig(
            host_id=self.host_id,
            backend=self.server.backend.name,
            n_shards=self.server.policy.n_shards,
            span_align=self.server.span_align,
            assignment_mode=self.server.policy.assignment,
            stable_shapes=self.server.stable_shapes,
            tenants=tuple(self.registry),
            placement={
                t: tuple((ref.shard, ref.slot) for ref in refs)
                for t, refs in plan.placement.items()
            },
            spans=self.server.spans_seen(),
        )

    def export_artifact(self, store, *, spans=None) -> HostConfig:
        """Persist this host's compiled launches into ``store`` and
        return the config a `boot_from_artifact` needs to rebuild it.
        On a no-AOT backend no executables are stored (the boot falls
        back to trace-on-boot, reason logged by the server)."""
        self.server.export_executables(store, spans=spans)
        return self.host_config()

    @classmethod
    def boot_from_artifact(
        cls,
        host_id: str,
        path: str,
        *,
        device: "str | torch.device | None" = None,
        tracer: "TraceRecorder | None" = None,
        clock: Callable[[], float] = time.monotonic,
        latency_est_s: float = 0.0,
    ) -> "ServingHost":
        """Reconstruct one fleet member from a `FleetArtifact` on
        ``device`` with no program compiled on the card: circuits load
        from the store, the exported placement recompiles byte-identically
        (same shard content hashes), and the stored span-launch units load
        straight into the launch cache.  A placement the stored circuits no
        longer satisfy falls back to a fresh compile; mismatched or
        corrupt executables fall back to compiling — both logged, never
        fatal."""
        from repro_torch.serve.artifacts import ArtifactStore

        store = ArtifactStore(path)
        art = FleetArtifact.load(store)
        cfg = art.host_configs.get(host_id)
        if cfg is None:
            raise KeyError(
                f"fleet artifact at {path!r} has no host {host_id!r} "
                f"(hosts: {sorted(art.host_configs)})"
            )
        full = store.load_registry()
        registry = CircuitRegistry()
        for tenant in cfg.tenants:  # registration order preserved
            registry.add_ensemble(
                tenant, full.members(tenant), qos=full.qos(tenant)
            )
        host = cls(
            host_id, registry,
            device=device,
            policy=PlacementPolicy(
                n_shards=cfg.n_shards, span_align=cfg.span_align,
                assignment=cfg.assignment_mode,
            ),
            tracer=tracer, clock=clock, latency_est_s=latency_est_s,
        )
        server = host.server
        try:
            compiled = server.compiler.compile_from_placement(
                registry.catalog(),
                {t: [list(p) for p in pairs]
                 for t, pairs in cfg.placement.items()},
                cfg.n_shards,
            )
            server.swap_plan(
                compiled, action="boot", reason="artifact", prewarm=False
            )
        except (ValueError, StalePlanError) as err:
            _log.warning(
                "host %r: exported placement unusable (%s: %s); booting "
                "with a fresh compile — persisted executables whose shard "
                "hashes no longer match will recompile",
                host_id, type(err).__name__, err,
            )
            server.plan()
        server.preload_executables(store)
        return host

    # -- plan cutover --------------------------------------------------
    def _swap(self, action: str, reason: str) -> None:
        """Recompile the current catalog and install it through the
        generation-fenced swap, retrying when a concurrent registry
        mutation outruns the compile."""
        for _ in range(_SWAP_RETRIES):
            compiled = self.server.compiler.recompile(
                self.registry.catalog(), self.server.peek_plan()
            )
            try:
                self.server.swap_plan(compiled, action=action, reason=reason)
                return
            except StalePlanError:
                continue
        raise StalePlanError(
            f"host {self.host_id!r}: registry outran {_SWAP_RETRIES} "
            f"recompile attempts during {action!r}"
        )

    # -- RPC surface ---------------------------------------------------
    def handle(self, method: str, payload: dict):
        """Dispatch one RPC.  Exceptions propagate to the transport,
        which envelopes them for the wire (socket) or lets them raise
        in the caller (in-process)."""
        fn = getattr(self, f"_rpc_{method}", None)
        if fn is None:
            raise ValueError(
                f"host {self.host_id!r}: unknown RPC method {method!r}"
            )
        return fn(payload)

    def _rpc_ping(self, payload: dict) -> dict:
        return {
            "host_id": self.host_id,
            "backend": self.server.backend.name,
            "n_tenants": len(self.registry),
        }

    def _rpc_tenants(self, payload: dict) -> dict:
        return {"tenants": sorted(self.registry)}

    def _rpc_stats(self, payload: dict) -> dict:
        return {
            "host_id": self.host_id,
            "server": self.server.stats.report(),
            "frontend": self.frontend.stats.report(),
            "queue_rows": self.frontend.queue_rows(),
            "tenant_rows": {
                t: int(r) for t, r in self.server.stats.tenant_rows.items()
            },
            "migrations_in": self.migrations_in,
            "migrations_out": self.migrations_out,
        }

    def _rpc_reset_stats(self, payload: dict) -> dict:
        self.server.reset_stats()
        self.frontend.stats = FrontendStats(
            backend=self.server.backend.name
        )
        return {"ok": True}

    def _rpc_submit(self, payload: dict) -> dict:
        """Deadline-path serve: enqueue + block on the future.  The
        transport's per-host serialization makes this a synchronous RPC;
        the router restores asynchrony with its own thread pool."""
        fut = self.frontend.enqueue(
            payload["tenant"],
            np.asarray(payload["x"], np.float32),
            deadline_s=payload.get("deadline_s"),
        )
        return {"y": fut.result(timeout=payload.get("timeout_s", 60.0)),
                "request_id": fut.request_id}

    def _rpc_step(self, payload: dict) -> dict:
        """Fused synchronous serve: the whole chunk rides one
        `CircuitServer.step` (one launch per plan shard) — the replay
        path that makes 10⁵-request traces affordable.  Per-item errors
        come back as error dicts in position, not a failed RPC."""
        work = [
            (str(tenant), np.asarray(x, np.float32))
            for tenant, x in payload["work"]
        ]
        with self.tracer.span(
            "fleet.host.step", cat="fleet", track=f"host:{self.host_id}",
            items=len(work), rows=sum(x.shape[0] for _, x in work),
        ):
            outs = self.server.step(work)
        return {"y": [
            {"error": type(o).__name__, "message": str(o)}
            if isinstance(o, Exception) else o
            for o in outs
        ]}

    def _rpc_add_tenant(self, payload: dict) -> dict:
        """Install a tenant from its persistence bundles and cut the
        plan over (action ``migrate_in`` when this is a migration)."""
        tenant = payload["tenant"]
        circuits = [load_bundle(raw) for raw in payload["bundles"]]
        qos = payload.get("qos")
        self.registry.add_ensemble(
            tenant, circuits,
            replace=bool(payload.get("replace", False)),
            qos=TenantQoS(**qos) if qos else None,
        )
        action = payload.get("action", "add")
        if action == "migrate_in":
            self.migrations_in += 1
        self._swap(action, f"tenant {tenant!r} -> {self.host_id}")
        self.tracer.instant(
            "fleet.tenant_in", cat="fleet", track=f"host:{self.host_id}",
            tenant=tenant, members=len(circuits), action=action,
        )
        return {"generation": self.registry.generation,
                "n_tenants": len(self.registry)}

    def _rpc_remove_tenant(self, payload: dict) -> dict:
        tenant = payload["tenant"]
        self.registry.remove(tenant)
        action = payload.get("action", "remove")
        if action == "migrate_out":
            self.migrations_out += 1
        self._swap(action, f"tenant {tenant!r} <- {self.host_id}")
        self.tracer.instant(
            "fleet.tenant_out", cat="fleet", track=f"host:{self.host_id}",
            tenant=tenant, action=action,
        )
        return {"generation": self.registry.generation,
                "n_tenants": len(self.registry)}

    def _rpc_export_tenant(self, payload: dict) -> dict:
        """The outbound half of a migration: the tenant's member bundles
        (bit-identical to its registered circuits) plus its QoS pins."""
        tenant = payload["tenant"]
        members = self.registry.members(tenant)  # KeyError if unknown
        backend = self.server.backend.name
        return {
            "tenant": tenant,
            "bundles": [dump_bundle(sc, backend) for sc in members],
            "qos": dataclasses.asdict(self.registry.qos(tenant)),
        }

    def _rpc_drain_tenant(self, payload: dict) -> dict:
        """Serve everything the tenant still has queued *on this host* —
        called between traffic cutover and removal so no request ever
        rides a registry the tenant has left."""
        tenant = payload["tenant"]
        with self.frontend._lock:
            reqs = self.frontend.scheduler.pending_for(tenant)
        if reqs:
            outs = self.server.step(
                [(r.tenant_id, r.features) for r in reqs]
            )
            done = self.frontend.clock()
            for req, out in zip(reqs, outs):
                self.frontend.stats.record_request(
                    done - req.submitted_at, late=done > req.deadline
                )
                if isinstance(out, Exception):
                    req.future.set_exception(out)
                else:
                    req.future.set_result(out)
        return {"drained": len(reqs)}

    # -- online evolution ----------------------------------------------
    def _rpc_evolution_watch(self, payload: dict) -> dict:
        """Start drift-watching a tenant on this host (enables the
        evolution loop with default configs on first use)."""
        mgr = self.enable_evolution(
            synchronous_refit=bool(payload.get("synchronous_refit", False))
        )
        ref = payload.get("reference")
        mgr.watch(
            payload["tenant"],
            reference=None if ref is None else np.asarray(ref, np.float32),
            accuracy_baseline=payload.get("accuracy_baseline"),
        )
        return {"watched": list(mgr.watched())}

    def _rpc_feedback(self, payload: dict) -> dict:
        """Late ground-truth delivery for a served request (the id the
        ``submit`` response carried)."""
        if self.evolution is None:
            return {"accepted": 0}
        accepted = self.evolution.submit_feedback(
            payload["tenant"], int(payload["request_id"]), payload["labels"]
        )
        return {"accepted": accepted}

    def _rpc_evolution_step(self, payload: dict) -> dict:
        """One control-loop iteration (routers drive the cadence)."""
        if self.evolution is None:
            return {"enabled": False}
        summary = self.evolution.step()
        return {"enabled": True,
                **{k: [list(v) if isinstance(v, tuple) else v
                       for v in vals]
                   for k, vals in summary.items()}}

    def _rpc_evolution_report(self, payload: dict) -> dict:
        if self.evolution is None:
            return {"enabled": False}
        return {"enabled": True, "host_id": self.host_id,
                **self.evolution.report()}

    def _rpc_export_artifact(self, payload: dict) -> dict:
        """Write this host's executables into the artifact store at
        ``payload["path"]`` (a path both ends can see — artifact export
        assumes a shared filesystem) and return its boot config."""
        from repro_torch.serve.artifacts import ArtifactStore

        store = ArtifactStore(payload["path"])
        keys = self.server.export_executables(
            store, spans=payload.get("spans")
        )
        return {
            "config": self.host_config().to_manifest(),
            "exported": list(keys),
        }

    def _rpc_shutdown(self, payload: dict) -> dict:
        self.stop()
        return {"ok": True}
