"""Multi-host fleet serving: the tier above one process (PyTorch port of
the reference package's fleet; every host tick is one
`eval_population_spans` launch per plan shard with work).

Everything below this package serves tenants inside a single process —
`LaunchPlan` places circuits on shards, the deadline front-end places
launches in time.  This package places *tenants on hosts*:

  * `FleetPlan` / `FleetPlanner` — consistent hashing (stable under
    membership change) with an LPT override driven by observed per-
    tenant load (`plan`);
  * `ServingHost` — one cluster member, a full serving stack behind a
    flat RPC surface (`host`);
  * `Transport` seam — `InProcTransport` for deterministic tests/CI,
    `SocketTransport` + `spawn_host_process` for real runs, one wire
    codec for both (`transport`);
  * `FleetRouter` — the routed front-end: proxied submits, host
    join/leave, zero-lost cross-host migration over the persistence-
    bundle + generation-fenced `swap_plan` path (`router`);
  * `Workload` — replayable seeded traces (skew/diurnal/spike) for the
    cluster load harness (`workload`);
  * `RebalanceCadence` — periodic load-gated `rebalance()` driven by
    observed routed rows, replacing scripted mid-replay calls
    (`cadence`);
  * `FleetArtifact` / `HostConfig` — the exported shape of a whole
    cluster inside one `ArtifactStore`: circuits + fleet plan + exact
    per-host placements + stored span-launch units, so
    `FleetRouter.boot_from_artifact` restarts the fleet on the card with
    no program compiled (`artifact`).
"""
from repro_torch.serve.fleet.artifact import FleetArtifact, HostConfig
from repro_torch.serve.fleet.cadence import RebalanceCadence
from repro_torch.serve.fleet.host import ServingHost, dump_bundle, load_bundle
from repro_torch.serve.fleet.plan import FleetPlan, FleetPlanner, HashRing
from repro_torch.serve.fleet.router import FleetRouter, MigrationEvent
from repro_torch.serve.fleet.transport import (
    InProcTransport,
    SocketTransport,
    Transport,
    TransportError,
    serve_socket,
    spawn_host_process,
)
from repro_torch.serve.fleet.workload import (
    Workload,
    WorkloadEvent,
    generate,
    load_trace,
    save_trace,
)

__all__ = [
    "FleetArtifact",
    "FleetPlan",
    "FleetPlanner",
    "FleetRouter",
    "HashRing",
    "HostConfig",
    "InProcTransport",
    "MigrationEvent",
    "RebalanceCadence",
    "ServingHost",
    "SocketTransport",
    "Transport",
    "TransportError",
    "Workload",
    "WorkloadEvent",
    "dump_bundle",
    "generate",
    "load_bundle",
    "load_trace",
    "save_trace",
    "serve_socket",
    "spawn_host_process",
]
