"""Multi-tenant circuit serving: catalog → compiled plans → fused launches.

Many fitted tiny classifiers (tenants — optionally k-member voting
ensembles) share one `eval_population_spans` launch per plan shard per
serving tick.  See `registry` (the catalog: hot add/remove, ensembles,
QoS), `repro_torch.serve.planning` (PlacementPolicy → PlanCompiler →
LaunchPlan shards), `server` (the micro-batching engine, with the
generation-fenced `swap_plan`, shadow slots and span-launch units) and
`metrics` (QPS / latency / occupancy / rebalance reports, and the async
front end's request-level `FrontendStats`).
"""
from repro_torch.serve.circuits.metrics import (
    FrontendStats,
    RebalanceEvent,
    ServerStats,
    TickReport,
)
from repro_torch.serve.circuits.registry import (
    DEFAULT_QOS,
    CircuitRegistry,
    TenantQoS,
)
from repro_torch.serve.circuits.server import CircuitServer, StalePlanError

__all__ = [
    "DEFAULT_QOS",
    "CircuitRegistry",
    "CircuitServer",
    "FrontendStats",
    "RebalanceEvent",
    "ServerStats",
    "StalePlanError",
    "TenantQoS",
    "TickReport",
]
