"""Plan-aware autoscaling: online shard rebalancing from live telemetry.

An `AutoscaleController` windows the serving stack's own telemetry
(per-shard occupancy, scheduler latency EWMAs, deadline misses), a
pluggable `AutoscalePolicy` decides when the layout no longer fits the
traffic, and the controller installs an incrementally recompiled plan
through the server's generation-fenced `swap_plan` — in-flight launches
finish on the old plan, queued requests land on the new one, and
content-hash caching keeps unchanged shards' device state (their
span-launch units on the card) across the swap.
"""
from repro_torch.serve.autoscale.controller import (
    AutoscaleController,
    CounterWindow,
    carry_map,
)
from repro_torch.serve.autoscale.policy import (
    AutoscaleDecision,
    AutoscalePolicy,
    HysteresisPolicy,
    ShardTelemetry,
)

__all__ = [
    "AutoscaleController",
    "CounterWindow",
    "AutoscaleDecision",
    "AutoscalePolicy",
    "HysteresisPolicy",
    "ShardTelemetry",
    "carry_map",
]
