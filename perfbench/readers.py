"""Arithmetic that several metric readers share."""
from __future__ import annotations

import math

from perfbench import work

# a failed request misses every limit; its latency reads as this
MISSED_MS = 1e6


def per(total: float, count: float, scale: float = 1.0) -> "float | None":
    return None if not count else scale * total / count


def phase_ms(run, phases, count_key: str) -> "float | None":
    """Milliseconds of the program's own clock over ``phases``, per count."""
    if not run.phases:
        return None
    return per(sum(run.phases.get(p, 0.0) for p in phases),
               run.counters.get(count_key, 0), 1e3)


def idle_share_pct(run) -> "float | None":
    """Per cent of the traced window in which no operation ran on the card."""
    t = run.trace
    if t is None or not t.ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def roofline_pct(run) -> "float | None":
    """Per cent of the card's least time that the launches of the cell's
    kernel took: the mean least time of the window's launches over the mean
    device time of those the trace holds.  Where the profiler lost the
    records of a few launches, the traced ones stand for all; with every
    launch traced this is their bounds summed over their times summed."""
    if run.trace is None or not run.launch_bounds_s:
        return None
    times = run.trace.durations_s(run.kernel)
    if not times:
        return None
    bound = sum(run.launch_bounds_s) / len(run.launch_bounds_s)
    return 100.0 * bound / (sum(times) / len(times))


def mfu_pct(run) -> "float | None":
    """Per cent of the card's INT32 peak over the traced window that the
    logic the window's launches needed would fill."""
    t = run.trace
    if t is None or not run.ops or t.window_s <= 0:
        return None
    return 100.0 * run.ops / (t.window_s * work.INT32_OPS_PER_S)


def p95_ms(latencies_s) -> "float | None":
    """The 95th percentile (nearest rank) of request latencies in ms; a
    failed request (infinite latency) misses every limit."""
    if not latencies_s:
        return None
    lat = sorted(latencies_s)
    v = lat[math.ceil(0.95 * len(lat)) - 1]
    return MISSED_MS if math.isinf(v) else 1e3 * v
