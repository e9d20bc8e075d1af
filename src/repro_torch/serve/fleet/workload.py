"""Replayable workload traces for the cluster load harness.

A workload is a time-ordered list of `WorkloadEvent`s — *(arrival time,
tenant, rows, feature seed)*.  The file format deliberately stores the
seed instead of the feature matrix: 10⁵–10⁶ requests of committed float
data would be megabytes of noise in the repo, but a seed regenerates
the exact same `float32` rows on every machine, which is what makes the
acceptance criterion ("fleet replay bitwise-identical to a single-host
replay") checkable at all.  Generators are committed tooling; traces
are artifacts you can regenerate from (shape, seed) or commit when they
gate CI (the small `benchmarks/workloads/fleet_smoke.jsonl.gz` trace).
The port's own copy of the reference's generator and format: a trace
either package generates or saves is the other's, byte for byte.

Three load shapes, all driven by a rate profile r(t) on a fixed grid
and inverted through its CDF so event *counts* are exact and arrival
*times* follow the profile:

  * ``skew``    — flat in time, Zipf-ish across tenants: a few tenants
    carry most rows, the long tail idles.  This is the shape that makes
    consistent hashing insufficient and the LPT override earn its keep.
  * ``diurnal`` — one sinusoidal day compressed into the trace span.
  * ``spike``   — low plateau with a burst window at mid-trace.

File format ("fleet-workload-v1"): gzip'd JSONL, first line a meta
object (format tag, shape, seed, counts), then one ``[t, tenant, rows,
seed]`` row per event.  Human-greppable, diffable, and append-streamed
on write so a million-event trace never sits in memory twice.
"""
from __future__ import annotations

import dataclasses
import gzip
import json
import os
from typing import Iterable, Sequence

import numpy as np

FORMAT = "fleet-workload-v1"


@dataclasses.dataclass(frozen=True)
class WorkloadEvent:
    """One request arrival: ``rows`` feature rows for ``tenant`` at
    trace-relative time ``t`` (seconds), features derived from ``seed``."""

    t: float
    tenant: str
    rows: int
    seed: int

    def features(self, n_features: int) -> np.ndarray:
        """Materialize this event's feature matrix — deterministic in
        (seed, rows, n_features), so every replay sees identical bits."""
        rng = np.random.RandomState(self.seed % (2 ** 32))
        return rng.randn(self.rows, n_features).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class Workload:
    """An ordered trace plus the metadata needed to regenerate it."""

    events: tuple[WorkloadEvent, ...]
    meta: dict

    @property
    def n_events(self) -> int:
        return len(self.events)

    @property
    def total_rows(self) -> int:
        return sum(e.rows for e in self.events)

    def tenants(self) -> tuple[str, ...]:
        return tuple(sorted({e.tenant for e in self.events}))


def _rate_profile(shape: str, grid: np.ndarray) -> np.ndarray:
    """Relative arrival rate r(t) over a unit-time grid."""
    if shape == "skew":
        return np.ones_like(grid)
    if shape == "diurnal":
        # one "day": trough at the ends, peak mid-trace, never zero
        return 0.25 + 0.75 * np.sin(np.pi * grid) ** 2
    if shape == "spike":
        plateau = np.ones_like(grid)
        burst = (np.abs(grid - 0.5) < 0.05).astype(float) * 9.0
        return plateau + burst
    raise ValueError(
        f"unknown workload shape {shape!r} (want skew|diurnal|spike)"
    )


def _tenant_weights(shape: str, n_tenants: int) -> np.ndarray:
    """Per-tenant selection weights (sum to 1)."""
    ranks = np.arange(1, n_tenants + 1, dtype=np.float64)
    if shape == "skew":
        w = 1.0 / ranks  # Zipf s=1: head tenants dominate
    else:
        w = np.ones(n_tenants)
    return w / w.sum()


def generate(
    shape: str,
    *,
    n_events: int,
    tenants: Sequence[str],
    seed: int = 0,
    duration_s: float = 60.0,
    rows_choices: Sequence[int] = (1, 2, 4, 8),
) -> Workload:
    """Seeded trace generator — same (args, seed) ⇒ identical trace.

    Arrival times invert the shape's rate-profile CDF (exact event
    count, profile-faithful spacing); tenants draw from the shape's
    weight vector; ``rows`` draws uniformly from ``rows_choices``; each
    event gets an independent feature seed derived from the master rng.
    """
    if n_events < 1:
        raise ValueError(f"n_events must be >= 1, got {n_events}")
    if not tenants:
        raise ValueError("tenants must be non-empty")
    rng = np.random.RandomState(seed)
    grid = np.linspace(0.0, 1.0, 1024)
    rate = _rate_profile(shape, grid)
    cdf = np.cumsum(rate)
    cdf = cdf / cdf[-1]
    # uniform quantiles + seeded jitter → profile-shaped arrival times
    u = (np.arange(n_events) + rng.uniform(0.0, 1.0, n_events)) / n_events
    times = np.interp(u, cdf, grid) * duration_s
    weights = _tenant_weights(shape, len(tenants))
    tenant_idx = rng.choice(len(tenants), size=n_events, p=weights)
    rows = rng.choice(list(rows_choices), size=n_events)
    seeds = rng.randint(0, 2 ** 31 - 1, size=n_events)
    names = list(tenants)
    events = tuple(
        WorkloadEvent(
            # µs resolution: matches the file format exactly, so a
            # generate → save → load round-trip is the identity
            t=round(float(times[i]), 6),
            tenant=names[int(tenant_idx[i])],
            rows=int(rows[i]),
            seed=int(seeds[i]),
        )
        for i in range(n_events)
    )
    meta = {
        "format": FORMAT,
        "shape": shape,
        "seed": int(seed),
        "n_events": int(n_events),
        "n_tenants": len(tenants),
        "duration_s": float(duration_s),
        "total_rows": int(sum(e.rows for e in events)),
    }
    return Workload(events=events, meta=meta)


def save_trace(workload: Workload, path: str) -> int:
    """Write a trace as gzip'd JSONL (meta line + one row per event).

    Returns the number of event lines written."""
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        f.write(json.dumps(workload.meta) + "\n")
        for e in workload.events:
            f.write(json.dumps(
                [round(e.t, 6), e.tenant, e.rows, e.seed]) + "\n")
    return workload.n_events


def load_trace(path: str) -> Workload:
    """Read a trace written by `save_trace`; validates the format tag."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        meta = json.loads(f.readline())
        if not isinstance(meta, dict) or meta.get("format") != FORMAT:
            raise ValueError(
                f"{path}: not a {FORMAT} trace "
                f"(meta line: {str(meta)[:80]!r})"
            )
        events = tuple(
            WorkloadEvent(t=float(t), tenant=str(tenant),
                          rows=int(rows), seed=int(seed))
            for t, tenant, rows, seed in map(json.loads, f)
        )
    if len(events) != meta.get("n_events"):
        raise ValueError(
            f"{path}: truncated trace — meta says {meta.get('n_events')} "
            f"events, file holds {len(events)}"
        )
    return Workload(events=events, meta=meta)


def chunked(events: Iterable[WorkloadEvent],
            size: int) -> "Iterable[list[WorkloadEvent]]":
    """Yield consecutive chunks of at most ``size`` events — the unit of
    one fused replay step per host in the router's replay path."""
    if size < 1:
        raise ValueError(f"chunk size must be >= 1, got {size}")
    buf: list[WorkloadEvent] = []
    for e in events:
        buf.append(e)
        if len(buf) >= size:
            yield buf
            buf = []
    if buf:
        yield buf
