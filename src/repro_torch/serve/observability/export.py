"""Exporters: Chrome-trace/Perfetto JSON, JSONL, Prometheus text (PyTorch
port: a copy of the reference package's exporters, whose output it matches
byte for byte).

Three consumers, three formats, one timeline:

  * `export_chrome` — the Chrome trace-event JSON the Perfetto UI
    (https://ui.perfetto.dev) and ``chrome://tracing`` open directly.
    Request-lifecycle async spans, per-tick phase spans,
    scheduler/autoscale instants and a fit's complete (``X``) spans all
    land on one zoomable timeline.
  * `export_jsonl` — one JSON object per event line, for ad-hoc
    ``jq``/pandas analysis and structured log shipping.
  * `prometheus_text` — a text-format snapshot of the serving stack's
    existing aggregate stats (`ServerStats` / `FrontendStats` reports),
    for scraping into a metrics store without a client library.

The Chrome exporter *sanitizes* the window it was given: a ring buffer
that wrapped (or a recorder disabled mid-span) can hold an ``E`` whose
``B`` was evicted, or a ``B`` that never closed.  Orphan closes are
dropped and dangling opens get a synthetic close at the window's end, so
the emitted document always carries matched, properly nested B/E pairs
and monotonically non-decreasing timestamps — the invariants the trace
tests assert.
"""
from __future__ import annotations

import json
import os
from typing import Iterable

from repro_torch.serve.observability.trace import TraceEvent, TraceRecorder

_PID = 1  # one serving process per trace


def _event_list(src: "TraceRecorder | Iterable[TraceEvent]"):
    events = src.events() if isinstance(src, TraceRecorder) else list(src)
    # stable sort: appends from different threads may interleave slightly
    # out of timestamp order in the ring; an X span is appended when it
    # ends, so of spans that start together the longer (the parent) goes
    # first
    return sorted(events, key=lambda e: (e.ts, -(e.dur or 0.0)))


def _json_args(args: "dict | None") -> dict:
    if not args:
        return {}
    return {k: (v if isinstance(v, (int, float, str, bool, type(None)))
                else str(v))
            for k, v in args.items()}


def to_chrome(src: "TraceRecorder | Iterable[TraceEvent]") -> dict:
    """Render a timeline as a Chrome trace-event document (pure)."""
    events = _event_list(src)
    origin = events[0].ts if events else 0.0
    end_us = (max(e.ts + (e.dur or 0.0) for e in events) - origin) * 1e6 if events else 0.0

    tids: dict[str, int] = {}
    out: list[dict] = []

    def tid_of(track: str) -> int:
        tid = tids.get(track)
        if tid is None:
            tid = tids[track] = len(tids) + 1
        return tid

    # per-track open-span stacks (sanitization) and per-id async opens
    stacks: dict[int, list[dict]] = {}
    async_open: dict[tuple[str, int], int] = {}

    for ev in events:
        ts_us = (ev.ts - origin) * 1e6
        tid = tid_of(ev.track)
        rec = {"name": ev.name, "cat": ev.cat or "trace", "ph": ev.phase,
               "ts": ts_us, "pid": _PID, "tid": tid}
        args = _json_args(ev.args)
        if ev.phase == "B":
            if args:
                rec["args"] = args
            out.append(rec)
            stacks.setdefault(tid, []).append(rec)
        elif ev.phase == "E":
            stack = stacks.get(tid)
            if not stack:
                continue  # orphan close: its B was evicted by the ring
            opened = stack.pop()
            # E inherits the B's identity — Chrome pairs by order, but
            # keeping names equal makes the document self-describing
            rec["name"] = opened["name"]
            rec["cat"] = opened["cat"]
            out.append(rec)
        elif ev.phase in ("b", "n", "e"):
            if ev.id is None:
                continue
            key = (ev.cat or "trace", ev.id)
            if ev.phase == "b":
                async_open[key] = async_open.get(key, 0) + 1
            elif async_open.get(key, 0) <= 0:
                continue  # async n/e whose b was evicted
            elif ev.phase == "e":
                async_open[key] -= 1
            rec["id"] = format(ev.id, "x")
            if args:
                rec["args"] = args
            out.append(rec)
        elif ev.phase == "X":
            rec["dur"] = (ev.dur or 0.0) * 1e6
            if args:
                rec["args"] = args
            out.append(rec)
        elif ev.phase == "C":
            rec["args"] = args or {"value": 0}
            out.append(rec)
        else:  # "i" and anything future-shaped
            rec["ph"] = "i"
            rec["s"] = "t"  # thread-scoped instant
            if args:
                rec["args"] = args
            out.append(rec)

    # dangling opens (disabled mid-span / window cut): synthetic closes
    # at the window end keep every B matched, innermost first
    for tid, stack in stacks.items():
        while stack:
            opened = stack.pop()
            out.append({"name": opened["name"], "cat": opened["cat"],
                        "ph": "E", "ts": end_us, "pid": _PID, "tid": tid})
    for (cat, id_), n_open in async_open.items():
        for _ in range(max(n_open, 0)):
            out.append({"name": "truncated", "cat": cat, "ph": "e",
                        "ts": end_us, "pid": _PID, "tid": 1,
                        "id": format(id_, "x")})

    meta = [{"name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
             "args": {"name": track}} for track, tid in tids.items()]
    doc = {"traceEvents": meta + out, "displayTimeUnit": "ms"}
    if isinstance(src, TraceRecorder) and src.dropped:
        doc["otherData"] = {"dropped_events": src.dropped}
    return doc


def export_chrome(src: "TraceRecorder | Iterable[TraceEvent]",
                  path: str) -> dict:
    """Write `to_chrome`'s document to ``path``; returns the document."""
    doc = to_chrome(src)
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def export_jsonl(src: "TraceRecorder | Iterable[TraceEvent]",
                 path: str) -> int:
    """One JSON object per event line; returns the number of lines."""
    events = _event_list(src)
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps({
                "ts": ev.ts, "ph": ev.phase, "name": ev.name,
                "cat": ev.cat, "track": ev.track,
                **({"id": ev.id} if ev.id is not None else {}),
                **({"dur": ev.dur} if ev.dur is not None else {}),
                **({"args": _json_args(ev.args)} if ev.args else {}),
            }) + "\n")
    return len(events)


# -- Prometheus text snapshot ------------------------------------------

def _prom_name(s: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in s)


def _prom_lines(prefix: str, report: dict, label: str) -> list[str]:
    lines: list[str] = []
    for key, value in report.items():
        name = f"{prefix}_{_prom_name(key)}"
        if isinstance(value, bool):
            continue
        if isinstance(value, (int, float)):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name}{{{label}}} {value}")
        elif isinstance(value, dict):
            numeric = {k: v for k, v in value.items()
                       if isinstance(v, (int, float))
                       and not isinstance(v, bool)}
            if not numeric:
                continue
            lines.append(f"# TYPE {name} gauge")
            for k, v in numeric.items():
                lines.append(f'{name}{{{label},key="{_prom_name(str(k))}"}}'
                             f" {v}")
        # strings (backend names, tier maps) ride as labels elsewhere
    return lines


def _fleet_lines(fleet, namespace: str) -> list[str]:
    """Fleet section: router-level gauges plus one ``{host="..."}``
    labelled series per host per metric, so a scrape sees the whole
    cluster in one exposition."""
    report = fleet if isinstance(fleet, dict) else fleet.report()
    lines: list[str] = []
    router = report.get("router", {})
    for key, value in router.items():
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            continue
        name = f"{namespace}_fleet_router_{_prom_name(key)}"
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {value}")
    hosts = report.get("hosts", {})
    per_metric: dict[str, list[str]] = {}
    for host, stats in sorted(hosts.items()):
        for key, value in stats.items():
            if isinstance(value, bool) or not isinstance(
                    value, (int, float)):
                continue
            name = f"{namespace}_fleet_host_{_prom_name(key)}"
            per_metric.setdefault(name, []).append(
                f'{name}{{host="{_prom_name(str(host))}"}} {value}'
            )
    for name, series in per_metric.items():
        lines.append(f"# TYPE {name} gauge")
        lines.extend(series)
    return lines


def prometheus_text(
    server_stats=None,
    frontend_stats=None,
    *,
    fleet=None,
    evolution=None,
    namespace: str = "repro",
) -> str:
    """Text-format metrics snapshot of the serving stack's aggregates.

    Takes the live `ServerStats` / `FrontendStats` objects (or their
    pre-computed ``report()`` dicts) and renders every numeric field as a
    gauge, dict-valued fields (``fire_reasons``, ``shard_occupancy``,
    nested ``phase_breakdown`` maps) as one labelled series per key.
    ``fleet`` (a `FleetRouter` or its ``report()`` dict) adds the
    cluster section: ``<ns>_fleet_router_*`` gauges (QPS, migrations,
    plan generation) and ``<ns>_fleet_host_*`` series labelled by host
    (queue depth, requests routed, per-host QPS).
    ``evolution`` (an `EvolutionManager` or its ``report()`` dict) adds
    the online-evolution section: ``<ns>_evolution_*`` counters (drift
    triggers, refits, shadows, promotions, rollbacks) and the per-tenant
    window divergence as a ``key=<tenant>``-labelled series.
    """
    sections: list[str] = []
    for prefix, stats in ((f"{namespace}_server", server_stats),
                          (f"{namespace}_frontend", frontend_stats)):
        if stats is None:
            continue
        report = stats if isinstance(stats, dict) else stats.report()
        backend = report.get("backend", "unknown")
        label = f'backend="{backend}"'
        flat = {}
        for k, v in report.items():
            if isinstance(v, dict) and any(
                    isinstance(x, dict) for x in v.values()):
                for kk, vv in v.items():  # one nesting level (phase maps)
                    flat[f"{k}_{kk}"] = vv
            else:
                flat[k] = v
        sections.extend(_prom_lines(prefix, flat, label))
    if fleet is not None:
        sections.extend(_fleet_lines(fleet, namespace))
    if evolution is not None:
        report = (evolution if isinstance(evolution, dict)
                  else evolution.report())
        sections.extend(_prom_lines(
            f"{namespace}_evolution", report, 'loop="online"'
        ))
    return "\n".join(sections) + ("\n" if sections else "")
