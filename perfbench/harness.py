"""Run one cell of `BENCHMARK.json` and assemble its result line.

A cell names a configuration and a traffic mix; everything else is found by
name under `perfbench/`:

* ``configs/<config>.json``  the configuration's sizes and settings;
* ``traffic/<traffic>.json`` the mix's parameters, whose ``driver`` names
  the generator in ``drivers/`` that reads them;
* ``metrics/<metric>.py``    one reader per metric, ``read(run)``, which
  returns the metric's value from the run's record, or None where the
  record holds nothing to read.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"

# top-level modules that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    """What a driver is given: the cell, the run's arguments, the device it
    runs on and the host time at which the process started."""

    cell: "Cell"
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float


@dataclasses.dataclass
class Run:
    """What a driver hands back: the record that the metric readers read."""

    setup_s: float = 0.0
    window_s: float = 0.0          # the measured window, host clock
    attempted: int = 0
    failed: int = 0
    checks: dict = dataclasses.field(default_factory=dict)  # name -> value, limit
    counters: dict = dataclasses.field(default_factory=dict)
    phases: dict = dataclasses.field(default_factory=dict)  # program clocks, s
    latencies_s: "list | None" = None  # per request due in the window; inf: failed
    trace: "object | None" = None      # devtrace.DeviceTrace of a traced run
    kernel: str = ""                   # the cell's circuit kernel
    launch_bounds_s: list = dataclasses.field(default_factory=list)  # per launch traced
    ops: int = 0                       # logic ops the traced launches needed
    device: dict = dataclasses.field(default_factory=dict)
    # the control's readings of the same sample (`perfbench/control.py`)
    control: "object | None" = dataclasses.field(default=None, repr=False)

    @property
    def correct(self) -> bool:
        return all(c["value"] <= c["limit"] for c in self.checks.values())


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def mix_cell(config: str, traffic: str, overrides: "dict | None" = None) -> Cell:
    """``configs/<config>.json`` under ``traffic/<traffic>.json``, as a cell
    on one chip that reports no metric: for the sweep, or a test, of a mix
    that has no entry in `BENCHMARK.json`.  ``overrides`` (``{"config":
    {...}, "traffic": {...}}``) replaces keys of either, for runs at other
    sizes."""
    cfg = _load_json(HERE / "configs" / f"{config}.json")
    mix = _load_json(HERE / "traffic" / f"{traffic}.json")
    overrides = overrides or {}
    cfg.update(overrides.get("config", {}))
    mix.update(overrides.get("traffic", {}))
    return Cell(f"{config}.{traffic}", cfg, mix, 1, [], [])


def load_cell(name: str, overrides: "dict | None" = None,
              benchmark: Path = BENCHMARK) -> Cell:
    """The cell ``name`` of ``benchmark`` with its configuration, its mix
    (``overrides`` as in `mix_cell`) and the metrics it reports."""
    bench = _load_json(benchmark)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {benchmark.name}; "
                       f"cells: {sorted(work)}")
    w = work[name]
    cell = mix_cell(w["config"], w["traffic"], overrides)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return dataclasses.replace(cell, name=name, chips=int(w["chips"]),
                               end_to_end=e2e, per_layer=per_layer)


def read_metric(name: str, run) -> "float | None":
    """The value that ``metrics/<name>.py`` reads from ``run``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    value = mod.read(run)
    return None if value is None else float(value)


def driver(cell: Cell):
    """The generator module that the cell's mix names."""
    return importlib.import_module(f"perfbench.drivers.{cell.traffic['driver']}")


def forbidden_modules() -> "list[str]":
    """Modules loaded in this process whose top-level name (the part before
    the first dot, compared whole) is one of `FORBIDDEN`."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def result_line(cell: Cell, run, trace: bool) -> dict:
    """The JSON object a run prints last: its verdict, its counts, the
    cell's end-to-end metrics (or with ``trace`` its per-layer ones), the
    device, the trace's breakdown, and last the numbers compared with their
    limits."""
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": bool(run.correct), "attempted": int(run.attempted),
            "failed": int(run.failed), "metrics": metrics, "device": dict(run.device)}
    if trace and run.trace is not None:
        line["device"]["busy_s"] = run.trace.busy_s()
        line["device"]["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.top_ops(),
                             "idle_gaps": run.trace.idle_gaps()}
    line["checks"] = run.checks
    return line
