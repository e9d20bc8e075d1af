"""The program's own spans, laid on the device trace's clock.

Under `recording` (`repro_torch.serve.observability.trace`) the program
records each search phase (``search.<phase>``, with the process's CPU
nanoseconds over it), each generation (``search.generation``, a search's
first parent ``search.init``), encoding and packing (``encoding.*``) and
the kernel library's load (``kernels.load_library``), on its
``perf_counter`` clock.  The profiler stamps device operations on
``time.time_ns``'s clock.  `anchor` reads the two clocks back to back;
two anchors, one before the run and one after, carry every span onto the
trace's clock (`record`), and the readers below take what they show:

* `idle_gaps`: the device's idle time divided among the innermost spans
  open during it (``host in <span>``; ``host outside the program`` where
  none is);
* `host_cpu_per_s`, `idle_unattributed_pct`, `encode_pack_s`,
  `kernel_load_s`: per-layer readings that no device trace can give;
* `phase_cpu`: each phase's wall and CPU seconds in the window (over the
  sampled generations, which read the CPU clock), which says which phase
  wakes torch's intra-op pool;
* `alignment`: whether each traced launch of the cell's kernel starts
  inside its generation's ``search.launch`` to ``search.readback``;
* `calibrated`: the device times corrected at each readback, the sync
  point that bounds the profiler's clock error.

A reader returns None where the run holds no spans or the ring dropped
some.  `run.py` records no spans: the files it runs would need an edit for
that (PERF.md §7).  Meanwhile this file runs a cell as `run.py` does, with
a recorder active around the driver when ``--record 1``::

    python3 perfbench/spans.py --workload higgs.search --seed <n> --seconds <s> \\
        --trace <0|1> --record <0|1>

and prints `run.py`'s result line with one key more, ``spans``, holding
the readings above (with ``--trace 1``) or only the counts.
"""
import time

T_START = time.perf_counter()  # set-up is timed from here, as in run.py

import argparse  # noqa: E402
import bisect  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NamedTuple  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# a generation records 9 events; 2**20 hold a 51 s window at 2,000
# generations a second, four times what the card's host reaches
CAPACITY = 1 << 20
OUTSIDE = "host outside the program"
ENCODE_PACK = ("encoding.fit_encoder", "encoding.encode", "encoding.pack")
ENCLOSING = ("search.generation", "search.init")   # the rest of search.* are phases


class Anchor(NamedTuple):
    """One reading of both clocks: ``time_ns() - perf_counter_ns()`` at
    ``perf_ns``, the middle of the tightest of a few back-to-back brackets,
    ``width_ns`` wide."""

    perf_ns: int
    offset_ns: int
    width_ns: int


def anchor(tries: int = 64) -> Anchor:
    best = None
    for _ in range(tries):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[2]:
            best = ((a + b) // 2, wall, b - a)
    mid, wall, width = best
    return Anchor(mid, wall - mid, width)


class Span(NamedTuple):
    name: str
    start: int   # ns, the device trace's clock
    end: int
    args: dict


class SpanRecord(NamedTuple):
    """A run's spans on the trace's clock, sorted by start, with what the
    readers need to trust them."""

    spans: "list[Span]"
    dropped: int          # events the ring lost: the readers read nothing then
    setup_end: int        # ns: the end of set-up, where the window starts
    drift_ns: int         # the offset's change from the first anchor to the second


def to_trace_ns(t_s: float, a0: Anchor, a1: Anchor) -> int:
    """``perf_counter`` seconds on the trace's clock: the offset moves
    linearly from ``a0``'s to ``a1``'s."""
    p = round(t_s * 1e9)
    span = a1.perf_ns - a0.perf_ns
    frac = (p - a0.perf_ns) / span if span else 0.0
    return p + round(a0.offset_ns + frac * (a1.offset_ns - a0.offset_ns))


def record(events, dropped: int, setup_end_s: float, a0: Anchor, a1: Anchor) -> SpanRecord:
    """The spans of a recorder's events (``X`` as they are, ``B``/``E``
    paired per track in the ring's order; a pair the ring cut is left out)
    on the trace's clock; ``setup_end_s`` on ``perf_counter``'s."""
    def ns(t):
        return to_trace_ns(t, a0, a1)

    out, open_ = [], {}
    for e in events:
        if e.phase == "X":
            out.append(Span(e.name, ns(e.ts), ns(e.ts + e.dur), e.args or {}))
        elif e.phase == "B":
            open_.setdefault(e.track, []).append(e)
        elif e.phase == "E" and open_.get(e.track):
            b = open_[e.track].pop()
            out.append(Span(b.name, ns(b.ts), ns(e.ts), b.args or {}))
    out.sort(key=lambda s: (s.start, -s.end))
    return SpanRecord(out, int(dropped), ns(setup_end_s), a1.offset_ns - a0.offset_ns)


def _usable(rec: "SpanRecord | None") -> bool:
    return rec is not None and bool(rec.spans) and rec.dropped == 0


def _window(rec: SpanRecord, name: str) -> "list[Span]":
    return [s for s in rec.spans if s.name == name and s.start >= rec.setup_end]


def _innermost(spans: "list[Span]") -> "list[tuple[int, int, str]]":
    """(start, end, name) of the innermost open span, over every stretch
    in which some span is open; the latest started is the innermost."""
    points = []
    for i, s in enumerate(spans):
        if s.end <= s.start:
            continue   # covers nothing
        points.append((s.start, 1, -s.end, i))
        points.append((s.end, 0, 0, i))
    points.sort()   # at one time: closes first, then the longer span opens first
    stack, segs, prev = [], [], None
    for t, opens, _, i in points:
        if stack and t > prev:
            segs.append((prev, t, spans[stack[-1]].name))
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
        prev = t
    return segs


def _device_gaps(trace) -> "list[tuple[int, int]]":
    """Idle stretches between the trace's operations, as
    `DeviceTrace.idle_gaps` finds them."""
    gaps, end = [], None
    for _, s, e in trace.ops:
        if end is not None and s > end:
            gaps.append((end, s))
        if end is None or e > end:
            end = e
    return gaps


def gap_shares(trace, rec: SpanRecord) -> dict:
    """Idle ns between the trace's operations by the innermost span open
    in them (``host in <name>``), the rest under `OUTSIDE`."""
    segs = _innermost(rec.spans)
    total: dict = {OUTSIDE: 0}
    j = 0
    for gs, ge in _device_gaps(trace):
        while j < len(segs) and segs[j][1] <= gs:
            j += 1
        covered, m = 0, j
        while m < len(segs) and segs[m][0] < ge:
            s, e, name = segs[m]
            d = min(e, ge) - max(s, gs)
            if d > 0:
                key = f"host in {name}"
                total[key] = total.get(key, 0) + d
                covered += d
            m += 1
        total[OUTSIDE] += (ge - gs) - covered
    return total


def idle_gaps(trace, rec: "SpanRecord | None", k: int = 10) -> "list[list]":
    """The breakdown's idle gaps: by span where the run holds spans, else
    `DeviceTrace.idle_gaps` as it is (named after the operations around)."""
    if not _usable(rec):
        return trace.idle_gaps(k)
    shares = gap_shares(trace, rec)
    return [[n, t / 1e9] for n, t in sorted(shares.items(), key=lambda kv: -kv[1])[:k]]


def host_cpu_per_s(rec: "SpanRecord | None") -> "float | None":
    """Process CPU seconds a wall second over the window's generations that
    read the CPU clock (one in `CPU_SAMPLE_EVERY` of `core/evolve.py`)."""
    if not _usable(rec):
        return None
    gens = [s for s in _window(rec, "search.generation") if "cpu_ns" in s.args]
    wall = sum(s.end - s.start for s in gens)
    return sum(s.args["cpu_ns"] for s in gens) / wall if wall else None


def idle_unattributed_pct(trace, rec: "SpanRecord | None") -> "float | None":
    """Per cent of the device's idle time between operations in which no
    program span was open."""
    if not _usable(rec) or trace is None or not trace.ops:
        return None
    shares = gap_shares(trace, rec)
    idle = sum(shares.values())
    return 100.0 * shares[OUTSIDE] / idle if idle else None


def _setup_s(rec: "SpanRecord | None", names) -> "float | None":
    if not _usable(rec):
        return None
    hit = [s for s in rec.spans if s.name in names and s.end <= rec.setup_end]
    return sum(s.end - s.start for s in hit) / 1e9 if hit else None


def encode_pack_s(rec: "SpanRecord | None") -> "float | None":
    """Seconds of set-up in fitting the encoder, encoding and packing."""
    return _setup_s(rec, ENCODE_PACK)


def kernel_load_s(rec: "SpanRecord | None") -> "float | None":
    """Seconds of set-up in loading (and, where ``nvcc`` ran, building)
    the kernel library."""
    return _setup_s(rec, ("kernels.load_library",))


def phase_cpu(rec: "SpanRecord | None") -> "dict | None":
    """Each phase over the window's spans that read the CPU clock: wall and
    CPU seconds, CPU seconds a wall second, and its share of their CPU."""
    if not _usable(rec):
        return None
    out: dict = {}
    for s in rec.spans:
        if s.name.startswith("search.") and s.name not in ENCLOSING \
                and s.start >= rec.setup_end and "cpu_ns" in s.args:
            v = out.setdefault(s.name[len("search."):], {"wall_s": 0.0, "cpu_s": 0.0})
            v["wall_s"] += (s.end - s.start) / 1e9
            v["cpu_s"] += s.args["cpu_ns"] / 1e9
    cpu = sum(v["cpu_s"] for v in out.values())
    for v in out.values():
        v["cpu_per_s"] = v["cpu_s"] / v["wall_s"] if v["wall_s"] else None
        v["cpu_share_pct"] = 100.0 * v["cpu_s"] / cpu if cpu else None
    return out


def alignment(trace, rec: "SpanRecord | None", kernel: str) -> "dict | None":
    """How many traced launches of ``kernel`` start after the start of the
    latest ``search.launch`` span before them and before the end of that
    generation's ``search.readback``; and the launches' lag after their
    launch span's start, in µs (median and 99th percentile)."""
    from perfbench.devtrace import kernel_name

    if not _usable(rec) or trace is None:
        return None
    launch = [s for s in rec.spans if s.name == "search.launch"]
    back = {(s.args["search"], s.args["gen"]): s.end
            for s in rec.spans if s.name == "search.readback"}
    starts = [s.start for s in launch]
    ok, lags, n = 0, [], 0
    for name, s, _ in trace.ops:
        if kernel_name(name) != kernel:
            continue
        n += 1
        i = bisect.bisect_right(starts, s) - 1
        if i < 0:
            continue
        span = launch[i]
        key = (span.args["search"], span.args["gen"])
        lags.append(s - span.start)
        ok += s < back.get(key, span.start)
    if not n:
        return None
    lags.sort()
    return {"launches": n, "inside": ok, "inside_pct": 100.0 * ok / n,
            "lag_us_median": lags[len(lags) // 2] / 1e3 if lags else None,
            "lag_us_p99": lags[int(0.99 * (len(lags) - 1))] / 1e3 if lags else None}


def calibrated(trace, rec: "SpanRecord | None"):
    """``(trace, shifts)``: the trace with each generation's operations
    moved onto the spans' clock, and the shift of each generation in ns;
    ``(None, None)`` where the window's copies to the host and its
    ``search.readback`` spans do not pair one to one.

    The profiler's device times drift from the host's clock by up to about
    a millisecond between its re-syncs (PERF.md §6).  A readback is a sync
    point: its copy ran inside its ``search.readback`` span, so at the copy
    the device time's error lies in [copy end - span end, copy start - span
    start].  Each operation from the previous copy's end to a copy's end
    moves back by the value of that range nearest 0."""
    from perfbench.devtrace import DeviceTrace

    if not _usable(rec) or trace is None:
        return None, None
    copies = [(s, e) for n, s, e in trace.ops if n.startswith("Memcpy DtoH")]
    backs = [s for s in rec.spans if s.name == "search.readback" and s.start >= rec.setup_end]
    if not copies or len(copies) != len(backs):
        return None, None
    shifts = []
    for (cs, ce), b in zip(copies, backs):
        lo, hi = ce - b.end, cs - b.start
        shifts.append(lo if lo > 0 else hi if hi < 0 else 0)
    ends = [e for _, e in copies]
    ops = []
    for name, s, e in trace.ops:
        d = shifts[min(bisect.bisect_left(ends, s), len(ends) - 1)]
        ops.append((name, s - d, e - d))
    return DeviceTrace(ops, trace.window_s), shifts


def readings(run, rec: SpanRecord) -> dict:
    """Everything this module reads from one traced run: on the calibrated
    trace where the readbacks pair with the copies, else on the trace as
    the profiler gave it."""
    cal, shifts = calibrated(run.trace, rec)
    trace = cal if cal is not None else run.trace
    return {
        "search.host_cpu_per_s": host_cpu_per_s(rec),
        "search.idle_unattributed_pct": idle_unattributed_pct(trace, rec),
        "setup.encode_pack_s": encode_pack_s(rec),
        "setup.kernel_load_s": kernel_load_s(rec),
        "idle_gaps": idle_gaps(trace, rec) if trace is not None else None,
        "phase_cpu": phase_cpu(rec),
        "alignment": alignment(trace, rec, run.kernel),
        "alignment_uncalibrated": alignment(run.trace, rec, run.kernel),
        "calibration": None if shifts is None else {
            "generations": len(shifts),
            "shifted_pct": 100.0 * sum(1 for d in shifts if d) / len(shifts),
            "shift_us_max": max(abs(d) for d in shifts) / 1e3},
        "loaded_built": [s.args.get("built") for s in rec.spans
                         if s.name == "kernels.load_library"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--record", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    cache = ROOT / "build" / "perfbench"   # as run.py sets them
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

    from perfbench import harness
    cell = harness.load_cell(args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    from repro_torch.serve.observability.trace import TraceRecorder, recording

    ctx = harness.Context(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    tracer = TraceRecorder(capacity=CAPACITY) if args.record else None
    a0 = anchor()
    with recording(tracer) if tracer is not None else contextlib.nullcontext():
        run = harness.driver(cell).run(ctx)
    a1 = anchor()
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules that the benchmark may not load are loaded: {bad}", file=sys.stderr)
        return 3
    line = harness.result_line(cell, run, bool(args.trace))
    if tracer is not None:
        rec = record(tracer.events(), tracer.dropped, T_START + run.setup_s, a0, a1)
        line["spans"] = {"recorded": len(tracer), "dropped": rec.dropped,
                         "drift_us": rec.drift_ns / 1e3,
                         "anchor_width_ns": [a0.width_ns, a1.width_ns]}
        if args.trace:
            line["spans"].update(readings(run, rec))
        print(f"spans: {len(tracer)} recorded, {rec.dropped} dropped, "
              f"clock offset drift {rec.drift_ns / 1e3:.3f} us", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
