"""The program's spans on the trace's clock (`perfbench/spans.py`), on
hand-made spans and traces, and on a small run of the search on the CPU."""
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from perfbench import devtrace, harness
from perfbench import spans as S
from perfbench.harness import Run
from perfbench.tests.conftest import MIXES, SMALL

ROOT = Path(__file__).resolve().parents[2]
NAME = "(anonymous namespace)::eval_program_kernel(Program, int const*, int*, int, int)"


def rec_of(spans, setup_end=0, dropped=0):
    """A record of (name, start, end, args) spans, on the trace's clock."""
    return S.SpanRecord(sorted((S.Span(*s) for s in spans), key=lambda s: (s.start, -s.end)),
                        dropped, setup_end, 0)


def X(ts, name, dur, **args):
    from repro_torch.serve.observability import TraceEvent
    return TraceEvent(ts, "X", name, "search", "main", args or None, None, dur)


def BE(ts, phase, name, track="main"):
    from repro_torch.serve.observability import TraceEvent
    return TraceEvent(ts, phase, name, "encoding", track, None, None)


# -- the clocks -------------------------------------------------------------

def test_anchor_brackets_both_clocks():
    a = S.anchor()
    wall, perf = time.time_ns(), time.perf_counter_ns()
    assert 0 <= a.width_ns < 10_000_000
    assert abs((wall - perf) - a.offset_ns) < 50_000_000


def test_conversion_with_a_known_offset():
    a0 = S.Anchor(perf_ns=1_000_000_000, offset_ns=5_000, width_ns=50)
    a1 = S.Anchor(perf_ns=3_000_000_000, offset_ns=7_000, width_ns=60)
    assert S.to_trace_ns(1.0, a0, a1) == 1_000_005_000
    assert S.to_trace_ns(2.0, a0, a1) == 2_000_006_000   # halfway: the offset moved by half
    assert S.to_trace_ns(3.0, a0, a1) == 3_000_007_000
    assert S.to_trace_ns(2.0, a0, a0) == 2_000_005_000
    events = [X(1.5, "search.mutate", 0.25, cpu_ns=7),
              BE(1.0, "E", "orphan"),                     # its B was evicted
              BE(1.25, "B", "encoding.pack"), BE(1.75, "E", "encoding.pack"),
              BE(2.5, "B", "never-closed")]
    rec = S.record(events, 0, 1.25, a0, a1)
    assert rec.drift_ns == 2_000 and rec.setup_end == 1_250_005_250
    assert [(s.name, s.start, s.end, s.args) for s in rec.spans] == [
        ("encoding.pack", 1_250_005_250, 1_750_005_750, {}),
        ("search.mutate", 1_500_005_500, 1_750_005_750, {"cpu_ns": 7})]


# -- idle gaps, by span ------------------------------------------------------

def trace_of(*ops):
    return devtrace.DeviceTrace([(n, s, e) for n, s, e in ops], window_s=1.0)


TRACE = trace_of(("void at::copy(float*)", 0, 10), (NAME, 50, 60),
                 ("void at::reduce(int*)", 100, 110), ("void at::copy(float*)", 200, 210))
SPANS = [("search.generation", 5, 150, {"cpu_ns": 290}),
         ("search.mutate", 5, 40, {"cpu_ns": 70}),
         ("search.launch", 40, 55, {"cpu_ns": 15, "search": 1, "gen": 1}),
         ("search.readback", 55, 150, {"cpu_ns": 190, "search": 1, "gen": 1})]


def test_gaps_are_divided_among_the_innermost_spans():
    got = S.gap_shares(TRACE, rec_of(SPANS))
    # gaps 10-50, 60-100, 110-200; the generation is open through 150
    assert got == {"host in search.mutate": 30, "host in search.launch": 10,
                   "host in search.readback": 40 + 40, S.OUTSIDE: 50}
    assert sum(got.values()) == 40 + 40 + 90
    assert S.idle_gaps(TRACE, rec_of(SPANS)) == [
        ["host in search.readback", 80e-9], [S.OUTSIDE, 50e-9],
        ["host in search.mutate", 30e-9], ["host in search.launch", 10e-9]]
    assert S.idle_unattributed_pct(TRACE, rec_of(SPANS)) == pytest.approx(100 * 50 / 170)


def test_a_parent_covers_what_its_children_leave():
    rec = rec_of([("search.generation", 0, 300, {}), ("search.mutate", 20, 30, {})])
    assert S.gap_shares(TRACE, rec) == {"host in search.generation": 40 + 40 + 90 - 10,
                                        "host in search.mutate": 10, S.OUTSIDE: 0}


@pytest.mark.parametrize("rec", [None, rec_of([]), rec_of(SPANS, dropped=3)])
def test_without_spans_the_gaps_keep_their_names(rec):
    assert S.idle_gaps(TRACE, rec) == TRACE.idle_gaps()
    assert S.idle_gaps(TRACE, rec)[0][0].startswith("host between ")
    assert S.idle_unattributed_pct(TRACE, rec) is None


# -- the readers -------------------------------------------------------------

SETUP = [("encoding.fit_encoder", -900, -800, {}), ("encoding.encode", -800, -600, {}),
         ("encoding.split_masks", -500, -300, {}), ("encoding.pack", -450, -400, {}),
         ("encoding.pack", -600, -550, {}), ("encoding.h2d", -400, -350, {}),
         ("kernels.load_library", -200, -120, {"built": True}),
         ("search.generation", -100, -10, {"cpu_ns": 10_000})]   # warm-up


def test_readers_on_a_record():
    rec = rec_of(SETUP + SPANS + [("search.generation", 150, 250, {"cpu_ns": 800})] +
                 [("encoding.encode", 300, 400, {})])           # after set-up: predict
    assert S.host_cpu_per_s(rec) == pytest.approx((290 + 800) / (145 + 100))
    assert S.encode_pack_s(rec) == pytest.approx((100 + 200 + 50 + 50) / 1e9)
    assert S.kernel_load_s(rec) == pytest.approx(80 / 1e9)
    cpu = S.phase_cpu(rec)
    assert set(cpu) == {"mutate", "launch", "readback"}
    assert cpu["readback"]["cpu_per_s"] == pytest.approx(2.0)
    assert sum(v["cpu_share_pct"] for v in cpu.values()) == pytest.approx(100.0)


@pytest.mark.parametrize("rec", [None, rec_of([]), rec_of(SETUP + SPANS, dropped=1)])
def test_readers_read_nothing_without_a_whole_record(rec):
    assert S.host_cpu_per_s(rec) is None
    assert S.idle_unattributed_pct(TRACE, rec) is None
    assert S.encode_pack_s(rec) is None and S.kernel_load_s(rec) is None
    assert S.phase_cpu(rec) is None and S.alignment(TRACE, rec, "eval_program_kernel") is None


def test_readers_read_nothing_where_the_record_lacks_their_spans():
    rec = rec_of(SPANS[1:])
    assert S.host_cpu_per_s(rec) is None
    assert S.encode_pack_s(rec) is None and S.kernel_load_s(rec) is None


def test_alignment_counts_launches_inside_their_generation():
    rec = rec_of(SPANS)
    assert S.alignment(TRACE, rec, "eval_program_kernel") == {
        "launches": 1, "inside": 1, "inside_pct": 100.0,
        "lag_us_median": 10 / 1e3, "lag_us_p99": 10 / 1e3}
    late = trace_of((NAME, 160, 170))          # after its readback ended
    early = trace_of((NAME, 30, 35))           # before any launch span
    assert S.alignment(late, rec, "eval_program_kernel")["inside"] == 0
    assert S.alignment(early, rec, "eval_program_kernel")["inside"] == 0
    assert S.alignment(trace_of(("void at::copy(float*)", 0, 1)), rec,
                       "eval_program_kernel") is None


COPY = "Memcpy DtoH (Device -> Pageable)"
# three generations 1000 ns apart; the device's stamps right, 150 ns late,
# 50 ns early
GENS = [x for g, (t, err) in enumerate(((0, 0), (1000, 150), (2000, -50)), 1) for x in (
    ("span", "search.launch", t, t + 10, {"search": 1, "gen": g}),
    ("span", "search.readback", t + 40, t + 100, {"search": 1, "gen": g}),
    ("op", NAME, t + 20 + err, t + 30 + err), ("op", COPY, t + 60 + err, t + 70 + err))]


def test_calibration_moves_each_generation_by_its_readback():
    rec = rec_of([x[1:] for x in GENS if x[0] == "span"])
    trace = trace_of(*[x[1:] for x in GENS if x[0] == "op"])
    cal, shifts = S.calibrated(trace, rec)
    # [copy end - span end, copy start - span start], nearest 0:
    # [-30, 20] -> 0; [120, 170] -> 120; [-80, -30] -> -30
    assert shifts == [0, 120, -30]
    assert [(s, e) for n, s, e in cal.ops if n == NAME] == [(20, 30), (1050, 1060), (2000, 2010)]
    assert S.alignment(trace, rec, "eval_program_kernel")["inside"] == 1
    assert S.alignment(cal, rec, "eval_program_kernel")["inside"] == 3
    run = Run(trace=trace, kernel="eval_program_kernel")
    got = S.readings(run, rec)
    assert got["alignment"]["inside_pct"] == 100.0
    assert got["calibration"] == {"generations": 3, "shifted_pct": 200 / 3, "shift_us_max": 0.12}
    assert trace.ops == sorted((x[1:] for x in GENS if x[0] == "op"), key=lambda o: o[1])


def test_no_calibration_where_copies_and_readbacks_do_not_pair():
    rec = rec_of([x[1:] for x in GENS if x[0] == "span"])
    ops = [x[1:] for x in GENS if x[0] == "op"]
    assert S.calibrated(trace_of(*ops[:-1]), rec) == (None, None)   # a copy lost
    assert S.calibrated(trace_of(*ops), rec_of([])) == (None, None)
    assert S.readings(Run(trace=trace_of(*ops[:-1]), kernel="eval_program_kernel"),
                      rec)["calibration"] is None


def test_the_existing_readers_read_the_same_with_the_span_readings():
    """Reading the spans changes nothing that the benchmark's own readers
    read from the run."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    run = Run(setup_s=12.5, window_s=1.0, attempted=40, trace=TRACE,
              kernel="eval_program_kernel", launch_bounds_s=[1e-9], ops=10,
              counters={"generations": 40, "searches": 1},
              phases={p: 0.001 for p in ("mutate", "compile", "program_h2d", "launch",
                                         "fitness_reduce", "readback", "host_select")})
    before = {n: harness.read_metric(n, run) for n in names}
    ops = list(TRACE.ops)
    S.readings(run, rec_of(SETUP + SPANS))
    assert {n: harness.read_metric(n, run) for n in names} == before
    assert TRACE.ops == ops and len([v for v in before.values() if v is not None]) == 8


# -- a run of the search on the CPU -----------------------------------------

def _run(monkeypatch, record: bool):
    from repro_torch.serve.observability import trace as T
    made = []
    init = T.TraceRecorder.__init__

    def counting(self, *a, **k):
        made.append(self)
        init(self, *a, **k)
    monkeypatch.setattr(T.TraceRecorder, "__init__", counting)
    cell = harness.mix_cell(*MIXES["higgs.search"], SMALL)
    t_start = time.perf_counter()
    ctx = harness.Context(cell, 2**31 + 11, 0.5, False, "cpu", t_start)
    if not record:
        return harness.driver(cell).run(ctx), made, None
    a0 = S.anchor()
    with T.recording(T.TraceRecorder(capacity=S.CAPACITY)) as tracer:
        run = harness.driver(cell).run(ctx)
    a1 = S.anchor()
    return run, made, S.record(tracer.events(), tracer.dropped, t_start + run.setup_s, a0, a1)


def test_a_run_at_trace_0_makes_no_recorder(monkeypatch):
    from repro_torch.serve.observability import NULL_TRACER
    run, made, _ = _run(monkeypatch, record=False)
    assert run.correct and run.counters["generations"] > 0
    assert made == [] and len(NULL_TRACER) == 0


def test_a_recorded_run_of_the_search(monkeypatch):
    run, made, rec = _run(monkeypatch, record=True)
    assert run.correct and len(made) == 1 and rec.dropped == 0
    gens = [s for s in rec.spans if s.name == "search.generation" and s.start >= rec.setup_end]
    assert len(gens) == run.counters["generations"]
    assert S.host_cpu_per_s(rec) > 0 and 0 < S.encode_pack_s(rec) < run.setup_s
    assert S.kernel_load_s(rec) is None          # the plain versions load no library
    assert set(S.phase_cpu(rec)) == {"mutate", "compile", "program_h2d", "launch",
                                     "fitness_reduce", "readback", "host_select"}
    assert abs(rec.drift_ns) < 5_000_000


def test_without_a_card_the_command_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "perfbench/spans.py", "--workload", "higgs.search",
                        "--seed", "5", "--seconds", "1", "--trace", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "CUDA device" in p.stderr and "metrics" not in p.stdout
