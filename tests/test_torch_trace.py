"""The fit's spans on the process's current recorder (CPU, a fake clock).

`recording(rec)` makes ``rec`` the recorder that the search (`PhaseClock`),
the encoding and the kernel library's load record into; outside it the
process's recorder is `NULL_TRACER` and nothing is recorded.  Each search
phase is a ``search.<phase>`` span from the same clock reads `PhaseClock`
sums, inside a ``search.generation`` (or ``search.init``) span that shares
its ``gen``.  This file imports neither JAX nor the reference package, so
its one ``cuda`` case runs on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_trace.py
"""
import ctypes
import json
import pickle
import warnings
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.core import api as A
from repro_torch.core import encoding as E
from repro_torch.core import evolve as V
from repro_torch.core.genome import CircuitSpec
from repro_torch.kernels import circuit_eval, native
from repro_torch.kernels import program as PG
from repro_torch.serve.observability import (
    NULL_TRACER,
    TraceEvent,
    TraceRecorder,
    active,
    export_jsonl,
    recording,
    to_chrome,
)
from repro_torch.serve.observability.trace import NOOP_SPAN


class FakeClock:
    """Advances by ``step`` seconds a read: dyadic steps keep every sum exact."""

    def __init__(self, t: float = 100.0, step: float = 0.125):
        self.t, self.step = t, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


@pytest.fixture(autouse=True)
def _program_library_loaded():
    """The native program compiler loads once per process, at the first
    `make_eval_fn`: load it before any recording here, so every test sees
    only its own spans (its load span has a test of its own)."""
    PG.load_library()


def _problem(rows: int = 200, seed: int = 3):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, 3).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int64)
    enc = E.fit_encoder(x, E.EncodingConfig("quantile", 2))
    bits = E.encode(enc, x)
    data = E.pack_dataset(bits, y, 2, device="cpu")
    masks = E.split_masks(rows, data.x_words.shape[1], 0.5, seed=seed, device="cpu")
    spec = CircuitSpec(n_inputs=bits.shape[1], n_nodes=16, n_outputs=1)
    return spec, data, masks


def _search(spec, data, masks, gens: int, searches: int = 1):
    """``searches`` searches of ``gens`` generations each on one eval_fn."""
    cfg = V.EvolveConfig(lam=3, max_gens=10_000)
    eval_fn = V.make_eval_fn(spec, data, *masks)
    g = torch.Generator().manual_seed(1)
    for _ in range(searches):
        state = V.init_state(g, spec, eval_fn)
        for _ in range(gens):
            state = V.generation_step(state, g, spec, cfg, eval_fn)
    return eval_fn


def _xs(rec, prefix=""):
    return [e for e in rec.events() if e.phase == "X" and e.name.startswith(prefix)]


def test_phase_spans_sum_to_the_clock_exactly():
    spec, data, masks = _problem()
    rec = TraceRecorder(capacity=1 << 12, clock=FakeClock())
    with recording(rec):
        eval_fn = _search(spec, data, masks, gens=6, searches=2)
    assert eval_fn.clock.tracer is rec and rec.dropped == 0
    for phase in V.FIT_PHASES:
        spans = [e for e in _xs(rec) if e.name == f"search.{phase}"]
        assert len(spans) == eval_fn.clock.laps[phase] > 0
        total = 0.0
        for e in spans:
            total += e.dur
        assert total == eval_fn.clock.seconds[phase], phase


def test_the_cpu_clock_is_read_on_sampled_generations():
    spec, data, masks = _problem()
    rec = TraceRecorder(capacity=1 << 14, clock=FakeClock())
    every = V.CPU_SAMPLE_EVERY
    with recording(rec):
        _search(spec, data, masks, gens=2 * every + 1)
    sampled = {e.args["gen"] for e in _xs(rec, "search.") if "cpu_ns" in e.args}
    assert sampled == {0, every, 2 * every}
    for e in _xs(rec, "search."):
        assert ("cpu_ns" in e.args) == (e.args["gen"] in sampled)
        assert "cpu_ns" not in e.args or (isinstance(e.args["cpu_ns"], int)
                                         and e.args["cpu_ns"] >= 0)


def test_each_generation_holds_its_seven_phases_at_its_gen():
    spec, data, masks = _problem()
    rec = TraceRecorder(capacity=1 << 12, clock=FakeClock())
    with recording(rec):
        _search(spec, data, masks, gens=4, searches=2)
    outer = [e for e in _xs(rec) if e.name in ("search.generation", "search.init")]
    phases = [e for e in _xs(rec, "search.") if e not in outer]
    assert Counter(e.name for e in outer) == {"search.generation": 8, "search.init": 2}
    assert [(e.args["search"], e.args["gen"]) for e in outer] == [
        (s, g) for s in (1, 2) for g in range(5)]
    for o in outer:
        inside = [p for p in phases if (p.args["search"], p.args["gen"])
                  == (o.args["search"], o.args["gen"])]
        want = V.FIT_PHASES if o.name == "search.generation" else V.FIT_PHASES[1:]
        assert [p.name for p in inside] == [f"search.{n}" for n in want]
        assert all(o.ts <= p.ts and p.ts + p.dur <= o.ts + o.dur for p in inside)
        assert inside[0].ts == o.ts and inside[-1].ts + inside[-1].dur == o.ts + o.dur
        if o.args["gen"] % V.CPU_SAMPLE_EVERY == 0:
            assert o.args["cpu_ns"] == sum(p.args["cpu_ns"] for p in inside)


def test_without_a_recorder_a_search_records_nothing():
    spec, data, masks = _problem()
    assert active() is NULL_TRACER
    eval_fn = _search(spec, data, masks, gens=5)
    assert eval_fn.clock.tracer is NULL_TRACER
    assert eval_fn.clock.generation_span(np.int32(3)) is NOOP_SPAN
    assert eval_fn.clock.searches == 1 and eval_fn.clock.laps["mutate"] == 5
    assert len(NULL_TRACER) == 0 and NULL_TRACER.dropped == 0
    assert NULL_TRACER.events() == []


def test_a_clock_made_under_a_recorder_keeps_it():
    """The clock holds the recorder it was made under, not the one that is
    current when it laps."""
    spec, data, masks = _problem()
    rec = TraceRecorder(capacity=1 << 12, clock=FakeClock())
    with recording(rec):
        eval_fn = V.make_eval_fn(spec, data, *masks)
    g = torch.Generator().manual_seed(1)
    V.init_state(g, spec, eval_fn)
    assert len(_xs(rec, "search.")) == 7 and len(NULL_TRACER) == 0


def test_a_pickled_clock_keeps_its_sums_and_leaves_its_recorder():
    spec, data, masks = _problem()
    rec = TraceRecorder(capacity=1 << 12, clock=FakeClock())
    with recording(rec):
        eval_fn = _search(spec, data, masks, gens=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        copy = pickle.loads(pickle.dumps(eval_fn.clock))
    assert copy.seconds == eval_fn.clock.seconds and copy.laps == eval_fn.clock.laps
    assert copy.tracer is NULL_TRACER and copy.searches == 1
    n = len(rec)
    copy.start()
    copy.lap("mutate")
    assert len(rec) == n and len(NULL_TRACER) == 0


def test_recording_restores_the_previous_recorder():
    a, b = TraceRecorder(), TraceRecorder()
    with recording(a) as got:
        assert got is a and active() is a
        with recording(b):
            assert active() is b
        assert active() is a
        with pytest.raises(KeyError):
            with recording(b):
                raise KeyError("inside")
        assert active() is a
    assert active() is NULL_TRACER


def test_complete_records_one_x_event_and_nothing_when_off():
    rec = TraceRecorder(clock=FakeClock())
    rec.complete("work", 1.5, 2.25, cat="c", track="t", k=1)
    assert rec.events() == [TraceEvent(1.5, "X", "work", "c", "t", {"k": 1}, None, 0.75)]
    rec.disable()
    rec.complete("more", 3.0, 4.0)
    assert len(rec) == 1
    NULL_TRACER.complete("never", 0.0, 1.0)
    assert len(NULL_TRACER) == 0


def _nested(rec, want):
    """Each (outer, inner) of ``want``: an ``inner`` span lies inside an
    ``outer`` one on the same track."""
    spans, stack = [], []
    for e in rec.events():
        if e.phase == "B":
            stack.append(e)
        elif e.phase == "E":
            b = stack.pop()
            spans.append((b.name, b.ts, e.ts, [s.name for s in stack]))
    for outer, inner in want:
        assert any(n == inner and outer in parents for n, _, _, parents in spans), (outer, inner)
    return Counter(n for n, *_ in spans)


def test_encoding_spans():
    rng = np.random.RandomState(0)
    x = rng.randn(100, 4).astype(np.float32)
    y = (x[:, 1] > 0).astype(np.int64)
    rec = TraceRecorder(capacity=1 << 12, clock=FakeClock())
    with recording(rec):
        enc = E.fit_encoder(x, E.EncodingConfig("quantize", 2))
        bits = E.encode(enc, x)
        data = E.pack_dataset(bits, y, 2, device="cpu")
        E.split_masks(100, data.x_words.shape[1], 0.5, seed=0, device="cpu")
    names = _nested(rec, [("encoding.split_masks", "encoding.pack"),
                          ("encoding.split_masks", "encoding.h2d")])
    assert names == {"encoding.fit_encoder": 1, "encoding.encode": 1, "encoding.pack": 6,
                     "encoding.h2d": 2, "encoding.split_masks": 1}
    assert all(e.cat == "encoding" for e in rec.events())


def test_predict_records_its_encode_and_pack():
    rng = np.random.RandomState(1)
    x = rng.randn(300, 3).astype(np.float32)
    y = (x[:, 0] + x[:, 2] > 0).astype(np.int64)
    clf = A.AutoTinyClassifier(n_gates=16, max_gens=20, device="cpu",
                               encodings=(E.EncodingConfig("quantile", 2),)).fit(x, y)
    rec = TraceRecorder(capacity=1 << 12, clock=FakeClock())
    with recording(rec):
        ids = clf.to_servable().predict(x[:70], device="cpu")
    assert ids.shape == (70,)
    assert [(e.phase, e.name) for e in rec.events()] == [
        ("B", "encoding.encode"), ("E", "encoding.encode"),
        ("B", "encoding.pack"), ("E", "encoding.pack")]


def _fake_library(monkeypatch, builds: int):
    """`load_library` over a fake build that runs ``nvcc`` ``builds`` times
    and a fake loader: the library's load path without a card."""
    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    def build():
        circuit_eval._builds += builds
        return "libfake.so"

    monkeypatch.setattr(circuit_eval, "_lib", None)
    monkeypatch.setattr(circuit_eval, "_builds", 0)
    monkeypatch.setattr(circuit_eval, "build_library", build)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: Lib())


@pytest.mark.parametrize("builds", [0, 1])
def test_load_library_span_says_whether_nvcc_ran(monkeypatch, builds):
    _fake_library(monkeypatch, builds)
    rec = TraceRecorder(clock=FakeClock())
    with recording(rec):
        lib = circuit_eval.load_library()
        assert circuit_eval.load_library() is lib   # loaded once: one span
    (e,) = rec.events()
    assert (e.phase, e.name, e.cat, e.dur) == ("X", "kernels.load_library", "kernels", 0.125)
    assert e.args == {"built": bool(builds)}


def test_program_library_span_says_whether_cxx_ran(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    for built in (True, False):
        monkeypatch.setattr(PG, "_lib", None)
        monkeypatch.setattr(PG, "_lib_loaded", False)
        rec = TraceRecorder(clock=FakeClock())
        with recording(rec):
            lib = PG.load_library()
            assert PG.load_library() is lib is not None   # loaded once: one span
        (e,) = rec.events()
        assert (e.phase, e.name, e.cat, e.dur) == (
            "X", "kernels.load_program_library", "kernels", 0.125)
        assert e.args == {"built": built}
    assert PG.library_path().exists() and PG.library_path().parent == tmp_path


@pytest.mark.cuda
def test_load_library_span_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    circuit_eval.load_library()
    monkeypatch.setattr(circuit_eval, "_lib", None)
    before = circuit_eval.build_count()
    rec = TraceRecorder()
    with recording(rec):
        circuit_eval.load_library()
    (e,) = rec.events()
    assert e.name == "kernels.load_library" and e.dur > 0
    assert e.args == {"built": circuit_eval.build_count() > before} == {"built": False}


def test_chrome_renders_complete_spans(tmp_path):
    spec, data, masks = _problem()
    rec = TraceRecorder(capacity=1 << 12, clock=FakeClock(step=0.5))
    with recording(rec):
        _search(spec, data, masks, gens=2)
    doc = to_chrome(rec)
    json.dumps(doc)
    xs = [d for d in doc["traceEvents"] if d["ph"] == "X"]
    assert len(xs) == len(_xs(rec)) == 1 + 6 + 2 * 8
    first = [d for d in xs if d["ts"] == 0.0]
    # the enclosing span comes first, then its first phase
    assert [d["name"] for d in first] == ["search.init", "search.compile"]
    for d, e in zip(sorted(xs, key=lambda d: (d["ts"], -d["dur"])),
                    sorted(_xs(rec), key=lambda e: (e.ts, -e.dur))):
        assert d["dur"] == e.dur * 1e6 and d["args"] == e.args and d["cat"] == "search"
    # a span left open closes where the last span ends, a complete one too
    window = [TraceEvent(0.5, "X", "long", "c", "t", None, None, 2.0),
              TraceEvent(1.0, "B", "open", "c", "t", None, None)]
    (close,) = [d for d in to_chrome(window)["traceEvents"] if d["ph"] == "E"]
    assert close["ts"] == 2.0e6
    path = tmp_path / "fit.jsonl"
    assert export_jsonl(rec, str(path)) == len(rec)
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert sum("dur" in x for x in lines) == len(xs)
    assert all(("dur" in x) == (x["ph"] == "X") for x in lines)
