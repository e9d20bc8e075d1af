"""The port's exporters against the reference's, byte for byte (CPU).

`to_chrome`, `export_chrome`, `export_jsonl` and `prometheus_text` are host
code, so the same inputs give the same JSON documents, the same files and
the same exposition text: trace windows with wrapped rings, orphan and
dangling B/E pairs and async orphans; `ServerStats` / `FrontendStats` fed
the same records (as objects and as report dicts); a fleet router's
report; and the `EvolutionManager` of a scripted run in each package.
"""
import json

import numpy as np
import pytest

from repro.serve import observability as RO
from repro.serve.circuits import metrics as RM
from repro_torch.serve import observability as PO
from repro_torch.serve.circuits import metrics as PM
from tests.test_torch_evolution import ManagerTwin, manager_parent, x4


class FakeClock:
    def __init__(self, t: float = 0.0, step: float = 0.0):
        self.t, self.step = t, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def events(mod, rows):
    return [mod.TraceEvent(*r) for r in rows]


# (ts, phase, name, cat, track, args, id)
WINDOWS = {
    "clean": [
        (0.5, "B", "tick", "tick", "ticker", {"shard": 0}, None),
        (0.75, "B", "encode", "tick", "ticker", None, None),
        (1.0, "E", "encode", "tick", "ticker", None, None),
        (1.25, "i", "fire", "scheduler", "sched", {"reason": "max_wait"}, None),
        (1.5, "E", "tick", "tick", "ticker", None, None),
        (1.75, "C", "queue.rows", "queue", "sched", {"value": 7}, None),
        (2.0, "b", "request", "request", "submit", {"tenant": "t0"}, 1),
        (2.25, "n", "request", "request", "sched", {"state": "fired"}, 1),
        (2.5, "e", "request", "request", "sched", {"outcome": "ok"}, 1),
    ],
    "orphans": [
        (1.0, "E", "evicted-open", "test", "main", None, None),
        (2.0, "B", "never-closed", "test", "main", {"k": np.int64(3)}, None),
        (2.5, "i", "mark", "test", "main", {"shape": (2, 3), "ok": True}, None),
        (2.75, "B", "inner", "test", "main", None, None),
        (3.0, "C", "empty", "test", "other", None, None),
        (3.5, "x", "future-shaped", "", "other", None, None),
    ],
    "async_orphans": [
        (1.0, "n", "request", "request", "main", None, 9),
        (1.5, "e", "request", "request", "main", None, 9),
        (2.0, "b", "request", "request", "main", None, 7),
        (2.1, "b", "request", "request", "main", {"again": 1}, 7),
        (2.2, "e", "request", "request", "main", None, 7),
        (2.3, "b", "nameless", "request", "main", None, None),
    ],
    "out_of_order": [
        (3.0, "i", "late", "test", "a", None, None),
        (1.0, "B", "early", "test", "a", None, None),
        (2.0, "E", "early", "test", "a", None, None),
        (1.0, "i", "tie", "test", "b", {"x": 1.5}, None),
    ],
    "empty": [],
}


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_chrome_and_jsonl_match_the_reference(window, tmp_path):
    rows = WINDOWS[window]
    doc = PO.to_chrome(events(PO, rows))
    assert doc == RO.to_chrome(events(RO, rows))
    assert json.dumps(doc) == json.dumps(RO.to_chrome(events(RO, rows)))
    paths = {}
    for name, mod in (("ref", RO), ("port", PO)):
        paths[name] = (tmp_path / f"{name}.json", tmp_path / f"{name}.jsonl")
        assert mod.export_chrome(events(mod, rows), str(paths[name][0])) == doc
        assert mod.export_jsonl(events(mod, rows), str(paths[name][1])) == len(rows)
    for a, b in zip(paths["port"], paths["ref"]):
        assert a.read_bytes() == b.read_bytes()
    assert json.loads(paths["port"][0].read_text()) == doc


def drive(mod, capacity, clock):
    """The same recorder calls in either package: spans, instants,
    counters and async spans, more events than the ring holds."""
    tr = mod.TraceRecorder(capacity=capacity, clock=clock)
    with tr.span("tick", cat="tick", track="ticker", shard=0):
        tr.instant("fire", cat="scheduler", track="sched", reason="deadline")
        with tr.span("launch", cat="kernel", track="ticker"):
            pass
    for i in range(6):
        rid = tr.next_id()
        tr.async_begin("request", rid, tenant=f"t{i % 2}")
        tr.counter("queue.rows", i, cat="queue")
        tr.async_instant("request", rid, state="fired")
        if i % 3:
            tr.async_end("request", rid, outcome="ok")
    tr.begin("open-at-end", cat="tick", track="ticker")
    return tr


@pytest.mark.parametrize("capacity", [4, 9, 1000])
def test_recorder_exports_match_the_reference(capacity, tmp_path):
    """A recorder whose ring wrapped (capacity 4 and 9) or did not: the
    same document, the same dropped count, the same files, also through
    `TraceRecorder.export_chrome` / `export_jsonl`."""
    ref = drive(RO, capacity, FakeClock(10.0, step=0.125))
    port = drive(PO, capacity, FakeClock(10.0, step=0.125))
    assert port.dropped == ref.dropped and (capacity == 1000) == (ref.dropped == 0)
    assert PO.to_chrome(port) == RO.to_chrome(ref)
    for suffix in ("json", "jsonl"):
        method = f"export_{'chrome' if suffix == 'json' else 'jsonl'}"
        out = {}
        for name, tr in (("ref", ref), ("port", port)):
            path = tmp_path / name / f"trace.{suffix}"   # the exporter makes the dir
            out[name] = (getattr(tr, method)(str(path)), path.read_bytes())
        assert out["port"] == out["ref"]


def tick(mod, requests, rows, latency, shard_stats):
    return mod.TickReport(
        generation=1, tenants=2, requests=requests, rows=rows, launches=len(shard_stats),
        span_words=2, latency_s=latency, occupancy=0.4, plan_shards=len(shard_stats),
        max_slots_per_launch=3, shard_stats=shard_stats, tenant_rows=(("t0", rows),),
        phase_s={p: 0.0001 * (k + 1) for k, p in enumerate(mod.TICK_PHASES)},
    )


def stats(mod):
    """`ServerStats` and `FrontendStats` fed the same records."""
    server = mod.ServerStats(backend="any", clock=FakeClock(0.0, step=0.25))
    for i in range(5):
        server.record(tick(mod, 3 + i, 40 + i, 0.001 * (i + 1),
                           ((0, 10, 64), (1, 5 + i, 64))))
    server.record_rebalance(mod.RebalanceEvent(
        action="grow", reason="scripted", generation=2, from_shards=1, to_shards=2,
        shards_reused=1, shards_rebuilt=1, inflight_requests=3, swap_ms=0.02,
        prev_hash="a", plan_hash="b"))
    front = mod.FrontendStats(backend="any")
    for i in range(4):
        front.record_submitted()
        front.record_poll(5 * i)
    front.record_rejected()
    front.record_shed(1)
    front.record_fire("deadline", 0.5, shards=(0, 1), reasons=["deadline", "max_wait"])
    front.record_fire("batch_full", 1.0, shards=(0,), reasons=["batch_full"])
    front.record_request(0.01, late=False)
    front.record_request(0.03, late=True)
    return server, front


FLEET = {
    "router": {"requests_routed": 500, "qps": 76.2, "migrations": 2, "n_hosts": 2,
               "plan_generation": 7, "draining": False, "name": "r0"},
    "hosts": {
        "h1": {"requests_routed": 197, "queue_rows": 0, "qps": 30.0, "alive": True},
        "h-0": {"requests_routed": 303, "queue_rows": 4, "qps": 46.2, "tenants": 2},
    },
}


@pytest.mark.parametrize("sections", ["server", "frontend", "both", "fleet", "all", "none"])
@pytest.mark.parametrize("as_dict", [False, True], ids=["objects", "reports"])
def test_prometheus_text_matches_the_reference(sections, as_dict):
    (rs, rf), (ps, pf) = stats(RM), stats(PM)
    if as_dict:
        rs, rf = rs.report(), rf.report()
        ps, pf = dict(rs), dict(rf)   # the same report dicts into both
    kw = {"server": lambda s, f: dict(server_stats=s),
          "frontend": lambda s, f: dict(frontend_stats=f),
          "both": lambda s, f: dict(server_stats=s, frontend_stats=f),
          "fleet": lambda s, f: dict(fleet=FLEET),
          "all": lambda s, f: dict(server_stats=s, frontend_stats=f, fleet=FLEET,
                                   namespace="ns"),
          "none": lambda s, f: {}}[sections]
    want = RO.prometheus_text(**kw(rs, rf))
    assert PO.prometheus_text(**kw(ps, pf)) == want
    assert (want == "") == (sections == "none")


def test_prometheus_evolution_section_matches_the_reference():
    """The manager of a scripted run in each package, as the object and as
    its report, beside the server's and front end's stats."""
    tw = ManagerTwin(manager_parent())
    tw.watch(accuracy_baseline=0.9)
    for i in range(3):
        tw.serve(x4(i, rows=16), labels=lambda ids: 1 - ids if i else ids)
        tw.step()
    want = RO.prometheus_text(evolution=tw.ref)
    assert PO.prometheus_text(evolution=tw.port) == want
    assert PO.prometheus_text(evolution=tw.port.report(), namespace="x") == \
        RO.prometheus_text(evolution=tw.ref.report(), namespace="x")
    assert 'repro_evolution_watched{loop="online"} 1' in want
    assert 'repro_evolution_divergence{loop="online",key="t"}' in want
    text = PO.prometheus_text(tw.pfe.server.stats, tw.pfe.stats, evolution=tw.port)
    assert "repro_evolution_feedback_rows" in text and "repro_server_qps" in text
