"""Plan swaps, shadow slots and `compile_from_placement` on the PyTorch port
against the reference, on the CPU.

The reference serves through its ``"ref"`` backend and the port with
``device="cpu"`` (its plain versions); both start from the same
reference-made circuits (`tests/torch_parity.py`).  Every comparison is
exact: placements, shard and plan content hashes, the seven refusals of
`compile_from_placement`, `RebalanceEvent`s in every field but
``swap_ms`` (a wall time), served class ids and shadow ids.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro.serve.circuits import CircuitServer as RefServer
from repro.serve.circuits import StalePlanError as RefStalePlanError
from repro.serve.planning import PlacementPolicy as RefPolicy
from repro.serve.planning import PlanCompiler as RefCompiler
from repro.serve.planning import ensemble_vote as ref_vote
from repro_torch.serve.circuits import CircuitServer, RebalanceEvent, StalePlanError
from repro_torch.serve.observability import TraceRecorder
from repro_torch.serve.planning import PlacementPolicy, PlanCompiler
from tests.torch_parity import golden_pair, make_ref_servable, rows_for, serving_registries, to_port


@dataclasses.dataclass
class Side:
    """One package's serving stack, driven in lockstep with the other's."""

    reg: object
    server: object
    policy: type
    compiler: type
    backend: str
    stale: type
    led: object  # the golden led bundle as this package loads it

    def recompile(self, **kw):
        return self.server.compiler.recompile(self.reg.catalog(), self.server.peek_plan(), **kw)


def _sides():
    ref_reg, reg = serving_registries()
    ref_led, led = golden_pair("led")
    return (Side(ref_reg, RefServer(ref_reg, backend="ref"), RefPolicy, RefCompiler, "ref",
                 RefStalePlanError, ref_led),
            Side(reg, CircuitServer(reg, device="cpu"), PlacementPolicy, PlanCompiler,
                 "torch-ref", StalePlanError, led))


def _grow(side):
    comp = side.compiler(side.backend, side.policy(n_shards=2))
    return comp.recompile(side.reg.catalog(), side.server.peek_plan()), {
        "compiler": comp, "action": "grow", "reason": "1 -> 2 shards"}


def _weights(side):
    """Observed load per tenant, the weighted rebalance's input."""
    return {t: float((i + 1) ** 2) for i, t in enumerate(side.reg)}


# the scripted sequence: (name, registry mutation, the plan to swap in)
SEQUENCE = [
    ("add", lambda s: s.reg.add("led2", s.led),
     lambda s: (s.recompile(), {"reason": "tenant added"})),
    ("remove", lambda s: s.reg.remove("t1"),
     lambda s: (s.recompile(), {"reason": "tenant removed"})),
    ("grow", lambda s: None, _grow),
    ("rebalance", lambda s: None,
     lambda s: (s.recompile(weights=_weights(s), max_imbalance=1.05),
                {"action": "rebalance", "reason": "load"})),
]


def _submit(side, seed, n_req=2):
    out = []
    for i, tenant in enumerate(side.reg):
        for j in range(n_req):
            x = rows_for(side.reg, tenant, 100 * seed + 10 * i + j, 5 + 13 * j)
            out.append((tenant, x, side.server.submit(tenant, x)))
    return out


def _event(e) -> dict:
    d = dataclasses.asdict(e)
    assert d.pop("swap_ms") >= 0.0
    return d


def _placement(plan) -> dict:
    return {t: [list(map(int, r)) for r in refs] for t, refs in plan.placement.items()}


def _same_plans(a, b) -> None:
    assert a.content_hash == b.content_hash
    assert [s.content_hash for s in a.shards] == [s.content_hash for s in b.shards]
    assert _placement(a) == _placement(b)
    assert a.generation == b.generation


def _warm(ref, port):
    for side in (ref, port):
        tickets = _submit(side, seed=0, n_req=1)
        side.server.tick()
        for _, _, t in tickets:
            side.server.result(t)


def test_swap_sequence_matches_reference():
    """Add, remove, grow 1 → 2 shards, weighted rebalance: each swap lands
    with requests pending; the events, plans and served ids are the
    reference's."""
    ref, port = _sides()
    _warm(ref, port)
    for step, (name, mutate, make) in enumerate(SEQUENCE, 1):
        events, served = [], []
        for side in (ref, port):
            mutate(side)
            tickets = _submit(side, seed=step)
            plan, kw = make(side)
            events.append(side.server.swap_plan(plan, **kw))
            report = side.server.tick()
            served.append(([side.server.result(t) for _, _, t in tickets], report))
            with pytest.raises(KeyError):  # each ticket is answered once
                side.server.result(tickets[0][2])
        assert isinstance(events[1], RebalanceEvent)
        assert _event(events[1]) == _event(events[0]), name
        assert events[1].inflight_requests == len(tickets)
        _same_plans(port.server.peek_plan(), ref.server.peek_plan())
        (want, rep_r), (got, rep_t) = served
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        for field in ("launches", "rows", "requests", "plan_shards", "shard_stats",
                      "tenant_rows", "generation"):
            assert getattr(rep_t, field) == getattr(rep_r, field), (name, field)
        # every served id is also the tenant's own predict
        for i in range(0, len(tickets), 3):
            tenant, x, _ = tickets[i]
            members = port.reg.members(tenant)
            want = ref_vote(np.stack([m.predict(x, device="cpu") for m in members]),
                            members[0].n_classes)
            np.testing.assert_array_equal(got[i], want)
    assert port.server.policy.n_shards == 2 and port.server.plan().n_shards == 2
    rep_t, rep_r = port.server.stats.report(), ref.server.stats.report()
    for key in ("n_rebalances", "shards_reused_frac"):
        assert rep_t[key] == rep_r[key], key
    assert rep_t["n_rebalances"] == len(SEQUENCE)


def _chain(n_steps: int):
    """Both packages' compilers driven through the first ``n_steps`` of the
    sequence (no server): the sticky plans a live server would hold."""
    ref, port = _sides()
    plans = []
    for side in (ref, port):
        comp = side.compiler(side.backend, side.policy())
        plan = comp.compile(side.reg.catalog())
        for name, mutate, _ in SEQUENCE[:n_steps]:
            mutate(side)
            if name == "grow":
                comp = side.compiler(side.backend, side.policy(n_shards=2))
                plan = comp.recompile(side.reg.catalog(), plan)
            elif name == "rebalance":
                plan = comp.recompile(side.reg.catalog(), plan, weights=_weights(side),
                                      max_imbalance=1.05)
            else:
                plan = comp.recompile(side.reg.catalog(), plan)
        plans.append((side, comp, plan))
    return plans


@pytest.mark.parametrize("n_steps", range(len(SEQUENCE) + 1))
def test_compile_from_placement_rebuilds_the_sticky_plan(n_steps):
    (ref, ref_comp, ref_plan), (port, comp, plan) = _chain(n_steps)
    _same_plans(plan, ref_plan)
    # the placement as a JSON file carries it: lists, not SlotRefs
    placement = json.loads(json.dumps(_placement(plan)))
    rebuilt = comp.compile_from_placement(port.reg.catalog(), placement, plan.n_shards)
    _same_plans(rebuilt, plan)
    for a, b in zip(rebuilt.shards, plan.shards):
        for name in ("opcodes", "edge_src", "out_src", "in_width", "out_width"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    ref_rebuilt = ref_comp.compile_from_placement(ref.reg.catalog(), placement,
                                                  ref_plan.n_shards)
    _same_plans(rebuilt, ref_rebuilt)


def _bad(case: str, placement: dict):
    """One of the seven placements `compile_from_placement` refuses, and
    the shard count it is offered with."""
    p = {t: [list(r) for r in refs] for t, refs in placement.items()}
    (a, b) = sorted(p)[:2]
    if case == "none":
        return None, 2
    if case == "unknown_member":
        p["ghost"] = [[0, 0]]
    elif case == "shard_out_of_range":
        p[a][0][0] = 5
    elif case == "slot_twice":
        p[b][0] = list(p[a][0])
    elif case == "missing_members":
        del p[a]
    elif case == "not_contiguous":
        p[a][0][1] = 99
    elif case == "empty_shard":
        return p, 3
    return p, 2


@pytest.mark.parametrize("case", ["none", "unknown_member", "shard_out_of_range",
                                  "slot_twice", "missing_members", "not_contiguous",
                                  "empty_shard"])
def test_compile_from_placement_refuses_what_the_reference_refuses(case):
    (ref, ref_comp, ref_plan), (port, comp, plan) = _chain(3)  # a 2-shard plan
    placement, n_shards = _bad(case, _placement(plan))
    with pytest.raises(ValueError) as want:
        ref_comp.compile_from_placement(ref.reg.catalog(), placement, n_shards)
    with pytest.raises(ValueError) as got:
        comp.compile_from_placement(port.reg.catalog(), placement, n_shards)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spans", [(1,), (4, 64, 256)])
def test_executable_keys_match_reference(spans):
    (_, ref_comp, ref_plan), (_, comp, plan) = _chain(3)
    want = ref_comp.executable_keys(ref_plan, spans)
    for backend in ("torch-ref", "cuda"):
        got = PlanCompiler(backend, comp.policy).executable_keys(plan, spans)
        assert got == {backend + k[len("ref"):]: v for k, v in want.items()}
        assert all(k.startswith(backend + "--") for k in got)


class _RacingRegistry:
    """A registry whose generation moves right after a swap's fast-path
    check reads it: the check under the plan lock must catch it."""

    def __init__(self, reg, mutate):
        self._reg, self._mutate, self._reads = reg, mutate, 0

    def __getattr__(self, name):
        return getattr(self._reg, name)

    @property
    def generation(self):
        gen = self._reg.generation
        self._reads += 1
        if self._reads == 1:
            self._mutate()
        return gen


@pytest.mark.parametrize("package", ["reference", "port"])
@pytest.mark.parametrize("where", ["fast_path", "under_the_lock"])
def test_stale_plan_is_refused(package, where):
    side = _sides()[package == "port"]
    side.server.plan()
    stale = side.recompile()
    late = make_ref_servable(77, 4, 2, 30, 2)
    late = late if package == "reference" else to_port(late)
    mutate = lambda: side.reg.add("late", late)  # noqa: E731
    before = side.server.peek_plan()
    if where == "fast_path":
        mutate()
    else:
        side.server.registry = _RacingRegistry(side.reg, mutate)
    with pytest.raises(side.stale, match="generation"):
        side.server.swap_plan(stale, action="grow")
    if where == "under_the_lock":
        assert side.server.registry._reads >= 2  # the check under the lock ran
        side.server.registry = side.reg
    assert side.server.peek_plan() is before  # nothing installed
    assert side.server.stats.rebalances == []
    assert "late" in side.server.plan().placement  # the server's own refresh sees it


def test_swap_reuses_device_state_and_repoints_the_policy():
    ref, port = _sides()
    _warm(ref, port)
    before = dict(port.server._dev)
    events = []
    for side in (ref, port):
        comp = side.compiler(side.backend, side.policy(n_shards=3))
        events.append(side.server.swap_plan(
            comp.recompile(side.reg.catalog(), side.server.plan()), compiler=comp,
            action="grow"))
    assert _event(events[1]) == _event(events[0])
    assert events[1].from_shards == 1 and events[1].to_shards == 3
    assert events[1].shards_reused + events[1].shards_rebuilt == 3
    for shard in port.server.plan().shards:
        if shard.content_hash in before:  # reused: the same state, not rebuilt
            assert port.server._dev[shard.content_hash] is before[shard.content_hash]
    late = make_ref_servable(78, 4, 2, 30, 2)
    port.reg.add("extra", to_port(late))
    assert port.server.plan().n_shards == 3  # the swapped policy governs refreshes


def test_swap_records_a_trace_instant():
    _, reg = serving_registries()
    tracer = TraceRecorder()
    server = CircuitServer(reg, device="cpu", tracer=tracer)
    server.plan()
    event = server.swap_plan(server.compiler.recompile(reg.catalog(), server.peek_plan()),
                             action="rebalance", reason="test")
    (inst,) = [e for e in tracer.events() if e.name == "plan.swap"]
    assert inst.args["action"] == "rebalance" and inst.args["reason"] == "test"
    assert inst.args["shards_reused"] == event.shards_reused == 1
    assert inst.args["generation"] == event.generation


def test_no_request_lost_or_double_answered_across_swap():
    ref, port = _sides()
    answers = []
    for side in (ref, port):
        tickets = {t: (side.server.submit(t, rows_for(side.reg, t, 7, 7)), None)
                   for t in side.reg}
        comp = side.compiler(side.backend, side.policy(n_shards=3))
        event = side.server.swap_plan(comp.recompile(side.reg.catalog(), side.server.plan()),
                                      compiler=comp, action="grow")
        assert event.inflight_requests == len(tickets)
        side.server.tick()
        answers.append({t: side.server.result(k) for t, (k, _) in tickets.items()})
        for k, _ in tickets.values():
            with pytest.raises(KeyError):  # exactly once: the ticket is consumed
                side.server.result(k)
        assert not side.server._results  # nothing double-buffered
    for tenant, ids in answers[1].items():
        np.testing.assert_array_equal(ids, answers[0][tenant])
        members = port.reg.members(tenant)
        want = ref_vote(np.stack([m.predict(rows_for(port.reg, tenant, 7, 7), device="cpu")
                                  for m in members]), members[0].n_classes)
        np.testing.assert_array_equal(ids, want)


def _shadow_stacks():
    """A tenant whose parent is served alone in both packages, and the
    candidate a shadow slot would score."""
    from repro.serve.circuits import CircuitRegistry as RefRegistry
    from repro_torch.serve.circuits import CircuitRegistry

    parent, cand = make_ref_servable(9, 5, 2, 40, 3), make_ref_servable(10, 5, 2, 40, 3)
    ref_reg, reg = RefRegistry(), CircuitRegistry()
    ref_reg.add("t", parent)
    reg.add("t", to_port(parent))
    return ((ref_reg, RefServer(ref_reg, backend="ref"), (parent, cand)),
            (reg, CircuitServer(reg, device="cpu"), (to_port(parent), to_port(cand))))


def test_shadow_member_is_excluded_from_the_served_vote():
    x = np.random.RandomState(5).randn(50, 5).astype(np.float32)
    seen = {}
    for label, (reg, server, (parent, cand)) in zip(("ref", "port"), _shadow_stacks()):
        want = server.predict("t", x)
        log = seen[label] = []
        server.shadow_hook = lambda tenant, shadow_ids, served, log=log: log.append(
            (tenant, np.asarray(shadow_ids[0]), np.asarray(served)))
        server.set_shadow("t", 2, 1)
        reg.add_ensemble("t", (parent, cand), replace=True)
        got = server.predict("t", x)
        np.testing.assert_array_equal(got, want)  # the candidate never votes
        tenant, shadow_ids, served = log[-1]
        assert tenant == "t" and shadow_ids.shape == (50,)
        np.testing.assert_array_equal(served, want)
        seen[label + "_ids"] = (want, shadow_ids)
        # promote: registry first, exclusion cleared after; a member count
        # that no longer matches disarms the exclusion
        reg.add_ensemble("t", (cand,), replace=True)
        seen[label + "_promoted"] = server.predict("t", x)
        server.clear_shadow("t")
        assert server.shadow_of("t") is None
    for a, b in zip(seen["port_ids"], seen["ref_ids"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(seen["port_ids"][1], to_port(
        make_ref_servable(10, 5, 2, 40, 3)).predict(x, device="cpu"))
    np.testing.assert_array_equal(seen["port_promoted"], seen["ref_promoted"])
    assert len(seen["port"]) == len(seen["ref"]) == 1


@pytest.mark.parametrize("n_members,n_shadow", [(1, 1), (2, 0), (2, 2), (3, -1)])
def test_set_shadow_validates_as_the_reference(n_members, n_shadow):
    (_, ref_server, _), (_, server, _) = _shadow_stacks()
    with pytest.raises(ValueError) as want:
        ref_server.set_shadow("t", n_members, n_shadow)
    with pytest.raises(ValueError) as got:
        server.set_shadow("t", n_members, n_shadow)
    assert str(got.value) == str(want.value)
    assert server.shadow_of("t") is None


def test_raising_shadow_hook_never_fails_the_tick():
    (_, ref_server, _), (reg, server, (parent, cand)) = _shadow_stacks()
    x = np.random.RandomState(6).randn(9, 5).astype(np.float32)
    want = server.predict("t", x)

    def hook(tenant, shadow_ids, served):
        raise RuntimeError("a scoring fault")

    server.shadow_hook = hook
    server.set_shadow("t", 2, 1)
    reg.add_ensemble("t", (parent, cand), replace=True)
    np.testing.assert_array_equal(server.predict("t", x), want)
    assert server.stats.report()["ticks"] == 2
