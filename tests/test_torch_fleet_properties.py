"""Fleet placement and wire properties of the PyTorch port (Hypothesis),
held to the reference on every drawn input.

  * **rings** — owners and the moves a join or a leave makes equal the
    reference's exactly.  The reference's own join property bounds the
    moved share by 0.8 of the tenants and fails on hosts ['00', '1'],
    tenant '0', joiner '0' (one tenant, and it moves); the port is held
    to the reference's moves there, not to that bound;
  * **stability** — a join moves tenants only onto the joiner, a leave
    only the leaver's tenants;
  * **planner** — plans (assignment, pins, content hash) and LPT moves
    equal the reference's, and the override never raises the maximum;
  * **wire** — frames for drawn payloads equal the reference's byte for
    byte; drawn traces equal the reference's.
"""
import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.serve import fleet as RF  # noqa: E402
from repro.serve.fleet import transport as ref_transport  # noqa: E402
from repro_torch.serve import fleet as PF  # noqa: E402
from repro_torch.serve.fleet import transport as port_transport  # noqa: E402

VNODES = 32

host_names = st.sets(
    st.text(alphabet="abcdefgh0123456789", min_size=1, max_size=8),
    min_size=1, max_size=8,
).map(sorted)

tenant_names = st.sets(
    st.text(alphabet="tuvwxyz0123456789", min_size=1, max_size=10),
    min_size=1, max_size=80,
).map(sorted)


def moves(pkg, before_hosts, after_hosts, tenants):
    before = pkg.HashRing(before_hosts, vnodes=VNODES)
    after = pkg.HashRing(after_hosts, vnodes=VNODES)
    return [(t, before.owner(t), after.owner(t)) for t in tenants]


@given(hosts=host_names, tenants=tenant_names,
       joiner=st.text(alphabet="jk0123456789", min_size=1, max_size=8))
@example(hosts=["00", "1"], tenants=["0"], joiner="0")
@settings(max_examples=60, deadline=None)
def test_join_moves_equal_the_reference_and_only_reach_the_joiner(hosts, tenants, joiner):
    got = moves(PF, hosts, list(hosts) + [joiner], tenants)
    assert got == moves(RF, hosts, list(hosts) + [joiner], tenants)
    for _, old, new in got:
        assert new == old or new == joiner


@given(hosts=host_names.filter(lambda h: len(h) >= 2),
       tenants=tenant_names, leaver_idx=st.integers(0, 7))
@settings(max_examples=60, deadline=None)
def test_leave_moves_equal_the_reference_and_only_the_leavers(hosts, tenants, leaver_idx):
    leaver = hosts[leaver_idx % len(hosts)]
    rest = [h for h in hosts if h != leaver]
    got = moves(PF, hosts, rest, tenants)
    assert got == moves(RF, hosts, rest, tenants)
    for _, old, new in got:
        assert new != leaver and (old == leaver or new == old)


@given(hosts=host_names, tenants=tenant_names,
       loads=st.one_of(st.none(), st.just("equal"), st.just("drawn")),
       imbalance=st.sampled_from([1.0, 1.05, 1.25, 2.0]), data=st.data())
@settings(max_examples=40, deadline=None)
def test_plans_and_lpt_moves_equal_the_reference(hosts, tenants, loads, imbalance, data):
    if loads == "equal":
        loads = {t: 3.0 for t in tenants}
    elif loads == "drawn":
        loads = {t: data.draw(st.floats(0.0, 100.0, allow_nan=False)) for t in tenants}
    a = PF.FleetPlanner(vnodes=VNODES, imbalance_high=imbalance).plan(
        hosts, tenants, loads=loads, generation=5)
    b = RF.FleetPlanner(vnodes=VNODES, imbalance_high=imbalance).plan(
        hosts, tenants, loads=loads, generation=5)
    assert (a.hosts, a.assignment, a.pins, a.content_hash) == (
        b.hosts, b.assignment, b.pins, b.content_hash)
    assert sorted(a.assignment) == list(tenants)
    assert set(a.assignment.values()) <= set(hosts)
    if loads:
        ring = PF.FleetPlanner(vnodes=VNODES).plan(hosts, tenants)

        def max_load(plan):
            return max(sum(loads[t] for t in plan.tenants_of(h)) for h in hosts)

        assert max_load(a) <= max_load(ring)


leaves = st.one_of(
    st.none(), st.booleans(), st.integers(-2**40, 2**40),
    st.floats(allow_nan=False, allow_infinity=False), st.text(max_size=12),
    st.binary(max_size=40),
    st.builds(lambda a: np.asarray(a, np.float32),
              st.lists(st.floats(-1e6, 1e6, width=32), max_size=9)),
    st.builds(lambda a: np.asarray(a, np.int32), st.lists(st.integers(-2**31, 2**31 - 1),
                                                          max_size=9)),
)
payloads = st.recursive(
    leaves,
    lambda kids: st.one_of(st.lists(kids, max_size=4),
                           st.dictionaries(st.text(max_size=6), kids, max_size=4)),
    max_leaves=12,
)


@given(payload=st.dictionaries(st.text(max_size=8), payloads, max_size=5))
@settings(max_examples=80, deadline=None)
def test_frames_equal_the_reference_byte_for_byte(payload):
    assert port_transport.encode_frame(payload) == ref_transport.encode_frame(payload)


@given(shape=st.sampled_from(["skew", "diurnal", "spike"]), n_events=st.integers(1, 300),
       n_tenants=st.integers(1, 9), seed=st.integers(0, 2**31 - 1),
       duration=st.floats(0.5, 600.0))
@settings(max_examples=30, deadline=None)
def test_drawn_traces_equal_the_reference(shape, n_events, n_tenants, seed, duration):
    kw = dict(n_events=n_events, tenants=[f"t{i}" for i in range(n_tenants)], seed=seed,
              duration_s=duration)
    a, b = PF.generate(shape, **kw), RF.generate(shape, **kw)
    assert a.meta == b.meta
    assert [(e.t, e.tenant, e.rows, e.seed) for e in a.events] == [
        (e.t, e.tenant, e.rows, e.seed) for e in b.events]
