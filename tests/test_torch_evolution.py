"""Online evolution on the PyTorch port, against the reference, on the CPU.

Exact wherever the computation is deterministic:

  * **drift** — both packages' `DriftDetector`s on the same bit batches
    and label feedback give the same verdicts (but the clock stamp) and
    the same `state()`, including on the input the reference's own
    ``test_guaranteed_trigger_under_large_shift`` fails on;
  * **refit** — the refit encoder, the packed words, the masks, the
    candidate's ``ref_stats``, ``parent_hash`` and lineage; and the
    reference's seeded search replayed through the port's
    `refit_circuit` (its draws fed to the port's `advance`) gives the
    same candidate, at a class count that is a power of two and one that
    is not;
  * **promote** — the same parent, candidate and shadow feed give the same
    `ShadowStats`, verdicts, `PromotionRecord`s (but ``swap_ms``),
    registry contents and served ids (the shadow slot's own cases, the
    vote exclusion and `set_shadow`'s refusals, are in
    `tests/test_torch_swap.py`);
  * **manager** — the reference's `EvolutionManager` scenarios under one
    fake clock with the refit injected (each package's module-global
    `refit_circuit` returns the same reference-made candidate): every
    `step()` summary, the counters, `report()`, the records (but
    ``swap_ms``), the served ids and the registry are equal.

The two packages cannot share a PRNG stream, so the port's own searches
are held to the reference's quality within a stated band.  Circuits are
made by the reference and carried into the port (`tests/torch_parity.py`);
the port runs with ``device="cpu"``, the reference with ``backend="ref"``.
"""
import dataclasses
import hashlib
import os
import sys
import threading
import warnings

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.serve.evolution.refit as ref_refit_mod
import repro_torch.serve.evolution.refit as refit_mod
import repro_torch.serve.evolution.refit_process as refit_process
from repro.core import encoding as RE
from repro.core.genome import Genome as RefGenome
from repro.core.mutate import mutate_children as ref_mutate_children
from repro.serve import evolution as R
from repro.serve.async_frontend import AsyncCircuitServer as RefFrontend
from repro.serve.circuits import CircuitRegistry as RefRegistry
from repro.serve.circuits import CircuitServer as RefServer
from repro.serve.planning import circuit_digest as ref_digest
from repro_torch.core import encoding as E
from repro_torch.core import evolve as V
from repro_torch.core.genome import genome_from_arrays
from repro_torch.device import NoCudaDeviceError
from repro_torch.serve import evolution as P
from repro_torch.serve.async_frontend import AsyncCircuitServer
from repro_torch.serve.circuits import CircuitRegistry, CircuitServer
from repro_torch.serve.planning import circuit_digest
from tests.test_evolution import make_servable as ref_make_servable
from tests.test_evolution import shifted_rows, stationary_rows
from tests.test_evolution_properties import CFG as REF_PROPERTY_CFG
from tests.test_evolution_properties import draw_bits, reference
from tests.torch_parity import to_port, u32

RNG = np.random.RandomState(0)


def pair(seed, **kw):
    """One reference-made servable, and the same circuit in the port."""
    sc = ref_make_servable(seed, **kw)
    return sc, to_port(sc)


def same_genome(port_genome, ref_genome) -> bool:
    return all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(port_genome, ref_genome))


# ---------------------------------------------------------------------------
# drift
# ---------------------------------------------------------------------------

def detectors(ref_stats, cfg_kw, **kw):
    """The same detector in both packages; the port's clock runs, the
    reference's stands still (the stamp is cosmetic)."""
    ticks = [0.0]

    def clock():
        ticks[0] += 1.5
        return ticks[0]

    return (R.DriftDetector(ref_stats, R.DriftConfig(**cfg_kw), **kw),
            P.DriftDetector(ref_stats, P.DriftConfig(**cfg_kw), clock=clock, **kw))


def same_verdict(vr, vp) -> None:
    assert vp._replace(at=0.0) == vr._replace(at=0.0)
    assert type(vp.divergence) is type(vr.divergence) is float


def feed(pair_, op) -> None:
    r, p = pair_
    if op[0] == "bits":
        same_verdict(r.observe_bits(op[1]), p.observe_bits(op[1]))
    else:
        same_verdict(r.observe_accuracy(*op[1:]), p.observe_accuracy(*op[1:]))
    assert p.state() == r.state()
    assert (p.drifted, p.rows_seen, p.accuracy, p.divergence) == (
        r.drifted, r.rows_seen, r.accuracy, r.divergence)
    assert (p.trigger is None) == (r.trigger is None)
    if r.trigger is not None:
        same_verdict(r.trigger, p.trigger)


ops = st.one_of(
    # bit batches: empty ones, and ones wider than the window
    st.tuples(st.just("bits"), st.integers(0, 160), st.floats(0.0, 0.5),
              st.integers(0, 2**16)),
    # label feedback: total <= 0 is a no-op in both
    st.tuples(st.just("acc"), st.integers(-2, 80), st.floats(0.0, 1.0)),
)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 10_000), seq=st.lists(ops, min_size=1, max_size=24),
       window=st.integers(1, 96), min_rows=st.integers(1, 200),
       baseline=st.one_of(st.none(), st.floats(0.3, 1.0)))
def test_detectors_agree_on_any_observation_sequence(seed, seq, window, min_rows, baseline):
    ref = reference(seed)
    cfg_kw = dict(window=window, min_rows=min_rows, divergence_threshold=0.15,
                  ph_delta=0.01, ph_lambda=0.3, accuracy_halflife=16.0,
                  min_accuracy_drop=0.05, min_labeled_rows=8)
    both = detectors(ref, cfg_kw, accuracy_baseline=baseline)
    for op in seq:
        if op[0] == "bits":
            _, rows, flip, s = op
            feed(both, ("bits", draw_bits(ref, rows, seed=s, flip=flip)))
        else:
            _, total, frac = op
            feed(both, ("acc", int(round(frac * max(total, 0))), total))
    # a reset against a new reference, then the same again
    new_ref = reference(seed + 1)
    for d in both:
        d.reset(new_ref, accuracy_baseline=baseline)
    assert both[1].state() == both[0].state()
    feed(both, ("bits", draw_bits(new_ref, 40, seed=seed, flip=0.3)))


def test_the_reference_failing_input_behaves_identically():
    """``test_guaranteed_trigger_under_large_shift`` fails in the reference
    on seed 0 with batches [16] * 8 (its window divergence stays under the
    threshold).  The port reads the same: neither detector trips, and the
    states are equal after every batch."""
    seed, batches = 0, [16] * 8
    ref = reference(seed)
    both = detectors(ref, dataclasses.asdict(REF_PROPERTY_CFG))
    feed(both, ("bits", draw_bits(ref, 128, seed=seed)))
    for i, rows in enumerate(batches):
        feed(both, ("bits", draw_bits(ref, rows, seed=seed * 37 + i, flip=0.45)))
    r, p = both
    assert not r.drifted and not p.drifted
    assert p.divergence == r.divergence and p.state() == r.state()


def _quiet(enc):
    return [E.encode(enc, stationary_rows(64, seed=i)) for i in range(20)]


def _shift(enc):
    return ([E.encode(enc, stationary_rows(128, seed=0))]
            + [E.encode(enc, shifted_rows(64, seed=i)) for i in range(8)]
            + [E.encode(enc, stationary_rows(64, seed=99))])


def _ramp(enc):
    return [E.encode(enc, shifted_rows(32, seed=i, shift=0.04 * i)) for i in range(60)]


# the reference's detector cases (`tests/test_evolution.py`), both packages
DETECTOR_CASES = {
    "quiet": (1, {}, _quiet, False),
    "covariate_shift": (2, {}, _shift, True),
    "page_hinkley_ramp": (3, dict(divergence_threshold=10.0, ph_delta=0.005,
                                  ph_lambda=0.30), _ramp, True),
}


@pytest.mark.parametrize("case", sorted(DETECTOR_CASES))
def test_reference_detector_cases_agree(case):
    seed, cfg_kw, batches, trips = DETECTOR_CASES[case]
    sc, _ = pair(seed)
    both = detectors(sc.ref_stats, {"window": 256, "min_rows": 128, **cfg_kw})
    for bits in batches(sc.encoder):
        feed(both, ("bits", bits))
    assert both[1].drifted is trips
    for d in both:
        d.reset()
    assert both[1].state() == both[0].state() and not both[1].drifted


def test_accuracy_channel_agrees():
    sc, _ = pair(4)
    both = detectors(sc.ref_stats, dict(min_labeled_rows=64, min_accuracy_drop=0.05,
                                        accuracy_halflife=32.0), accuracy_baseline=0.9)
    for correct in [29] * 4 + [16] * 8:
        feed(both, ("acc", correct, 32))
    assert both[1].drifted and both[1].trigger.reason == "accuracy"


@pytest.mark.parametrize("strategy,bits,rows", [("quantile", 2, 200), ("quantize", 4, 33),
                                                ("gray", 3, 1), ("onehot", 4, 0)])
def test_bit_activation_stats_is_bitwise_the_reference(strategy, bits, rows):
    rng = np.random.RandomState(bits + rows)
    fit_x = rng.randn(300, 6).astype(np.float32)
    x = (rng.randn(rows, 6) * 1.3 + 0.4).astype(np.float32)
    enc = E.fit_encoder(fit_x, E.EncodingConfig(strategy, bits))
    ref_enc = RE.fit_encoder(fit_x, RE.EncodingConfig(strategy, bits))
    got, want = P.bit_activation_stats(enc, x), R.bit_activation_stats(ref_enc, x)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


VALIDATION_CASES = {
    "window": lambda M: M.DriftConfig(window=0),
    "min_rows": lambda M: M.DriftConfig(min_rows=0),
    "threshold": lambda M: M.DriftConfig(divergence_threshold=0.0),
    "ph_lambda": lambda M: M.DriftConfig(ph_lambda=-1.0),
    "empty_reference": lambda M: M.DriftDetector(np.zeros(0, np.float32)),
    "bits_width": lambda M: M.DriftDetector(np.full(6, 0.5)).observe_bits(
        np.zeros((4, 3), np.uint8)),
    "bits_rank": lambda M: M.DriftDetector(np.full(6, 0.5)).observe_bits(
        np.zeros(6, np.uint8)),
    "replay_capacity": lambda M: M.ReplayBuffer(0),
    "replay_rows": lambda M: M.ReplayBuffer(10).extend(np.zeros((3, 2)), np.zeros(2)),
}


@pytest.mark.parametrize("case", sorted(VALIDATION_CASES))
def test_validation_errors_match_the_reference(case):
    make = VALIDATION_CASES[case]
    with pytest.raises(ValueError) as want:
        make(R)
    with pytest.raises(ValueError) as got:
        make(P)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# refit: the deterministic parts, and the seeded search replayed
# ---------------------------------------------------------------------------

def labelled_rows(n, n_feats, n_classes, seed, shift=1.5):
    """Shifted rows and a learnable rule over them."""
    x = shifted_rows(n, n_feats=n_feats, seed=seed, shift=shift)
    y = ((x[:, 0] + x[:, 1] > 2 * shift).astype(np.int64)
         + (x[:, 2] > shift + 0.5)) % n_classes
    return x, y


# class count → (parent seed, features, parent lineage, refit index); C = 2
# sums the class recalls by halving inside the reference's loop, C = 3 left
# to right (`fitness._class_sum`)
REFIT_CASES = {2: (31, 5, None, 0),
               3: (32, 4, {"refit_generation": 2, "parent_hash": "0" * 64}, 3)}
REFIT_KW = dict(max_gens=60, kappa=25, lam=4)


@pytest.fixture(scope="module", params=sorted(REFIT_CASES), ids=lambda c: f"C{c}")
def refit_case(request):
    """The reference's `refit_circuit` on one case, and its inputs."""
    c = request.param
    seed, n_feats, lineage, idx = REFIT_CASES[c]
    live = dataclasses.replace(ref_make_servable(seed, n_feats=n_feats, n_classes=c),
                               lineage=lineage)
    x, y = labelled_rows(300, n_feats, c, seed)
    want = R.refit_circuit("t", live, x, y, R.RefitConfig(**REFIT_KW), refit_index=idx)
    return live, to_port(live), x, y, idx, want


def test_refit_deterministic_parts_are_bitwise_the_reference(refit_case):
    live, port_live, x, y, idx, want = refit_case
    cand = want.candidate
    enc = E.fit_encoder(x, E.EncodingConfig(port_live.encoder.strategy,
                                            port_live.encoder.bits))
    assert enc.thresholds.tobytes() == np.asarray(cand.encoder.thresholds).tobytes()
    assert enc.codes.tobytes() == np.asarray(cand.encoder.codes).tobytes()
    bits = E.encode(enc, x)
    data = E.pack_dataset(bits, y, port_live.n_classes, port_live.spec.n_outputs,
                          device="cpu")
    ref_data = RE.pack_dataset(RE.encode(cand.encoder, x), y, live.n_classes,
                               live.spec.n_outputs)
    for name in ("x_words", "y_words", "class_words", "mask_words"):
        np.testing.assert_array_equal(u32(getattr(data, name)),
                                      np.asarray(getattr(ref_data, name)), err_msg=name)
    w = data.x_words.shape[1]
    for got, ref in zip(E.split_masks(len(y), w, 0.5, seed=idx, device="cpu"),
                        RE.split_masks(len(y), w, 0.5, seed=idx)):
        np.testing.assert_array_equal(u32(got), np.asarray(ref))
    assert P.bit_activation_stats(enc, x).tobytes() == cand.ref_stats.tobytes()
    assert circuit_digest(port_live) == want.parent_hash == ref_digest(live)
    # the port's own search: the same lineage keys, and the same values
    # of every key the search does not decide
    cfg = P.RefitConfig(**REFIT_KW, device="cpu")
    got = P.refit_circuit("t", port_live, x, y, cfg, refit_index=idx)
    assert set(got.candidate.lineage) == set(cand.lineage)
    for key in ("parent_hash", "refit_generation", "replay_rows", "seeded"):
        assert got.candidate.lineage[key] == cand.lineage[key], key
    assert got.candidate.ref_stats.tobytes() == cand.ref_stats.tobytes()
    assert got.candidate.encoder.thresholds.tobytes() == enc.thresholds.tobytes()
    assert (got.parent_hash, got.replay_rows, got.seeded) == (
        want.parent_hash, want.replay_rows, want.seeded)
    assert got.candidate.spec == port_live.spec
    assert all(t.device.type == "cpu" for t in got.candidate.genome)


def ref_draws(ref_spec, cfg: V.EvolveConfig):
    """The reference's per-generation draws (`evolve.generation_step`):
    split the key into (key, k_mut, k_sel), mutate λ children with k_mut,
    draw the tie-break uniforms from k_sel."""
    rate = cfg.rate(ref_spec)

    @jax.jit
    def draws(key, gate_fn, edge_src, out_src):
        key, k_mut, k_sel = jax.random.split(key, 3)
        children = ref_mutate_children(k_mut, RefGenome(gate_fn, edge_src, out_src),
                                       ref_spec, rate, cfg.lam)
        return key, children, jax.random.uniform(k_sel, (cfg.lam,))

    return lambda key, parent: draws(key, *(a.numpy() for a in parent))


def replaying_evolve_packed(ref_spec, tenant, idx, seen):
    """An `evolve_packed` for the port's `refit_circuit` that runs the
    port's `init_state` and `advance` on the reference's draws from
    ``_refit_key(tenant, idx)``.  The reference's `init_state` splits off
    ``k_init`` even when a seed genome is given."""
    def fake(generator, spec, cfg, data, mask_train, mask_val, seed_genome=None):
        seen.append(generator.initial_seed())
        eval_fn = V.make_eval_fn(spec, data, mask_train, mask_val)
        _, key = jax.random.split(ref_refit_mod._refit_key(tenant, idx))
        state = V.init_state(None, spec, eval_fn, seed_genome=seed_genome)
        draws = ref_draws(ref_spec, cfg)
        while V.not_terminated(state, cfg):
            key, children, u = draws(key, state.parent)
            children = genome_from_arrays(*children)
            state = V.advance(state, children, *eval_fn(children), np.asarray(u), cfg)
        return state

    return fake


def test_replayed_refit_search_is_the_reference_candidate(refit_case, monkeypatch):
    live, port_live, x, y, idx, want = refit_case
    seen = []
    monkeypatch.setattr(refit_mod, "evolve_packed",
                        replaying_evolve_packed(live.spec, "t", idx, seen))
    got = P.refit_circuit("t", port_live, x, y, P.RefitConfig(**REFIT_KW, device="cpu"),
                          refit_index=idx)
    assert seen == [int.from_bytes(hashlib.sha256(f"t:{idx}".encode()).digest()[:4], "big")]
    assert same_genome(got.candidate.genome, want.candidate.genome)
    assert np.float32(got.val_fitness).tobytes() == np.float32(want.val_fitness).tobytes()
    assert got.generations == want.generations
    assert got.candidate.lineage == want.candidate.lineage
    assert circuit_digest(got.candidate) == ref_digest(want.candidate)
    assert got.candidate.ref_stats.tobytes() == want.candidate.ref_stats.tobytes()
    assert got._replace(candidate=None, duration_s=0) == want._replace(
        candidate=None, duration_s=0)


def test_refit_is_deterministic_and_keyed_by_tenant_and_index():
    _, live = pair(6)
    x = shifted_rows(300, seed=1)
    y = RNG.randint(0, live.n_classes, 300).astype(np.int64)
    cfg = P.RefitConfig(max_gens=30, kappa=15, device="cpu")
    r1 = P.refit_circuit("t", live, x, y, cfg)
    r2 = P.refit_circuit("t", live, x, y, cfg)
    assert circuit_digest(r1.candidate) == circuit_digest(r2.candidate)
    assert r1.parent_hash == circuit_digest(live)
    lin = r1.candidate.lineage
    assert lin["parent_hash"] == r1.parent_hash
    assert lin["refit_generation"] == 1 and lin["seeded"]
    assert lin["search_generations"] == r1.generations <= 30
    # refit-of-a-refit deepens the line
    r3 = P.refit_circuit("t", r1.candidate, x, y, cfg, refit_index=1)
    assert r3.candidate.lineage["refit_generation"] == 2
    assert r1.candidate.spec == live.spec
    seeds = {refit_mod._refit_key(t, i).initial_seed() for t in ("t", "u") for i in range(3)}
    assert len(seeds) == 6
    with pytest.raises(ValueError, match=">= 2 rows"):
        P.refit_circuit("t", live, x[:1], y[:1], cfg)


# Candidate quality.  Measured on this configuration over seeds 0-15 (CPU;
# run this file as a script to repeat it): the held-out accuracy of a
# refit's candidate has a per-seed standard deviation of QUALITY_SD_PORT
# for the port and QUALITY_SD_REF for the reference; the difference of two
# means over QUALITY_SEEDS has a standard error of the pooled deviation
# times sqrt(2 / len(QUALITY_SEEDS)); the band is 3 of them.
QUALITY_SEEDS = tuple(range(4))
QUALITY_KW = dict(max_gens=500, kappa=200)
QUALITY_SD_PORT, QUALITY_SD_REF = 0.0432, 0.0467
QUALITY_BAND = (3 * np.sqrt((QUALITY_SD_PORT ** 2 + QUALITY_SD_REF ** 2) / 2)
                * np.sqrt(2 / len(QUALITY_SEEDS)))   # 0.0954


def quality_rows(n, seed, shift=1.5):
    """Shifted rows whose class is which side of x0 + x1 = 2 shift."""
    x = shifted_rows(n, n_feats=4, seed=seed, shift=shift)
    return x, (x[:, 0] + x[:, 1] > 2 * shift).astype(np.int64)


def quality(seeds):
    """Per seed: the held-out accuracy of the reference's and of the port's
    refit candidate, each refitting the same parent on the same rows."""
    rows = []
    for s in seeds:
        live = ref_make_servable(60 + s, n_feats=4, n_classes=2, n_nodes=40)
        x, y = quality_rows(512, seed=100 + s)
        tx, ty = quality_rows(1000, seed=200 + s)
        ref = R.refit_circuit("q", live, x, y, R.RefitConfig(**QUALITY_KW), refit_index=s)
        got = P.refit_circuit("q", to_port(live), x, y,
                              P.RefitConfig(**QUALITY_KW, device="cpu"), refit_index=s)
        rows.append(((ref.candidate.predict(tx, backend="ref") == ty).mean(),
                     (got.candidate.predict(tx, device="cpu") == ty).mean()))
    return np.array(rows)


def test_refit_quality_lies_within_a_band_of_the_reference():
    acc = quality(QUALITY_SEEDS)
    ref_mean, port_mean = acc.mean(axis=0)
    assert abs(port_mean - ref_mean) <= QUALITY_BAND, acc
    assert port_mean > 0.6, acc   # far above chance (0.5) on the shifted rows


# ---------------------------------------------------------------------------
# ReplayBuffer and RefitWorker (the reference's cases on the port)
# ---------------------------------------------------------------------------

def test_replay_buffer_bounds_and_snapshot():
    bufs = P.ReplayBuffer(capacity_rows=100), R.ReplayBuffer(capacity_rows=100)
    for i in range(10):
        sizes = [b.extend(np.full((30, 2), i, np.float32), np.full(30, i % 3, np.int64))
                 for b in bufs]
        assert sizes[0] == sizes[1]
    buf = bufs[0]
    assert len(buf) <= 100 + 30  # whole-block eviction overshoots one block
    x, y = buf.snapshot()
    assert x.shape[0] == y.shape[0] == len(buf)
    assert x[-1, 0] == 9
    for got, want in zip(buf.snapshot(), bufs[1].snapshot()):
        assert got.tobytes() == want.tobytes() and got.dtype == want.dtype
    assert buf.extend(np.zeros((0, 2)), np.zeros(0)) == len(buf)
    empty = P.ReplayBuffer().snapshot()
    assert empty[0].shape == (0, 0) and empty[1].shape == (0,)


def small_worker(**kw):
    return P.RefitConfig(**{"max_gens": 10, "kappa": 5, "min_replay_rows": 100,
                            "device": "cpu", **kw})


def test_refit_worker_rate_limits_and_cancels():
    _, live = pair(7)
    buf = P.ReplayBuffer(1000)
    buf.extend(stationary_rows(200, seed=3), RNG.randint(0, 3, 200).astype(np.int64))
    t = [0.0]
    done = []
    worker = P.RefitWorker(small_worker(min_interval_s=60.0), clock=lambda: t[0],
                           synchronous=True)
    assert not worker.request("t", live, P.ReplayBuffer(1000), done.append)  # too thin
    assert worker.request("t", live, buf, done.append)
    assert len(done) == 1 and worker.completed == 1 and not worker.busy()
    assert not worker.request("t", live, buf, done.append)  # rate-limited
    t[0] += 61.0
    assert worker.request("t", live, buf, done.append)
    assert len(done) == 2
    assert [r.candidate.lineage["refit_generation"] for r in done] == [1, 1]
    assert not worker.cancel("t")


def test_refit_worker_background_thread_delivers():
    _, live = pair(8)
    buf = P.ReplayBuffer(1000)
    buf.extend(stationary_rows(150, seed=4), RNG.randint(0, 3, 150).astype(np.int64))
    done = []
    worker = P.RefitWorker(small_worker())
    try:
        assert worker.request("t", live, buf, done.append)
        assert worker.join(timeout=60.0)
        assert len(done) == 1 and done[0].tenant == "t"
    finally:
        worker.stop()
    assert worker._thread is None


def test_cancelled_running_job_is_discarded(monkeypatch):
    """A job cancelled while its search runs (in the worker's process) is
    discarded on delivery."""
    _, live = pair(9)
    buf = P.ReplayBuffer(1000)
    buf.extend(stationary_rows(150, seed=5), RNG.randint(0, 3, 150).astype(np.int64))
    started, release = threading.Event(), threading.Event()
    real = refit_process.RefitProcess.refit

    def slow(self, *args, **kw):
        started.set()
        assert release.wait(30.0)
        return real(self, *args, **kw)

    monkeypatch.setattr(refit_process.RefitProcess, "refit", slow)
    done = []
    worker = P.RefitWorker(small_worker())
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert worker.request("t", live, buf, done.append)
            assert started.wait(30.0) and worker.busy("t")
            assert worker.cancel("t")
            release.set()
            assert worker.join(timeout=60.0)
        assert not [w for w in caught if issubclass(w.category, RuntimeWarning)]
    finally:
        release.set()
        worker.stop()
    assert done == [] and worker.discarded == 1 and worker.completed == 0
    assert not worker.busy("t")


def test_refit_worker_counters_are_updated_under_its_lock(monkeypatch):
    """The worker's departure from the reference: ``completed`` and
    ``discarded`` are written under its lock."""
    _, live = pair(10)
    buf = P.ReplayBuffer(1000)
    buf.extend(stationary_rows(150, seed=6), RNG.randint(0, 3, 150).astype(np.int64))

    class Guarded(P.RefitWorker):
        def __setattr__(self, key, value):
            if key in ("completed", "discarded") and key in self.__dict__:
                assert self._lock.locked(), f"{key} written without the lock"
            super().__setattr__(key, value)

    done = []
    worker = Guarded(small_worker(), synchronous=True)
    assert worker.request("t", live, buf, done.append)
    real = refit_mod.refit_circuit

    def cancelled_while_running(tenant, *args, **kw):
        worker.cancel(tenant)
        return real(tenant, *args, **kw)

    monkeypatch.setattr(refit_mod, "refit_circuit", cancelled_while_running)
    assert worker.request("u", live, buf, done.append)
    assert worker.completed == 1 and worker.discarded == 1 and len(done) == 1


def test_failed_background_search_warns_and_the_worker_survives(monkeypatch):
    """A search that raises in the worker's process comes back as a warning;
    the worker thread and its process serve the next job."""
    _, live = pair(10)
    buf = P.ReplayBuffer(1000)
    buf.extend(stationary_rows(150, seed=6), RNG.randint(0, 3, 150).astype(np.int64))
    thin = P.ReplayBuffer(1000)   # one row: refit_circuit refuses it
    thin.extend(stationary_rows(1, seed=6), np.zeros(1, np.int64))
    calls = []
    real = refit_process.RefitProcess.refit

    def counted(self, *args, **kw):
        calls.append(1)
        return real(self, *args, **kw)

    monkeypatch.setattr(refit_process.RefitProcess, "refit", counted)
    worker = P.RefitWorker(small_worker(min_replay_rows=1))
    try:
        with pytest.warns(RuntimeWarning, match="refit needs >= 2 rows"):
            assert worker.request("t", live, thin, lambda r: None)
            assert worker.join(timeout=30.0)
            worker._thread.join(0.2)
        pid = worker._child.pid
        got = []
        assert worker.request("t", live, buf, got.append)
        assert worker.join(timeout=30.0) and [r.tenant for r in got] == ["t"]
        assert worker._thread.is_alive() and worker._child.pid == pid
        assert worker.completed == 1
    finally:
        worker.stop()
    assert calls == [1, 1]


def test_process_worker_candidate_equals_inline_refit(refit_case):
    """A background worker runs the search in its own process; its result
    is the inline `refit_circuit`'s, bit for bit (the search's generator is
    seeded from the tenant and the refit index, not from the process)."""
    _, live, x, y, idx, _ = refit_case
    live = dataclasses.replace(live, lineage={"refit_generation": 1})
    cfg = P.RefitConfig(**REFIT_KW, min_replay_rows=1, device="cpu")
    want = P.refit_circuit("t", live, x, y, cfg, refit_index=idx)
    buf = P.ReplayBuffer(1000)
    buf.extend(x, y)
    done = []
    worker = P.RefitWorker(cfg)
    try:
        worker._counts["t"] = idx   # the tenant's next refit is attempt idx
        assert worker.request("t", live, buf, done.append)
        assert worker.join(timeout=120.0)
        assert worker._child.pid != os.getpid()
    finally:
        worker.stop()
    (got,) = done
    assert (got.tenant, got.parent_hash, got.val_fitness, got.generations, got.replay_rows,
            got.seeded) == (want.tenant, want.parent_hash, want.val_fitness,
                            want.generations, want.replay_rows, want.seeded)
    for a, b in zip(got.candidate.genome, want.candidate.genome):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got.candidate.lineage == want.candidate.lineage
    assert got.candidate.ref_stats.tobytes() == want.candidate.ref_stats.tobytes()
    assert got.candidate.encoder.thresholds.tobytes() == want.candidate.encoder.thresholds.tobytes()
    assert got.candidate.encoder.codes.tobytes() == want.candidate.encoder.codes.tobytes()
    assert (got.candidate.spec, got.candidate.n_classes) == (want.candidate.spec,
                                                             want.candidate.n_classes)
    assert worker.remote_launches == {"eval_population": 0, "eval_population_spans": 0}


def test_killed_refit_process_fails_the_job_loudly(monkeypatch):
    """A child killed during a job fails that job with a warning; nothing
    searches on the worker thread, and the next `start` replaces the child."""
    _, live = pair(12)
    buf = P.ReplayBuffer(1000)
    buf.extend(stationary_rows(150, seed=7), RNG.randint(0, 3, 150).astype(np.int64))
    inline = []
    monkeypatch.setattr(refit_mod, "refit_circuit", lambda *a, **k: inline.append(1))
    started = threading.Event()
    real = refit_process.RefitProcess.refit

    def killed(self, *args, **kw):
        self.proc.kill()
        self.proc.wait()
        started.set()
        return real(self, *args, **kw)

    monkeypatch.setattr(refit_process.RefitProcess, "refit", killed)
    done = []
    worker = P.RefitWorker(small_worker())
    try:
        with pytest.warns(RuntimeWarning, match="died during the job"):
            assert worker.request("t", live, buf, done.append)
            assert started.wait(60.0) and worker.join(timeout=60.0)
            worker._thread.join(0.2)
        assert done == [] and worker.completed == 0 and not worker.busy("t")
        old = worker._child.pid
        monkeypatch.setattr(refit_process.RefitProcess, "refit", real)
        assert worker.request("t", live, buf, done.append)
        assert worker.join(timeout=60.0) and len(done) == 1 and worker.completed == 1
        assert worker._child.pid != old
    finally:
        worker.stop()
    assert inline == []


def test_refit_process_that_cannot_start_raises(monkeypatch):
    """A child that exits before it is ready makes `start` raise, and a
    request that needed it raises too, leaving nothing in flight."""
    _, live = pair(13)
    buf = P.ReplayBuffer(1000)
    buf.extend(stationary_rows(150, seed=8), RNG.randint(0, 3, 150).astype(np.int64))
    monkeypatch.setattr(refit_mod, "refit_circuit", lambda *a, **k: pytest.fail("inline"))
    monkeypatch.setattr(refit_process, "child_argv",
                        lambda *a: [sys.executable, "-c", "import sys; sys.exit(3)"])
    worker = P.RefitWorker(small_worker())
    with pytest.raises(refit_process.RefitProcessError, match="code 3"):
        worker.start()
    with pytest.raises(refit_process.RefitProcessError, match="code 3"):
        worker.request("t", live, buf, lambda r: None)
    assert not worker.busy() and worker.completed == 0
    worker.stop()


def test_cancelled_queued_job_never_reaches_the_process(monkeypatch):
    """`cancel` drops a job queued behind a running one: it is never sent to
    the child, and `join` returns once both have left."""
    _, live = pair(14)
    buf = P.ReplayBuffer(1000)
    buf.extend(stationary_rows(150, seed=9), RNG.randint(0, 3, 150).astype(np.int64))
    sent, release = [], threading.Event()
    real = refit_process.RefitProcess.refit

    def held(self, tenant, *args, **kw):
        sent.append(tenant)
        assert release.wait(30.0)
        return real(self, tenant, *args, **kw)

    monkeypatch.setattr(refit_process.RefitProcess, "refit", held)
    done = []
    worker = P.RefitWorker(small_worker())
    try:
        assert worker.request("a", live, buf, done.append)
        assert worker.request("b", live, buf, done.append)
        assert worker.busy("b") and worker.cancel("b")
        assert not worker.join(timeout=0.2)
        release.set()
        assert worker.join(timeout=60.0)
    finally:
        release.set()
        worker.stop()
    assert sent == ["a"] and [r.tenant for r in done] == ["a"]
    assert worker.completed == 1 and worker.discarded == 0


def test_refit_defaults_to_the_card():
    """``RefitConfig.device=None`` is the card: `refit_circuit` packs onto
    it and `RefitWorker` resolves it at construction; without one both
    raise, and nothing carries on on the CPU."""
    _, live = pair(11)
    x = stationary_rows(64, seed=1)
    y = np.arange(64) % 3
    if torch.cuda.is_available():
        assert P.RefitWorker(P.RefitConfig()).cfg.device is None
        return
    with pytest.raises(NoCudaDeviceError):
        P.refit_circuit("t", live, x, y, P.RefitConfig(max_gens=2))
    with pytest.raises(NoCudaDeviceError):
        P.RefitWorker(P.RefitConfig())
    assert "backend" not in {f.name for f in dataclasses.fields(P.RefitConfig)}
    assert "backend" not in {f.name for f in dataclasses.fields(P.RefitConfig().evolve_config())}



# ---------------------------------------------------------------------------
# promote: the same shadow feed through both packages' Promoters
# ---------------------------------------------------------------------------

POLICY = dict(min_shadow_rows=32, min_labeled_rows=16, min_accuracy_delta=0.0,
              max_shadow_rows=200)


def record_view(rec) -> dict:
    """A `PromotionRecord` but its swap time."""
    d = dataclasses.asdict(rec)
    assert d.pop("swap_ms") >= 0.0
    return d


class PromoterTwin:
    """One parent serving in both packages, and one candidate to shadow."""

    def __init__(self):
        self.t = [0.0]
        self.parent, self.cand = ref_make_servable(12), ref_make_servable(13)
        self.rreg, self.preg = RefRegistry(), CircuitRegistry()
        self.rreg.add("t", self.parent)
        self.preg.add("t", to_port(self.parent))
        self.rserver = RefServer(self.rreg, backend="ref")
        self.pserver = CircuitServer(self.preg, device="cpu")
        clock = lambda: self.t[0]  # noqa: E731
        self.rprom = R.Promoter(self.rserver, policy=R.PromotionPolicy(**POLICY), clock=clock)
        self.pprom = P.Promoter(self.pserver, policy=P.PromotionPolicy(**POLICY), clock=clock)
        assert self.pprom.scorer.device == torch.device("cpu")

    def install(self):
        self.rprom.install_shadow("t", self.cand)
        self.pprom.install_shadow("t", to_port(self.cand))
        self.check()

    def feed(self, x, labels_of):
        """Serve rows in both (the launch hook scores agreement), then feed
        the same labels to both scorers."""
        served = self.rserver.predict("t", x)
        np.testing.assert_array_equal(self.pserver.predict("t", x), served)
        labels = labels_of(served)
        self.rprom.scorer.observe_labels("t", x, labels, served)
        self.pprom.scorer.observe_labels("t", x, labels, served)
        self.t[0] += 1.0
        self.check()
        return served

    def act(self, name, *args, **kw):
        want = getattr(self.rprom, name)("t", *args, **kw)
        got = getattr(self.pprom, name)("t", *args, **kw)
        assert (got is None) == (want is None)
        if want is not None:
            assert record_view(got) == record_view(want)
        self.check()
        return got

    def check(self):
        rs, ps = self.rprom.scorer.stats("t"), self.pprom.scorer.stats("t")
        assert (ps is None) == (rs is None)
        if rs is not None:
            assert ps.as_dict() == rs.as_dict()
            assert self.pprom.policy.decide(ps) == self.rprom.policy.decide(rs)
        assert self.pprom.shadowing("t") == self.rprom.shadowing("t")
        assert self.pprom.scorer.tracked() == self.rprom.scorer.tracked()
        assert self.pserver.shadow_of("t") == self.rserver.shadow_of("t")
        assert self.preg.generation == self.rreg.generation
        assert ([circuit_digest(m) for m in self.preg.members("t")]
                == [ref_digest(m) for m in self.rreg.members("t")])
        assert self.preg.get("t").lineage == self.rreg.get("t").lineage
        assert ([record_view(r) for r in self.pprom.records]
                == [record_view(r) for r in self.rprom.records])


def test_promotion_matches_the_reference():
    tw = PromoterTwin()
    tw.install()
    assert tw.pprom.shadowing("t") and len(tw.preg.members("t")) == 2
    x = stationary_rows(40, seed=6)
    tw.feed(x, lambda served: tw.cand.predict(x))    # the candidate always right
    rec = tw.act("evaluate")
    assert rec.verdict == "promoted" and tw.pserver.shadow_of("t") is None
    assert tw.preg.get("t").lineage["verdict"] == "promoted"
    np.testing.assert_array_equal(tw.pserver.predict("t", x), tw.cand.predict(x))


def test_rejection_matches_the_reference():
    tw = PromoterTwin()
    tw.install()
    # labels == served output: the live circuit is always right, so the
    # candidate never clears the bar and the window runs out
    for i in range(6):
        xi = stationary_rows(40, seed=10 + i)
        tw.feed(xi, lambda served: served)
        if i < 4:
            assert tw.act("evaluate") is None
    assert tw.act("evaluate").verdict == "rejected"
    assert len(tw.preg.members("t")) == 1 and not tw.pprom.shadowing("t")
    x = stationary_rows(40, seed=7)
    np.testing.assert_array_equal(tw.pserver.predict("t", x), tw.parent.predict(x))


def test_rollback_and_forget_parent_match_the_reference():
    tw = PromoterTwin()
    tw.install()
    x = stationary_rows(40, seed=8)
    tw.feed(x, lambda served: tw.cand.predict(x))
    assert tw.act("evaluate").verdict == "promoted"
    rec = tw.act("rollback", reason="canary regression", shadow={"post_accuracy": 0.25})
    assert rec.verdict == "rolled_back" and rec.parent_hash == ref_digest(tw.parent)
    np.testing.assert_array_equal(tw.pserver.predict("t", x), tw.parent.predict(x))
    assert [r.verdict for r in tw.pprom.records] == ["promoted", "rolled_back"]
    # a second candidate survives probation: its parent is forgotten
    tw.install()
    tw.feed(x, lambda served: tw.cand.predict(x))
    assert tw.act("evaluate").verdict == "promoted"
    tw.rprom.forget_parent("t")
    tw.pprom.forget_parent("t")
    for prom in (tw.rprom, tw.pprom):
        with pytest.raises(KeyError):
            prom.rollback("t")
    with pytest.raises(ValueError, match="already has a shadow"):
        tw.pprom.install_shadow("t", to_port(tw.cand))
        tw.pprom.install_shadow("t", to_port(tw.cand))


def test_shadow_scorer_predicts_on_the_servers_device():
    """The scorer re-predicts on the serving stack's device; with no device
    it is the card, which raises here rather than falling back."""
    _, cand = pair(13)
    scorer = P.ShadowScorer()
    scorer.track("t", cand)
    x = stationary_rows(8, seed=1)
    if torch.cuda.is_available():
        scorer.observe_labels("t", x, np.zeros(8, np.int64), np.zeros(8, np.int64))
        assert scorer.stats("t").labeled_rows == 8
        return
    with pytest.raises(NoCudaDeviceError):
        scorer.observe_labels("t", x, np.zeros(8, np.int64), np.zeros(8, np.int64))
    cpu = P.ShadowScorer("cpu")
    cpu.track("t", cand)
    cpu.observe_labels("t", x, cand.predict(x, device="cpu"), np.zeros(8, np.int64))
    assert cpu.stats("t").shadow_correct == 8


# ---------------------------------------------------------------------------
# manager: the reference's scenarios in both packages, refit injected
# ---------------------------------------------------------------------------

def inject_refit(monkeypatch, cand):
    """Patch both packages' module-global `refit_circuit` to return the same
    reference-made candidate (carried into the port), stamped with the
    lineage a search would give it.  Returns the calls each package made."""
    calls = {"ref": [], "port": []}

    def fake_for(name, pkg, digest, convert):
        def fake(tenant, live, x, y, cfg, *, refit_index=0):
            calls[name].append((tenant, refit_index, x.tobytes(), y.tobytes()))
            parent_hash = digest(live)
            lineage = {"parent_hash": parent_hash,
                       "refit_generation": int((live.lineage or {}).get(
                           "refit_generation", 0)) + 1,
                       "replay_rows": int(x.shape[0]), "val_fitness": 0.75,
                       "search_generations": 7, "seeded": bool(cfg.seed_from_live)}
            return pkg.RefitResult(tenant, convert(dataclasses.replace(cand, lineage=lineage)),
                                   parent_hash, 0.75, 7, int(x.shape[0]),
                                   cfg.seed_from_live, 0.0)
        return fake

    monkeypatch.setattr(ref_refit_mod, "refit_circuit", fake_for("ref", R, ref_digest,
                                                                 lambda c: c))
    monkeypatch.setattr(refit_mod, "refit_circuit", fake_for("port", P, circuit_digest,
                                                             to_port))
    return calls


MANAGER_DRIFT = dict(window=256, min_rows=128, min_labeled_rows=32, accuracy_halflife=32.0)
MANAGER_REFIT = dict(max_gens=20, kappa=10, min_replay_rows=64)
MANAGER_POLICY = dict(min_shadow_rows=32, min_labeled_rows=16, min_accuracy_delta=-1.0,
                      rollback_margin=0.2, rollback_window_rows=256)


class ManagerTwin:
    """The reference's `manager_stack` in both packages under one fake
    clock; every `step()` is held to the reference's."""

    def __init__(self, sc, *, drift=None, refit=None, policy=None, **kw):
        self.t = [0.0]
        clock = lambda: self.t[0]  # noqa: E731
        self.rreg, self.preg = RefRegistry(), CircuitRegistry()
        self.rreg.add("t", sc)
        self.preg.add("t", to_port(sc))
        self.rfe = RefFrontend(RefServer(self.rreg, backend="ref"), clock=clock)
        self.pfe = AsyncCircuitServer(CircuitServer(self.preg, device="cpu"), clock=clock)
        drift = {**MANAGER_DRIFT, **(drift or {})}
        refit = {**MANAGER_REFIT, **(refit or {})}
        policy = {**MANAGER_POLICY, **(policy or {})}
        self.ref = R.EvolutionManager(
            self.rfe, drift=R.DriftConfig(**drift), refit=R.RefitConfig(**refit),
            policy=R.PromotionPolicy(**policy), synchronous_refit=True, **kw)
        self.port = P.EvolutionManager(
            self.pfe, drift=P.DriftConfig(**drift),
            refit=P.RefitConfig(**refit, device="cpu"),
            policy=P.PromotionPolicy(**policy), synchronous_refit=True, **kw)
        self.summaries = []

    def watch(self, **kw):
        self.ref.watch("t", **kw)
        self.port.watch("t", **kw)
        self.check()

    def serve(self, x, labels=None):
        """One request through both front ends; ``labels(ids)`` (or an
        array) goes back as feedback.  Returns the ids and request id."""
        fr = self.rfe.enqueue("t", x, deadline_s=10.0)
        fp = self.pfe.enqueue("t", x, deadline_s=10.0)
        self.t[0] += 0.01
        self.rfe.pump(self.t[0])
        self.pfe.pump(self.t[0])
        ids = fr.result(timeout=5)
        np.testing.assert_array_equal(fp.result(timeout=5), ids)
        assert fp.request_id == fr.request_id
        if labels is not None:
            lab = labels(ids) if callable(labels) else labels
            assert (self.pfe.submit_feedback("t", fp.request_id, lab)
                    == self.rfe.submit_feedback("t", fr.request_id, lab))
        return ids, fr.request_id

    def step(self) -> dict:
        want = self.ref.step()
        got = self.port.step()
        assert got == want
        self.summaries.append(want)
        self.check()
        return want

    def check(self):
        assert self.port.counters == self.ref.counters
        assert self.port.report() == self.ref.report()
        assert ([record_view(r) for r in self.port.records]
                == [record_view(r) for r in self.ref.records])
        assert self.preg.generation == self.rreg.generation
        assert ([circuit_digest(m) for m in self.preg.members("t")]
                == [ref_digest(m) for m in self.rreg.members("t")])
        assert self.preg.get("t").lineage == self.rreg.get("t").lineage
        assert self.port.watched() == self.ref.watched()
        for t in self.ref.watched():
            assert self.port.detector(t).state() == self.ref.detector(t).state()
        assert self.port.promoter.shadowing("t") == self.ref.promoter.shadowing("t")
        assert self.pfe.server.shadow_of("t") == self.rfe.server.shadow_of("t")

    def drift_reasons(self) -> list:
        return [reason for s in self.summaries for _, reason in s["drift"]]


def x4(seed, rows=64, shift=None):
    return (stationary_rows(rows, n_feats=4, seed=seed) if shift is None
            else shifted_rows(rows, n_feats=4, seed=seed, shift=shift))


def manager_parent():
    return ref_make_servable(20, n_feats=4, n_classes=2, n_nodes=30)


def test_manager_accuracy_drift_to_promotion_and_rollback_matches(monkeypatch):
    """Accuracy drift → refit → shadow → promote → rollback."""
    calls = inject_refit(monkeypatch, ref_make_servable(25, n_feats=4, n_classes=2, n_nodes=30))
    tw = ManagerTwin(manager_parent(), policy=dict(rollback_margin=0.05))
    tw.watch(accuracy_baseline=0.9)
    for i in range(4):   # healthy: feedback agrees with the served output
        tw.serve(x4(i), labels=lambda ids: ids)
        tw.step()
    assert not tw.port.detector("t").drifted
    for i in range(30):  # labels flip: the accuracy EWMA collapses
        tw.serve(x4(100 + i), labels=lambda ids: 1 - ids)
        tw.step()
        if tw.ref.counters["promotions"]:
            break
    c = tw.port.counters
    assert c["drift_triggers"] == c["refits_completed"] == c["shadows_installed"] == 1
    assert c["promotions"] == 1 and tw.drift_reasons() == ["accuracy"]
    assert tw.preg.get("t").lineage["verdict"] == "promoted"
    for i in range(30):  # probation: still wrong → rollback
        tw.serve(x4(200 + i), labels=lambda ids: 1 - ids)
        tw.step()
        if tw.ref.counters["rollbacks"]:
            break
    assert tw.port.counters["rollbacks"] == 1
    assert circuit_digest(tw.preg.get("t")) == ref_digest(manager_parent())
    assert [r.verdict for r in tw.port.records] == ["promoted", "rolled_back"]
    assert len(calls["port"]) == len(calls["ref"]) == 1 and calls["port"] == calls["ref"]


def test_manager_covariate_drift_to_promotion_and_probation_matches(monkeypatch):
    """Covariate drift (divergence) → refit → shadow → promote on labeled
    evidence → the canary survives probation and its parent is released."""
    cand = ref_make_servable(26, n_feats=4, n_classes=2, n_nodes=30)
    calls = inject_refit(monkeypatch, cand)
    tw = ManagerTwin(manager_parent(), policy=dict(min_accuracy_delta=0.0),
                     observe_every=2)
    tw.watch()
    truth = lambda x: (lambda ids: cand.predict(x))  # noqa: E731 — the candidate's world
    for i in range(4):
        tw.serve(x4(i), labels=lambda ids: ids)
        tw.step()
    for i in range(60):
        x = x4(300 + i, shift=2.0)
        tw.serve(x, labels=truth(x))
        tw.step()
        if tw.ref.counters["promotions"]:
            break
    assert tw.drift_reasons() == ["divergence"] and tw.port.counters["promotions"] == 1
    rec = tw.port.records[-1]
    assert rec.shadow["accuracy_delta"] > 0
    for i in range(10):
        x = x4(400 + i, shift=2.0)
        tw.serve(x, labels=truth(x))
        tw.step()
    assert tw.port.report()["probation"] == 0 and tw.port.counters["rollbacks"] == 0
    assert "t" not in tw.port.promoter._parents
    assert calls["port"] == calls["ref"]


def test_manager_rejection_rearms_and_refits_again_matches(monkeypatch):
    """A candidate that never clears the bar is rejected; the detector
    re-arms and the next trip schedules refit index 1."""
    calls = inject_refit(monkeypatch, ref_make_servable(27, n_feats=4, n_classes=2, n_nodes=30))
    tw = ManagerTwin(manager_parent(), policy=dict(min_accuracy_delta=0.01,
                                                   max_shadow_rows=64))
    tw.watch()
    for i in range(40):  # shifted traffic on which the live circuit is right
        tw.serve(x4(500 + i, shift=2.0), labels=lambda ids: ids)
        tw.step()
        if tw.ref.counters["refits_scheduled"] >= 2:
            break
    c = tw.port.counters
    assert c["rejections"] >= 1 and c["refits_scheduled"] == 2 and c["promotions"] == 0
    assert [i for _, i, _, _ in calls["port"]] == [0, 1] and calls["port"] == calls["ref"]


def test_manager_observe_sampling_matches():
    """observe_every=k parks every k-th request for the detector; the
    feedback join and the replay buffer still see every request."""
    tw = ManagerTwin(ref_make_servable(22, n_feats=4, n_classes=2, n_nodes=30),
                     observe_every=3)
    tw.watch()
    for i in range(6):
        tw.serve(x4(40 + i, rows=8), labels=lambda ids: ids)
    tw.step()
    assert tw.port.counters["observed_rows"] == 2 * 8
    assert tw.port.detector("t").rows_seen == 2 * 8
    assert tw.port.counters["feedback_rows"] == 6 * 8
    assert len(tw.port._buffers["t"]) == 6 * 8
    for pkg, fe in ((R, tw.rfe), (P, tw.pfe)):
        with pytest.raises(ValueError, match="observe_every"):
            pkg.EvolutionManager(fe, observe_every=0, refit=pkg.RefitConfig(
                **({} if pkg is R else {"device": "cpu"})))
    tw.ref.stop()
    tw.port.stop()


def test_manager_requires_a_reference_for_v1_artifacts():
    sc = ref_make_servable(21, with_ref=False)
    tw = ManagerTwin(sc)
    errors = []
    for mgr in (tw.ref, tw.port):
        with pytest.raises(ValueError, match="reference") as err:
            mgr.watch("t")
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    tw.watch(reference=np.full(sc.encoder.n_bits_total, 0.5))
    assert tw.port.watched() == ("t",)
    tw.ref.unwatch("t")
    tw.port.unwatch("t")
    tw.check()
    assert tw.port.report()["watched"] == 0


def test_manager_feedback_joins_by_request_id():
    tw = ManagerTwin(manager_parent())
    tw.watch(accuracy_baseline=0.9)
    x = stationary_rows(16, n_feats=4, seed=3)
    ids, rid = tw.serve(x)
    for fe in (tw.rfe, tw.pfe):
        assert fe.submit_feedback("t", rid, ids) == 16
        assert fe.submit_feedback("t", rid, ids) == 0         # consumed
        assert fe.submit_feedback("t", 999_999, ids) == 0     # unknown id
        assert fe.submit_feedback("u", rid, ids) == 0         # not watched
    ids2, rid2 = tw.serve(x)
    errors = []
    for fe in (tw.rfe, tw.pfe):
        with pytest.raises(ValueError, match="labels") as err:
            fe.submit_feedback("t", rid2, ids[:3])
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    ids3, rid3 = tw.serve(x, labels=np.int64(1))    # a scalar broadcasts
    tw.step()
    assert tw.port.counters["feedback_rows"] == 32


def test_frontend_without_a_manager_rejects_feedback():
    sc, port_sc = pair(22)
    reg = CircuitRegistry()
    reg.add("t", port_sc)
    fe = AsyncCircuitServer(CircuitServer(reg, device="cpu"), clock=lambda: 0.0)
    rreg = RefRegistry()
    rreg.add("t", sc)
    rfe = RefFrontend(RefServer(rreg, backend="ref"), clock=lambda: 0.0)
    errors = []
    for f in (rfe, fe):
        with pytest.raises(RuntimeError, match="EvolutionManager") as err:
            f.submit_feedback("t", 1, [0])
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_manager_with_the_ports_own_refit():
    """The reference's mechanics test on the port with its own search (not
    injected): accuracy drift → refit → shadow → promote → rollback."""
    sc = to_port(manager_parent())
    reg = CircuitRegistry()
    reg.add("t", sc)
    t = [0.0]
    fe = AsyncCircuitServer(CircuitServer(reg, device="cpu"), clock=lambda: t[0])
    mgr = P.EvolutionManager(
        fe, drift=P.DriftConfig(**MANAGER_DRIFT),
        refit=P.RefitConfig(**MANAGER_REFIT, device="cpu"),
        policy=P.PromotionPolicy(**{**MANAGER_POLICY, "rollback_margin": 0.05}),
        synchronous_refit=True)
    mgr.watch("t", accuracy_baseline=0.9)

    def serve(x, flip):
        fut = fe.enqueue("t", x, deadline_s=10.0)
        t[0] += 0.01
        fe.pump(t[0])
        ids = fut.result(timeout=5)
        fe.submit_feedback("t", fut.request_id, 1 - ids if flip else ids)

    for i in range(4):
        serve(x4(i), flip=False)
        mgr.step()
    assert not mgr.detector("t").drifted
    for i in range(30):
        serve(x4(100 + i), flip=True)
        mgr.step()
        if mgr.counters["promotions"]:
            break
    assert mgr.counters["drift_triggers"] >= 1 and mgr.counters["refits_completed"] >= 1
    assert mgr.counters["shadows_installed"] >= 1 and mgr.counters["promotions"] == 1
    promoted = reg.get("t")
    assert promoted.lineage["verdict"] == "promoted"
    assert promoted.lineage["parent_hash"] == circuit_digest(sc)
    assert 0 < promoted.lineage["search_generations"] <= MANAGER_REFIT["max_gens"]
    for i in range(30):
        serve(x4(200 + i), flip=True)
        mgr.step()
        if mgr.counters["rollbacks"]:
            break
    assert mgr.counters["rollbacks"] == 1
    assert circuit_digest(reg.get("t")) == circuit_digest(sc)
    assert [r.verdict for r in mgr.records][-1] == "rolled_back"
    mgr.stop()


def test_manager_counters_are_updated_under_its_lock():
    """The departure from the reference: every counter update holds the
    manager's lock (the worker thread and feedback callers write them)."""
    _, sc = pair(23, n_feats=4, n_classes=2, n_nodes=30)
    reg = CircuitRegistry()
    reg.add("t", sc)
    fe = AsyncCircuitServer(CircuitServer(reg, device="cpu"), clock=lambda: 0.0)
    mgr = P.EvolutionManager(fe, refit=P.RefitConfig(device="cpu"))

    class Guarded(dict):
        def __setitem__(self, key, value):
            assert mgr._lock.locked(), f"counter {key!r} written without the lock"
            super().__setitem__(key, value)

    mgr.counters = Guarded(mgr.counters)
    mgr.watch("t")
    fut = fe.enqueue("t", x4(1, rows=8), deadline_s=10.0)
    fe.pump(1.0)
    assert fe.submit_feedback("t", fut.request_id, fut.result(timeout=5)) == 8
    mgr.step()
    mgr._on_refit_done(P.RefitResult("u", sc, "", 0.0, 0, 0, True, 0.0))
    assert mgr.counters["feedback_rows"] == mgr.counters["observed_rows"] == 8
    assert mgr.counters["refits_completed"] == 1 and mgr.report()["pending_candidates"] == 1

if __name__ == "__main__":
    # The seed spread QUALITY_BAND is derived from:
    #   PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_evolution.py
    acc = quality(range(16))
    sd_ref, sd_port = acc.std(axis=0, ddof=1)
    pooled = np.sqrt((sd_ref ** 2 + sd_port ** 2) / 2)
    print("per seed (reference, port):", acc.round(4).tolist())
    print(f"means {acc.mean(axis=0).round(4).tolist()}; sd reference {sd_ref:.4f}, "
          f"port {sd_port:.4f}, pooled {pooled:.4f}; band over {len(QUALITY_SEEDS)} seeds: "
          f"{3 * pooled * np.sqrt(2 / len(QUALITY_SEEDS)):.4f}")
