"""Online evolution on the card.

Marked ``cuda``: each test skips when no CUDA device is present (decided
inside the test, never at import).  This file imports neither JAX nor the
reference package, so it runs where only torch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_evolution.py

  * a refit's search through the kernel equals the same search through
    the plain versions on the card, from one generator on the same packed
    data and masks (the same best genome, validation fitness and
    generation count);
  * a background refit on the card while the front end's scheduler thread
    serves: every served id equals ``predict`` on the card of the circuit
    that served it, and the worker thread raises no warning;
  * the shadow scorer re-predicts on the serving stack's device.
"""
import itertools
import time
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import encoding as E
from repro_torch.core import evolve as V
from repro_torch.core.api import AutoTinyClassifier
from repro_torch.kernels import circuit_eval
from repro_torch.serve.async_frontend import AsyncCircuitServer
from repro_torch.serve.circuits import CircuitRegistry, CircuitServer, TenantQoS
from repro_torch.serve.evolution import (
    DriftConfig,
    EvolutionManager,
    PromotionPolicy,
    Promoter,
    RefitConfig,
    refit_circuit,
)
from repro_torch.serve.evolution.refit import _refit_key


def evolve_rows(n: int, *, shift: float, seed: int):
    """`benchmarks/serve_evolve.py`'s covariate shift with concept
    tracking: x ~ N(shift, 1) over 6 features, class 1 where x0 + x1 >
    2 shift."""
    r = np.random.RandomState(seed)
    x = (r.randn(n, 6) + shift).astype(np.float32)
    return x, (x[:, 0] + x[:, 1] > 2.0 * shift).astype(np.int64)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _parent(gens=200):
    """A parent fitted on the card on pre-shift rows (6 features, one
    4-bit quantile encoding, as `chip_smoke.py`'s evolve phase)."""
    x, y = evolve_rows(1500, shift=0.0, seed=1)
    return AutoTinyClassifier(n_gates=100, max_gens=gens, kappa=100, seed=1,
                              encodings=[E.EncodingConfig("quantile", 4)]).fit(x, y).to_servable()


@pytest.mark.cuda
@pytest.mark.parametrize("refit_index", [0, 1])
def test_refit_search_through_the_kernel_equals_the_plain_versions(refit_index):
    _card()
    live = _parent()
    x, y = evolve_rows(2048, shift=1.5, seed=2 + refit_index)
    cfg = RefitConfig(max_gens=400, kappa=150)
    before = circuit_eval.EVAL_POPULATION.launches
    got = refit_circuit("t", live, x, y, cfg, refit_index=refit_index)
    assert circuit_eval.EVAL_POPULATION.launches - before == got.generations + 1
    # the same search through the plain versions on the card, rebuilt as
    # `refit_circuit` builds it
    enc = E.fit_encoder(x, E.EncodingConfig(live.encoder.strategy, live.encoder.bits))
    data = E.pack_dataset(E.encode(enc, x), y, live.n_classes, live.spec.n_outputs,
                          device="cuda")
    masks = E.split_masks(len(y), data.x_words.shape[1], cfg.val_fraction,
                          seed=refit_index, device="cuda")
    eval_fn = V.make_eval_fn(live.spec, data, *masks, backend="torch-ref")
    before = circuit_eval.EVAL_POPULATION.launches
    plain = V.evolve(_refit_key("t", refit_index), live.spec, cfg.evolve_config(), eval_fn,
                     seed_genome=live.genome)
    assert circuit_eval.EVAL_POPULATION.launches == before
    assert got.generations == int(plain.gen)
    assert np.float32(got.val_fitness).tobytes() == plain.best_val.tobytes()
    assert all(torch.equal(a, b.cpu()) for a, b in zip(got.candidate.genome, plain.best))
    assert all(t.device.type == "cpu" for t in got.candidate.genome)
    assert got.candidate.lineage["search_generations"] == got.generations


@pytest.mark.cuda
def test_background_refit_on_the_card_while_the_front_end_serves():
    _card()
    parent = _parent()
    reg = CircuitRegistry()
    reg.add("t0", parent, qos=TenantQoS(max_batch=64, max_wait_s=0.002, default_deadline_s=30.0))
    fe = AsyncCircuitServer(CircuitServer(reg, device="cuda"))
    mgr = EvolutionManager(
        fe, drift=DriftConfig(window=512, min_rows=512, divergence_threshold=0.10),
        refit=RefitConfig(max_gens=600, kappa=300, min_replay_rows=1024),
        policy=PromotionPolicy(min_shadow_rows=256, min_labeled_rows=128,
                               min_accuracy_delta=-1.0),
        replay_capacity=1024)
    mgr.watch("t0")
    served, during = [], 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with fe:   # the scheduler thread fires; this thread steps
            deadline = time.monotonic() + 120.0
            for i in itertools.count():
                assert time.monotonic() < deadline, mgr.report()
                x, y = evolve_rows(64, shift=1.5, seed=100 + i)
                live = reg.members("t0")[0]
                fut = fe.enqueue("t0", x)
                ids = fut.result(timeout=30.0)
                fe.submit_feedback("t0", fut.request_id, y)
                served.append((x, ids, live))   # swaps happen only in step()
                during += mgr.worker.busy("t0")
                mgr.step()
                if mgr.counters["promotions"]:
                    break
        assert mgr.worker.join(timeout=60.0)
        mgr.stop()
    assert not [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    assert mgr.counters["refits_completed"] == 1 and mgr.counters["promotions"] == 1
    assert during >= 1
    for circuit in {id(c): c for _, _, c in served}.values():
        mine = [(x, ids) for x, ids, c in served if c is circuit]
        want = circuit.predict(np.concatenate([x for x, _ in mine]), device="cuda")
        np.testing.assert_array_equal(np.concatenate([ids for _, ids in mine]), want)


@pytest.mark.cuda
def test_shadow_scorer_predicts_on_the_servers_device():
    _card()
    parent = _parent(gens=50)
    reg = CircuitRegistry()
    reg.add("t0", parent)
    server = CircuitServer(reg, device="cuda")
    prom = Promoter(server, policy=PromotionPolicy(min_shadow_rows=8, min_labeled_rows=8))
    assert prom.scorer.device == server.device and server.device.type == "cuda"
    prom.install_shadow("t0", parent)
    x, _ = evolve_rows(40, shift=0.0, seed=3)
    served = server.predict("t0", x)
    before = circuit_eval.EVAL_POPULATION.launches
    prom.scorer.observe_labels("t0", x, served, served)
    assert circuit_eval.EVAL_POPULATION.launches == before + 1
    stats = prom.scorer.stats("t0")
    assert stats.rows == 40 and stats.agree_rows == 40
    assert stats.shadow_correct == stats.live_correct == stats.labeled_rows == 40
    assert prom.evaluate("t0").verdict == "promoted"
