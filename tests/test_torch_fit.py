"""The port's search — packing, `make_eval_fn`, the 1+λ loop and
`AutoTinyClassifier.fit` — against the reference, on the CPU.

Exact wherever the computation is deterministic: the packed dataset and
masks, the fitness of the same children, and a replay in which the port's
pure `advance` is fed the reference's own children and tie-break draws.
The two packages cannot share a PRNG stream, so end-to-end fit quality is
held within a stated band.

The reference runs as `AutoTinyClassifier.fit` runs it: its own loop,
outside an outer ``jax.jit``, with the dataset as operands.  Where its
eval function is compared alone, it is compiled as that loop compiles
it: one jitted computation from the children, the dataset and masks as
operands.  The form matters at the last bit.  In it XLA sums the class
recalls by halving when C is a power of two (`fitness._class_sum`), while
called op by op, or jitted with the counts as operands, it sums left to
right.  Under an outer ``jax.jit`` that captures the dataset, XLA folds
the class counts into constants and multiplies by their reciprocals,
which moves some fitnesses by an ulp again.
"""
import dataclasses
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as RE
from repro.core.api import AutoTinyClassifier as RefClassifier
from repro.core.api import load_servable as ref_load_servable
from repro.core.evolve import EvolveConfig as RefConfig
from repro.core.evolve import evolve_packed as ref_evolve_packed
from repro.core.evolve import evolve_with_history as ref_evolve_with_history
from repro.core.evolve import init_state as ref_init_state
from repro.core.evolve import make_eval_fn as ref_make_eval_fn
from repro.core.genome import CircuitSpec as RefSpec
from repro.core.genome import Genome as RefGenome
from repro.core.genome import init_genome as ref_init_genome
from repro.core.mutate import mutate_children as ref_mutate_children
from repro_torch.core import api as A
from repro_torch.core import encoding as E
from repro_torch.core import evolve as V
from repro_torch.core import gates
from repro_torch.core.genome import CircuitSpec, genome_from_arrays, init_genome
from repro_torch.data import load_dataset, train_test_split
from repro_torch.runtime import NoCudaDeviceError
from tests.torch_parity import u32

GOLDEN = Path(__file__).resolve().parent / "torch_golden"


def _bits_labels(rows: int, n_feats: int, n_classes: int, seed: int):
    """Encoded bits of a learnable rule over seeded numpy rows."""
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, n_feats).astype(np.float32)
    y = ((x[:, 0] > 0).astype(np.int64) + 2 * (x[:, 2] > 0.5) + (x[:, 1] > 1)) % n_classes
    enc = RE.fit_encoder(x, RE.EncodingConfig("quantile", 2))
    return RE.encode(enc, x), y


class _Problem:
    """The same packed problem in both packages."""

    def __init__(self, rows=900, n_classes=3, n_nodes=40, n_out=None, seed=0):
        bits, y = _bits_labels(rows, 5, n_classes, seed)
        self.ref = RE.pack_dataset(bits, y, n_classes, n_out)
        w = self.ref.x_words.shape[1]
        self.ref_masks = RE.split_masks(rows, w, 0.5, seed=seed + 1)
        self.port = E.pack_dataset(bits, y, n_classes, n_out, device="cpu")
        self.port_masks = E.split_masks(rows, w, 0.5, seed=seed + 1, device="cpu")
        n_out = self.ref.n_outputs
        self.ref_spec = RefSpec(bits.shape[1], n_nodes, n_out, gates.FULL_FS)
        self.spec = CircuitSpec(bits.shape[1], n_nodes, n_out, gates.FULL_FS)

    def ref_eval(self):
        return ref_make_eval_fn(self.ref_spec, self.ref, *self.ref_masks)

    def ref_search_eval(self):
        """The reference's eval compiled as its loop compiles it: one jitted
        computation from the children, the dataset and masks as operands."""
        spec = self.ref_spec
        fn = jax.jit(lambda children, data, mtr, mva:
                     ref_make_eval_fn(spec, data, mtr, mva)(children))
        return lambda children: fn(children, self.ref, *self.ref_masks)

    def port_eval(self):
        return V.make_eval_fn(self.spec, self.port, *self.port_masks)


def _ref_draws(problem: _Problem, cfg: RefConfig):
    """The reference's per-generation draws (`evolve.py` generation_step):
    split the key into (key, k_mut, k_sel), mutate λ children of the given
    parent with k_mut, draw the tie-break uniforms from k_sel."""
    spec, rate = problem.ref_spec, cfg.rate(problem.ref_spec)

    @jax.jit
    def draws(key, gate_fn, edge_src, out_src):
        key, k_mut, k_sel = jax.random.split(key, 3)
        children = ref_mutate_children(k_mut, RefGenome(gate_fn, edge_src, out_src),
                                       spec, rate, cfg.lam)
        return key, children, jax.random.uniform(k_sel, (cfg.lam,))

    return lambda key, parent: draws(key, *(jnp.asarray(a.numpy()) for a in parent))


def _same_genome(port, ref) -> bool:
    return all(np.array_equal(a.numpy(), np.asarray(b)) for a, b in zip(port, ref))


def _bits(x) -> np.uint32:
    return np.float32(x).view(np.uint32)


# -- packing ----------------------------------------------------------------

@pytest.mark.parametrize("rows", [1, 31, 33, 257])
@pytest.mark.parametrize("n_classes", [2, 3, 10])
@pytest.mark.parametrize("pad", [1, 4])
def test_pack_dataset_is_bitwise_the_reference(rows, n_classes, pad):
    rng = np.random.RandomState(rows * n_classes + pad)
    bits = rng.randint(0, 2, (rows, 9)).astype(np.uint8)
    y = rng.randint(0, n_classes, rows)
    want = RE.pack_dataset(bits, y, n_classes, pad_words_to=pad)
    got = E.pack_dataset(bits, y, n_classes, pad_words_to=pad, device="cpu")
    assert got.n_classes == n_classes and got.n_outputs == want.n_outputs
    for name in ("x_words", "y_words", "class_words", "mask_words"):
        t = getattr(got, name)
        assert t.dtype == torch.int32 and t.is_contiguous() and t.device.type == "cpu"
        np.testing.assert_array_equal(u32(t), np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(E.class_code_bits(n_classes), RE.class_code_bits(n_classes))


@pytest.mark.parametrize("rows,pad,frac,seed", [(1, 1, 0.5, 0), (33, 1, 0.5, 3),
                                                 (257, 4, 0.3, 7), (1000, 2, 0.8, 11)])
def test_split_masks_are_bitwise_the_reference(rows, pad, frac, seed):
    w = RE.n_words(rows, pad)
    want = RE.split_masks(rows, w, frac, seed)
    got = E.split_masks(rows, w, frac, seed, device="cpu")
    for g, r in zip(got, want):
        assert g.shape == (w,) and g.dtype == torch.int32
        np.testing.assert_array_equal(u32(g), np.asarray(r))


def test_packing_defaults_to_the_card():
    """``device=None`` is the card, as for every entry point: packed data
    lands there, or packing raises without one; it never stays on the CPU."""
    bits = np.random.RandomState(0).randint(0, 2, (40, 6)).astype(np.uint8)
    y = np.arange(40) % 3
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDeviceError):
            E.pack_dataset(bits, y, 3)
        with pytest.raises(NoCudaDeviceError):
            E.split_masks(40, 2, 0.5, 0)
        return
    assert E.pack_dataset(bits, y, 3).device.type == "cuda"
    assert all(m.device.type == "cuda" for m in E.split_masks(40, 2, 0.5, 0))


# -- fitness of the same children --------------------------------------------

@pytest.mark.parametrize("n_classes,n_out", [(2, None), (3, None), (4, None), (8, None),
                                             (10, None), (3, 3)])
def test_make_eval_fn_is_bitwise_the_reference(n_classes, n_out):
    prob = _Problem(rows=700, n_classes=n_classes, n_out=n_out, n_nodes=48, seed=n_classes)
    ref_eval, port_eval = prob.ref_search_eval(), prob.port_eval()
    key = jax.random.key(n_classes)
    for _ in range(2):
        key, k1, k2 = jax.random.split(key, 3)
        children = ref_mutate_children(k2, ref_init_genome(k1, prob.ref_spec),
                                       prob.ref_spec, 0.2, 4)
        rft, rfv = ref_eval(children)
        ft, fv = port_eval(genome_from_arrays(*children))
        assert ft.dtype == fv.dtype == np.float32 and ft.shape == (4,)
        np.testing.assert_array_equal(ft.view(np.uint32), np.asarray(rft).view(np.uint32))
        np.testing.assert_array_equal(fv.view(np.uint32), np.asarray(rfv).view(np.uint32))


@pytest.mark.parametrize("n_classes", [3, 4, 8])
def test_init_state_is_bitwise_the_reference(n_classes):
    """The first parent is scored as the reference's `init_state` scores
    it: op by op, outside the loop (left to right even at C = 4, 8)."""
    prob = _Problem(rows=700, n_classes=n_classes, n_nodes=40, seed=n_classes)
    ref_eval, port_eval = prob.ref_eval(), prob.port_eval()
    for k in range(12):
        key = jax.random.key(k)
        genome = ref_init_genome(key, prob.ref_spec)
        want = ref_init_state(key, prob.ref_spec, ref_eval, seed_genome=genome)
        got = V.init_state(None, prob.spec, port_eval, seed_genome=genome_from_arrays(*genome))
        for name in ("parent_fit", "best_val", "best_train", "ref_val"):
            assert _bits(getattr(got, name)) == _bits(getattr(want, name)), name
        assert got.since == got.gen == 0


# -- the loop ----------------------------------------------------------------

@pytest.mark.parametrize("n_classes", [3, 4])
def test_replay_of_the_reference_draws_is_exact(n_classes):
    """300 generations: the port's `advance` on the reference's children
    and tie-break draws, with the port's own fitness, gives the history and
    final state of the reference's `evolve_with_history`, to the bit (at
    C = 4 the reference sums its recalls by halving, at C = 3 left to
    right)."""
    prob = _Problem(n_classes=n_classes)
    gens = 300
    rcfg = RefConfig(lam=4, kappa=10**6, max_gens=gens)
    cfg = V.EvolveConfig(lam=4, kappa=10**6, max_gens=gens)
    key = jax.random.key(7)
    r_final, (r_pf, r_bv, r_live) = ref_evolve_with_history(key, prob.ref_spec, rcfg,
                                                            prob.ref_eval())
    k_init, key = jax.random.split(key)
    eval_fn = prob.port_eval()
    state = V.init_state(None, prob.spec, eval_fn,
                         seed_genome=genome_from_arrays(*ref_init_genome(k_init, prob.ref_spec)))
    draws = _ref_draws(prob, rcfg)
    pf, bv, live, neutral = [], [], [], 0
    for _ in range(gens):
        live.append(V.not_terminated(state, cfg))
        key, children, u = draws(key, state.parent)
        children = genome_from_arrays(*children)
        ft, fv = eval_fn(children)
        nxt = V.advance(state, children, ft, fv, np.asarray(u), cfg)
        neutral += bool(nxt.parent is not state.parent and nxt.parent_fit == state.parent_fit)
        state = nxt
        pf.append(state.parent_fit)
        bv.append(state.best_val)
    assert neutral > 0
    np.testing.assert_array_equal(np.array(pf).view(np.uint32), np.asarray(r_pf).view(np.uint32))
    np.testing.assert_array_equal(np.array(bv).view(np.uint32), np.asarray(r_bv).view(np.uint32))
    np.testing.assert_array_equal(live, np.asarray(r_live))
    for name in ("parent_fit", "best_val", "best_train", "ref_val"):
        assert _bits(getattr(state, name)) == _bits(getattr(r_final, name)), name
    assert state.since == int(r_final.since) and state.gen == int(r_final.gen) == gens
    assert state.since.dtype == state.gen.dtype == np.int32
    assert _same_genome(state.parent, r_final.parent)
    assert _same_genome(state.best, r_final.best)


@pytest.mark.parametrize("kappa,gamma", [(40, 0.01), (25, 2.0)])
def test_replay_through_termination_matches_the_reference_search(kappa, gamma):
    """The reference's early-exit search (`evolve_packed`), replayed: the
    same generation count, fitnesses, bookkeeping and genomes."""
    prob = _Problem(rows=500, n_classes=2, n_nodes=30, seed=4)
    rcfg = RefConfig(lam=4, kappa=kappa, gamma=gamma, max_gens=500)
    cfg = V.EvolveConfig(lam=4, kappa=kappa, gamma=gamma, max_gens=500)
    key = jax.random.key(3)
    r_final = ref_evolve_packed(key, prob.ref_spec, rcfg, prob.ref, *prob.ref_masks)
    k_init, key = jax.random.split(key)
    eval_fn = prob.port_eval()
    state = V.init_state(None, prob.spec, eval_fn,
                         seed_genome=genome_from_arrays(*ref_init_genome(k_init, prob.ref_spec)))
    draws = _ref_draws(prob, rcfg)
    while V.not_terminated(state, cfg):
        key, children, u = draws(key, state.parent)
        children = genome_from_arrays(*children)
        state = V.advance(state, children, *eval_fn(children), np.asarray(u), cfg)
    assert state.gen == int(r_final.gen) < 500
    if gamma > 1:
        assert state.gen == kappa
    assert state.since == int(r_final.since) == kappa
    for name in ("parent_fit", "best_val", "best_train", "ref_val"):
        assert _bits(getattr(state, name)) == _bits(getattr(r_final, name)), name
    assert _same_genome(state.parent, r_final.parent)
    assert _same_genome(state.best, r_final.best)


def test_history_carries_terminated_states_and_the_clock_counts_every_step():
    prob = _Problem(rows=300, n_classes=2, n_nodes=20, seed=5)
    cfg = V.EvolveConfig(lam=2, gamma=2.0, kappa=25, max_gens=60)
    eval_fn = prob.port_eval()
    final, (pf, bv, live) = V.evolve_with_history(torch.Generator().manual_seed(0),
                                                  prob.spec, cfg, eval_fn)
    assert final.gen == 25 and live.sum() == 25 and live[:25].all()
    assert pf.dtype == bv.dtype == np.float32 and pf.shape == bv.shape == (60,)
    assert (pf[25:] == final.parent_fit).all() and (bv[25:] == final.best_val).all()
    assert (np.diff(pf) >= 0).all()                 # >= selection: never worse
    laps = eval_fn.clock.laps
    assert laps["launch"] == laps["readback"] == 26  # init + one per generation
    assert laps["mutate"] == 25 and laps["host_select"] == 26


def test_evolve_starts_from_seed_genome_and_is_deterministic():
    prob = _Problem(rows=300, n_classes=3, n_nodes=24, seed=6)
    cfg = V.EvolveConfig(lam=4, kappa=30, max_gens=80)
    seed_genome = genome_from_arrays(*ref_init_genome(jax.random.key(1), prob.ref_spec))
    runs = [V.evolve_packed(torch.Generator().manual_seed(9), prob.spec, cfg, prob.port,
                            *prob.port_masks, seed_genome=seed_genome) for _ in range(2)]
    assert runs[0].gen == runs[1].gen and _bits(runs[0].best_val) == _bits(runs[1].best_val)
    assert all(torch.equal(a, b) for a, b in zip(runs[0].best, runs[1].best))
    ft, _ = prob.port_eval()(V._stack1(seed_genome))
    assert runs[0].best_train >= 0 and runs[0].parent_fit >= ft[0]


# -- AutoTinyClassifier end to end -------------------------------------------

FIT_DATA = "wall-robot"   # 4 classes, 5,456 rows, 3 features
FIT_SEEDS = tuple(range(6))
FIT_KW = dict(n_gates=48, kappa=150, max_gens=400)
# |mean(port) - mean(reference)| of the best validation fitness over
# FIT_SEEDS.  Measured on this configuration over seeds 0-15 (CPU; run
# this file as a script to repeat it): the per-seed standard deviation is
# 0.059 for the port and 0.045 for the reference (pooled 0.053), so the
# difference of two 6-seed means has a standard error of
# 0.053 * sqrt(2 / 6) = 0.031; the band is 3 of them.
FIT_BAND = 0.09


def _fits(seeds):
    ds = load_dataset(FIT_DATA)
    tr, te = train_test_split(ds)
    port = [A.AutoTinyClassifier(encodings=(E.EncodingConfig("quantile", 2),), seed=s,
                                 device="cpu", **FIT_KW).fit(tr.x, tr.y, ds.n_classes)
            for s in seeds]
    ref = [RefClassifier(encodings=(RE.EncodingConfig("quantile", 2),), seed=s,
                         **FIT_KW).fit(tr.x, tr.y, ds.n_classes) for s in seeds]
    return ds, te, port, ref


@pytest.fixture(scope="module")
def fits():
    return _fits(FIT_SEEDS)


def test_fit_quality_lies_within_a_band_of_the_reference(fits):
    ds, te, port, ref = fits
    pv = np.mean([c.records_[0].val_fitness for c in port])
    rv = np.mean([c.records_[0].val_fitness for c in ref])
    assert abs(pv - rv) <= FIT_BAND, (pv, rv)
    assert pv > 2 / ds.n_classes                     # far above chance
    for c in port:
        rec = c.records_[0]
        assert 0 < rec.generations <= FIT_KW["max_gens"]
        assert rec.clock.laps["launch"] == rec.generations + 1
        assert c.balanced_score(te.x, te.y) > 1 / ds.n_classes
        assert 0 <= c.accuracy(te.x, te.y) <= 1


def test_port_fitted_bundle_predicts_the_same_ids_in_the_reference(fits, tmp_path):
    ds, te, port, _ = fits
    clf = port[0]
    ids = clf.predict(te.x)
    path = A.save_servable(clf.to_servable(), str(tmp_path / FIT_DATA))
    back = ref_load_servable(path)
    np.testing.assert_array_equal(back.predict(te.x, backend="ref"), ids)
    np.testing.assert_array_equal(A.load_servable(path).predict(te.x, device="cpu"), ids)
    np.testing.assert_array_equal(back.ref_stats, clf.ref_stats_)


def test_fit_keeps_the_best_encoding():
    ds = load_dataset("iris")
    clf = A.AutoTinyClassifier(encodings=A.DEFAULT_ENCODINGS[:2], seed=1, device="cpu",
                               n_gates=24, kappa=20, max_gens=40).fit(ds.x, ds.y)
    assert [r.encoding for r in clf.records_] == list(A.DEFAULT_ENCODINGS[:2])
    best = max(clf.records_, key=lambda r: r.val_fitness)
    assert clf.encoder_.bits == best.encoding.bits
    assert clf.spec_.n_inputs == ds.n_features * best.encoding.bits
    assert clf.n_classes_ == 3 and clf.ref_stats_.shape == (clf.spec_.n_inputs,)
    with pytest.raises(RuntimeError, match="fit"):
        A.AutoTinyClassifier(device="cpu").predict(ds.x)


def test_classifier_defaults_to_the_card():
    """`AutoTinyClassifier` and `ServableCircuit.predict` resolve no device
    to the card, and raise without one."""
    if torch.cuda.is_available():
        assert A.AutoTinyClassifier().device.type == "cuda"
        return
    with pytest.raises(NoCudaDeviceError):
        A.AutoTinyClassifier()
    sc = A.load_servable(str(GOLDEN / "led.circuit.npz"))
    with pytest.raises(NoCudaDeviceError):
        sc.predict(np.zeros((3, 7), np.float32))


@pytest.mark.parametrize("entry", [A.AutoTinyClassifier.__init__, A.ServableCircuit.predict,
                                   V.evolve_packed, V.evolve, E.pack_dataset, E.split_masks])
def test_entry_points_take_no_backend(entry):
    """A device picks the backend: the kernels on the card, the plain
    versions on the CPU.  Only `make_eval_fn` names a backend."""
    assert "backend" not in inspect.signature(entry).parameters
    assert "backend" not in {f.name for f in dataclasses.fields(V.EvolveConfig)}


def test_no_fallback_when_the_kernels_are_asked_for_on_the_cpu():
    """`make_eval_fn` follows the data's device by default; naming the
    kernels' backend for CPU data raises, and nothing carries on with the
    plain versions."""
    prob = _Problem(rows=200, n_classes=2, n_nodes=16, seed=8)
    children = V._stack1(init_genome(torch.Generator().manual_seed(0), prob.spec))
    assert prob.port_eval().backend.name == "torch-ref"
    kernel_eval = V.make_eval_fn(prob.spec, prob.port, *prob.port_masks, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel_eval(children)


if __name__ == "__main__":
    # The seed spread FIT_BAND is derived from:
    #   PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_fit.py
    _, _, port_fits, ref_fits = _fits(range(16))
    for name, clfs in (("port", port_fits), ("reference", ref_fits)):
        vals = [c.records_[0].val_fitness for c in clfs]
        print(name, np.round(vals, 3), "mean", np.mean(vals), "sd", np.std(vals, ddof=1))
