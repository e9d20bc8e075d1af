"""The search's program path on the card: one native compile into a pinned
buffer and one copy to the card a generation.

Marked ``cuda``: each test skips when no CUDA device is present (decided
inside the fixture, never at import).  This file imports neither JAX nor
the reference package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_program.py

The problem has the fit's shape (I = 116 inputs, n = 300 gates, λ = 4);
the NumPy route is the same search with the C++ compiler hidden.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import encoding as E
from repro_torch.core import evolve as V
from repro_torch.core.api import AutoTinyClassifier
from repro_torch.core.genome import CircuitSpec, opcodes
from repro_torch.kernels import native
from repro_torch.kernels import program as PG

FIELDS = ("gates", "n_live", "rows", "n_rows", "taps")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _table(rows: int = 20_000, feats: int = 29):
    rng = np.random.RandomState(17)
    x = rng.randn(rows, feats).astype(np.float32)
    y = ((x[:, 0] > 0.2) ^ (x[:, 3] * x[:, 5] > 0)).astype(np.int64)
    return x, y


def _problem(device):
    x, y = _table()
    enc = E.fit_encoder(x, E.EncodingConfig("quantile", 4))
    bits = E.encode(enc, x)
    data = E.pack_dataset(bits, y, 2, device=device)
    masks = E.split_masks(len(x), data.x_words.shape[1], 0.5, seed=17, device=device)
    return CircuitSpec(bits.shape[1], 300, 1), data, masks


class _Recorded(V.make_eval_fn):
    """`make_eval_fn` that keeps every call's fitnesses and, on every
    ``check_every``-th call, holds the program the kernel ran (copied back
    after its launch, in stream order) and the kernel's outputs to the
    NumPy program of the same genomes."""

    def __init__(self, *args, check_every: int = 0):
        super().__init__(*args)
        self.inner, self.backend = self.backend, self
        self.check_every, self.calls, self.checked, self.fits = check_every, 0, 0, []

    def __call__(self, genomes, **kw):
        self.genomes = genomes
        self.calls += 1
        ft, fv = super().__call__(genomes, **kw)
        self.fits.append((ft.copy(), fv.copy()))
        return ft, fv

    def eval_program(self, program, x_words):
        out = self.inner.eval_program(program, x_words)
        if self.check_every and self.calls % self.check_every == 0:
            g = self.genomes
            want = PG._compile_numpy(opcodes(g, self.spec), g.edge_src, g.out_src,
                                     self.spec.n_inputs)
            for k in FIELDS:
                assert torch.equal(getattr(program, k).cpu(), getattr(want, k)), k
            assert torch.equal(out, self.inner.eval_program(want.to(x_words.device), x_words))
            self.checked += 1
        return out


def _search(spec, data, masks, gens: int, *, seed: int = 23, check_every: int = 0,
            profile_from: "int | None" = None):
    eval_fn = _Recorded(spec, data, *masks, check_every=check_every)
    cfg = V.EvolveConfig(lam=4, kappa=100_000, max_gens=100_000)
    g = torch.Generator().manual_seed(seed)
    state = V.init_state(g, spec, eval_fn)
    prof = None
    for i in range(gens):
        if i == profile_from:
            torch.cuda.synchronize()
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        state = V.generation_step(state, g, spec, cfg, eval_fn)
    torch.cuda.synchronize()
    if prof is not None:
        prof.__exit__(None, None, None)
    return state, eval_fn, prof


def _hide_compiler(monkeypatch, build_dir) -> None:
    monkeypatch.setattr(PG, "_cxx", lambda: None)
    monkeypatch.setattr(native, "BUILD_DIR", build_dir)
    monkeypatch.setattr(PG, "_lib", None)
    monkeypatch.setattr(PG, "_lib_loaded", False)


@pytest.mark.cuda
def test_one_copy_a_generation_and_the_numpy_routes_fitnesses(cuda, monkeypatch, tmp_path):
    spec, data, masks = _problem(cuda)
    PG.reset_compile_count()
    state, fast, prof = _search(spec, data, masks, 110, profile_from=10)
    copies = [e for e in prof.events() if e.name.startswith("Memcpy HtoD")]
    assert len(copies) == 100
    assert PG.compile_counts() == {"native": 111, "numpy": 0}
    _hide_compiler(monkeypatch, tmp_path)
    plain_state, plain, _ = _search(spec, data, masks, 110)
    assert PG.compile_counts() == {"native": 111, "numpy": 111}
    assert len(fast.fits) == len(plain.fits) == 111
    for (ft, fv), (pt, pv) in zip(fast.fits, plain.fits):
        assert ft.tobytes() == pt.tobytes() and fv.tobytes() == pv.tobytes()
    for a, b in zip(state.parent, plain_state.parent):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_the_pinned_buffer_never_hands_the_kernel_a_stale_program(cuda):
    spec, data, masks = _problem(cuda)
    _, eval_fn, _ = _search(spec, data, masks, 2000, seed=29, check_every=100)
    assert eval_fn.calls == 2001 and eval_fn.checked == 20


@pytest.mark.cuda
def test_a_fit_on_the_card_compiles_natively(cuda):
    x, y = _table(4000, 6)
    PG.reset_compile_count()
    AutoTinyClassifier(n_gates=60, max_gens=200, device=cuda,
                       encodings=(E.EncodingConfig("quantile", 2),)).fit(x, y)
    counts = PG.compile_counts()
    assert counts["numpy"] == 0 and counts["native"] > 200
