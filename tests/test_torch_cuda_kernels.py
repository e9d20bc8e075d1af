"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips when no CUDA device is present (decided
inside the fixture, never at import).  This file imports neither JAX nor
the reference package, so it runs where only torch is installed.  Its
shapes and problems are `chip_smoke.py`'s own, so the two on-card checks
cannot drift apart.  The kernels run live-gate programs
(`repro_torch.kernels.program`); each result is held to the genome-level
plain version and to the program-level one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

The fit path is held here too: the kernel at the fit's shape (λ mutated
children of a 300-gate genome), and short searches that must follow the
same trajectory through the kernel and through the plain versions.
"""
import numpy as np
import pytest
import torch

from chip_smoke import CHECK_SHAPES as SHAPES
from chip_smoke import FIT_CHECK, FIT_CHECK_WORDS, fit_population
from chip_smoke import corrupt_population, random_population, span_case, spans_by_genome
from repro_torch.core import encoding as E
from repro_torch.core.api import AutoTinyClassifier
from repro_torch.core.evolve import EvolveConfig, evolve_with_history, make_eval_fn
from repro_torch.core.genome import CircuitSpec
from repro_torch.kernels import circuit_eval, ops
from repro_torch.kernels import ref as TR
from repro_torch.kernels.program import compile_program


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _problem(shape, seed, make=random_population):
    """The kernel-check problem `chip_smoke.py` builds for ``shape``."""
    g = torch.Generator().manual_seed(seed)
    return (*make(g, *shape), g)


def _on(device, *ts):
    return [t.to(device) for t in ts]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_population_kernel_matches_plain(cuda, shape):
    opc, edge, outs, x, _ = _problem(shape, 0)
    want = TR.eval_population_packed(opc, edge, outs, x)
    before = circuit_eval.EVAL_POPULATION.launches
    got = ops.eval_population(*_on(cuda, opc, edge, outs, x))
    torch.cuda.synchronize()
    assert circuit_eval.EVAL_POPULATION.launches == before + 1
    assert torch.equal(got.cpu(), want)


def _spans_args(shape, g):
    n_in, _, _, pop, w = shape
    slots, woff, iw, live, span = span_case(g, n_in, pop, w)
    return (slots, woff, iw, live), span


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_spans_kernel_matches_plain(cuda, shape):
    """Slot gather inside the kernel: repeats, a negative slot id, a pad
    slot, mixed widths, misaligned / negative / off-the-end offsets."""
    opc, edge, outs, x, g = _problem(shape, 1)
    (slots, woff, iw, live), span = _spans_args(shape, g)
    want = spans_by_genome(opc, edge, outs, x, slots, woff, iw, live, span)
    prog = compile_program(opc, edge, outs, shape[0])
    assert torch.equal(TR.eval_program_spans(prog, x, slots, woff, iw, live,
                                             span_words=span), want)
    before = circuit_eval.EVAL_POPULATION_SPANS.launches
    got = ops.eval_program_spans(prog.to(cuda), *_on(cuda, x, slots, woff, iw, live),
                                 span_words=span)
    torch.cuda.synchronize()
    assert circuit_eval.EVAL_POPULATION_SPANS.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain_on_corrupt_genomes(cuda, shape):
    """Negative, forward and past-the-end ids and opcodes outside the table
    read what the reference reads, in both kernels."""
    opc, edge, outs, x, g = _problem(shape, 2, corrupt_population)
    prog = compile_program(opc, edge, outs, shape[0])
    got = circuit_eval.eval_program(prog.to(cuda), x.to(cuda))
    assert torch.equal(got.cpu(), TR.eval_population_packed(opc, edge, outs, x))
    (slots, woff, iw, live), span = _spans_args(shape, g)
    got = circuit_eval.eval_program_spans(prog.to(cuda), *_on(cuda, x, slots, woff, iw, live),
                                          span_words=span)
    want = spans_by_genome(opc, edge, outs, x, slots, woff, iw, live, span)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES[::3])
def test_uncompacted_program_matches_plain(cuda, shape):
    """The identity compaction (every gate kept) computes the same words."""
    opc, edge, outs, x, _ = _problem(shape, 3)
    full = compile_program(opc, edge, outs, shape[0], compact=False)
    got = circuit_eval.eval_program(full.to(cuda), x.to(cuda))
    assert torch.equal(got.cpu(), TR.eval_population_packed(opc, edge, outs, x))


@pytest.mark.cuda
@pytest.mark.parametrize("start", [1, 2, 3, 4])
def test_kernels_stage_from_misaligned_words(cuda, start):
    """Words whose first element is not 16-byte aligned take the 4-byte
    copies; an aligned start with a stride of 4k words the 16-byte ones."""
    n_in, w = 12, 64
    opc, edge, outs, _, g = _problem((n_in, 40, 2, 3, w), 4)
    flat = torch.randint(-2**31, 2**31 - 1, (start + n_in * w,), generator=g,
                         dtype=torch.int32)
    x = flat[start:].view(n_in, w)
    prog = compile_program(opc, edge, outs, n_in)
    base = flat.to(cuda)
    xd = base[start:].view(n_in, w)
    assert xd.is_contiguous()
    got = circuit_eval.eval_program(prog.to(cuda), xd)
    assert torch.equal(got.cpu(), TR.eval_population_packed(opc, edge, outs, x))
    slots = torch.tensor([2, 0, 1], dtype=torch.int32)
    woff = torch.tensor([0, 16, 33], dtype=torch.int32)
    iw = torch.tensor([n_in, 5, 0], dtype=torch.int32)
    live = torch.ones(3, dtype=torch.int32)
    got = circuit_eval.eval_program_spans(prog.to(cuda), xd, *_on(cuda, slots, woff, iw, live),
                                          span_words=16)
    want = spans_by_genome(opc, edge, outs, x, slots, woff, iw, live, 16)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_spans_kernel_isolation(cuda):
    """Rows at or past in_width read zero on the card too."""
    opc, edge, outs, x, _ = _problem((8, 10, 2, 1, 4), 2)
    poisoned, clean = x.clone(), x.clone()
    poisoned[5:] = 0x5EADBEEF
    clean[5:] = 0
    prog = compile_program(opc, edge, outs, 8).to(cuda)
    zero, one, five = (torch.full((1,), v, dtype=torch.int32, device=cuda) for v in (0, 1, 5))
    a = circuit_eval.eval_program_spans(prog, poisoned.to(cuda), zero, zero, five, one,
                                        span_words=4)
    b = circuit_eval.eval_program_spans(prog, clean.to(cuda), zero, zero, five, one,
                                        span_words=4)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_rejects_cpu_and_wrong_dtype(cuda):
    opc, edge, outs, x, _ = _problem((4, 10, 1, 1, 2), 3)
    prog = compile_program(opc, edge, outs, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        circuit_eval.eval_program(prog, x.to(cuda))
    with pytest.raises(ValueError, match="int32"):
        circuit_eval.eval_program(prog.to(cuda), x.to(cuda, torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("w", FIT_CHECK_WORDS)
def test_fit_shape_kernel_matches_plain(cuda, w):
    """λ mutated children of a 300-gate genome over 116 input rows, at the
    fit's W and a misaligned W."""
    opc, edge, outs, x, _ = _problem((*FIT_CHECK, w), 5, fit_population)
    prog = compile_program(opc, edge, outs, FIT_CHECK[0])
    got = circuit_eval.eval_program(prog.to(cuda), x.to(cuda)).cpu()
    assert torch.equal(got, TR.eval_population_packed(opc, edge, outs, x))
    assert torch.equal(got, TR.eval_program(prog, x))


def _learnable(n_classes: int, rows: int = 3000):
    rng = np.random.RandomState(n_classes)
    x = rng.randn(rows, 6).astype(np.float32)
    y = ((x[:, 0] > 0).astype(np.int64) + 2 * (x[:, 3] > 0.5)) % n_classes
    return x, y


@pytest.mark.cuda
@pytest.mark.parametrize("n_classes", [2, 3])
def test_short_fit_is_the_same_on_the_card_and_on_the_cpu(cuda, n_classes):
    """Draws come from one CPU generator and fitness is bitwise, so the
    search on the card (the kernel) makes the same choices as the search
    on the CPU (the plain versions); every evaluation of the card's run is
    one launch."""
    x, y = _learnable(n_classes)
    kw = dict(n_gates=64, encodings=(E.EncodingConfig("quantile", 2),), kappa=60,
              max_gens=150, seed=1)
    before = circuit_eval.EVAL_POPULATION.launches
    kernel = AutoTinyClassifier(**kw, device=cuda).fit(x, y, n_classes)
    launches = circuit_eval.EVAL_POPULATION.launches - before
    plain = AutoTinyClassifier(**kw, device="cpu").fit(x, y, n_classes)
    (rk,), (rp,) = kernel.records_, plain.records_
    assert launches == rk.generations + 1
    assert (rk.generations, rk.val_fitness, rk.train_fitness) == \
        (rp.generations, rp.val_fitness, rp.train_fitness)
    assert all(torch.equal(a, b) for a, b in zip(kernel.genome_, plain.genome_))
    np.testing.assert_array_equal(kernel.predict(x), plain.predict(x))


@pytest.mark.cuda
def test_search_history_is_the_same_through_the_kernel_and_the_plain_versions(cuda):
    x, y = _learnable(3)
    enc = E.fit_encoder(x, E.EncodingConfig("quantile", 4))
    bits = E.encode(enc, x)
    data = E.pack_dataset(bits, y, 3, device=cuda)
    masks = E.split_masks(len(y), data.x_words.shape[1], 0.5, 0, device=cuda)
    spec = CircuitSpec(bits.shape[1], 100, data.n_outputs)
    runs = []
    for backend in ("cuda", "torch-ref"):
        cfg = EvolveConfig(kappa=40, max_gens=120)
        eval_fn = make_eval_fn(spec, data, *masks, backend)
        runs.append(evolve_with_history(torch.Generator().manual_seed(0), spec, cfg, eval_fn))
    (fk, hk), (fp, hp) = runs
    for a, b in zip(hk, hp):
        np.testing.assert_array_equal(a, b)
    assert fk.gen == fp.gen and fk.best_val.tobytes() == fp.best_val.tobytes()
    assert all(torch.equal(a, b) for a, b in zip(fk.best, fp.best))
