"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips when no CUDA device is present (decided
inside the fixture, never at import).  This file imports neither JAX nor
the reference package, so it runs where only torch is installed.  Its
shapes and problems are `chip_smoke.py`'s own, so the two on-card checks
cannot drift apart:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import pytest
import torch

from chip_smoke import CHECK_SHAPES as SHAPES
from chip_smoke import random_population, span_case
from repro_torch.kernels import circuit_eval, ops
from repro_torch.kernels import ref as TR


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _problem(shape, seed):
    """The kernel-check problem `chip_smoke.py` builds for ``shape``."""
    g = torch.Generator().manual_seed(seed)
    return (*random_population(g, *shape), g)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_population_kernel_matches_plain(cuda, shape):
    opc, edge, outs, x, _ = _problem(shape, 0)
    want = TR.eval_population_packed(opc, edge, outs, x)
    before = circuit_eval.EVAL_POPULATION.launches
    got = ops.eval_population(*(t.to(cuda) for t in (opc, edge, outs, x)))
    torch.cuda.synchronize()
    assert circuit_eval.EVAL_POPULATION.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_spans_kernel_matches_plain(cuda, shape):
    opc, edge, outs, x, g = _problem(shape, 1)
    n_in, _, _, pop, w = shape
    woff, iw, span = span_case(g, n_in, pop, w)
    want = TR.eval_population_spans_packed(opc, edge, outs, x, woff, iw, span_words=span)
    before = circuit_eval.EVAL_POPULATION_SPANS.launches
    got = ops.eval_population_spans(
        *(t.to(cuda) for t in (opc, edge, outs, x, woff, iw)), span_words=span)
    torch.cuda.synchronize()
    assert circuit_eval.EVAL_POPULATION_SPANS.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_spans_kernel_isolation(cuda):
    """Rows at or past in_width read zero on the card too."""
    opc, edge, outs, x, _ = _problem((8, 10, 2, 1, 4), 2)
    poisoned, clean = x.clone(), x.clone()
    poisoned[5:] = 0x5EADBEEF
    clean[5:] = 0
    args = [t.to(cuda) for t in (opc, edge, outs)]
    woff, iw = torch.zeros(1, dtype=torch.int32, device=cuda), torch.full(
        (1,), 5, dtype=torch.int32, device=cuda)
    a = circuit_eval.eval_population_spans(*args, poisoned.to(cuda), woff, iw, span_words=4)
    b = circuit_eval.eval_population_spans(*args, clean.to(cuda), woff, iw, span_words=4)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_rejects_cpu_and_wrong_dtype(cuda):
    opc, edge, outs, x, _ = _problem((4, 10, 1, 1, 2), 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        circuit_eval.eval_population(opc.to(cuda), edge.to(cuda), outs, x.to(cuda))
    with pytest.raises(ValueError, match="int32"):
        circuit_eval.eval_population(opc.to(cuda), edge.to(cuda), outs.to(cuda),
                                     x.to(cuda, torch.int64))
