"""The MLP baseline trained on the card.

Marked ``cuda``: each test skips when no CUDA device is present (decided
inside the fixture, never at import).  Like `test_torch_cuda_kernels.py`
this file imports neither JAX nor the reference package, so it runs where
only torch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_baselines.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.baselines.mlp import (
    SMALLEST_MLP, mlp_params_from_arrays, mlp_predict, train_mlp)
from repro_torch.data import load_dataset, train_test_split


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [None, 2])
def test_train_mlp_puts_every_tensor_on_the_card(cuda, bits):
    ds = load_dataset("blood")
    tr, te = train_test_split(ds, 0.2, seed=0)
    cfg = dataclasses.replace(SMALLEST_MLP, weight_bits=bits, act_bits=bits, epochs=3)
    model, norm = train_mlp(tr.x, tr.y, ds.n_classes, cfg)  # device=None
    tensors = list(model.parameters()) + list(model.buffers())
    assert tensors and all(t.device.type == "cuda" for t in tensors)
    pred = mlp_predict(model, norm, te.x)
    assert pred.shape == (len(te.y),) and pred.min() >= 0 and pred.max() < ds.n_classes


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [None, 2])
def test_forward_on_the_card_matches_the_cpu(cuda, bits):
    """The same weights give the same logits on the card and on the CPU,
    within float32 matmul rounding (full float32: TF32 is off by
    default), away from the quantised levels' rounding boundaries."""
    rng = np.random.RandomState(0)
    cfg = dataclasses.replace(SMALLEST_MLP, weight_bits=bits, act_bits=bits)
    sizes = cfg.layer_sizes(7, 3)
    ws = [rng.randn(a, b).astype(np.float32) * np.sqrt(2 / a) for a, b in zip(sizes, sizes[1:])]
    bs = [rng.randn(b).astype(np.float32) * 0.1 for b in sizes[1:]]
    x = rng.randn(512, 7).astype(np.float32)
    with torch.no_grad():
        got = mlp_params_from_arrays(ws, bs, cfg)(torch.from_numpy(x).to(cuda)).cpu().numpy()
        want = mlp_params_from_arrays(ws, bs, cfg, "cpu")(torch.from_numpy(x)).numpy()
    close = np.abs(got - want).max(axis=1) <= 1e-4 * np.abs(want).max()
    # float: every row.  2-bit: a row may flip a level at a .5 boundary;
    # on an H100 every row agreed for weights and rows from seeds 0-15
    assert close.mean() >= (1.0 if bits is None else 0.99), close.mean()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(16))
def test_training_on_the_card_matches_the_cpu(cuda, seed):
    """The float smallest MLP trained on blood for 5 epochs (20 steps of
    autograd and `adam_update`) from one start, on the card and on the
    CPU.  The two differ by matmul summation order and by the card's
    division by a scalar (a product with its reciprocal), a few float32
    ulps a step.  Adam divides each update by the gradient's own scale,
    so a relative difference in a gradient passes to the update at the
    same size; only a gradient within rounding of zero can turn an update
    round, which a 1e-4 bound still shows (one such update moves a
    parameter by up to 2 lr = 6e-3).  Bound: 1e-4 of the largest
    parameter, and 99 % of the test predictions equal.  A wrong gradient
    or update on the card moves parameters by lr-sized steps and fails."""
    ds = load_dataset("blood")
    tr, te = train_test_split(ds, 0.2, seed=0)
    cfg = dataclasses.replace(SMALLEST_MLP, epochs=5)
    rng = np.random.RandomState(seed)
    sizes = cfg.layer_sizes(ds.n_features, ds.n_classes)
    ws = [rng.randn(a, b).astype(np.float32) * np.sqrt(2 / a) for a, b in zip(sizes, sizes[1:])]
    bs = [np.zeros(b, np.float32) for b in sizes[1:]]
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        init = mlp_params_from_arrays(ws, bs, cfg, dev)
        model, norm = train_mlp(tr.x, tr.y, ds.n_classes, cfg, device=dev, init=init)
        runs[dev.type] = ([p.detach().cpu().numpy() for p in model.parameters()],
                          mlp_predict(model, norm, te.x))
    (pc, yc), (ph, yh) = runs["cuda"], runs["cpu"]
    scale = max(float(np.abs(p).max()) for p in ph)
    diff = max(float(np.abs(a - b).max()) for a, b in zip(pc, ph))
    assert diff <= 1e-4 * scale, (diff, scale)
    assert (yc == yh).mean() >= 0.99
