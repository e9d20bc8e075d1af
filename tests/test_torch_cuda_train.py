"""Training on the card, at smoke size.

Marked ``cuda``: each test skips when no CUDA device is present (decided
inside the test, never at import).  This file imports neither JAX nor the
reference package, so it runs where only torch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train.py

  * a float32 step's gradients and three train steps on the card equal
    the same on the CPU from one start, within ``CARD_TOL`` (remat
    ``"full"``, so the checkpointed layers recompute on the card), for one
    arch of each block kind and granite-moe at capacity 1.0, dropping
    pairs;
  * 6 steps straight equal 3 steps, a checkpoint, a restore and 3 more,
    bitwise, on the card, with ``torch.use_deterministic_algorithms`` on
    and without it;
  * a checkpoint written from the card restores on the CPU bitwise, and
    `make_train_state` and `restore` default to the card.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenStream
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step
from repro_torch.train.optimizer import OptConfig, tree_leaves, tree_map
from repro_torch.train.train_step import make_train_state, make_train_step

# float32 card against CPU: the same operations, other reduction orders
# (cuBLAS, the card's softmax and sums), so every gradient leaf within a
# relative L2 of 5e-5 (a first run read 1.003e-5 on rwkv6's wkv path, past
# the 1e-5 first set; in float64 the same gap collapses to rounding,
# `test_rwkv6_card_gradient_gap_is_rounding`, so the limit stands as
# rounding) and the losses within 1e-5; Adam's first
# steps scale every gradient element to about ±lr, so an element whose
# gradient is near zero may move by up to 2 · lr · steps between the two
CARD_TOL = {"grad_rel": 5e-5, "loss_rel": 1e-5, "param_atol": 6e-3}
# rwkv6's card-against-CPU gradient gap in float64: rounding only if it
# falls below this (float64 carries 2^29 times float32's precision)
F64_GRAD_REL = 1e-10


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _cfg(arch, capacity=None):
    cfg = dataclasses.replace(get_config(arch).smoke(), remat="full")
    if capacity is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity))
    return cfg


def _steps(state, cfg, opt, start, n, microbatches=1):
    stream = TokenStream(vocab=cfg.vocab, batch=8, seq_len=32, seed=0)
    step = make_train_step(cfg, opt, microbatches=microbatches)
    losses = []
    for i in range(start, start + n):
        state, m = step(state, stream.batch_at(i))
        losses.append(float(m["loss"]))
    return state, losses


def _to(state, device):
    flat = ckpt._flatten(state)
    return ckpt._unflatten(state, {k: t.to(device) for k, t in flat.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("arch,capacity", [("minitron-8b", None), ("granite-moe-1b-a400m", None),
                                           ("granite-moe-1b-a400m", 1.0), ("rwkv6-7b", None),
                                           ("hymba-1.5b", None)])
def test_a_card_step_equals_the_cpu_step(arch, capacity):
    _card()
    cfg = _cfg(arch, capacity)
    opt = OptConfig(lr=1e-3)
    cpu = make_train_state(torch.Generator().manual_seed(0), cfg, opt, "cpu")
    card = _to(cpu, "cuda")
    batch = TokenStream(vocab=cfg.vocab, batch=8, seq_len=32, seed=0).batch_at(0)
    _, _, g_cpu = train_step._value_and_grad(cpu.params, cfg, {
        k: torch.as_tensor(v) for k, v in batch.items()})
    _, _, g_card = train_step._value_and_grad(card.params, cfg, {
        k: torch.as_tensor(v, device="cuda") for k, v in batch.items()})
    gaps = [float((a.cpu() - b).norm() / b.norm()) for a, b in zip(tree_leaves(g_card),
                                                                  tree_leaves(g_cpu))]
    assert max(gaps) <= CARD_TOL["grad_rel"], gaps
    cpu, l_cpu = _steps(cpu, cfg, opt, 0, 3)
    card, l_card = _steps(card, cfg, opt, 0, 3)
    for a, b in zip(l_card, l_cpu):
        assert abs(a - b) <= CARD_TOL["loss_rel"] * abs(b), (l_card, l_cpu)
    assert all(t.device.type == "cuda" for t in tree_leaves(card))
    for a, b in zip(tree_leaves(card.params), tree_leaves(cpu.params)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=CARD_TOL["param_atol"])


@pytest.mark.cuda
@pytest.mark.parametrize("deterministic", [True, False])
def test_resume_is_bitwise_on_the_card(tmp_path, deterministic, monkeypatch):
    _card()
    if deterministic:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = _cfg("granite-moe-1b-a400m")
    opt = OptConfig(lr=1e-3)

    def fresh():
        return make_train_state(torch.Generator(device="cuda").manual_seed(0), cfg, opt, "cuda")

    torch.use_deterministic_algorithms(deterministic)
    try:
        full, l_full = _steps(fresh(), cfg, opt, 0, 6)
        half, l_half = _steps(fresh(), cfg, opt, 0, 3)
        ckpt.save(str(tmp_path), 3, half, blocking=False).join(timeout=120)
        restored, step = ckpt.restore(str(tmp_path), fresh())
        resumed, l_rest = _steps(restored, cfg, opt, 3, 3)
    finally:
        torch.use_deterministic_algorithms(False)
    assert step == 3
    assert l_half + l_rest == l_full
    for a, b in zip(tree_leaves(full), tree_leaves(resumed)):
        assert a.device.type == "cuda" and torch.equal(a, b)


@pytest.mark.cuda
def test_a_card_checkpoint_restores_on_the_cpu(tmp_path):
    _card()
    cfg = dataclasses.replace(_cfg("granite-moe-1b-a400m"), dtype="bfloat16")
    opt = OptConfig(kind="adam8bit", lr=1e-3)
    state = make_train_state(torch.Generator(device="cuda").manual_seed(0), cfg, opt)
    assert all(t.device.type == "cuda" for t in tree_leaves(state))
    state, _ = _steps(state, cfg, opt, 0, 2)
    ckpt.save(str(tmp_path), 2, state)
    on_cpu, step = ckpt.restore(str(tmp_path), state, device="cpu")
    on_card, _ = ckpt.restore(str(tmp_path), state)
    assert step == 2
    for a, b, c in zip(tree_leaves(state), tree_leaves(on_cpu), tree_leaves(on_card)):
        assert b.device.type == "cpu" and c.device.type == "cuda"
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b) and torch.equal(a, c)


class _Float64:
    """Inside the block the port computes in float64: every ``.float()`` a
    ``.double()`` and every config's dtype float64 (`chip_smoke.Float64`)."""

    def __init__(self, monkeypatch):
        from repro_torch.models.common import ModelConfig

        monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
        monkeypatch.setattr(ModelConfig, "torch_dtype", property(lambda self: torch.float64))


@pytest.mark.cuda
def test_rwkv6_card_gradient_gap_is_rounding(monkeypatch):
    """The float32 gradient gap of rwkv6 between the card and the CPU (which
    ``CARD_TOL`` allows up to 5e-5) read in float64 from the same start
    and batch: every leaf within ``F64_GRAD_REL``, so the float32 gap is
    rounding, not a port fault.  Both readings are printed."""
    _card()
    cfg = _cfg("rwkv6-7b")
    params = make_train_state(torch.Generator().manual_seed(0), cfg, OptConfig(), "cpu").params
    batch = TokenStream(vocab=cfg.vocab, batch=8, seq_len=32, seed=0).batch_at(0)

    def gaps(params):
        card, host = (tree_leaves(train_step._value_and_grad(
            tree_map(lambda t: t.to(device), params), cfg,
            {k: torch.as_tensor(v, device=device) for k, v in batch.items()})[2])
            for device in ("cuda", "cpu"))
        assert all(g.dtype == params["embed"].dtype for g in card + host)
        return [float((a.cpu().double() - b.double()).norm() / b.double().norm())
                for a, b in zip(card, host)]

    f32 = gaps(params)
    with monkeypatch.context() as m:
        _Float64(m)
        f64 = gaps(tree_map(torch.Tensor.double, params))
    print(f"rwkv6 card-against-CPU gradient gap: float32 max {max(f32):.3e}, "
          f"float64 max {max(f64):.3e}")
    assert max(f32) <= CARD_TOL["grad_rel"]
    assert max(f64) <= F64_GRAD_REL, f64
