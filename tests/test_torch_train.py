"""The port's single-device training against the reference.

Weights and optimizer states are the reference's, carried across with
`params_from_reference` and `train_state_from_reference` (torch cannot
reproduce threefry); batches are seeded numpy arrays fed to both
packages.  Everything runs in float32 on the CPU.

Tolerances, each beside the largest gap measured on these inputs:

* loss and every gradient leaf against ``jax.value_and_grad``: a relative
  L2 of ``GRAD_REL = 1e-5`` per leaf (measured at most 3.6e-6, rwkv6's
  ``wlA``; the other archs 5.5e-7–1.2e-6) and ``LOSS_REL = 1e-6`` on the
  loss (measured 1.7e-7).  Both packages compute the same float32
  operations; their reductions group terms differently.
* three train steps: parameters within ``STEP_ATOL_ADAMW = 3e-5``
  (measured 8.1e-6, lr 1e-3) under AdamW; under adam8bit within
  ``STEP_ATOL_ADAM8 = 5e-4`` (measured 1.6e-4): a moment that rounds to
  the next int8 level moves an element's update by up to lr/2.
"""
import dataclasses
import json
import os
import signal
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as ref_get_config
from repro.data.pipeline import TokenStream as RefTokenStream
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import lm as RLM
from repro.train import checkpoint as RC
from repro.train import optimizer as RO
from repro.train import train_step as RT
from repro.train.grad_compress import Compressor as RefCompressor
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import TokenStream
from repro_torch.device import NoCudaDeviceError
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as A
from repro_torch.models import blocks, moe
from repro_torch.models.convert import params_from_reference, train_state_from_reference
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer
from repro_torch.train import train_step as T
from repro_torch.train.fault_tolerance import PreemptionGuard, StragglerMonitor
from repro_torch.train.grad_compress import Compressor
from repro_torch.train.optimizer import (
    OptConfig, apply_updates, init_opt_state, q8_dequantize, q8_quantize, q8v_dequantize,
    q8v_quantize, tree_leaves, tree_map)
from repro_torch.train.train_step import make_train_state, make_train_step

GRAD_REL = 1e-5
LOSS_REL = 1e-6
STEP_ATOL_ADAMW = 3e-5
STEP_ATOL_ADAM8 = 5e-4
B, S = 2, 24
CFG = get_config("minitron-8b").smoke()   # the reference test_train.py's model


def _rel(got: torch.Tensor, want) -> float:
    a = got.detach().numpy().astype(np.float64)
    b = np.asarray(want, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _configs(arch: str, capacity=None):
    rcfg, cfg = ref_get_config(arch).smoke(), get_config(arch).smoke()
    if capacity is not None:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe,
                                                                 capacity_factor=capacity))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=capacity))
    return rcfg, cfg


def _batch(cfg, seed=1, s=S, mask=True) -> dict:
    """Seeded tokens (or frame/patch embeddings for the frontend stubs),
    labels, qwen2-vl's (t, h, w) positions and a loss mask with zeros."""
    rng = np.random.RandomState(seed)
    b = {}
    if cfg.frontend is not None:
        b["embeds"] = rng.randn(B, s, cfg.d_model).astype(np.float32)
    else:
        b["tokens"] = rng.randint(0, cfg.vocab, (B, s)).astype(np.int32)
    b["labels"] = rng.randint(0, cfg.vocab, (B, s)).astype(np.int32)
    if cfg.rope_kind == "mrope":
        b["positions"] = rng.randint(0, 40, (B, s, 3)).astype(np.int32)
    if mask:
        b["loss_mask"] = (rng.rand(B, s) < 0.7).astype(np.float32)
    return b


def _ref_value_and_grad(rparams, rcfg, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.value_and_grad(lambda p: RT.loss_fn(p, rcfg, jb), has_aux=True)(rparams)


def _port_value_and_grad(params, cfg, batch):
    return T._value_and_grad(params, cfg, {k: torch.as_tensor(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# The loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask", [None, "some", "zeros"])
def test_cross_entropy_matches_the_reference(mask):
    rng = np.random.RandomState(0)
    logits = (rng.randn(3, 7, 50) * 4).astype(np.float32)
    labels = rng.randint(0, 50, (3, 7)).astype(np.int32)
    m = {None: None, "some": (rng.rand(3, 7) < 0.5).astype(np.float32),
         "zeros": np.zeros((3, 7), np.float32)}[mask]
    want = RL.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                 None if m is None else jnp.asarray(m))
    got = cross_entropy_loss(torch.as_tensor(logits), torch.as_tensor(labels),
                             None if m is None else torch.as_tensor(m))
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-6 * max(abs(float(want)), 1.0)
    if mask == "zeros":
        assert float(got) == 0.0   # divided by max(mask.sum(), 1)


CASES = [(arch, None) for arch in ARCH_IDS] + [("granite-moe-1b-a400m", 1.0)]


@pytest.mark.parametrize("arch,capacity", CASES)
def test_loss_and_every_gradient_match_jax_value_and_grad(arch, capacity):
    """All ten archs' smoke configs (the frontend archs with embeddings,
    qwen2-vl with M-RoPE positions) and granite-moe at capacity 1.0, where
    the router drops pairs: a dropped pair's gradient is zero in both."""
    rcfg, cfg = _configs(arch, capacity)
    rparams = RLM.init_params(jax.random.key(0), rcfg)
    params = params_from_reference(jax.tree.map(np.asarray, rparams), cfg, "cpu")
    batch = _batch(cfg)
    assert 0 < batch["loss_mask"].sum() < batch["loss_mask"].size
    (rloss, rmetrics), rgrads = _ref_value_and_grad(rparams, rcfg, batch)
    if capacity is not None:
        drops = []
        real = moe.route

        def reading(*a):
            plan = real(*a)
            drops.append(int((~plan.kept).sum()))
            return plan

        moe.route = reading
        try:
            loss, metrics, grads = _port_value_and_grad(params, cfg, batch)
        finally:
            moe.route = real
        assert min(drops) > 0, drops
    else:
        loss, metrics, grads = _port_value_and_grad(params, cfg, batch)
    assert abs(float(loss) - float(rloss)) <= LOSS_REL * abs(float(rloss))
    assert abs(float(metrics["aux"]) - float(rmetrics["aux"])) <= 1e-6
    assert (float(metrics["aux"]) > 0) == (cfg.moe is not None)
    want = jax.tree.leaves(rgrads)
    got = tree_leaves(grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert _rel(g, w) <= GRAD_REL


def test_the_loss_mask_reaches_the_gradients():
    """Ignoring the mask moves the loss and the gradients far past the
    tolerance (the planted fault of the card's gradient check)."""
    rcfg, cfg = _configs("minitron-8b")
    rparams = RLM.init_params(jax.random.key(0), rcfg)
    params = params_from_reference(jax.tree.map(np.asarray, rparams), cfg, "cpu")
    batch = _batch(cfg)
    (rloss, _), rgrads = _ref_value_and_grad(rparams, rcfg, batch)
    unmasked = {k: v for k, v in batch.items() if k != "loss_mask"}
    loss, _, grads = _port_value_and_grad(params, cfg, unmasked)
    assert abs(float(loss) - float(rloss)) > 100 * LOSS_REL * abs(float(rloss))
    assert max(_rel(g, w) for g, w in zip(tree_leaves(grads), jax.tree.leaves(rgrads))) > 1e-2


def test_top_k_ties_route_the_gradient_as_the_reference():
    """A router whose probabilities tie: the gradient flows to the
    lower expert ids, as through ``jax.lax.top_k``."""
    rcfg, cfg = _configs("granite-moe-1b-a400m")
    rparams = RLM.init_params(jax.random.key(0), rcfg)
    tree = jax.tree.map(np.asarray, rparams)
    router = np.array(tree["blocks"]["router"])
    router[..., 1] = router[..., 0]
    router[..., 3] = router[..., 2]      # experts 0/1 and 2/3 tie for every token
    tree["blocks"]["router"] = router
    rparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_reference(tree, cfg, "cpu")
    batch = _batch(cfg)
    (rloss, _), rgrads = _ref_value_and_grad(rparams, rcfg, batch)
    loss, _, grads = _port_value_and_grad(params, cfg, batch)
    assert abs(float(loss) - float(rloss)) <= LOSS_REL * abs(float(rloss))
    for g, w in zip(tree_leaves(grads), jax.tree.leaves(rgrads)):
        assert _rel(g, w) <= GRAD_REL


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["minitron-8b", "granite-moe-1b-a400m", "rwkv6-7b",
                                  "hymba-1.5b"])
def test_remat_modes_give_equal_gradients(arch):
    """``none``, ``full`` and ``dots`` give the same loss and gradients;
    in the backward pass ``full`` recomputes the layers' matrix products
    and ``dots`` keeps them (no more ``aten.mm`` than ``none``)."""
    cfg = get_config(arch).smoke()
    params = T.make_train_state(torch.Generator().manual_seed(0), cfg, OptConfig(),
                                "cpu").params
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()}
    out, backward_mm = {}, {}
    for remat in ("none", "full", "dots"):
        rcfg = dataclasses.replace(cfg, remat=remat)
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        loss, _ = T.loss_fn(live, rcfg, batch)
        with _CountMM() as count:
            grads = torch.autograd.grad(loss, leaves)
        out[remat] = (loss.detach(), grads)
        backward_mm[remat] = count.mm
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for g, w in zip(out[remat][1], out["none"][1]):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-7)
    assert backward_mm["dots"] == backward_mm["none"] < backward_mm["full"], backward_mm


def test_chunked_attention_gradients_match_the_reference():
    """The chunked path under autograd (each query block checkpointed)
    against the reference's chunked path and the port's direct path."""
    rng = np.random.RandomState(0)
    q = rng.randn(2, 64, 4, 8).astype(np.float32)
    k = rng.randn(2, 64, 2, 8).astype(np.float32)
    v = rng.randn(2, 64, 2, 8).astype(np.float32)
    w = rng.randn(2, 64, 4, 8).astype(np.float32)

    def ref(q, k, v):
        return jnp.sum(RA.gqa_attention_chunked(q, k, v, window=40, chunk_q=16, chunk_kv=32)
                       * w)

    rq, rk, rv = jax.grad(ref, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    grads = {}
    for path in ("chunked", "direct"):
        ts = [torch.as_tensor(a).requires_grad_(True) for a in (q, k, v)]
        if path == "chunked":
            o = A.gqa_attention_chunked(*ts, window=40, chunk_q=16, chunk_kv=32)
        else:
            o = A.gqa_attention_direct(*ts, window=40)
        grads[path] = torch.autograd.grad((o * torch.as_tensor(w)).sum(), ts)
    for path in grads:
        for g, want in zip(grads[path], (rq, rk, rv)):
            assert _rel(g, want) <= GRAD_REL


def _every_block(q, k, v, window, cq, ckv):
    """The chunked path as the reference's scan runs it: every key/value
    block computed and masked."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    g, nq, nk = hq // hkv, sq // cq, k.shape[1] // ckv
    qs, ks, vs = (q.reshape(b, nq, cq, hkv, g, hd), k.reshape(b, nk, ckv, hkv, hd),
                  v.reshape(b, nk, ckv, hkv, hd))
    outs = []
    for qi in range(nq):
        m_run = torch.full((b, hkv, g, cq), A.NEG_INF)
        l_run = torch.zeros((b, hkv, g, cq))
        acc = torch.zeros((b, hkv, g, cq, hd), dtype=v.dtype)
        for kj in range(nk):
            s = torch.einsum("bqkgd,btkd->bkgqt", qs[:, qi], ks[:, kj]).float() * (1.0 / hd ** 0.5)
            msk = A._mask(qi * cq + torch.arange(cq), kj * ckv + torch.arange(ckv), True, window)
            s = torch.where(msk, s, A.NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None].to(acc.dtype) + torch.einsum(
                "bkgqt,btkd->bkgqd", p.to(v.dtype), vs[:, kj])
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-20)[..., None].to(acc.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, cq, hq, hd))
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("window,chunks,dtype", [
    (None, (16, 8), torch.float32), (None, (8, 16), torch.bfloat16), (1, (16, 16), torch.float32),
    (20, (8, 16), torch.float32), (40, (16, 8), torch.bfloat16)])
def test_skipping_covered_blocks_changes_no_bit(window, chunks, dtype):
    """The chunked path skips the key/value blocks the causal or window
    mask covers wholly and does not mask the blocks it leaves open: its
    output and gradients equal, bit for bit, those of every block computed
    and masked."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 64, h, 8, generator=gen).to(dtype).requires_grad_(True)
               for h in (4, 2, 2))
    w = torch.randn(2, 64, 4, 8, generator=gen).to(dtype)
    outs = [A.gqa_attention_chunked(q, k, v, window=window, chunk_q=chunks[0],
                                    chunk_kv=chunks[1]),
            _every_block(q, k, v, window, *chunks)]
    assert torch.equal(outs[0], outs[1])
    grads = [torch.autograd.grad((o * w).float().sum(), (q, k, v)) for o in outs]
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------

SHAPES = {"a": (3, 300), "b": {"c": (700,), "d": (2, 5, 260)}, "e": (7,)}


def _tree(fn, shapes=SHAPES):
    return {k: (_tree(fn, v) if isinstance(v, dict) else fn(v)) for k, v in shapes.items()}


@pytest.mark.parametrize("kind", ["adamw", "adam8bit"])
def test_apply_updates_matches_the_reference(kind):
    """Four steps on the same parameters and gradients (magnitudes over
    five decades, weight decay on, no clip: the clip goes through the
    norm's summation order, which the train-step test covers).  The first
    moment is bitwise (adam8bit: its int8 words and scales); AdamW's second
    moment too; adam8bit's log-domain second moment has the same words and
    its scales within 2e-7 relative (measured 7.1e-8 over 6 seeds: XLA's
    and torch's ``log`` differ by an ulp); parameters within 3e-7
    (measured 1.2e-7)."""
    rng = np.random.RandomState(0)
    kw = dict(kind=kind, lr=1e-2, weight_decay=0.01, grad_clip=0.0)
    rcfg, cfg = RO.OptConfig(**kw), OptConfig(**kw)
    p0 = _tree(lambda s: rng.randn(*s).astype(np.float32))
    rp, pp = jax.tree.map(jnp.asarray, p0), tree_map(torch.as_tensor, p0)
    rs, ps = RO.init_opt_state(rp, rcfg), init_opt_state(pp, cfg)
    for _ in range(4):
        g = _tree(lambda s: (rng.randn(*s) * 10 ** rng.uniform(-4, 1)).astype(np.float32))
        rp, rs, rm = RO.apply_updates(rp, jax.tree.map(jnp.asarray, g), rs, rcfg)
        pp, ps, pm = apply_updates(pp, tree_map(torch.as_tensor, g), ps, cfg)
        assert abs(float(pm["grad_norm"]) - float(rm["grad_norm"])) <= 1e-6 * float(rm["grad_norm"])
        for a, b in zip(tree_leaves(ps.m), jax.tree.leaves(rs.m)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for i, (a, b) in enumerate(zip(tree_leaves(ps.v), jax.tree.leaves(rs.v))):
            if kind == "adam8bit" and i % 2:   # a Q8's scale
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-7)
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree_leaves(pp), jax.tree.leaves(rp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=3e-7)
    if kind == "adam8bit":
        assert all(t.dtype == torch.int8 for t in tree_leaves(ps.m)[0::2])
    assert int(ps.step) == int(rs.step) == 4


@pytest.mark.parametrize("kind", ["adamw", "adam8bit"])
def test_an_update_by_slices_is_the_whole_update(kind, monkeypatch):
    """Leaves past `UPDATE_SLICE` elements are updated a slice of rows at
    a time: bitwise the same parameters and moments."""
    rng = np.random.RandomState(3)
    cfg = OptConfig(kind=kind, lr=1e-2, weight_decay=0.01)
    shapes = {"w": (37, 300), "x": (5, 3, 260), "y": (700,)}
    params = _tree(lambda s: torch.as_tensor(rng.randn(*s), dtype=torch.float32), shapes)
    grads = [_tree(lambda s: torch.as_tensor(rng.randn(*s) * (i + 1), dtype=torch.float32),
                   shapes) for i in range(3)]
    results = {}
    for slice_elems in (optimizer.UPDATE_SLICE, 1000):
        monkeypatch.setattr(optimizer, "UPDATE_SLICE", slice_elems)
        p, st = params, init_opt_state(params, cfg)
        for g in grads:
            p, st, _ = apply_updates(p, g, st, cfg)
        results[slice_elems] = tree_leaves((p, st))
    for a, b in zip(*results.values()):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def test_q8_words_and_scales_are_the_references():
    rng = np.random.RandomState(1)
    for shape in [(5, 600), (300,), (2, 3, 256), ()]:
        x = np.asarray(rng.randn(*shape) * 3, np.float32)
        if x.ndim:
            # a block of absmax 127 has scale 1: 2.5 and 3.5 round half to even
            x[..., :3] = (127.0, 2.5, 3.5)
        rq, pq = RO.q8_quantize(jnp.asarray(x)), q8_quantize(torch.as_tensor(x))
        if x.ndim:
            assert (pq.q[..., 1:3] == torch.tensor([2, 4], dtype=torch.int8)).all()
        np.testing.assert_array_equal(pq.q.numpy(), np.asarray(rq.q))
        np.testing.assert_array_equal(pq.scale.numpy(), np.asarray(rq.scale))
        np.testing.assert_array_equal(q8_dequantize(pq, shape).numpy(),
                                      np.asarray(RO.q8_dequantize(rq, shape)))
        v = np.abs(x) ** 2 * 1e-3
        rv, pv = RO.q8v_quantize(jnp.asarray(v)), q8v_quantize(torch.as_tensor(v))
        # log differs between XLA and torch by an ulp at most: at most one
        # int8 level, and the decoded v within 1e-6 relative
        assert np.abs(pv.q.numpy().astype(int) - np.asarray(rv.q).astype(int)).max() <= 1
        np.testing.assert_allclose(q8v_dequantize(pv, shape).numpy(),
                                   np.asarray(RO.q8v_dequantize(rv, shape)), rtol=1e-6)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind,microbatches", [
    ("minitron-8b", "adamw", 1), ("minitron-8b", "adamw", 4),
    ("granite-moe-1b-a400m", "adamw", 4), ("granite-moe-1b-a400m", "adam8bit", 1)])
def test_three_train_steps_match_the_references(arch, kind, microbatches):
    """Three steps from the reference's state on its token stream: every
    metric (granite's grad norms exceed 1, so its clip acts), the
    parameters (module doc), both step counters."""
    rcfg, cfg = _configs(arch)
    ro, po = RO.OptConfig(kind=kind, lr=1e-3), OptConfig(kind=kind, lr=1e-3)
    rs = RT.make_train_state(jax.random.key(0), rcfg, ro)
    ps = train_state_from_reference(jax.tree.map(np.asarray, rs), cfg, kind, "cpu")
    stream = TokenStream(vocab=cfg.vocab, batch=8, seq_len=32, seed=0)
    rstep = jax.jit(RT.make_train_step(rcfg, ro, microbatches=microbatches))
    pstep = make_train_step(cfg, po, microbatches=microbatches)
    # measured: 4.8e-7 under AdamW, 5.7e-6 (grad_norm) under adam8bit
    metric_rel = 2e-6 if kind == "adamw" else 2e-5
    for i in range(3):
        batch = stream.batch_at(i)
        rs, rm = rstep(rs, {k: jnp.asarray(v) for k, v in batch.items()})
        ps, pm = pstep(ps, batch)
        assert sorted(pm) == sorted(rm) == ["aux", "ce", "grad_norm", "loss"]
        for k in rm:
            assert abs(float(pm[k]) - float(rm[k])) <= metric_rel * max(abs(float(rm[k])), 1.0), k
    if microbatches > 1:
        assert float(pm["aux"]) == 0.0 and float(pm["ce"]) == float(pm["loss"])
    atol = STEP_ATOL_ADAMW if kind == "adamw" else STEP_ATOL_ADAM8
    for a, b in zip(tree_leaves(ps.params), jax.tree.leaves(rs.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)
    assert int(ps.step) == int(ps.opt.step) == int(rs.step) == 3


def test_train_state_shapes_are_the_references():
    for arch in ("granite-moe-1b-a400m", "rwkv6-7b"):
        for kind in ("adamw", "adam8bit"):
            rcfg, cfg = _configs(arch)
            want = RT.train_state_shapes(rcfg, RO.OptConfig(kind=kind))
            got = T.train_state_shapes(cfg, OptConfig(kind=kind))
            got_flat, want_flat = ckpt._flatten(got), RC._flatten(want)
            assert list(got_flat) == list(want_flat)
            for k, w in want_flat.items():
                assert got_flat[k].device.type == "meta"
                assert tuple(got_flat[k].shape) == w.shape, k
                assert str(got_flat[k].dtype).removeprefix("torch.") == str(w.dtype), k


def test_train_state_from_reference_refuses_a_different_tree():
    rcfg, cfg = _configs("granite-moe-1b-a400m")
    tree = jax.tree.map(np.asarray, RT.make_train_state(jax.random.key(0), rcfg,
                                                        RO.OptConfig(kind="adam8bit")))
    assert len(ckpt._flatten(train_state_from_reference(tree, cfg, "adam8bit", "cpu"))) == 62
    words_only = jax.tree.map(lambda q: q.q, tree.opt.m, is_leaf=lambda x: isinstance(x, RO.Q8))
    with pytest.raises(ValueError, match="Q8"):
        train_state_from_reference(tree._replace(opt=tree.opt._replace(m=words_only)), cfg,
                                   "adam8bit", "cpu")
    with pytest.raises(ValueError, match="float32"):
        train_state_from_reference(tree, cfg, "adamw", "cpu")
    bad = tree._replace(step=np.int64(3))
    with pytest.raises(ValueError, match="int32"):
        train_state_from_reference(bad, cfg, "adam8bit", "cpu")
    with pytest.raises(ValueError, match="optimizer"):
        train_state_from_reference(tree, cfg, "sgd", "cpu")


# ---------------------------------------------------------------------------
# Gradient compression
# ---------------------------------------------------------------------------

def test_compressor_levels_and_residuals_match_the_references():
    rng = np.random.RandomState(0)
    g0 = {"w": (rng.randn(64) * 3).astype(np.float32), "u": {"x": rng.randn(5, 9).astype(np.float32)}}
    rc, pc = RefCompressor.init(jax.tree.map(jnp.asarray, g0)), Compressor.init(
        tree_map(torch.as_tensor, g0))
    for step in range(3):
        g = jax.tree.map(lambda a: (a * (step + 1) + step).astype(np.float32), g0)
        rout, rc = rc.compress(jax.tree.map(jnp.asarray, g))
        pout, pc = pc.compress(tree_map(torch.as_tensor, g))
        for a, b in zip(tree_leaves(pout), jax.tree.leaves(rout)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree_leaves(pc.err), jax.tree.leaves(rc.err)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# The token stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,shard,shards,structured", [
    (0, 0, 1, True), (7, 1, 2, True), (3, 3, 4, False), (40, 0, 2, False)])
def test_token_stream_batches_are_the_references_bitwise(seed, shard, shards, structured):
    kw = dict(vocab=97, batch=8, seq_len=33, seed=seed, shard_index=shard, shard_count=shards,
              structured=structured)
    mine, ref = TokenStream(**kw), RefTokenStream(**kw)
    for step in (0, 1, 5, 1000):
        a, b = mine.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_token_stream_prefetching_is_the_references():
    kw = dict(vocab=49155, batch=4, seq_len=64, seed=5)
    mine, ref = TokenStream(**kw).prefetching(3), RefTokenStream(**kw).prefetching(3)
    for _ in range(4):
        (sa, a), (sb, b) = next(mine), next(ref)
        assert sa == sb
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    mine.close()
    ref.close()


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------

def _ref_trained(dtype: str, kind: str, steps: int = 2):
    rcfg, cfg = _configs("granite-moe-1b-a400m")
    rcfg, cfg = (dataclasses.replace(c, dtype=dtype) for c in (rcfg, cfg))
    ro = RO.OptConfig(kind=kind, lr=1e-3)
    rs = RT.make_train_state(jax.random.key(0), rcfg, ro)
    step = jax.jit(RT.make_train_step(rcfg, ro))
    stream = RefTokenStream(vocab=rcfg.vocab, batch=4, seq_len=16, seed=0)
    for i in range(steps):
        rs, _ = step(rs, {k: jnp.asarray(v) for k, v in stream.batch_at(i).items()})
    return rs, cfg


def _same_leaves(port_tree, ref_tree):
    mine, theirs = ckpt._flatten(port_tree), RC._flatten(ref_tree)
    assert list(mine) == list(theirs)
    for k, t in theirs.items():
        a = mine[k]
        b = np.asarray(t)
        if a.dtype == torch.bfloat16:
            assert b.dtype == ml_dtypes.bfloat16, k
            np.testing.assert_array_equal(a.view(torch.int16).numpy(), b.view(np.int16))
        else:
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["adamw", "adam8bit"])
def test_a_reference_checkpoint_restores_in_the_port(tmp_path, dtype, kind):
    rs, cfg = _ref_trained(dtype, kind)
    RC.save(str(tmp_path), 2, rs)
    template = T.train_state_shapes(cfg, OptConfig(kind=kind))
    state, step = ckpt.restore(str(tmp_path), template, device="cpu")
    assert step == 2
    assert len(ckpt._flatten(state)) == {"adamw": 38, "adam8bit": 62}[kind]
    _same_leaves(state, rs)


@pytest.mark.parametrize("kind", ["adamw", "adam8bit"])
def test_a_port_checkpoint_restores_in_the_reference(tmp_path, kind):
    rs, cfg = _ref_trained("float32", kind)
    state = train_state_from_reference(jax.tree.map(np.asarray, rs), cfg, kind, "cpu")
    state, _ = make_train_step(cfg, OptConfig(kind=kind, lr=1e-3))(
        state, TokenStream(vocab=cfg.vocab, batch=4, seq_len=16, seed=0).batch_at(2))
    ckpt.save(str(tmp_path), 3, state)
    restored, step = RC.restore(str(tmp_path), jax.eval_shape(lambda: rs))
    assert step == 3
    _same_leaves(state, restored)


@pytest.mark.parametrize("kind", ["adamw", "adam8bit"])
def test_a_bf16_port_checkpoint_is_the_references_bytes(tmp_path, kind):
    """The same bf16 state written by both packages: every leaf file and
    the manifest are byte for byte the same (the reference's own
    ``restore`` cannot read its bf16 leaves back: ``'<V2'`` is no JAX
    type; numpy and ml_dtypes read them as the port's words)."""
    rs, cfg = _ref_trained("bfloat16", kind)
    state = train_state_from_reference(jax.tree.map(np.asarray, rs), cfg, kind, "cpu")
    RC.save(str(tmp_path / "ref"), 2, rs)
    ckpt.save(str(tmp_path / "port"), 2, state)
    ref_dir, port_dir = tmp_path / "ref" / "step_00000002", tmp_path / "port" / "step_00000002"
    names = sorted(os.listdir(ref_dir))
    assert sorted(os.listdir(port_dir)) == names
    assert any(json.load(open(ref_dir / "MANIFEST.json"))["leaves"][k]["dtype"] == "bfloat16"
               for k in json.load(open(ref_dir / "MANIFEST.json"))["leaves"])
    for name in names:
        assert (ref_dir / name).read_bytes() == (port_dir / name).read_bytes(), name
    assert (tmp_path / "ref" / "LATEST").read_text() == (tmp_path / "port" / "LATEST").read_text()
    for k, meta in json.load(open(port_dir / "MANIFEST.json"))["leaves"].items():
        if meta["dtype"] == "bfloat16":
            words = np.load(port_dir / meta["file"]).view(ml_dtypes.bfloat16)
            np.testing.assert_array_equal(words, np.asarray(RC._flatten(rs)[k]))


# ---------------------------------------------------------------------------
# The reference's test_train.py cases, on the port
# ---------------------------------------------------------------------------

def _run(steps, opt_cfg, seed=0, state=None, start=0, microbatches=1):
    stream = TokenStream(vocab=CFG.vocab, batch=8, seq_len=32, seed=seed)
    if state is None:
        state = make_train_state(torch.Generator().manual_seed(0), CFG, opt_cfg, "cpu")
    step = make_train_step(CFG, opt_cfg, microbatches=microbatches)
    losses = []
    for i in range(start, start + steps):
        state, m = step(state, stream.batch_at(i))
        losses.append(float(m["loss"]))
    return state, losses


def test_q8_roundtrip_error_bounded():
    rng = np.random.RandomState(0)
    for shape in [(100,), (33, 7), (4, 5, 6)]:
        x = torch.as_tensor(rng.randn(*shape) * rng.rand() * 10, dtype=torch.float32)
        back = q8_dequantize(q8_quantize(x), x.shape)
        assert float((back - x).abs().max()) <= float(x.abs().max()) / 127.0 + 1e-6


def test_adam8bit_tracks_fp32_adam():
    """8-bit Adam loss curve stays close to fp32 Adam (same data/seeds)."""
    _, l32 = _run(25, OptConfig(kind="adamw", lr=2e-3))
    _, l8 = _run(25, OptConfig(kind="adam8bit", lr=2e-3))
    assert l8[-1] < l32[0], "adam8bit failed to reduce the loss"
    assert abs(np.mean(l8[-5:]) - np.mean(l32[-5:])) < 0.25, (l32, l8)


def test_grad_clip():
    cfg = OptConfig(lr=1e-3, grad_clip=1e-9)
    params = {"w": torch.ones((8, 8))}
    grads = {"w": torch.full((8, 8), 100.0)}
    new_p, _, m = apply_updates(params, grads, init_opt_state(params, cfg), cfg)
    assert float((new_p["w"] - params["w"]).abs().max()) < 1e-3
    assert float(m["grad_norm"]) > 1.0


def test_microbatch_equivalence():
    """Gradient accumulation ≈ full-batch step (same data)."""
    s1, l1 = _run(3, OptConfig(lr=1e-3), microbatches=1)
    s2, l2 = _run(3, OptConfig(lr=1e-3), microbatches=4)
    assert np.allclose(l1, l2, atol=5e-2), (l1, l2)
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-3)


def test_microbatches_must_divide_the_batch():
    with pytest.raises(AssertionError):
        _run(1, OptConfig(lr=1e-3), microbatches=3)


def test_checkpoint_roundtrip(tmp_path):
    state, _ = _run(3, OptConfig(lr=1e-3))
    ckpt.save(str(tmp_path), 3, state)
    restored, step = ckpt.restore(str(tmp_path), state, device="cpu")
    assert step == 3
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_crash_restart_bitwise_identical(tmp_path):
    """Train 6 steps straight vs 3 steps + checkpoint + 'crash' + resume —
    the stateless-indexed data pipeline makes the two runs identical."""
    opt = OptConfig(lr=1e-3)
    s_full, l_full = _run(6, opt)
    s_half, l_half = _run(3, opt)
    ckpt.save(str(tmp_path), 3, s_half)
    template = T.train_state_shapes(CFG, opt)
    restored, _ = ckpt.restore(str(tmp_path), template, device="cpu")
    s_resumed, l_rest = _run(3, opt, state=restored, start=3)
    assert l_half + l_rest == l_full
    for a, b in zip(tree_leaves(s_full), tree_leaves(s_resumed)):
        assert torch.equal(a, b)


def test_checkpoint_async_and_latest(tmp_path):
    state, _ = _run(1, OptConfig(lr=1e-3))
    t = ckpt.save(str(tmp_path), 1, state, blocking=False)
    t.join(timeout=60)
    assert not t.is_alive()
    ckpt.save(str(tmp_path), 5, state)
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_checkpoint_atomicity(tmp_path):
    """A stale .tmp dir (crash mid-write) must not corrupt restore, and a
    LATEST that points ahead falls back to the last complete step."""
    state, _ = _run(1, OptConfig(lr=1e-3))
    ckpt.save(str(tmp_path), 1, state)
    os.makedirs(str(tmp_path / "step_00000002.tmp"))
    assert ckpt.latest_step(str(tmp_path)) == 1
    _, step = ckpt.restore(str(tmp_path), state, device="cpu")
    assert step == 1
    (tmp_path / "LATEST").write_text("7")
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_compression_error_feedback_convergence():
    """EF-int8-compressed training converges like uncompressed."""
    opt = OptConfig(lr=2e-3)
    stream = TokenStream(vocab=CFG.vocab, batch=8, seq_len=32, seed=0)
    state = make_train_state(torch.Generator().manual_seed(0), CFG, opt, "cpu")
    holder = [Compressor.init(state.params)]

    def compress(grads):
        out, holder[0] = holder[0].compress(grads)
        return out

    step = make_train_step(CFG, opt, compress=compress)
    losses = []
    for i in range(20):
        state, m = step(state, stream.batch_at(i))
        losses.append(float(m["loss"]))
    _, l_ref = _run(20, opt)
    assert losses[-1] < losses[0] - 0.2
    assert abs(losses[-1] - l_ref[-1]) < 0.4


def test_compression_quantizes_to_int8_levels():
    g = {"w": torch.as_tensor(np.random.RandomState(0).randn(64) * 3, dtype=torch.float32)}
    out, comp2 = Compressor.init(g).compress(g)
    scale = float(g["w"].abs().max()) / 127.0
    levels = out["w"].numpy() / scale
    np.testing.assert_allclose(levels, np.round(levels), atol=1e-4)
    assert float(comp2.err["w"].abs().max()) <= scale / 2 + 1e-6


def test_straggler_monitor():
    mon = StragglerMonitor(window=20, threshold=2.0, evict_after=3)
    for s in range(15):
        assert not mon.record(s, 1.0)
    evict = False
    for s in range(15, 25):
        evict = mon.record(s, 5.0) or evict
    assert evict and len(mon.flagged_steps) >= 3


def test_preemption_guard():
    with PreemptionGuard() as guard:
        assert not guard.preempted
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.1)
        assert guard.preempted


# ---------------------------------------------------------------------------
# The launcher and the device default
# ---------------------------------------------------------------------------

def test_the_train_launcher_resumes_at_its_checkpoint(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    args = ["--arch", "granite-moe-1b-a400m", "--smoke", "--batch", "4", "--seq", "16",
            "--ckpt-dir", ck, "--ckpt-every", "2", "--log-every", "1", "--device", "cpu"]
    assert launch_train.main(args + ["--steps", "3"]) == 0
    first = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in first] == ["step 0", "step 1", "step 2"]
    assert ckpt.latest_step(ck) == 3 and os.path.exists(os.path.join(ck, "HEARTBEAT"))
    assert launch_train.main(args + ["--steps", "5", "--resume"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed from step 3"
    assert [ln.split(":")[0] for ln in out[1:]] == ["step 3", "step 4"]
    assert ckpt.latest_step(ck) == 5


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state, _ = _run(1, OptConfig(lr=1e-3))
    ckpt.save(str(tmp_path), 1, state)
    with pytest.raises(NoCudaDeviceError):
        make_train_state(torch.Generator().manual_seed(0), CFG, OptConfig())
    with pytest.raises(NoCudaDeviceError):
        ckpt.restore(str(tmp_path), state)
    rcfg, _ = _configs("minitron-8b")
    with pytest.raises(NoCudaDeviceError):
        train_state_from_reference(jax.tree.map(np.asarray, RT.make_train_state(
            jax.random.key(0), rcfg, RO.OptConfig())), CFG, "adamw")
    with pytest.raises(NoCudaDeviceError):
        launch_train.main(["--arch", "minitron-8b", "--smoke", "--steps", "1"])


def test_the_f32_leaves_stay_f32_through_a_bf16_step():
    """A bf16 model's parameters keep their dtypes through a step (the
    reference's f32 leaves among them); the moments are float32."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").smoke(), dtype="bfloat16")
    state = make_train_state(torch.Generator().manual_seed(0), cfg, OptConfig(), "cpu")
    batch = TokenStream(vocab=cfg.vocab, batch=2, seq_len=16, seed=0).batch_at(0)
    new, m = make_train_step(cfg, OptConfig())(state, batch)
    assert np.isfinite(float(m["loss"]))
    for k, v in new.params["blocks"].items():
        assert v.dtype == (torch.float32 if k in blocks.F32_LEAVES else torch.bfloat16), k
    assert all(t.dtype == torch.float32 for t in tree_leaves(new.opt.m))
