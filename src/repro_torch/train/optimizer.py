"""Optimizers: AdamW (fp32 states) and blockwise-8-bit Adam (PyTorch port
of the reference's ``optimizer.py``).

adam8bit stores both moments as int8 with per-block (256) fp32 absmax scales
(dynamic re-quantisation each step, bitsandbytes-style): fp32 Adam keeps
8 bytes of state a parameter, 8-bit 2 (+1/128 for the scales).  The first
moment is quantised linearly, the second in the log domain (`q8v_*`).

Trees are nested dicts of tensors, the reference's parameter tree; a `Q8`
is one leaf of a moment tree.  Leaves are visited in the reference's
order, ``jax.tree.leaves``'s: dict keys sorted (`tree_leaves`), so the
global gradient norm sums them in the same order.  Every update is
computed in float32 and cast back to the parameter's dtype.

On a mesh (``apply_updates(..., shardings=)``, the parameters' `Sharding`
tree) every leaf is a local block and the update is the global one:

  * the global gradient norm is one all-reduce of the local sums of
    squares, each block counted once (a replicated block only on the
    first of its replicas);
  * the `Q8` moments follow `sharding.params.opt_state_specs`: ``q``
    splits as its parameter, ``scale`` inherits the parameter's spec and
    loses the last dimension's axis where the blocks do not divide.  Where
    a shard's last-dimension width is not a multiple of the 256-wide block
    (a block straddles shards) or the scales are not split as the
    parameter, the leaf's rows are gathered along the last dimension, the
    whole blocks updated (each absmax the whole block's), and this rank's
    part kept.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

BLOCK = 256


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"        # "adamw" | "adam8bit"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0


class Q8(NamedTuple):
    """Blockwise int8 tensor **in the parameter's own shape**.

    q     int8[*param.shape]
    scale f32[*param.shape[:-1], ceil(last/BLOCK)] (absmax per last-dim block)

    The moments keep the parameter's shape so that every optimizer op stays
    elementwise, and a moment shards as its parameter does.
    """
    q: torch.Tensor
    scale: torch.Tensor


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of same-keyed nested dicts (a `Q8` or a tuple
    is a leaf), keys sorted."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of a tree in ``jax.tree.leaves``'s order: dict keys
    sorted, tuple fields in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def _nb_last(shape) -> int:
    last = shape[-1] if shape else 1
    return -(-last // BLOCK)


def q8_zeros_like(x: torch.Tensor) -> Q8:
    shape = tuple(x.shape) if x.ndim else (1,)
    return Q8(q=torch.zeros(x.shape, dtype=torch.int8, device=x.device),
              scale=torch.zeros((*shape[:-1], _nb_last(shape)), dtype=torch.float32,
                                device=x.device))


def _expand_scale(scale: torch.Tensor, last: int) -> torch.Tensor:
    return scale.repeat_interleave(BLOCK, dim=-1)[..., :last]


def q8_quantize(x: torch.Tensor) -> Q8:
    orig_ndim = x.ndim
    if orig_ndim == 0:
        x = x[None]
    last = x.shape[-1]
    nb = _nb_last(x.shape)
    xf = x.float()
    blocks = F.pad(xf, (0, nb * BLOCK - last)).reshape(*x.shape[:-1], nb, BLOCK)
    scale = blocks.abs().amax(dim=-1) / 127.0
    # torch.round rounds half to even, as jnp.round does
    q = torch.round(xf / torch.clamp(_expand_scale(scale, last), min=1e-12))
    q = torch.clamp(q, -127, 127).to(torch.int8)
    if orig_ndim == 0:
        q = q[0]
    return Q8(q=q, scale=scale)


def q8_dequantize(t: Q8, shape, dtype=torch.float32) -> torch.Tensor:
    q = t.q if t.q.ndim else t.q[None]
    out = q.float() * _expand_scale(t.scale, q.shape[-1])
    return out.reshape(shape).to(dtype)


# --- log-domain variant for the second moment ------------------------------
# Linear absmax int8 rounds small v entries to exactly 0, which explodes the
# Adam update (m / (√0 + ε)).  v spans decades but is non-negative, so the
# log of (v + tiny) is quantised instead: 8 bits over a ~30-nat range give
# at most 12 % relative error on v, 6 % on √v.
_V_TINY = 1e-12


def q8v_zeros_like(x: torch.Tensor) -> Q8:
    return q8_zeros_like(x)


def q8v_quantize(v: torch.Tensor) -> Q8:
    return q8_quantize(torch.log(v.float() + _V_TINY))


def q8v_dequantize(t: Q8, shape) -> torch.Tensor:
    # a fresh state's all-zero blocks would decode to exp(0) - tiny ≈ 1;
    # its blocks have scale 0, which decodes to v = 0
    lv = q8_dequantize(t, shape)
    untouched = _expand_scale(t.scale, t.q.shape[-1] if t.q.ndim else 1) == 0
    v = torch.exp(lv) - _V_TINY
    v = torch.where(untouched.reshape(shape), 0.0, v)
    return torch.clamp(v, min=0.0)


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    m: dict             # tree of f32 tensors, or of `Q8`
    v: dict


def init_opt_state(params: dict, cfg: OptConfig) -> OptState:
    """Zero moments beside ``params``, on their devices."""
    if cfg.kind == "adam8bit":
        m = tree_map(q8_zeros_like, params)
        v = tree_map(q8v_zeros_like, params)
    else:
        m = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
        v = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    return OptState(step=step, m=m, v=v)


def _global_norm(tree, shardings=None) -> torch.Tensor:
    if shardings is None:
        sq = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
        return torch.sqrt(sq)
    from repro_torch.sharding import collectives as C

    shs = tree_leaves(shardings)
    sq = sum(torch.sum(torch.square(x.float())) * float(sh.is_first_replica())
             for x, sh in zip(tree_leaves(tree), shs))
    mesh = shs[0].mesh
    return torch.sqrt(C._raw_all_reduce(sq, mesh, mesh.axis_names))


# A leaf of more than this many elements is updated a slice of rows (along
# its first axis) at a time, into whole new tensors: every op of the update
# is elementwise and a Q8 block lies along the last axis, so the result is
# the same, while the update's float32 temporaries stay this small (a
# 256,000 x 4,096 table's are 4.2 GB each)
UPDATE_SLICE = 1 << 26


def _rows(x, sl: slice):
    return Q8(x.q[sl], x.scale[sl]) if isinstance(x, Q8) else x[sl]


def _whole(x, n: int):
    if isinstance(x, Q8):
        return Q8(_whole(x.q, n), _whole(x.scale, n))
    return torch.empty((n, *x.shape[1:]), dtype=x.dtype, device=x.device)


def _write(dst, src, sl: slice) -> None:
    if isinstance(dst, Q8):
        dst.q[sl] = src.q
        dst.scale[sl] = src.scale
    else:
        dst[sl] = src


def _by_slices(upd, p, g, m, v) -> tuple:
    """``upd(p, g, m, v)``, slice by slice of `UPDATE_SLICE` elements."""
    if p.ndim < 2 or p.numel() <= UPDATE_SLICE:
        return upd(p, g, m, v)
    n = p.shape[0]
    rows = max(1, UPDATE_SLICE // (p.numel() // n))
    out = None
    for i in range(0, n, rows):
        sl = slice(i, i + rows)
        part = upd(p[sl], g[sl], _rows(m, sl), _rows(v, sl))
        if out is None:
            out = tuple(_whole(x, n) for x in part)
        for dst, src in zip(out, part):
            _write(dst, src, sl)
    return out


def _q8_whole_rows(update, p, g, m: Q8, v: Q8, sh) -> tuple:
    """``update`` of a Q8 leaf on a mesh (module doc): local where every
    256-block and its scale lie in this rank's block, else over rows
    gathered along the last dimension, this rank's part kept."""
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.params import fit

    last = sh.spec[-1]
    scale_last = fit(sh.mesh, sh.spec, (*sh.shape[:-1], _nb_last(sh.shape)))[-1]
    if last is None or (p.shape[-1] % BLOCK == 0 and scale_last == last):
        return update(p, g, m, v)
    d = p.ndim - 1

    def rows(t):
        return C._raw_all_gather(t, sh.mesh, last, d)

    def scales(t):
        return t if scale_last is None else C._raw_all_gather(t, sh.mesh, scale_last, d)

    new_p, new_m, new_v = update(rows(p), rows(g), Q8(rows(m.q), scales(m.scale)),
                                 Q8(rows(v.q), scales(v.scale)))

    def mine(t, entry):
        if entry is None:
            return t
        n = t.shape[-1] // sh.mesh.axis_size(entry)
        return t[..., sh.mesh.index(entry) * n:(sh.mesh.index(entry) + 1) * n].contiguous()

    return (mine(new_p, last), Q8(mine(new_m.q, last), mine(new_m.scale, scale_last)),
            Q8(mine(new_v.q, last), mine(new_v.scale, scale_last)))


def apply_updates(params: dict, grads: dict, state: OptState, cfg: OptConfig,
                  shardings=None):
    """→ (new_params, new_state, metrics). Updates computed in fp32 and cast
    back to the parameter dtype; nothing is written in place.
    ``shardings``: the parameters' `Sharding` tree on a mesh, every leaf a
    local block (module doc)."""
    step = state.step + 1
    gnorm = _global_norm(grads, shardings)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
            if cfg.grad_clip else 1.0)
    stepf = step.float()
    bc1 = 1.0 - torch.pow(cfg.b1, stepf)
    bc2 = 1.0 - torch.pow(cfg.b2, stepf)
    is_q8 = cfg.kind == "adam8bit"

    def upd(p, g, m, v):
        g = g.float() * clip
        mf = q8_dequantize(m, p.shape) if is_q8 else m
        vf = q8v_dequantize(v, p.shape) if is_q8 else v
        mf = cfg.b1 * mf + (1 - cfg.b1) * g
        vf = cfg.b2 * vf + (1 - cfg.b2) * g * g
        u = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        if cfg.weight_decay:
            u = u + cfg.weight_decay * p.float()
        newp = (p.float() - cfg.lr * u).to(p.dtype)
        return (newp, q8_quantize(mf) if is_q8 else mf, q8v_quantize(vf) if is_q8 else vf)

    def leaf(p, g, m, v, sh=None):
        if sh is not None and is_q8:
            return _q8_whole_rows(lambda *a: _by_slices(upd, *a), p, g, m, v, sh)
        return _by_slices(upd, p, g, m, v)

    if shardings is None:
        out = tree_map(leaf, params, grads, state.m, state.v)
    else:
        out = tree_map(leaf, params, grads, state.m, state.v, shardings)
    new_p, new_m, new_v = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
    return new_p, OptState(step=step, m=new_m, v=new_v), {"grad_norm": gnorm}
