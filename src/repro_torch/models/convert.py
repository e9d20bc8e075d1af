"""Parameters for `CausalLM`: the reference's weights carried across, or a
random start.

`params_from_reference` takes the reference's ``lm.init_params`` tree as
numpy arrays (``bfloat16`` arrays too, as ``ml_dtypes`` holds them) and
returns the port's tree, keeping the reference's layout: the blocks
stacked (L, …), ``head`` as (d, V).  It refuses a tree whose keys,
shapes or dtypes differ from `param_shapes` and `param_dtype` (the
leaves the reference keeps in float32 in a bf16 model among them).
`init_params` draws a random start
from an explicit `torch.Generator` (on the card: a CUDA generator, so
8 B parameters are drawn there).  `train_state_from_reference` carries a
whole reference ``TrainState`` (parameters, both moments, the steps)
across with the same checks, so both packages can train from one start.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import embed_init


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes (the reference's ``param_shapes``); each
    leaf's dtype is `param_dtype`'s."""
    l, d, f, v = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    bl = {"ln1": (l, d), "ln2": (l, d)}
    if cfg.block_kind in ("attn", "hybrid"):
        bl.update(wq=(l, d, cfg.q_dim), wk=(l, d, cfg.kv_dim), wv=(l, d, cfg.kv_dim),
                  wo=(l, cfg.q_dim, d))
    if cfg.block_kind == "rwkv":
        r, hd = cfg.ssm.lora_rank, cfg.ssm.head_dim
        bl.update(mu=(l, 5, d), wr=(l, d, d), wk_t=(l, d, d), wv_t=(l, d, d), wg_t=(l, d, d),
                  wo_t=(l, d, d), w0=(l, d), wlA=(l, d, r), wlB=(l, r, d), u=(l, d // hd, hd),
                  ln_x=(l, d), mu_ck=(l, d), mu_cr=(l, d), c_wk=(l, d, f), c_wv=(l, f, d),
                  c_wr=(l, d, d))
    else:
        if cfg.block_kind == "hybrid":
            di, n = cfg.ssm.expand * d, cfg.ssm.state_dim
            dtr = cfg.ssm.dt_rank or -(-d // 16)
            bl.update(m_in=(l, d, 2 * di), m_conv=(l, di, cfg.ssm.conv_dim),
                      m_Alog=(l, di, n), m_x=(l, di, dtr + 2 * n), m_dtw=(l, dtr, di),
                      m_dtb=(l, di), m_D=(l, di), m_out=(l, di, d))
        if cfg.moe is not None:
            e, fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
            bl.update(router=(l, d, e), e_wg=(l, e, d, fe), e_wu=(l, e, d, fe),
                      e_wd=(l, e, fe, d))
        if cfg.moe is None or cfg.moe.dense_residual:
            if cfg.act == "swiglu":
                bl["wg_f"] = (l, d, f)
            bl["wu_f"], bl["wd_f"] = (l, d, f), (l, f, d)
    p = {"embed": (v, d), "blocks": bl, "ln_f": (d,)}
    if not cfg.tie_embeddings:
        p["head"] = (d, v)
    return p


def param_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """A leaf's dtype: float32 for `blocks.F32_LEAVES`, else ``cfg``'s."""
    return torch.float32 if name in blocks.F32_LEAVES else cfg.torch_dtype


def _tensor(a) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: the tree may be read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes: no numpy dtype torch reads
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _check(tree: dict, want: dict, cfg: ModelConfig, where: str = "") -> None:
    if set(tree) != set(want):
        raise ValueError(f"parameter keys {sorted(tree)} at {where or 'the root'}; "
                         f"expected {sorted(want)}")
    for k, shape in want.items():
        if isinstance(shape, dict):
            _check(tree[k], shape, cfg, f"{where}{k}.")
            continue
        if tuple(tree[k].shape) != shape:
            raise ValueError(f"{where}{k} has shape {tuple(tree[k].shape)}; expected {shape}")
        dtype = np.dtype(tree[k].dtype).name
        want_dtype = str(param_dtype(cfg, k)).removeprefix("torch.")
        if dtype != want_dtype:
            raise ValueError(f"{where}{k} is {dtype}; expected {want_dtype}")


def params_from_reference(tree: dict, cfg: ModelConfig,
                          device: "str | torch.device | None" = None) -> dict:
    """The reference's parameter tree (numpy leaves) as the port's, on
    ``device`` (``None``: the card)."""
    device = resolve_device(device)
    _check(tree, param_shapes(cfg), cfg)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(node).to(device)

    return conv(tree)


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device: "str | torch.device | None" = None) -> dict:
    """A random start in ``cfg``'s dtype: normal / sqrt(fan in) matrices,
    N(0, 0.02²) embeddings, unit norms, as the reference initialises.  The
    draws are made on the generator's device and the tree is moved to
    ``device`` (``None``: the card)."""
    device = resolve_device(device)
    dt, d, v = cfg.torch_dtype, cfg.d_model, cfg.vocab
    p = {"embed": embed_init(generator, (v, d), dt),
         "blocks": blocks.init_block_params(generator, cfg),
         "ln_f": torch.ones((d,), dtype=dt, device=generator.device)}
    if not cfg.tie_embeddings:
        p["head"] = embed_init(generator, (d, v), dt)

    def move(node):
        return {k: move(x) for k, x in node.items()} if isinstance(node, dict) else node.to(device)

    return move(p)


def _leaf(a, shape: tuple, dtype: str, where: str, device) -> torch.Tensor:
    if not hasattr(a, "dtype"):
        raise ValueError(f"{where} is a {type(a).__name__}; expected a {dtype} array")
    if tuple(np.shape(a)) != tuple(shape):
        raise ValueError(f"{where} has shape {tuple(np.shape(a))}; expected {tuple(shape)}")
    if np.dtype(a.dtype).name != dtype:
        raise ValueError(f"{where} is {np.dtype(a.dtype).name}; expected {dtype}")
    return _tensor(a).to(device)


def train_state_from_reference(tree, cfg: ModelConfig, opt_kind: str,
                               device: "str | torch.device | None" = None):
    """The reference's ``TrainState`` with numpy leaves (``params``, ``opt``
    an ``OptState`` whose moments are float32 trees under ``"adamw"`` and
    trees of ``Q8`` (int8 ``q``, float32 ``scale``) under ``"adam8bit"``,
    ``step``) as the port's `TrainState` on ``device`` (``None``: the
    card).  Refuses keys, shapes or dtypes that differ from ``cfg``'s."""
    # imported here: the train package imports this module
    from repro_torch.train.optimizer import BLOCK, OptState, Q8
    from repro_torch.train.train_step import TrainState

    if opt_kind not in ("adamw", "adam8bit"):
        raise ValueError(f"unknown optimizer {opt_kind!r}")
    device = resolve_device(device)
    params = params_from_reference(tree.params, cfg, device)

    def moment(node, want, where: str):
        if isinstance(want, dict):
            if not isinstance(node, dict) or set(node) != set(want):
                raise ValueError(f"moment keys at {where or 'the root'} differ from "
                                 f"{sorted(want)}")
            return {k: moment(node[k], want[k], f"{where}{k}.") for k in want}
        if opt_kind == "adamw":
            return _leaf(node, want, "float32", where[:-1], device)
        if not hasattr(node, "q") or not hasattr(node, "scale"):
            raise ValueError(f"{where[:-1]} is not a Q8 (q, scale) leaf")
        scale = (*want[:-1], -(-want[-1] // BLOCK))
        return Q8(q=_leaf(node.q, want, "int8", where + "q", device),
                  scale=_leaf(node.scale, scale, "float32", where + "scale", device))

    shapes = param_shapes(cfg)
    opt = OptState(step=_leaf(tree.opt.step, (), "int32", "opt.step", device),
                   m=moment(tree.opt.m, shapes, "opt.m."),
                   v=moment(tree.opt.v, shapes, "opt.v."))
    return TrainState(params=params, opt=opt, step=_leaf(tree.step, (), "int32", "step", device))
