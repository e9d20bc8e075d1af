"""Attention block bodies and their parameter initialisation (PyTorch
port, attention-only blocks).

Parameters are dicts of tensors **stacked over layers** (leading L dim),
the reference's layout; `models/lm.py` loops over the layers in Python.
Experts (`models/moe.py`) and the RWKV and hybrid blocks (`models/ssm.py`)
are not ported yet and raise `NotImplementedError`.  The reference's
sharding constraints and its sharded cache write do nothing on one card:
the cache write here is a plain index write, in place.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import decode_attention, gqa_attention
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import act_fn, dense_init, rms_norm
from repro_torch.models.rope import apply_mrope, apply_rope

NOT_PORTED = ("not ported yet: experts (models/moe.py) and the RWKV and hybrid "
              "blocks (models/ssm.py) are ROADMAP queue 1's next item")


def require_attention_only(cfg: ModelConfig) -> None:
    """Raise for the blocks this port does not have yet."""
    if cfg.block_kind != "attn" or cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: {NOT_PORTED}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_block_params(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Stacked (L, …) parameter dict for all layers, on the generator's
    device."""
    require_attention_only(cfg)
    l, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    dt = cfg.torch_dtype
    dev = generator.device

    def mat(*shape):
        return dense_init(generator, shape, in_axis=-2, dtype=dt)

    p = {"ln1": torch.ones((l, d), dtype=dt, device=dev),
         "ln2": torch.ones((l, d), dtype=dt, device=dev),
         "wq": mat(l, d, cfg.q_dim), "wk": mat(l, d, cfg.kv_dim),
         "wv": mat(l, d, cfg.kv_dim), "wo": mat(l, cfg.q_dim, d)}
    if cfg.act == "swiglu":
        p["wg_f"] = mat(l, d, f)
    p["wu_f"] = mat(l, d, f)
    p["wd_f"] = mat(l, f, d)
    return p


# ---------------------------------------------------------------------------
# FFN sublayer
# ---------------------------------------------------------------------------

def _dense_ffn(h: torch.Tensor, lp: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.act == "swiglu":
        z = act_fn("swiglu")(h @ lp["wg_f"]) * (h @ lp["wu_f"])
    else:
        z = act_fn(cfg.act)(h @ lp["wu_f"])
    return z @ lp["wd_f"]


def ffn_sublayer(x: torch.Tensor, lp: dict, cfg: ModelConfig) -> torch.Tensor:
    """Pre-norm dense FFN with residual."""
    require_attention_only(cfg)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + _dense_ffn(h, lp, cfg)


# ---------------------------------------------------------------------------
# Attention sublayer (sequence path)
# ---------------------------------------------------------------------------

def _apply_pos(q, k, positions, cfg: ModelConfig):
    if cfg.rope_kind == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope_kind == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.rope_theta)
    return q, k


def _qkv(h: torch.Tensor, lp: dict, cfg: ModelConfig):
    b, s, _ = h.shape
    q = (h @ lp["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (h @ lp["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ lp["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def attn_sublayer(x, lp, cfg: ModelConfig, positions, *, window, q_offset=0,
                  collect_kv=False):
    """Pre-norm GQA attention with residual.  positions: (B,S) or (B,S,3).
    Returns ``(x, (k, v))`` with ``collect_kv`` (k after its rotary
    embedding), else ``(x, None)``."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(h, lp, cfg)
    q, k = _apply_pos(q, k, positions, cfg)
    o = gqa_attention(q, k, v, causal=True, window=window, q_offset=q_offset)
    x = x + o.reshape(b, s, cfg.q_dim) @ lp["wo"]
    return x, ((k, v) if collect_kv else None)


def attn_block(x, lp, cfg: ModelConfig, positions, *, window, collect_kv=False):
    """→ (x, kv or None, aux); aux is 0 without experts."""
    x, kv = attn_sublayer(x, lp, cfg, positions, window=window, collect_kv=collect_kv)
    return ffn_sublayer(x, lp, cfg), kv, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Decode (single-token) attention sublayer against a cache
# ---------------------------------------------------------------------------

def _cache_write(cache: torch.Tensor, new_row: torch.Tensor, write_pos: int) -> torch.Tensor:
    """Write one token row (B, 1, Hkv, hd) into a (B, T, Hkv, hd) cache, in
    place."""
    cache[:, write_pos] = new_row[:, 0]
    return cache


def attn_decode_sublayer(x, lp, cfg: ModelConfig, k_cache, v_cache, pos: int,
                         positions, *, window=None, ring=False, slot=None):
    """x (B,1,D); k_cache/v_cache (B,T,Hkv,hd), written in place at
    ``slot`` (default ``pos``).  Returns x and the two caches."""
    b = x.shape[0]
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(h, lp, cfg)
    q, k = _apply_pos(q, k, positions, cfg)
    write = pos if slot is None else slot
    k_cache = _cache_write(k_cache, k, write)
    v_cache = _cache_write(v_cache, v, write)
    o = decode_attention(q, k_cache, v_cache, pos, window=window, ring=ring)
    x = x + o.reshape(b, 1, cfg.q_dim) @ lp["wo"]
    return x, k_cache, v_cache
