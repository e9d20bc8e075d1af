"""Transformer, RWKV and hybrid block bodies and their parameter
initialisation (PyTorch port of the reference's ``blocks.py``).

Parameters are dicts of tensors **stacked over layers** (leading L dim),
the reference's layout; `models/lm.py` loops over the layers in Python.
Leaves the reference keeps in float32 whatever ``cfg.dtype`` is
(`F32_LEAVES`) are made in float32 here too.

Under a mesh (`sharding.specs.use_mesh_axes`; the partition is written
out in `sharding/specs.py`) the bodies see one layer's gathered
parameters and this rank's batch rows:

  * `ffn_sublayer` takes the reference's branch: `moe.moe_ffn_sharded`
    (tokens over fsdp, experts over tp) when the whole batch's tokens
    divide over fsdp and tp divides the experts, else `moe.moe_ffn` on
    the whole batch.  Rows split over fsdp always divide; a batch held
    whole on every rank (`specs.batch_split`) is cut to the rank's
    tokens for the sharded branch and gathered after it;
  * `_cache_write` writes a row only on the rank whose slice of a
    sequence-split cache holds the position (the reference's
    clamp-and-mask, with the position on the host);
  * `decode_attention_split` is the split softmax over a sequence-split
    cache: each rank's max, sum and weighted values, combined over tp;
  * `rwkv_block` runs the wkv of the rank's own heads (``heads``) and
    gathers their outputs (``gather``).

On one device the cache write is a plain index write, in place, and
experts go through `moe.moe_ffn`.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import NEG_INF, decode_attention, gqa_attention
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import act_fn, dense_init, rms_norm
from repro_torch.models.rope import apply_mrope, apply_rope
from repro_torch.sharding import collectives as C
from repro_torch.sharding.specs import batch_split, current_mesh, local_block

# the leaves the reference initialises in float32 for every cfg.dtype
F32_LEAVES = frozenset({"router", "w0", "wlB", "u", "ln_x", "m_Alog", "m_dtb"})
# experts drawn per layer in blocks of this many, so that drawing arctic's
# (128, 7168, 4864) expert tensors never holds a whole layer in float32
EXPERT_DRAW_BLOCK = 8


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_block_params(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Stacked (L, …) parameter dict for all layers, on the generator's
    device: normal / sqrt(fan in) matrices and the reference's constants."""
    l, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    dt = cfg.torch_dtype
    dev = generator.device

    def mat(*shape):
        return dense_init(generator, shape, in_axis=-2, dtype=dt)

    def full(shape, value, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def normal(shape, std, dtype):
        return (torch.randn(shape, generator=generator, device=dev) * std).to(dtype)

    p = {"ln1": full((l, d), 1.0), "ln2": full((l, d), 1.0)}
    if cfg.block_kind in ("attn", "hybrid"):
        p.update(wq=mat(l, d, cfg.q_dim), wk=mat(l, d, cfg.kv_dim),
                 wv=mat(l, d, cfg.kv_dim), wo=mat(l, cfg.q_dim, d))

    if cfg.block_kind == "rwkv":
        r = cfg.ssm.lora_rank
        h, hd = d // cfg.ssm.head_dim, cfg.ssm.head_dim
        p["mu"] = full((l, 5, d), 0.5)
        for nm in ("wr", "wk_t", "wv_t", "wg_t", "wo_t"):
            p[nm] = mat(l, d, d)
        p["w0"] = full((l, d), -1.0, torch.float32)
        p["wlA"] = mat(l, d, r)
        p["wlB"] = normal((l, r, d), 0.01, torch.float32)
        p["u"] = full((l, h, hd), 0.0, torch.float32)
        p["ln_x"] = full((l, d), 1.0, torch.float32)
        p["mu_ck"] = full((l, d), 0.5)
        p["mu_cr"] = full((l, d), 0.5)
        p["c_wk"] = mat(l, d, f)
        p["c_wv"] = mat(l, f, d)
        p["c_wr"] = mat(l, d, d)
        return p

    if cfg.block_kind == "hybrid" and cfg.ssm is not None:
        di = cfg.ssm.expand * d
        n = cfg.ssm.state_dim
        dtr = cfg.ssm.dt_rank or -(-d // 16)
        cw = cfg.ssm.conv_dim
        p["m_in"] = mat(l, d, 2 * di)
        p["m_conv"] = normal((l, di, cw), 0.2, dt)
        p["m_Alog"] = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev)
                                ).expand(l, di, n).contiguous()
        p["m_x"] = mat(l, di, dtr + 2 * n)
        p["m_dtw"] = mat(l, dtr, di)
        p["m_dtb"] = full((l, di), -4.6, torch.float32)  # softplus ≈ 0.01
        p["m_D"] = full((l, di), 1.0)
        p["m_out"] = mat(l, di, d)

    if cfg.moe is not None:
        e, fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
        p["router"] = normal((l, d, e), 0.02, torch.float32)
        p["e_wg"] = _expert_init(generator, (l, e, d, fe), dt)
        p["e_wu"] = _expert_init(generator, (l, e, d, fe), dt)
        p["e_wd"] = _expert_init(generator, (l, e, fe, d), dt)
    if cfg.moe is None or cfg.moe.dense_residual:
        if cfg.act == "swiglu":
            p["wg_f"] = mat(l, d, f)
        p["wu_f"] = mat(l, d, f)
        p["wd_f"] = mat(l, f, d)
    return p


def _expert_init(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    """`dense_init` of an (L, E, fan in, out) expert tensor, drawn
    `EXPERT_DRAW_BLOCK` experts at a time into the result."""
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    for i in range(shape[0]):
        for j in range(0, shape[1], EXPERT_DRAW_BLOCK):
            blk = out[i, j:j + EXPERT_DRAW_BLOCK]
            blk.copy_(dense_init(generator, tuple(blk.shape), in_axis=-2, dtype=dtype))
    return out


# ---------------------------------------------------------------------------
# FFN / MoE sublayer
# ---------------------------------------------------------------------------

def _dense_ffn(h: torch.Tensor, lp: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.act == "swiglu":
        z = act_fn("swiglu")(h @ lp["wg_f"]) * (h @ lp["wu_f"])
    else:
        z = act_fn(cfg.act)(h @ lp["wu_f"])
    return z @ lp["wd_f"]


def ffn_sublayer(x: torch.Tensor, lp: dict, cfg: ModelConfig):
    """Pre-norm FFN or MoE (with arctic's dense residual branch) with
    residual.  Returns (x, aux loss)."""
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.moe is None:
        return x + _dense_ffn(h, lp, cfg), torch.zeros((), dtype=torch.float32, device=x.device)
    b, s, d = h.shape
    flat = h.reshape(b * s, d)
    experts = (lp["router"], lp["e_wg"], lp["e_wu"], lp["e_wd"], cfg.moe)
    ctx = current_mesh()
    if ctx is None:
        out, aux = moe_lib.moe_ffn(flat, *experts)
    else:
        # the reference's condition on the whole batch's tokens; rows
        # split over fsdp always divide
        mesh, axes = ctx
        split = batch_split()
        experts_split = cfg.moe.n_experts % mesh.shape[axes.tp] == 0
        if experts_split and (split or (b * s) % mesh.axis_size(axes.fsdp) == 0):
            x_loc = flat if split else local_block(flat, mesh, (axes.fsdp, None))
            out, aux = moe_lib.moe_ffn_sharded(x_loc, *experts, mesh, axes.fsdp, axes.tp)
            if not split:
                out = C.all_gather(out, mesh, axes.fsdp, 0)
        else:
            # the reference's moe_ffn over the whole batch, with every expert
            whole = C.all_gather(flat, mesh, axes.fsdp, 0) if split else flat
            if experts_split:
                experts = (lp["router"], *(C.all_gather(lp[k], mesh, axes.tp, 0)
                                           for k in ("e_wg", "e_wu", "e_wd")), cfg.moe)
            out, aux = moe_lib.moe_ffn(whole, *experts)
            if split:
                out = local_block(out, mesh, (axes.fsdp, None))
    out = out.reshape(b, s, d)
    if cfg.moe.dense_residual:
        out = out + _dense_ffn(h, lp, cfg)
    return x + out, aux


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


# ---------------------------------------------------------------------------
# Full block bodies (sequence path)
# ---------------------------------------------------------------------------

def attn_block(x, lp, cfg: ModelConfig, positions, *, window, collect_kv=False):
    """→ (x, kv or None, aux); aux is 0 without experts."""
    x, kv = attn_sublayer(x, lp, cfg, positions, window=window, collect_kv=collect_kv)
    x, aux = ffn_sublayer(x, lp, cfg)
    return x, kv, aux


def rwkv_block(x, lp, cfg: ModelConfig, state: ssm_lib.RWKVState, chunk: int = 16,
               heads=None, gather=None):
    """RWKV6 time mix then channel mix, each pre-norm with residual.
    → (x, the updated state).  ``heads``/``gather``: the wkv of a block of
    heads only (`ssm.rwkv6_time_mix`)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    mix, state = ssm_lib.rwkv6_time_mix(h, state, lp, cfg.d_model // cfg.ssm.head_dim,
                                        cfg.ssm.head_dim, chunk=chunk, heads=heads,
                                        gather=gather)
    x = x + mix
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    cm, state = ssm_lib.rwkv6_channel_mix(h2, state, lp)
    return x + cm, state


def hybrid_block(x, lp, cfg: ModelConfig, positions, mamba_state: ssm_lib.MambaState, *,
                 window, collect_kv=False):
    """Hymba: attention and Mamba heads in parallel on the same pre-norm
    input, both summed into the residual, then the FFN.
    → (x, kv or None, the Mamba state, aux)."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(h, lp, cfg)
    q, k = _apply_pos(q, k, positions, cfg)
    attn_o = gqa_attention(q, k, v, causal=True, window=window)
    attn_o = attn_o.reshape(b, s, cfg.q_dim) @ lp["wo"]
    mamba_o, mamba_state = ssm_lib.mamba_mix(h, mamba_state, lp, cfg.ssm.state_dim)
    x = x + attn_o + mamba_o
    x, aux = ffn_sublayer(x, lp, cfg)
    return x, ((k, v) if collect_kv else None), mamba_state, aux


# ---------------------------------------------------------------------------
# Decode (single-token) attention sublayer against a cache
# ---------------------------------------------------------------------------

def _cache_write(cache: torch.Tensor, new_row: torch.Tensor, write_pos: int,
                 offset: int = 0) -> torch.Tensor:
    """Write one token row (B, 1, Hkv, hd) into a (B, T, Hkv, hd) cache, in
    place.  ``offset``: the first position of this rank's slice of a
    sequence-split cache; a rank whose slice does not hold ``write_pos``
    leaves its slice as it was."""
    slot = write_pos - offset
    if 0 <= slot < cache.shape[1]:
        cache[:, slot] = new_row[:, 0]
    return cache


def decode_attention_split(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           pos: int, *, offset: int, total: int, mesh, axes,
                           window: "int | None" = None, ring: bool = False) -> torch.Tensor:
    """`attention.decode_attention` over a cache whose sequence is split
    over tp: this rank holds slots ``[offset, offset + T_loc)`` of
    ``total``.  Each rank masks its slots as the whole cache's, takes its
    scores' max, the max over tp, its sum of exp(s − max), the sum over tp,
    and the normalised weights times its values, summed over tp."""
    b, t, hkv, hd = k_cache.shape
    hq = q.shape[2]
    g = hq // hkv
    qg = q.reshape(b, 1, hkv, g, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k_cache).float()
    s = s * (1.0 / math.sqrt(hd))
    slots = torch.arange(offset, offset + t, device=q.device)
    if ring:
        valid = (slots <= pos) | (pos >= total)
    else:
        valid = slots <= pos
        if window is not None:
            valid &= slots > pos - window
    s = torch.where(valid, s, NEG_INF)
    m = C.all_reduce_max(s.amax(dim=-1, keepdim=True), mesh, axes.tp)
    e = torch.exp(s - m)
    p = e / C.all_reduce(e.sum(dim=-1, keepdim=True), mesh, axes.tp)
    o = torch.einsum("bkgqt,btkd->bqkgd", p.to(v_cache.dtype), v_cache)
    return C.all_reduce(o, mesh, axes.tp).reshape(b, 1, hq, hd)


def attn_decode_sublayer(x, lp, cfg: ModelConfig, k_cache, v_cache, pos: int,
                         positions, *, window=None, ring=False, slot=None, split=None):
    """x (B,1,D); k_cache/v_cache (B,T,Hkv,hd), written in place at
    ``slot`` (default ``pos``).  ``split``: ``(offset, total)`` of this
    rank's slice of a sequence-split cache under the ambient mesh.
    Returns x and the two caches."""
    b = x.shape[0]
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(h, lp, cfg)
    q, k = _apply_pos(q, k, positions, cfg)
    write = pos if slot is None else slot
    offset = 0 if split is None else split[0]
    k_cache = _cache_write(k_cache, k, write, offset)
    v_cache = _cache_write(v_cache, v, write, offset)
    if split is None:
        o = decode_attention(q, k_cache, v_cache, pos, window=window, ring=ring)
    else:
        mesh, axes = current_mesh()
        o = decode_attention_split(q, k_cache, v_cache, pos, offset=offset, total=split[1],
                                   mesh=mesh, axes=axes, window=window, ring=ring)
    x = x + o.reshape(b, 1, cfg.q_dim) @ lp["wo"]
    return x, k_cache, v_cache
