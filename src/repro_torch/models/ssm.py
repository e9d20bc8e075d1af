"""Attention-free sequence mixers: RWKV6 (Finch) and a Mamba-style
selective SSM (PyTorch port of the reference's ``ssm.py``).

RWKV6 time-mix (the `rwkv6-7b` arch): multi-head linear recurrence
  S_t = diag(w_t)·S_{t-1} + k_tᵀ v_t,   y_t = r_t·(S_{t-1} + diag(u)·k_tᵀ v_t)
with data-dependent per-channel decay w_t = exp(-exp(w0 + LoRA(x_t))) and
token-shift lerps on r/k/v/w/g.  `rwkv6_chunked` is the reference's
chunked form: within a chunk every decay is a ratio exp(logW_a − logW_b)
with a ≥ b, at most 1; the intra-chunk terms use an explicit (c, c, dk)
decay tensor.  The ratios of the masked pairs (s ≥ t) may overflow, so
their exponents are set to −inf before ``exp`` and they come out 0 (the
reference removes them with ``where`` after the product).  A Python loop
over chunks carries the state.

Mamba head (the `hymba-1.5b` hybrid): a selective SSM with state (B,
d_inner, N).  The reference's two-level chunked scan only saves memory for
its backward pass; its numbers are the per-step recurrence, which
`mamba_mix` runs as a Python loop over time steps (the decays and inputs
of a block of steps computed at once, then one multiply-add a step).

Dtypes follow the reference: the recurrences run in float32, the
projections in the activation dtype, and the leaves the reference keeps
in float32 (``w0``, ``wlB``, ``u``, ``ln_x``, ``m_Alog``, ``m_dtb``) are
cast where it casts them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

# time steps whose decays and inputs `mamba_mix` computes at once
MAMBA_BLOCK = 64


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

class RWKVState(NamedTuple):
    s: torch.Tensor        # (B, H, dk, dv) wkv state, float32
    last_x: torch.Tensor   # (B, D) previous token (time-mix shift)
    last_xc: torch.Tensor  # (B, D) previous token (channel-mix shift)


def rwkv_state_init(batch: int, n_heads: int, head_dim: int, d_model: int,
                    dtype=torch.float32, device=None) -> RWKVState:
    return RWKVState(
        s=torch.zeros((batch, n_heads, head_dim, head_dim), dtype=torch.float32, device=device),
        last_x=torch.zeros((batch, d_model), dtype=dtype, device=device),
        last_xc=torch.zeros((batch, d_model), dtype=dtype, device=device),
    )


def _token_shift(x: torch.Tensor, last_x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) shifted right by one, the first slot the carried token."""
    return torch.cat([last_x[:, None, :], x[:, :-1, :]], dim=1)


def _rwkv_project(x, xs, p):
    """Token-shift lerps and projections → r, k, v, g, logw (B, S, …)."""
    mu = p["mu"]  # (5, D): r, k, v, w, g lerp coefficients

    def mix(i):
        return x + (xs - x) * mu[i][None, None, :].to(x.dtype)

    r = mix(0) @ p["wr"].to(x.dtype)
    k = mix(1) @ p["wk_t"].to(x.dtype)
    v = mix(2) @ p["wv_t"].to(x.dtype)
    g = mix(4) @ p["wg_t"].to(x.dtype)
    # data-dependent decay (Finch): w0 + tanh(x_w A) B, then logw = -exp(·)
    xw = mix(3).float()
    w_raw = p["w0"].float() + torch.tanh(xw @ p["wlA"].float()) @ p["wlB"].float()
    return r, k, v, g, -torch.exp(w_raw)  # logw <= 0, (B, S, D)


def rwkv6_chunked(r, k, v, logw, u, s0, chunk: int = 16):
    """Chunked-parallel wkv over (B, S, H, ·) heads, S a multiple of
    ``chunk``; logw (B, S, H, dk), u (H, dk), s0 (B, H, dk, dv).
    Returns (y (B, S, H, dv) in r's dtype, the final state, float32)."""
    b, s_len, h, dk = r.shape
    dv = v.shape[-1]
    if s_len % chunk:
        raise ValueError(f"sequence of {s_len} is not a multiple of the chunk {chunk}")
    uf = u.float()
    mask = (torch.arange(chunk, device=r.device)[:, None]
            > torch.arange(chunk, device=r.device)[None, :])       # (t, s): s < t
    s_prev = s0.float()
    ys = []
    for c0 in range(0, s_len, chunk):
        rf, kf, vf = (a[:, c0:c0 + chunk].float() for a in (r, k, v))
        lw = logw[:, c0:c0 + chunk].float()
        lw_inc = torch.cumsum(lw, dim=1)                           # (B, c, H, dk) inclusive
        lw_exc = lw_inc - lw                                       # exclusive
        # contribution of the carried state
        r_dec = rf * torch.exp(lw_exc)
        y_state = torch.einsum("bchk,bhkv->bchv", r_dec, s_prev)
        # intra-chunk: explicit (c, c, dk) decay ratios, the pairs s < t only
        expo = lw_exc[:, :, None] - lw_inc[:, None, :]             # (B, t, s, H, dk)
        ratio = torch.exp(torch.where(mask[None, :, :, None, None], expo, -torch.inf))
        scores = torch.einsum("bthk,bshk,btshk->bths", rf, kf, ratio)
        y_intra = torch.einsum("bths,bshv->bthv", scores, vf)
        # diagonal bonus term u
        y_diag = torch.einsum("bthk,bthk,bthv->bthv", rf, uf[None, None] * kf, vf)
        ys.append(y_state + y_intra + y_diag)
        # state update
        tail = torch.exp(lw_inc[:, -1][:, None] - lw_inc)          # (B, c, H, dk)
        s_new = torch.einsum("bshk,bshv->bhkv", kf * tail, vf)
        s_prev = s_new + s_prev * torch.exp(lw_inc[:, -1])[..., None]
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    return y.reshape(b, s_len, h, dv).to(r.dtype), s_prev


def rwkv6_time_mix(x, state: RWKVState, p, n_heads: int, head_dim: int,
                   chunk: int = 16, eps: float = 1e-5, heads: "tuple[int, int] | None" = None,
                   gather=None):
    """(B, S, D) → (B, S, D) and the updated state; ``p`` the layer's
    parameters.  S is padded to a multiple of ``chunk`` with k = v = r = 0
    and logw = 0 (decay 1), which leaves the carried state unchanged.

    ``heads=(h0, h1)`` runs the wkv of those heads only, ``state.s`` being
    theirs (a mesh splits the state by heads over tp); ``gather`` then
    takes their normed outputs (B, S, (h1 − h0)·hd) to all D channels
    before the gate and the output projection."""
    b, s_len, d = x.shape
    xs = _token_shift(x, state.last_x)
    r, k, v, g, logw = _rwkv_project(x, xs, p)
    h0, h1 = heads if heads is not None else (0, n_heads)
    cols = slice(h0 * head_dim, h1 * head_dim)
    if heads is not None:
        r, k, v, logw = (t[..., cols] for t in (r, k, v, logw))
    n_heads = h1 - h0
    pad = (-s_len) % chunk
    if pad:
        r, k, v, logw = (F.pad(t, (0, 0, 0, pad)) for t in (r, k, v, logw))
    sp = s_len + pad

    def split(t):
        return t.reshape(b, sp, n_heads, head_dim)

    y, s_f = rwkv6_chunked(split(r), split(k), split(v), split(logw).float(), p["u"][h0:h1],
                           state.s, chunk=chunk)
    y = y[:, :s_len]
    # per-head group norm (population variance), then output gate and projection
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, correction=0)
    yn = (yf - mu) * torch.rsqrt(var + eps)
    yn = yn.reshape(b, s_len, n_heads * head_dim) * p["ln_x"][cols].float()
    if gather is not None:
        yn = gather(yn)
    out = (yn.to(x.dtype) * F.silu(g)) @ p["wo_t"].to(x.dtype)
    return out, RWKVState(s=s_f, last_x=x[:, -1, :], last_xc=state.last_xc)


def rwkv6_channel_mix(x, state: RWKVState, p):
    """RWKV FFN: squared-ReLU key path with a receptance gate."""
    xs = _token_shift(x, state.last_xc)

    def mix(mu):
        return x + (xs - x) * mu[None, None, :].to(x.dtype)

    kk = torch.square(torch.relu(mix(p["mu_ck"]) @ p["c_wk"].to(x.dtype)))
    vv = kk @ p["c_wv"].to(x.dtype)
    out = torch.sigmoid(mix(p["mu_cr"]) @ p["c_wr"].to(x.dtype)) * vv
    return out, state._replace(last_xc=x[:, -1, :])


# ---------------------------------------------------------------------------
# Mamba-style selective SSM (hymba's parallel head)
# ---------------------------------------------------------------------------

class MambaState(NamedTuple):
    h: torch.Tensor     # (B, d_inner, N), float32
    conv: torch.Tensor  # (B, cw - 1, d_inner) trailing inputs of the causal conv


def mamba_state_init(batch: int, d_inner: int, n_state: int, conv_w: int,
                     dtype=torch.float32, device=None) -> MambaState:
    return MambaState(
        h=torch.zeros((batch, d_inner, n_state), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, conv_w - 1, d_inner), dtype=dtype, device=device),
    )


def _causal_conv(x, conv_hist, w):
    """Depthwise causal conv1d: x (B, S, di), w (di, cw), hist (B, cw-1, di)
    → (y (B, S, di), the new history)."""
    cw = w.shape[1]
    xp = torch.cat([conv_hist, x], dim=1)                          # (B, S+cw-1, di)
    idx = (torch.arange(x.shape[1], device=x.device)[:, None]
           + torch.arange(cw, device=x.device)[None, :])
    windows = xp[:, idx, :]                                        # (B, S, cw, di)
    y = torch.einsum("bscd,dc->bsd", windows, w.to(x.dtype))
    return y, xp[:, xp.shape[1] - (cw - 1):, :]


def mamba_mix(x, state: MambaState, p, n_state: int):
    """Selective SSM over a sequence: x (B, S, D) → (B, S, D), new state."""
    b, s_len, d = x.shape
    xz = x @ p["m_in"].to(x.dtype)                                 # (B, S, 2di)
    xin, z = torch.chunk(xz, 2, dim=-1)
    xc, conv_hist = _causal_conv(xin, state.conv, p["m_conv"])
    xc = F.silu(xc)
    dtr = p["m_dtw"].shape[0]
    dbc = xc @ p["m_x"].to(x.dtype)                                # (B, S, dtr+2N)
    dt_low = dbc[..., :dtr]
    b_t = dbc[..., dtr:dtr + n_state].float()
    c_t = dbc[..., dtr + n_state:].float()
    # softplus in the activation dtype, then float32 (the reference's order)
    dt = F.softplus(dt_low @ p["m_dtw"].to(x.dtype) + p["m_dtb"].to(x.dtype)).float()
    a = -torch.exp(p["m_Alog"].float())                            # (di, N)
    xcf = xc.float()

    h = state.h.float()
    ys = []
    for t0 in range(0, s_len, MAMBA_BLOCK):
        t1 = min(t0 + MAMBA_BLOCK, s_len)
        # (T, B, di, N): each step's decay and input, then h = h·decay + input
        dt_blk = dt[:, t0:t1].transpose(0, 1)
        decay = torch.exp(dt_blk[..., None] * a)
        inp = ((dt_blk * xcf[:, t0:t1].transpose(0, 1))[..., None]
               * b_t[:, t0:t1].transpose(0, 1)[:, :, None, :])
        hs = torch.empty_like(decay)
        for i in range(t1 - t0):
            h = h * decay[i] + inp[i]
            hs[i] = h
        ys.append(torch.einsum("tbdn,tbn->tbd", hs, c_t[:, t0:t1].transpose(0, 1)))
    y = torch.cat(ys).transpose(0, 1).to(x.dtype)                  # (B, S, di)
    y = y + xc * p["m_D"].to(x.dtype)[None, None, :]
    out = (y * F.silu(z)) @ p["m_out"].to(x.dtype)
    return out, MambaState(h=h, conv=conv_hist)
