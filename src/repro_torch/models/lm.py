"""Full language-model assembly: forward, prefill and decode for every
block kind (PyTorch port of the reference's ``lm.py``).

`forward` is the reference's functional forward over a parameter tree
(`models/convert.py` makes one): it records gradients for training, with
each layer rematerialised as ``cfg.remat`` says, as the reference's
``_remat`` does — ``"full"`` checkpoints the whole layer, ``"dots"``
keeps the outputs of the non-batched matrix products (``aten.mm``,
the reference's ``dots_with_no_batch_dims_saveable``) and recomputes
the rest, ``"none"`` keeps everything.  Remat applies only while
gradients are recorded.

`CausalLM` holds the reference's parameter tree — ``embed`` (V, d), the
blocks stacked over layers (L, …), ``ln_f`` and ``head`` (d, V) unless
the embeddings are tied — and loops over the layers in Python:

  * `forward`     — the module's `forward` recording no gradients: a
                    sequence → (logits, aux loss summed over layers,
                    collected); with ``collect_kv`` it also returns what a
                    decode cache needs: every layer's (k, v) stacked (L, B,
                    S, Hkv, hd) for attention archs, the stacked RWKV
                    states (each layer starting from zeros) for rwkv, and
                    ((k, v), (m_h, m_conv)) for the hybrid;
  * `prefill`     — forward that also fills the decode caches: a ring of
                    ``min(window, max_len)`` slots per layer for sliding
                    layers (token t in slot t % T), the stack itself when
                    the prompt fills the cache, the hybrid's global layers
                    in a full-length cache of their own, the recurrent
                    states as the prompt leaves them;
  * `decode_step` — one token against the caches, written in place (RWKV
                    with chunk 1).

Caches are dicts of stacked tensors and a host ``pos``.  The reference's
sharding constraints (``_res_constrain``, ``constrain``,
``constrain_layer_params``) are dropped: on one card they do nothing.
The model lives on one device, the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import decode_attention
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import rms_norm


# the products whose outputs ``remat="dots"`` keeps: those without batch
# dimensions (``x @ w``; the attention einsums and the experts' ``bmm``
# are batched and recomputed)
_SAVED_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` (one layer) checkpointed as ``cfg.remat`` says, while
    gradients are recorded (module doc)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"unknown remat {cfg.remat!r}")


def _embed_in(params: dict, cfg: ModelConfig, tokens=None, embeds=None) -> torch.Tensor:
    device = params["embed"].device
    if embeds is not None:
        return embeds.to(device, cfg.torch_dtype)
    # `F.embedding`: its backward on the card sums each row's gradients in
    # one order on every run, so a resumed run repeats a straight one
    return F.embedding(tokens.to(device).long(), params["embed"]).to(cfg.torch_dtype)


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return x @ head.to(x.dtype)


def _default_positions(cfg: ModelConfig, b: int, s: int, device, offset: int = 0) -> torch.Tensor:
    pos = torch.arange(offset, offset + s, dtype=torch.int32, device=device)
    pos = pos[None, :].expand(b, s)
    if cfg.rope_kind == "mrope":
        pos = pos[..., None].expand(b, s, 3)
    return pos


def _rwkv_state(cfg: ModelConfig, b: int, device) -> ssm_lib.RWKVState:
    return ssm_lib.rwkv_state_init(b, cfg.d_model // cfg.ssm.head_dim, cfg.ssm.head_dim,
                                   cfg.d_model, cfg.torch_dtype, device)


def forward(params: dict, cfg: ModelConfig, tokens=None, embeds=None, positions=None,
            collect_kv: bool = False):
    """→ (logits (B, S, V), aux loss summed over layers, collected or
    None) over the parameter tree ``params`` (module doc); every layer
    starts its recurrent state from zeros.  Runs where ``params`` lies."""
    x = _embed_in(params, cfg, tokens, embeds)
    device = x.device
    b, s, _ = x.shape
    stacked = params["blocks"]
    aux = torch.zeros((), dtype=torch.float32, device=device)

    def layer(i: int) -> dict:
        return {k: v[i] for k, v in stacked.items()}

    if cfg.block_kind == "rwkv":
        def rwkv_body(x, lp):
            return blocks.rwkv_block(x, lp, cfg, _rwkv_state(cfg, b, device))

        states = []
        for i in range(cfg.n_layers):
            x, st = _remat(rwkv_body, cfg)(x, layer(i))
            if collect_kv:
                states.append(st)
        collected = (ssm_lib.RWKVState(*(torch.stack(t) for t in zip(*states)))
                     if collect_kv else None)
        return _logits(params, cfg, x), aux, collected

    positions = (_default_positions(cfg, b, s, device) if positions is None
                 else positions.to(device))
    window = cfg.window if cfg.attn_kind == "sliding" else None

    def attn_body(x, lp):
        return blocks.attn_block(x, lp, cfg, positions, window=window, collect_kv=collect_kv)

    def hybrid_body(x, lp, win):
        mst = ssm_lib.mamba_state_init(b, cfg.ssm.expand * cfg.d_model, cfg.ssm.state_dim,
                                       cfg.ssm.conv_dim, cfg.torch_dtype, device)
        return blocks.hybrid_block(x, lp, cfg, positions, mst, window=win,
                                   collect_kv=collect_kv)

    ks, vs, m_h, m_conv = [], [], [], []
    for i in range(cfg.n_layers):
        if cfg.block_kind == "hybrid":
            # the global layers see the whole sequence: a window of s
            win = s if i in cfg.global_layers else cfg.window
            x, kv, mst, a = _remat(hybrid_body, cfg)(x, layer(i), win)
            m_h.append(mst.h)
            m_conv.append(mst.conv)
        else:
            x, kv, a = _remat(attn_body, cfg)(x, layer(i))
        aux = aux + a
        if collect_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    collected = None
    if collect_kv:
        collected = (torch.stack(ks), torch.stack(vs))
        if cfg.block_kind == "hybrid":
            collected = (collected, (torch.stack(m_h), torch.stack(m_conv)))
    return _logits(params, cfg, x), aux, collected


class CausalLM(nn.Module):
    """A decoder of any of the ten archs on one device (module doc).
    ``params`` is the reference's tree of tensors (`models/convert.py`
    makes one from the reference's arrays or at random); it is moved to
    ``device``."""

    def __init__(self, cfg: ModelConfig, params: dict, *,
                 device: "str | torch.device | None" = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)

        def param(t: torch.Tensor) -> nn.Parameter:
            return nn.Parameter(t.to(self.device), requires_grad=False)

        self.embed = param(params["embed"])
        self.ln_f = param(params["ln_f"])
        self.head = None if cfg.tie_embeddings else param(params["head"])
        self.blocks = nn.ParameterDict({k: param(v) for k, v in params["blocks"].items()})

    # ------------------------------------------------------------------
    def _layer(self, i: int) -> dict:
        return {k: v[i] for k, v in self.blocks.items()}

    def _window(self) -> "int | None":
        return self.cfg.window if self.cfg.attn_kind == "sliding" else None

    def _uses_ring(self) -> bool:
        """A window-sized ring cache: pure sliding-window archs, and the
        hybrid's sliding layers."""
        cfg = self.cfg
        return cfg.block_kind == "hybrid" or (cfg.attn_kind == "sliding"
                                              and not cfg.global_layers)

    def params(self) -> dict:
        """The parameter tree (the module's tensors, shared)."""
        p = {"embed": self.embed, "blocks": dict(self.blocks), "ln_f": self.ln_f}
        if self.head is not None:
            p["head"] = self.head
        return p

    def _embed_in(self, tokens=None, embeds=None) -> torch.Tensor:
        return _embed_in(self.params(), self.cfg, tokens, embeds)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return _logits(self.params(), self.cfg, x)

    def _positions(self, b: int, s: int, offset: int = 0) -> torch.Tensor:
        return _default_positions(self.cfg, b, s, self.device, offset)

    def _d_inner(self) -> int:
        return self.cfg.ssm.expand * self.cfg.d_model

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, tokens=None, embeds=None, positions=None, collect_kv: bool = False):
        """→ (logits (B, S, V), aux_loss, collected or None) (module doc),
        recording no gradients."""
        return forward(self.params(), self.cfg, tokens, embeds, positions, collect_kv)

    def cache_len(self, max_len: int) -> int:
        """Slots per layer of the attention cache: ``max_len``, or a
        window-sized ring for pure sliding-window archs (starcoder2: 4,096
        of 32k) and for every layer of the hybrid (its global layers keep
        a full-length cache of their own)."""
        return min(self.cfg.window, max_len) if self._uses_ring() else max_len

    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        dt, l = cfg.torch_dtype, cfg.n_layers

        def zeros(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        if cfg.block_kind == "rwkv":
            h, hd = cfg.d_model // cfg.ssm.head_dim, cfg.ssm.head_dim
            return {"pos": 0, "s": zeros(l, batch, h, hd, hd, dtype=torch.float32),
                    "last_x": zeros(l, batch, cfg.d_model),
                    "last_xc": zeros(l, batch, cfg.d_model)}
        kv = (l, batch, self.cache_len(max_len), cfg.n_kv_heads, cfg.head_dim)
        c = {"pos": 0, "k": zeros(*kv), "v": zeros(*kv)}
        if cfg.block_kind == "hybrid":
            lg = max(len(cfg.global_layers), 1)
            c["gk"] = zeros(lg, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            c["gv"] = zeros(lg, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            di = self._d_inner()
            c["m_h"] = zeros(l, batch, di, cfg.ssm.state_dim, dtype=torch.float32)
            c["m_conv"] = zeros(l, batch, cfg.ssm.conv_dim - 1, di)
        return c

    @torch.no_grad()
    def prefill(self, tokens=None, embeds=None, positions=None, max_len: "int | None" = None):
        """Run the full prompt; return (last-token logits (B, V), cache).
        ``max_len``: the decode cache's capacity (at least the prompt's
        length, which is the default)."""
        cfg = self.cfg
        logits, _aux, collected = self.forward(tokens, embeds, positions, collect_kv=True)
        b, s = logits.shape[:2]
        max_len = max(max_len or s, s)
        if cfg.block_kind == "rwkv":
            cache = {"s": collected.s, "last_x": collected.last_x,
                     "last_xc": collected.last_xc}
        else:
            (k_all, v_all), mamba = (collected if cfg.block_kind == "hybrid"
                                     else (collected, None))
            t = self.cache_len(max_len)
            k, v = k_all, v_all
            if self._uses_ring() and s >= t:
                roll = s % t  # ring layout: token i lives in slot i % t
                k = torch.roll(k_all[:, :, -t:], roll, dims=2)
                v = torch.roll(v_all[:, :, -t:], roll, dims=2)
            if k.shape[2] == t and mamba is None:
                cache = {"k": k, "v": v}  # no copy: the stack (or ring) is the cache
            else:
                cache = self.init_cache(b, max_len)
                cache["k"][:, :, :k.shape[2]] = k
                cache["v"][:, :, :v.shape[2]] = v
            if mamba is not None:
                for g, i in enumerate(cfg.global_layers):
                    cache["gk"][g, :, :s] = k_all[i]
                    cache["gv"][g, :, :s] = v_all[i]
                cache["m_h"], cache["m_conv"] = mamba
        cache["pos"] = s
        return logits[:, -1, :], cache

    @torch.no_grad()
    def decode_step(self, cache: dict, token=None, embed=None):
        """One token (B, 1) ids or (B, 1, D) embeddings at ``cache["pos"]``
        → (logits (B, V), the cache, updated in place)."""
        cfg = self.cfg
        x = self._embed_in(token, embed)
        b = x.shape[0]
        pos = int(cache["pos"])
        if cfg.block_kind == "rwkv":
            for i in range(cfg.n_layers):
                st = ssm_lib.RWKVState(cache["s"][i], cache["last_x"][i], cache["last_xc"][i])
                x, st = blocks.rwkv_block(x, self._layer(i), cfg, st, chunk=1)
                cache["s"][i] = st.s
                cache["last_x"][i] = st.last_x
                cache["last_xc"][i] = st.last_xc
        elif cfg.block_kind == "hybrid":
            x = self._decode_hybrid(x, cache, pos)
        else:
            positions = self._positions(b, 1, offset=pos)
            ring = self._uses_ring()
            slot = pos % cache["k"].shape[2] if ring else None
            for i in range(cfg.n_layers):
                lp = self._layer(i)
                x, _, _ = blocks.attn_decode_sublayer(
                    x, lp, cfg, cache["k"][i], cache["v"][i], pos, positions,
                    window=None if ring else self._window(), ring=ring, slot=slot)
                x, _aux = blocks.ffn_sublayer(x, lp, cfg)
        cache["pos"] = pos + 1
        return self._logits(x)[:, 0, :], cache

    def _decode_hybrid(self, x: torch.Tensor, cache: dict, pos: int) -> torch.Tensor:
        """The hybrid's layers for one token: global layers write their
        full-length cache at ``pos``, sliding layers their ring at
        ``pos % w``, and every layer's Mamba state is updated in place."""
        cfg = self.cfg
        b = x.shape[0]
        positions = self._positions(b, 1, offset=pos)
        slot = pos % cache["k"].shape[2]
        g = 0
        for i in range(cfg.n_layers):
            lp = self._layer(i)
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            q, k, v = blocks._qkv(h, lp, cfg)
            q, k = blocks._apply_pos(q, k, positions, cfg)
            if i in cfg.global_layers:
                kc = blocks._cache_write(cache["gk"][g], k, pos)
                vc = blocks._cache_write(cache["gv"][g], v, pos)
                o = decode_attention(q, kc, vc, pos)
                g += 1
            else:
                kc = blocks._cache_write(cache["k"][i], k, slot)
                vc = blocks._cache_write(cache["v"][i], v, slot)
                o = decode_attention(q, kc, vc, pos, ring=True)
            attn_o = o.reshape(b, 1, cfg.q_dim) @ lp["wo"]
            mst = ssm_lib.MambaState(cache["m_h"][i], cache["m_conv"][i])
            mamba_o, mst = ssm_lib.mamba_mix(h, mst, lp, cfg.ssm.state_dim)
            cache["m_h"][i] = mst.h
            cache["m_conv"][i] = mst.conv
            x = x + attn_o + mamba_o
            x, _aux = blocks.ffn_sublayer(x, lp, cfg)
        return x
