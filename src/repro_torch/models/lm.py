"""Full language-model assembly for attention-only archs: forward, prefill
and decode (PyTorch port of the reference's ``lm.py``, its attention
``else:`` branches).

`CausalLM` holds the reference's parameter tree — ``embed`` (V, d), the
blocks stacked over layers (L, …), ``ln_f`` and ``head`` (d, V) unless
the embeddings are tied — and loops over the layers in Python:

  * `forward`     — a sequence; with ``collect_kv`` it also returns every
                    layer's (k, v), stacked (L, B, S, Hkv, hd);
  * `prefill`     — forward that also fills the decode caches: a ring of
                    ``min(window, max_len)`` slots per layer for pure
                    sliding-window archs (token t in slot t % T), the
                    stack itself when the prompt fills the cache;
  * `decode_step` — one token against the caches, written in place.

Caches are dicts of stacked tensors and a host ``pos``.  The reference's
sharding constraints (``_res_constrain``, ``constrain``,
``constrain_layer_params``) are dropped: on one card they do nothing.
Experts, the hybrid and the RWKV blocks raise `NotImplementedError`
(`blocks.NOT_PORTED`).  The model lives on one device, the card unless
the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import rms_norm


class CausalLM(nn.Module):
    """An attention-only decoder on one device (module doc).  ``params``
    is the reference's tree of tensors (`models/convert.py` makes one from
    the reference's arrays or at random); it is moved to ``device``."""

    def __init__(self, cfg: ModelConfig, params: dict, *,
                 device: "str | torch.device | None" = None):
        super().__init__()
        blocks.require_attention_only(cfg)
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
        return self.cfg.attn_kind == "sliding" and not self.cfg.global_layers

    def _embed_in(self, tokens=None, embeds=None) -> torch.Tensor:
        if embeds is not None:
            return embeds.to(self.device, self.cfg.torch_dtype)
        return self.embed[tokens.to(self.device).long()].to(self.cfg.torch_dtype)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.ln_f, self.cfg.norm_eps)
        head = self.embed.T if self.cfg.tie_embeddings else self.head
        return x @ head.to(x.dtype)

    def _positions(self, b: int, s: int, offset: int = 0) -> torch.Tensor:
        pos = torch.arange(offset, offset + s, dtype=torch.int32, device=self.device)
        pos = pos[None, :].expand(b, s)
        if self.cfg.rope_kind == "mrope":
            pos = pos[..., None].expand(b, s, 3)
        return pos

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, tokens=None, embeds=None, positions=None, collect_kv: bool = False):
        """→ (logits (B, S, V), aux_loss, (k, v) stacked over layers or None)."""
        cfg = self.cfg
        x = self._embed_in(tokens, embeds)
        b, s, _ = x.shape
        positions = (self._positions(b, s) if positions is None
                     else positions.to(self.device))
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        ks, vs = [], []
        for i in range(cfg.n_layers):
            x, kv, a = blocks.attn_block(x, self._layer(i), cfg, positions,
                                         window=self._window(), collect_kv=collect_kv)
            aux = aux + a
            if collect_kv:
                ks.append(kv[0])
                vs.append(kv[1])
        collected = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
        return self._logits(x), aux, collected

    def cache_len(self, max_len: int) -> int:
        """Slots per layer: ``max_len``, or a window-sized ring for pure
        sliding-window archs (starcoder2: 4,096 of 32k)."""
        return min(self.cfg.window, max_len) if self._uses_ring() else max_len

    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        shape = (cfg.n_layers, batch, self.cache_len(max_len), cfg.n_kv_heads, cfg.head_dim)
        return {"pos": 0,
                "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=self.device),
                "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=self.device)}

    @torch.no_grad()
    def prefill(self, tokens=None, embeds=None, positions=None, max_len: "int | None" = None):
        """Run the full prompt; return (last-token logits (B, V), cache).
        ``max_len``: the decode cache's capacity (at least the prompt's
        length, which is the default)."""
        logits, _aux, (k, v) = self.forward(tokens, embeds, positions, collect_kv=True)
        b, s = logits.shape[:2]
        max_len = max(max_len or s, s)
        t = self.cache_len(max_len)
        if self._uses_ring() and s >= t:
            roll = s % t  # ring layout: token i lives in slot i % t
            cache = {"k": torch.roll(k[:, :, -t:], roll, dims=2),
                     "v": torch.roll(v[:, :, -t:], roll, dims=2)}
        elif s == t:
            cache = {"k": k, "v": v}  # no copy: the stack is the cache
        else:
            cache = self.init_cache(b, max_len)
            cache["k"][:, :, :s] = k
            cache["v"][:, :, :s] = v
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
        positions = self._positions(b, 1, offset=pos)
        ring = self._uses_ring()
        slot = pos % cache["k"].shape[2] if ring else None
        for i in range(cfg.n_layers):
            lp = self._layer(i)
            x, _, _ = blocks.attn_decode_sublayer(
                x, lp, cfg, cache["k"][i], cache["v"][i], pos, positions,
                window=None if ring else self._window(), ring=ring, slot=slot)
            x = blocks.ffn_sublayer(x, lp, cfg)
        cache["pos"] = pos + 1
        return self._logits(x)[:, 0, :], cache
