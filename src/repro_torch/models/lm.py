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

Caches are dicts of stacked tensors and a host ``pos``.  The model lives
on one device, the card unless the caller passes ``device="cpu"``.

**On a mesh** (`sharding/`; the port's partition is written out in
`sharding/specs.py`), `forward` runs under `sharding.specs.use_mesh_axes`
on this rank's batch rows with the parameter tree's local blocks: each
layer's parameters are gathered as it runs (`constrain_layer_params`,
inside the layer's remat), the residual stream between layers is split
over tp along the sequence (`_res_constrain`) and the logits are of this
rank's block of it (the whole sequence with ``collect_kv``).
``CausalLM(..., mesh=mesh)`` holds the local blocks and serves on the
mesh: `prefill` and `decode_step` take the whole batch and return its
whole logits on every rank (the ("batch", None, "vocab") logits gathered
over fsdp; a batch the fsdp axes do not divide runs whole on every rank),
and its caches live in `cache_specs`' layout (`init_cache` makes the
local blocks): an attention cache's sequence split over tp, an RWKV
state's heads split over tp.  Its decode steps read weights gathered on
the first step and kept: the experts' tp block and every other leaf
whole, so a rank holds the whole model while it decodes (per-layer
gathers each step would move the whole model through the collectives
per token).  The hybrid's decode on a mesh is not ported (ROADMAP); its
`cache_specs` are.
"""
from __future__ import annotations

import contextlib
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
from repro_torch.sharding import collectives as C
from repro_torch.sharding.params import (Sharding, batch_divides, fit, param_shardings,
                                         shard_batch, tree_shardings)
from repro_torch.sharding.specs import (MeshAxes, batch_split, constrain_kv_collect,
                                        constrain_layer_params, current_mesh, local_block,
                                        maybe_constrain, no_mesh, use_mesh_axes)


# the products whose outputs ``remat="dots"`` keeps: those without batch
# dimensions (``x @ w``; the attention einsums and the experts' ``bmm``
# are batched and recomputed)
_SAVED_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` (one layer) checkpointed as ``cfg.remat`` says, while
    gradients are recorded (module doc).  Under a mesh the layer runs in
    the mesh's context wherever it runs: its recompute runs in the
    backward pass, which on the card is autograd's own thread, where the
    caller's thread-local context is not set."""
    ctx = current_mesh()
    if ctx is not None:
        inner, split = fn, batch_split()

        def fn(*args):
            with use_mesh_axes(ctx[0], split):
                return inner(*args)

    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"unknown remat {cfg.remat!r}")


def _whole(params: dict, cfg: ModelConfig, name: str) -> torch.Tensor:
    """A top-level leaf, gathered under a mesh (its backward scatters the
    gradient back into the local block)."""
    ctx = current_mesh()
    if ctx is None:
        return params[name]
    return C.gather_leaf(params[name], param_shardings(cfg, ctx[0])[name])


def _embed_in(params: dict, cfg: ModelConfig, tokens=None, embeds=None) -> torch.Tensor:
    device = params["embed"].device
    if embeds is not None:
        return embeds.to(device, cfg.torch_dtype)
    # `F.embedding`: its backward on the card sums each row's gradients in
    # one order on every run, so a resumed run repeats a straight one
    return F.embedding(tokens.to(device).long(), _whole(params, cfg, "embed")
                       ).to(cfg.torch_dtype)


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, _whole(params, cfg, "ln_f"), cfg.norm_eps)
    head = _whole(params, cfg, "embed").T if cfg.tie_embeddings else _whole(params, cfg, "head")
    return x @ head.to(x.dtype)


def _seq_split(s: int) -> bool:
    """Whether the residual stream of an ``s``-long sequence is split over
    tp between layers (the reference's fitted (batch → fsdp, seq → tp))."""
    ctx = current_mesh()
    if ctx is None:
        return False
    return fit(ctx[0], (None, ctx[1].tp), (1, s))[1] is not None


def _res_constrain(x: torch.Tensor) -> torch.Tensor:
    """The residual stream's layout between layers: this rank's block of
    the sequence over tp (identity where tp does not divide it)."""
    ctx = current_mesh()
    if ctx is None:
        return x
    return maybe_constrain(x, ctx[0], (None, ctx[1].tp, None))


def _res_gather(x: torch.Tensor, s: int) -> torch.Tensor:
    """The whole sequence of a residual block, gathered over tp."""
    if not _seq_split(s):
        return x
    mesh, axes = current_mesh()
    return C.all_gather(x, mesh, axes.tp, 1)


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
    starts its recurrent state from zeros.  Runs where ``params`` lies.
    Under a mesh: this rank's batch rows and parameter blocks; the logits
    are of its block of the residual's sequence (all of it with
    ``collect_kv``)."""
    x = _embed_in(params, cfg, tokens, embeds)
    device = x.device
    b, s, _ = x.shape
    stacked = params["blocks"]
    aux = torch.zeros((), dtype=torch.float32, device=device)
    x = _res_constrain(x)

    def layer(i: int) -> dict:
        return {k: v[i] for k, v in stacked.items()}

    def out_logits(x):
        return _logits(params, cfg, _res_gather(x, s) if collect_kv else x)

    if cfg.block_kind == "rwkv":
        def rwkv_body(x, lp):
            x = _res_gather(x, s)
            x, st = blocks.rwkv_block(x, constrain_layer_params(lp, cfg), cfg,
                                      _rwkv_state(cfg, b, device))
            return _res_constrain(x), st

        states = []
        for i in range(cfg.n_layers):
            x, st = _remat(rwkv_body, cfg)(x, layer(i))
            if collect_kv:
                states.append(st)
        collected = (ssm_lib.RWKVState(*(torch.stack(t) for t in zip(*states)))
                     if collect_kv else None)
        return out_logits(x), aux, collected

    positions = (_default_positions(cfg, b, s, device) if positions is None
                 else positions.to(device))
    window = cfg.window if cfg.attn_kind == "sliding" else None

    def attn_body(x, lp):
        x, kv, a = blocks.attn_block(_res_gather(x, s), constrain_layer_params(lp, cfg), cfg,
                                     positions, window=window, collect_kv=collect_kv)
        return _res_constrain(x), kv, a

    def hybrid_body(x, lp, win):
        mst = ssm_lib.mamba_state_init(b, cfg.ssm.expand * cfg.d_model, cfg.ssm.state_dim,
                                       cfg.ssm.conv_dim, cfg.torch_dtype, device)
        x, kv, mst, a = blocks.hybrid_block(_res_gather(x, s), constrain_layer_params(lp, cfg),
                                            cfg, positions, mst, window=win,
                                            collect_kv=collect_kv)
        return _res_constrain(x), kv, mst, a

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
    return out_logits(x), aux, collected


def _uses_ring(cfg: ModelConfig) -> bool:
    """A window-sized ring cache: pure sliding-window archs, and the
    hybrid's sliding layers."""
    return cfg.block_kind == "hybrid" or (cfg.attn_kind == "sliding" and not cfg.global_layers)


def cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Slots per layer of the attention cache: ``max_len``, or a
    window-sized ring for pure sliding-window archs (starcoder2: 4,096 of
    32k) and for every layer of the hybrid (its global layers keep a
    full-length cache of their own)."""
    return min(cfg.window, max_len) if _uses_ring(cfg) else max_len


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The decode cache's tensors on the ``meta`` device (``pos`` a 0-d
    int32), for its layout on a mesh."""
    dt, l = cfg.torch_dtype, cfg.n_layers

    def meta(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device="meta")

    c = {"pos": meta(dtype=torch.int32)}
    if cfg.block_kind == "rwkv":
        h, hd = cfg.d_model // cfg.ssm.head_dim, cfg.ssm.head_dim
        c.update(s=meta(l, batch, h, hd, hd, dtype=torch.float32),
                 last_x=meta(l, batch, cfg.d_model), last_xc=meta(l, batch, cfg.d_model))
        return c
    kv = (l, batch, cache_len(cfg, max_len), cfg.n_kv_heads, cfg.head_dim)
    c.update(k=meta(*kv), v=meta(*kv))
    if cfg.block_kind == "hybrid":
        lg = max(len(cfg.global_layers), 1)
        gkv = (lg, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        di = cfg.ssm.expand * cfg.d_model
        c.update(gk=meta(*gkv), gv=meta(*gkv),
                 m_h=meta(l, batch, di, cfg.ssm.state_dim, dtype=torch.float32),
                 m_conv=meta(l, batch, cfg.ssm.conv_dim - 1, di))
    return c


def cache_specs(cfg: ModelConfig, axes: MeshAxes) -> dict:
    """Specs for the cache tree (the reference's, entry for entry)."""
    fsdp, tp = axes.fsdp, axes.tp
    c: dict = {"pos": ()}
    if cfg.block_kind == "rwkv":
        c["s"] = (None, fsdp, tp, None, None)
        c["last_x"] = (None, fsdp, None)
        c["last_xc"] = (None, fsdp, None)
        return c
    if cfg.block_kind == "hybrid":
        c["k"] = (None, fsdp, None, None, None)
        c["v"] = c["k"]
        c["gk"] = (None, fsdp, tp, None, None)  # global KV: seq over tp
        c["gv"] = c["gk"]
        c["m_h"] = (None, fsdp, tp, None)
        c["m_conv"] = (None, fsdp, None, tp)
        return c
    c["k"] = (None, fsdp, tp, None, None)       # seq over tp (kv_heads < tp)
    c["v"] = c["k"]
    return c


class CausalLM(nn.Module):
    """A decoder of any of the ten archs on one device (module doc).
    ``params`` is the reference's tree of tensors (`models/convert.py`
    makes one from the reference's arrays or at random); it is moved to
    ``device``.  With ``mesh``, ``params`` is this rank's blocks
    (`sharding.params.param_shardings`) and the model serves on the mesh
    (module doc); ``device`` is then the mesh's."""

    def __init__(self, cfg: ModelConfig, params: dict, *,
                 device: "str | torch.device | None" = None, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        # decode on a mesh: each layer's and the top leaves' gathered
        # weights, kept after their first gather (module doc)
        self._kept: dict = {}
        self.device = mesh.device if mesh is not None else resolve_device(device)
        if mesh is not None:
            def check(p, sh: Sharding, where=""):
                if tuple(p.shape) != sh.local_shape:
                    raise ValueError(f"{where} has shape {tuple(p.shape)}; its block on "
                                     f"{mesh} is {sh.local_shape}")

            shs = param_shardings(cfg, mesh)
            for k, sh in shs.items():
                if isinstance(sh, dict):
                    for n, shn in sh.items():
                        check(params[k][n], shn, f"blocks.{n}")
                else:
                    check(params[k], sh, k)

        def param(t: torch.Tensor) -> nn.Parameter:
            return nn.Parameter(t.to(self.device), requires_grad=False)

        self.embed = param(params["embed"])
        self.ln_f = param(params["ln_f"])
        self.head = None if cfg.tie_embeddings else param(params["head"])
        self.blocks = nn.ParameterDict({k: param(v) for k, v in params["blocks"].items()})

    # ------------------------------------------------------------------
    def _layer(self, i: int) -> dict:
        """Layer ``i``'s parameters for a decode step (on a mesh gathered
        once and kept, module doc)."""
        if self.mesh is None:
            return {k: v[i] for k, v in self.blocks.items()}
        if i not in self._kept:
            self._kept[i] = constrain_layer_params({k: v[i] for k, v in self.blocks.items()},
                                                   self.cfg)
        return self._kept[i]

    def _window(self) -> "int | None":
        return self.cfg.window if self.cfg.attn_kind == "sliding" else None

    def _on_mesh(self, rows: int):
        """The mesh's context for a batch of ``rows`` rows (a no-op
        context without one)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return use_mesh_axes(self.mesh, batch_divides(self.mesh, rows))

    def params(self) -> dict:
        """The parameter tree (the module's tensors, shared)."""
        p = {"embed": self.embed, "blocks": dict(self.blocks), "ln_f": self.ln_f}
        if self.head is not None:
            p["head"] = self.head
        return p

    def _top(self):
        """The top leaves for a decode step and the context to read them
        in: on a mesh the kept whole leaves (module doc), read with no
        mesh since they are gathered already."""
        if self.mesh is None:
            return self.params(), contextlib.nullcontext()
        if "top" not in self._kept:
            shs = param_shardings(self.cfg, self.mesh)
            self._kept["top"] = {k: C.gather_leaf(v, shs[k]) for k, v in self.params().items()
                                 if k != "blocks"}
        return self._kept["top"], no_mesh()

    def _embed_in(self, tokens=None, embeds=None) -> torch.Tensor:
        params, ctx = self._top()
        with ctx:
            return _embed_in(params, self.cfg, tokens, embeds)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        params, ctx = self._top()
        with ctx:
            return _logits(params, self.cfg, x)

    def _positions(self, b: int, s: int, offset: int = 0) -> torch.Tensor:
        return _default_positions(self.cfg, b, s, self.device, offset)

    def _d_inner(self) -> int:
        return self.cfg.ssm.expand * self.cfg.d_model

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, tokens=None, embeds=None, positions=None, collect_kv: bool = False):
        """→ (logits (B, S, V), aux_loss, collected or None) (module doc),
        recording no gradients.  On a mesh: the whole batch in, this
        rank's block out (its rows, and its block of the sequence unless
        ``collect_kv``)."""
        rows = next(v for v in (tokens, embeds) if v is not None).shape[0]
        with self._on_mesh(rows):
            if self.mesh is not None:
                batch = shard_batch(self.mesh, {k: v for k, v in (
                    ("tokens", tokens), ("embeds", embeds), ("positions", positions))
                    if v is not None}, self.cfg, "prefill")
                tokens, embeds, positions = (batch.get(k) for k in ("tokens", "embeds",
                                                                    "positions"))
            return forward(self.params(), self.cfg, tokens, embeds, positions, collect_kv)

    def cache_len(self, max_len: int) -> int:
        """Slots per layer of the attention cache (`cache_len`)."""
        return cache_len(self.cfg, max_len)

    def cache_shardings(self, batch: int, max_len: int) -> dict:
        """The cache's `Sharding`s on the mesh (`cache_specs` fitted to
        `cache_shapes`), ``pos`` left out: it is a host int."""
        shapes = cache_shapes(self.cfg, batch, max_len)
        del shapes["pos"]
        specs = cache_specs(self.cfg, MeshAxes.for_mesh(self.mesh))
        return tree_shardings(self.mesh, shapes, {k: specs[k] for k in shapes})

    def init_cache(self, batch: int, max_len: int) -> dict:
        """Zero caches for ``batch`` rows (the whole batch; on a mesh, this
        rank's blocks of its caches, and ``t``: the attention cache's whole
        length, a host int like ``pos``)."""
        if self.mesh is not None:
            shapes = cache_shapes(self.cfg, batch, max_len)
            return {"pos": 0, "t": self.cache_len(max_len), **{k: torch.zeros(sh.local_shape, dtype=shapes[k].dtype,
                                                device=self.device)
                                 for k, sh in self.cache_shardings(batch, max_len).items()}}
        return self._whole_cache(batch, max_len)

    def _whole_cache(self, batch: int, max_len: int) -> dict:
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
        length, which is the default).  On a mesh: the whole batch in,
        its whole logits out on every rank, and this rank's cache blocks."""
        batch = {k: v for k, v in (("tokens", tokens), ("embeds", embeds),
                                   ("positions", positions)) if v is not None}
        b_all = next(iter(batch.values())).shape[0]
        with self._on_mesh(b_all):
            if self.mesh is not None:
                self._mesh_decode_supported()
                batch = shard_batch(self.mesh, batch, self.cfg, "prefill")
            logits, cache = self._prefill(batch.get("tokens"), batch.get("embeds"),
                                          batch.get("positions"), max_len)
            if self.mesh is not None:
                cache = self._cut_cache(cache, b_all)
                logits = self._whole_batch(logits)
        return logits, cache

    def _mesh_decode_supported(self) -> None:
        if self.cfg.block_kind == "hybrid":
            raise NotImplementedError("the hybrid's prefill and decode on a mesh are not "
                                      "ported (ROADMAP queue 1); its cache_specs are")

    def _whole_batch(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the batch, gathered over fsdp (the rows
        already, where the batch is whole on every rank)."""
        if not batch_split():
            return x
        return C.all_gather(x, self.mesh, MeshAxes.for_mesh(self.mesh).fsdp, 0)

    def _cut_cache(self, cache: dict, b_all: int) -> dict:
        """A cache of this rank's batch rows, whole along its other
        dimensions, cut to this rank's blocks (`cache_specs`)."""
        t = 1 if self.cfg.block_kind == "rwkv" else cache["k"].shape[2]
        out = {"pos": cache["pos"], "t": t}
        for k, sh in self.cache_shardings(b_all, t).items():
            if k in ("k", "v"):
                continue
            spec = tuple(None if d == 1 else e for d, e in enumerate(sh.spec))
            out[k] = local_block(cache[k], self.mesh, spec).contiguous()
        if "k" in cache:
            # each layer's (B, T, Hkv, hd) rows to the decode layout
            k, v = constrain_kv_collect(cache["k"].flatten(0, 1), cache["v"].flatten(0, 1))
            out["k"], out["v"] = (c.unflatten(0, cache["k"].shape[:2]).contiguous()
                                  for c in (k, v))
        return out

    def _prefill(self, tokens, embeds, positions, max_len):
        cfg = self.cfg
        logits, _aux, collected = forward(self.params(), cfg, tokens, embeds, positions,
                                          collect_kv=True)
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
            if _uses_ring(cfg) and s >= t:
                roll = s % t  # ring layout: token i lives in slot i % t
                k = torch.roll(k_all[:, :, -t:], roll, dims=2)
                v = torch.roll(v_all[:, :, -t:], roll, dims=2)
            if k.shape[2] == t and mamba is None:
                cache = {"k": k, "v": v}  # no copy: the stack (or ring) is the cache
            else:
                cache = self._whole_cache(b, max_len)
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
        → (logits (B, V), the cache, updated in place).  On a mesh: the
        whole batch's token in, its whole logits out on every rank, this
        rank's cache blocks updated."""
        with self._on_mesh(next(v for v in (token, embed) if v is not None).shape[0]):
            if self.mesh is not None:
                self._mesh_decode_supported()
                kind = {k: v for k, v in (("token", token), ("embed", embed)) if v is not None}
                local = shard_batch(self.mesh, kind, self.cfg, "decode")
                token, embed = local.get("token"), local.get("embed")
            logits, cache = self._decode_step(cache, token, embed)
            if self.mesh is not None:
                logits = self._whole_batch(logits)
        return logits, cache

    def _split(self, local: int) -> "tuple[int, int]":
        """(this rank's first index, the whole length) of a dimension of
        ``local`` entries per rank split over tp."""
        tp = MeshAxes.for_mesh(self.mesh).tp
        return self.mesh.index(tp) * local, local * self.mesh.shape[tp]

    def _decode_step(self, cache: dict, token, embed):
        cfg = self.cfg
        x = self._embed_in(token, embed)
        b = x.shape[0]
        pos = int(cache["pos"])
        mesh = self.mesh
        if cfg.block_kind == "rwkv":
            heads = gather = None
            h_loc = cache["s"].shape[2]
            if mesh is not None and h_loc < cfg.d_model // cfg.ssm.head_dim:
                h0 = self._split(h_loc)[0]
                heads = (h0, h0 + h_loc)
                tp = MeshAxes.for_mesh(mesh).tp

                def gather(yn):
                    return C.all_gather(yn, mesh, tp, 2)
            for i in range(cfg.n_layers):
                st = ssm_lib.RWKVState(cache["s"][i], cache["last_x"][i], cache["last_xc"][i])
                x, st = blocks.rwkv_block(x, self._layer(i), cfg, st, chunk=1, heads=heads,
                                          gather=gather)
                cache["s"][i] = st.s
                cache["last_x"][i] = st.last_x
                cache["last_xc"][i] = st.last_xc
        elif cfg.block_kind == "hybrid":
            x = self._decode_hybrid(x, cache, pos)
        else:
            positions = self._positions(b, 1, offset=pos)
            ring = _uses_ring(cfg)
            t_loc = cache["k"].shape[2]
            total = cache.get("t", t_loc)  # the whole length of a cache on a mesh
            split = None if total == t_loc else (self._split(t_loc)[0], total)
            slot = pos % total if ring else None
            for i in range(cfg.n_layers):
                lp = self._layer(i)
                x, _, _ = blocks.attn_decode_sublayer(
                    x, lp, cfg, cache["k"][i], cache["v"][i], pos, positions,
                    window=None if ring else self._window(), ring=ring, slot=slot, split=split)
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
