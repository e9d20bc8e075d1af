"""Parameter / optimizer / batch sharding trees (PyTorch port of the
reference's ``sharding/params.py``).

Rules (fsdp = ("pod","data") or ("data",); tp = "model"):
  * weights: d_model → fsdp (ZeRO-3/FSDP), heads·hd and d_ff → tp
    (Megatron column/row), experts → tp (expert parallelism), vocab → tp;
  * every spec is *fitted* per tensor: a mesh axis that does not divide the
    dim is dropped (granite-moe's vocab of 49,155 loses its tp axis).

`tree_shardings` zips a tree of shapes (tensors, ``meta`` ones too) with a
tree of specs into a tree of `Sharding`s: the fitted spec, the global
shape and this rank's local block.  Trees are dicts and named tuples
(`TrainState`, `OptState`, `Q8`); a spec is a plain tuple.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.sharding.specs import Mesh, MeshAxes, _names


def _axis_size(mesh: Mesh, entry) -> int:
    return math.prod(mesh.shape[a] for a in _names(entry))


def fit(mesh: Mesh, spec: tuple, shape: tuple) -> tuple:
    """Drop spec entries whose mesh-axis size does not divide the dim (or
    is 1); every kept entry is spelled as a tuple of axis names."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        size = _axis_size(mesh, entry)
        out.append(_names(entry) if size > 1 and dim % size == 0 else None)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's layout on a mesh: its fitted spec and global shape."""
    mesh: Mesh
    spec: tuple
    shape: tuple

    @property
    def local_shape(self) -> tuple:
        return tuple(d // self.mesh.axis_size(e) for d, e in zip(self.shape, self.spec))

    def block(self) -> tuple:
        """This rank's block of the global tensor, as slices."""
        return tuple(slice(self.mesh.index(e) * n, (self.mesh.index(e) + 1) * n)
                     for e, n in zip(self.spec, self.local_shape))

    def replica_axes(self) -> tuple:
        """The mesh axes the spec does not use: the ranks along them hold
        the same block."""
        used = {a for e in self.spec for a in _names(e)}
        return tuple(a for a in self.mesh.axis_names if a not in used)

    def is_first_replica(self) -> bool:
        """Whether this rank is coordinate 0 along every replica axis (the
        one copy of its block that a global sum counts)."""
        return all(self.mesh.coords[a] == 0 for a in self.replica_axes())


def zip_tree(fn, tree, *rest):
    """``fn`` over the leaves of same-shaped trees (dicts and named tuples;
    a plain tuple is a leaf: a spec), keeping the first tree's structure."""
    if isinstance(tree, dict):
        return {k: zip_tree(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(zip_tree(fn, *xs) for xs in zip(tree, *rest)))
    return fn(tree, *rest)


def tree_shardings(mesh: Mesh, shapes_tree, specs_tree):
    """A tree of shapes zipped with a tree of specs → a tree of
    `Sharding`s, every spec fitted to its tensor's shape."""
    def one(x, spec):
        shape = tuple(x.shape)
        return Sharding(mesh, fit(mesh, spec, shape), shape)

    return zip_tree(one, shapes_tree, specs_tree)


def local_tree(tree, shardings):
    """Each leaf of a tree of whole tensors cut to its `Sharding`'s block
    (a contiguous copy, so the whole tensor can be freed)."""
    return zip_tree(lambda x, sh: x[sh.block()].contiguous(), tree, shardings)


# ---------------------------------------------------------------------------
# Parameter specs (mirrors models.convert.param_shapes)
# ---------------------------------------------------------------------------

def block_param_specs(cfg: ModelConfig, axes: MeshAxes) -> dict:
    f, t = axes.fsdp, axes.tp
    p: dict = {"ln1": (None, None), "ln2": (None, None)}
    if cfg.block_kind in ("attn", "hybrid"):
        p["wq"] = (None, f, t)
        p["wk"] = (None, f, t)
        p["wv"] = (None, f, t)
        p["wo"] = (None, t, f)
    if cfg.block_kind == "rwkv":
        p["mu"] = (None, None, None)
        for nm in ("wr", "wk_t", "wv_t", "wg_t"):
            p[nm] = (None, f, t)
        p["wo_t"] = (None, t, f)
        p["w0"] = (None, None)
        p["wlA"] = (None, f, None)
        p["wlB"] = (None, None, f)
        p["u"] = (None, None, None)
        p["ln_x"] = (None, None)
        p["mu_ck"] = (None, None)
        p["mu_cr"] = (None, None)
        p["c_wk"] = (None, f, t)
        p["c_wv"] = (None, t, f)
        p["c_wr"] = (None, f, t)
        return p
    if cfg.block_kind == "hybrid" and cfg.ssm is not None:
        p["m_in"] = (None, f, t)
        p["m_conv"] = (None, t, None)
        p["m_Alog"] = (None, t, None)
        p["m_x"] = (None, t, None)
        p["m_dtw"] = (None, None, t)
        p["m_dtb"] = (None, t)
        p["m_D"] = (None, t)
        p["m_out"] = (None, t, f)
    if cfg.moe is not None:
        p["router"] = (None, f, None)
        p["e_wg"] = (None, t, f, None)
        p["e_wu"] = (None, t, f, None)
        p["e_wd"] = (None, t, None, f)
    if cfg.moe is None or cfg.moe.dense_residual:
        if cfg.act == "swiglu":
            p["wg_f"] = (None, f, t)
        p["wu_f"] = (None, f, t)
        p["wd_f"] = (None, t, f)
    return p


def param_specs(cfg: ModelConfig, axes: MeshAxes) -> dict:
    f, t = axes.fsdp, axes.tp
    p = {
        "embed": (t, f),
        "blocks": block_param_specs(cfg, axes),
        "ln_f": (None,),
    }
    if not cfg.tie_embeddings:
        p["head"] = (f, t)
    return p


def opt_state_specs(pspecs, kind: str, axes: "MeshAxes | None" = None):
    """Optimizer-state specs mirroring the param tree."""
    from repro_torch.train.optimizer import Q8, OptState

    if kind == "adam8bit":
        # Q8 moments live in the parameter's own shape: q shards exactly
        # like the param; the per-block scale inherits the same spec and
        # `fit()` drops the last-dim axis when n_blocks doesn't divide.
        def q8(node):
            if isinstance(node, dict):
                return {k: q8(v) for k, v in node.items()}
            return Q8(q=node, scale=node)

        return OptState(step=(), m=q8(pspecs), v=q8(pspecs))
    return OptState(step=(), m=pspecs, v=pspecs)


def train_state_specs(cfg: ModelConfig, axes: MeshAxes, opt_kind: str):
    from repro_torch.train.train_step import TrainState

    ps = param_specs(cfg, axes)
    return TrainState(params=ps, opt=opt_state_specs(ps, opt_kind, axes), step=())


def batch_specs(cfg: ModelConfig, axes: MeshAxes, kind: str) -> dict:
    f = axes.fsdp
    s: dict = {}
    if kind in ("train", "prefill"):
        if cfg.frontend is not None:
            s["embeds"] = (f, None, None)
        else:
            s["tokens"] = (f, None)
        if kind == "train":
            s["labels"] = (f, None)
        if cfg.rope_kind == "mrope":
            s["positions"] = (f, None, None)
    else:
        if cfg.frontend is not None:
            s["embed"] = (f, None, None)
        else:
            s["token"] = (f, None)
    return s


# ---------------------------------------------------------------------------
# The model's layouts on a mesh
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def param_shardings(cfg: ModelConfig, mesh: Mesh) -> dict:
    """The parameter tree's `Sharding`s on ``mesh`` (``param_specs``
    fitted to `models.convert.param_shapes`)."""
    from repro_torch.models.convert import param_shapes

    shapes = param_shapes(cfg)

    def meta(node):
        if isinstance(node, dict):
            return {k: meta(v) for k, v in node.items()}
        return torch.empty(node, device="meta")

    return tree_shardings(mesh, meta(shapes), param_specs(cfg, MeshAxes.for_mesh(mesh)))


@functools.lru_cache(maxsize=64)
def layer_shardings(cfg: ModelConfig, mesh: Mesh) -> dict:
    """One layer's leaves' `Sharding`s: the stacked ones without their
    (unsplit) layer dimension."""
    return {k: Sharding(mesh, sh.spec[1:], sh.shape[1:])
            for k, sh in param_shardings(cfg, mesh)["blocks"].items()}


def shard_batch(mesh: Mesh, batch: dict, cfg: ModelConfig, kind: str) -> dict:
    """This rank's block of a global batch (`batch_specs` fitted: the
    batch over the fsdp axes, or whole on every rank when they do not
    divide it, as the reference's fitted spec replicates it)."""
    specs = batch_specs(cfg, MeshAxes.for_mesh(mesh), kind)
    out = {}
    for k, x in batch.items():
        spec = specs.get(k, (MeshAxes.for_mesh(mesh).fsdp,))
        out[k] = x[Sharding(mesh, fit(mesh, spec, tuple(x.shape)), tuple(x.shape)).block()]
    return out


def batch_divides(mesh: Mesh, rows: int) -> bool:
    """Whether a batch of ``rows`` rows is split over the fsdp axes
    (`shard_batch`), rather than held whole on every rank."""
    return fit(mesh, (MeshAxes.for_mesh(mesh).fsdp,), (rows,))[0] is not None
