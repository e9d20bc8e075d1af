"""Sharding rules: logical axes → mesh axes, the ambient mesh, and the
port's partition of the model over it (PyTorch port of the reference's
``sharding/specs.py``).

Production meshes (`launch/mesh.py`):
  * single-pod: (16, 16)  axes ("data", "model")
  * multi-pod:  (2, 16, 16) axes ("pod", "data", "model")

Policy: fsdp = ("pod","data") (or ("data",)), tp = "model".
  * batch / tokens         → fsdp
  * d_model of weights     → fsdp       (FSDP / ZeRO-3 style)
  * heads·head_dim, d_ff   → tp         (Megatron column/row parallel)
  * experts                → tp         (expert parallelism)
  * vocab                  → tp

A spec is a tuple with one entry per dimension: ``None``, an axis name or
a tuple of axis names, as the reference writes them; `params.fit` fits a
spec to a shape and spells every kept entry as a tuple of names.  The
specs (`params.py`, `models.lm.cache_specs`) are the reference's entry for
entry.  A rank's local tensor is the block of the global one at its mesh
coordinates (`Sharding.block`); the entry ("pod", "data") splits a
dimension into pod × data blocks, pod major.  Local tensors are plain
tensors beside a tree of `params.Sharding`s, not DTensors.

**The port's partition.**  GSPMD chose the reference's from the specs; the
port's is written out here, and its numerics are the reference's:

  * the batch is split over the fsdp axes (`shard_batch`) and replicated
    over tp; a batch the fsdp axes do not divide is replicated over them
    as well, as the reference's fitted batch spec does, and the model is
    told so (`use_mesh_axes(..., batch_split=False)`);
  * each layer's parameters are gathered just before the layer runs and
    dropped after it (`constrain_layer_params`, the reference's pin of a
    scanned layer's slices: a peak of about one gathered layer); under
    remat the gather is part of the recomputed layer;
  * the experts stay split over tp: gathered over fsdp only, each rank
    dispatches its data shard's tokens to its own experts and the combine
    is an all-reduce over tp (`models.moe.moe_ffn_sharded`), under the
    reference's condition (the batch's tokens divide over fsdp and tp
    divides the experts; else `moe_ffn` over the whole batch);
  * every other weight (attention, dense FFN, router, norms, embedding,
    head) is gathered over tp as well and its products run whole on every
    tp rank: tensor-parallel products are later work;
  * between layers the residual stream is split over tp along the
    sequence, when tp divides it (`_res_constrain`'s layout
    (batch → fsdp, seq → tp)): a layer gathers it over tp at its start
    and keeps its own block of the output, so a rematerialised layer
    saves 1/tp of its input; the logits and the loss are of that block;
  * gradients are reduced and scattered back into each parameter's
    layout by the gathers' backward (`grad_shardings`; the microbatch
    accumulator lives in that layout too);
  * decode caches live in `cache_specs`' layout: an attention cache's
    sequence is split over tp and attention over it is a split softmax
    combined over tp; RWKV's state is split by heads over tp;
  * decode steps read weights gathered once per model and kept (the
    experts' tp block, every other leaf whole): a rank holds the whole
    model while it decodes, where a step that gathered every layer again
    would move the whole model through the collectives per token.

Each rank's objective is its share of the global loss, so that the sum
over ranks is the loss and the gathers' backward (a reduce-scatter over
the gathered axes, then a sum over the axes a shard is replicated on)
gives each shard the global gradient (`train.train_step.loss_fn`).

`maybe_constrain`, `constrain`, `constrain_spec` and
`constrain_kv_collect` are redistributions of replicated tensors: each
returns this rank's block of a tensor every rank holds whole, iff the
spec divides its shape (the reference's rule), and the tensor unchanged
otherwise.  The batch entry of an activation's spec is already local (the
batch is split before the model runs), so the model code names only the
dimensions it splits.

`population_mesh` is the serving pick of a device per plan shard.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    fsdp: tuple[str, ...]
    tp: str

    @staticmethod
    def for_mesh(mesh: "Mesh") -> "MeshAxes":
        if "pod" in tuple(mesh.axis_names):
            return MeshAxes(fsdp=("pod", "data"), tp="model")
        return MeshAxes(fsdp=("data",), tp="model")


class Mesh:
    """A device mesh over the initialised process group: its axes and
    their sizes (``shape``, name → size, in mesh order), this rank's
    coordinates, the device its tensors live on, and a process group per
    set of axes (`group`).  `launch/mesh.py` builds one over
    ``init_device_mesh``; ranks are laid out row-major over the axes."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = torch.device(device)
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))
        coords = device_mesh.get_coordinate()
        self.coords = dict(zip(self.axis_names, coords))
        self.size = math.prod(self.shape.values())
        self._groups: dict = {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"

    def axis_size(self, entry) -> int:
        """Ranks along a spec entry: None, an axis name or a tuple of them."""
        return math.prod(self.shape[a] for a in _names(entry))

    def index(self, entry) -> int:
        """This rank's block index along a spec entry (row-major over its
        axes)."""
        i = 0
        for a in _names(entry):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes) -> "dist.ProcessGroup | None":
        """The process group of the ranks that differ only along ``axes``
        (``None``: the whole world); group rank = block index along them.
        Groups of one axis are the device mesh's; others are made on first
        use, by every rank in the same order."""
        axes = tuple(a for a in self.axis_names if a in _names(axes))
        if len(axes) == len(self.axis_names):
            return None
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if axes not in self._groups:
            # host arithmetic (numpy): no tensor, so a dry run's fake
            # tensor mode never sees it
            ranks = np.arange(self.size).reshape(tuple(self.shape.values()))
            keep = [self.axis_names.index(a) for a in axes]
            rest = [i for i in range(len(self.axis_names)) if i not in keep]
            ranks = ranks.transpose(*rest, *keep).reshape(-1, math.prod(
                self.shape[a] for a in axes))
            group, _ = dist.new_subgroups_by_enumeration(ranks.tolist())
            self._groups[axes] = group
        return self._groups[axes]


def _names(entry) -> tuple:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


# Logical axis vocabulary used by the model code.
#   "batch", "seq", "embed", "heads", "kv_heads", "head_dim", "ff",
#   "experts", "vocab", "layers", "state"
def logical(axes: MeshAxes) -> dict[str, object]:
    return {
        "batch": axes.fsdp,
        "seq": None,
        "embed": axes.fsdp,
        "embed_tp": axes.tp,      # alternate: shard embed over tp (lm head in)
        "heads": axes.tp,
        "kv_heads": None,          # replicated across tp (n_kv < tp in general)
        "head_dim": None,
        "ff": axes.tp,
        "experts": axes.tp,
        "vocab": axes.tp,
        "layers": None,
        "state": None,
        None: None,
    }


def spec_for(axes: MeshAxes, *names: "str | None") -> tuple:
    table = logical(axes)
    return tuple(table[n] for n in names)


def divisible(mesh: Mesh, shape: tuple, spec: tuple) -> bool:
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        size = mesh.axis_size(entry)
        if size > 1 and dim % size != 0:
            return False
    return True


def local_block(x: torch.Tensor, mesh: Mesh, spec: tuple) -> torch.Tensor:
    """This rank's block of ``x`` (held whole) under ``spec`` (a view)."""
    for dim, entry in enumerate(spec):
        n = mesh.axis_size(entry)
        if n > 1:
            size = x.shape[dim] // n
            x = x.narrow(dim, mesh.index(entry) * size, size)
    return x


def maybe_constrain(x: torch.Tensor, mesh: "Mesh | None", spec: tuple) -> torch.Tensor:
    """This rank's block of ``x`` iff the spec divides; ``x`` otherwise
    (module doc)."""
    if mesh is None or not divisible(mesh, tuple(x.shape), spec):
        return x
    return local_block(x, mesh, spec)


def population_mesh(n_shards: int, device: torch.device) -> list[torch.device]:
    """The device each plan shard of a fused serving launch runs on.

    Serving shards the *population* axis, not weights: each `LaunchPlan`
    shard is an independent fused launch, so the mesh is an ordered pick
    of local devices: shard ``s`` runs on ``cuda:{s % count}``.  Never
    larger than the shard count or the local device count (one card: one
    device, and all shards time-share it).  A device with an index, or
    the CPU, is every shard's."""
    if device.type != "cuda" or device.index is not None:
        return [device]
    n = max(1, min(int(n_shards), torch.cuda.device_count()))
    return [torch.device("cuda", s) for s in range(n)]


# ---------------------------------------------------------------------------
# Ambient mesh context — model code calls constrain(x, *logical_names) and is
# a no-op outside a mesh context (single device).
# ---------------------------------------------------------------------------

_TLS = threading.local()


@contextlib.contextmanager
def use_mesh_axes(mesh: Mesh, batch_split: bool = True):
    """``mesh`` the ambient mesh inside the block.  ``batch_split``: the
    model's batch rows are this rank's block over the fsdp axes (False:
    the whole batch on every rank, for a batch they do not divide)."""
    prev = getattr(_TLS, "ctx", None), getattr(_TLS, "batch_split", True)
    _TLS.ctx, _TLS.batch_split = (mesh, MeshAxes.for_mesh(mesh)), batch_split
    try:
        yield
    finally:
        _TLS.ctx, _TLS.batch_split = prev


def current_mesh() -> "tuple[Mesh, MeshAxes] | None":
    return getattr(_TLS, "ctx", None)


def batch_split() -> bool:
    """Whether the ambient mesh's batch rows are split over fsdp
    (`use_mesh_axes`)."""
    return getattr(_TLS, "batch_split", True)


@contextlib.contextmanager
def no_mesh():
    """No ambient mesh inside the block: whole tensors run as on one
    device (a decode session's gathered top leaves)."""
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = None
    try:
        yield
    finally:
        _TLS.ctx = prev


def constrain(x: torch.Tensor, *names: "str | None") -> torch.Tensor:
    ctx = current_mesh()
    if ctx is None:
        return x
    mesh, axes = ctx
    return maybe_constrain(x, mesh, spec_for(axes, *names))


def constrain_spec(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """Constrain to an explicit spec under the ambient mesh."""
    ctx = current_mesh()
    if ctx is None:
        return x
    return maybe_constrain(x, ctx[0], spec)


def constrain_kv_collect(k: torch.Tensor, v: torch.Tensor):
    """Collected prefill KV (B, S, Hkv, hd), its batch already local, to
    the decode cache's layout: the sequence over tp (kv_heads < tp cannot
    split the head dim)."""
    ctx = current_mesh()
    if ctx is None:
        return k, v
    mesh, axes = ctx
    spec = (None, axes.tp, None, None)
    return maybe_constrain(k, mesh, spec), maybe_constrain(v, mesh, spec)


def constrain_layer_params(lp: dict, cfg) -> dict:
    """One layer's local parameter slices gathered for the layer to run
    (module doc): every leaf whole, but the experts, which keep their tp
    block (gathered over fsdp only) for `models.moe.moe_ffn_sharded`.
    The gathers record their backward (a reduce-scatter into the local
    layout).  Identity outside a mesh."""
    ctx = current_mesh()
    if ctx is None:
        return lp
    mesh, axes = ctx
    from repro_torch.sharding.collectives import gather_leaf
    from repro_torch.sharding.params import layer_shardings

    out = {}
    for k, sh in layer_shardings(cfg, mesh).items():
        keep = (axes.tp,) if k in EXPERT_LEAVES else ()
        out[k] = gather_leaf(lp[k], sh, keep=keep)
    return out


# the expert leaves: split over tp through the layer (module doc)
EXPERT_LEAVES = frozenset({"e_wg", "e_wu", "e_wd"})
