"""Collectives over the axes of a mesh: all-gather, reduce-scatter and
all-reduce, the port's counterpart of ``shard_map``'s ``psum``/``pmean``
and of the collectives GSPMD inserts for the reference.

Each takes a tensor, a `specs.Mesh` and the mesh axes to run over (a spec
entry: an axis name or a tuple of them); over axes of one rank it returns
its input.  The autograd-aware forms record their adjoint, so gradients
flow through a sharded forward:

  * `all_gather` — backward: a reduce-scatter (sum) into the local block;
  * `all_reduce` (sum) — backward: an all-reduce (sum), the adjoint of a
    sum that every rank of the group goes on to use;
  * `gather_leaf` — a parameter's local block gathered along every split
    dimension (but the axes it is told to keep); backward: a
    reduce-scatter along each, then a sum over the axes the block is
    replicated on, so that every rank's gradient reaches the block.

`all_reduce_max` and `gather_tree` record nothing (a softmax's stabiliser;
a checkpoint's leaves).

**The path is the backend's.**  ``nccl`` (one card per rank) runs every
collective on the card.  ``gloo`` runs them on the host: on CPU tensors
directly, and on CUDA tensors gloo copies through host memory itself.
Every collective the port issues was accepted by gloo on CUDA tensors in
float32, bfloat16 and int8 on an H100 with torch 2.11 (`chip_smoke.py`'s
``sharded`` phase checks each, `gloo_on_cuda`), so this module keeps no
host-staged copy of its own.  Four ranks that share one card can only use
gloo: NCCL refuses two ranks on one device.

`STATS` counts the calls and bytes of each kind, labelled with the
transport (``"gloo-host"`` for CUDA tensors under gloo), so that a phase
line shows what went through the host.  Bytes are the payload: an
all-gather's output, a reduce-scatter's input, an all-reduce's tensor.
Milliseconds are counted only inside ``with STATS.timed():``, a
measurement's window: wall time around each call, with the card
synchronised before and after it when the tensor lives there.  Outside
the window a collective adds no host synchronisation of its own.  Inside
``with STATS.recording() as calls:`` each collective is also appended to
``calls`` as a `utils.collective_stats.Call` (its result's shape and its
group's size), which `collective_stats` turns into the reference's
record of the step's traffic (`launch/dryrun.py`).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch
import torch.distributed as dist

from repro_torch.sharding.specs import Mesh, _names
from repro_torch.utils.collective_stats import Call


class CollectiveStats:
    """Calls, bytes and ms per (kind, transport); `snapshot` reads them,
    ms are counted only inside `timed` and each call is listed only
    inside `recording` (module doc)."""

    def __init__(self):
        self.timing = False
        self.calls: "list[Call] | None" = None
        self.reset()

    @contextlib.contextmanager
    def recording(self):
        """Yield a list that every collective issued inside the block is
        appended to, as a `Call`."""
        prev, self.calls = self.calls, []
        try:
            yield self.calls
        finally:
            if prev is not None:
                prev.extend(self.calls)
            self.calls = prev

    @contextlib.contextmanager
    def timed(self):
        """Count each collective's milliseconds inside the block."""
        prev, self.timing = self.timing, True
        try:
            yield
        finally:
            self.timing = prev

    def reset(self) -> None:
        self.by_kind: dict = defaultdict(lambda: {"calls": 0, "bytes": 0, "ms": 0.0})

    def add(self, kind: str, transport: str, nbytes: int, ms: float, call: Call) -> None:
        s = self.by_kind[f"{kind}:{transport}"]
        s["calls"] += 1
        s["bytes"] += int(nbytes)
        s["ms"] += ms
        if self.calls is not None:
            self.calls.append(call)

    def snapshot(self) -> dict:
        return {k: dict(v) for k, v in sorted(self.by_kind.items())}


STATS = CollectiveStats()


def _transport(group, x: torch.Tensor) -> str:
    backend = dist.get_backend(group)
    if backend == "gloo" and x.device.type == "cuda":
        return "gloo-host"
    return str(backend)


class _Timed:
    """Counts one collective into `STATS`; inside `STATS.timed` also its
    ms, the card synchronised around it when the tensor lives there.
    ``result``: the collective's output on this rank (`STATS.recording`)."""

    def __init__(self, kind: str, group, x: torch.Tensor, nbytes: int, result: torch.Tensor):
        self.kind, self.group, self.x, self.nbytes = kind, group, x, nbytes
        self.call = Call(kind, result.dtype, tuple(result.shape), dist.get_world_size(group))
        self.sync = STATS.timing and x.device.type == "cuda"

    def __enter__(self):
        if self.sync:
            torch.cuda.synchronize(self.x.device)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.sync:
            torch.cuda.synchronize(self.x.device)
        ms = (time.perf_counter() - self.t0) * 1e3 if STATS.timing else 0.0
        STATS.add(self.kind, _transport(self.group, self.x), self.nbytes, ms, self.call)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


# ---------------------------------------------------------------------------
# Raw collectives (no autograd)
# ---------------------------------------------------------------------------

def _raw_all_gather(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    group = mesh.group(axes)
    x = x.contiguous()
    buf = x.new_empty((n * x.shape[0], *x.shape[1:]))
    with _Timed("all_gather", group, x, _nbytes(buf), buf):
        dist.all_gather_into_tensor(buf, x, group=group)
    if dim == 0:
        return buf
    return buf.view(n, *x.shape).movedim(0, dim).flatten(dim, dim + 1)


def _raw_reduce_scatter(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    group = mesh.group(axes)
    xs = x.unflatten(dim, (n, x.shape[dim] // n)).movedim(dim, 0).contiguous()
    out = xs.new_empty(xs.shape[1:])
    with _Timed("reduce_scatter", group, xs, _nbytes(xs), out):
        dist.reduce_scatter_tensor(out, xs.flatten(0, 1) if out.ndim else xs, op=dist.ReduceOp.SUM,
                                   group=group)
    return out


def _raw_all_reduce(x: torch.Tensor, mesh: Mesh, axes, op=dist.ReduceOp.SUM,
                    kind: str = "all_reduce") -> torch.Tensor:
    if mesh.axis_size(axes) == 1:
        return x
    group = mesh.group(axes)
    y = x.contiguous().clone()
    with _Timed(kind, group, y, _nbytes(y), y):
        dist.all_reduce(y, op=op, group=group)
    return y


def all_reduce_max(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """The elementwise max over ``axes`` (records no gradient)."""
    return _raw_all_reduce(x.detach(), mesh, axes, dist.ReduceOp.MAX, "all_reduce_max")


# ---------------------------------------------------------------------------
# Autograd-aware collectives
# ---------------------------------------------------------------------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _raw_all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _raw_reduce_scatter(g, *ctx.args), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return _raw_all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_reduce(g, *ctx.args), None, None


def all_gather(x: torch.Tensor, mesh: Mesh, axes, dim: int = 0) -> torch.Tensor:
    """The blocks of the ranks along ``axes`` concatenated along ``dim``,
    in block order (module doc)."""
    if mesh.axis_size(axes) == 1:
        return x
    return _AllGather.apply(x, mesh, axes, dim)


def all_reduce(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """The sum over the ranks along ``axes`` (module doc)."""
    if mesh.axis_size(axes) == 1:
        return x
    return _AllReduce.apply(x, mesh, axes)


def pmean(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """The mean over the ranks along ``axes``."""
    n = mesh.axis_size(axes)
    return x if n == 1 else all_reduce(x, mesh, axes) / n


class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sharding, dims):
        ctx.sharding, ctx.dims = sharding, dims
        if not dims:
            return x.view_as(x)
        for d in dims:
            x = _raw_all_gather(x, sharding.mesh, sharding.spec[d], d)
        return x

    @staticmethod
    def backward(ctx, g):
        sh = ctx.sharding
        for d in reversed(ctx.dims):
            g = _raw_reduce_scatter(g, sh.mesh, sh.spec[d], d)
        return _raw_all_reduce(g, sh.mesh, sh.replica_axes()), None, None


def gather_leaf(x: torch.Tensor, sharding, keep: tuple = ()) -> torch.Tensor:
    """A parameter's local block ``x`` gathered along every dimension its
    ``sharding`` splits, but those split over the ``keep`` axes (module
    doc).  Records its backward when ``x`` requires a gradient."""
    dims = tuple(d for d, e in enumerate(sharding.spec)
                 if e is not None and not set(_names(e)) & set(keep))
    if not dims and not sharding.replica_axes():
        return x
    return _GatherLeaf.apply(x, sharding, dims)


@torch.no_grad()
def gather_tree(tree, shardings):
    """Every leaf of a tree of local blocks gathered whole (no gradient)."""
    from repro_torch.sharding.params import zip_tree

    def one(x, sh):
        for d, e in enumerate(sh.spec):
            if e is not None:
                x = _raw_all_gather(x, sh.mesh, e, d)
        return x

    return zip_tree(one, tree, shardings)
