"""Production and host mesh factories over a `torch.distributed` group
(PyTorch port of the reference's ``launch/mesh.py``).

FUNCTIONS, not module-level constants: importing this module touches no
process group.  Each builds ``init_device_mesh`` over the group the caller
initialised (gloo ranks from `launch.ranks.spawn_ranks`; the ``fake``
backend for the production meshes' layouts in one process) and raises when
the world size is not the mesh's.  Ranks are laid out row-major over the
axes.

The reference's ``utils/jax_compat.py`` has no counterpart: its
``make_mesh`` is these two functions on ``init_device_mesh``, and its
``shard_map`` is the explicit collectives of `sharding.collectives`
inside the port's sharded functions (`models.moe.moe_ffn_sharded`, the
cache write and split-softmax decode of `models.blocks`).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.sharding.specs import Mesh


def _make_mesh(shape: tuple, axes: tuple, device) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group is initialised: start the ranks first "
                           "(launch.ranks.spawn_ranks) or init_process_group")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {' x '.join(map(str, shape))} mesh {axes} needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    if device.type == "cuda":
        # every rank of a group on one card uses device 0; with a card per
        # rank, the rank's own
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    dm = init_device_mesh(device.type, shape, mesh_dim_names=axes)
    return Mesh(dm, device)


def make_production_mesh(*, multi_pod: bool = False,
                         device: "str | torch.device | None" = None) -> Mesh:
    """16×16 single-pod (256 ranks) or 2×16×16 multi-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1, pod: "int | None" = None, *,
                   device: "str | torch.device | None" = None) -> Mesh:
    """A small mesh over the ranks of one host: tests and the card's smoke
    run.  ``device``: where the ranks' tensors live (``None``: the card,
    raising without one)."""
    if pod is not None:
        return _make_mesh((pod, data, model), ("pod", "data", "model"), device)
    return _make_mesh((data, model), ("data", "model"), device)
