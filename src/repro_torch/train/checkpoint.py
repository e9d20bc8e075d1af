"""Manifest-based checkpointing with async writes (PyTorch port of the
reference's ``checkpoint.py``, in its layout, key for key).

Layout:
    <dir>/step_000123/
        MANIFEST.json          tree structure, shapes, dtypes, step
        <leaf-path>.npy        one file per tree leaf ("/" in its key → "__")
    <dir>/LATEST               atomic pointer file

Keys are the reference's paths through a ``TrainState``: dict keys sorted,
named-tuple fields by name (``params/blocks/wq``, ``opt/m/embed/q``,
``opt/step``, ``step``).

Guarantees:
  * atomicity — data is written to `step_X.tmp` then `os.replace`d, so a
    crash mid-write can never corrupt the LATEST checkpoint, and
    `latest_step` falls back past a LATEST that points ahead;
  * restore onto any device — leaves are loaded full-shape on the host and
    moved to the device the caller names;
  * elastic restore — `save(..., shardings=)` on a mesh gathers every
    leaf whole and rank 0 writes today's files; `restore(...,
    shardings=)` onto any mesh reads each rank's block of each file
    (memory-mapped), so a 2 × 4 checkpoint restores onto 2 × 2, onto one
    process, or into the reference, unchanged;
  * async — `save(..., blocking=False)` snapshots to host memory and writes
    in a background thread, keeping the train loop running.

bfloat16 leaves: the reference ``np.save``s ``ml_dtypes.bfloat16`` arrays,
whose header says ``'<V2'`` (raw 16-bit words) while the manifest says
``"bfloat16"``.  numpy has no bfloat16 of its own, so such leaves are read
and written here as those raw words, by the manifest's dtype, in the same
bytes as the reference's files: checkpoints move both ways between the
packages.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

_SEP = "/"


def _children(tree) -> "list[tuple[str, Any]] | None":
    """A node's (name, child) pairs in the reference's order — dict keys
    sorted, named-tuple fields in order — or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    return None


def _flatten(tree, prefix: tuple = ()) -> dict[str, Any]:
    kids = _children(tree)
    if kids is None:
        return {_SEP.join(prefix): tree}
    flat: dict = {}
    for name, sub in kids:
        flat.update(_flatten(sub, prefix + (name,)))
    return flat


def _unflatten(template, flat: dict, prefix: tuple = ()):
    kids = _children(template)
    if kids is None:
        return flat[_SEP.join(prefix)]
    values = [_unflatten(sub, flat, prefix + (name,)) for name, sub in kids]
    if isinstance(template, dict):
        return {name: v for (name, _), v in zip(kids, values)}
    return type(template)(*values)


def _leaf_filename(key: str) -> str:
    return key.replace(_SEP, "__") + ".npy"


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A copy on the host; bfloat16 as its raw 16-bit words."""
    t = t.detach().to("cpu", copy=True)
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _write_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    # the reference's header for an ml_dtypes.bfloat16 array
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _read_leaf(path: str, dtype: str, block: "tuple | None" = None) -> torch.Tensor:
    """A leaf file as a tensor of the manifest's dtype; ``block``: only
    those slices of it, read through a memory map."""
    arr = np.load(path) if block is None else np.load(path, mmap_mode="r")[block]
    if dtype == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save(ckpt_dir: str, step: int, tree, blocking: bool = True,
         shardings=None) -> "threading.Thread | None":
    """Write a checkpoint. Returns the writer thread when blocking=False.
    ``shardings``: ``tree`` is this rank's blocks of a tree laid out so on
    a mesh; every rank calls, the leaves are gathered whole and rank 0
    writes (a blocking save returns on every rank once the files are
    written)."""
    if shardings is not None:
        import torch.distributed as dist

        from repro_torch.sharding.collectives import gather_tree

        whole = gather_tree(tree, shardings)
        writer = save(ckpt_dir, step, whole, blocking) if dist.get_rank() == 0 else None
        if blocking:
            dist.barrier()
        return writer
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    # snapshot to host memory first so the training loop may proceed (and
    # its device tensors be freed) while the files are written
    dtypes = {k: _dtype_name(v) for k, v in flat.items()}
    host = {k: _to_host(v) for k, v in flat.items()}
    manifest = {
        "step": int(step),
        "leaves": {
            k: {"shape": list(v.shape), "dtype": dtypes[k], "file": _leaf_filename(k)}
            for k, v in host.items()
        },
    }

    def write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for k, v in host.items():
            _write_leaf(os.path.join(tmp, _leaf_filename(k)), v, dtypes[k])
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(str(step))
        os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> "int | None":
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        s = int(f.read().strip())
    if os.path.exists(os.path.join(ckpt_dir, f"step_{s:08d}")):
        return s
    # LATEST pointer ahead of a completed dir (crash window) — fall back
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    return steps[-1] if steps else None


def restore(ckpt_dir: str, tree_template, step: "int | None" = None,
            device: "str | torch.device | None" = None, shardings=None):
    """Load a checkpoint into the structure of ``tree_template`` (tensors,
    on the ``meta`` device too, of the whole shapes) → (tree, step), each
    leaf in the manifest's dtype on ``device`` (``None``: the card).
    ``shardings``: a tree of `Sharding`s like the template's on a mesh;
    each leaf is then this rank's block, read alone, on the mesh's device
    (an elastic restore onto any mesh)."""
    flat_shard = {}
    if shardings is not None:
        flat_shard = _flatten(shardings)
        device = next(iter(flat_shard.values())).mesh.device
    device = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)

    loaded = {}
    for k, t in _flatten(tree_template).items():
        meta = manifest["leaves"][k]
        want = tuple(getattr(t, "shape", meta["shape"]))
        if tuple(meta["shape"]) != want:
            raise ValueError(f"checkpoint leaf {k} has shape {tuple(meta['shape'])}; "
                             f"the template's is {want}")
        block = flat_shard[k].block() if k in flat_shard else None
        loaded[k] = _read_leaf(os.path.join(d, meta["file"]), meta["dtype"], block).to(device)
    return _unflatten(tree_template, loaded), manifest["step"]
