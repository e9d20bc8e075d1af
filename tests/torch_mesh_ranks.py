"""Rank programs for the port's mesh tests (`tests/test_torch_mesh.py` on
gloo ranks of the CPU, `tests/test_torch_cuda_sharding.py` on the card).

Each is a `launch.ranks.spawn_ranks` target, ``fn(payload, device)``,
called in every rank of an initialised gloo group; it builds its mesh
over the whole group and returns what rank 0 (or every rank) holds.  It
imports no JAX and nothing of the reference: payloads carry the
reference's starting points already converted to the port's tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe
from repro_torch.models.common import MoEConfig
from repro_torch.models.lm import CausalLM
from repro_torch.sharding import collectives as C
from repro_torch.sharding.params import local_tree, param_shardings, zip_tree
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.grad_compress import Compressor
from repro_torch.train.optimizer import BLOCK, OptConfig, tree_leaves, tree_map
from repro_torch.train.train_step import (make_train_step, train_state_shapes,
                                          train_state_shardings)


def _host(tree):
    return zip_tree(lambda t: t.detach().cpu().numpy(), tree)


class Float64:
    """Inside the block the port computes in float64: every ``.float()`` a
    ``.double()`` and every config's dtype float64 (`chip_smoke.Float64`)."""

    def __enter__(self):
        from repro_torch.models.common import ModelConfig

        self.saved = (torch.Tensor.float, ModelConfig.torch_dtype)
        torch.Tensor.float = torch.Tensor.double
        ModelConfig.torch_dtype = property(lambda self: torch.float64)
        return self

    def __exit__(self, *exc):
        from repro_torch.models.common import ModelConfig

        torch.Tensor.float, ModelConfig.torch_dtype = self.saved


def as_float64(tree):
    """Every floating leaf of a tree made float64."""
    return zip_tree(lambda t: t.double() if t.is_floating_point() else t, tree)


def _cfg(arch: str, capacity=None):
    cfg = get_config(arch).smoke()
    if capacity is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               capacity_factor=capacity))
    return cfg


def straddling_leaves(shardings) -> list[str]:
    """The parameters whose last dimension is split with a shard width
    that is not a multiple of the 256-wide Q8 block."""
    out = []
    for name, sh in zip(_names(shardings), tree_leaves(shardings)):
        if sh.spec[-1] is not None and sh.local_shape[-1] % BLOCK:
            out.append(name)
    return out


def _names(tree, prefix="") -> list[str]:
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], prefix + k + "/")]
    return [prefix.rstrip("/")]


def train(mesh, case: dict, device) -> dict:
    """``case["steps"]`` sharded train steps from the whole start
    ``case["state"]`` on ``case["batch"]``: the losses, whether every local
    leaf has its block's shape and lies on ``device``, the parameters
    gathered whole (rank 0) and the state kept for a checkpoint."""
    cfg = _cfg(case["arch"], case.get("capacity"))
    opt = OptConfig(kind=case["kind"], lr=case.get("lr", 1e-3))
    shs = train_state_shardings(cfg, opt, mesh)
    state = zip_tree(lambda t: t.to(device), local_tree(case["state"], shs))
    shapes_ok = all(tuple(t.shape) == sh.local_shape and t.device.type == device.type
                    for t, sh in zip(tree_leaves(state), tree_leaves(shs)))
    local_shapes = train_state_shapes(cfg, opt, shs)
    shapes_ok &= all(tuple(a.shape) == tuple(t.shape)
                     for a, t in zip(tree_leaves(local_shapes), tree_leaves(state)))
    step = make_train_step(cfg, opt, microbatches=case["mb"], grad_shardings=shs.params)
    losses = []
    for _ in range(case["steps"]):
        state, m = step(state, case["batch"])
        losses.append(float(m["loss"]))
    whole = C.gather_tree(state.params, shs.params)
    return {"losses": losses, "shapes_ok": shapes_ok, "state": state, "shardings": shs,
            "straddling": straddling_leaves(shs.params),
            "params": _host(whole) if dist.get_rank() == 0 else None}


def decode(mesh, case: dict, device) -> dict:
    """A prefill of ``case["prompt"]`` and ``case["steps"]`` greedy decode
    steps on the mesh from the whole parameters ``case["params"]``: each
    step's whole logits and tokens (rank 0)."""
    cfg = _cfg(case["arch"], case.get("capacity"))
    shs = param_shardings(cfg, mesh)
    params = tree_map(lambda t: t.to(device), local_tree(case["params"], shs))
    model = CausalLM(cfg, params, mesh=mesh)
    prompt = torch.as_tensor(case["prompt"])
    logits, cache = model.prefill(prompt, max_len=case["max_len"])
    steps, tokens = [logits.float().cpu().numpy()], []
    for _ in range(case["steps"]):
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        tokens.append(tok.cpu().numpy())
        logits, cache = model.decode_step(cache, tok)
        steps.append(logits.float().cpu().numpy())
    split = {k: tuple(v.shape) for k, v in cache.items() if torch.is_tensor(v)}
    return {"logits": np.stack(steps), "tokens": np.concatenate(tokens, 1), "cache_shapes": split}


def moe_case(mesh, case: dict, device) -> dict:
    """`moe_ffn_sharded` on this rank's tokens and experts; the output
    gathered over the data shards, the aux and the dropped pairs."""
    from repro_torch.sharding.specs import MeshAxes, local_block

    axes = MeshAxes.for_mesh(mesh)
    cfg = MoEConfig(**case["cfg"])
    x, router, wg, wu, wd = (torch.as_tensor(a).to(device) for a in case["arrays"])
    x_loc = local_block(x, mesh, (axes.fsdp, None))
    ex = [local_block(w, mesh, (axes.tp, None, None)) for w in (wg, wu, wd)]
    y, aux, dropped = moe.moe_ffn_sharded(x_loc, router, *ex, cfg, mesh, axes.fsdp, axes.tp,
                                          with_dropped=True)
    y = C.all_gather(y, mesh, axes.fsdp, 0)
    return {"y": y.cpu().numpy(), "aux": float(aux), "dropped": int(dropped)}


def mesh_rank(payload: dict, device: torch.device) -> dict:
    """Every case of ``payload`` on one ``payload["mesh"]`` = (data, model)
    mesh, in order; a checkpoint of the last train case's state is saved
    from the mesh into ``payload["ckpt_dir"]`` when given."""
    mesh = make_host_mesh(*payload["mesh"], device=device)
    out: dict = {"train": {}, "decode": {}, "moe": {}}
    last = None
    for name, case in payload.get("train", {}).items():
        last = train(mesh, case, device)
        out["train"][name] = {k: v for k, v in last.items() if k not in ("state", "shardings")}
    out["train_f64"] = {}
    for name, case in payload.get("train_f64", {}).items():
        with Float64():
            res = train(mesh, {**case, "state": as_float64(case["state"])}, device)
        out["train_f64"][name] = res["params"]
    for name, case in payload.get("decode", {}).items():
        out["decode"][name] = decode(mesh, case, device)
    for name, case in payload.get("moe", {}).items():
        out["moe"][name] = moe_case(mesh, case, device)
    if payload.get("adam8"):
        out["adam8"] = adam8_case(mesh, device)
    if payload.get("ckpt_dir") and last is not None:
        ckpt.save(payload["ckpt_dir"], 3, last["state"], shardings=last["shardings"])
    out["stats"] = C.STATS.snapshot()
    return out


def restore_rank(payload: dict, device: torch.device) -> dict:
    """Elastic restores onto a ``payload["mesh"]`` mesh: each checkpoint of
    ``payload["restores"]`` (directory, arch, optimizer kind) read as this
    rank's blocks, gathered whole (rank 0); then the int8 compressed
    all-reduce of `Compressor` over the world on ``payload["compress"]``
    (one row a rank)."""
    mesh = make_host_mesh(*payload["mesh"], device=device)
    out: dict = {"restored": {}}
    for name, (path, arch, kind) in payload.get("restores", {}).items():
        cfg, opt = _cfg(arch), OptConfig(kind=kind)
        shs = train_state_shardings(cfg, opt, mesh)
        state, step = ckpt.restore(path, train_state_shapes(cfg, opt), shardings=shs)
        ok = all(tuple(t.shape) == sh.local_shape
                 for t, sh in zip(tree_leaves(state), tree_leaves(shs)))
        whole = C.gather_tree(state, shs)
        out["restored"][name] = {"step": step, "shapes_ok": ok,
                                 "state": _host(whole) if dist.get_rank() == 0 else None}
    if "compress" in payload:
        g = torch.as_tensor(payload["compress"][dist.get_rank()]).to(device)
        comp = Compressor.init({"g": g})
        got, _ = comp.compress({"g": g}, group=dist.group.WORLD)
        out["compressed"] = got["g"].cpu().numpy()
    return out


# leaves of the adam8bit case: (shape, spec) with the last dimension over
# tp = 4 as 96-wide shards (blocks straddle), 256-wide ones (aligned, the
# scales split alike) and 128-wide ones whose 2 scales do not split
ADAM8_LEAVES = {"straddle": ((6, 384), (("data",), ("model",))),
                "aligned": ((4, 1024), (None, ("model",))),
                "scales_whole": ((2, 512), (("data",), ("model",)))}
ADAM8_CFG = dict(kind="adam8bit", lr=1e-2, weight_decay=0.01, grad_clip=0.0)


def adam8_inputs():
    """Whole parameters, two gradients and the state after a first whole
    step from zeros: the second step is the one compared."""
    from repro_torch.train.optimizer import apply_updates, init_opt_state

    g = torch.Generator().manual_seed(7)
    params = {k: torch.randn(shape, generator=g) for k, (shape, _) in ADAM8_LEAVES.items()}
    grads = [{k: torch.randn(shape, generator=g) * 0.1 for k, (shape, _) in ADAM8_LEAVES.items()}
             for _ in range(2)]
    cfg = OptConfig(**ADAM8_CFG)
    params, state, _ = apply_updates(params, grads[0], init_opt_state(params, cfg), cfg)
    return params, grads[1], state


def adam8_case(mesh, device) -> dict:
    """The second adam8bit step on this rank's blocks, gathered whole."""
    from repro_torch.sharding.params import Sharding, fit, opt_state_specs, tree_shardings
    from repro_torch.train.optimizer import apply_updates

    params, grads, state = adam8_inputs()
    pshs = {k: Sharding(mesh, fit(mesh, spec, shape), shape)
            for k, (shape, spec) in ADAM8_LEAVES.items()}
    oshs = tree_shardings(mesh, state, opt_state_specs({k: s for k, (_, s) in
                                                        ADAM8_LEAVES.items()}, "adam8bit"))
    local = [zip_tree(lambda t, sh: t[sh.block()].contiguous().to(device), tree, shs)
             for tree, shs in ((params, pshs), (grads, pshs), (state, oshs))]
    new_p, new_s, _ = apply_updates(*local, OptConfig(**ADAM8_CFG), shardings=pshs)
    return {"params": _host(C.gather_tree(new_p, pshs)),
            "state": _host(C.gather_tree(new_s, oshs)),
            "straddling": straddling_leaves(pshs)}


def pod_rank(payload: dict, device: torch.device) -> dict:
    """On a (pod, data, model) mesh: every rank's (pod, data) block index
    gathered over the fsdp axes ("pod", "data"), a group of two axes, and
    a reduce-scatter over them: → both, per rank."""
    from repro_torch.sharding.specs import MeshAxes

    mesh = make_host_mesh(*payload["mesh"], device=device)
    fsdp = MeshAxes.for_mesh(mesh).fsdp
    mine = torch.full((1, 2), float(mesh.index(fsdp)), device=device)
    gathered = C.all_gather(mine, mesh, fsdp, 0)
    n = mesh.axis_size(fsdp)
    scattered = C._raw_reduce_scatter(torch.arange(2.0 * n, device=device)[:, None]
                                      * (mesh.coords["model"] + 1), mesh, fsdp, 0)
    return {"coords": mesh.coords, "index": mesh.index(fsdp),
            "gathered": gathered.cpu().numpy(), "scattered": scattered.cpu().numpy()}
