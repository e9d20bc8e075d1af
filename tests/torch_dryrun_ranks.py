"""Programs for the port's dry-run and hybrid-mesh tests
(`tests/test_torch_dryrun.py`, `tests/test_torch_hymba_mesh.py`).

  * `dry_side` runs in a process of its own (`python -m` this module with
    a job file): the port's dry run over fake worlds — collectives the
    port issues on a fake 2 × 16 mesh, the untraced records of every
    production cell, argument bytes at smoke size on 2 × 4, fake traces of
    smoke cells on 2 × 2 and the ``autotc`` count on 2 × 2;
  * `real_rank` is a `launch.ranks.spawn_ranks` target on 2 × 2 gloo
    ranks of the CPU: the same smoke cells run for real (collectives,
    FLOPs and argument bytes of each step), then `evolve_islands` with
    ``torch.distributed`` wrapped to list its collectives;
  * `hymba_rank` (2 × 4 gloo ranks): hymba's prefill and greedy decode on
    the mesh, and the same with a planted fault.

It imports no JAX and nothing of the reference: payloads carry the
reference's starting points already converted to the port's tensors.
"""
from __future__ import annotations

import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, ShapeConfig, get_config, input_specs, smoke_shape
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.convert import init_params
from repro_torch.models.lm import CausalLM
from repro_torch.sharding import collectives as C
from repro_torch.sharding.params import (layer_shardings, local_tree, param_shardings,
                                         shard_batch)
from repro_torch.sharding.specs import MeshAxes
from repro_torch.train.optimizer import OptConfig, tree_leaves
from repro_torch.utils.collective_stats import Call, collective_stats

# (d): one arch of each block kind, and an embeds frontend
SMOKE_ARCHS = ("minitron-8b", "granite-moe-1b-a400m", "rwkv6-7b", "hymba-1.5b",
               "musicgen-medium")
KINDS = ("train_4k", "prefill_32k", "decode_32k")
# (e): a small island problem on 2 islands x 2 shards
ISLAND = dict(rows=1000, n_inputs=12, n_gates=20, n_cls=3, lam=4, gens=6, migrate_every=2)
# the five dtypes the port's collectives send
DTYPES = (torch.float32, torch.bfloat16, torch.float64, torch.int8, torch.int32)


def smoke(name: str) -> ShapeConfig:
    return smoke_shape(SHAPES[name])


def smoke_batch(cfg, shape: ShapeConfig, seed: int = 0) -> dict:
    """A seeded batch of the cell's inputs (numpy)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, (s, dt) in input_specs(cfg, shape).items():
        if dt.is_floating_point:
            out[k] = rng.randn(*s).astype(np.float32)
        elif k == "positions":
            out[k] = np.broadcast_to(np.arange(s[1], dtype=np.int32)[None, :, None], s).copy()
        else:
            out[k] = rng.randint(0, cfg.vocab, s).astype(np.int32)
    return out


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree) if torch.is_tensor(t))


# ---------------------------------------------------------------------------
# The dry side (fake worlds, one process)
# ---------------------------------------------------------------------------

def dry_side(job: dict) -> dict:
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch import dryrun as D

    out: dict = {}
    # (a): the port's own collectives on a fake 2 x 16 mesh, every kind
    mesh = D.fake_host_mesh((2, 16), "cpu")
    axes = MeshAxes.for_mesh(mesh)
    with C.STATS.recording() as calls:
        for i, dt in enumerate(DTYPES):
            x = torch.zeros((32, 3 + i), dtype=dt)
            C._raw_all_gather(x, mesh, axes.tp, 0)
            C._raw_all_reduce(x, mesh, axes.fsdp)
            for group in (axes.fsdp, axes.tp):     # groups of 2 and 16
                C._raw_reduce_scatter(x, mesh, group, 0)
        C.all_reduce_max(torch.zeros(5), mesh, mesh.axis_names)
    out["calls"] = list(calls)
    # (b): every production cell's untraced record
    out["cells"] = {}
    for mesh_name in D.MESHES:
        mesh = D.production_mesh(mesh_name, "cpu")
        for arch in ARCH_IDS:
            for shape in SHAPES:
                out["cells"][(mesh_name, arch, shape)] = D.cell_record(arch, shape, mesh,
                                                                       mesh_name)
    # (c): argument bytes at smoke size on 2 x 4
    mesh = D.fake_host_mesh((2, 4), "cpu")
    out["smoke_args"] = {(a, k): D.argument_bytes(get_config(a).smoke(), smoke(k), mesh)
                         for a in job["smoke_args"] for k in KINDS}
    # (d): the smoke cells traced on 2 x 2; (e): autotc's count on 2 x 2
    mesh = D.fake_host_mesh((2, 2), "cpu")
    out["traced"] = {}
    for a in SMOKE_ARCHS:
        for k in KINDS:
            rec = D.trace_step(get_config(a).smoke(), smoke(k), mesh)
            out["traced"][(a, k)] = {key: rec.get(key) for key in
                                     ("memory", "cost", "collectives", "first_step", "ops")}
    # the peak counts the mesh device alone: arctic's spec tree, made on
    # ``meta`` inside a train step whose caches are cold, holds ~50 GB
    # (its experts whole in float32), against ~2 GB a rank on the device
    out["cold_warm_peaks"] = cold_warm_peaks(D)
    out["autotc"] = D.autotc_record(ISLAND["rows"], mesh, {
        k: ISLAND[k] for k in ("n_inputs", "n_gates", "n_cls", "lam")} | {"n_out": job["n_out"]})
    return out


def cold_warm_peaks(D) -> tuple:
    """Peaks of one arctic layer's train step on the 16 x 16 mesh (64 x 256
    tokens, a row a data shard in each of its 4 microbatches), traced with
    the spec-tree caches cold, then warm."""
    import dataclasses

    mesh = D.production_mesh("single_pod_16x16", "cpu")
    cfg = dataclasses.replace(get_config("arctic-480b"), n_layers=1)
    shape = ShapeConfig("probe", "train", 256, 64)
    param_shardings.cache_clear()
    layer_shardings.cache_clear()
    return tuple(D.trace_step(cfg, shape, mesh)["memory"]["peak_size_in_bytes"]
                 for _ in range(2))


# ---------------------------------------------------------------------------
# The real side (gloo ranks of the CPU)
# ---------------------------------------------------------------------------

def _measured(fn) -> dict:
    """One step's collectives and this rank's FLOPs."""
    from torch.utils.flop_counter import FlopCounterMode

    flops = FlopCounterMode(display=False)
    with C.STATS.recording() as calls, flops:
        fn()
    return {"collectives": collective_stats(calls), "flops": float(flops.get_total_flops())}


def real_cell(mesh, arch: str, kind: str) -> dict:
    """The smoke cell run for real on this rank: each step's collectives
    and FLOPs, and the bytes of its inputs on this rank."""
    from repro_torch.train.train_step import (make_train_state, make_train_step,
                                              train_state_shardings)

    cfg, shape = get_config(arch).smoke(), smoke(kind)
    batch = {k: torch.from_numpy(v) for k, v in smoke_batch(cfg, shape).items()}
    local_batch = _bytes(shard_batch(mesh, batch, cfg, shape.kind))
    gen = torch.Generator().manual_seed(0)
    if shape.kind == "train":
        opt = OptConfig(kind=cfg.optimizer)
        shs = train_state_shardings(cfg, opt, mesh)
        state = make_train_state(gen, cfg, opt, shardings=shs)
        step = make_train_step(cfg, opt, microbatches=cfg.train_microbatches,
                               grad_shardings=shs.params)
        return {"args": _bytes(state) + local_batch, "steps": [_measured(lambda: step(state,
                                                                                      batch))]}
    params = local_tree(init_params(gen, cfg, "cpu"), param_shardings(cfg, mesh))
    model = CausalLM(cfg, params, mesh=mesh)
    if shape.kind == "prefill":
        return {"args": _bytes(params) + local_batch,
                "steps": [_measured(lambda: model.prefill(**batch))]}
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    cache["pos"] = shape.seq_len - 2
    steps = [_measured(lambda: model.decode_step(cache, batch.get("token"), batch.get("embed")))
             for _ in range(2)]
    return {"args": _bytes(params) + _bytes({k: v for k, v in cache.items()
                                             if torch.is_tensor(v)}) + local_batch,
            "steps": steps}


class _ListedDist:
    """``torch.distributed``'s all_reduce and isend wrapped inside the block:
    each call listed as a `Call` (an isend as the ring's permute; its
    irecv is the same exchange)."""

    def __init__(self):
        self.calls: list = []

    def __enter__(self):
        self.saved = dist.all_reduce, dist.isend
        all_reduce, isend = self.saved

        def listed_all_reduce(t, *a, group=None, **kw):
            self.calls.append(Call("all_reduce", t.dtype, tuple(t.shape),
                                   dist.get_world_size(group)))
            return all_reduce(t, *a, group=group, **kw)

        def listed_isend(t, dst, group=None, **kw):
            self.calls.append(Call("permute", t.dtype, tuple(t.shape),
                                   dist.get_world_size(group)))
            return isend(t, dst, group=group, **kw)

        dist.all_reduce, dist.isend = listed_all_reduce, listed_isend
        return self

    def __exit__(self, *exc):
        dist.all_reduce, dist.isend = self.saved


def island_problem(seed: int = 0):
    """A seeded packed problem padded for 2 shards: (spec, data, masks)."""
    from repro_torch.core import gates
    from repro_torch.core.encoding import pack_dataset, split_masks
    from repro_torch.core.genome import CircuitSpec

    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 2, (ISLAND["rows"], ISLAND["n_inputs"])).astype(np.uint8)
    y = rng.randint(0, ISLAND["n_cls"], ISLAND["rows"])
    data = pack_dataset(bits, y, ISLAND["n_cls"], pad_words_to=2, device="cpu")
    masks = split_masks(len(y), data.x_words.shape[1], 0.5, seed=1, device="cpu")
    spec = CircuitSpec(ISLAND["n_inputs"], ISLAND["n_gates"], data.n_outputs, gates.FULL_FS)
    return spec, data, masks


def islands_case() -> dict:
    """`evolve_islands` on 2 islands x 2 shards (this world) for
    ``ISLAND["gens"]`` generations, every collective listed."""
    from repro_torch.core.evolve import EvolveConfig
    from repro_torch.core.islands import IslandConfig, evolve_islands

    spec, data, masks = island_problem()
    cfg = EvolveConfig(lam=ISLAND["lam"], kappa=10**6, max_gens=ISLAND["gens"])
    with _ListedDist() as listed:
        evolve_islands(0, spec, cfg, IslandConfig(ISLAND["migrate_every"], 2), data, *masks,
                       device="cpu")
    return {"calls": listed.calls, "n_out": spec.n_outputs}


def real_rank(payload: dict, device: torch.device) -> dict:
    mesh = make_host_mesh(2, 2, device=device)
    out = {"cells": {(a, k): real_cell(mesh, a, k) for a in SMOKE_ARCHS for k in KINDS}}
    out["islands"] = islands_case()
    return out


# ---------------------------------------------------------------------------
# hymba on a 2 x 4 mesh
# ---------------------------------------------------------------------------

def wrong_rank_state(m_h: torch.Tensor, mesh) -> torch.Tensor:
    """The planted fault: each rank's Mamba state block replaced by the
    next tp rank's (the state written to the wrong tp rank)."""
    tp = MeshAxes.for_mesh(mesh).tp
    n = mesh.shape[tp]
    whole = C.all_gather(m_h, mesh, tp, 2)
    return whole.chunk(n, dim=2)[(mesh.index(tp) + 1) % n].contiguous()


def hymba_rank(payload: dict, device: torch.device) -> dict:
    """Prefill and greedy decode of ``payload["prompt"]`` on a 2 x 4 mesh
    from the whole ``payload["params"]``; then the same prompt with the
    planted fault, fed the clean run's tokens: rank 0's whole logits and
    tokens, and every rank's cache shapes."""
    mesh = make_host_mesh(2, 4, device=device)
    cfg = get_config("hymba-1.5b").smoke()
    model = CausalLM(cfg, local_tree(payload["params"], param_shardings(cfg, mesh)), mesh=mesh)
    prompt = torch.as_tensor(payload["prompt"])

    def run(fault: bool, feed=None):
        logits, cache = model.prefill(prompt, max_len=payload["max_len"])
        if fault:
            cache["m_h"] = wrong_rank_state(cache["m_h"], mesh)
        steps, tokens = [logits.numpy()], []
        for i in range(payload["steps"]):
            tok = logits.argmax(-1)[:, None].to(torch.int32) if feed is None else feed[:, i:i + 1]
            tokens.append(tok)
            logits, cache = model.decode_step(cache, tok)
            steps.append(logits.numpy())
        shapes = {k: tuple(v.shape) for k, v in cache.items() if torch.is_tensor(v)}
        return np.stack(steps), torch.cat(tokens, 1), shapes

    logits, tokens, shapes = run(False)
    fault_logits, _, _ = run(True, tokens)
    return {"logits": logits, "tokens": tokens.numpy(), "fault_logits": fault_logits,
            "cache_shapes": shapes, "t": model.init_cache(8, payload["max_len"])["t"]}


if __name__ == "__main__":
    with open(sys.argv[1], "rb") as f:
        job = pickle.load(f)
    res = dry_side(job)
    with open(sys.argv[2], "wb") as f:
        pickle.dump(res, f)
