"""Multi-pod dry run (PyTorch port of the reference's ``launch/dryrun.py``).

For every (architecture × input shape × mesh) cell, rank 0 of the
production mesh runs the port's own sharded step — the program that
gloo ranks run for real (`launch/mesh.py`, `sharding/`) — on fake
tensors:

    fake process group of 256 or 512 ranks  →  make_production_mesh
    with FakeTensorMode():  local state / params / cache blocks, the batch
        one dispatch mode (ops, FLOPs, live bytes), STATS.recording()

and writes one JSON record per cell under
``experiments/dryrun_torch/<mesh>/<arch>__<shape>.json`` (git-ignored).
Nothing is allocated: a fake tensor has a shape, a dtype and a device
and no data, and the ``fake`` backend's collectives return at once.

Torch has no lowering, so the trace stands where the reference lowers
and compiles; what each record holds, against the reference's:

  * ``status`` ``ok``, ``skipped`` (``reason`` from `configs.applicable`)
    or ``error`` (``error``, ``traceback``); ``params``,
    ``active_params``, ``tokens``, ``kind`` as the reference's;
  * ``trace_s`` in place of ``lower_s``/``compile_s``;
  * ``memory.argument_size_in_bytes``: the bytes of the step's inputs on
    this rank, each its fitted block (`sharding.params.tree_shardings`);
    the batch counts its block, though the port's step is handed the
    whole batch and reads its rows of it, and a decode cache's host
    ``pos`` counts nothing (XLA holds it as a 4-byte scalar);
  * ``memory.output_size_in_bytes``: the bytes of the step's outputs on
    this rank; ``alias_size_in_bytes``: those of them that are arguments
    written in place (a decode cache; the train step writes nothing in
    place, where the reference donates its state);
  * ``memory.temp_size_in_bytes``: the traced peak of the live storages
    on the mesh's device (over both decode steps; the card's rounded to
    the caching allocator's 512 bytes, as ``MemTracker`` rounds them) less
    the arguments; ``peak_size_in_bytes`` is the peak itself.  The
    reference's ``generated_code_size_in_bytes`` has no meaning here and
    is left out;
  * ``cost.flops``: the step's executed FLOPs on this rank by
    `FlopCounterMode`'s formulas, every loop counted in full (the layer
    loop, the chunked attention's blocks, the microbatches).  The
    reference's ``cost_analysis`` counts a ``while`` body once
    (``benchmarks/roofline.py``), so the two are not compared;
  * ``collectives``: the reference's record (`utils.collective_stats`) of
    the collectives the step issued (`sharding.collectives.STATS`);
  * ``ops``: the aten ops the trace dispatched, by name, for
    `collective_stats.count_op`.

The counts come from one dispatch mode (`_Tracer`) rather than
``FlopCounterMode``, ``MemTracker`` and a counter stacked: every op and
every ``.device`` query passes each Python mode in turn, and the deep
cells' traces ran three times longer so.

Decode is traced over two steps.  The port's mesh decode gathers every
layer's weights on its first step and keeps them (`models.lm`), so the
record's ``cost`` and ``collectives`` are the second, steady step's, the
first step's go under ``first_step``, and ``memory`` is the peak the
rank really holds: the whole weights included.  The steps decode at
positions ``seq_len - 2`` and ``seq_len - 1`` of a ``seq_len`` cache.

The ``autotc`` cells (the paper's island evolution) are counted, not
traced: the island program's control flow depends on its data and its
kernel launches through ``ctypes``, which a fake trace cannot run.
`autotc_record` counts one generation from the program's shapes, as the
reference's cost counts its loop body once: each rank's packed data
shard, λ children's logic ops at every gate live, and the generation's
collectives (the data ``all_reduce`` of the counts, the ring's
``isend``/``irecv`` of one packed genome, which the program makes every
generation and accepts every ``migrate_every``, and the world
``all_reduce`` of the live flag).

Departures from the reference: the trace in place of lowering; executed
FLOPs; decode's two steps; ``autotc`` counted; and `run_cell` and
`build_lowerable` also take a `ShapeConfig` (and `trace_step` a
`ModelConfig` and any fake mesh), so that a check on the card can trace
the very batch a real sharded step runs.  No TPU figure is carried; the
port's peak rates are the H100's, stated where they are used.

Usage (``--device cpu`` traces CPU tensors; the default is the card, and
raises without one):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-moe-1b-a400m \\
        --shape train_4k --mesh single --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch autotc --mesh multi --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from collections import Counter

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, applicable, get_config, input_specs
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.common import ModelConfig
from repro_torch.models.lm import CausalLM, cache_shapes, cache_specs
from repro_torch.sharding import collectives as C
from repro_torch.sharding.params import (batch_specs, param_shardings, tree_shardings,
                                         zip_tree)
from repro_torch.sharding.specs import MeshAxes
from repro_torch.train.optimizer import OptConfig, tree_leaves
from repro_torch.train.train_step import (make_train_step, train_state_shapes,
                                          train_state_shardings)
from repro_torch.utils.collective_stats import Call, collective_stats

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun_torch")
MESHES = {"single_pod_16x16": False, "multi_pod_2x16x16": True}
AUTOTC_SHAPES = {"tab_small": 64 * 1024, "tab_large": 1024 * 1024}   # rows
# the reference's island cell: 128 input bits, 300 gates, 2 output bits,
# 4 classes, λ = 4 (its migration every 32 generations moves no other
# bytes: the ring sends every generation)
AUTOTC = dict(n_inputs=128, n_gates=300, n_out=2, n_cls=4, lam=4)


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------

def init_fake_world(world_size: int) -> None:
    """This process as rank 0 of a ``fake`` process group of
    ``world_size`` ranks (a group of another size is torn down first)."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401 — registers "fake"

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=world_size)


def production_mesh(mesh_name: str, device=None):
    """The production mesh ``mesh_name`` (a key of `MESHES`) over a fake
    world of its size, on ``device`` (``None``: the card)."""
    multi = MESHES[mesh_name]
    init_fake_world(512 if multi else 256)
    return make_production_mesh(multi_pod=multi, device=resolve_device(device))


def fake_host_mesh(shape: tuple, device=None):
    """A (data, model) or (pod, data, model) mesh over a fake world of its
    size: what a real group of that many ranks would run on."""
    init_fake_world(math.prod(shape))
    dims = dict(zip(("data", "model"), shape)) if len(shape) == 2 else \
        dict(zip(("pod", "data", "model"), shape))
    return make_host_mesh(**dims, device=resolve_device(device))


# ---------------------------------------------------------------------------
# The step of a cell
# ---------------------------------------------------------------------------

def _shape(shape) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if torch.is_tensor(t)]


def _local_bytes(shardings, shapes) -> int:
    """Bytes of each leaf's block under its `Sharding` (dtype from
    ``shapes``)."""
    return sum(tree_leaves(zip_tree(lambda sh, t: math.prod(sh.local_shape) * t.element_size(),
                                    shardings, shapes)))


def _param_shapes(cfg: ModelConfig):
    """The parameter tree on ``meta``, each leaf in its dtype."""
    return train_state_shapes(cfg, OptConfig()).params


def _batch_shapes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    return {k: torch.empty(s, dtype=dt, device="meta")
            for k, (s, dt) in input_specs(cfg, shape).items()}


def _batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh, batch: dict) -> dict:
    specs = batch_specs(cfg, MeshAxes.for_mesh(mesh), shape.kind)
    return tree_shardings(mesh, batch, {k: specs[k] for k in batch})


def argument_bytes(cfg: ModelConfig, shape, mesh, opt_cfg: "OptConfig | None" = None) -> int:
    """``memory.argument_size_in_bytes`` of a cell (module doc), from the
    fitted shardings alone: the train state (or the parameters, and for
    decode the cache but its host ``pos``) and the batch, each its block
    on this rank."""
    shape = _shape(shape)
    batch = _batch_shapes(cfg, shape)
    total = _local_bytes(_batch_shardings(cfg, shape, mesh, batch), batch)
    if shape.kind == "train":
        opt_cfg = opt_cfg or OptConfig(kind=cfg.optimizer)
        state = train_state_shapes(cfg, opt_cfg)
        return total + _local_bytes(train_state_shardings(cfg, opt_cfg, mesh), state)
    total += _local_bytes(param_shardings(cfg, mesh), _param_shapes(cfg))
    if shape.kind == "decode":
        cache = cache_shapes(cfg, shape.global_batch, shape.seq_len)
        del cache["pos"]
        specs = cache_specs(cfg, MeshAxes.for_mesh(mesh))
        total += _local_bytes(tree_shardings(mesh, cache, {k: specs[k] for k in cache}), cache)
    return total


@dataclasses.dataclass
class Lowerable:
    """A cell's step on fake tensors: ``steps`` (one, or decode's two),
    each called with no arguments, and the trees of its arguments."""
    steps: list
    args: tuple


def build_lowerable(cfg: ModelConfig, shape, mesh, opt_cfg: "OptConfig | None" = None
                    ) -> Lowerable:
    """The step of a cell, inside the caller's ``FakeTensorMode``: the
    train step with ``grad_shardings`` and ``cfg.train_microbatches``;
    `CausalLM.prefill`; or two decode steps against a ``seq_len`` cache
    (module doc).  Every tensor is a fake tensor on the mesh's device: the
    state, parameters and cache are this rank's blocks, the batch whole
    (the port's steps take the whole batch).  ``shape``: a name of
    `SHAPES` or a `ShapeConfig` (a departure: module doc)."""
    shape = _shape(shape)
    dev = mesh.device

    def empty(t):
        return torch.empty(t.shape, dtype=t.dtype, device=dev)

    batch = {k: empty(t) for k, t in _batch_shapes(cfg, shape).items()}
    if shape.kind == "train":
        opt_cfg = opt_cfg or OptConfig(kind=cfg.optimizer)
        shs = train_state_shardings(cfg, opt_cfg, mesh)
        state = zip_tree(empty, train_state_shapes(cfg, opt_cfg, shs))
        step = make_train_step(cfg, opt_cfg, microbatches=cfg.train_microbatches,
                               grad_shardings=shs.params)
        return Lowerable([lambda: step(state, batch)], (state, batch))

    params = zip_tree(lambda t, sh: torch.empty(sh.local_shape, dtype=t.dtype, device=dev),
                      _param_shapes(cfg), param_shardings(cfg, mesh))
    model = CausalLM(cfg, params, mesh=mesh)
    if shape.kind == "prefill":
        return Lowerable([lambda: model.prefill(**batch)], (params, batch))
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    cache["pos"] = shape.seq_len - 2
    token = batch.get("token")
    embed = batch.get("embed")
    step = [lambda: model.decode_step(cache, token, embed)] * 2
    return Lowerable(step, (params, cache, batch))


class _Tracer(TorchDispatchMode):
    """The trace's one dispatch mode above the fake tensors: the ops it
    dispatches by name (`names`), their FLOPs by `FlopCounterMode`'s
    formulas (`flops`), and the bytes of the live storages on the mesh's
    device, each rounded up to the caching allocator's 512 bytes on the
    card: the running ``live`` and its ``peak``.  A storage counts from
    its first appearance (`track` for the arguments) until it is freed."""

    def __init__(self, device: torch.device):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.device_type = device.type
        self.round = 512 if device.type == "cuda" else 1
        self.formulas = flop_registry
        self.ops: Counter = Counter()
        self.flops = 0
        self.live = self.peak = 0
        self.bytes: dict = {}

    def track(self, t: torch.Tensor) -> None:
        if t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self.bytes:
            return
        n = -(-st.nbytes() // self.round) * self.round
        self.bytes[key] = (n, weakref.ref(st, lambda _, k=key: self._free(k)))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key) -> None:
        self.live -= self.bytes.pop(key)[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is torch.ops.prim.device.default:
            return out
        self.ops[func] += 1
        formula = self.formulas.get(func.overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        for t in _tensors(out if isinstance(out, tuple) else (out,)):
            self.track(t)
        return out

    def names(self) -> dict:
        return {str(k): v for k, v in sorted(self.ops.items(), key=lambda kv: str(kv[0]))}


def _storages(tree) -> dict:
    """The bytes of a tree's tensors by their storage (a view counts once)."""
    out = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        out[st._cdata] = max(out.get(st._cdata, 0), _nbytes(t))
    return out


def trace_step(cfg: ModelConfig, shape, mesh, opt_cfg: "OptConfig | None" = None) -> dict:
    """→ the traced part of a record: ``memory``, ``cost``,
    ``collectives``, ``ops``, ``trace_s`` (and ``first_step`` for decode),
    for rank 0 of ``mesh`` (a mesh over a fake world)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    shape = _shape(shape)
    t0 = time.perf_counter()
    with FakeTensorMode():
        low = build_lowerable(cfg, shape, mesh, opt_cfg)
        arg_storages = _storages(low.args)
        tracer = _Tracer(mesh.device)
        for t in _tensors(low.args):
            tracer.track(t)
        runs, out = [], None
        with tracer:
            for step in low.steps:
                tracer.flops, tracer.ops = 0, Counter()
                with C.STATS.recording() as calls:
                    out = step()
                runs.append({"cost": {"flops": float(tracer.flops)},
                             "collectives": collective_stats(calls), "ops": tracer.names()})
        peak = tracer.peak
    outputs = _storages(out)
    out_bytes = sum(outputs.values())
    alias = sum(n for k, n in outputs.items() if k in arg_storages)
    arguments = argument_bytes(cfg, shape, mesh, opt_cfg)
    rec = {"trace_s": round(time.perf_counter() - t0, 2),
           "memory": {"argument_size_in_bytes": arguments,
                      "output_size_in_bytes": out_bytes,
                      "alias_size_in_bytes": alias,
                      "temp_size_in_bytes": int(peak) - sum(arg_storages.values()),
                      "peak_size_in_bytes": int(peak)},
           "cost": runs[-1]["cost"], "collectives": runs[-1]["collectives"],
           "ops": runs[-1]["ops"]}
    if len(runs) > 1:
        rec["first_step"] = {"cost": runs[0]["cost"], "collectives": runs[0]["collectives"]}
    return rec


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def cell_record(arch: str, shape, mesh, mesh_name: str) -> dict:
    """The untraced part of a cell's record: its names, ``status``
    (``skipped`` with the reference's reason, or ``ok`` pending the
    trace), the parameter counts, ``tokens``, ``kind`` and the argument
    bytes."""
    shape = _shape(shape)
    rec: dict = {"arch": arch, "shape": shape.name, "mesh": mesh_name, "n_devices": mesh.size}
    cfg = get_config(arch)
    ok, why = applicable(cfg, shape)
    if not ok:
        rec.update({"status": "skipped", "reason": why})
        return rec
    rec.update({"status": "ok", "params": cfg.n_params(), "active_params": cfg.active_params(),
                "tokens": shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1),
                "kind": shape.kind,
                "memory": {"argument_size_in_bytes": argument_bytes(cfg, shape, mesh)}})
    return rec


def run_cell(arch: str, shape, mesh, mesh_name: str, out_dir: str, force: bool = False) -> dict:
    """Trace one cell (or count it, for ``autotc``) and write its record
    to ``<out_dir>/<mesh_name>/<arch>__<shape>.json``; an existing record
    is read back unless ``force``."""
    shape_name = shape if isinstance(shape, str) else shape.name
    os.makedirs(os.path.join(out_dir, mesh_name), exist_ok=True)
    path = os.path.join(out_dir, mesh_name, f"{arch}__{shape_name}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    if arch == "autotc":
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "n_devices": mesh.size,
               **autotc_record(AUTOTC_SHAPES[shape_name], mesh)}
        _write(path, rec)
        return rec
    rec = cell_record(arch, shape, mesh, mesh_name)
    if rec["status"] == "ok":
        try:
            rec.update(trace_step(get_config(arch), shape, mesh))
        except Exception as e:  # noqa: BLE001 — the record carries it
            rec = {k: v for k, v in rec.items() if k != "memory"}
            rec.update({"status": "error", "error": repr(e),
                        "traceback": traceback.format_exc()[-4000:]})
    _write(path, rec)
    return rec


# ---------------------------------------------------------------------------
# The island-evolution cell, counted
# ---------------------------------------------------------------------------

def autotc_calls(n_islands: int, n_data: int, *, n_gates: int, n_out: int, n_cls: int,
                 lam: int) -> list:
    """The collectives one generation of `core.islands.evolve_islands`
    issues on each rank while every island is live, in its order: the
    world ``all_reduce`` of the live flag, the data ``all_reduce`` of the
    children's counts (2, λ, C), and the ring's exchange of one packed
    genome (gates, their two operands, the output taps and the fitness;
    none with one island)."""
    calls = [Call("all_reduce", torch.int32, (1,), n_islands * n_data),
             Call("all_reduce", torch.int32, (2, lam, n_cls), n_data)]
    if n_islands > 1:
        calls.append(Call("permute", torch.int32, (3 * n_gates + n_out + 1,), n_islands))
    return calls


def autotc_record(rows: int, mesh, params: "dict | None" = None) -> dict:
    """The ``autotc`` cell on ``mesh`` (module doc): islands on ``model``,
    the dataset's words over the fsdp axes, one generation counted.
    ``memory``: a rank's packed shard (x, y, class and mask words) and
    its two split masks; temp: the kernel's (λ, O, W) output words.
    ``cost.flops``: λ·gates·words 32-bit logic ops (every gate live, one
    op a word, as XLA's cost analysis counts an elementwise op);
    ``bytes accessed``: every input word read once, the outputs written."""
    p = {**AUTOTC, **(params or {})}
    axes = MeshAxes.for_mesh(mesh)
    n_isl, n_data = mesh.shape[axes.tp], mesh.axis_size(axes.fsdp)
    w = -(-(rows // 32) // n_data) * n_data
    w_loc = w // n_data
    words = 4 * w_loc
    data = (p["n_inputs"] + p["n_out"] + p["n_cls"] + 1) * words
    out = p["lam"] * p["n_out"] * words
    calls = autotc_calls(n_isl, n_data, n_gates=p["n_gates"], n_out=p["n_out"],
                         n_cls=p["n_cls"], lam=p["lam"])
    return {"status": "ok", "trace_s": 0.0, "kind": "evolve", "rows": rows,
            "islands": n_isl, "data_shards": n_data, "words_per_shard": w_loc,
            "counted": "one generation, from the program's shapes",
            "memory": {"argument_size_in_bytes": data + 2 * words, "output_size_in_bytes": 0,
                       "alias_size_in_bytes": 0, "temp_size_in_bytes": out},
            "cost": {"flops": float(p["lam"] * p["n_gates"] * w_loc),
                     "bytes accessed": float(data + 2 * words + out)},
            "collectives": collective_stats(calls)}


def _write(path: str, rec: dict):
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def _line(mesh_name: str, arch: str, shape: str, rec: dict, secs: float) -> str:
    status = rec.get("status")
    if status == "ok":
        mem = rec.get("memory", {})
        extra = (f"args/dev={mem.get('argument_size_in_bytes', 0) / 2**30:.2f}GiB "
                 f"tmp/dev={mem.get('temp_size_in_bytes', 0) / 2**30:.2f}GiB "
                 f"trace={rec.get('trace_s')}s")
    elif status == "error":
        extra = rec.get("error", "")[:200]
    else:
        extra = rec.get("reason", "")[:80]
    return f"[{mesh_name}] {arch} × {shape}: {status} {extra} ({secs:.0f}s)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="arch id, 'autotc', or omit with --all")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device (default: the card; 'cpu' without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    out_dir = args.out or os.path.abspath(OUT_DIR)
    names = [n for n, multi in MESHES.items()
             if args.mesh == "both" or (args.mesh == "multi") == multi]
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
        cells += [("autotc", "tab_small"), ("autotc", "tab_large")]
    else:
        if not args.arch:
            ap.error("--arch or --all required")
        shapes = [args.shape] if args.shape else (
            list(AUTOTC_SHAPES) if args.arch == "autotc" else list(SHAPES))
        cells = [(args.arch, s) for s in shapes]

    counts = Counter()
    for mesh_name in names:
        mesh = production_mesh(mesh_name, device)
        for arch, shape in cells:
            t0 = time.time()
            rec = run_cell(arch, shape, mesh, mesh_name, out_dir, args.force)
            counts[rec.get("status")] += 1
            print(_line(mesh_name, arch, shape, rec, time.time() - t0), flush=True)
    print(f"done: ok={counts['ok']} skipped={counts['skipped']} error={counts['error']}")
    return 1 if counts["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
