"""The port's dry run (`launch/dryrun.py`, `utils/collective_stats.py`)
against the reference's and against real runs of the same program.

  * (a) ``test_collective_stats_equal_the_references``: the collectives
    the port issues on a fake 2 × 16 mesh (every kind, the five dtypes
    its collectives send, reduce-scatters over groups of 2 and 16),
    rendered as HLO lines for the reference's parser, give the
    reference's record, ``==``; a reduce-scatter counts its scattered
    result, as the reference's regex reads it;
  * (b) ``test_production_cells_equal_the_references``: for all ten
    archs × four shapes × both production meshes, the untraced record
    (``status``, ``reason``, ``params``, ``active_params``, ``tokens``,
    ``kind``, ``memory.argument_size_in_bytes``) equals the reference's,
    whose argument bytes are the sum of ``shard_shape`` bytes over the
    same state, parameters, cache and batch (``tree_shardings``, no
    compile, one 512-device subprocess); the reference's cache ``pos``,
    a 4-byte scalar the port holds on the host, is left out there;
  * (c) ``test_smoke_argument_bytes_equal_xlas``: at smoke size on 2 × 4,
    the argument bytes equal XLA's compiled
    ``memory_analysis().argument_size_in_bytes`` for train, prefill and
    decode of one arch of each block kind and an embeds frontend, but for
    two named buffers: decode's ``pos`` (XLA's 4-byte scalar; the port's
    is a host int), and an embeds frontend's ``embed`` table in prefill
    and decode, which ``jit`` drops from the executable's arguments
    because the step never reads it, while the port's model holds it;
  * (d) ``test_the_dry_run_predicts_the_real_run``: the same smoke cells
    traced on a fake 2 × 2 world and run for real on 2 × 2 gloo ranks of
    the CPU give equal collective calls and bytes per kind, equal FLOPs
    (`FlopCounterMode` around each real step on rank 0) and equal argument
    bytes, for train, prefill and both decode steps, hymba's included;
  * (e) ``test_autotc_counts_equal_a_real_island_run``: `autotc_record`'s
    collectives per generation equal those each generation of a real
    `evolve_islands` run issues on 2 islands × 2 shards (``dist`` wrapped
    in the ranks);
  * the CLI's records and lines, and `count_op`.

Every process of the file starts together in one module fixture.
"""
import json
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from repro.utils import hlo as ref_hlo
from repro_torch.launch import dryrun
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.utils.collective_stats import Call, collective_stats, count_op
from tests.conftest import SRC, run_multidevice
from tests.torch_dryrun_ranks import DTYPES, KINDS, SMOKE_ARCHS, island_problem, smoke

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
TIMEOUT_S = 300
# the buffers XLA's argument size and the port's differ by (module doc)
XLA_ONLY = {"decode_32k": 4}            # the cache's int32 pos

REF_CELLS = """
import json, jax, numpy as np
from repro.configs import ARCH_IDS, SHAPES, applicable, get_config, input_specs
from repro.launch.mesh import make_production_mesh
from repro.models import lm
from repro.sharding.params import batch_specs, param_specs, train_state_specs, tree_shardings
from repro.sharding.specs import MeshAxes
from repro.train.optimizer import OptConfig
from repro.train.train_step import train_state_shapes

def local_bytes(tree, shs):
    leaves = jax.tree.leaves(tree)
    sh = jax.tree.leaves(shs, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
    assert len(leaves) == len(sh)
    return sum(int(np.prod(s.shard_shape(tuple(l.shape)))) * np.dtype(l.dtype).itemsize
               for l, s in zip(leaves, sh))

out = {}
for mesh_name, multi in (("single_pod_16x16", False), ("multi_pod_2x16x16", True)):
    mesh = make_production_mesh(multi_pod=multi)
    axes = MeshAxes.for_mesh(mesh)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for name, shape in SHAPES.items():
            key = "|".join((mesh_name, arch, name))
            rec = {"arch": arch, "shape": name, "mesh": mesh_name, "n_devices": mesh.size}
            ok, why = applicable(cfg, shape)
            if not ok:
                out[key] = {**rec, "status": "skipped", "reason": why}
                continue
            specs = input_specs(cfg, shape)
            args = local_bytes(specs, tree_shardings(
                mesh, specs, {k: batch_specs(cfg, axes, shape.kind)[k] for k in specs}))
            if shape.kind == "train":
                opt = OptConfig(kind=cfg.optimizer)
                st = train_state_shapes(cfg, opt)
                args += local_bytes(st, tree_shardings(mesh, st,
                                                       train_state_specs(cfg, axes, opt.kind)))
            else:
                ps = lm.param_shapes(cfg)
                args += local_bytes(ps, tree_shardings(mesh, ps, param_specs(cfg, axes)))
                if shape.kind == "decode":
                    cache = jax.eval_shape(
                        lambda: lm.init_cache(cfg, shape.global_batch, shape.seq_len))
                    cache = {k: v for k, v in cache.items() if k != "pos"}
                    cs = lm.cache_specs(cfg, axes)
                    args += local_bytes(cache, tree_shardings(mesh, cache,
                                                              {k: cs[k] for k in cache}))
            out[key] = {**rec, "status": "ok", "params": cfg.n_params(),
                        "active_params": cfg.active_params(),
                        "tokens": shape.global_batch
                        * (shape.seq_len if shape.kind != "decode" else 1),
                        "kind": shape.kind, "memory": {"argument_size_in_bytes": args}}
print("RESULT " + json.dumps(out))
"""

REF_COMPILE = """
import json, jax
from jax.sharding import PartitionSpec as P
from repro.configs import SHAPES, get_config, input_specs
from repro.configs.shapes import smoke_shape
from repro.launch.mesh import make_host_mesh
from repro.models import lm
from repro.sharding.params import batch_specs, param_specs, train_state_specs, tree_shardings
from repro.sharding.specs import MeshAxes, use_mesh_axes
from repro.train.optimizer import OptConfig
from repro.train.train_step import make_train_step, train_state_shapes
mesh = make_host_mesh(data=2, model=4)
axes = MeshAxes.for_mesh(mesh)
archs, kinds = %r
out = {}
for arch in archs:
    cfg = get_config(arch).smoke()
    for kind in kinds:
        shape = smoke_shape(SHAPES[kind])
        specs = input_specs(cfg, shape)
        bsh = tree_shardings(mesh, specs, {k: batch_specs(cfg, axes, shape.kind)[k]
                                           for k in specs})
        if shape.kind == "train":
            opt = OptConfig(kind=cfg.optimizer)
            st = train_state_shapes(cfg, opt)
            sh = tree_shardings(mesh, st, train_state_specs(cfg, axes, opt.kind))
            step = make_train_step(cfg, opt, microbatches=cfg.train_microbatches,
                                   grad_shardings=sh.params)
            fn = jax.jit(step, in_shardings=(sh, bsh), out_shardings=(sh, None),
                         donate_argnums=(0,))
            args = (st, specs)
        else:
            ps = lm.param_shapes(cfg)
            psh = tree_shardings(mesh, ps, param_specs(cfg, axes))
            if shape.kind == "prefill":
                fn = jax.jit(lambda p, b: lm.prefill(p, cfg, **b), in_shardings=(psh, bsh))
                args = (ps, specs)
            else:
                cache = jax.eval_shape(lambda: lm.init_cache(cfg, shape.global_batch,
                                                             shape.seq_len))
                csh = tree_shardings(mesh, cache, {**lm.cache_specs(cfg, axes), "pos": P()})
                fn = jax.jit(lambda p, c, b: lm.decode_step(p, cfg, c, **b),
                             in_shardings=(psh, csh, bsh), out_shardings=(None, csh),
                             donate_argnums=(1,))
                args = (ps, cache, specs)
        with mesh, use_mesh_axes(mesh):
            compiled = fn.lower(*args).compile()
        out[arch + "|" + kind] = int(compiled.memory_analysis().argument_size_in_bytes)
print("RESULT " + json.dumps(out))
"""


def _dry_side(tmp) -> dict:
    """`torch_dryrun_ranks.dry_side` in a process of its own (its fake
    worlds never touch this one)."""
    job, res = tmp / "dry_job.pkl", tmp / "dry_res.pkl"
    spec, _, _ = island_problem()
    job.write_bytes(pickle.dumps({"smoke_args": SMOKE_ARCHS, "n_out": spec.n_outputs}))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, TESTS_DIR]))
    r = subprocess.run([sys.executable, os.path.join(TESTS_DIR, "torch_dryrun_ranks.py"),
                        str(job), str(res)], env=env, capture_output=True, text=True,
                       timeout=TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-4000:]
    return pickle.loads(res.read_bytes())


def _cli(tmp) -> tuple:
    """`dryrun.main` in a process of its own: two cells of the single pod
    and an autotc cell, written under ``tmp``."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = []
    for arch, shape in (("hymba-1.5b", "long_500k"), ("minitron-8b", "long_500k"),
                        ("autotc", "tab_small")):
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                            "--shape", shape, "--mesh", "single", "--device", "cpu",
                            "--out", str(tmp / "records")],
                           env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
        out.append((r.returncode, r.stdout, r.stderr[-4000:]))
    return out


def _ranks_env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [TESTS_DIR] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    saved = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = _ranks_env()["PYTHONPATH"]
    try:
        with ThreadPoolExecutor(max_workers=6) as pool:
            futures = {
                "ref_compile": pool.submit(run_multidevice, REF_COMPILE % ((SMOKE_ARCHS, KINDS),),
                                           8, TIMEOUT_S),
                "ref_cells": pool.submit(run_multidevice, REF_CELLS, 512, TIMEOUT_S),
                "real": pool.submit(spawn_ranks, "torch_dryrun_ranks:real_rank", {}, 4,
                                    device="cpu", timeout_s=TIMEOUT_S),
                "dry": pool.submit(_dry_side, tmp),
                "cli": pool.submit(_cli, tmp),
            }
            out = {k: f.result() for k, f in futures.items()}
    finally:
        if saved is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = saved
    for k in ("ref_compile", "ref_cells"):
        out[k] = json.loads(out[k].split("RESULT ", 1)[1])
    out["tmp"] = tmp
    return out


_HLO_DTYPE = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float64: "f64",
              torch.int8: "s8", torch.int32: "s32", torch.float16: "f16"}


def _as_hlo(calls) -> str:
    """Each call as an optimized-HLO line whose result shape is the call's
    (an async all-reduce as a -start/-done pair, which the reference
    counts once)."""
    lines = []
    for i, c in enumerate(calls):
        op = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
              "all_reduce": "all-reduce", "all_reduce_max": "all-reduce",
              "permute": "collective-permute"}[c.kind]
        shape = f"{_HLO_DTYPE[c.dtype]}[{','.join(map(str, c.shape))}]"
        if op == "all-reduce" and i % 2:
            lines.append(f"  %s{i} = {shape}{{0}} all-reduce-start(%x{i}), to_apply=%add")
            lines.append(f"  %d{i} = {shape}{{0}} all-reduce-done(%s{i})")
        else:
            lines.append(f"  %c{i} = {shape}{{0}} {op}(%x{i}), replica_groups={{}}")
    return "\n".join(lines)


def test_collective_stats_equal_the_references(launched):
    calls = launched["dry"]["calls"]
    kinds = {c.kind for c in calls}
    assert kinds == {"all_gather", "all_reduce", "reduce_scatter", "all_reduce_max"}
    assert {c.dtype for c in calls} == set(DTYPES)
    # a reduce-scatter's result: its (32, n) input over the group of 2 or 16
    assert {(c.group_size, c.shape[0]) for c in calls if c.kind == "reduce_scatter"} == \
        {(2, 16), (16, 2)}
    extra = [Call("permute", torch.int32, (903,), 16), Call("permute", torch.float16, (7, 3), 2)]
    for listed in (calls, calls + extra):
        got = collective_stats(listed)
        want = ref_hlo.collective_stats(_as_hlo(listed))
        assert got == want, (got, want)
    assert collective_stats([]) == ref_hlo.collective_stats("") == {"weighted_bytes": 0.0}


@pytest.mark.parametrize("mesh_name", list(dryrun.MESHES))
def test_production_cells_equal_the_references(launched, mesh_name):
    ref = launched["ref_cells"]
    cells = {k: v for k, v in launched["dry"]["cells"].items() if k[0] == mesh_name}
    assert len(cells) == 40
    for (m, arch, shape), rec in cells.items():
        assert rec == ref["|".join((m, arch, shape))], (m, arch, shape)
    assert sum(r["status"] == "skipped" for r in cells.values()) == 8   # long_500k, attention archs


def test_smoke_argument_bytes_equal_xlas(launched):
    from repro_torch.configs import get_config

    for (arch, kind), port in launched["dry"]["smoke_args"].items():
        xla = launched["ref_compile"][f"{arch}|{kind}"]
        cfg = get_config(arch).smoke()
        named = XLA_ONLY.get(kind, 0)
        if cfg.frontend is not None and kind != "train_4k":
            # the embedding table the step never reads: its block on one of 8 ranks
            named -= cfg.vocab * cfg.d_model * cfg.torch_dtype.itemsize // 8
        assert xla == port + named, (arch, kind, xla, port)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_the_dry_run_predicts_the_real_run(launched, arch):
    real = launched["real"][0]["cells"]
    for kind in KINDS:
        got, want = launched["dry"]["traced"][(arch, kind)], real[(arch, kind)]
        steps = ([got["first_step"]] if got["first_step"] else []) + [got]
        assert len(steps) == len(want["steps"]) == (2 if kind == "decode_32k" else 1)
        for traced, ran in zip(steps, want["steps"]):
            assert traced["collectives"] == ran["collectives"], (kind, traced, ran)
            assert traced["cost"]["flops"] == ran["flops"] > 0, kind
        assert got["memory"]["argument_size_in_bytes"] == want["args"], kind
        assert got["memory"]["temp_size_in_bytes"] > 0
    # every rank of the real run issued the same traffic as rank 0
    for r in launched["real"][1:]:
        assert r["cells"][(arch, "train_4k")]["steps"][0]["collectives"] == \
            real[(arch, "train_4k")]["steps"][0]["collectives"]


def test_the_peak_is_the_mesh_devices(launched):
    """A trace that first builds the spec trees (their shapes on ``meta``)
    reads the same peak as one that finds them cached: the peak is the
    mesh device's, not the ``meta`` device's."""
    cold, warm = launched["dry"]["cold_warm_peaks"]
    assert cold == warm > 0
    # 12.1 GB (adam8bit's whole-row update of the straddling expert
    # leaves in float32), not the ~50 GB of the tree's float32 shapes
    assert warm < 25 * 2**30, warm


def test_decode_steps_reuse_the_kept_weights(launched):
    """The first decode step gathers the weights (all-gathers), the second
    reads the kept ones and gathers none but the split attention's."""
    for arch in SMOKE_ARCHS:
        got = launched["dry"]["traced"][(arch, "decode_32k")]
        first, steady = got["first_step"]["collectives"], got["collectives"]
        assert first["all-gather"]["bytes"] > steady.get("all-gather", {}).get("bytes", 0)


def test_autotc_counts_equal_a_real_island_run(launched):
    from tests.torch_dryrun_ranks import ISLAND

    counted = launched["dry"]["autotc"]
    for rank in launched["real"]:
        calls = rank["islands"]["calls"]
        # the class counts and the first parent's counts, then a
        # generation's three collectives each, then the last live flag
        gens = ISLAND["gens"]
        assert len(calls) == 2 + 3 * gens + 1
        per_gen = [calls[2 + 3 * g: 5 + 3 * g] for g in range(gens)]
        for g in per_gen:
            assert collective_stats(g) == counted["collectives"]
    assert counted["islands"] == 2 and counted["data_shards"] == 2
    assert counted["status"] == "ok" and counted["kind"] == "evolve"


def test_the_cli_writes_the_records(launched):
    lasts = []
    for rc, stdout, stderr in launched["cli"]:
        assert rc == 0, stderr
        lasts.append(stdout.strip().splitlines()[-1])
    assert lasts == ["done: ok=1 skipped=0 error=0", "done: ok=0 skipped=1 error=0",
                     "done: ok=1 skipped=0 error=0"]
    lines = [out for _, out, _ in launched["cli"]]
    assert "[single_pod_16x16] hymba-1.5b × long_500k: ok" in lines[0]
    assert "skipped pure full-attention arch" in lines[1]
    rec = json.loads((launched["tmp"] / "records" / "single_pod_16x16" /
                      "hymba-1.5b__long_500k.json").read_text())
    assert rec["status"] == "ok" and rec["kind"] == "decode" and rec["tokens"] == 1
    assert set(rec["memory"]) >= {"argument_size_in_bytes", "output_size_in_bytes",
                                  "alias_size_in_bytes", "temp_size_in_bytes"}
    assert rec["memory"]["alias_size_in_bytes"] > 0       # the cache, written in place
    assert rec["cost"]["flops"] > 0 and "first_step" in rec and rec["trace_s"] >= 0
    assert "lower_s" not in rec and "generated_code_size_in_bytes" not in rec["memory"]
    assert count_op(rec["ops"], "mm") > 0
    assert count_op(rec["ops"], "mm") == sum(v for k, v in rec["ops"].items()
                                             if k.startswith("aten.mm."))
    tc = json.loads((launched["tmp"] / "records" / "single_pod_16x16" /
                     "autotc__tab_small.json").read_text())
    assert tc["rows"] == 64 * 1024 and tc["islands"] == 16 and tc["data_shards"] == 16


def test_count_op_matches_names_and_overloads():
    ops = ["aten.mm.default", "aten.mm.out", "aten.addmm.default", "aten.bmm.default"]
    assert count_op(ops, "mm") == 2
    assert count_op(ops, "aten.mm.default") == 1
    assert count_op({"aten.mm.default": 3, "aten.bmm.default": 2}, "mm") == 3
    assert ref_hlo.count_op("dot(a) dot(b) fusion(c)", "dot") == 2


def test_the_cli_needs_a_device(monkeypatch):
    """Without ``--device cpu`` the dry run is the card's, and raises
    where there is none."""
    from repro_torch.device import NoCudaDeviceError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError):
        dryrun.main(["--arch", "autotc", "--mesh", "single"])
