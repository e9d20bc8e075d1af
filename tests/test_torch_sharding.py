"""The port's sharding metadata against the reference's, in one process
per side (`sharding/`, `launch/mesh.py`, `models.lm.cache_specs`).

For all ten archs, on the 16 × 16 and 2 × 16 × 16 production meshes and
the 2 × 4 host mesh, every fitted spec equals the reference's
``tree_shardings(...)`` PartitionSpec entry for entry (an entry is a
tuple of axis names or None): parameters, the train state under
``adamw`` and ``adam8bit`` (moments, Q8 words and scales, the steps),
batches (train, prefill, decode) and decode caches.  The reference's
meshes are 512 fake host devices (`run_multidevice`); the port's are
``init_device_mesh`` under the ``fake`` backend, which needs no process
per rank.  Both sides run in subprocesses, started together.

Beside them: the port's own layout arithmetic (blocks, replicas), the
serving device pick behind `population_mesh`, and the mesh entry points'
card default.
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from repro_torch.device import NoCudaDeviceError
from repro_torch.launch import mesh as M
from repro_torch.sharding import specs
from tests.conftest import SRC, run_multidevice

# the batch and cache shapes of the comparison: B = 48 splits over 16
# data ranks but not over pod × data = 32, so the fit drops it there
B, S, MAX_LEN = 48, 128, 256

REFERENCE = """
import json, jax, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import ARCH_IDS, get_config
from repro.launch.mesh import make_host_mesh, make_production_mesh
from repro.models import lm
from repro.sharding.params import (batch_specs, param_specs, train_state_specs,
                                   tree_shardings)
from repro.sharding.specs import MeshAxes
from repro.train.checkpoint import _flatten
from repro.train.optimizer import OptConfig
from repro.train.train_step import train_state_shapes
B, S, MAX_LEN = %d, %d, %d
meshes = {"16x16": make_production_mesh(), "2x16x16": make_production_mesh(multi_pod=True),
          "2x4": make_host_mesh(data=2, model=4)}

def entries(spec, n):
    out = []
    for e in tuple(spec) + (None,) * (n - len(spec)):
        out.append(None if e is None else [e] if isinstance(e, str) else list(e))
    return out

def dump(mesh, shapes, specs):
    sh = tree_shardings(mesh, shapes, specs)
    flat_sh, flat_x = _flatten(sh), _flatten(shapes)
    return {k: entries(v.spec, len(flat_x[k].shape)) for k, v in flat_sh.items()}

def batches(cfg, kind):
    out = {}
    if kind in ("train", "prefill"):
        if cfg.frontend is not None:
            out["embeds"] = (B, S, cfg.d_model)
        else:
            out["tokens"] = (B, S)
        if kind == "train":
            out["labels"] = (B, S)
        if cfg.rope_kind == "mrope":
            out["positions"] = (B, S, 3)
    else:
        out["embed" if cfg.frontend is not None else "token"] = (B, 1) + (
            (cfg.d_model,) if cfg.frontend is not None else ())
    return {k: jax.ShapeDtypeStruct(v, np.int32) for k, v in out.items()}

res = {}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    states = {k: train_state_shapes(cfg, OptConfig(kind=k)) for k in ("adamw", "adam8bit")}
    params = lm.param_shapes(cfg)
    cache = jax.eval_shape(lambda: lm.init_cache(cfg, B, MAX_LEN))
    for name, mesh in meshes.items():
        axes = MeshAxes.for_mesh(mesh)
        r = {"params": dump(mesh, params, param_specs(cfg, axes))}
        for k, st in states.items():
            r["state_" + k] = dump(mesh, st, train_state_specs(cfg, axes, k))
        for kind in ("train", "prefill", "decode"):
            shapes = batches(cfg, kind)
            r["batch_" + kind] = dump(mesh, shapes, {k: batch_specs(cfg, axes, kind)[k]
                                                     for k in shapes})
        r["cache"] = dump(mesh, cache, {**lm.cache_specs(cfg, axes), "pos": P()})
        res[arch + "@" + name] = r
print("RESULT " + json.dumps(res))
""" % (B, S, MAX_LEN)

PORT = """
import json, sys
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.models.convert import param_shapes
from repro_torch.sharding.params import (batch_specs, param_specs, train_state_specs,
                                         tree_shardings)
from repro_torch.sharding.specs import MeshAxes
from repro_torch.train.checkpoint import _flatten
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import train_state_shapes
B, S, MAX_LEN = %d, %d, %d

def meta(node):
    if isinstance(node, dict):
        return {k: meta(v) for k, v in node.items()}
    return torch.empty(node, device="meta")

def dump(mesh, shapes, specs):
    flat = _flatten(tree_shardings(mesh, shapes, specs))
    return {k: [None if e is None else list(e) for e in v.spec] for k, v in flat.items()}

def batches(cfg, kind):
    out = {}
    if kind in ("train", "prefill"):
        if cfg.frontend is not None:
            out["embeds"] = (B, S, cfg.d_model)
        else:
            out["tokens"] = (B, S)
        if kind == "train":
            out["labels"] = (B, S)
        if cfg.rope_kind == "mrope":
            out["positions"] = (B, S, 3)
    else:
        out["embed" if cfg.frontend is not None else "token"] = (B, 1) + (
            (cfg.d_model,) if cfg.frontend is not None else ())
    return {k: torch.empty(v, device="meta") for k, v in out.items()}

res, checks = {}, {}
for name, world in (("16x16", 256), ("2x16x16", 512), ("2x4", 8)):
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    if name == "2x4":
        mesh = make_host_mesh(data=2, model=4, device="cpu")
    else:
        mesh = make_production_mesh(multi_pod=name == "2x16x16", device="cpu")
    checks[name] = {"shape": mesh.shape, "coords": mesh.coords}
    axes = MeshAxes.for_mesh(mesh)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        r = {"params": dump(mesh, meta(param_shapes(cfg)), param_specs(cfg, axes))}
        for k in ("adamw", "adam8bit"):
            r["state_" + k] = dump(mesh, train_state_shapes(cfg, OptConfig(kind=k)),
                                   train_state_specs(cfg, axes, k))
        for kind in ("train", "prefill", "decode"):
            shapes = batches(cfg, kind)
            r["batch_" + kind] = dump(mesh, shapes, {k: batch_specs(cfg, axes, kind)[k]
                                                     for k in shapes})
        r["cache"] = dump(mesh, lm.cache_shapes(cfg, B, MAX_LEN), lm.cache_specs(cfg, axes))
        res[arch + "@" + name] = r
    try:
        make_host_mesh(data=2, model=2, device="cpu")
        checks[name]["wrong_world"] = "accepted"
    except ValueError as e:
        checks[name]["wrong_world"] = str(e)
    dist.destroy_process_group()
print("RESULT " + json.dumps({"specs": res, "checks": checks}))
""" % (B, S, MAX_LEN)


def _port_run(script: str) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, r.stderr
    return r.stdout


@pytest.fixture(scope="module")
def dumped():
    with ThreadPoolExecutor(max_workers=2) as pool:
        ref = pool.submit(run_multidevice, REFERENCE, 512, 300)
        port = pool.submit(_port_run, PORT)
        ref_out = json.loads(ref.result().split("RESULT ", 1)[1])
        port_out = json.loads(port.result().split("RESULT ", 1)[1])
    return ref_out, port_out


MESHES = ("16x16", "2x16x16", "2x4")
TREES = ("params", "state_adamw", "state_adam8bit", "batch_train", "batch_prefill",
         "batch_decode", "cache")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("tree", TREES)
def test_fitted_specs_are_the_references_for_every_arch(dumped, mesh, tree):
    ref, port = dumped
    cases = [k for k in ref if k.endswith("@" + mesh)]
    assert len(cases) == 10
    for case in cases:
        want, got = ref[case][tree], port["specs"][case][tree]
        assert list(got) == list(want), (case, tree)
        for k in want:
            assert got[k] == want[k], (case, tree, k, got[k], want[k])


def test_the_fits_drop_what_does_not_divide(dumped):
    """granite-moe's vocab of 49,155 loses its tp axis everywhere; the batch
    keeps fsdp on 16 data ranks and loses it on 32 (the reference's
    rule, and the comparison sees both branches); B = 48."""
    _, port = dumped
    specs_ = port["specs"]
    for mesh in MESHES:
        embed = specs_["granite-moe-1b-a400m@" + mesh]["params"]["embed"]
        assert embed[0] is None
    assert specs_["minitron-8b@16x16"]["batch_train"]["tokens"][0] == ["data"]
    assert specs_["minitron-8b@2x16x16"]["batch_train"]["tokens"][0] is None


def test_the_production_meshes_are_built_under_the_fake_backend(dumped):
    _, port = dumped
    checks = port["checks"]
    assert checks["16x16"]["shape"] == {"data": 16, "model": 16}
    assert checks["2x16x16"]["shape"] == {"pod": 2, "data": 16, "model": 16}
    assert checks["2x4"]["shape"] == {"data": 2, "model": 4}
    for c in checks.values():
        assert set(c["coords"].values()) == {0}
        assert "needs 4 ranks" in c["wrong_world"]


class _FakeMesh(specs.Mesh):
    """A mesh's layout alone (no process group): the arithmetic of
    blocks and replicas."""

    def __init__(self, shape: dict, coords: dict):
        self.axis_names = tuple(shape)
        self.shape, self.coords = dict(shape), dict(coords)
        self.size = 1
        for n in shape.values():
            self.size *= n
        self.device = torch.device("cpu")


def test_blocks_replicas_and_row_major_indices():
    from repro_torch.sharding.params import Sharding, fit

    mesh = _FakeMesh({"pod": 2, "data": 3, "model": 4}, {"pod": 1, "data": 2, "model": 3})
    assert mesh.index(("pod", "data")) == 1 * 3 + 2
    spec = fit(mesh, (("pod", "data"), "model", None), (12, 8, 5))
    assert spec == (("pod", "data"), ("model",), None)
    sh = Sharding(mesh, spec, (12, 8, 5))
    assert sh.local_shape == (2, 2, 5)
    assert sh.block() == (slice(10, 12), slice(6, 8), slice(0, 5))
    assert sh.replica_axes() == () and sh.is_first_replica()
    # the vocab dim loses its axis: the block is replicated over model
    rep = Sharding(mesh, fit(mesh, ("model", ("pod", "data")), (49155, 12)), (49155, 12))
    assert rep.spec == (None, ("pod", "data"))
    assert rep.replica_axes() == ("model",) and not rep.is_first_replica()
    x = torch.arange(12 * 8 * 5).reshape(12, 8, 5)
    torch.testing.assert_close(specs.local_block(x, mesh, spec), x[sh.block()])
    # a spec that does not divide leaves the tensor whole
    assert specs.maybe_constrain(x, mesh, (None, None, "model")) is x


def test_population_mesh_is_the_servers_pick(monkeypatch):
    from repro_torch.serve.circuits.server import CircuitServer

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    card = torch.device("cuda")
    for shard in range(7):
        want = torch.device("cuda", shard % 3)
        devs = specs.population_mesh(shard + 1, card)
        assert devs[shard % len(devs)] == want
    assert specs.population_mesh(8, torch.device("cpu")) == [torch.device("cpu")]
    assert specs.population_mesh(8, torch.device("cuda", 1)) == [torch.device("cuda", 1)]
    server = CircuitServer.__new__(CircuitServer)
    server.device = card
    assert [server.device_for(s) for s in range(5)] == [torch.device("cuda", s % 3)
                                                        for s in range(5)]


def test_the_mesh_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError):
        M.make_host_mesh(data=2, model=2)
    with pytest.raises(NoCudaDeviceError):
        M.make_production_mesh()
