"""The PyTorch port stands alone: no JAX, nothing of the reference package."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

# `import jax`, `from jax…`, `import repro`, `from repro.…` — but never
# the port's own `repro_torch`
FORBIDDEN = re.compile(
    r"^\s*(?:import\s+jax\b|from\s+jax\b|import\s+repro(?:\.|\s|,|$)"
    r"|from\s+repro(?:\.|\s))",
    re.M,
)


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _sources() -> list[pathlib.Path]:
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_has_modules():
    mods = _port_modules()
    for want in ("repro_torch.kernels.circuit_eval", "repro_torch.core.api",
                 "repro_torch.serve.circuits.server", "repro_torch.data.tabular",
                 "repro_torch.core.evolve", "repro_torch.core.fitness",
                 "repro_torch.core.mutate", "repro_torch.core.netlist",
                 "repro_torch.core.verilog", "repro_torch.core.hardware",
                 "repro_torch.core.baselines.gbdt", "repro_torch.core.baselines.mlp",
                 "repro_torch.runtime.aot", "repro_torch.serve.artifacts",
                 "repro_torch.serve.artifacts.store",
                 "repro_torch.serve.async_frontend",
                 "repro_torch.serve.async_frontend.queue",
                 "repro_torch.serve.async_frontend.scheduler",
                 "repro_torch.serve.async_frontend.frontend",
                 "repro_torch.serve.autoscale",
                 "repro_torch.serve.autoscale.policy",
                 "repro_torch.serve.autoscale.controller",
                 "repro_torch.serve.evolution",
                 "repro_torch.serve.evolution.drift",
                 "repro_torch.serve.evolution.refit",
                 "repro_torch.serve.evolution.promote",
                 "repro_torch.serve.evolution.manager",
                 "repro_torch.serve.evolution.refit_process",
                 "repro_torch.serve.fleet", "repro_torch.serve.fleet.plan",
                 "repro_torch.serve.fleet.workload", "repro_torch.serve.fleet.cadence",
                 "repro_torch.serve.fleet.transport", "repro_torch.serve.fleet.artifact",
                 "repro_torch.serve.fleet.host", "repro_torch.serve.fleet.router",
                 "repro_torch.serve.observability.export",
                 "repro_torch.core.islands", "repro_torch.launch.islands",
                 "repro_torch.launch.serve", "repro_torch.models.common",
                 "repro_torch.models.layers", "repro_torch.models.rope",
                 "repro_torch.models.attention", "repro_torch.models.blocks",
                 "repro_torch.models.lm", "repro_torch.models.convert",
                 "repro_torch.configs", "repro_torch.configs.shapes",
                 "repro_torch.configs.minitron_8b", "repro_torch.serve.engine",
                 "repro_torch.train", "repro_torch.train.optimizer",
                 "repro_torch.train.train_step", "repro_torch.train.checkpoint",
                 "repro_torch.train.fault_tolerance", "repro_torch.train.grad_compress",
                 "repro_torch.data.pipeline", "repro_torch.launch.train",
                 "repro_torch.configs.tiny_classifier", "repro_torch.sharding",
                 "repro_torch.sharding.specs", "repro_torch.sharding.params",
                 "repro_torch.sharding.collectives", "repro_torch.launch.mesh",
                 "repro_torch.launch.ranks", "repro_torch.launch.dryrun",
                 "repro_torch.utils", "repro_torch.utils.collective_stats"):
        assert want in mods
    assert (PORT / "csrc" / "circuit_eval.cu").is_file()


def test_every_module_imports_with_jax_and_repro_blocked():
    script = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]\n"
        f"for m in {_port_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and"
        " (m in ('jax', 'repro') or m.startswith(('jax.', 'repro.')))]\n"
        "assert not bad, bad\n"
        "print('imported', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120, env=env, cwd=str(REPO))
    assert r.returncode == 0, r.stderr
    assert "imported" in r.stdout


def test_async_and_autoscale_entry_points_import_with_jax_and_repro_blocked():
    script = (
        "import inspect, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path[:0] = [{str(REPO / 'src')!r}]\n"
        "from repro_torch.core.api import ServableCircuit\n"
        "from repro_torch.serve.circuits import FrontendStats\n"
        "from repro_torch.serve.async_frontend import AsyncCircuitServer, DeadlineScheduler\n"
        "from repro_torch.serve.autoscale import AutoscaleController, HysteresisPolicy\n"
        "params = inspect.signature(ServableCircuit.serve_async).parameters\n"
        "assert 'device' in params and 'backend' not in params, list(params)\n"
        "assert callable(AsyncCircuitServer.queue_rows) and callable(FrontendStats.snapshot)\n"
        "print('entry points ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120, env=env, cwd=str(REPO))
    assert r.returncode == 0, r.stderr
    assert "entry points ok" in r.stdout


def test_evolution_and_export_entry_points_import_with_jax_and_repro_blocked():
    script = (
        "import dataclasses, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path[:0] = [{str(REPO / 'src')!r}]\n"
        "from repro_torch.serve.evolution import (DriftDetector, EvolutionManager,\n"
        "    RefitConfig, refit_circuit)\n"
        "from repro_torch.serve.observability import TraceRecorder, prometheus_text\n"
        "fields = {f.name for f in dataclasses.fields(RefitConfig)}\n"
        "assert 'device' in fields and 'backend' not in fields, fields\n"
        "assert RefitConfig().device is None\n"
        "assert callable(TraceRecorder.export_chrome) and callable(TraceRecorder.export_jsonl)\n"
        "assert prometheus_text() == ''\n"
        "print('evolution ok', EvolutionManager.__name__, DriftDetector.__name__,\n"
        "      refit_circuit.__name__)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120, env=env, cwd=str(REPO))
    assert r.returncode == 0, r.stderr
    assert "evolution ok" in r.stdout


def test_fleet_and_refit_child_entry_points_import_with_jax_and_repro_blocked():
    """The fleet, and what the two child interpreters run (the refit
    process's boot and job loop, the subprocess host's script), import
    neither JAX nor the reference; the host takes ``device``."""
    script = (
        "import inspect, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path[:0] = [{str(REPO / 'src')!r}]\n"
        "from repro_torch.serve import fleet\n"
        "from repro_torch.serve.evolution import refit_process\n"
        "from repro_torch.serve.fleet import transport\n"
        "refit_process._boot('cpu')\n"
        "from repro_torch.serve.evolution.refit import refit_circuit\n"
        "head = transport._HOST_MAIN.split('cfg = ')[0]\n"
        "exec(head)\n"
        "for fn in (fleet.ServingHost, fleet.ServingHost.boot_from_artifact,\n"
        "           fleet.spawn_host_process):\n"
        "    params = inspect.signature(fn).parameters\n"
        "    assert 'device' in params and 'backend' not in params, (fn, list(params))\n"
        "assert set(fleet.__all__) >= {'FleetRouter', 'ServingHost', 'spawn_host_process'}\n"
        "print('fleet ok', len(fleet.__all__))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120, env=env, cwd=str(REPO))
    assert r.returncode == 0, r.stderr
    assert "fleet ok 22" in r.stdout


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_reference_imports_in_source(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: {hits}"


@pytest.mark.parametrize("line,forbidden", [
    ("import jax", True),
    ("import jax.numpy as jnp", True),
    ("from jax import lax", True),
    ("import repro", True),
    ("from repro.core import gates", True),
    ("    from repro.serve import x", True),
    ("import repro_torch", False),
    ("from repro_torch.core import gates", False),
    ("import jaxlib_like_name_is_not_jax", False),
])
def test_forbidden_pattern_is_sharp(line, forbidden):
    assert bool(FORBIDDEN.search(line)) is forbidden


def test_the_mesh_path_runs_with_jax_and_repro_blocked():
    """`launch/mesh.py` and `sharding/` build the production mesh's layout
    under the ``fake`` backend, and the rank programs of the mesh tests
    import, with no JAX and nothing of the reference."""
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]\n"
        "import torch.distributed as dist\n"
        "from torch.testing._internal.distributed.fake_pg import FakeStore\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.launch.mesh import make_production_mesh\n"
        "from repro_torch.sharding.params import param_shardings\n"
        "import tests.torch_mesh_ranks\n"
        "dist.init_process_group('fake', store=FakeStore(), rank=0, world_size=256)\n"
        "mesh = make_production_mesh(device='cpu')\n"
        "sh = param_shardings(get_config('minitron-8b'), mesh)['blocks']['wq']\n"
        "assert sh.spec == (None, ('data',), ('model',)), sh.spec\n"
        "print('mesh ok', sh.local_shape)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=120, env=env, cwd=str(REPO))
    assert r.returncode == 0, r.stderr
    assert "mesh ok" in r.stdout
