"""Nothing the benchmark runs loads JAX or the JAX package: every module under
`perfbench/`, and a run of each cell on the CPU, with them blocked, compared
by whole top-level names."""
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

BLOCK = textwrap.dedent("""
    import importlib.abc, sys
    BLOCKED = ("jax", "jaxlib", "flax", "repro")
    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)
    sys.meta_path.insert(0, Block())
    sys.path[0:0] = [{root!r}, {src!r}]
""").format(root=str(ROOT), src=str(ROOT / "src"))


def python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", BLOCK + textwrap.dedent(code)],
                          capture_output=True, text=True, timeout=600, cwd=ROOT)


def test_every_module_imports_with_jax_and_repro_blocked():
    p = python("""
        import importlib, pkgutil, perfbench
        from perfbench import harness
        names = [m.name for m in pkgutil.walk_packages(perfbench.__path__, "perfbench.")
                 if ".tests" not in m.name]
        for n in names:
            importlib.import_module(n)
        run = harness.Run()
        for f in sorted((harness.HERE / "metrics").glob("*.py")):
            harness.read_metric(f.stem, run)
        assert harness.forbidden_modules() == [], harness.forbidden_modules()
        print(len(names))
    """)
    assert p.returncode == 0, p.stderr[-3000:]
    assert int(p.stdout.split()[-1]) >= 12


def test_a_run_of_every_cell_loads_neither():
    p = python("""
        import time
        from perfbench import harness
        from perfbench.tests.conftest import MIXES, SMALL
        for w in MIXES:
            cell = harness.mix_cell(*MIXES[w], SMALL)
            run = harness.driver(cell).run(
                harness.Context(cell, 7, 0.5, False, "cpu", time.perf_counter()))
            assert run.correct, (w, run.checks)
        assert harness.forbidden_modules() == [], harness.forbidden_modules()
        import repro_torch
        print("ok")
    """)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.split()[-1] == "ok"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from perfbench import harness
    for name in ("repro_torch.core", "reprox", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert not [m for m in harness.forbidden_modules()
                if m in ("repro_torch.core", "reprox", "jaxtyping", "flaxen")]
    monkeypatch.setitem(sys.modules, "repro.core", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    found = harness.forbidden_modules()
    assert "repro.core" in found and "jax" in found


def test_no_source_reads_the_old_benchmarks():
    for f in (ROOT / "perfbench").rglob("*.py"):
        if "tests" in f.parts:
            continue
        text = f.read_text()
        assert "benchmarks" not in text and "BENCH_" not in text, f


def test_no_source_tunes_the_process_under_test():
    """The program is timed as it ships: nothing of the benchmark changes
    torch's thread pools, the garbage collector or the OpenMP settings of
    the process that it times."""
    tuning = ("set_num_threads", "set_num_interop_threads", "gc.freeze", "gc.disable",
              "OMP_NUM_THREADS", "OMP_WAIT_POLICY", "MKL_NUM_THREADS")
    for f in (ROOT / "perfbench").rglob("*.py"):
        if "tests" in f.parts:
            continue
        text = f.read_text()
        assert not [t for t in tuning if t in text], f
