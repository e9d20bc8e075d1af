"""The run command on a machine without a card, and in a directory that holds
only the benchmark, prints no result and exits non-zero."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "higgs.search", "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"]


def run(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def no_result(out: str) -> bool:
    for line in out.splitlines():
        try:
            if "metrics" in json.loads(line):
                return False
        except ValueError:
            pass
    return True


def test_without_a_card_it_exits_non_zero_and_prints_no_metric():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = run(ROOT)
    assert p.returncode != 0 and no_result(p.stdout)
    assert "CUDA device" in p.stderr


def test_with_only_the_benchmark_it_exits_non_zero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run(tmp_path)
    assert p.returncode != 0 and no_result(p.stdout)
