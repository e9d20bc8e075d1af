"""The benchmark's CPU tests: the repository root and `src/` on the path."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# a tiny version of every cell, for runs on the CPU
SMALL = {"config": {"rows": 3000},
         "traffic": {"warmup_generations": 3, "check_generations": 6, "warmup_s": 0.3,
                     "rate_per_s": 40, "wait_after_s": 20}}

# the mixes that the tests run, by the cell that runs or would run each
MIXES = {"higgs.search": ("higgs", "search"), "higgs.serve": ("higgs", "serve_open")}
