"""Readings of a cell's numbers compared, for the program and for the control.

    python3 perfbench/control.py --workload <name> --seeds 1 2 3 --seconds 3

runs the cell once a seed, in one process, with a short window at the cell's
own load, and prints one JSON line a seed: the numbers the program's run
compared (its lower readings) and the same numbers for the control, the
reference computed in the precision below the configuration's, put in the
program's place on the same sample (its upper readings).  The benchmark's
own runs never run the control.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "perfbench" / "cuda")
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    from perfbench import harness

    import torch
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        run = harness.driver(cell).run(
            harness.Context(cell, seed, args.seconds, False, "cuda", t))
        print(json.dumps({"workload": cell.name, "seed": seed, "attempted": run.attempted,
                          "program": run.checks, "control": run.control(),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
