"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the chips the cell asks for.
Without them it prints no result and exits non-zero.  See
`perfbench/README.md`.
"""
import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of a build or a compile at a fixed path in the checkout
    cache = ROOT / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

    from perfbench import harness
    cell = harness.load_cell(args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    ctx = harness.Context(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    run = harness.driver(cell).run(ctx)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules that the benchmark may not load are loaded: {bad}",
              file=sys.stderr)
        return 3
    line = harness.result_line(cell, run, bool(args.trace))
    if run.trace is not None and run.kernel:
        print(f"trace: {len(run.trace.durations_s(run.kernel))} launches of "
              f"{run.kernel} traced of {len(run.launch_bounds_s)} made, "
              f"{len(run.trace.ops)} device operations", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
