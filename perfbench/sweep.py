"""The offered-load sweep of an open-loop serving cell, to find its knee.

    python3 perfbench/sweep.py --config higgs --traffic serve_open --rates 600 800 --seconds 20

runs the configuration under the open-loop mix once a rate, in one process,
and prints one JSON line a rate (run it once a rate, so that each rate starts
in a fresh process):
the 95th-percentile latency from the due time, the share of requests that
failed (rejected, shed or errored: each misses the deadline), and whether the
backlog grew (the median latency of the window's last quarter of requests
over its first quarter's).  The knee is the highest rate at and below which
fewer than 1 % of requests fail and the backlog does not grow; the mix
offers four fifths of it, written into it as ``rate_per_s``.
"""
import argparse
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "perfbench" / "cuda")
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    from perfbench import harness, readers

    import torch
    if not torch.cuda.is_available():
        print("the sweep runs on the card", file=sys.stderr)
        return 2
    for rate in args.rates:
        cell = harness.mix_cell(args.config, args.traffic, {"traffic": {"rate_per_s": rate}})
        t = time.perf_counter()
        run = harness.driver(cell).run(
            harness.Context(cell, args.seed, args.seconds, False, "cuda", t))
        lat = run.latencies_s
        q = max(1, len(lat) // 4)
        first, last = statistics.median(lat[:q]), statistics.median(lat[-q:])
        print(json.dumps({
            "rate_per_s": rate, "requests": run.attempted, "failed": run.failed,
            "failed_share": run.failed / max(run.attempted, 1),
            "p95_ms": readers.p95_ms(lat), "p50_ms": 1e3 * statistics.median(lat),
            "growth": (last / first) if first > 0 and not math.isinf(last) else None,
            "ticks": run.counters["ticks"], "rows": run.counters["rows"],
            "late_p50_ms": run.counters["late_p50_ms"], "late_max_ms": run.counters["late_max_ms"],
            "correct": run.correct, "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
