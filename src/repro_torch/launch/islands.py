"""Island-parallel evolution launcher: K islands × D data shards as K·D
processes on one host (the counterpart of `examples/evolve_distributed.py`).

    PYTHONPATH=src python -m repro_torch.launch.islands --islands 4 --data 2 \
        --dataset phoneme

runs `core.islands.evolve_islands` on the card (``--device cpu`` for the
plain versions), prints every island's fitness and the best island's
balanced accuracy on held-out rows.

`spawn_ranks` is the machinery: it builds the kernel library in this
process first (the ranks load it and never build it), writes the job to a
temporary directory, and starts ``world_size`` fresh interpreters
(`subprocess`, never a fork after CUDA is initialised) with ``PYTHONPATH``
set to this checkout's ``src``.  Each rank joins one gloo group through a
`FileStore` in that directory (no TCP port, so concurrent launches never
collide), runs the job's target, writes its result and exits.  A rank that
exits non-zero, or a run that outlasts ``timeout_s``, fails the launch
with that rank's stderr tail; the other ranks are killed.  Nothing falls
back to running in this process.

Launch counts are per process: each rank reports its own
(`circuit_eval.KERNELS`), with its evaluations, so a caller can hold the
two to each other.
"""
from __future__ import annotations

import argparse
import datetime
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import encoding as E
from repro_torch.core import fitness as F
from repro_torch.core.encoding import PackedDataset
from repro_torch.core.evolve import EvolveConfig, EvolveState
from repro_torch.core.gates import FULL_FS
from repro_torch.core.genome import CircuitSpec, opcodes
from repro_torch.core.islands import (
    IslandConfig, IslandEval, best_island, evolve_islands, pad_words_for, sharded_eval_fn)
from repro_torch.data import load_dataset, train_test_split
from repro_torch.device import resolve_device
from repro_torch.kernels import circuit_eval, ops
from repro_torch.kernels.program import compile_program

# the directory holding the ``repro_torch`` package
SRC_DIR = Path(__file__).resolve().parents[2]
_CHILD_MAIN = (
    "import sys; from repro_torch.launch.islands import rank_main; "
    "sys.exit(rank_main(sys.argv[1:]))"
)
STDERR_TAIL = 4000  # bytes of a failed rank's stderr in the error


class IslandLaunchError(RuntimeError):
    """A rank failed to start, failed, or the launch timed out."""


class IslandLaunch(NamedTuple):
    states: list[EvolveState]  # every island's final state, in island order
    ranks: list[dict]          # per rank: launches, evaluations, timings, boot_s


def _tail(path: Path) -> str:
    try:
        return path.read_bytes()[-STDERR_TAIL:].decode(errors="replace")
    except OSError:
        return ""


def spawn_ranks(target: str, payload, world_size: int, *,
                device: "str | torch.device | None" = None,
                timeout_s: float = 600.0) -> list:
    """Run ``target`` (``"module:function"``, called as ``fn(payload,
    device)`` inside an initialised gloo group) in ``world_size`` fresh
    processes; returns each rank's result, in rank order (module doc)."""
    device = resolve_device(device)
    if device.type == "cuda":
        circuit_eval.build_library()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC_DIR)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    with tempfile.TemporaryDirectory(prefix="islands-") as tmp:
        run = Path(tmp)
        (run / "job.pkl").write_bytes(pickle.dumps(
            {"target": target, "payload": payload, "timeout_s": timeout_s},
            protocol=pickle.HIGHEST_PROTOCOL))
        procs, errs = [], []
        try:
            for rank in range(world_size):
                err = open(run / f"rank{rank}.err", "wb")
                errs.append(err)
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _CHILD_MAIN, tmp, str(rank), str(world_size),
                     str(device), repr(time.time())],
                    env=env, stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
                    stderr=err))
            _wait(procs, run, timeout_s)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
            for err in errs:
                err.close()
        return [pickle.loads((run / f"rank{r}.pkl").read_bytes()) for r in range(world_size)]


def _wait(procs: list, run: Path, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    while True:
        codes = [p.poll() for p in procs]
        bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
        if bad:
            r = bad[0]
            raise IslandLaunchError(
                f"rank {r} of {len(procs)} exited with code {codes[r]}:\n"
                f"{_tail(run / f'rank{r}.err')}")
        if all(c == 0 for c in codes):
            return
        if time.monotonic() > deadline:
            silent = [r for r, c in enumerate(codes) if c is None]
            tails = "\n".join(f"-- rank {r} --\n{_tail(run / f'rank{r}.err')}" for r in silent)
            raise IslandLaunchError(
                f"ranks {silent} of {len(procs)} did not finish within {timeout_s} s:\n{tails}")
        time.sleep(0.05)


def rank_main(argv: "list[str]") -> int:
    """One rank: ``argv`` is (run directory, rank, world size, device, the
    parent's spawn time)."""
    run, rank, world = Path(argv[0]), int(argv[1]), int(argv[2])
    try:
        torch.set_num_threads(1)
        job = pickle.loads((run / "job.pkl").read_bytes())
        device = resolve_device(argv[3])
        if device.type == "cuda":
            torch.zeros(1, device=device)  # the CUDA context, now
            if not circuit_eval.library_path().exists():
                raise IslandLaunchError(
                    f"the kernel library {circuit_eval.library_path()} is not built; "
                    "a rank loads the one its launcher built")
            circuit_eval.load_library()
        dist.init_process_group(
            "gloo", init_method=f"file://{run / 'store'}", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=job["timeout_s"]))
        boot_s = time.time() - float(argv[4])
        module, name = job["target"].split(":")
        result = getattr(importlib.import_module(module), name)(job["payload"], device)
        result["boot_s"] = boot_s
        tmp = run / f"rank{rank}.pkl.tmp"
        tmp.write_bytes(pickle.dumps(result, protocol=pickle.HIGHEST_PROTOCOL))
        tmp.rename(run / f"rank{rank}.pkl")
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — report on stderr, then exit non-zero
        traceback.print_exc()
        return 1
    return 0


def _launch_counts() -> dict:
    return {k.name: k.launches for k in circuit_eval.KERNELS}


def island_rank(payload: dict, device: torch.device) -> dict:
    """A rank's part of `launch_islands`: `evolve_islands` on its shard."""
    data = PackedDataset(*(torch.from_numpy(a) for a in payload["data"]))
    mtr, mva = (torch.from_numpy(a) for a in payload["masks"])
    before = _launch_counts()
    timings: dict = {}
    t0 = time.perf_counter()
    states = evolve_islands(payload["seed"], payload["spec"], payload["cfg"], payload["icfg"],
                            data, mtr, mva, device=device, timings=timings)
    timings["evolve_s"] = time.perf_counter() - t0
    after = _launch_counts()
    rank = dist.get_rank()
    return {"rank": rank, "island": rank // payload["icfg"].n_data,
            "shard": rank % payload["icfg"].n_data,
            "states": states if rank == 0 else None, "timings": timings,
            "launches": {k: after[k] - before[k] for k in after}}


def fitness_rank(payload: dict, device: torch.device) -> dict:
    """Every problem's genomes evaluated on this rank's shard of the
    world's ``world_size`` shards, the counts summed over the world, and
    on the whole data in this process alone: ``{"sharded": [(train, val)],
    "whole": [(train, val)]}`` per problem, float32 on the host."""
    rank, world = dist.get_rank(), dist.get_world_size()
    out: dict = {"sharded": [], "whole": []}
    for prob in payload["problems"]:
        data = PackedDataset(*(torch.from_numpy(a) for a in prob["data"]))
        mtr, mva = (torch.from_numpy(a) for a in prob["masks"])
        genomes = prob["genomes"]
        sharded = sharded_eval_fn(prob["spec"], data, mtr, mva, rank, world, None, device)
        out["sharded"].append(sharded(genomes))
        whole = IslandEval(prob["spec"], *(PackedDataset(*(a.to(device) for a in data)),
                                             mtr.to(device), mva.to(device)))
        out["whole"].append(whole(genomes))
    out["launches"] = _launch_counts()
    return out


def _host(a: torch.Tensor) -> np.ndarray:
    return a.cpu().numpy()


def launch_islands(
    seed: int, spec: CircuitSpec, cfg: EvolveConfig, icfg: IslandConfig, n_islands: int,
    data: PackedDataset, mask_train: torch.Tensor, mask_val: torch.Tensor, *,
    device: "str | torch.device | None" = None, timeout_s: float = 600.0,
) -> IslandLaunch:
    """`evolve_islands` over ``n_islands * icfg.n_data`` fresh processes on
    ``device`` (``None``: the card, raising without one).  ``data`` is the
    whole dataset, padded to a multiple of ``icfg.n_data`` words."""
    payload = {"seed": seed, "spec": spec, "cfg": cfg, "icfg": icfg,
               "data": [_host(a) for a in data], "masks": [_host(mask_train), _host(mask_val)]}
    ranks = spawn_ranks("repro_torch.launch.islands:island_rank", payload,
                        n_islands * icfg.n_data, device=device, timeout_s=timeout_s)
    return IslandLaunch(ranks[0].pop("states"), ranks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--islands", type=int, default=4)
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--dataset", default="phoneme")
    ap.add_argument("--gates", type=int, default=300)
    ap.add_argument("--max-gens", type=int, default=2500)
    ap.add_argument("--kappa", type=int, default=300)
    ap.add_argument("--migrate-every", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the plain versions")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    ds = load_dataset(args.dataset)
    tr, te = train_test_split(ds, 0.2, seed=args.seed)
    enc = E.fit_encoder(tr.x, E.EncodingConfig("quantile", 2))
    bits = E.encode(enc, tr.x)
    data = E.pack_dataset(bits, tr.y, ds.n_classes, pad_words_to=pad_words_for(args.data),
                          device="cpu")
    mtr, mva = E.split_masks(tr.x.shape[0], data.x_words.shape[1], 0.5, seed=1, device="cpu")
    spec = CircuitSpec(bits.shape[1], args.gates, data.n_outputs, FULL_FS)
    cfg = EvolveConfig(lam=4, kappa=args.kappa, max_gens=args.max_gens)
    icfg = IslandConfig(migrate_every=args.migrate_every, n_data=args.data)
    print(f"{args.islands} islands x {args.data}-way sharded fitness = "
          f"{args.islands * args.data} processes on {device}")
    run = launch_islands(args.seed, spec, cfg, icfg, args.islands, data, mtr, mva,
                         device=device)
    print("per-island val fitness:", [round(float(s.best_val), 3) for s in run.states])
    best = best_island(run.states)
    te_words = torch.from_numpy(
        E.pack_bits_rows(E.encode(enc, te.x), E.n_words(te.x.shape[0])).view(np.int32))
    program = compile_program(opcodes(best.best, spec)[None], best.best.edge_src[None],
                              best.best.out_src[None], spec.n_inputs)
    out = ops.eval_program(program.to(device), te_words.to(device))[0]
    pred = np.minimum(F.predicted_class_ids(out, te.x.shape[0]).cpu().numpy(),
                      ds.n_classes - 1)
    ba = F.balanced_accuracy_rows(pred, te.y, np.ones_like(te.y, bool), ds.n_classes)
    print(f"global best island: val={float(best.best_val):.3f} test balanced acc={ba:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
