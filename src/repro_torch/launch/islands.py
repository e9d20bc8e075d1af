"""Island-parallel evolution launcher: K islands × D data shards as K·D
processes on one host (the counterpart of `examples/evolve_distributed.py`).

    PYTHONPATH=src python -m repro_torch.launch.islands --islands 4 --data 2 \
        --dataset phoneme

runs `core.islands.evolve_islands` on the card (``--device cpu`` for the
plain versions), prints every island's fitness and the best island's
balanced accuracy on held-out rows.

The ranks are fresh interpreters in one gloo group, started by
`launch.ranks.spawn_ranks` (re-exported here with its error,
`IslandLaunchError`).

Launch counts are per process: each rank reports its own
(`circuit_eval.KERNELS`), with its evaluations, so a caller can hold the
two to each other.
"""
from __future__ import annotations

import argparse
import time
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
from repro_torch.launch.ranks import RankLaunchError, spawn_ranks

IslandLaunchError = RankLaunchError  # the island launcher's name for it


class IslandLaunch(NamedTuple):
    states: list[EvolveState]  # every island's final state, in island order
    ranks: list[dict]          # per rank: launches, evaluations, timings, boot_s


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
