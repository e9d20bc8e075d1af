"""Rank groups on one host: ``world_size`` fresh interpreters joined in
one gloo group, each running a target function (`spawn_ranks`).

`spawn_ranks` builds the kernel library in this process first (the ranks
load it and never build it), writes the job to a temporary directory, and
starts ``world_size`` fresh interpreters (`subprocess`, never a fork after
CUDA is initialised) with ``PYTHONPATH`` set to this checkout's ``src``.
Each rank joins one gloo group through a `FileStore` in that directory
(no TCP port, so concurrent launches never collide), runs the job's
target, writes its result and exits.  A rank that exits non-zero, or a
run that outlasts ``timeout_s``, fails the launch with that rank's stderr
tail; the other ranks are killed.  Nothing falls back to running in this
process.  On the card every rank uses device 0: the ranks of a group share
one card, or take ``cuda:{rank % count}`` where a target asks for it.

The island launcher (`launch/islands.py`) and the sharded training and
decode over a mesh (`launch/mesh.py`) run their ranks through it.
"""
from __future__ import annotations

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

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.kernels import circuit_eval

# the directory holding the ``repro_torch`` package
SRC_DIR = Path(__file__).resolve().parents[2]
_CHILD_MAIN = (
    "import sys; from repro_torch.launch.ranks import rank_main; "
    "sys.exit(rank_main(sys.argv[1:]))"
)
STDERR_TAIL = 4000  # bytes of a failed rank's stderr in the error


class RankLaunchError(RuntimeError):
    """A rank failed to start, failed, or the launch timed out."""


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
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
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
            raise RankLaunchError(
                f"rank {r} of {len(procs)} exited with code {codes[r]}:\n"
                f"{_tail(run / f'rank{r}.err')}")
        if all(c == 0 for c in codes):
            return
        if time.monotonic() > deadline:
            silent = [r for r, c in enumerate(codes) if c is None]
            tails = "\n".join(f"-- rank {r} --\n{_tail(run / f'rank{r}.err')}" for r in silent)
            raise RankLaunchError(
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
                raise RankLaunchError(
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
