"""Training launcher: an end-to-end loop with checkpointing, auto-resume,
heartbeat, straggler monitoring and preemption handling, on the card
unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-8b --smoke \
        --steps 200 --batch 8 --seq 64 --ckpt-dir /tmp/ck --ckpt-every 50

Weights are random, drawn from ``--seed`` on the device; batches come from
the seeded `TokenStream`, a pure function of the step, so a resumed run
sees the batches it would have seen.  Departures from the reference's
launcher: ``--device``; the checkpoint directory is made before the first
heartbeat is written into it (the reference's first beat fails on a
directory that does not exist yet); each step's time includes waiting for
its loss.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenStream
from repro_torch.device import resolve_device
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import Heartbeat, PreemptionGuard, StragglerMonitor
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import make_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' to run there")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    opt_cfg = OptConfig(kind=cfg.optimizer, lr=args.lr)
    stream = TokenStream(vocab=cfg.vocab, batch=args.batch, seq_len=args.seq, seed=args.seed)

    state = make_train_state(torch.Generator(device=device).manual_seed(args.seed), cfg,
                             opt_cfg, device)
    start_step = 0
    if args.resume and args.ckpt_dir and ckpt.latest_step(args.ckpt_dir):
        state, start_step = ckpt.restore(args.ckpt_dir, state, device=device)
        print(f"resumed from step {start_step}")

    step_fn = make_train_step(cfg, opt_cfg, args.microbatches)
    if args.ckpt_dir:
        os.makedirs(args.ckpt_dir, exist_ok=True)
    hb = Heartbeat(args.ckpt_dir + "/HEARTBEAT", 5.0) if args.ckpt_dir else None
    mon = StragglerMonitor()
    writer = None

    with PreemptionGuard() as guard:
        for i in range(start_step, args.steps):
            t0 = time.time()
            state, metrics = step_fn(state, stream.batch_at(i))
            loss = float(metrics["loss"])  # waits for the step
            dt = time.time() - t0
            if mon.record(i, dt):
                print(f"step {i}: straggler threshold exceeded — at scale "
                      "this triggers evict + elastic restart")
            if hb:
                hb.beat(i)
            if i % args.log_every == 0 or i == args.steps - 1:
                print(f"step {i}: loss={loss:.4f} "
                      f"grad_norm={float(metrics['grad_norm']):.3f} "
                      f"({dt*1000:.0f} ms)", flush=True)
            want_ckpt = args.ckpt_dir and (
                (i + 1) % args.ckpt_every == 0 or guard.preempted
                or i == args.steps - 1
            )
            if want_ckpt:
                if writer is not None:
                    writer.join()
                writer = ckpt.save(args.ckpt_dir, i + 1, state, blocking=False)
            if guard.preempted:
                print(f"preempted at step {i}; checkpoint written")
                break
    if writer is not None:
        writer.join()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
