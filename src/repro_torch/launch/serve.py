"""Serving launcher: batched requests against a (smoke or full) arch, on
the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-8b \
        --requests 8 --new-tokens 16

Weights are random, drawn from ``--seed`` on the device (`init_params`).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.convert import init_params
from repro_torch.serve.engine import Engine, Request, throughput_report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' to run there")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    generator = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(generator, cfg, device)
    engine = Engine(cfg, params, batch_size=args.batch, max_len=128, seed=args.seed,
                    device=device)
    rng = np.random.RandomState(args.seed)
    reqs = [
        Request(uid=i,
                prompt=rng.randint(0, cfg.vocab, rng.randint(4, 12)),
                max_new_tokens=args.new_tokens,
                temperature=args.temperature)
        for i in range(args.requests)
    ]
    rep = throughput_report(engine, reqs)
    for r in reqs[:4]:
        print(f"req {r.uid}: prompt={r.prompt.tolist()[:6]}… "
              f"→ {r.output[:8]}…")
    print({**rep, "device": str(device)})
    if not all(r.done for r in reqs):
        raise RuntimeError("a request was not served")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
