"""Batched LM serving engine: prefill + decode with greedy/temperature
sampling and a simple fixed-batch request queue (PyTorch port of the
reference's ``serve/engine.py``).

`CausalLM.prefill` / `CausalLM.decode_step` do the work; this engine is
the host loop around them.  Sampling draws from an explicit
`torch.Generator` on the model's device, seeded from ``seed``
(Gumbel-max over ``logits / temperature`` in float32, the reference's
``categorical``); temperature 0 is greedy.  The engine runs on the card
unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.lm import CausalLM


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray           # int32[prompt_len]
    max_new_tokens: int = 16
    temperature: float = 0.0     # 0 → greedy
    # filled by the engine:
    output: list = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    def __init__(self, cfg: ModelConfig, params: dict, batch_size: int = 4,
                 max_len: int = 256, seed: int = 0, *,
                 device: "str | torch.device | None" = None):
        """``params``: the port's parameter tree, moved to ``device``
        (``None``: the card); tensors already there are used in place."""
        self.cfg = cfg
        self.model = CausalLM(cfg, params, device=device)
        self.batch_size = batch_size
        self.max_len = max_len
        self.generator = torch.Generator(device=self.model.device).manual_seed(seed)

    def _sample(self, logits: torch.Tensor, temps: np.ndarray) -> np.ndarray:
        logits = logits.float()
        greedy = torch.argmax(logits, dim=-1)
        t = torch.as_tensor(np.maximum(temps, 1e-6), dtype=torch.float32,
                            device=logits.device)[:, None]
        u = torch.rand(logits.shape, generator=self.generator, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        sampled = torch.argmax(logits / t + gumbel, dim=-1)
        pick = torch.as_tensor(temps > 0, device=logits.device)
        return torch.where(pick, sampled, greedy).cpu().numpy()

    def _tokens(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int32), device=self.model.device)

    def run(self, requests: list[Request]) -> list[Request]:
        """Serve all requests; batches of `batch_size` share a prefill.

        Prompts in one batch are truncated to the batch's *shortest*
        prompt for the prefill, and each prompt's remainder is replayed
        through decode (exact)."""
        queue = list(requests)
        while queue:
            batch = queue[: self.batch_size]
            queue = queue[self.batch_size:]
            self._run_batch(batch)
        return requests

    def _run_batch(self, batch: list[Request]):
        min_len = min(len(r.prompt) for r in batch)
        toks = np.stack([r.prompt[:min_len] for r in batch])
        logits, cache = self.model.prefill(self._tokens(toks), max_len=self.max_len)

        # replay any prompt remainder through decode (exactness over speed)
        remainders = [list(r.prompt[min_len:]) for r in batch]
        max_rem = max(len(x) for x in remainders)
        for i in range(max_rem):
            nxt = [rem[i] if i < len(rem) else 0 for rem in remainders]
            logits, cache = self.model.decode_step(cache, self._tokens(nxt)[:, None])

        temps = np.asarray([r.temperature for r in batch])
        steps = max(r.max_new_tokens for r in batch)
        cur = self._sample(logits, temps)
        for r, t in zip(batch, cur):
            if r.max_new_tokens > 0:
                r.output.append(int(t))
        for _ in range(1, steps):
            logits, cache = self.model.decode_step(cache, self._tokens(cur)[:, None])
            cur = self._sample(logits, temps)
            for r, t in zip(batch, cur):
                if len(r.output) < r.max_new_tokens:
                    r.output.append(int(t))
        for r in batch:
            r.done = True


def throughput_report(engine: Engine, requests: list[Request]) -> dict:
    t0 = time.perf_counter()
    engine.run(requests)
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in requests)
    return {"requests": len(requests), "tokens": toks, "seconds": dt,
            "tok_per_s": toks / max(dt, 1e-9)}
