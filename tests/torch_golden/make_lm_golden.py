"""Regenerate the reference LM fixtures of the PyTorch port.

Each fixture is one arch of the reference package at ``smoke()`` size
(2 layers, d_model 64, vocab 256, float32), its parameters from
``lm.init_params(jax.random.key(0), cfg)``, serving one seeded batch of 2
prompts: the prefill's last-token logits, then greedy decoding for 8
tokens (each step's logits and the tokens).  The port's tests and
``chip_smoke.py`` carry the parameters across with
`repro_torch.models.convert.params_from_reference` and must reproduce the
tokens exactly and the logits within the CPU tests' tolerance.

  * ``lm_minitron_smoke.npz``: minitron-8b, prompts of 12 tokens;
  * ``lm_granite_moe_smoke.npz``: granite-moe at a capacity factor of 1.0
    (the smoke config's is E/k = 2, dropless), so that a decode step of
    the batch has one slot per expert and drops pairs;
  * ``lm_rwkv6_smoke.npz``: rwkv6, prompts of 13 tokens (not a multiple
    of the chunk of 16: the padding path runs);
  * ``lm_hymba_smoke.npz``: hymba, prompts of 20 tokens (past the smoke
    window of 16: the sliding layers' ring wraps, the global layer sees
    every token).

Run from the repository root (needs JAX):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_golden/make_lm_golden.py

Each file (0.4–0.7 MB) holds ``param/<path>`` for every leaf of the
parameter tree (``/`` between the keys), ``prompt``, ``prefill_logits``,
``decode_logits`` and ``tokens``.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH, NEW = 2, 8


@dataclasses.dataclass(frozen=True)
class Fixture:
    name: str
    arch: str
    prompt: int
    capacity_factor: "float | None" = None   # replaces the smoke config's

    @property
    def path(self) -> str:
        return os.path.join(HERE, f"lm_{self.name}_smoke.npz")

    def config(self, get_config):
        """The fixture's config, from either package's ``get_config``."""
        cfg = get_config(self.arch).smoke()
        if self.capacity_factor is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=self.capacity_factor))
        return cfg


FIXTURES = (Fixture("minitron", "minitron-8b", 12),
            Fixture("granite_moe", "granite-moe-1b-a400m", 12, capacity_factor=1.0),
            Fixture("rwkv6", "rwkv6-7b", 13),
            Fixture("hymba", "hymba-1.5b", 20))


def build(fx: Fixture) -> dict:
    """The fixture's arrays, computed by the reference."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.models import lm

    cfg = fx.config(get_config)
    params = lm.init_params(jax.random.key(0), cfg)
    prompt = np.random.RandomState(0).randint(0, cfg.vocab, (BATCH, fx.prompt)).astype(np.int32)
    logits, cache = lm.prefill(params, cfg, tokens=jnp.asarray(prompt), max_len=fx.prompt + NEW)
    out = {"prompt": prompt, "prefill_logits": np.asarray(logits, np.float32)}
    tokens, steps = [], []
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    for _ in range(NEW):
        tokens.append(np.asarray(tok))
        logits, cache = lm.decode_step(params, cfg, cache, token=tok[:, None])
        steps.append(np.asarray(logits, np.float32))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    out["tokens"] = np.stack(tokens, axis=1)           # (B, NEW)
    out["decode_logits"] = np.stack(steps, axis=1)     # (B, NEW, V)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        name = "/".join(str(k.key) for k in path)
        out[f"param/{name}"] = np.asarray(leaf, np.float32)
    return out


def param_tree(arrays) -> dict:
    """The ``param/…`` arrays of a fixture as the reference's nested tree
    (no JAX needed: the port's tests and ``chip_smoke.py`` load it)."""
    tree: dict = {}
    for key in arrays:
        if key.startswith("param/"):
            *parents, leaf = key.split("/")[1:]
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = np.asarray(arrays[key])
    return tree


def main() -> None:
    for fx in FIXTURES:
        np.savez(fx.path, **build(fx))
        print(f"wrote {fx.path} ({os.path.getsize(fx.path)} bytes)")


if __name__ == "__main__":
    main()
