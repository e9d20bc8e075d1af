"""Regenerate the reference LM fixture of the PyTorch port.

The reference package's minitron-8b at ``smoke()`` size (2 layers,
d_model 64, vocab 256, float32), its parameters from
``lm.init_params(jax.random.key(0), cfg)``, serves one seeded batch of 2
prompts of 12 tokens: the prefill's last-token logits, then greedy
decoding for 8 tokens (each step's logits and the tokens).  The port's
tests and ``chip_smoke.py`` carry the parameters across with
`repro_torch.models.convert.params_from_reference` and must reproduce the
tokens exactly and the logits within the CPU tests' tolerance.

Run from the repository root (needs JAX):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_golden/make_lm_golden.py

It writes ``tests/torch_golden/lm_minitron_smoke.npz`` (about 0.4 MB):
``param/<path>`` for every leaf of the parameter tree (``/`` between the
keys), ``prompt``, ``prefill_logits``, ``decode_logits`` and ``tokens``.
"""
from __future__ import annotations

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PATH = os.path.join(HERE, "lm_minitron_smoke.npz")
ARCH = "minitron-8b"
BATCH, PROMPT, NEW = 2, 12, 8


def build() -> dict:
    """The fixture's arrays, computed by the reference."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.models import lm

    cfg = get_config(ARCH).smoke()
    params = lm.init_params(jax.random.key(0), cfg)
    prompt = np.random.RandomState(0).randint(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)
    logits, cache = lm.prefill(params, cfg, tokens=jnp.asarray(prompt), max_len=PROMPT + NEW)
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
    np.savez(PATH, **build())
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")


if __name__ == "__main__":
    main()
