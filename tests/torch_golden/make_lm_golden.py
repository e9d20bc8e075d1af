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
    every token);
  * ``lm_stablelm_smoke.npz`` and ``lm_llama3_smoke.npz``: stablelm-12b
    and llama3-405b (RoPE θ = 500,000), prompts of 12 tokens;
  * ``lm_qwen2_vl_smoke.npz`` and ``lm_musicgen_smoke.npz``: the two
    embedding frontends, prompts of 12 seeded embeddings (``embeds``);
    qwen2-vl's with M-RoPE ids (``positions``, `vision_positions`): a 2 × 4
    image grid at distinct (t, h, w), then text.  Each decode step feeds
    the greedy token's row of the embedding table (``embed=``,
    `decode_input`).

Run from the repository root (needs JAX); names write only those
fixtures (the others' files stay as they are):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_golden/make_lm_golden.py [name ...]

Each file (0.4–0.7 MB) holds ``param/<path>`` for every leaf of the
parameter tree (``/`` between the keys), ``prompt`` (token archs) or
``embeds`` and ``positions`` (frontends), ``prefill_logits``,
``decode_logits`` and ``tokens``.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH, NEW = 2, 8


@dataclasses.dataclass(frozen=True)
class Fixture:
    name: str
    arch: str
    prompt: int
    capacity_factor: "float | None" = None   # replaces the smoke config's
    grid: "tuple[int, int] | None" = None    # M-RoPE: the prompt's image grid

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
            Fixture("hymba", "hymba-1.5b", 20),
            Fixture("stablelm", "stablelm-12b", 12),
            Fixture("llama3", "llama3-405b", 12),
            Fixture("qwen2_vl", "qwen2-vl-7b", 12, grid=(2, 4)),
            Fixture("musicgen", "musicgen-medium", 12))


def vision_positions(batch: int, s: int, grid: "tuple[int, int]") -> np.ndarray:
    """M-RoPE ids (batch, s, 3) of a prompt that opens with one image of
    ``grid`` = (rows, cols) patches, then text, as Qwen2-VL lays them out:
    patch (r, c) at (t, h, w) = (0, r, c), then text at t = h = w, counting
    on from max(rows, cols)."""
    rows, cols = grid
    n_img = rows * cols
    if n_img > s:
        raise ValueError(f"a {rows} x {cols} grid does not fit a prompt of {s}")
    pos = np.empty((s, 3), np.int32)
    pos[:n_img, 0] = 0
    pos[:n_img, 1] = np.arange(n_img) // cols
    pos[:n_img, 2] = np.arange(n_img) % cols
    pos[n_img:] = (max(rows, cols) + np.arange(s - n_img))[:, None]
    return np.broadcast_to(pos, (batch, s, 3)).copy()


def prefill_inputs(arrays) -> dict:
    """A fixture's prefill inputs, keyed as ``prefill`` takes them:
    ``tokens``, or ``embeds`` with ``positions`` where it has them."""
    if "prompt" in arrays:
        return {"tokens": arrays["prompt"]}
    return {k: arrays[k] for k in ("embeds", "positions") if k in arrays}


def decode_input(frontend: "str | None", embed_table, tok) -> dict:
    """A decode step's input for the greedy tokens ``tok`` (B,): their ids
    (B, 1), or for an embedding frontend their rows of the embedding
    table (B, 1, d).  Indexing only, so numpy, JAX and torch arrays all
    serve."""
    if frontend is None:
        return {"token": tok[:, None]}
    return {"embed": embed_table[tok][:, None]}


def build(fx: Fixture) -> dict:
    """The fixture's arrays, computed by the reference."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.models import lm

    cfg = fx.config(get_config)
    params = lm.init_params(jax.random.key(0), cfg)
    rng = np.random.RandomState(0)
    if cfg.frontend is None:
        out = {"prompt": rng.randint(0, cfg.vocab, (BATCH, fx.prompt)).astype(np.int32)}
    else:
        out = {"embeds": rng.randn(BATCH, fx.prompt, cfg.d_model).astype(np.float32)}
        if cfg.rope_kind == "mrope":
            out["positions"] = vision_positions(BATCH, fx.prompt, fx.grid)
    logits, cache = lm.prefill(params, cfg, max_len=fx.prompt + NEW,
                               **{k: jnp.asarray(v) for k, v in prefill_inputs(out).items()})
    out["prefill_logits"] = np.asarray(logits, np.float32)
    tokens, steps = [], []
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    for _ in range(NEW):
        tokens.append(np.asarray(tok))
        logits, cache = lm.decode_step(params, cfg, cache,
                                       **decode_input(cfg.frontend, params["embed"], tok))
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


def main(names: "list[str]") -> None:
    unknown = set(names) - {fx.name for fx in FIXTURES}
    if unknown:
        raise SystemExit(f"unknown fixtures {sorted(unknown)}")
    for fx in FIXTURES:
        if names and fx.name not in names:
            continue
        np.savez(fx.path, **build(fx))
        print(f"wrote {fx.path} ({os.path.getsize(fx.path)} bytes)")


if __name__ == "__main__":
    main(sys.argv[1:])
