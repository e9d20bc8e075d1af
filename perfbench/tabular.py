"""Table-1 rows made from a seed: the benchmark's frozen copy of the tree-rule
generator.

The paper's datasets (arXiv:2303.00031, Table 1) are not shipped, so a
configuration's table is synthetic at the published rows, features and
classes: standard-normal features, about a third of them bucketed into a few
distinct values, labels from a random axis-aligned decision tree over the
informative features, then label noise.  The difficulty knobs (noise, share of
informative features, tree depth) come from the dataset's name, as in the
generator this copies; the values come from the run's seed, so every seed
gives a different table of the same shape and kind.
"""
from __future__ import annotations

import hashlib

import numpy as np


def name_seed(name: str) -> int:
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")


def rng_for(seed: int, *stream: int) -> np.random.RandomState:
    """A `RandomState` for one stream of a run's seed (any whole number)."""
    ss = np.random.SeedSequence([int(seed) % 2**64, *stream])
    return np.random.RandomState(ss.generate_state(1)[0])


def _tree_rule_labels(rng, x: np.ndarray, n_classes: int, depth: int) -> np.ndarray:
    """Label rows by a random axis-aligned decision tree over ``x``."""
    r = x.shape[0]
    y = np.zeros(r, dtype=np.int64)
    stack = [(np.arange(r), 0)]
    leaf = 0
    while stack:
        idx, d = stack.pop()
        if d == depth or len(idx) == 0:
            if len(idx):
                y[idx] = leaf % n_classes
                leaf += 1
            continue
        f = rng.randint(x.shape[1])
        vals = x[idx, f]
        thr = np.quantile(vals, rng.uniform(0.25, 0.75)) if len(idx) > 4 else 0.0
        stack.append((idx[vals <= thr], d + 1))
        stack.append((idx[vals > thr], d + 1))
    return y


def make_table(name: str, rows: int, features: int, classes: int,
               seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(x float32[rows, features], y int64[rows]) for dataset ``name``."""
    knobs = name_seed(name)
    rng = rng_for(seed, knobs)
    noise = 0.03 + (knobs % 97) / 97 * 0.22           # label noise 3-25 %
    frac_informative = 0.4 + (knobs % 53) / 53 * 0.5  # 40-90 % informative
    n_inf = max(2, int(features * frac_informative)) if features > 2 else features
    depth = int(np.clip(2 + (knobs % 5), 2, 6))

    x = rng.randn(rows, features).astype(np.float32)
    for j in range(features // 3):  # categorical-ish columns
        k = 2 + (knobs + j) % 6
        x[:, j] = np.floor((x[:, j] - x[:, j].min()) / (np.ptp(x[:, j]) + 1e-6) * k)
    y = _tree_rule_labels(rng, x[:, :n_inf], classes, depth)
    flip = rng.rand(rows) < noise
    y[flip] = rng.randint(0, classes, flip.sum())
    return x, y
