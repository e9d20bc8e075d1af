"""Tabular dataset substrate (paper Table 1), numpy copy for the port.

This module must give byte-identical arrays to the reference package's
`data/tabular.py`; the port keeps its own copy so that it runs where only
torch and numpy are installed.

The container is offline, so the 33 OpenML/UCI/Kaggle datasets are
represented by deterministic synthetic generators *matched to Table 1*
(rows, features, classes, and a per-dataset difficulty drawn from the
dataset-name hash).  Targets are generated from random decision-tree rules
over a subset of informative features plus label noise — the regime where
tree-based models beat DNNs (Grinsztajn et al., quoted in the paper §1):
irregular target patterns, uninformative features, non rotationally-
invariant data.

`iris` is generated from the published per-class Gaussian statistics of the
real UCI iris data (means/stds per feature per species) — documented
deviation.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class TabularDataset:
    name: str
    x: np.ndarray         # float32[R, F]
    y: np.ndarray         # int64[R] in [0, n_classes)
    n_classes: int

    @property
    def n_rows(self) -> int:
        return self.x.shape[0]

    @property
    def n_features(self) -> int:
        return self.x.shape[1]


# name: (classes, rows, features, in_autogluon_paper)  — paper Table 1.
DATASETS: dict[str, tuple[int, int, int, bool]] = {
    "vehicle": (2, 846, 22, True),
    "cars": (3, 406, 8, True),
    "user-model-data": (4, 403, 5, False),
    "kc1": (2, 145, 95, True),
    "phoneme": (2, 5404, 6, True),
    "skin-seg": (2, 245057, 4, False),
    "ecoli-data": (4, 336, 8, False),
    "iris": (3, 150, 7, False),
    "blood": (2, 748, 4, True),
    "higgs": (2, 98050, 29, True),
    "wifi-localization": (4, 2000, 7, False),
    "nomao": (2, 34465, 119, True),
    "olinda-outlier": (4, 75, 3, False),
    "australian": (2, 690, 15, True),
    "segment": (2, 2310, 20, True),
    "led": (10, 500, 7, False),
    "numerai": (2, 96320, 22, True),
    "miniboone": (2, 130064, 51, True),
    "wall-robot": (4, 5456, 3, False),
    "jasmine": (2, 2984, 145, True),
    "yeast": (10, 1484, 8, False),
    "christine": (2, 5418, 1637, True),
    "sylvine": (2, 5124, 21, True),
    "seismic-bumps": (3, 210, 8, False),
    "ccfraud": (2, 284807, 31, False),
    "clickpred": (2, 1496391, 10, False),
    "vowel": (2, 528, 21, False),
    "nursery": (5, 12958, 9, False),
    "spectf-data": (2, 267, 45, False),
    "teaching-assist": (3, 151, 7, False),
    "wisconsin": (2, 194, 33, False),
    "sonar": (2, 208, 61, False),
    "ionosphere": (2, 351, 35, False),
}

# Published UCI iris per-class feature means / stds (sepal-l, sepal-w,
# petal-l, petal-w); 3 extra synthetic features pad to Table 1's 7.
_IRIS_STATS = {
    0: ([5.006, 3.428, 1.462, 0.246], [0.352, 0.379, 0.174, 0.105]),
    1: ([5.936, 2.770, 4.260, 1.326], [0.516, 0.314, 0.470, 0.198]),
    2: ([6.588, 2.974, 5.552, 2.026], [0.636, 0.322, 0.552, 0.275]),
}


def _name_seed(name: str) -> int:
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")


def _tree_rule_labels(
    rng: np.random.RandomState, x: np.ndarray, n_classes: int, depth: int
) -> np.ndarray:
    """Label rows by a random axis-aligned decision tree over x."""
    r = x.shape[0]
    y = np.zeros(r, dtype=np.int64)
    idx_stack = [(np.arange(r), 0)]
    leaf_class = 0
    while idx_stack:
        idx, d = idx_stack.pop()
        if d == depth or len(idx) == 0:
            if len(idx):
                y[idx] = leaf_class % n_classes
                leaf_class += 1
            continue
        f = rng.randint(x.shape[1])
        vals = x[idx, f]
        thr = np.quantile(vals, rng.uniform(0.25, 0.75)) if len(idx) > 4 else 0.0
        left = idx[vals <= thr]
        right = idx[vals > thr]
        idx_stack.append((left, d + 1))
        idx_stack.append((right, d + 1))
    return y


def _synth(name: str, n_classes: int, rows: int, feats: int) -> TabularDataset:
    seed = _name_seed(name)
    rng = np.random.RandomState(seed)
    # difficulty knobs drawn from the name hash
    noise = 0.03 + (seed % 97) / 97 * 0.22          # label noise 3–25 %
    frac_informative = 0.4 + (seed % 53) / 53 * 0.5  # 40–90 % informative
    n_inf = max(2, int(feats * frac_informative)) if feats > 2 else feats
    depth = int(np.clip(2 + (seed % 5), 2, 6))

    x = rng.randn(rows, feats).astype(np.float32)
    # heterogeneous columns: make ~1/3 categorical-ish (few distinct values)
    n_cat = feats // 3
    for j in range(n_cat):
        k = 2 + (seed + j) % 6
        x[:, j] = np.floor(
            (x[:, j] - x[:, j].min()) / (np.ptp(x[:, j]) + 1e-6) * k
        )
    y = _tree_rule_labels(rng, x[:, :n_inf], n_classes, depth)
    flip = rng.rand(rows) < noise
    y[flip] = rng.randint(0, n_classes, flip.sum())
    return TabularDataset(name=name, x=x, y=y, n_classes=n_classes)


def _iris() -> TabularDataset:
    rng = np.random.RandomState(_name_seed("iris"))
    xs, ys = [], []
    for c, (mu, sd) in _IRIS_STATS.items():
        n = 50
        base = rng.randn(n, 4) * np.asarray(sd) + np.asarray(mu)
        extra = rng.randn(n, 3) * 0.5  # uninformative padding features
        xs.append(np.concatenate([base, extra], axis=1))
        ys.append(np.full(n, c, dtype=np.int64))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys)
    perm = rng.permutation(len(y))
    return TabularDataset("iris", x[perm], y[perm], 3)


def load_dataset(name: str, max_rows: int | None = None) -> TabularDataset:
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; options: {sorted(DATASETS)}")
    c, r, f, _ = DATASETS[name]
    ds = _iris() if name == "iris" else _synth(name, c, r, f)
    if max_rows is not None and ds.n_rows > max_rows:
        rng = np.random.RandomState(0)
        idx = rng.choice(ds.n_rows, max_rows, replace=False)
        ds = TabularDataset(ds.name, ds.x[idx], ds.y[idx], ds.n_classes)
    return ds


def train_test_split(
    ds: TabularDataset, test_fraction: float = 0.2, seed: int = 0
) -> tuple[TabularDataset, TabularDataset]:
    """Paper §5: 80 % train / 20 % test."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(ds.n_rows)
    n_test = int(round(ds.n_rows * test_fraction))
    te, tr = perm[:n_test], perm[n_test:]
    mk = lambda i: TabularDataset(ds.name, ds.x[i], ds.y[i], ds.n_classes)
    return mk(tr), mk(te)


def kfold(ds: TabularDataset, k: int = 10, seed: int = 0):
    """Yield (train, test) folds — the paper's Fig. 10 robustness study."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(ds.n_rows)
    folds = np.array_split(perm, k)
    mk = lambda i: TabularDataset(ds.name, ds.x[i], ds.y[i], ds.n_classes)
    for f in range(k):
        te = folds[f]
        tr = np.concatenate([folds[j] for j in range(k) if j != f])
        yield mk(tr), mk(te)
