"""XGBoost-style gradient-boosted decision trees (paper §5.1 baseline).

Second-order (Newton) boosting with histogram split finding, exactly the
algorithmic core of XGBoost [Chen & Guestrin '16]:

  gain = ½ [ GL²/(HL+λ) + GR²/(HR+λ) − (GL+GR)²/(HL+HR+λ) ] − γ_split

Binary: logistic loss.  Multiclass: one-vs-all — K trees per boosting round
(the paper's hardware analysis assumes 100 × n_classes estimators, §5.5).
Pure numpy on the host, the reference package's code unchanged: it draws
no random numbers, so the port builds the same trees and predicts the same
ids.  The hardware cost of the resulting ensembles is modelled by
`repro_torch.core.hardware.gbdt_hw`.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class GBDTConfig:
    n_rounds: int = 100
    max_depth: int = 6
    lr: float = 0.3
    reg_lambda: float = 1.0
    min_child_weight: float = 1.0
    n_bins: int = 64
    seed: int = 0


@dataclasses.dataclass
class _Tree:
    feat: np.ndarray    # int32[n_nodes]   (-1 for leaf)
    thresh: np.ndarray  # float32[n_nodes]
    left: np.ndarray    # int32[n_nodes]
    right: np.ndarray   # int32[n_nodes]
    value: np.ndarray   # float32[n_nodes]

    def predict(self, x: np.ndarray) -> np.ndarray:
        out = np.zeros(x.shape[0], dtype=np.float32)
        node = np.zeros(x.shape[0], dtype=np.int64)
        active = np.ones(x.shape[0], dtype=bool)
        while active.any():
            f = self.feat[node]
            leaf = f < 0
            done = active & leaf
            out[done] = self.value[node[done]]
            active &= ~leaf
            if not active.any():
                break
            idx = np.where(active)[0]
            go_left = x[idx, f[idx]] <= self.thresh[node[idx]]
            node[idx] = np.where(
                go_left, self.left[node[idx]], self.right[node[idx]]
            )
        return out

    @property
    def n_internal(self) -> int:
        return int((self.feat >= 0).sum())


def _build_tree(x_binned, bin_edges, g, h, cfg: GBDTConfig) -> _Tree:
    n, f = x_binned.shape
    feat, thresh, left, right, value = [], [], [], [], []

    def new_node():
        feat.append(-1)
        thresh.append(0.0)
        left.append(-1)
        right.append(-1)
        value.append(0.0)
        return len(feat) - 1

    def grow(idx: np.ndarray, depth: int) -> int:
        nid = new_node()
        gs, hs = g[idx].sum(), h[idx].sum()
        value[nid] = float(-gs / (hs + cfg.reg_lambda) * cfg.lr)
        if depth >= cfg.max_depth or len(idx) < 2:
            return nid
        best = (0.0, -1, -1)  # gain, feature, bin
        parent_score = gs * gs / (hs + cfg.reg_lambda)
        for j in range(f):
            hist_g = np.bincount(x_binned[idx, j], weights=g[idx],
                                 minlength=cfg.n_bins)
            hist_h = np.bincount(x_binned[idx, j], weights=h[idx],
                                 minlength=cfg.n_bins)
            gl = np.cumsum(hist_g)[:-1]
            hl = np.cumsum(hist_h)[:-1]
            gr, hr = gs - gl, hs - hl
            ok = (hl >= cfg.min_child_weight) & (hr >= cfg.min_child_weight)
            gain = np.where(
                ok,
                gl * gl / (hl + cfg.reg_lambda)
                + gr * gr / (hr + cfg.reg_lambda)
                - parent_score,
                -np.inf,
            )
            b = int(np.argmax(gain))
            if gain[b] > best[0]:
                best = (float(gain[b]), j, b)
        if best[1] < 0:
            return nid
        _, j, b = best
        mask = x_binned[idx, j] <= b
        li, ri = idx[mask], idx[~mask]
        if len(li) == 0 or len(ri) == 0:
            return nid
        feat[nid] = j
        thresh[nid] = float(bin_edges[j][b])
        left[nid] = grow(li, depth + 1)
        right[nid] = grow(ri, depth + 1)
        return nid

    grow(np.arange(n), 0)
    return _Tree(
        np.asarray(feat, np.int32), np.asarray(thresh, np.float32),
        np.asarray(left, np.int32), np.asarray(right, np.int32),
        np.asarray(value, np.float32),
    )


def _bin_features(x: np.ndarray, n_bins: int):
    """Quantile binning → (binned int32[R,F], per-feature bin upper edges)."""
    r, f = x.shape
    binned = np.zeros((r, f), dtype=np.int32)
    edges = []
    for j in range(f):
        qs = np.quantile(x[:, j], np.linspace(0, 1, n_bins + 1)[1:-1])
        qs = np.unique(qs)
        binned[:, j] = np.searchsorted(qs, x[:, j], side="right")
        full = np.concatenate([qs, [x[:, j].max() + 1.0]])
        # pad so edge index == bin index up to n_bins
        pad = np.full(n_bins - len(full), full[-1])
        edges.append(np.concatenate([full, pad]).astype(np.float32))
    return binned, edges


@dataclasses.dataclass
class GBDTModel:
    trees: list          # binary: list[_Tree]; multiclass: list[list[_Tree]]
    n_classes: int
    base_score: np.ndarray

    @property
    def n_estimators(self) -> int:
        if self.n_classes == 2:
            return len(self.trees)
        return sum(len(t) for t in self.trees)

    def total_internal_nodes(self) -> int:
        if self.n_classes == 2:
            return sum(t.n_internal for t in self.trees)
        return sum(t.n_internal for row in self.trees for t in row)


def train_gbdt(x: np.ndarray, y: np.ndarray, n_classes: int,
               cfg: GBDTConfig = GBDTConfig()) -> GBDTModel:
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.int64)
    binned, edges = _bin_features(x, cfg.n_bins)
    n = x.shape[0]

    if n_classes == 2:
        yb = y.astype(np.float32)
        margin = np.zeros(n, dtype=np.float32)
        trees = []
        for _ in range(cfg.n_rounds):
            p = 1.0 / (1.0 + np.exp(-margin))
            g = p - yb
            h = np.maximum(p * (1 - p), 1e-6)
            t = _build_tree(binned, edges, g, h, cfg)
            margin += t.predict(x)
            trees.append(t)
        return GBDTModel(trees, 2, np.zeros(1, np.float32))

    margins = np.zeros((n, n_classes), dtype=np.float32)
    onehot = np.eye(n_classes, dtype=np.float32)[y]
    rounds: list[list[_Tree]] = []
    for _ in range(cfg.n_rounds):
        e = np.exp(margins - margins.max(axis=1, keepdims=True))
        p = e / e.sum(axis=1, keepdims=True)
        row = []
        for c in range(n_classes):
            g = p[:, c] - onehot[:, c]
            h = np.maximum(p[:, c] * (1 - p[:, c]), 1e-6)
            t = _build_tree(binned, edges, g, h, cfg)
            margins[:, c] += t.predict(x)
            row.append(t)
        rounds.append(row)
    return GBDTModel(rounds, n_classes, np.zeros(n_classes, np.float32))


def gbdt_predict(model: GBDTModel, x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    if model.n_classes == 2:
        margin = np.zeros(x.shape[0], dtype=np.float32)
        for t in model.trees:
            margin += t.predict(x)
        return (margin > 0).astype(np.int64)
    margins = np.zeros((x.shape[0], model.n_classes), dtype=np.float32)
    for row in model.trees:
        for c, t in enumerate(row):
            margins[:, c] += t.predict(x)
    return np.argmax(margins, axis=1).astype(np.int64)


def balanced_accuracy(pred: np.ndarray, y: np.ndarray, n_classes: int) -> float:
    recalls = []
    for c in range(n_classes):
        m = y == c
        if m.sum():
            recalls.append(float((pred[m] == c).mean()))
    return float(np.mean(recalls)) if recalls else 0.0
