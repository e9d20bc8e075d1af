"""MLP baseline in PyTorch (paper §5.1/§5.4, the Kadra-et-al protocol).

Two configurations used by the paper's hardware comparison:
  * "best MLP":     9 hidden layers × 512 neurons
  * "smallest MLP": 3 hidden layers × 64 neurons
each trained non-quantized and as a **2-bit quantized** version (straight-
through estimator for weights and 2-bit quantized ReLU activations, mirroring
the Brevitas/FINN recipe the paper uses for FPGA synthesis).

The arithmetic is the reference package's, in float32 and in its order:
weights are stored ``[in, out]`` (so per-output-channel quantisation
reduces over dim 0), the activation scale is one per tensor (so a
quantised MLP's predictions depend on the batch, and `mlp_predict` runs
all rows as one batch), the inputs are standardised in numpy, and Adam is
written out by hand.  Training runs eagerly on the card (``device=None``)
and raises without one; ``device="cpu"`` runs on the CPU.  The reference
draws its initial weights from JAX's PRNG, which torch cannot reproduce:
`mlp_params_from_arrays` carries its weights across instead.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    hidden_layers: int = 3
    hidden_dim: int = 64
    weight_bits: int | None = None  # None → float; 2 → paper's quantized MLP
    act_bits: int | None = None
    lr: float = 3e-3
    epochs: int = 60
    batch_size: int = 128
    seed: int = 0

    def layer_sizes(self, n_in: int, n_classes: int) -> list[int]:
        return [n_in] + [self.hidden_dim] * self.hidden_layers + [n_classes]


BEST_MLP = MLPConfig(hidden_layers=9, hidden_dim=512)
SMALLEST_MLP = MLPConfig(hidden_layers=3, hidden_dim=64)


def _fake_quant_sym(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric *per-output-channel* fake quantization of an ``[in, out]``
    weight, straight-through gradients (FINN/Brevitas-style; per-tensor
    2-bit collapses training)."""
    qmax = 2.0 ** (bits - 1) - 1          # 2-bit → {-1, 0, 1}
    scale = torch.clamp_min(torch.amax(torch.abs(x), dim=0, keepdim=True), 1e-6) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax, qmax) * scale
    return x + (q - x).detach()


def _fake_quant_relu(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Quantized ReLU (unsigned levels, one scale for the whole tensor),
    straight-through through the round."""
    r = torch.relu(x)
    qmax = 2.0 ** bits - 1
    scale = torch.clamp_min(torch.amax(r), 1e-6) / qmax
    q = torch.clamp(torch.round(r / scale), 0, qmax) * scale
    return r + (q - r).detach()


class MLP(nn.Module):
    """The baseline's weights (``ws[i]``: ``[in, out]``) and biases, and
    its forward pass under ``cfg``'s weight and activation bits."""

    def __init__(self, ws: list[torch.Tensor], bs: list[torch.Tensor], cfg: MLPConfig):
        super().__init__()
        if len(ws) != len(bs) or any(w.shape[1:] != b.shape for w, b in zip(ws, bs)):
            raise ValueError("each [in, out] weight needs an [out] bias")
        self.cfg = cfg
        self.ws = nn.ParameterList(nn.Parameter(w) for w in ws)
        self.bs = nn.ParameterList(nn.Parameter(b) for b in bs)

    @property
    def layer_sizes(self) -> list[int]:
        return [self.ws[0].shape[0]] + [w.shape[1] for w in self.ws]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        n = len(self.ws)
        for i, (w, b) in enumerate(zip(self.ws, self.bs)):
            if self.cfg.weight_bits is not None:
                w = _fake_quant_sym(w, self.cfg.weight_bits)
            h = h @ w + b
            if i < n - 1:
                if self.cfg.act_bits is not None:
                    h = _fake_quant_relu(h, self.cfg.act_bits)
                else:
                    h = torch.relu(h)
        return h  # logits


def _init(sizes: list[int], cfg: MLPConfig, device: torch.device) -> MLP:
    """He-normal weights from a CPU generator seeded by ``cfg.seed`` (the
    same weights on every device), zero biases."""
    g = torch.Generator().manual_seed(cfg.seed)
    ws = [torch.randn((a, b), generator=g) * math.sqrt(2.0 / a)
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [torch.zeros(b) for b in sizes[1:]]
    return MLP(ws, bs, cfg).to(device)


def mlp_params_from_arrays(ws, bs, cfg: MLPConfig,
                           device: "str | torch.device | None" = None) -> MLP:
    """An `MLP` holding the given weights (``[in, out]`` arrays, e.g. the
    reference's ``MLPParams.ws`` through ``np.asarray``) and biases, as
    float32 on ``device`` (``None``: the card)."""
    dev = resolve_device(device)

    def f32(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))
    return MLP([f32(w) for w in ws], [f32(b) for b in bs], cfg).to(dev)


def mlp_loss(model: MLP, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of the logits against the labels."""
    logp = torch.log_softmax(model(xb), dim=-1)
    return torch.mean(-logp.gather(1, yb[:, None]))


@torch.no_grad()
def adam_update(params, grads, m, v, t: int, lr: float) -> None:
    """One Adam update in place, in float32 and in the reference's order:
    ``m = b1·m + (1−b1)·g``, ``v = b2·v + (1−b2)·g·g``, bias corrections
    ``1 − b**t`` computed in float32, ``p −= lr·m̂ / (√v̂ + eps)``."""
    t32 = np.float32(t)
    bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** t32)
    bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** t32)
    for p, g, mi, vi in zip(params, grads, m, v):
        mi.mul_(ADAM_B1).add_((1 - ADAM_B1) * g)
        vi.mul_(ADAM_B2).add_((1 - ADAM_B2) * g * g)
        p.sub_(lr * (mi / bc1) / (torch.sqrt(vi / bc2) + ADAM_EPS))


def train_mlp(x: np.ndarray, y: np.ndarray, n_classes: int, cfg: MLPConfig, *,
              device: "str | torch.device | None" = None,
              init: "MLP | None" = None):
    """Adam training with feature standardisation; returns (model, norm).

    ``device=None`` trains on the card and raises without one.  ``init``
    (e.g. from `mlp_params_from_arrays`) gives the starting weights, which
    are copied, in place of a fresh draw.  The batches are the reference's:
    a ``RandomState(cfg.seed)`` permutation each epoch, the partial last
    batch dropped."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    mu, sd = x.mean(0), x.std(0) + 1e-6
    xt = torch.from_numpy((x - mu) / sd).to(dev)
    yt = torch.from_numpy(np.asarray(y, np.int64)).to(dev)

    sizes = cfg.layer_sizes(x.shape[1], n_classes)
    if init is None:
        model = _init(sizes, cfg, dev)
    elif init.layer_sizes != sizes:
        raise ValueError(f"init has layers {init.layer_sizes}, cfg needs {sizes}")
    else:
        model = MLP([w.detach().clone() for w in init.ws],
                    [b.detach().clone() for b in init.bs], cfg).to(dev)
    params = list(model.parameters())
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]

    rng = np.random.RandomState(cfg.seed)
    n = x.shape[0]
    bs = min(cfg.batch_size, n)
    t = 0
    for _ in range(cfg.epochs):
        perm = torch.from_numpy(rng.permutation(n)).to(dev)
        for s in range(0, n - bs + 1, bs):
            idx = perm[s : s + bs]
            t += 1
            grads = torch.autograd.grad(mlp_loss(model, xt[idx], yt[idx]), params)
            adam_update(params, grads, m, v, t, cfg.lr)
    return model, (mu, sd)


@torch.no_grad()
def mlp_predict(model: MLP, norm, x: np.ndarray) -> np.ndarray:
    """Class ids of the rows ``x``, all in one batch (the quantised
    activation scale is the batch's), on the model's device."""
    mu, sd = norm
    dev = model.ws[0].device
    xn = torch.from_numpy((np.asarray(x, np.float32) - mu) / sd).to(dev)
    return torch.argmax(model(xn), dim=-1).cpu().numpy()
