"""Shared layers: RMSNorm, initialisers, activations (PyTorch port).

The initialisers draw from an explicit `torch.Generator` on the device
the tensor is made on (a CUDA generator for a start on the card); torch
cannot reproduce JAX's threefry streams, so weights carried from the
reference go through `models/convert.py` instead.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32 accumulation, cast back to input dtype."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(dt)


def dense_init(generator: torch.Generator, shape, in_axis: int = -2,
               dtype=torch.float32) -> torch.Tensor:
    """N(0, 1) / sqrt(fan_in), drawn in float32 on the generator's device."""
    fan_in = shape[in_axis]
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (x / math.sqrt(fan_in)).to(dtype)


def embed_init(generator: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (x * 0.02).to(dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    if name == "swiglu":  # applied as silu(gate) * up by callers
        return F.silu
    if name == "gelu":
        return _gelu_tanh
    raise ValueError(name)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: "torch.Tensor | None" = None) -> torch.Tensor:
    """Token-mean cross entropy in fp32 (``logsumexp`` less the gold
    logit); labels int[...], logits [..., V].  With a mask, the masked
    mean over ``max(mask.sum(), 1)`` tokens."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
