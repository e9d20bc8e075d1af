"""Rotary position embeddings: standard RoPE and Qwen2-VL's M-RoPE
(PyTorch port).

M-RoPE [arXiv:2409.12191] splits the head_dim rotary channels into three
sections (temporal / height / width) with separate position ids; for pure
text all three ids coincide and M-RoPE degenerates to RoPE.  The modality
frontend stub supplies (B, S, 3) position ids.
"""
from __future__ import annotations

import torch

# Qwen2-VL section split for head_dim 128 (×2 channels each: 16/24/24 pairs)
MROPE_SECTIONS = (16, 24, 24)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (D/2,)
    ang = positions[..., None].float() * freqs              # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)


def mrope_sections(half: int) -> tuple[int, int, int]:
    """Qwen2-VL's 16/24/24 split for half = 64; proportional otherwise."""
    if half == sum(MROPE_SECTIONS):
        return MROPE_SECTIONS
    s0 = max(half // 4, 1)
    s1 = (half - s0) // 2
    return (s0, s1, half - s0 - s1)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: "tuple[int, int, int] | None" = None) -> torch.Tensor:
    """x: (B, S, H, D); positions3: (B, S, 3) int32 (t, h, w ids)."""
    half = x.shape[-1] // 2
    secs = mrope_sections(half) if sections is None else sections
    if sum(secs) != half:
        raise ValueError(f"sections {secs} do not cover {half} rotary channels")
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (half,)
    # which positional id drives each rotary channel
    sec_id = torch.repeat_interleave(torch.arange(3, device=x.device),
                                     torch.tensor(secs, device=x.device))
    pos = positions3.float()[..., sec_id]                   # (B, S, half)
    ang = pos * freqs
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)
