"""Assigned input shapes and (arch × shape) applicability.

  train_4k     seq 4,096  × global_batch 256   → train_step
  prefill_32k  seq 32,768 × global_batch 32    → prefill_step
  decode_32k   seq 32,768 × global_batch 128   → serve_step (1 new token,
                                                  KV cache of seq_len)
  long_500k    seq 524,288 × global_batch 1    → serve_step; sub-quadratic
               attention required — runs for SSM/hybrid archs only
               (DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str        # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is this (arch × shape) cell runnable? (DESIGN.md §Arch-applicability)."""
    if shape.name == "long_500k" and cfg.block_kind == "attn":
        return False, (
            "pure full-attention arch: 512k dense-KV decode is the "
            "quadratic regime long_500k excludes — skipped per brief"
        )
    return True, ""


def smoke_shape(shape: ShapeConfig) -> ShapeConfig:
    """Reduced shape for CPU smoke tests of the same step kind."""
    return ShapeConfig(shape.name + "-smoke", shape.kind, seq_len=32,
                       global_batch=2)
