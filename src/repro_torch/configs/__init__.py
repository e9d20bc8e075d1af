"""Architecture registry: ``get_config("<arch-id>")`` for the ten assigned
architectures; `input_specs` lists the (arch × shape) inputs as
``(shape, dtype)`` pairs (the reference's ``ShapeDtypeStruct`` stand-ins).
The arch files are plain data, copied from the reference."""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.shapes import SHAPES, ShapeConfig, applicable, smoke_shape  # noqa: F401
from repro_torch.models.common import ModelConfig

_MODULES = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "arctic-480b": "arctic_480b",
    "stablelm-12b": "stablelm_12b",
    "llama3-405b": "llama3_405b",
    "starcoder2-7b": "starcoder2_7b",
    "minitron-8b": "minitron_8b",
    "musicgen-medium": "musicgen_medium",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "rwkv6-7b": "rwkv6_7b",
    "hymba-1.5b": "hymba_1_5b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; options: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``(shape, dtype)`` for every model input of this cell.

    Training/prefill on token archs: int32 token/label ids.  Modality archs
    ([audio]/[vlm]): the frontend is a stub — precomputed frame/patch
    embeddings (B, S, d_model) stand in; qwen2-vl additionally takes
    (B, S, 3) M-RoPE position ids.
    """
    b, s = shape.global_batch, shape.seq_len
    specs: dict = {}
    if shape.kind in ("train", "prefill"):
        if cfg.frontend is not None:
            specs["embeds"] = ((b, s, cfg.d_model), cfg.torch_dtype)
        else:
            specs["tokens"] = ((b, s), torch.int32)
        if shape.kind == "train":
            specs["labels"] = ((b, s), torch.int32)
        if cfg.rope_kind == "mrope":
            specs["positions"] = ((b, s, 3), torch.int32)
    else:  # decode: one new token against a seq_len cache
        if cfg.frontend is not None:
            specs["embed"] = ((b, 1, cfg.d_model), cfg.torch_dtype)
        else:
            specs["token"] = ((b, 1), torch.int32)
    return specs
