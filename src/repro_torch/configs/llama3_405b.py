"""llama3-405b [arXiv:2407.21783].

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256, RoPE θ=500k.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab=128256,
    attn_kind="full",
    rope_kind="rope",
    rope_theta=500_000.0,
    act="swiglu",
    optimizer="adam8bit",
    remat="full",
    train_microbatches=16,
    grad_accum_dtype="bfloat16",
)
