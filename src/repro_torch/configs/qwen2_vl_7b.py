"""qwen2-vl-7b [arXiv:2409.12191] — M-RoPE, dynamic resolution.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
Vision frontend is a STUB: input_specs provides precomputed patch
embeddings (B, S, d_model) plus (B, S, 3) M-RoPE position ids.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab=152064,
    attn_kind="full",
    rope_kind="mrope",
    act="swiglu",
    frontend="vision",
    remat="full",
    train_microbatches=2,
)
