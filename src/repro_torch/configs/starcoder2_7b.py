"""starcoder2-7b [arXiv:2402.19173].

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152, RoPE,
sliding-window attention (4096).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab=49152,
    attn_kind="sliding",
    window=4096,
    rope_kind="rope",
    act="gelu",
    remat="full",
    train_microbatches=2,
)
