"""minitron-8b [arXiv:2407.14679] — pruned Nemotron.

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=256000,
    attn_kind="full",
    rope_kind="rope",
    act="gelu",
    remat="full",
    train_microbatches=2,
)
