"""rwkv6-7b (Finch) [arXiv:2404.05892] — attention-free, data-dependent decay.

32L d_model=4096 d_ff=14336 vocab=65536; 64 wkv heads × head_dim 64.
"""
from repro_torch.models.common import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    n_layers=32,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=14336,
    vocab=65536,
    attn_kind="none",
    rope_kind="none",
    block_kind="rwkv",
    ssm=SSMConfig(kind="rwkv6", head_dim=64, lora_rank=64),
    remat="full",
    train_microbatches=2,
)
