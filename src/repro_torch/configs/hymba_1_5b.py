"""hymba-1.5b [arXiv:2411.13676] — parallel attention + mamba heads.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Mostly sliding-window attention with global (full) attention in the first,
middle and last layers (the paper's layout); mamba head in every layer.
"""
from repro_torch.models.common import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    attn_kind="sliding",
    window=1024,
    global_layers=(0, 15, 31),
    rope_kind="rope",
    block_kind="hybrid",
    ssm=SSMConfig(kind="mamba", state_dim=16, expand=2, conv_dim=4),
    act="swiglu",
    scan_layers=False,
    remat="full",
)
