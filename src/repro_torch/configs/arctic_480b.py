"""arctic-480b [hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 **+ dense residual FFN** (Arctic's dense-MoE hybrid).
"""
from repro_torch.models.common import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab=32000,
    attn_kind="full",
    rope_kind="rope",
    act="swiglu",
    moe=MoEConfig(
        n_experts=128, top_k=2, d_ff_expert=4864, dense_residual=True
    ),
    optimizer="adam8bit",
    remat="full",
    train_microbatches=4,
    grad_accum_dtype="bfloat16",
)
