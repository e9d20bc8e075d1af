"""musicgen-medium [arXiv:2306.05284] — decoder-only over EnCodec tokens.

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048 (EnCodec codebook).
Modality frontend is a STUB: input_specs provides precomputed frame
embeddings (B, S, d_model); targets are codebook token ids.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab=2048,
    attn_kind="full",
    rope_kind="rope",
    act="gelu",
    frontend="audio",
    remat="full",
)
