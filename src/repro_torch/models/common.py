"""Model configuration dataclasses for the assigned-architecture substrate
(PyTorch port: the reference's dataclasses, with `torch_dtype` in place of
its JAX dtype property).

One `ModelConfig` describes any of the ten architectures (dense / MoE /
audio / VLM / SSM / hybrid); `repro_torch.configs.<id>` holds the exact
published values.  Reduced smoke variants are produced by `.smoke()`.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba"      # "mamba" | "rwkv6"
    state_dim: int = 16      # mamba N; rwkv6 uses head_dim×head_dim state
    head_dim: int = 64       # rwkv6 head size
    expand: int = 2          # mamba d_inner = expand * d_model
    dt_rank: int = 0         # 0 → ceil(d_model/16)
    conv_dim: int = 4        # mamba depthwise conv width
    lora_rank: int = 64      # rwkv6 data-dependent decay LoRA rank


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int             # query heads (0 for attention-free)
    n_kv_heads: int
    head_dim: int
    d_ff: int                # dense FFN hidden dim (per expert dim in MoEConfig)
    vocab: int
    # attention
    attn_kind: str = "full"  # "full" | "sliding" | "none"
    window: int = 4096
    global_layers: tuple[int, ...] = ()  # full-attn layers in a sliding model
    rope_kind: str = "rope"  # "rope" | "mrope" | "none"
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    # ffn / moe / ssm
    act: str = "swiglu"      # "swiglu" | "gelu"
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    block_kind: str = "attn"  # "attn" | "rwkv" | "hybrid"
    # modality frontend (stub: inputs may be precomputed embeddings)
    frontend: str | None = None  # None | "audio" | "vision"
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # training-side knobs carried with the model for the dry-run
    remat: str = "full"      # "full" | "dots" | "none"
    scan_layers: bool = True
    optimizer: str = "adamw"  # "adamw" | "adam8bit"
    train_microbatches: int = 1  # gradient-accumulation splits of train_4k
    grad_accum_dtype: str = "float32"  # "float32" | "bfloat16" (405B-scale)

    # ------------------------------------------------------------------
    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.block_kind == "rwkv"

    def n_params(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        per_layer = 0
        if self.block_kind in ("attn", "hybrid"):
            per_layer += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.block_kind == "rwkv":
            # time-mix: r,k,v,g,o (d×d) + decay LoRA; channel-mix: 2 mats
            lr = self.ssm.lora_rank if self.ssm else 64
            per_layer += 5 * d * d + 2 * d * lr + d * f + f * d + d * d
        if self.block_kind == "hybrid" and self.ssm is not None:
            di = self.ssm.expand * d
            dtr = self.ssm.dt_rank or -(-d // 16)
            per_layer += (
                2 * d * di + di * self.ssm.state_dim * 2
                + di * dtr + dtr * di + di * d
            )
        if self.block_kind in ("attn", "hybrid"):
            if self.moe is not None:
                fe = self.moe.d_ff_expert
                per_layer += self.moe.n_experts * 3 * d * fe + d * self.moe.n_experts
                if self.moe.dense_residual:
                    per_layer += 3 * d * f
            else:
                n_mats = 3 if self.act == "swiglu" else 2
                per_layer += n_mats * d * f
        per_layer += 2 * d  # norms
        total = self.n_layers * per_layer + v * d + 2 * d
        if not self.tie_embeddings:
            total += d * v
        return total

    def active_params(self) -> int:
        """Active-per-token parameters (MoE: routed top-k only)."""
        if self.moe is None:
            return self.n_params()
        fe = self.moe.d_ff_expert
        routed_all = self.n_layers * self.moe.n_experts * 3 * self.d_model * fe
        routed_active = self.n_layers * self.moe.top_k * 3 * self.d_model * fe
        return self.n_params() - routed_all + routed_active

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw: dict = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=max(2, min(4, self.n_heads or 2)),
            n_kv_heads=max(1, min(2, self.n_kv_heads or 1)),
            head_dim=16,
            d_ff=128,
            vocab=256,
            window=16,
            dtype="float32",
            remat="none",
        )
        if self.moe is not None:
            # capacity E/k ⇒ provably dropless: decode/prefill/train agree
            # exactly (production configs keep the paper-standard 1.25 and
            # accept capacity drops).
            tk = min(2, self.moe.top_k)
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=tk, d_ff_expert=32,
                capacity_factor=4 / tk,
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, state_dim=min(8, self.ssm.state_dim), head_dim=16,
                lora_rank=8,
            )
        if self.global_layers:
            kw["global_layers"] = (0,)
        return dataclasses.replace(self, **kw)
