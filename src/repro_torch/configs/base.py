"""Model configuration: the port's own copy of ``repro.configs.base``.

Pure data.  The field set is the reference's, field for field, so a
reference config converts with ``ModelConfig(**dataclasses.asdict(cfg))``;
the port itself serves the standard-attention MoE decoders
(``models/model.py:paged_cache_supported``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

ArchType = str  # "dense" | "moe" | "ssm" | "hybrid" | "encoder" | "vlm"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: ArchType
    num_layers: int
    d_model: int
    vocab_size: int

    # ---- attention ----
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                 # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_fraction: float = 1.0        # fraction of head_dim that is rotary
    attn_window: Optional[int] = None
    causal: bool = True

    # ---- feed-forward ----
    d_ff: int = 0                     # dense MLP hidden dim (SwiGLU)
    mlp_gated: bool = True            # SwiGLU vs plain GELU MLP

    # ---- norm ----
    norm_type: str = "rmsnorm"        # "rmsnorm" | "layernorm"

    # ---- MoE ----
    num_experts: int = 0              # routed experts (0 -> dense MLP)
    top_k: int = 0
    moe_d_ff: int = 0                 # per-expert hidden dim
    num_shared_experts: int = 0       # deepseek-style shared experts
    dense_residual: bool = False      # arctic: dense MLP in parallel with MoE
    first_k_dense: int = 0            # first k layers use a dense MLP
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # ---- MLA (deepseek v2) ----
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # ---- SSM (mamba2 / zamba2) ----
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 64

    # ---- hybrid (zamba2) ----
    attn_every: int = 0

    # ---- vlm (llama 3.2 vision) ----
    cross_attn_every: int = 0
    num_image_tokens: int = 0

    # ---- audio (hubert) ----
    num_frame_tokens: int = 0

    # ---- substrate ----
    dtype: str = "bfloat16"
    max_seq_len: int = 131072
    tie_embeddings: bool = False

    # -------------------------------------------------------------- derived
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def has_decode(self) -> bool:
        """Encoder-only architectures have no autoregressive decode step."""
        return self.arch_type != "encoder"

    def param_count(self) -> int:
        """Parameters of a standard-attention decoder (embedding, LM head,
        attention, dense MLP or routed experts plus router) — the subset of
        the reference's ``param_count`` that the port's models cover."""
        D, H = self.d_model, self.num_heads
        hd, kvh = self.resolved_head_dim, self.num_kv_heads
        n = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        attn = D * H * hd + 2 * D * kvh * hd + H * hd * D
        ff_mult = 3 if self.mlp_gated else 2
        if self.is_moe:
            ffn = (self.num_experts * ff_mult * D * self.moe_d_ff
                   + self.num_shared_experts * ff_mult * D * self.moe_d_ff
                   + (ff_mult * D * self.d_ff if self.dense_residual else 0)
                   + D * self.num_experts)
        else:
            ffn = ff_mult * D * self.d_ff
        return n + self.num_layers * (attn + ffn)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """A smoke-test-sized variant of the same architecture family (2
    layers, d_model<=256, <=4 experts, f32) — the reference's ``reduced``
    for the standard-attention decoders the port covers."""
    small: dict = dict(
        num_layers=2,
        d_model=min(cfg.d_model, 256),
        vocab_size=min(cfg.vocab_size, 512),
        max_seq_len=1024,
    )
    if cfg.num_heads:
        small["num_heads"] = min(cfg.num_heads, 4)
        small["num_kv_heads"] = max(1, min(cfg.num_kv_heads,
                                           min(cfg.num_heads, 4)))
        small["head_dim"] = (64 if cfg.resolved_head_dim >= 64
                             else cfg.resolved_head_dim)
    if cfg.d_ff:
        small["d_ff"] = min(cfg.d_ff, 512)
    if cfg.is_moe:
        small["num_experts"] = min(cfg.num_experts, 4)
        small["top_k"] = min(cfg.top_k, 2)
        small["moe_d_ff"] = min(cfg.moe_d_ff, 256)
        small["num_shared_experts"] = min(cfg.num_shared_experts, 1)
        small["first_k_dense"] = min(cfg.first_k_dense, 1)
    small["dtype"] = "float32"
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **small)
