"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512, decoupled RoPE),
2 shared + 64 routed experts top-6, first layer dense.  [arXiv:2405.04434]

This is also one of the paper's own evaluation models (§7.2), so it is the
primary subject of the ElasticMoE reproduction experiments.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,      # MLA: one latent head; kept for bookkeeping
    d_ff=10944,           # dense MLP of the first layer
    vocab_size=102400,
    num_experts=64,
    top_k=6,
    moe_d_ff=1408,
    num_shared_experts=2,
    first_k_dense=1,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=0,        # v2-lite uses full-rank q
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
)
