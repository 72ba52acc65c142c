"""qwen3-30b-a3b — paper evaluation model (§7.2): 128 experts, 8 active.
[arXiv:2505.09388]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-30b-a3b",
    arch_type="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    num_experts=128,
    top_k=8,
    moe_d_ff=768,
)
