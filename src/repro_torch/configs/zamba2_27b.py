"""zamba2-2.7b [hybrid] — Mamba2 backbone with a single *shared* attention
block applied every 6 SSM blocks.  [arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,           # shared attention block's MLP
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=128,
    attn_every=6,         # 54 layers -> 9 shared-attention applications
)
