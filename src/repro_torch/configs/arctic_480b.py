"""arctic-480b [moe] — 128 routed experts top-2 in parallel with a dense
residual MLP (dense-MoE hybrid).  [hf:Snowflake/snowflake-arctic-base]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    arch_type="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,            # dense residual MLP hidden dim
    vocab_size=32000,
    num_experts=128,
    top_k=2,
    moe_d_ff=4864,
    dense_residual=True,  # arctic: dense FFN + MoE in parallel
)
