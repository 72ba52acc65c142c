"""stablelm-3b [dense] — partial rotary (25%), LayerNorm.
[hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    arch_type="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    rope_fraction=0.25,
    norm_type="layernorm",
)
