"""chatglm3-6b [dense] — RoPE 2d (partial rotary 0.5), GQA kv=2.  [arXiv:2406.12793]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    arch_type="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_fraction=0.5,   # chatglm applies rotary to half of each head dim
    qkv_bias=True,       # chatglm uses bias on qkv only
)
