"""llama-3.2-vision-11b [vlm] — cross-attention image layers every 5th layer;
the ViT vision encoder + projector is a stub providing patch embeddings
(``image_embeds`` [B, num_image_tokens, d_model]).
[hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    arch_type="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_every=5,      # 8 cross-attention layers among 40
    num_image_tokens=1601,   # (448/14)^2 + cls, per image tile
)
