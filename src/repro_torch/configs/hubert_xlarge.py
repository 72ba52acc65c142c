"""hubert-xlarge [audio] — encoder-only transformer backbone (same arch as
wav2vec2); the conv feature-extractor frontend is a stub that provides
frame embeddings (``frames`` [B, S, d_model]).  [arXiv:2106.07447]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    arch_type="encoder",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    rope_fraction=0.0,    # hubert uses learned/conv positions; frontend stub
    mlp_gated=False,      # GELU MLP
    norm_type="layernorm",
    num_frame_tokens=1,   # frames arrive pre-embedded from the stub frontend
)
