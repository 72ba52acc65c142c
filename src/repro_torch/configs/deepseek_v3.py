"""deepseek-v3 — paper evaluation model (§7.2): 256 routed experts, 8 active,
MLA with a low-rank query (q_lora_rank 1536).  [arXiv:2412.19437]

At 671 B parameters it does not fit one card: the port serves it only at
``reduced()`` size, on the CPU, where it carries the q-LoRA branch of
``models/mla.py`` (``q_down`` / ``q_norm`` / ``q_up``) that
deepseek-v2-lite (full-rank q) never reaches."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,
    vocab_size=129280,
    num_experts=256,
    top_k=8,
    moe_d_ff=2048,
    num_shared_experts=1,
    first_k_dense=3,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
)
