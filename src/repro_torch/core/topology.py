"""Elastic instance topology — the port's own copy of
``repro.core.topology``: DP-TP-EP configurations and the logical tensors
the scaling planner (``core/scaling_plan.py``) and the cost model
(``core/costmodel.py``) read.

Conventions (paper §2.1, §4.1): an instance runs on ``dp * tp`` devices;
attention and dense weights are TP-sharded (``tp_rank = slot % tp``) and
replicated over the DP replicas; experts are EP-distributed with ``ep =
dp * tp``; scaling changes DP and EP while TP stays fixed; the KV cache is
per-replica state, TP-sharded within a replica.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """One serving configuration: which devices, and how they're organized."""
    dp: int
    tp: int
    devices: Tuple[int, ...]           # global device ids, slot order

    def __post_init__(self):
        if len(self.devices) != self.dp * self.tp:
            raise ValueError(
                f"{self.dp}x{self.tp} != {len(self.devices)} devices")

    @property
    def ep(self) -> int:
        return self.dp * self.tp       # paper's EP = TP x DP convention

    @property
    def ndev(self) -> int:
        return len(self.devices)

    def slot(self, device: int) -> int:
        return self.devices.index(device)

    def tp_rank(self, device: int) -> int:
        return self.slot(device) % self.tp

    def dp_rank(self, device: int) -> int:
        return self.slot(device) // self.tp

    def ep_rank(self, device: int) -> int:
        return self.slot(device)       # one EP rank per device

    def describe(self) -> str:
        return f"DP{self.dp}-TP{self.tp}-EP{self.ep}@{list(self.devices)}"


@dataclasses.dataclass(frozen=True)
class TensorDesc:
    """One logical tensor of the plan.

    kind:
      'replicated' — identical on every device (norms, routers),
      'tp'         — sharded over the TP ranks; DP replicas hold identical
                     shards,
      'expert'     — one expert's weight page, owned by one EP rank,
      'kv'         — one replica's KV cache (TP-sharded): state, not
                     weights — kept on surviving devices, fresh on new ones.
    """
    name: str
    kind: str
    nbytes: int                        # per-shard bytes (after the TP split)
    layer: int = -1
    expert: int = -1


def expert_owner(expert: int, num_experts: int, cfg: ElasticConfig) -> int:
    """Device owning ``expert`` under round-robin-contiguous EP placement."""
    per = math.ceil(num_experts / cfg.ep)
    rank = min(expert // per, cfg.ep - 1)
    return cfg.devices[rank]


def model_tensors(mcfg, tp: int, kv_bytes_per_replica: int = 0,
                  expert_dtype: Optional[str] = None) -> List[TensorDesc]:
    """The logical tensors of ``mcfg`` at ``tp``: 'tp' sizes are per TP
    shard, expert pages per (layer, expert), the granularity of a remap.

    ``expert_dtype`` is the storage dtype of the expert pages only (the
    pooled store's ``expert_dtype="int8"``); a quantized page carries one
    f32 scale per bank, so it holds ``ff_mult * (D * moe_d_ff * 1 + 4)``
    bytes.  Every other tensor keeps the model dtype."""
    from repro_torch.core.costmodel import dtype_bytes
    bpe = dtype_bytes(mcfg.dtype)
    ebpe = dtype_bytes(expert_dtype or mcfg.dtype)
    escale = 4 if (expert_dtype or mcfg.dtype) != mcfg.dtype else 0
    D = mcfg.d_model
    out: List[TensorDesc] = []
    out.append(TensorDesc("embed", "tp",
                          mcfg.vocab_size * D * bpe // tp))
    out.append(TensorDesc("lm_head", "tp",
                          mcfg.vocab_size * D * bpe // tp))

    H, KVH, hd = mcfg.num_heads, mcfg.num_kv_heads, mcfg.resolved_head_dim
    for l in range(mcfg.num_layers):
        if mcfg.arch_type not in ("ssm",):
            if mcfg.use_mla:
                r = mcfg.kv_lora_rank
                qk = mcfg.qk_nope_dim + mcfg.qk_rope_dim
                attn = (D * H * qk + D * (r + mcfg.qk_rope_dim)
                        + r * H * (mcfg.qk_nope_dim + mcfg.v_head_dim)
                        + H * mcfg.v_head_dim * D)
            else:
                attn = D * H * hd + 2 * D * KVH * hd + H * hd * D
            out.append(TensorDesc(f"layer{l}/attn", "tp", attn * bpe // tp,
                                  layer=l))
        ff_mult = 3 if mcfg.mlp_gated else 2
        if mcfg.is_moe and l >= mcfg.first_k_dense:
            page = ff_mult * (D * mcfg.moe_d_ff * ebpe + escale) // tp
            for e in range(mcfg.num_experts):
                out.append(TensorDesc(f"layer{l}/expert{e}", "expert", page,
                                      layer=l, expert=e))
            if mcfg.num_shared_experts:
                out.append(TensorDesc(
                    f"layer{l}/shared_experts", "tp",
                    mcfg.num_shared_experts * ff_mult * D * mcfg.moe_d_ff
                    * bpe // tp, layer=l))
            if mcfg.dense_residual and mcfg.d_ff:
                out.append(TensorDesc(f"layer{l}/dense_mlp", "tp",
                                      ff_mult * D * mcfg.d_ff * bpe // tp,
                                      layer=l))
            out.append(TensorDesc(f"layer{l}/router", "replicated",
                                  D * mcfg.num_experts * 4, layer=l))
        elif mcfg.d_ff:
            out.append(TensorDesc(f"layer{l}/mlp", "tp",
                                  ff_mult * D * mcfg.d_ff * bpe // tp,
                                  layer=l))
        if mcfg.arch_type in ("ssm", "hybrid"):
            di, N = mcfg.d_inner, mcfg.ssm_state
            ssm = D * (2 * di + 2 * N + mcfg.ssm_heads) + di * mcfg.ssm_conv \
                + di * D
            out.append(TensorDesc(f"layer{l}/ssm", "tp", ssm * bpe // tp,
                                  layer=l))
        out.append(TensorDesc(f"layer{l}/norms", "replicated", 2 * D * bpe,
                              layer=l))
    if kv_bytes_per_replica:
        for l in range(mcfg.num_layers):
            out.append(TensorDesc(f"layer{l}/kv", "kv",
                                  kv_bytes_per_replica
                                  // mcfg.num_layers // tp, layer=l))
    return out


def kv_cache_bytes(mcfg, batch: int, max_len: int,
                   kv_dtype: Optional[str] = None) -> int:
    """KV and state bytes of ONE DP replica (every layer, before the TP
    split).  ``kv_dtype="int8"`` adds one f32 scale per (k, v) token row
    and layer, 8 bytes a token, as the quantized pool allocates them."""
    from repro_torch.core.costmodel import dtype_bytes
    bpe = dtype_bytes(mcfg.dtype)
    kv_bpe = dtype_bytes(kv_dtype or mcfg.dtype)
    kv_scale = 2 * 4 if (kv_dtype or mcfg.dtype) != mcfg.dtype else 0
    L = mcfg.num_layers
    if mcfg.arch_type in ("ssm", "hybrid"):
        di, N = mcfg.d_inner, mcfg.ssm_state
        n = L * batch * ((mcfg.ssm_conv - 1) * (di + 2 * N) * bpe
                         + mcfg.ssm_heads * N * mcfg.ssm_head_dim * 4)
        if mcfg.arch_type == "hybrid":
            ng = L // mcfg.attn_every
            n += ng * batch * max_len * 2 * mcfg.num_kv_heads \
                * mcfg.resolved_head_dim * bpe
        return n
    if mcfg.use_mla:
        return L * batch * max_len * (mcfg.kv_lora_rank
                                      + mcfg.qk_rope_dim) * kv_bpe
    return L * batch * max_len * (2 * mcfg.num_kv_heads
                                  * mcfg.resolved_head_dim * kv_bpe
                                  + kv_scale)
