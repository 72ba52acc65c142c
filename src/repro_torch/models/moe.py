"""Mixture-of-Experts layer on one shard — the port of the single-shard
paths of ``repro.models.moe`` (router, capacity dispatch, combine, and the
dense-bank and pooled-store expert FFNs).

Capacity convention (GShard): every expert gets ``C = ceil(T * top_k / E *
capacity_factor)`` slots; slots come from a cumulative count over the
flattened (token, k) order and overflow entries are dropped.  At decode
with 8 sequences, top-8 of 128 experts and factor 1.25, C is one token.

Where the reference's JAX idioms do not carry over:

* ``jax.lax.top_k`` breaks ties toward the lower index; ``torch.topk``
  promises no order on CUDA, so ``route`` takes a stable descending sort;
* the reference's combine ``y.at[token_idx].add(...)`` sums the k
  contributions of a token in order, in the working dtype; ``index_add_``
  on CUDA uses atomics (order varies run to run), so the combine gathers
  ``[T, k, D]`` and adds over k in order instead;
* dropped writes (``mode="drop"``) go to an extra overflow slot that is
  sliced off, and dropped reads (``mode="fill"``) read a zero slot;
* the reference's ``moe_local`` / ``moe_local_pooled`` also return the
  load-balance aux loss, a training term that serving discards; here they
  return the output only, and ``route`` alone computes the loss.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dot, mlp_apply


def router_init(gen, d_model, num_experts, device, lead=()):
    # router math is always f32 for stability
    return {"w": torch.randn(*lead, d_model, num_experts, generator=gen,
                             device=device, dtype=torch.float32)
            .mul_(1.0 / math.sqrt(d_model))}


def _topk(p, x, top_k: int):
    """x [T, D] -> (probs [T,E], topk_idx [T,k] int64, topk_w [T,k] f32)."""
    logits = torch.matmul(x.float(), p["w"].float())
    probs = torch.softmax(logits, dim=-1)
    topk_w, topk_idx = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    topk_w, topk_idx = topk_w[:, :top_k], topk_idx[:, :top_k]
    return probs, topk_idx, topk_w / topk_w.sum(-1, keepdim=True)


def route(p, x, top_k: int):
    """x [T, D] -> (topk_idx [T,k] int32, topk_w [T,k] f32, aux_loss)."""
    probs, topk_idx, topk_w = _topk(p, x, top_k)
    # GShard/Switch load-balance auxiliary loss
    E = probs.shape[-1]
    me = probs.mean(0)
    ce = F.one_hot(topk_idx[:, 0], E).float().mean(0)
    aux = E * torch.sum(me * ce)
    return topk_idx.to(torch.int32), topk_w, aux


def _dispatch_indices(topk_idx, num_experts: int, capacity: int):
    """Flattened (token, k) entries -> (expert_flat [T*k], slot [T*k],
    keep [T*k] bool); dropped entries get ``slot == capacity``."""
    expert_flat = topk_idx.reshape(-1).long()
    onehot = F.one_hot(expert_flat, num_experts)
    pos = torch.cumsum(onehot, dim=0) - 1                   # [Tk, E]
    slot = (pos * onehot).sum(-1)                            # [Tk]
    keep = slot < capacity
    slot = torch.where(keep, slot, torch.full_like(slot, capacity))
    return expert_flat, slot, keep


def capacity_for(tokens: int, cfg) -> int:
    return max(1, int(math.ceil(tokens * cfg.top_k / cfg.num_experts
                                * cfg.capacity_factor)))


def routing_counts(topk_idx, num_experts: int):
    """topk_idx [T, k] -> per-expert routed-token counts [E] int32 (router
    demand; capacity dropping ignored)."""
    return torch.bincount(topk_idx.reshape(-1).long(),
                          minlength=num_experts).to(torch.int32)


def _expert_ffn(xg, wi, wg, wo):
    """Dense banks: xg [E, C, D]; wi/wg [E, D, F]; wo [E, F, D].  Three
    batched products, each accumulated in f32 and rounded once to xg's
    dtype (``dot``), with ``silu`` in f32 of the rounded gate: the
    rounding points of the pooled path's ``paged_expert_ffn``.  The
    reference's dense einsum keeps the gate product in f32 until after
    ``silu``; in f32 the two are the same function, in bf16 they differ by
    one rounding of the gate.  Casting the banks to f32 instead would copy
    every expert's weights (2.4 GB a layer at full size) on every step."""
    h = dot(xg, wi)
    g = dot(xg, wg)
    h = h * F.silu(g.float()).to(h.dtype)
    return dot(h, wo)


def _moe_local_body(cfg, p, x, capacity, expert_ffn):
    """Single-shard dispatch / combine shared by the dense banks and the
    pooled store; ``expert_ffn(xg [E, C, D]) -> [E, C, D]`` is the only
    difference between them.  Serving discards the router's aux loss, so
    it is not computed here (``route`` has it)."""
    T, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    C = capacity or capacity_for(T, cfg)
    _, topk_idx, topk_w = _topk(p["router"], x, k)
    expert_flat, slot, keep = _dispatch_indices(topk_idx, E, C)
    token_idx = torch.arange(T, device=x.device).repeat_interleave(k)

    xg = torch.zeros((E, C + 1, D), dtype=x.dtype, device=x.device)
    xg[expert_flat, slot] = x[token_idx]           # slot C: dropped entries
    yg = expert_ffn(xg[:, :C].contiguous())
    yg = torch.cat([yg, yg.new_zeros((E, 1, D))], dim=1)   # zero fill slot

    w_flat = topk_w.reshape(T * k).to(x.dtype)
    contrib = yg[expert_flat, slot] * (w_flat * keep)[:, None]
    contrib = contrib.reshape(T, k, D)
    y = contrib[:, 0]
    for j in range(1, k):                          # in order, working dtype
        y = y + contrib[:, j]
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x)
    return y


def moe_local(cfg, p, x, capacity=None):
    """x [T, D] -> [T, D] over dense banks {wi, wg, wo} [E, D, F|D]."""
    return _moe_local_body(
        cfg, p, x, capacity,
        lambda xg: _expert_ffn(xg, p["wi"], p["wg"], p["wo"]))


def moe_local_pooled(cfg, p, pool, x, capacity=None):
    """Single-shard MoE over the pooled weight store: ``p["gtable"]`` [E]
    is each expert's global pool row and ``pool`` holds the banks
    ``{wi, wg, wo}`` as ``[pages, D, F]`` / ``[pages, F, D]``; the expert
    FFN reads pages through the table (``ops.paged_expert_ffn``: three
    paged-GMM launches on the card).  An int8 store also holds the
    per-page f32 scale banks ``{wi,wg,wo}_scale`` [pages], read through the
    same table (``ops.quant_paged_expert_ffn``).  x [T, D] -> [T, D]."""
    gt = p["gtable"]
    if "wi_scale" in pool:
        def ffn(xg):
            return ops.quant_paged_expert_ffn(
                gt, gt, gt, pool["wi"], pool["wg"], pool["wo"],
                pool["wi_scale"], pool["wg_scale"], pool["wo_scale"], xg)
    else:
        def ffn(xg):
            return ops.paged_expert_ffn(gt, gt, gt, pool["wi"], pool["wg"],
                                        pool["wo"], xg)
    return _moe_local_body(cfg, p, x, capacity, ffn)
