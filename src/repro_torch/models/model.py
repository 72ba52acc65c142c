"""Standard-attention decoder (dense or MoE) over the paged KV pool — the
port of the serving steps of ``repro.models.model``.

Parameters are nested dicts of tensors in the reference's layout: the
per-layer leaves under ``params["blocks"]`` are stacked with a leading
layer axis, an optional ``params["dense_prefix"]`` list holds the first
``first_k_dense`` layers of a MoE model, and with the pooled expert store
``params["moe_pool"]`` holds the page banks while ``blocks/moe`` holds the
index arrays (``tables``, ``edest``, ``eslot``, ``gtable``).  A Python loop
over layers replaces the reference's ``lax.scan``.

The paged steps update the KV pool in place (the reference donates it to
its jitted steps) and return the same dict.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models.layers import (apply_norm, attention_init, linear,
                                       linear_init, mlp_apply, mlp_init,
                                       norm_init, paged_attention_apply,
                                       paged_chunk_attention_apply)
from repro_torch.models.moe import moe_local_pooled, router_init

Params = Dict[str, Any]


# ------------------------------------------------------------------ builders

def _block_init(gen, cfg, dtype, device, *, moe: bool, lead=()):
    p = {"ln1": norm_init(cfg.d_model, cfg.norm_type, dtype, device, lead),
         "ln2": norm_init(cfg.d_model, cfg.norm_type, dtype, device, lead),
         "attn": attention_init(gen, cfg, dtype, device, lead)}
    if moe:
        p["moe"] = {"router": router_init(gen, cfg.d_model, cfg.num_experts,
                                          device, lead)}
        if cfg.num_shared_experts:
            p["moe"]["shared"] = mlp_init(
                gen, cfg.d_model, cfg.moe_d_ff * cfg.num_shared_experts,
                dtype, device, gated=True, lead=lead)
        if cfg.dense_residual:
            p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device,
                                cfg.mlp_gated, lead)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device,
                            cfg.mlp_gated, lead)
    return p


def init_expert_bank(cfg, gen: torch.Generator, dtype, device):
    """One MoE layer's routed expert weights {wi, wg: [E,D,F], wo:
    [E,F,D]} — drawn one layer at a time so that ``HMM.boot`` can write
    each (layer, expert) straight into its pool page."""
    D, Fd, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts

    def normal(shape, scale):
        return torch.randn(*shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(scale).to(dtype)
    return {"wi": normal((E, D, Fd), D ** -0.5),
            "wg": normal((E, D, Fd), D ** -0.5),
            "wo": normal((E, Fd, D), Fd ** -0.5)}


def init_params(cfg, seed: int = 0, *, device="cuda", dtype=None) -> Params:
    """Random parameters drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed`` (not the reference's numbers: the tests convert
    the reference's parameters with ``convert.params_from_jax`` instead).

    MoE layers get the router but no routed experts: ``HMM.boot`` fills the
    pooled store layer by layer with ``init_expert_bank`` and adds its page
    tables, so the experts are never held twice."""
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    p: Params = {"final_norm": norm_init(cfg.d_model, cfg.norm_type, dtype,
                                         dev),
                 "embed": torch.randn(cfg.vocab_size, cfg.d_model,
                                      generator=gen, device=dev,
                                      dtype=torch.float32).mul_(0.02)
                 .to(dtype),
                 "lm_head": linear_init(gen, cfg.d_model, cfg.vocab_size,
                                        dtype, dev)}
    nk = cfg.first_k_dense if cfg.is_moe else 0
    if nk:
        p["dense_prefix"] = [_block_init(gen, cfg, dtype, dev, moe=False)
                             for _ in range(nk)]
    p["blocks"] = _block_init(gen, cfg, dtype, dev, moe=cfg.is_moe,
                              lead=(cfg.num_layers - nk,))
    return p


def layer_params(tree, i: int):
    """Layer ``i``'s view of stacked per-layer leaves."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


# -------------------------------------------------------------- block apply

def _ffn_part(cfg, bp, h, *, moe: bool, moe_pool=None):
    """Post-attention feed-forward: the dense MLP, or the MoE over the
    pooled expert store ``moe_pool`` (``bp["moe"]`` carries its page-table
    index arrays)."""
    if not moe:
        return mlp_apply(bp["mlp"], h, cfg.mlp_gated)
    B, S, D = h.shape
    y = moe_local_pooled(cfg, bp["moe"], moe_pool,
                         h.reshape(B * S, D)).reshape(B, S, D)
    if cfg.dense_residual:
        y = y + mlp_apply(bp["mlp"], h, cfg.mlp_gated)
    return y


def _layers(cfg, params):
    """(block params, is_moe) per layer, dense prefix first."""
    nk = cfg.first_k_dense if cfg.is_moe else 0
    for i in range(cfg.num_layers):
        if i < nk:
            yield params["dense_prefix"][i], False
        else:
            yield layer_params(params["blocks"], i - nk), cfg.is_moe


# ------------------------------------------------------------------- caches

def paged_cache_supported(cfg) -> bool:
    """The block-managed KV layout covers standard-attention decoders
    (dense + MoE)."""
    return (cfg.has_decode and cfg.arch_type in ("dense", "moe")
            and not cfg.use_mla and cfg.attn_window is None)


def chunk_prefill_supported(cfg) -> bool:
    """Chunked prefill covers the same family as the paged layout."""
    return paged_cache_supported(cfg)


def init_paged_cache(cfg, num_blocks: int, block_size: int, dtype=None, *,
                     device="cuda", kv_dtype=None):
    """Block-pool decode cache: {'k','v': [L, NB, bs, KVH, hd]}, zeros."""
    if not paged_cache_supported(cfg):
        raise ValueError(f"{cfg.name}: paged KV requires a "
                         f"standard-attention decoder")
    if kv_dtype is not None:
        raise NotImplementedError("kv_dtype (int8 KV pool) is not ported yet")
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


# ------------------------------------------------------------------- steps

def paged_decode_step(cfg, params: Params, tokens, cache, lengths,
                      block_tables, write_block):
    """One decode step over the paged KV pool.  tokens [B,1]; lengths [B]
    int32 (tokens already cached); block_tables [B,MB] int32; write_block
    [B] int32 = row receiving this token's k/v (``NB`` for inactive slots
    -> dropped).  Updates ``cache`` in place; returns (logits [B,V],
    cache)."""
    x = F.embedding(tokens.long(), params["embed"])
    positions = lengths[:, None]
    pool = params.get("moe_pool")
    for i, (bp, moe) in enumerate(_layers(cfg, params)):
        h = apply_norm(bp["ln1"], x, cfg.norm_type)
        a, _ = paged_attention_apply(
            cfg, bp["attn"], h, positions,
            cache={n: v[i] for n, v in cache.items()},
            block_tables=block_tables, write_block=write_block,
            lengths=lengths)
        x = x + a
        h = apply_norm(bp["ln2"], x, cfg.norm_type)
        x = x + _ffn_part(cfg, bp, h, moe=moe, moe_pool=pool)
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    return linear(params["lm_head"], x[:, 0]), cache


def paged_chunk_prefill_step(cfg, params: Params, tokens, cache, start: int,
                             length: int, block_tables, chunk_block_ids):
    """One chunked-prefill step for a single sequence over the paged pool.

    tokens [1,C] — one prompt chunk at positions start..start+C-1 (rows at
    or beyond the prompt length are padding); ``start`` = chunk offset
    (block-aligned); ``length`` = context tokens after this chunk;
    block_tables [1,MB] = the sequence's table; chunk_block_ids [C/bs] =
    pool rows receiving this chunk's k/v (``NB`` for padding / CoW-shared
    rows -> dropped).  Updates ``cache`` in place; returns (logits [1,V] at
    position ``length-1``, cache)."""
    start, length = int(start), int(length)
    C = tokens.shape[1]
    dev = tokens.device
    x = F.embedding(tokens.long(), params["embed"])
    positions = start + torch.arange(C, device=dev, dtype=torch.int32)[None]
    q_len = length - start
    ctx_t = torch.tensor([length], dtype=torch.int32, device=dev)
    qlen_t = torch.tensor([q_len], dtype=torch.int32, device=dev)
    pool = params.get("moe_pool")
    for i, (bp, moe) in enumerate(_layers(cfg, params)):
        h = apply_norm(bp["ln1"], x, cfg.norm_type)
        a, _ = paged_chunk_attention_apply(
            cfg, bp["attn"], h, positions,
            cache={n: v[i] for n, v in cache.items()},
            block_tables=block_tables, chunk_block_ids=chunk_block_ids,
            ctx_len=ctx_t, q_len=qlen_t)
        x = x + a
        h = apply_norm(bp["ln2"], x, cfg.norm_type)
        x = x + _ffn_part(cfg, bp, h, moe=moe, moe_pool=pool)
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    return linear(params["lm_head"], x[:, q_len - 1]), cache
