"""Standard-attention and MLA decoders (dense or MoE) and the Mamba2
models — the port of the serving steps of ``repro.models.model`` over the
two KV layouts: the paged pool (``paged_decode_step``,
``paged_chunk_prefill_step``; standard attention only, as in the
reference) and the slot-contiguous cache of the dense-KV mode
(``prefill``, ``decode_step``; ``write_prefill_to_blocks`` moves a
monolithic prefill into the pool), plus the full-sequence ``forward``.  An
MLA model (``cfg.use_mla``) caches its latent ``{'c','kr'}``
(``models/mla.py``) and applies its ``first_k_dense`` prefix in every
step, prefix rows first in the cache.  A Mamba2 model (``arch_type``
"ssm") caches each layer's conv tail and SSD state ``{'conv','state'}``
(``models/mamba2.py``); a hybrid ("hybrid", zamba2) adds one shared
attention block at the head of every group of ``attn_every`` SSD layers,
its K/V rows ``{'attn_k','attn_v'}`` cached per group.

Parameters are nested dicts of tensors in the reference's layout: the
per-layer leaves under ``params["blocks"]`` are stacked with a leading
layer axis, an optional ``params["dense_prefix"]`` list holds the first
``first_k_dense`` layers of a MoE model.  The routed experts are either
dense banks ``blocks/moe/{wi,wg,wo}`` ``[L, E, D, F|D]`` or, with the
pooled expert store, page banks in ``params["moe_pool"]`` while
``blocks/moe`` holds the index arrays (``tables``, ``edest``, ``eslot``,
``gtable``).  The Mamba2 models stack ``blocks/{ln, ssm}`` and a hybrid
holds its one shared block, unstacked, in ``params["shared_attn"]``.  A
Python loop over layers replaces the reference's ``lax.scan``.

The steps that take a cache update it in place (the reference donates it
to its jitted steps) and return the same dict.

With ``parallel`` (``distributed.sharding.ParallelCtx``, several logical
devices) the parameters and the cache are trees of ``ShardedTensor``s, as
``HMM`` lays them out: each DP replica runs its embedding, norms,
attention and LM head on its own shards, over its own rows and its own
slice of the cache (the slot cache split on its batch axis, the block pool
on its block axis: block tables and block ids are local to that slice),
and every MoE layer runs ``moe_ep`` across all logical devices, each
replica's rows once.  A decode step's rows are the replicas' slots in
order; a prefill or a chunk belongs to one replica (``replica``).  At tp >
1 a replica's TP ranks split it Megatron-style (``layers``' ``*_tp``
forms): each rank holds a copy of the activations between blocks and of
the replica's cache slice; the embedding gives each rank's vocab rows
(zeros elsewhere) summed over the ranks, the LM head each rank's vocab
columns gathered; every step writes every rank's copy of the cache.  An
MLA layer splits its heads the same way (``mla_*_tp``: every rank
computes the same latent and writes its own copy); an SSD layer is
replicated, each rank running it on its copy of the activations and its
copy of the layer's conv tail and state; a hybrid's shared block splits
as standard attention does.  Heads must split evenly over tp
(``check_tp_heads``); the paged steps stay standard-attention only.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.distributed.sharding import (local_view, tp_all_gather,
                                              tp_all_reduce)
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_norm, attention_apply,
                                       attention_apply_tp, attention_init,
                                       linear, linear_cols, linear_init,
                                       mlp_apply, mlp_apply_tp, mlp_init,
                                       norm_init, paged_attention_apply,
                                       paged_attention_apply_tp,
                                       paged_chunk_attention_apply,
                                       paged_chunk_attention_apply_tp)
from repro_torch.models.mamba2 import (mamba2_decode, mamba2_forward,
                                       mamba2_init)
from repro_torch.models.mla import (mla_decode, mla_decode_tp, mla_init,
                                    mla_prefill, mla_prefill_tp)
from repro_torch.models.moe import (moe_ep, moe_local, moe_local_pooled,
                                    router_init)

Params = Dict[str, Any]


# ------------------------------------------------------------------ builders

def _block_init(gen, cfg, dtype, device, *, moe: bool, lead=()):
    attn = mla_init if cfg.use_mla else attention_init
    p = {"ln1": norm_init(cfg.d_model, cfg.norm_type, dtype, device, lead),
         "ln2": norm_init(cfg.d_model, cfg.norm_type, dtype, device, lead),
         "attn": attn(gen, cfg, dtype, device, lead)}
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
    dense banks or the pooled store layer by layer with
    ``init_expert_bank``, so the experts are never held twice.  The Mamba2
    models get stacked SSD blocks and, a hybrid, one shared attention
    block."""
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
    if cfg.arch_type in ("ssm", "hybrid"):
        lead = (cfg.num_layers,)
        p["blocks"] = {"ln": norm_init(cfg.d_model, cfg.norm_type, dtype,
                                       dev, lead),
                       "ssm": mamba2_init(gen, cfg, dtype, dev, lead)}
        if cfg.arch_type == "hybrid":
            p["shared_attn"] = _block_init(gen, cfg, dtype, dev, moe=False)
        return p
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
    index arrays) or over the layer's dense banks ``bp["moe"]["wi"/"wg"/
    "wo"]``."""
    if not moe:
        return mlp_apply(bp["mlp"], h, cfg.mlp_gated)
    B, S, D = h.shape
    x = h.reshape(B * S, D)
    if moe_pool is not None and "gtable" in bp["moe"]:
        y = moe_local_pooled(cfg, bp["moe"], moe_pool, x)
    else:
        y = moe_local(cfg, bp["moe"], x)
    y = y.reshape(B, S, D)
    if cfg.dense_residual:
        y = y + mlp_apply(bp["mlp"], h, cfg.mlp_gated)
    return y


def _layers(cfg, params):
    """(kind, cache row, block params, is_moe) per block, in order.  An
    attention decoder's blocks are all "attn", dense prefix first, cache
    row = layer.  A Mamba2 model's are "ssm" (cache row = layer); a hybrid
    applies its shared "attn" block at the head of every group of
    ``attn_every`` layers (cache row = group)."""
    if cfg.arch_type in ("ssm", "hybrid"):
        every = cfg.attn_every if cfg.arch_type == "hybrid" else 0
        for l in range(cfg.num_layers):
            if every and l % every == 0:
                yield "attn", l // every, params["shared_attn"], False
            yield "ssm", l, layer_params(params["blocks"], l), False
        return
    nk = cfg.first_k_dense if cfg.is_moe else 0
    for i in range(cfg.num_layers):
        if i < nk:
            yield "attn", i, params["dense_prefix"][i], False
        else:
            yield "attn", i, layer_params(params["blocks"], i - nk), \
                cfg.is_moe


def _attention(cfg, bp, h, positions, **cache_kw):
    """The layer's self-attention: MLA (``models/mla.py``) or standard
    (``layers.attention_apply``); returns (y, new k/v or latent)."""
    if cfg.use_mla:
        if not cache_kw:
            return mla_prefill(cfg, bp["attn"], h, positions)
        return mla_decode(cfg, bp["attn"], h, positions, **cache_kw)
    return attention_apply(cfg, bp["attn"], h, positions, **cache_kw)


def _attn_block(cfg, bp, x, positions, *, moe=False, moe_pool=None,
                **cache_kw):
    """Self-attention and the feed-forward, each with its residual ->
    (x', the attention's new k/v, latent or cache)."""
    h = apply_norm(bp["ln1"], x, cfg.norm_type)
    a, kv = _attention(cfg, bp, h, positions, **cache_kw)
    x = x + a
    h = apply_norm(bp["ln2"], x, cfg.norm_type)
    return x + _ffn_part(cfg, bp, h, moe=moe, moe_pool=moe_pool), kv


def _ssm_block(cfg, bp, x, cache=None):
    """Norm, SSD (``mamba2_forward`` from a zero state, or one
    ``mamba2_decode`` step from ``cache``) and residual -> (x', the
    layer's new {'conv', 'state'})."""
    h = apply_norm(bp["ln"], x, cfg.norm_type)
    if cache is None:
        y, new = mamba2_forward(cfg, bp["ssm"], h, return_cache=True)
    else:
        y, new = mamba2_decode(cfg, bp["ssm"], h, cache)
    return x + y, new


# ------------------------------------------------------------------- caches

def dense_cache_supported(cfg) -> bool:
    """The slot-contiguous cache covers the standard-attention decoders
    (``paged_cache_supported``), the MLA decoders (dense and MoE) and the
    Mamba2 models (attention-free and hybrid)."""
    return paged_cache_supported(cfg) or (
        cfg.has_decode and cfg.attn_window is None
        and (cfg.arch_type in ("ssm", "hybrid")
             or (cfg.arch_type in ("dense", "moe") and cfg.use_mla)))


def cache_names(cfg):
    """The slot-contiguous cache's leaves that the attention blocks write:
    the latent and rope key for MLA, the shared block's k and v for a
    hybrid, none for an attention-free model, k and v otherwise."""
    if cfg.arch_type in ("ssm", "hybrid"):
        return ("attn_k", "attn_v") if cfg.arch_type == "hybrid" else ()
    return ("c", "kr") if cfg.use_mla else ("k", "v")


def _check_dense_kv(cfg) -> None:
    """The slot-contiguous steps cover the reference's standard-attention,
    MLA, ssm and hybrid branches of ``prefill`` / ``decode_step``.  The
    standard branches scan ``blocks`` only: a dense prefix there is
    outside what the reference computes; the MLA branches apply it."""
    if not dense_cache_supported(cfg):
        raise NotImplementedError(f"{cfg.name}: only standard-attention, "
                                  f"MLA and Mamba2 decoders are ported")
    if cfg.is_moe and cfg.first_k_dense and not cfg.use_mla:
        raise ValueError(f"{cfg.name}: the dense-KV steps apply no "
                         f"first_k_dense prefix (as in the reference)")


def init_cache(cfg, batch: int, max_len: int, dtype=None, *,
               device="cuda"):
    """Slot-contiguous decode cache, zeros, in the model dtype (or
    ``dtype``): {'k','v': [L, B, max_len, KVH, hd]}; for MLA the latent
    {'c': [L, B, max_len, r], 'kr': [L, B, max_len, dr]}; for a Mamba2
    model {'conv': [L, B, K-1, d_inner + 2N], 'state': [L, B, H, N, P]
    f32}, and for a hybrid also the shared block's {'attn_k','attn_v':
    [L / attn_every, B, max_len, KVH, hd]}."""
    _check_dense_kv(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    L = cfg.num_layers
    cache = {}
    if cfg.arch_type in ("ssm", "hybrid"):
        conv = cfg.d_inner + 2 * cfg.ssm_state
        cache["conv"] = torch.zeros((L, batch, cfg.ssm_conv - 1, conv),
                                    dtype=dtype, device=dev)
        cache["state"] = torch.zeros((L, batch, cfg.ssm_heads, cfg.ssm_state,
                                      cfg.ssm_head_dim), device=dev)
        L = L // cfg.attn_every if cfg.attn_every else 0
    lead = (L, batch, max_len)
    if cfg.use_mla:
        shapes = ((cfg.kv_lora_rank,), (cfg.qk_rope_dim,))
    else:
        shapes = ((cfg.num_kv_heads, cfg.resolved_head_dim),) * 2
    cache.update({n: torch.zeros(lead + tail, dtype=dtype, device=dev)
                  for n, tail in zip(cache_names(cfg), shapes)})
    return cache


def _cache_slot(cfg, lengths):
    """KV write slot for each sequence (ring-buffered under attn_window)."""
    if cfg.attn_window is None:
        return lengths
    return lengths % cfg.attn_window


def _decode_slots(cfg, cache, lengths):
    """A decode step's (write slot, valid length) per sequence: slot
    ``lengths`` over ``lengths + 1`` positions; a hybrid's shared block
    writes at ``lengths % max_len`` over at most ``max_len``, as the
    reference's hybrid branch does."""
    if cfg.arch_type == "hybrid":
        win = cache["attn_k"].shape[2]
        return lengths % win, (lengths + 1).clamp(max=win)
    return _cache_slot(cfg, lengths), lengths + 1


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
    """Block-pool decode cache: {'k','v': [L, NB, bs, KVH, hd]}, zeros.

    ``kv_dtype="int8"`` (any dtype other than the model's) makes the entry
    pools int8 and adds f32 per-token scale pools {'k_scale','v_scale':
    [L, NB, bs]}.  Every leaf keeps the block axis at axis 1, so the
    engine's copy-on-write and per-block byte accounting move a block's
    scales with its entries.  Any other ``kv_dtype`` raises."""
    if not paged_cache_supported(cfg):
        raise ValueError(f"{cfg.name}: paged KV requires a "
                         f"standard-attention decoder")
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    if kv_dtype is not None and torch_dtype(kv_dtype) != dtype:
        if torch_dtype(kv_dtype) != torch.int8:
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r} (int8 or "
                             f"the model dtype)")
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                       device=dev),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                       device=dev)}
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def write_prefill_to_blocks(cache, dense_cache, block_ids, *, parallel=None,
                            replica: int = 0):
    """Scatter one sequence's prefill KV (``dense_cache`` {'k','v': [L, 1,
    S, KVH, hd]}) into its pool blocks, in place.  ``block_ids`` [S/bs]
    holds the pool row per prompt block; entries == NB drop — the engine
    passes the sentinel for padding blocks and for CoW-shared prefix
    blocks, which hold another live sequence's tokens.  An int8 pool
    quantizes each token row as it is written and scatters its scale
    through the same ids.  Every layer's K and V go in with one
    ``ops.kv_block_write``.  With ``parallel`` the rows go into replica
    ``replica``'s slice of the sharded pool, ``block_ids`` local to it, in
    every copy its TP ranks hold (one write each).  Returns ``cache``."""
    views = [(cache, block_ids)]
    if parallel is not None:
        views = [(local_view(cache, d),
                  block_ids.to(parallel.torch_device(d)))
                 for d in parallel.replica_devices(replica)]
    for pools, ids in views:
        rows = pools["k"].shape[2] * ids.shape[0]
        dev = pools["k"].device
        ops.kv_block_write(pools["k"], pools["v"],
                           dense_cache["k"][:, 0, :rows].to(dev),
                           dense_cache["v"][:, 0, :rows].to(dev), ids,
                           pools.get("k_scale"), pools.get("v_scale"))
    return cache


# ------------------------------------------------------------ DP replicas

HEAD_CUT = ("the head-cutting TP slice (ROADMAP §0 item 4): the reference "
            "shards q, k and v wherever their widths divide by tp, also "
            "inside a head")


def check_tp_heads(cfg, tp: int) -> None:
    """Raise for a TP degree that does not split the query and kv heads
    evenly over the ranks: the port computes head-aligned splits only."""
    if tp > 1 and (cfg.num_heads % tp or cfg.num_kv_heads % tp):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.num_heads} query and {cfg.num_kv_heads} kv "
            f"heads do not split evenly over tp = {tp}; serving where the "
            f"TP split cuts a head is not ported yet: it is {HEAD_CUT}")


def check_mla_heads(cfg, tp: int, devices) -> None:
    """Raise for an f32 MLA model on a card whose TP ranks would each hold
    an odd number of heads: the f32 ``mla_decode_attention`` takes an even
    count only (ROADMAP §3, "MLA head count"), so such a configuration
    would fail at its first decode or capture."""
    heads = cfg.num_heads // tp
    if (cfg.use_mla and cfg.dtype == "float32" and heads % 2
            and any(torch.device(d).type == "cuda" for d in devices)):
        raise NotImplementedError(
            f"{cfg.name}: {heads} heads a rank at tp = {tp}; the f32 MLA "
            f"decode kernel takes an even head count (ROADMAP §3, \"MLA "
            f"head count\"): serve it at bf16 or at a tp that leaves each "
            f"rank an even count")


def _check_parallel(cfg, parallel) -> None:
    if not dense_cache_supported(cfg):
        raise NotImplementedError(f"{cfg.name}: only standard-attention, "
                                  f"MLA and Mamba2 decoders are ported")
    check_tp_heads(cfg, parallel.tp)


def _embed_tp(cfg, tables, tokens, devices):
    """Each rank's embedding: its vocab rows' lookups, zeros for the tokens
    outside them, summed over the ranks (exactly one rank contributes to
    each token); a table the sharding left whole (vocab % tp != 0) is
    looked up by every rank on its own."""
    n = tables[0].shape[0]
    if n == cfg.vocab_size:
        return [F.embedding(tokens.to(d).long(), w)
                for w, d in zip(tables, devices)]
    parts = []
    for t, (w, d) in enumerate(zip(tables, devices)):
        tok = tokens.to(d).long() - t * n
        inside = ((tok >= 0) & (tok < n))[..., None]
        e = F.embedding(tok.clamp(0, n - 1), w)
        parts.append(torch.where(inside, e, torch.zeros((), dtype=e.dtype,
                                                        device=d)))
    return tp_all_reduce(parts, devices)


def _lm_head_tp(cfg, ps, hs, devices):
    """The logits [.., V] on rank 0's device: each rank's vocab columns
    gathered in rank order, or rank 0's whole head where the sharding left
    it whole."""
    if ps[0]["w"].shape[-1] == cfg.vocab_size:
        return linear(ps[0], hs[0])
    return tp_all_gather([linear_cols(p, h, t) for t, (p, h)
                          in enumerate(zip(ps, hs))], devices, -1)[0]


def _attention_tp(cfg, ps, hs, positions, devices, caches=None,
                  write_pos=None, kv_valid_len=None):
    """The layer's self-attention over one replica's TP ranks: MLA
    (``mla_*_tp``) or standard (``layers.attention_apply_tp``), a prefill
    when ``caches`` is None, else a decode step into the ranks' copies;
    returns (the outputs, one per rank, the new k/v or latent of rank 0,
    or the caches)."""
    if not cfg.use_mla:
        return attention_apply_tp(cfg, ps, hs, positions, devices,
                                  caches=caches, write_pos=write_pos,
                                  kv_valid_len=kv_valid_len)
    if caches is None:
        return mla_prefill_tp(cfg, ps, hs, positions, devices)
    return mla_decode_tp(cfg, ps, hs, positions, devices, caches=caches,
                         write_pos=write_pos, kv_valid_len=kv_valid_len)


def _dp_layers(cfg, params, parallel, replicas, tokens, attn, ssm=None):
    """Run the model over row groups, group g on DP replica ``replicas[g]``
    with ``tokens[g]`` [b, S] on its TP rank 0's device: on each of the
    replica's ranks its embedding, then block by block.  An attention
    block runs the ranks' norms and attention shards (``attn(g, cache row,
    the ranks' block params, the ranks' normed inputs, the ranks'
    devices)`` -> the attention output, one copy per rank), then every
    group's feed-forward together — ``moe_ep`` across all logical devices
    in a MoE layer, each group's rows once — and the ranks' MLP shards.
    An SSD block is replicated over the ranks: ``ssm(g, layer, the ranks'
    block params, the ranks' inputs)`` runs it on each rank's copy (from a
    zero state when ``ssm`` is None) -> the block's output, one copy per
    rank.  Returns each group's final-normed hidden states and its ranks'
    parameter views, one per rank."""
    _check_parallel(cfg, parallel)
    ssm = ssm or (lambda g, i, ps, xs: [_ssm_block(cfg, p, x)[0]
                                        for p, x in zip(ps, xs)])
    ranks = [parallel.replica_devices(r) for r in replicas]
    devs = [[parallel.torch_device(d) for d in rk] for rk in ranks]
    local = [[local_view(params, d) for d in rk] for rk in ranks]
    xs = [_embed_tp(cfg, [lp["embed"] for lp in lps], t, dv)
          for lps, t, dv in zip(local, tokens, devs)]
    blocks = [[list(_layers(cfg, lp)) for lp in lps] for lps in local]
    pool = params.get("moe_pool")
    nk = cfg.first_k_dense if cfg.is_moe else 0
    for li, (kind, i, _, moe) in enumerate(blocks[0][0]):
        bps = [[b[li][2] for b in bg] for bg in blocks]
        if kind == "ssm":
            xs = [ssm(g, i, bp, xg) for g, (bp, xg) in enumerate(zip(bps, xs))]
            continue
        hs = []
        for g, (bp, dv) in enumerate(zip(bps, devs)):
            h = [apply_norm(p["ln1"], x, cfg.norm_type)
                 for p, x in zip(bp, xs[g])]
            xs[g] = [x + a for x, a in zip(xs[g], attn(g, i, bp, h, dv))]
            hs.append([apply_norm(p["ln2"], x, cfg.norm_type)
                       for p, x in zip(bp, xs[g])])
        if moe:
            ys = moe_ep(cfg, layer_params(params["blocks"]["moe"], i - nk),
                        hs, parallel, pool=pool, owners=ranks)
        if not moe or cfg.dense_residual:
            mlp = [mlp_apply_tp([p["mlp"] for p in bp], h, dv, cfg.d_ff,
                                cfg.mlp_gated)
                   for bp, h, dv in zip(bps, hs, devs)]
            ys = ([[y + m for y, m in zip(yg, mg)]
                   for yg, mg in zip(ys, mlp)] if moe else mlp)
        xs = [[x + y for x, y in zip(xg, yg)] for xg, yg in zip(xs, ys)]
    return ([[apply_norm(lp["final_norm"], x, cfg.norm_type)
              for lp, x in zip(lps, xg)] for lps, xg in zip(local, xs)],
            local, devs)


def _logits(cfg, local, devs, hs):
    """Each group's logits from its ranks' final hidden states ``hs``."""
    return [_lm_head_tp(cfg, [lp["lm_head"] for lp in lps], h, dv)
            for lps, h, dv in zip(local, hs, devs)]


def _rank_caches(cache, parallel, replica):
    """Replica ``replica``'s cache slice as each of its TP ranks holds a
    copy of it, rank 0 first."""
    return [local_view(cache, d) for d in parallel.replica_devices(replica)]


def _replica_rows(parallel, *ts):
    """Split batch-major tensors into the DP replicas' row groups, each on
    its replica's TP rank 0 device -> (replica ids, [[t rows of replica r]
    ...])."""
    owners = parallel.replicas
    n = ts[0].shape[0] // len(owners)
    return list(range(len(owners))), [
        [t[r * n:(r + 1) * n].to(parallel.torch_device(d)) for t in ts]
        for r, d in enumerate(owners)]


def _gather_rows(parallel, ts):
    """The replicas' row groups as one batch on the first one's device."""
    dev = parallel.torch_device(parallel.replicas[0])
    return torch.cat([t.to(dev) for t in ts])


def _one_replica(parallel, replica, *ts):
    dev = parallel.torch_device(parallel.replicas[replica])
    return dev, [t.to(dev) for t in ts]


# ------------------------------------------------------------------- steps

def forward(cfg, params: Params, batch, *, parallel=None, replica: int = 0):
    """Full-sequence forward: tokens [B,S] -> logits [B,S,V].  Every
    sequence attends causally over its S tokens (``ops.flash_attention``);
    an SSD layer scans them from a zero state (``ops.ssd_scan``).  The
    reference also returns the router's load-balance loss, a training
    term; it is not computed here."""
    if not dense_cache_supported(cfg):
        raise NotImplementedError(f"{cfg.name}: only standard-attention, "
                                  f"MLA and Mamba2 decoders are ported")
    tokens = batch["tokens"]
    B, S = tokens.shape
    if parallel is not None:     # the batch on replica ``replica``
        dev, (tokens,) = _one_replica(parallel, replica, tokens)
        positions = torch.arange(S, device=dev)[None].expand(B, S)
        hs, local, devs = _dp_layers(
            cfg, params, parallel, [replica], [tokens],
            lambda g, i, bp, h, dv: _attention_tp(
                cfg, [p["attn"] for p in bp], h, positions, dv)[0])
        return _logits(cfg, local, devs, hs)[0]
    x = F.embedding(tokens.long(), params["embed"])
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    pool = params.get("moe_pool")
    for kind, _, bp, moe in _layers(cfg, params):
        if kind == "ssm":
            x, _ = _ssm_block(cfg, bp, x)
        else:
            x, _ = _attn_block(cfg, bp, x, positions, moe=moe,
                               moe_pool=pool)
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    return linear(params["lm_head"], x)


def prefill(cfg, params: Params, batch, max_len: int, *, parallel=None,
            replica: int = 0):
    """Monolithic prefill of left-aligned prompts padded to one length.

    batch: tokens [B,S], optional lengths [B] (true prompt lengths).  Every
    position — padding included — attends causally and goes through the
    MoE router, as in the reference (with capacity dropping, padding tokens
    take capacity slots).  Returns (logits [B,V] at position lengths-1,
    cache as ``init_cache`` lays it out, each layer's K/V or latent in its
    first S rows (the last ``max_len`` when S is longer) and zeros
    after).  An SSD layer scans all S tokens, padding included, so its
    cached conv tail and state are those after S tokens, as in the
    reference; decode continues from there.  With ``parallel`` the batch
    runs on replica ``replica``, which holds the returned logits and
    cache."""
    _check_dense_kv(cfg)
    if parallel is not None:
        return _prefill_dp(cfg, params, batch, max_len, parallel, replica)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = F.embedding(tokens.long(), params["embed"])
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    n = min(S, max_len)
    cache = init_cache(cfg, B, max_len, x.dtype, device=x.device)
    pool = params.get("moe_pool")
    names = cache_names(cfg)
    for kind, i, bp, moe in _layers(cfg, params):
        if kind == "ssm":
            x, new = _ssm_block(cfg, bp, x)
            cache["conv"][i] = new["conv"]
            cache["state"][i] = new["state"]
            continue
        x, kv = _attn_block(cfg, bp, x, positions, moe=moe, moe_pool=pool)
        for name, new in zip(names, kv):
            cache[name][i, :, :n] = new[:, S - n:]
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    lengths = batch.get("lengths")
    if lengths is None:
        last = x[:, -1]
    else:
        last = x[torch.arange(B, device=x.device), lengths.long() - 1]
    return linear(params["lm_head"], last), cache


def _prefill_dp(cfg, params, batch, max_len, parallel, replica):
    """The prefill on replica ``replica``: the returned cache (all heads,
    every leaf of ``init_cache``: k/v or the latent, an SSD layer's conv
    tail and state, a hybrid's shared-block k/v) lies on its TP rank 0's
    device, written from rank 0's results; the caller writes it into every
    rank's copy."""
    tokens, lengths = batch["tokens"], batch.get("lengths")
    B, S = tokens.shape
    dev, (tokens,) = _one_replica(parallel, replica, tokens)
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    n = min(S, max_len)
    cache = init_cache(cfg, B, max_len, params["embed"].dtype, device=dev)
    names = cache_names(cfg)

    def attn(g, i, bp, h, dv):
        a, kv = _attention_tp(cfg, [p["attn"] for p in bp], h, positions, dv)
        for name, new in zip(names, kv):
            cache[name][i, :, :n] = new[:, S - n:]
        return a

    def ssm(g, i, ps, xs):
        outs = [_ssm_block(cfg, p, x) for p, x in zip(ps, xs)]
        cache["conv"][i] = outs[0][1]["conv"]
        cache["state"][i] = outs[0][1]["state"]
        return [y for y, _ in outs]
    hs, local, devs = _dp_layers(cfg, params, parallel, [replica], [tokens],
                                 attn, ssm)
    if lengths is None:
        last = [x[:, -1] for x in hs[0]]
    else:
        last = [x[torch.arange(B, device=x.device),
                  lengths.to(x.device).long() - 1] for x in hs[0]]
    return _logits(cfg, local, devs, [last])[0], cache


def decode_step(cfg, params: Params, tokens, cache, lengths, *,
                parallel=None):
    """One decode step over the slot-contiguous cache.  tokens [B,1];
    lengths [B] int32 = tokens already cached: the new token's k/v (MLA:
    latent rows) land at slot ``lengths`` (``ops.kv_cache_write_pair``; past
    the cache they drop) and it attends ``lengths + 1`` positions
    (``ops.paged_decode_attention``; MLA: ``ops.mla_decode_attention``).
    An SSD layer takes one recurrent step from its cached conv tail and
    state; a hybrid's shared block writes at ``lengths % max_len`` and
    attends ``min(lengths + 1, max_len)`` positions, as the reference's
    hybrid branch does.  Updates ``cache`` in place; returns (logits
    [B,V], cache).  With ``parallel`` each replica decodes its own slots
    over its slice of the cache."""
    _check_dense_kv(cfg)
    names = cache_names(cfg)
    if parallel is not None:
        groups, rows = _replica_rows(parallel, tokens, lengths)
        caches = [_rank_caches(cache, parallel, r) for r in groups]
        slots = [_decode_slots(cfg, caches[g][0], lens)
                 for g, (_, lens) in enumerate(rows)]

        def attn(g, i, bp, h, dv):
            return _attention_tp(
                cfg, [p["attn"] for p in bp], h, rows[g][1][:, None], dv,
                caches=[tuple(c[n][i] for n in names) for c in caches[g]],
                write_pos=slots[g][0], kv_valid_len=slots[g][1])[0]

        def ssm(g, i, ps, xs):
            out = []
            for p, x, c in zip(ps, xs, caches[g]):
                y, new = _ssm_block(cfg, p, x, {"conv": c["conv"][i],
                                                "state": c["state"][i]})
                c["conv"][i] = new["conv"]
                c["state"][i] = new["state"]
                out.append(y)
            return out
        hs, local, devs = _dp_layers(cfg, params, parallel, groups,
                                     [r[0] for r in rows], attn, ssm)
        return _gather_rows(parallel, _logits(
            cfg, local, devs, [[x[:, 0] for x in h] for h in hs])), cache
    x = F.embedding(tokens.long(), params["embed"])
    positions = lengths[:, None]
    write_pos, valid = _decode_slots(cfg, cache, lengths)
    pool = params.get("moe_pool")
    for kind, i, bp, moe in _layers(cfg, params):
        if kind == "ssm":
            x, new = _ssm_block(cfg, bp, x, {"conv": cache["conv"][i],
                                             "state": cache["state"][i]})
            cache["conv"][i] = new["conv"]
            cache["state"][i] = new["state"]
            continue
        x, _ = _attn_block(cfg, bp, x, positions, moe=moe, moe_pool=pool,
                           cache=tuple(cache[n][i] for n in names),
                           write_pos=write_pos, kv_valid_len=valid)
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    return linear(params["lm_head"], x[:, 0]), cache


def paged_decode_step(cfg, params: Params, tokens, cache, lengths,
                      block_tables, write_block, *, parallel=None):
    """One decode step over the paged KV pool.  tokens [B,1]; lengths [B]
    int32 (tokens already cached); block_tables [B,MB] int32; write_block
    [B] int32 = row receiving this token's k/v (``NB`` for inactive slots
    -> dropped).  Updates ``cache`` in place; returns (logits [B,V],
    cache).  With ``parallel`` each replica decodes its own slots over its
    pool slice: its rows' tables, write blocks and ``NB`` are local to
    it."""
    if parallel is not None:
        groups, rows = _replica_rows(parallel, tokens, lengths, block_tables,
                                     write_block)
        caches = [_rank_caches(cache, parallel, r) for r in groups]

        def attn(g, i, bp, h, dv):
            _, lens, bt, wb = rows[g]
            return paged_attention_apply_tp(
                cfg, [p["attn"] for p in bp], h, lens[:, None], dv,
                caches=[{n: v[i] for n, v in c.items()} for c in caches[g]],
                block_tables=bt, write_block=wb, lengths=lens)[0]
        hs, local, devs = _dp_layers(cfg, params, parallel, groups,
                                     [r[0] for r in rows], attn)
        return _gather_rows(parallel, _logits(
            cfg, local, devs, [[x[:, 0] for x in h] for h in hs])), cache
    x = F.embedding(tokens.long(), params["embed"])
    positions = lengths[:, None]
    pool = params.get("moe_pool")
    for _, i, bp, moe in _layers(cfg, params):
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


def paged_chunk_prefill_step(cfg, params: Params, tokens, cache, start,
                             length, block_tables, chunk_block_ids, *,
                             parallel=None, replica: int = 0):
    """One chunked-prefill step for a single sequence over the paged pool.

    tokens [1,C] — one prompt chunk at positions start..start+C-1 (rows at
    or beyond the prompt length are padding); ``start`` = chunk offset
    (block-aligned); ``length`` = context tokens after this chunk; both [1]
    int32 tensors on the tokens' device, as a captured CUDA graph reads
    them (a Python int is filled into one); block_tables [1,MB] = the
    sequence's table; chunk_block_ids [C/bs] = pool rows receiving this
    chunk's k/v (``NB`` for padding / CoW-shared rows -> dropped).  Updates
    ``cache`` in place; returns (logits [1,V] at position ``length-1``,
    gathered by a device index, cache).  With ``parallel`` the sequence
    belongs to replica ``replica``: its table and ids are local to that
    replica's pool slice."""
    C = tokens.shape[1]
    dev = tokens.device
    # fills, not copies from host memory: the step never syncs
    start, length = (
        v if torch.is_tensor(v)
        else torch.full((1,), int(v), dtype=torch.int32, device=dev)
        for v in (start, length))
    if parallel is not None:
        dev, (tokens, block_tables, chunk_block_ids, start, length) = \
            _one_replica(parallel, replica, tokens, block_tables,
                         chunk_block_ids, start, length)
    start = start.reshape(1).to(torch.int32)
    ctx_t = length.reshape(1).to(torch.int32)
    positions = start[:, None] + torch.arange(C, device=dev,
                                              dtype=torch.int32)[None]
    qlen_t = ctx_t - start
    # the logits row of the last valid position, q_len - 1
    last = (qlen_t - 1).long()
    if parallel is not None:
        copies = _rank_caches(cache, parallel, replica)

        def attn(g, i, bp, h, dv):
            return paged_chunk_attention_apply_tp(
                cfg, [p["attn"] for p in bp], h, positions, dv,
                caches=[{n: v[i] for n, v in c.items()} for c in copies],
                block_tables=block_tables, chunk_block_ids=chunk_block_ids,
                ctx_len=ctx_t, q_len=qlen_t)[0]
        hs, local, devs = _dp_layers(cfg, params, parallel, [replica],
                                     [tokens], attn)
        return _logits(cfg, local, devs,
                       [[x.index_select(1, last.to(x.device))[:, 0]
                         for x in hs[0]]])[0], cache
    x = F.embedding(tokens.long(), params["embed"])
    pool = params.get("moe_pool")
    for _, i, bp, moe in _layers(cfg, params):
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
    return linear(params["lm_head"], x.index_select(1, last)[:, 0]), cache
