"""Standard-attention and MLA decoders (dense or MoE) and the Mamba2
models — the port of the serving steps of ``repro.models.model`` over the
two KV layouts: the paged pool (``paged_decode_step``,
``paged_chunk_prefill_step``; standard attention only, as in the
reference) and the slot-contiguous cache of the dense-KV mode
(``prefill``, ``decode_step``, and for standard attention
``chunk_prefill_step``; ``write_prefill_to_blocks`` moves a monolithic
prefill into the pool), plus the full-sequence ``forward`` and the
training loss ``loss_fn`` (the attention decoders on one device, over
dense expert banks; ``training/train_loop.py`` differentiates it).  An
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
to its jitted steps) and return the same dict.  With ``collect_routing``
the two decode steps also return the routing histogram's sample: each MoE
layer's per-expert token counts ``[L_moe, E]`` int32 (the dense-prefix
layers have no router and give no row; standard-attention MoE models
only, ``routing_stats_supported``).

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
as standard attention does, also where tp cuts a head, and so does an
MLA layer (``mla``'s module note); the paged steps stay
standard-attention only.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.distributed.sharding import (local_view, tp_all_gather,
                                              tp_all_reduce)
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_norm, attention_apply,
                                       attention_apply_tp, attention_init,
                                       chunk_attention_apply_tp, linear,
                                       linear_cols, linear_init, mlp_apply,
                                       mlp_apply_tp, mlp_init, norm_init,
                                       paged_attention_apply,
                                       paged_attention_apply_tp,
                                       paged_chunk_attention_apply_tp)
from repro_torch.models.mamba2 import (mamba2_decode, mamba2_forward,
                                       mamba2_init)
from repro_torch.models.mla import (heads_a_rank, mla_decode,
                                    mla_decode_tp, mla_init, mla_prefill,
                                    mla_prefill_tp)
from repro_torch.models.moe import (moe_ep, moe_local, moe_local_pooled,
                                    router_init)

Params = Dict[str, Any]


# ------------------------------------------------------------------ builders

def _block_init(gen, cfg, dtype, device, *, moe: bool, lead=(),
                cross: bool = False):
    """One block's parameters (stacked over ``lead``); a VLM's ``cross``
    block adds the cross-attention ``xattn``, its norm ``lnx`` and its
    gate ``xgate`` [1], zeros as in the reference (``tanh(0) = 0``: at
    init the image does not enter)."""
    attn = mla_init if cfg.use_mla else attention_init
    p = {"ln1": norm_init(cfg.d_model, cfg.norm_type, dtype, device, lead),
         "ln2": norm_init(cfg.d_model, cfg.norm_type, dtype, device, lead),
         "attn": attn(gen, cfg, dtype, device, lead)}
    if cross:
        p["xattn"] = attention_init(gen, cfg, dtype, device, lead)
        p["lnx"] = norm_init(cfg.d_model, cfg.norm_type, dtype, device, lead)
        p["xgate"] = torch.zeros(*lead, 1, dtype=dtype, device=device)
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


def init_params(cfg, seed: int = 0, *, device="cuda", dtype=None,
                experts: bool = False) -> Params:
    """Random parameters drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed`` (not the reference's numbers: the tests convert
    the reference's parameters with ``convert.params_from_jax`` instead).

    MoE layers get the router but no routed experts: ``HMM.boot`` fills the
    dense banks or the pooled store layer by layer with
    ``init_expert_bank``, so the experts are never held twice.  With
    ``experts`` (training, which owns its weights) the dense banks
    ``blocks/moe/{wi, wg, wo}`` [L, E, D, F|D] are drawn here, one layer at
    a time from a generator seeded with ``seed + 1``, the numbers the
    HMM's dense boot draws.  The Mamba2
    models get stacked SSD blocks and, a hybrid, one shared attention
    block.  A VLM's ``blocks`` are its ``num_layers - ncross`` self
    layers and ``cross_blocks`` its ``ncross = num_layers /
    cross_attn_every`` cross layers, one leading each group; an encoder
    has no ``embed`` (its frames arrive embedded)."""
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    p: Params = {"final_norm": norm_init(cfg.d_model, cfg.norm_type, dtype,
                                         dev)}
    if cfg.arch_type != "encoder":
        p["embed"] = torch.randn(cfg.vocab_size, cfg.d_model, generator=gen,
                                 device=dev,
                                 dtype=torch.float32).mul_(0.02).to(dtype)
    p["lm_head"] = linear_init(gen, cfg.d_model, cfg.vocab_size, dtype, dev)
    if cfg.arch_type in ("ssm", "hybrid"):
        lead = (cfg.num_layers,)
        p["blocks"] = {"ln": norm_init(cfg.d_model, cfg.norm_type, dtype,
                                       dev, lead),
                       "ssm": mamba2_init(gen, cfg, dtype, dev, lead)}
        if cfg.arch_type == "hybrid":
            p["shared_attn"] = _block_init(gen, cfg, dtype, dev, moe=False)
        return p
    if cfg.arch_type == "vlm":
        ncross = cfg.num_layers // cfg.cross_attn_every
        p["blocks"] = _block_init(gen, cfg, dtype, dev, moe=False,
                                  lead=(cfg.num_layers - ncross,))
        p["cross_blocks"] = _block_init(gen, cfg, dtype, dev, moe=False,
                                        lead=(ncross,), cross=True)
        return p
    nk = cfg.first_k_dense if cfg.is_moe else 0
    if nk:
        p["dense_prefix"] = [_block_init(gen, cfg, dtype, dev, moe=False)
                             for _ in range(nk)]
    p["blocks"] = _block_init(gen, cfg, dtype, dev, moe=cfg.is_moe,
                              lead=(cfg.num_layers - nk,))
    if experts and cfg.is_moe:
        moe, L = p["blocks"]["moe"], cfg.num_layers - nk
        banks = torch.Generator(device=dev)
        banks.manual_seed(seed + 1)
        for l in range(L):
            for name, t in init_expert_bank(cfg, banks, dtype, dev).items():
                if name not in moe:
                    moe[name] = t.new_empty((L, *t.shape))
                moe[name][l] = t
    return p


def layer_params(tree, i: int):
    """Layer ``i``'s view of stacked per-layer leaves."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


# -------------------------------------------------------------- block apply

def _ffn_part(cfg, bp, h, *, moe: bool, moe_pool=None, counts=None,
              aux=None):
    """Post-attention feed-forward: the dense MLP, or the MoE over the
    pooled expert store ``moe_pool`` (``bp["moe"]`` carries its page-table
    index arrays) or over the layer's dense banks ``bp["moe"]["wi"/"wg"/
    "wo"]``.  A MoE layer appends its routing counts [E] to the list
    ``counts``, and over dense banks its router's aux loss to the list
    ``aux``, when one is given."""
    if not moe:
        return mlp_apply(bp["mlp"], h, cfg.mlp_gated)
    B, S, D = h.shape
    x = h.reshape(B * S, D)
    want = counts is not None
    if moe_pool is not None and "gtable" in bp["moe"]:
        y = moe_local_pooled(cfg, bp["moe"], moe_pool, x,
                             return_counts=want)
    else:
        y = moe_local(cfg, bp["moe"], x, return_counts=want, aux=aux)
    if want:
        y, c = y
        counts.append(c)
    y = y.reshape(B, S, D)
    if cfg.dense_residual:
        y = y + mlp_apply(bp["mlp"], h, cfg.mlp_gated)
    return y


def _layers(cfg, params):
    """(kind, cache row, block params, is_moe) per block, in order.  An
    attention decoder's blocks are all "attn", dense prefix first, cache
    row = layer.  A Mamba2 model's are "ssm" (cache row = layer); a hybrid
    applies its shared "attn" block at the head of every group of
    ``attn_every`` layers (cache row = group).  A VLM's group g of
    ``cross_attn_every`` layers is its cross block ("cross", cache row g
    * every: the cross layer's self-attention; image row g) and then
    ``every - 1`` self blocks, the reference's cache row order."""
    if cfg.arch_type == "vlm":
        every = cfg.cross_attn_every
        for g in range(cfg.num_layers // every):
            yield "cross", g * every, layer_params(params["cross_blocks"],
                                                   g), False
            for j in range(every - 1):
                yield "attn", g * every + 1 + j, layer_params(
                    params["blocks"], g * (every - 1) + j), False
        return
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
                counts=None, aux=None, image_x=None, image_kv=None,
                **cache_kw):
    """Self-attention and the feed-forward, each with its residual ->
    (x', the attention's new k/v, latent or cache, the image k/v); a MoE
    layer appends its routing counts to ``counts`` and its aux loss to
    ``aux`` when given.  A VLM's
    cross block (``xattn``) attends the image after its self-attention,
    non-causal and without rope: the cached ``image_kv`` at decode, else
    ``image_x`` [B,T,D] (or, where no image is given, its own normed
    input, as the reference's ``kv_x=None`` does), and adds
    ``tanh(xgate)`` times it."""
    h = apply_norm(bp["ln1"], x, cfg.norm_type)
    a, kv = _attention(cfg, bp, h, positions, **cache_kw)
    x = x + a
    img = image_kv
    if "xattn" in bp:
        hx = apply_norm(bp["lnx"], x, cfg.norm_type)
        if image_kv is not None:
            cx, _ = attention_apply(cfg, bp["xattn"], hx, positions,
                                    cache=image_kv)
        else:
            cx, img = attention_apply(
                cfg, bp["xattn"], hx, positions,
                kv_x=hx if image_x is None else image_x)
        x = x + torch.tanh(bp["xgate"]) * cx
    h = apply_norm(bp["ln2"], x, cfg.norm_type)
    return x + _ffn_part(cfg, bp, h, moe=moe, moe_pool=moe_pool,
                         counts=counts, aux=aux), kv, img


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
    (dense, MoE and the VLM, also under a sliding window), the MLA
    decoders (dense and MoE) and the Mamba2 models (attention-free and
    hybrid); the last two without a window."""
    if not cfg.has_decode:
        return False
    if cfg.arch_type == "vlm" or (cfg.arch_type in ("dense", "moe")
                                  and not cfg.use_mla):
        return True
    return cfg.attn_window is None and cfg.arch_type in ("dense", "moe",
                                                         "ssm", "hybrid")


def cache_names(cfg):
    """The slot-contiguous cache's leaves that the attention blocks write:
    the latent and rope key for MLA, the shared block's k and v for a
    hybrid, none for an attention-free model, k and v otherwise."""
    if cfg.arch_type in ("ssm", "hybrid"):
        return ("attn_k", "attn_v") if cfg.arch_type == "hybrid" else ()
    return ("c", "kr") if cfg.use_mla else ("k", "v")


def _check_dense_kv(cfg) -> None:
    """The slot-contiguous steps cover the reference's standard-attention
    (windowed too), VLM, MLA, ssm and hybrid branches of ``prefill`` /
    ``decode_step``.  The standard branches scan ``blocks`` only: a dense
    prefix there is outside what the reference computes; the MLA branches
    apply it.  An encoder has no decode, as in the reference."""
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name} is encoder-only (no decode)")
    if not dense_cache_supported(cfg):
        raise NotImplementedError(f"{cfg.name}: a sliding window is ported "
                                  f"for standard attention only")
    if cfg.is_moe and cfg.first_k_dense and not cfg.use_mla:
        raise ValueError(f"{cfg.name}: the dense-KV steps apply no "
                         f"first_k_dense prefix (as in the reference)")


def init_cache(cfg, batch: int, max_len: int, dtype=None, *,
               device="cuda"):
    """Slot-contiguous decode cache, zeros, in the model dtype (or
    ``dtype``): {'k','v': [L, B, rows, KVH, hd]}, rows = max_len, or
    ``min(max_len, attn_window)`` under a window (a ring); a VLM adds the
    image's {'img_k','img_v': [L / cross_attn_every, B, num_image_tokens,
    KVH, hd]}; for MLA the latent {'c': [L, B, max_len, r], 'kr': [L, B,
    max_len, dr]}; for a Mamba2 model {'conv': [L, B, K-1, d_inner + 2N],
    'state': [L, B, H, N, P] f32}, and for a hybrid also the shared
    block's {'attn_k','attn_v': [L / attn_every, B, max_len, KVH, hd]}."""
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
    rows = max_len
    if cfg.attn_window is not None and cfg.arch_type in ("dense", "moe",
                                                         "vlm"):
        rows = min(max_len, cfg.attn_window)
    lead = (L, batch, rows)
    if cfg.use_mla:
        shapes = ((cfg.kv_lora_rank,), (cfg.qk_rope_dim,))
    else:
        shapes = ((cfg.num_kv_heads, cfg.resolved_head_dim),) * 2
    cache.update({n: torch.zeros(lead + tail, dtype=dtype, device=dev)
                  for n, tail in zip(cache_names(cfg), shapes)})
    if cfg.arch_type == "vlm":
        img = (cfg.num_layers // cfg.cross_attn_every, batch,
               cfg.num_image_tokens) + shapes[0]
        cache["img_k"] = torch.zeros(img, dtype=dtype, device=dev)
        cache["img_v"] = torch.zeros(img, dtype=dtype, device=dev)
    return cache


def _decode_slots(cfg, cache, lengths):
    """A decode step's (write slot, valid length) per sequence: slot
    ``lengths`` over ``lengths + 1`` positions.  A ring of ``rows`` slots
    (the cache's rows: a hybrid's shared block, and standard attention
    under a window, whose rows are ``min(max_len, W)``, or a VLM's
    ``max_len``, which its prefill writes whole) is written at ``lengths %
    rows`` over at most ``rows``, as the reference's branches do; under a
    window the attention also drops the slots below ``lengths - W + 1``
    (``layers._decode_range``)."""
    name = "attn_k" if cfg.arch_type == "hybrid" else "k"
    if cfg.arch_type == "hybrid" or cfg.attn_window is not None:
        win = cache[name].shape[2]
        return lengths % win, (lengths + 1).clamp(max=win)
    return lengths, lengths + 1


def routing_stats_supported(cfg) -> bool:
    """The decode steps' routing telemetry covers the standard-attention
    MoE decoders (no MLA, no attention window), as in the reference."""
    return (cfg.has_decode and cfg.arch_type == "moe"
            and not cfg.use_mla and cfg.attn_window is None)


def _check_routing(cfg) -> list:
    """A fresh counts list for a step with ``collect_routing``."""
    if not routing_stats_supported(cfg):
        raise ValueError(f"{cfg.name}: routing telemetry unsupported")
    return []


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

def check_mla_heads(cfg, tp: int, devices) -> None:
    """Raise for an f32 MLA model on a card where a TP rank would attend
    an odd number of heads (``mla.heads_a_rank``: H / tp, or where tp cuts
    a head the heads covering the rank's output columns): the f32
    ``mla_decode_attention`` takes an even count only (ROADMAP §3, "MLA
    head count"), so such a configuration would fail at its first decode
    or capture."""
    odd = [n for n in (heads_a_rank(cfg, tp) if cfg.use_mla else ())
           if n % 2]
    if (odd and cfg.dtype == "float32"
            and any(torch.device(d).type == "cuda" for d in devices)):
        heads = odd[0]
        raise NotImplementedError(
            f"{cfg.name}: {heads} heads a rank at tp = {tp}; the f32 MLA "
            f"decode kernel takes an even head count (ROADMAP §3, \"MLA "
            f"head count\"): serve it at bf16 or at a tp that leaves each "
            f"rank an even count")


def _check_parallel(cfg) -> None:
    """The steps over several logical devices cover the decoders of
    ``dense_cache_supported`` without a window; the VLM's cross-attention
    and a sliding window run on one device (ROADMAP §1 item 6)."""
    if cfg.arch_type in ("vlm", "encoder") or cfg.attn_window is not None:
        raise NotImplementedError(
            f"{cfg.name}: cross-attention, the encoder and a sliding window "
            f"run on one device only (ROADMAP §1 item 6)")
    if not dense_cache_supported(cfg):
        raise NotImplementedError(f"{cfg.name}: only standard-attention, "
                                  f"MLA and Mamba2 decoders are ported")


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


def _dp_layers(cfg, params, parallel, replicas, tokens, attn, ssm=None,
               counts=None):
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
    rank.  A MoE layer appends its routing counts [E] (on the first
    logical device) to ``counts`` when given.  Returns each group's
    final-normed hidden states and its ranks' parameter views, one per
    rank."""
    _check_parallel(cfg)
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
                        hs, parallel, pool=pool, owners=ranks,
                        return_counts=counts is not None)
            if counts is not None:
                ys, c = ys
                counts.append(c)
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
    """Full-sequence forward: tokens [B,S] (an encoder's frames [B,S,D])
    -> logits [B,S,V].  Every sequence attends over its S tokens
    (``ops.flash_attention``), causally unless the config says not (the
    encoder), within ``attn_window`` where one is set; a VLM's cross
    blocks also attend ``batch["image_embeds"]`` [B,T,D]; an SSD layer
    scans the tokens from a zero state (``ops.ssd_scan``).  The
    reference's forward also returns the router's load-balance loss, a
    training term: :func:`train_forward` returns it."""
    if cfg.arch_type != "encoder" and not dense_cache_supported(cfg):
        raise NotImplementedError(f"{cfg.name}: a sliding window is ported "
                                  f"for standard attention only")
    if cfg.arch_type == "encoder":
        if parallel is not None:
            _check_parallel(cfg)
        x = batch["frames"]
        return _forward_one(cfg, params, x, batch)
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
    return _forward_one(cfg, params, F.embedding(tokens.long(),
                                                 params["embed"]), batch)


def _forward_one(cfg, params, x, batch, remat=False, aux=None):
    """:func:`forward` on one device from the embedded input x [B,S,D];
    each MoE block's aux loss goes to the list ``aux`` where one is given,
    and each attention block runs checkpointed under ``remat``."""
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    pool = params.get("moe_pool")
    for kind, _, bp, moe in _layers(cfg, params):
        if kind == "ssm":
            x, _ = _ssm_block(cfg, bp, x)
            continue

        def block(x, bp=bp, moe=moe, kind=kind):
            a = []
            y = _attn_block(cfg, bp, x, positions, moe=moe, moe_pool=pool,
                            aux=None if aux is None else a,
                            image_x=(batch["image_embeds"]
                                     if kind == "cross" else None))[0]
            return (y, *a)
        out = (checkpoint(block, x, use_reentrant=False,
                          context_fn=ops.reference_contexts)
               if remat else block(x))
        x = out[0]
        if aux is not None:
            aux.extend(out[1:])
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    return linear(params["lm_head"], x)


def train_forward(cfg, params: Params, batch, *, parallel=None,
                  remat: bool = True):
    """The reference's training ``forward`` for the decoders
    ``_check_train`` takes: tokens [B,S] -> (logits [B,S,V], aux), aux the
    routers' load-balance losses summed over the MoE blocks in order from
    an f32 zero (the dense prefix adds none).  ``remat`` runs each block
    under ``torch.utils.checkpoint`` (non-reentrant), which keeps its
    input only and runs it again in the backward, as the reference's
    ``jax.checkpoint`` does."""
    _check_train(cfg, params, parallel)
    aux = []
    logits = _forward_one(cfg, params, F.embedding(
        batch["tokens"].long(), params["embed"]), batch, remat, aux)
    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    for a in aux:
        total = total + a
    return logits, total


def _check_train(cfg, params, parallel) -> None:
    """Training covers the attention decoders — standard attention and
    MLA, dense and MoE over dense expert banks — on one device and
    without a window: the others need a backward that is not ported
    (ROADMAP §1 item 7)."""
    if parallel is not None:
        why = "training over logical devices (parallel)"
    elif cfg.arch_type in ("ssm", "hybrid"):
        why = f"{cfg.arch_type} training (a backward for ssd_scan)"
    elif cfg.arch_type in ("vlm", "encoder"):
        why = (f"{cfg.arch_type} training (a flash backward that is not "
               f"causal or attends other keys)")
    elif cfg.attn_window is not None:
        why = "training under a window (a windowed flash backward)"
    elif "moe_pool" in params:
        why = "training over the pooled expert store"
    else:
        return
    raise NotImplementedError(f"{cfg.name}: {why} is not ported (ROADMAP "
                              f"§1 item 7)")


def loss_fn(cfg, params: Params, batch, *, parallel=None, remat=True):
    """The reference's training loss: the mean next-token NLL of the
    logits in f32 (``log_softmax``, the labels gathered), over
    ``batch["loss_mask"]``'s tokens where one is given, plus
    ``cfg.router_aux_coef`` times the summed router aux loss."""
    logits, aux = train_forward(cfg, params, batch, parallel=parallel,
                                remat=remat)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, batch["labels"].long()[..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is None:
        loss = nll.mean()
    else:
        mask = mask.to(nll.dtype)
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + cfg.router_aux_coef * aux


def prefill(cfg, params: Params, batch, max_len: int, *, parallel=None,
            replica: int = 0):
    """Monolithic prefill of left-aligned prompts padded to one length.

    batch: tokens [B,S], optional lengths [B] (true prompt lengths).  Every
    position — padding included — attends causally and goes through the
    MoE router, as in the reference (with capacity dropping, padding tokens
    take capacity slots).  Returns (logits [B,V] at position lengths-1,
    cache as ``init_cache`` lays it out, each layer's K/V or latent in its
    first S rows (the last ``rows`` when S is longer: a window's ring
    keeps the last ``min(max_len, W)``, as the reference does) and zeros
    after).  An SSD layer scans all S tokens, padding included, so its
    cached conv tail and state are those after S tokens, as in the
    reference; decode continues from there.  A VLM's cross blocks attend
    ``batch["image_embeds"]`` [B,T,D] and cache its k/v in ``img_k`` /
    ``img_v``; as in the reference its self k/v fill ``max_len`` rows
    whatever the window (a prompt longer than ``max_len`` raises), and
    without image embeddings each cross block attends its own normed
    input, whose S rows its image leaves then hold (ROADMAP §3, "The VLM
    server").  With ``parallel`` the batch runs on replica ``replica``,
    which holds the returned logits and cache."""
    _check_dense_kv(cfg)
    if parallel is not None:
        return _prefill_dp(cfg, params, batch, max_len, parallel, replica)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = F.embedding(tokens.long(), params["embed"])
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    cache = init_cache(cfg, B, max_len, x.dtype, device=x.device)
    pool = params.get("moe_pool")
    names = cache_names(cfg)
    img, image_kv = batch.get("image_embeds"), []
    if cfg.arch_type == "vlm":
        if S > max_len:
            raise ValueError(f"a VLM prompt of {S} tokens does not fit "
                             f"max_len {max_len} (as in the reference)")
        for name in names:
            cache[name] = x.new_zeros(cache[name].shape[:2] + (max_len,)
                                      + cache[name].shape[3:])
    rows = cache[names[0]].shape[2] if names else 0
    n = min(S, rows)
    for kind, i, bp, moe in _layers(cfg, params):
        if kind == "ssm":
            x, new = _ssm_block(cfg, bp, x)
            cache["conv"][i] = new["conv"]
            cache["state"][i] = new["state"]
            continue
        x, kv, ikv = _attn_block(cfg, bp, x, positions, moe=moe,
                                 moe_pool=pool,
                                 image_x=img if kind == "cross" else None)
        if kind == "cross":
            image_kv.append(ikv)
        for name, new in zip(names, kv):
            cache[name][i, :, :n] = new[:, S - n:]
    if image_kv:
        cache["img_k"] = torch.stack([k for k, _ in image_kv]).to(x.dtype)
        cache["img_v"] = torch.stack([v for _, v in image_kv]).to(x.dtype)
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
    _check_parallel(cfg)
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
                parallel=None, collect_routing=False):
    """One decode step over the slot-contiguous cache.  tokens [B,1];
    lengths [B] int32 = tokens already cached: the new token's k/v (MLA:
    latent rows) land at slot ``lengths`` (``ops.kv_cache_write_pair``; past
    the cache they drop) and it attends ``lengths + 1`` positions
    (``ops.paged_decode_attention``; MLA: ``ops.mla_decode_attention``).
    An SSD layer takes one recurrent step from its cached conv tail and
    state; a hybrid's shared block writes at ``lengths % max_len`` and
    attends ``min(lengths + 1, max_len)`` positions, as the reference's
    hybrid branch does, and so does a windowed ring (``_decode_slots``).
    A VLM's cross blocks also attend their cached image k/v.  Updates ``cache`` in place; returns (logits
    [B,V], cache), and with ``collect_routing`` the routing counts
    [L_moe, E].  With ``parallel`` each replica decodes its own slots over
    its slice of the cache."""
    _check_dense_kv(cfg)
    counts = _check_routing(cfg) if collect_routing else None
    names = cache_names(cfg)
    if parallel is not None:
        _check_parallel(cfg)
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
                                     [r[0] for r in rows], attn, ssm,
                                     counts)
        return _routed(_gather_rows(parallel, _logits(
            cfg, local, devs, [[x[:, 0] for x in h] for h in hs])), cache,
            counts)
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
        image_kv = None
        if kind == "cross":
            g = i // cfg.cross_attn_every
            image_kv = (cache["img_k"][g], cache["img_v"][g])
        x = _attn_block(cfg, bp, x, positions, moe=moe, moe_pool=pool,
                        counts=counts, image_kv=image_kv,
                        cache=tuple(cache[n][i] for n in names),
                        write_pos=write_pos, kv_valid_len=valid)[0]
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    return _routed(linear(params["lm_head"], x[:, 0]), cache, counts)


def _routed(logits, cache, counts):
    """A decode step's result: (logits, cache), and the stacked routing
    counts [L_moe, E] when the step collected them."""
    if counts is None:
        return logits, cache
    return logits, cache, torch.stack(counts)


def paged_decode_step(cfg, params: Params, tokens, cache, lengths,
                      block_tables, write_block, *, parallel=None,
                      collect_routing=False):
    """One decode step over the paged KV pool.  tokens [B,1]; lengths [B]
    int32 (tokens already cached); block_tables [B,MB] int32; write_block
    [B] int32 = row receiving this token's k/v (``NB`` for inactive slots
    -> dropped).  Updates ``cache`` in place; returns (logits [B,V],
    cache), and with ``collect_routing`` the routing counts [L_moe, E].
    With ``parallel`` each replica decodes its own slots over its pool
    slice: its rows' tables, write blocks and ``NB`` are local to it."""
    counts = _check_routing(cfg) if collect_routing else None
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
                                     [r[0] for r in rows], attn,
                                     counts=counts)
        return _routed(_gather_rows(parallel, _logits(
            cfg, local, devs, [[x[:, 0] for x in h] for h in hs])), cache,
            counts)
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
        x = x + _ffn_part(cfg, bp, h, moe=moe, moe_pool=pool, counts=counts)
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    return _routed(linear(params["lm_head"], x[:, 0]), cache, counts)


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
    def attn(ps, hs, positions, devs, caches, start, ctx, bt, ids):
        return paged_chunk_attention_apply_tp(
            cfg, ps, hs, positions, devs, caches=caches, block_tables=bt,
            chunk_block_ids=ids, ctx_len=ctx, q_len=ctx - start)[0]
    return _chunk_step(cfg, params, tokens, cache, start, length,
                       (block_tables, chunk_block_ids), attn,
                       parallel=parallel, replica=replica)


def chunk_prefill_step(cfg, params: Params, tokens, cache, start, length,
                       slot, *, parallel=None, replica: int = 0):
    """Dense-layout twin of :func:`paged_chunk_prefill_step`: the chunk's
    k/v land in row ``slot`` of the slot-contiguous cache {'k','v':
    [L,B,S_max,KVH,hd]} at positions [start, start+C) (moved back onto the
    row's last C positions where they would run past it, as the
    reference's ``dynamic_update_slice`` moves them), and the chunk
    attends causally over the row (``layers.chunk_attention_apply_tp``:
    the mixed kernel over the row viewed as pool blocks).  ``start``,
    ``length`` and ``slot`` are [1] int32 tensors (a Python int is filled
    into one).  With ``parallel`` the row is local to replica
    ``replica``'s slice, and every copy its TP ranks hold is written.
    Updates ``cache`` in place; returns (logits [1,V] at ``length-1``,
    cache)."""
    def attn(ps, hs, positions, devs, caches, start, ctx, slot):
        return chunk_attention_apply_tp(
            cfg, ps, hs, positions, devs,
            caches=[(c["k"], c["v"]) for c in caches], slot=slot,
            start=start)[0]
    return _chunk_step(cfg, params, tokens, cache, start, length, (slot,),
                       attn, parallel=parallel, replica=replica)


def _chunk_step(cfg, params, tokens, cache, start, length, where, attn, *,
                parallel, replica):
    """The two chunk steps' body: the chunk's embedding, then block by
    block its attention, ``attn(the ranks' attention params, the ranks'
    normed inputs, positions, the ranks' devices, the ranks' layer caches,
    start, ctx, *where)`` -> one output per rank (one rank on one device),
    and its feed-forward; returns (the logits at ``length - 1``, cache).
    ``where`` (the block table and chunk ids, or the slot row) goes to the
    replica's device with the tokens."""
    C = tokens.shape[1]
    dev = tokens.device
    # fills, not copies from host memory: the step never syncs
    start, length, *where = (
        v if torch.is_tensor(v)
        else torch.full((1,), int(v), dtype=torch.int32, device=dev)
        for v in (start, length, *where))
    if parallel is not None:
        dev, (tokens, start, length, *where) = _one_replica(
            parallel, replica, tokens, start, length, *where)
    start = start.reshape(1).to(torch.int32)
    ctx_t = length.reshape(1).to(torch.int32)
    positions = start[:, None] + torch.arange(C, device=dev,
                                              dtype=torch.int32)[None]
    # the logits row of the last valid position, q_len - 1
    last = (ctx_t - start - 1).long()
    if parallel is not None:
        copies = _rank_caches(cache, parallel, replica)

        def run(g, i, bp, h, dv):
            return attn([p["attn"] for p in bp], h, positions, dv,
                        [{n: v[i] for n, v in c.items()} for c in copies],
                        start, ctx_t, *where)
        hs, local, devs = _dp_layers(cfg, params, parallel, [replica],
                                     [tokens], run)
        return _logits(cfg, local, devs,
                       [[x.index_select(1, last.to(x.device))[:, 0]
                         for x in hs[0]]])[0], cache
    x = F.embedding(tokens.long(), params["embed"])
    pool = params.get("moe_pool")
    for _, i, bp, moe in _layers(cfg, params):
        h = apply_norm(bp["ln1"], x, cfg.norm_type)
        x = x + attn([bp["attn"]], [h], positions, [dev],
                     [{n: v[i] for n, v in cache.items()}], start, ctx_t,
                     *where)[0]
        h = apply_norm(bp["ln2"], x, cfg.norm_type)
        x = x + _ffn_part(cfg, bp, h, moe=moe, moe_pool=pool)
    x = apply_norm(params["final_norm"], x, cfg.norm_type)
    return linear(params["lm_head"], x.index_select(1, last)[:, 0]), cache
