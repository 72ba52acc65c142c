"""Core transformer layers as plain functions over parameter dicts — the
port of the parts of ``repro.models.layers`` the serving paths use (the
paged KV pool, and the slot-contiguous cache with monolithic prefill).

Conventions (the reference's, kept at every public function):

* weights are ``[d_in, d_out]`` and used as ``x @ w``;
* activations [B, S, D]; attention heads [B, S, H, hd];
* paged KV pools [NB, bs, KVH, hd] per layer; slot-contiguous caches
  [B, max_len, KVH, hd] per layer;
* matmuls accumulate in f32 and round to x's dtype (``dot``); norms, RoPE
  and the router compute in f32.

The attention functions that take a cache update the layer's views in
place (the reference donates the cache to its jitted steps; PyTorch writes
the rows directly) and return the same dict or tuple.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

# --------------------------------------------------------------------- utils


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with f32 accumulation, rounded to x's dtype.  On the card
    a bf16 product accumulates in f32 only with cuBLAS's reduced-precision
    reductions off, which every entry point resolving a CUDA device sets
    (``device.exact_matmuls``)."""
    if x.dtype == w.dtype:
        return torch.matmul(x, w)     # f32 accumulate, one rounding
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def linear_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
                device, bias: bool = False, scale=None, lead=()):
    """Normal(0, 1/sqrt(d_in)) weight ``[*lead, d_in, d_out]`` drawn from
    ``gen`` on ``device``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn(*lead, d_in, d_out, generator=gen, device=device,
                    dtype=torch.float32).mul_(scale).to(dtype)
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros(*lead, d_out, dtype=dtype, device=device)
    return p


def linear(p, x):
    y = dot(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


# --------------------------------------------------------------------- norms

def norm_init(d: int, norm_type: str, dtype, device, lead=()):
    p = {"scale": torch.ones(*lead, d, dtype=dtype, device=device)}
    if norm_type == "layernorm":
        p["bias"] = torch.zeros(*lead, d, dtype=dtype, device=device)
    return p


def apply_norm(p, x, norm_type: str, eps: float = 1e-5):
    xf = x.float()
    if norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------- rope

def rope_tables(positions: torch.Tensor, rot_dim: int, base: float = 10000.0):
    """positions [..., S] -> cos, sin [..., S, rot_dim/2] (f32)."""
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=positions.device) / rot_dim
    # a fill, not a copy from host memory: no sync with the device
    inv = 1.0 / torch.pow(torch.full((), base, dtype=torch.float32,
                                     device=positions.device), exps)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, rot_dim: int):
    """x [B,S,H,hd]; rotates *interleaved* (even, odd) pairs of the first
    ``rot_dim`` dims — not the half-split form."""
    if rot_dim == 0:
        return x
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    x1 = xr[..., 0::2]
    x2 = xr[..., 1::2]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    r1 = x1 * c - x2 * s
    r2 = x1 * s + x2 * c
    xr = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    if rot_dim < x.shape[-1]:
        return torch.cat([xr, xp.to(xr.dtype)], dim=-1).to(x.dtype)
    return xr.to(x.dtype)


# ----------------------------------------------------------------- attention

def attention_init(gen, cfg, dtype, device, lead=()):
    D = cfg.d_model
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    kw = dict(bias=cfg.qkv_bias, lead=lead)
    return {
        "q": linear_init(gen, D, H * hd, dtype, device, **kw),
        "k": linear_init(gen, D, KVH * hd, dtype, device, **kw),
        "v": linear_init(gen, D, KVH * hd, dtype, device, **kw),
        "o": linear_init(gen, H * hd, D, dtype, device, lead=lead),
    }


def _qkv_rope(cfg, p, x, positions):
    B, S, _ = x.shape
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = linear(p["q"], x).reshape(B, S, H, hd)
    k = linear(p["k"], x).reshape(B, S, KVH, hd)
    v = linear(p["v"], x).reshape(B, S, KVH, hd)
    rot_dim = int(cfg.resolved_head_dim * cfg.rope_fraction) // 2 * 2
    if rot_dim:
        cos, sin = rope_tables(positions, rot_dim)
        q = apply_rope(q, cos, sin, rot_dim)
        k = apply_rope(k, cos, sin, rot_dim)
    return q, k, v


def attention_apply(cfg, p, x, positions, *, cache=None, write_pos=None,
                    kv_valid_len=None, kv_x=None, causal=None, window=None):
    """Self-attention, with or without the slot-contiguous KV cache.

    * Prefill / forward (``cache=None``): x [B,S,D] at ``positions``
      ``arange(S)`` attends causally (``cfg.causal`` unless ``causal`` is
      given) over its own k/v through ``ops.flash_attention``; returns
      (y [B,S,D], (k, v) [B,S,KVH,hd]).
    * Decode (``cache=(k_cache, v_cache)`` [B,max_len,KVH,hd], x [B,1,D]):
      the new k/v rows go to ``cache[b, write_pos[b]]`` in place
      (``ops.kv_cache_write_pair``, one launch for both; positions outside
      the cache drop), then the token attends positions ``<
      kv_valid_len[b]`` (the decode step passes lengths + 1, where the
      causal mask ends too) through ``ops.paged_decode_attention``;
      returns (y [B,1,D], cache).

    Cross-attention (``kv_x``, or a cache without ``write_pos``) and
    windowed attention are outside this port and raise."""
    if kv_x is not None or (cache is not None and write_pos is None):
        raise NotImplementedError("cross-attention is not ported yet")
    window = cfg.attn_window if window is None else window
    if window is not None:
        raise NotImplementedError("windowed attention is not ported yet")
    causal = cfg.causal if causal is None else causal
    B, Sq, _ = x.shape
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _qkv_rope(cfg, p, x, positions)
    if cache is None:
        o = ops.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal)
        return linear(p["o"], o.reshape(B, Sq, H * hd)), (k, v)
    k_cache, v_cache = cache
    ops.kv_cache_write_pair(k_cache, k[:, 0].to(k_cache.dtype), v_cache,
                            v[:, 0].to(v_cache.dtype), write_pos)
    o = ops.paged_decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                                   kv_valid_len.to(torch.int32))
    return linear(p["o"], o.reshape(B, 1, H * hd)), cache


def paged_attention_apply(cfg, p, x, positions, *, cache, block_tables,
                          write_block, lengths):
    """Decode-step attention over the paged KV pool.

    x [B,1,D]; ``cache`` = this layer's pools {'k','v': [NB,bs,KVH,hd]},
    updated in place — int8 pools carry f32 per-token scale pools
    {'k_scale','v_scale': [NB,bs]} and the new rows are quantized over
    (KVH, hd) as they are written; block_tables [B,MB]; write_block [B] =
    pool row receiving this step's k/v (``NB`` marks inactive slots, whose
    writes drop); lengths [B] = tokens already cached (the new token lands
    at offset ``lengths % bs``).  The rows, and an int8 pool's scales, go
    in with one ``ops.kv_paged_write``, which drops the sentinel on the
    device.  Returns (y [B,1,D], cache)."""
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _qkv_rope(cfg, p, x, positions)
    quant = "k_scale" in cache
    ops.kv_paged_write(cache["k"], cache["v"], k[:, 0], v[:, 0], write_block,
                       lengths, cache.get("k_scale"), cache.get("v_scale"))
    # table padding holds the NB sentinel; the kernel and the plain version
    # clamp it to NB - 1 where they read (inactive slots' outputs are unused)
    qd, lens = q[:, 0].contiguous(), (lengths + 1).to(torch.int32)
    if quant:
        o = ops.quant_block_paged_decode_attention(
            qd, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"],
            block_tables, lens)
    else:
        o = ops.block_paged_decode_attention(qd, cache["k"], cache["v"],
                                             block_tables, lens)
    return linear(p["o"], o.reshape(B, 1, H * hd)), cache


def paged_chunk_attention_apply(cfg, p, x, positions, *, cache, block_tables,
                                chunk_block_ids, ctx_len, q_len):
    """Chunked-prefill attention over the paged KV pool (one sequence).

    x [1,C,D] is one prefill chunk — the last ``q_len`` (<= C) of the
    sequence's first ``ctx_len`` tokens; ``positions`` [1,C] their absolute
    positions.  The chunk's k/v are written into pool rows
    ``chunk_block_ids`` [C/bs] first (``NB`` marks padding and CoW-shared
    prefix rows, whose writes drop), then the chunk attends causally over
    the whole context through ``block_tables`` [1,MB].  ``cache`` is
    updated in place; int8 pools quantize each token row as it is written
    and scatter its scale alongside, as :func:`paged_attention_apply`, in
    one ``ops.kv_block_write`` (the pools as a one-layer stack, the
    chunk's C rows as its ``C/bs`` blocks).  Returns (y [1,C,D],
    cache)."""
    B, C, _ = x.shape
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _qkv_rope(cfg, p, x, positions)
    quant = "k_scale" in cache
    one = {n: t[None] for n, t in cache.items()}
    ops.kv_block_write(one["k"], one["v"], k, v, chunk_block_ids,
                       one.get("k_scale"), one.get("v_scale"))
    ctx1 = ctx_len.reshape(1).to(torch.int32)
    qlen1 = q_len.reshape(1).to(torch.int32)
    if quant:
        o = ops.quant_mixed_block_paged_attention(
            q.contiguous(), cache["k"], cache["k_scale"], cache["v"],
            cache["v_scale"], block_tables, ctx1, qlen1)
    else:
        o = ops.mixed_block_paged_attention(q.contiguous(), cache["k"],
                                            cache["v"], block_tables, ctx1,
                                            qlen1)
    return linear(p["o"], o.reshape(B, C, H * hd)), cache


# ----------------------------------------------------------------------- mlp

def mlp_init(gen, d_model, d_ff, dtype, device, gated=True, lead=()):
    p = {"up": linear_init(gen, d_model, d_ff, dtype, device, lead=lead),
         "down": linear_init(gen, d_ff, d_model, dtype, device, lead=lead)}
    if gated:
        p["gate"] = linear_init(gen, d_model, d_ff, dtype, device, lead=lead)
    return p


def mlp_apply(p, x, gated=True):
    h = linear(p["up"], x)
    if gated:
        h = h * F.silu(linear(p["gate"], x))
    else:
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    return linear(p["down"], h)
