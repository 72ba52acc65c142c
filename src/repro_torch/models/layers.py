"""Core transformer layers as plain functions over parameter dicts — the
port of ``repro.models.layers``: attention over the paged KV pool and
over the slot-contiguous cache with monolithic or chunked prefill, a
sliding window over the latter (its ring decode included), and the VLM's
cross-attention over image keys.

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

The ``*_tp`` forms run one DP replica's TP ranks (Megatron-style, the
shards of ``HMM.param_sharding``): they take one parameter view, one copy
of the input and one ``torch.device`` per rank, rank 0 first, and return
one copy of the output per rank.  Rank t holds columns ``[t W/tp, (t+1)
W/tp)`` of q, k and v (W their width) and the matching rows of ``o``,
wherever W divides by tp, also inside a head; its columns of the MLP's up
and gate and its rows of ``down``.  The rows of ``o`` and ``down`` give a
partial output that ``tp_all_reduce`` sums over the ranks.  The cache is
replicated over the ranks: the new k/v rows of all heads go into every
rank's copy, and each rank attends the kv heads its query heads read, of
its copy in place (the kernels' ``kv_head_offset``, ``kv_heads``).

* Head-aligned (``H`` and ``KVH`` divisible by tp): rank t computes its
  own query and kv heads (RoPE is per head), the k/v rows are gathered
  (``tp_all_gather``), and it attends kv heads ``[t KVH/tp, (t+1)
  KVH/tp)``.
* A split that cuts a head: the ranks' q, k and v columns are gathered in
  rank order on rank 0 (a weight the rule left whole is rank 0's own
  product), reshaped to heads and rotated there (RoPE pairs dimensions
  within a head, which a cut can separate), then broadcast.  Rank t needs
  attention-output columns ``[c0, c1) = [t H hd/tp, (t+1) H hd/tp)``: it
  attends the query heads ``[c0 // hd, ceil(c1 / hd))`` against the one
  kv head of their group, or, where they span groups, the whole groups
  they touch (``_cut_plan``), and multiplies columns ``[c0, c1)`` of the
  result by its rows of ``o``.  An int8 row is quantized over all heads,
  as in the reference.

The one-device forms are the case of one rank: the sums and gathers then
return the rank's own tensor, and it attends all its kv heads.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (place, tp_all_gather,
                                              tp_all_reduce, tp_broadcast,
                                              tp_gather)
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


def linear_cols(p, x, rank: int):
    """A linear whose weight is TP rank ``rank``'s column shard: ``x`` @
    the shard, plus the rank's columns of the replicated bias."""
    y = dot(x, p["w"])
    if "b" in p:
        n, b = p["w"].shape[-1], p["b"]
        y = y + (b if b.shape[-1] == n else b[..., rank * n:(rank + 1) * n])
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


def _qkv_rope(cfg, p, x, positions, rank: int = 0, tp: int = 1):
    """q, k, v [B,S,heads,hd] with rope applied: all heads, or at ``tp`` >
    1 TP rank ``rank``'s (``p`` its column shards)."""
    B, S, _ = x.shape
    H, KVH = cfg.num_heads // tp, cfg.num_kv_heads // tp
    hd = cfg.resolved_head_dim
    q = linear_cols(p["q"], x, rank).reshape(B, S, H, hd)
    k = linear_cols(p["k"], x, rank).reshape(B, S, KVH, hd)
    v = linear_cols(p["v"], x, rank).reshape(B, S, KVH, hd)
    rot_dim = int(cfg.resolved_head_dim * cfg.rope_fraction) // 2 * 2
    if rot_dim:
        cos, sin = rope_tables(positions, rot_dim)
        q = apply_rope(q, cos, sin, rot_dim)
        k = apply_rope(k, cos, sin, rot_dim)
    return q, k, v


def attention_apply(cfg, p, x, positions, *, cache=None, write_pos=None,
                    kv_valid_len=None, kv_x=None, causal=None, window=None):
    """Self- or cross-attention, with or without the slot-contiguous KV
    cache (the reference's signature; ``causal`` defaults to
    ``cfg.causal`` and applies to self-attention, ``window`` to
    ``cfg.attn_window``).

    * Prefill / forward (``cache=None``): x [B,S,D] at ``positions``
      ``arange(S)`` -> (y [B,S,D], (k, v) [B,S,KVH,hd]); a ``window`` W
      masks keys t with i - t >= W.
    * Decode (``cache=(k_cache, v_cache)`` [B,rows,KVH,hd], x [B,1,D],
      ``write_pos``): -> (y [B,1,D], cache), updated in place; with a
      window the new row goes where ``write_pos`` says (the ring's ``L %
      rows``) and row b attends the ring slots the reference's mask keeps
      (``_decode_range``).
    * Cross-attention, prefill (``kv_x`` [B,T,D], the image embeddings):
      k and v from ``kv_x`` -> (y, the image (k, v) [B,T,KVH,hd]); decode
      (a ``cache`` of image k/v and no ``write_pos``): attends it in place
      -> (y, cache).  Never causal and never rotated.

    Self-attention is the one-device case of :func:`attention_apply_tp`;
    cross-attention runs on one device only (``_cross_attention``)."""
    causal = cfg.causal if causal is None else causal
    window = cfg.attn_window if window is None else window
    if kv_x is not None or (cache is not None and write_pos is None):
        return _cross_attention(cfg, p, x, positions, kv_x=kv_x,
                                cache=cache, kv_valid_len=kv_valid_len,
                                window=window)
    ys, kv = attention_apply_tp(
        cfg, [p], [x], positions, [x.device],
        caches=None if cache is None else [cache], write_pos=write_pos,
        kv_valid_len=kv_valid_len, causal=causal, window=window)
    return ys[0], kv if cache is None else cache


def _decode_range(positions, valid, window):
    """A decode row's attended slots ``[start, end)`` of its cache, as the
    reference's ``mha`` masks them with ``kv_pos = arange(rows)`` (slot
    indices, which a windowed ring holds out of position order): ``end``
    = ``valid``, the valid length, which the self-attention's callers end
    at ``positions + 1``, where its causal mask ends too; ``start`` =
    ``positions - W + 1`` (at least 0) under a window W, else None.
    Where start >= end the reference masks every slot, and its softmax
    over equal ``-1e30`` scores gives the uniform mean of v, which
    ``ops.paged_decode_attention`` reproduces (ROADMAP §3, "Windowed
    decode")."""
    end = valid.to(torch.int32)
    if window is None:
        return None, end
    start = (positions[:, 0].to(torch.int32) - (window - 1)).clamp(min=0)
    return start, end


def _cross_attention(cfg, p, x, positions, *, kv_x, cache, kv_valid_len,
                     window):
    """:func:`attention_apply`'s cross-attention on one device.  Prefill:
    q from x [B,S,D], k and v from ``kv_x`` [B,T,D] (no rope on them, as
    in the reference), the image keys at positions ``arange(T)``, through
    ``ops.flash_attention`` (S rows over T keys) -> (y, (k, v)).  Decode
    (x [B,1,D]): q against the cached image k/v [B,T,KVH,hd] through
    ``ops.paged_decode_attention`` over ``_decode_range``'s slots (every
    image row, or a window's) -> (y, cache)."""
    B, S, _ = x.shape
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    # no rope and no causal mask, as the reference's VLM blocks call it
    q = linear(p["q"], x).reshape(B, S, H, hd)
    if kv_x is not None:
        T = kv_x.shape[1]
        k = linear(p["k"], kv_x).reshape(B, T, KVH, hd)
        v = linear(p["v"], kv_x).reshape(B, T, KVH, hd)
        o = ops.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), False, window=window)
        return linear(p["o"], o.reshape(B, S, H * hd)), (k, v)
    if S != 1:
        raise ValueError(f"a decode over a cached image attends one token, "
                         f"not {S}")
    kc, vc = cache
    T = kc.shape[1]
    valid = (torch.full((B,), T, dtype=torch.int32, device=x.device)
             if kv_valid_len is None else kv_valid_len)
    start, end = _decode_range(positions, valid, window)
    o = ops.paged_decode_attention(q[:, 0].contiguous(), kc, vc, end,
                                   starts=start)
    return linear(p["o"], o.reshape(B, 1, H * hd)), cache


def paged_attention_apply(cfg, p, x, positions, *, cache, block_tables,
                          write_block, lengths):
    """Decode-step attention over the paged KV pool: the one-device case
    of :func:`paged_attention_apply_tp`.  x [B,1,D]; ``cache`` = this
    layer's pools, updated in place.  Returns (y [B,1,D], cache)."""
    ys, _ = paged_attention_apply_tp(
        cfg, [p], [x], positions, [x.device], caches=[cache],
        block_tables=block_tables, write_block=write_block, lengths=lengths)
    return ys[0], cache


def paged_chunk_attention_apply(cfg, p, x, positions, *, cache, block_tables,
                                chunk_block_ids, ctx_len, q_len):
    """Chunked-prefill attention over the paged KV pool (one sequence): the
    one-device case of :func:`paged_chunk_attention_apply_tp`.  x [1,C,D];
    ``cache`` = this layer's pools, updated in place.  Returns (y [1,C,D],
    cache)."""
    ys, _ = paged_chunk_attention_apply_tp(
        cfg, [p], [x], positions, [x.device], caches=[cache],
        block_tables=block_tables, chunk_block_ids=chunk_block_ids,
        ctx_len=ctx_len, q_len=q_len)
    return ys[0], cache


def chunk_attention_apply(cfg, p, x, positions, *, k_row, v_row, start):
    """Chunked-prefill attention over a slot's row of the slot-contiguous
    cache: the one-device case of :func:`chunk_attention_apply_tp`.  x
    [1,C,D]; k_row / v_row [1,S_max,KVH,hd], updated in place; ``start``
    [1] int32.  Returns (y [1,C,D], (k_row, v_row))."""
    ys, _ = chunk_attention_apply_tp(
        cfg, [p], [x], positions, [x.device], caches=[(k_row, v_row)],
        slot=torch.zeros(1, dtype=torch.int32, device=x.device),
        start=start)
    return ys[0], (k_row, v_row)


# ------------------------------------------------------ attention bodies

def _cut_plan(cfg, tp: int, t: int):
    """Rank ``t``'s share of a split that cuts a head (module note) ->
    (query heads [h0, h1), kv heads [g0, g1), its attention-output columns
    [c0, c1)): the query heads covering [c0, c1), widened to whole groups
    where they span more than one kv head's group."""
    H, G, hd = cfg.num_heads, cfg.num_heads // cfg.num_kv_heads, \
        cfg.resolved_head_dim
    c0, c1 = t * H * hd // tp, (t + 1) * H * hd // tp
    h0, h1 = c0 // hd, -(-c1 // hd)
    g0, g1 = h0 // G, -(-h1 // G)
    if g1 - g0 > 1:
        h0, h1 = g0 * G, g1 * G
    return (h0, h1), (g0, g1), (c0, c1)


def _gathered_cols(ps, xs, devices, width: int):
    """All ``width`` columns of a TP linear on rank 0's device: the ranks'
    column shards joined in rank order, or rank 0's own product where the
    sharding left the weight whole."""
    if ps[0]["w"].shape[-1] == width:
        return linear(ps[0], xs[0])
    return tp_gather([linear_cols(p, x, t) for t, (p, x)
                      in enumerate(zip(ps, xs))], devices, -1)


class _Share(NamedTuple):
    """A TP rank's share of the attention: the query heads it attends
    [B,S,n,hd], the fresh k/v of the kv heads they read, the kernels'
    ``heads`` keywords for its copy of the cache, and ``cols`` = (c0, c1,
    h0 * hd), the output columns it keeps and the one its heads start at
    (None: all of them; :func:`_tp_out`)."""
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    heads: dict
    cols: Optional[Tuple[int, int, int]]


def _tp_qkv(cfg, ps, xs, positions, devices, everywhere=True):
    """Each rank's :class:`_Share` (module note), and the new k and v rows
    of all heads [B,S,KVH,hd]: one copy per rank, or rank 0's alone where
    not ``everywhere`` -> (shares, ks, vs)."""
    tp = len(ps)
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if H % tp == 0 and KVH % tp == 0:
        kvh = KVH // tp
        qkv = [_qkv_rope(cfg, p, x, positions.to(d), t, tp)
               for t, (p, x, d) in enumerate(zip(ps, xs, devices))]
        ks, vs = ((tp_all_gather(parts, devices, 2) if everywhere
                   else [tp_gather(parts, devices, 2)])
                  for parts in ([r[1] for r in qkv], [r[2] for r in qkv]))
        return [_Share(q, k, v, dict(kv_head_offset=t * kvh, kv_heads=kvh),
                       None) for t, (q, k, v) in enumerate(qkv)], ks, vs
    B, S, _ = xs[0].shape
    q, k, v = (_gathered_cols([p[n] for p in ps], xs, devices, w * hd)
               .reshape(B, S, w, hd)
               for n, w in (("q", H), ("k", KVH), ("v", KVH)))
    rot_dim = int(hd * cfg.rope_fraction) // 2 * 2
    if rot_dim:
        cos, sin = rope_tables(positions.to(devices[0]), rot_dim)
        q = apply_rope(q, cos, sin, rot_dim)
        k = apply_rope(k, cos, sin, rot_dim)
    ks, vs = tp_broadcast(k, devices), tp_broadcast(v, devices)
    shares = []
    for t, d in enumerate(devices):
        (h0, h1), (g0, g1), (c0, c1) = _cut_plan(cfg, tp, t)
        shares.append(_Share(place(q[:, :, h0:h1], d), ks[t][:, :, g0:g1],
                             vs[t][:, :, g0:g1],
                             dict(kv_head_offset=g0, kv_heads=g1 - g0),
                             (c0, c1, h0 * hd)))
    return (shares, ks, vs) if everywhere else (shares, ks[:1], vs[:1])


def _tp_out(ps, os_, devices, cols=None):
    """Each rank's attention rows [B,S,...] (its heads' outputs, flattened)
    through its rows of ``o`` (which carries no bias), summed over the
    ranks.  Where ``cols[t]`` = (c0, c1, first), rank t's rows start at
    attention-output column ``first`` and it keeps columns [c0, c1) (a
    split that cuts a head; rows [c0, c1) of an ``o`` the sharding left
    whole)."""
    parts = []
    for t, (p, o) in enumerate(zip(ps, os_)):
        o, w = o.reshape(*o.shape[:2], -1), p["o"]["w"]
        if cols is not None and cols[t] is not None:
            c0, c1, first = cols[t]
            o = o[..., c0 - first:c1 - first]
            if w.shape[0] != c1 - c0:
                w = w[c0:c1]
        parts.append(dot(o, w))
    return tp_all_reduce(parts, devices)


def attention_apply_tp(cfg, ps, xs, positions, devices, *, caches=None,
                       write_pos=None, kv_valid_len=None, causal=None,
                       window=None):
    """Self-attention over one replica's TP ranks (module note), with or
    without the slot-contiguous KV cache.

    * Prefill / forward (``caches`` None): x [B,S,D] at ``positions``
      ``arange(S)``; each rank attends causally (``cfg.causal`` unless
      ``causal`` is given) over the fresh k/v of the kv heads its query
      heads read (``ops.flash_attention``), keys t with i - t < ``window``
      only where one is given; returns (the outputs, one per rank, (k, v)
      of all heads [B,S,KVH,hd] on rank 0's device).
    * Decode (``caches[t]`` = rank t's copy ``(k_cache, v_cache)``
      [B,max_len,KVH,hd], x [B,1,D]): all heads' new rows go into every
      copy at ``cache[b, write_pos[b]]`` in place
      (``ops.kv_cache_write_pair``, one launch for both, once per copy;
      positions outside the cache drop), then rank t attends its kv heads
      of its copy, positions ``< kv_valid_len[b]`` (the decode step passes
      lengths + 1, where the causal mask ends too), and under a ``window``
      from ``_decode_range``'s start on, through
      ``ops.paged_decode_attention``; returns (the outputs, ``caches``)."""
    causal = cfg.causal if causal is None else causal
    shares, ks, vs = _tp_qkv(cfg, ps, xs, positions, devices,
                             everywhere=caches is not None)
    if caches is None:
        os_ = [ops.flash_attention(r.q.contiguous(), r.k.contiguous(),
                                   r.v.contiguous(), causal, window=window)
               for r in shares]
        return (_tp_out(ps, os_, devices, [r.cols for r in shares]),
                (ks[0], vs[0]))
    os_ = []
    for t, ((q, _, _, heads, _), (kc, vc), d) in enumerate(
            zip(shares, caches, devices)):
        ops.kv_cache_write_pair(kc, ks[t][:, 0].to(kc.dtype), vc,
                                vs[t][:, 0].to(vc.dtype), write_pos.to(d))
        start, end = _decode_range(positions.to(d), kv_valid_len.to(d),
                                   window)
        os_.append(ops.paged_decode_attention(
            q[:, 0].contiguous(), kc, vc, end, starts=start,
            **heads)[:, None])
    return _tp_out(ps, os_, devices, [r.cols for r in shares]), caches


def paged_attention_apply_tp(cfg, ps, xs, positions, devices, *, caches,
                             block_tables, write_block, lengths):
    """Decode-step attention over the paged KV pool, over one replica's TP
    ranks (module note).

    x [B,1,D]; ``caches[t]`` = rank t's copy of this layer's pools
    {'k','v': [NB,bs,KVH,hd]}, updated in place — int8 pools carry f32
    per-token scale pools {'k_scale','v_scale': [NB,bs]} and the new rows
    are quantized over all (KVH, hd) as they are written; block_tables
    [B,MB]; write_block [B] = pool row receiving this step's k/v (``NB``
    marks inactive slots, whose writes drop); lengths [B] = tokens already
    cached (the new token lands at offset ``lengths % bs``).  All heads'
    rows, and an int8 pool's scales, go into every copy with one
    ``ops.kv_paged_write`` each, which drops the sentinel on the device;
    then rank t attends its kv heads of its copy.  Returns (the outputs,
    one per rank, ``caches``)."""
    shares, ks, vs = _tp_qkv(cfg, ps, xs, positions, devices)
    os_ = []
    for t, ((q, _, _, heads, _), cache, d) in enumerate(
            zip(shares, caches, devices)):
        lens = lengths.to(d)
        ops.kv_paged_write(cache["k"], cache["v"], ks[t][:, 0], vs[t][:, 0],
                           write_block.to(d), lens, cache.get("k_scale"),
                           cache.get("v_scale"))
        # table padding holds the NB sentinel; the kernel and the plain
        # version clamp it to NB - 1 where they read (inactive slots'
        # outputs are unused)
        qd, bt = q[:, 0].contiguous(), block_tables.to(d)
        lens = (lens + 1).to(torch.int32)
        if "k_scale" in cache:
            o = ops.quant_block_paged_decode_attention(
                qd, cache["k"], cache["k_scale"], cache["v"],
                cache["v_scale"], bt, lens, **heads)
        else:
            o = ops.block_paged_decode_attention(qd, cache["k"], cache["v"],
                                                 bt, lens, **heads)
        os_.append(o[:, None])
    return _tp_out(ps, os_, devices, [r.cols for r in shares]), caches


def paged_chunk_attention_apply_tp(cfg, ps, xs, positions, devices, *,
                                   caches, block_tables, chunk_block_ids,
                                   ctx_len, q_len):
    """Chunked-prefill attention over the paged KV pool (one sequence),
    over one replica's TP ranks (module note).

    x [1,C,D] is one prefill chunk — the last ``q_len`` (<= C) of the
    sequence's first ``ctx_len`` tokens; ``positions`` [1,C] their absolute
    positions.  The chunk's k/v of all heads are written into pool rows
    ``chunk_block_ids`` [C/bs] of every rank's copy first (``NB`` marks
    padding and CoW-shared prefix rows, whose writes drop; int8 pools
    quantize each token row and scatter its scale alongside), one
    ``ops.kv_block_write`` a copy (the pools as a one-layer stack, the
    chunk's C rows as its ``C/bs`` blocks); then rank t's heads attend
    causally over the whole context through ``block_tables`` [1,MB], the
    kv heads they read of its copy.  Returns (the outputs, one per rank,
    ``caches``)."""
    shares, ks, vs = _tp_qkv(cfg, ps, xs, positions, devices)
    os_ = []
    for t, ((q, _, _, heads, _), cache, d) in enumerate(
            zip(shares, caches, devices)):
        one = {n: c[None] for n, c in cache.items()}
        ops.kv_block_write(one["k"], one["v"], ks[t], vs[t],
                           chunk_block_ids.to(d), one.get("k_scale"),
                           one.get("v_scale"))
        bt = block_tables.to(d)
        ctx1 = ctx_len.to(d).reshape(1).to(torch.int32)
        qlen1 = q_len.to(d).reshape(1).to(torch.int32)
        if "k_scale" in cache:
            o = ops.quant_mixed_block_paged_attention(
                q.contiguous(), cache["k"], cache["k_scale"], cache["v"],
                cache["v_scale"], bt, ctx1, qlen1, **heads)
        else:
            o = ops.mixed_block_paged_attention(q.contiguous(), cache["k"],
                                                cache["v"], bt, ctx1, qlen1,
                                                **heads)
        os_.append(o)
    return _tp_out(ps, os_, devices, [r.cols for r in shares]), caches


def chunk_attention_apply_tp(cfg, ps, xs, positions, devices, *, caches,
                             slot, start):
    """Chunked-prefill attention over the slot-contiguous cache (one
    sequence), over one replica's TP ranks (module note): the paged chunk
    attention over the slot's row read as a block pool.

    x [1,C,D] is one prefill chunk at positions ``start .. start + C - 1``
    (``positions`` [1,C]); ``caches[t]`` = rank t's copy ``(k_cache,
    v_cache)`` [B,S_max,KVH,hd] of this layer, updated in place; ``slot``
    and ``start`` [1] int32 device tensors.  Each copy is viewed as a pool
    [B * S_max/bs, bs, KVH, hd] with bs = gcd(C, S_max, 16), the slot's
    row as its blocks ``slot * S_max/bs + arange(S_max/bs)``.  The chunk's
    k/v rows go to positions ``[s, s + C)`` of the row, s = min(start,
    S_max - C): the reference's ``dynamic_update_slice`` moves a chunk
    that would run past the row back onto its last C positions, and the
    view never writes past its own row.  Then rank t's heads attend its kv
    heads of its copy through the mixed kernel with ctx = min(start + C,
    S_max) and q_len = ctx - start, so row i attends positions ``<= start
    + i`` of the row: the reference's causal ``mha`` over the row, the
    padding rows included.  Returns (the outputs, one per rank,
    ``caches``)."""
    C = xs[0].shape[1]
    S_max = caches[0][0].shape[1]
    bs = math.gcd(C, S_max, 16)
    MB = S_max // bs
    dev = start.device
    start = start.reshape(1).to(torch.int32)
    base = slot.reshape(1).to(dev, torch.int32) * MB
    table = base[:, None] + torch.arange(MB, dtype=torch.int32,
                                         device=dev)[None]
    first = torch.clamp(start, max=S_max - C) // bs
    ids = base + first + torch.arange(C // bs, dtype=torch.int32, device=dev)
    ctx = torch.clamp(start + C, max=S_max)
    views = [{"k": k.view(-1, bs, *k.shape[2:]),
              "v": v.view(-1, bs, *v.shape[2:])} for k, v in caches]
    ys, _ = paged_chunk_attention_apply_tp(
        cfg, ps, xs, positions, devices, caches=views, block_tables=table,
        chunk_block_ids=ids, ctx_len=ctx, q_len=ctx - start)
    return ys, caches


# ----------------------------------------------------------------------- mlp

def mlp_init(gen, d_model, d_ff, dtype, device, gated=True, lead=()):
    p = {"up": linear_init(gen, d_model, d_ff, dtype, device, lead=lead),
         "down": linear_init(gen, d_ff, d_model, dtype, device, lead=lead)}
    if gated:
        p["gate"] = linear_init(gen, d_model, d_ff, dtype, device, lead=lead)
    return p


def _mlp_hidden(p, x, gated, rank: int = 0):
    """up(x) * silu(gate(x)), or gelu(up(x)): all columns, or TP rank
    ``rank``'s (``p`` its column shards)."""
    h = linear_cols(p["up"], x, rank)
    if gated:
        return h * F.silu(linear_cols(p["gate"], x, rank))
    return F.gelu(h, approximate="tanh")     # jax.nn.gelu's default


def mlp_apply(p, x, gated=True):
    return linear(p["down"], _mlp_hidden(p, x, gated))


def mlp_apply_tp(ps, xs, devices, d_ff: int, gated=True):
    """:func:`mlp_apply` over one replica's TP ranks: rank t's columns of
    up (and gate) and its rows of down, summed over the ranks.  An MLP
    whose ``d_ff`` does not split over the ranks is replicated by the
    sharding rule: each rank then computes it whole."""
    if ps[0]["up"]["w"].shape[-1] == d_ff:
        return [mlp_apply(p, x, gated) for p, x in zip(ps, xs)]
    return tp_all_reduce([dot(_mlp_hidden(p, x, gated, t), p["down"]["w"])
                          for t, (p, x) in enumerate(zip(ps, xs))], devices)
