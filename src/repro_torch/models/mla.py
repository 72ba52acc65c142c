"""DeepSeek-V2 Multi-head Latent Attention (MLA) — the port of
``repro.models.mla``.

The KV cache stores only the rank-``kv_lora_rank`` latent ``c`` plus the
shared rope key ``kr``: per layer ``{c: [B, S, r], kr: [B, S, dr]}``, a
third of a standard-attention cache of the same model size.

Two compute paths, as in the reference:

* prefill / forward expand k and v from the latent and run causal
  attention at q/k width ``dn + dr`` and v width ``dv``
  (``ops.flash_attention``; the reference pads v to ``dn + dr`` for its
  ``mha`` and trims the output, the kernel reads and writes ``dv``);
* decode uses the *absorbed* form: q_nope goes through ``W_uk`` (a plain
  matmul, outside any kernel in the reference too), the token attends the
  latent cache directly (``ops.mla_decode_attention``), and the latent
  context is read out through ``W_uv``.

Both scale scores by ``1/sqrt(dn + dr)``, the reference model's scale (the
reference's Pallas kernel derives another from r; see
``kernels/mla_decode.py``).

The ``*_tp`` forms run one DP replica's TP ranks, as ``layers``' do for
standard attention.  The sharding rule splits each of ``q`` (or
``q_up``), ``k_up`` and ``v_up`` by columns and ``o`` by rows wherever its
own width divides by tp, also inside a head, and leaves it whole
elsewhere; ``kv_down``, ``kv_norm`` (and ``q_down``, ``q_norm``) are
replicated, so every rank computes the same latent and writes it into its
own copy of the cache.

* Head-aligned (``H`` divisible by tp): rank t holds heads ``[t H/tp,
  (t+1) H/tp)`` of every leaf and computes them on its own.
* A tp that cuts a head (at deepseek-v2-lite's widths tp = 32 cuts every
  leaf: ``q`` 96 columns a rank, half a head of 192, ``k_up`` / ``v_up`` 64
  columns and ``o`` 64 rows; tp = 3 cuts ``q`` and leaves the rest whole):
  rank t keeps attention-output columns ``[c0, c1) = [t H dv // tp, (t+1)
  H dv // tp)``, the rows of ``o`` it holds (or reads of a whole ``o``),
  and attends the heads ``[c0 // dv, ceil(c1 / dv))`` covering them
  (``_cut_plan``).  The ranks' ``q`` columns are gathered on rank 0 (a
  leaf left whole is rank 0's own product) and its RoPE part rotated
  there, since a cut can split it.  Prefill gathers the expanded
  ``k_nope`` and ``v`` columns the same way and sends each rank its
  heads.  Decode absorbs per rank: rank t multiplies the ``q_nope``
  columns matching its ``k_up`` columns by them, and rank 0 sums each
  head's partial ``q_eff`` [B, heads, r] in f32 in rank order and rounds
  it once; a gathered ``W_uk`` would move r x H dn weights a layer every
  step (about 4 MB at full width) where this moves [B, H, r] activations,
  and keeps no second copy of a weight.  The read-out needs no gather:
  ``v_up``'s columns and ``o``'s rows share their width and so their cut,
  so rank t's ``ctx · W_uv[:, c0:c1] · o[c0:c1]`` is a partial output
  that ``tp_all_reduce`` sums.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.sharding import place
from repro_torch.kernels import ops
from repro_torch.models.layers import (_gathered_cols, _tp_out, apply_norm,
                                       apply_rope, dot, linear, linear_cols,
                                       linear_init, norm_init, rope_tables)


def mla_init(gen, cfg, dtype, device, lead=()):
    """The reference's leaves: ``q`` (full-rank) or ``q_down`` /
    ``q_norm`` / ``q_up`` (q-LoRA), ``kv_down``, ``kv_norm``, ``k_up``,
    ``v_up``, ``o``; drawn from ``gen``."""
    D, H = cfg.d_model, cfg.num_heads
    dn, dr, dv, r = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)
    p = {}
    if cfg.q_lora_rank:
        p["q_down"] = linear_init(gen, D, cfg.q_lora_rank, dtype, device,
                                  lead=lead)
        p["q_norm"] = norm_init(cfg.q_lora_rank, "rmsnorm", dtype, device,
                                lead)
        p["q_up"] = linear_init(gen, cfg.q_lora_rank, H * (dn + dr), dtype,
                                device, lead=lead)
    else:
        p["q"] = linear_init(gen, D, H * (dn + dr), dtype, device, lead=lead)
    p["kv_down"] = linear_init(gen, D, r + dr, dtype, device, lead=lead)
    p["kv_norm"] = norm_init(r, "rmsnorm", dtype, device, lead)
    p["k_up"] = linear_init(gen, r, H * dn, dtype, device, lead=lead)
    p["v_up"] = linear_init(gen, r, H * dv, dtype, device, lead=lead)
    p["o"] = linear_init(gen, H * dv, D, dtype, device, lead=lead)
    return p


def _q_linear(cfg, p, x):
    """The linear that gives q and its input: ``q`` on x, or q-LoRA's
    ``q_up`` on the normed ``q_down`` (both replicated)."""
    if cfg.q_lora_rank:
        return p["q_up"], apply_norm(p["q_norm"], linear(p["q_down"], x),
                                     "rmsnorm")
    return p["q"], x


def _queries(cfg, p, x, rank: int = 0, tp: int = 1):
    """q_nope, q_rope [B,S,heads,dn|dr]: all heads, or at ``tp`` > 1 TP
    rank ``rank``'s (its column shard of ``q`` or ``q_up``)."""
    B, S, _ = x.shape
    H, dn, dr = cfg.num_heads // tp, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = linear_cols(*_q_linear(cfg, p, x), rank).reshape(B, S, H, dn + dr)
    return q[..., :dn], q[..., dn:]


def _latent_kv(cfg, p, x, positions):
    """(c [B,S,r], roped kr [B,S,dr], the RoPE tables at ``positions``);
    ``kv_down`` and ``kv_norm`` are replicated, so every rank computes the
    same latent."""
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    ckr = linear(p["kv_down"], x)
    cos, sin = rope_tables(positions, dr)
    return (apply_norm(p["kv_norm"], ckr[..., :r], "rmsnorm"),
            apply_rope(ckr[..., None, r:], cos, sin, dr)[:, :, 0],
            (cos, sin))


def _latent(cfg, p, x, positions, rank: int = 0, tp: int = 1):
    """(q_nope, roped q_rope of the rank's heads, c [B,S,r], roped kr
    [B,S,dr])."""
    q_nope, q_rope = _queries(cfg, p, x, rank, tp)
    c, kr, (cos, sin) = _latent_kv(cfg, p, x, positions)
    return q_nope, apply_rope(q_rope, cos, sin, cfg.qk_rope_dim), c, kr


def _scale(cfg) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)


def _cuts_heads(cfg, tp: int) -> bool:
    """Whether tp splits the MLA heads unevenly, so that the sharding rule
    cuts a leaf inside a head or leaves it whole (module note)."""
    return tp > 1 and cfg.num_heads % tp != 0


def _cut_plan(cfg, tp: int, t: int):
    """Rank ``t``'s share where tp cuts a head -> (heads [h0, h1), its
    attention-output columns [c0, c1) over ``H * dv``)."""
    dv = cfg.v_head_dim
    c0, c1 = t * cfg.num_heads * dv // tp, (t + 1) * cfg.num_heads * dv // tp
    return (c0 // dv, -(-c1 // dv)), (c0, c1)


def heads_a_rank(cfg, tp: int):
    """The number of heads each TP rank attends, rank 0 first."""
    if not _cuts_heads(cfg, tp):
        return [cfg.num_heads // tp] * tp
    return [h1 - h0 for (h0, h1), _ in
            (_cut_plan(cfg, tp, t) for t in range(tp))]


def _pieces(c0: int, c1: int, hd: int):
    """Columns [c0, c1) of a head-major width split at head boundaries:
    (head, first column, end column) for each head they touch."""
    return [(h, max(c0, h * hd), min(c1, (h + 1) * hd))
            for h in range(c0 // hd, -(-c1 // hd))]


def _rank_latents(cfg, ps, xs, positions, devices):
    """Every rank's (c, kr), each computed on its own device from its copy
    of x: the same values on every rank."""
    return [_latent_kv(cfg, p, x, positions.to(d))[:2]
            for p, x, d in zip(ps, xs, devices)]


def _cut_queries(cfg, ps, xs, positions, devices):
    """Where tp cuts a head: all heads' q_nope and roped q_rope
    [B,S,H,dn|dr] on rank 0, from the ranks' ``q`` (or ``q_up``) columns
    gathered in rank order."""
    B, S, _ = xs[0].shape
    H, dn, dr = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    qp, qx = zip(*(_q_linear(cfg, p, x) for p, x in zip(ps, xs)))
    q = _gathered_cols(qp, qx, devices, H * (dn + dr)).reshape(B, S, H,
                                                              dn + dr)
    cos, sin = rope_tables(positions.to(devices[0]), dr)
    return q[..., :dn], apply_rope(q[..., dn:], cos, sin, dr)


def mla_prefill(cfg, p, x, positions):
    """x [B,S,D] at ``positions`` [B,S] attends causally over its own
    tokens.  Returns (y [B,S,D], (c [B,S,r], kr [B,S,dr])): the one-device
    case of :func:`mla_prefill_tp`."""
    ys, kv = mla_prefill_tp(cfg, [p], [x], positions, [x.device])
    return ys[0], kv


def mla_prefill_tp(cfg, ps, xs, positions, devices):
    """:func:`mla_prefill` over one replica's TP ranks (``layers``' module
    note): rank t expands k and v of its H/tp heads from the latent
    (its columns of ``k_up`` and ``v_up``) and attends them
    (``ops.flash_attention``); its rows of ``o`` give a partial output,
    summed over the ranks.  Returns (the outputs, one per rank, (c, kr) of
    rank 0)."""
    tp = len(ps)
    if _cuts_heads(cfg, tp):
        return _mla_prefill_cut(cfg, ps, xs, positions, devices)
    H, dn, dr, dv = (cfg.num_heads // tp, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    ys, kv = [], None
    for t, (p, x, d) in enumerate(zip(ps, xs, devices)):
        B, S, _ = x.shape
        q_nope, q_rope, c, kr = _latent(cfg, p, x, positions.to(d), t, tp)
        k_nope = linear_cols(p["k_up"], c, t).reshape(B, S, H, dn)
        v = linear_cols(p["v_up"], c, t).reshape(B, S, H, dv)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, kr[:, :, None, :].expand(B, S, H, dr)],
                      dim=-1)
        ys.append(ops.flash_attention(q, k, v.contiguous(), True,
                                      _scale(cfg)))
        if t == 0:
            kv = (c, kr)
    return _tp_out(ps, ys, devices), kv


def _mla_prefill_cut(cfg, ps, xs, positions, devices):
    """:func:`mla_prefill_tp` where tp cuts a head (module note): q, k_nope
    and v of all heads on rank 0, rank t's heads sent to it and attended
    there, its columns kept."""
    tp = len(ps)
    B, S, _ = xs[0].shape
    H, dn, dr, dv = (cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    lat = _rank_latents(cfg, ps, xs, positions, devices)
    q_nope, q_rope = _cut_queries(cfg, ps, xs, positions, devices)
    cs = [c for c, _ in lat]
    k_nope = _gathered_cols([p["k_up"] for p in ps], cs, devices,
                            H * dn).reshape(B, S, H, dn)
    v = _gathered_cols([p["v_up"] for p in ps], cs, devices,
                       H * dv).reshape(B, S, H, dv)
    kr = lat[0][1]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(B, S, H, dr)], dim=-1)
    ys, cols = [], []
    for t, d in enumerate(devices):
        (h0, h1), (c0, c1) = _cut_plan(cfg, tp, t)
        ys.append(ops.flash_attention(
            place(q[:, :, h0:h1].contiguous(), d),
            place(k[:, :, h0:h1].contiguous(), d),
            place(v[:, :, h0:h1].contiguous(), d), True, _scale(cfg)))
        cols.append((c0, c1, h0 * dv))
    return _tp_out(ps, ys, devices, cols), lat[0]


def mla_decode(cfg, p, x, positions, cache, write_pos, kv_valid_len):
    """Absorbed single-token decode.  x [B,1,D]; ``cache`` = (c [B,Smax,r],
    kr [B,Smax,dr]), written in place: the new latent rows land at
    ``write_pos`` [B] (``ops.kv_cache_write_pair``, one launch for both;
    positions outside the cache drop), then the token attends positions
    ``< kv_valid_len[b]`` (``ops.mla_decode_attention``).  Returns (y
    [B,1,D], cache): the one-device case of :func:`mla_decode_tp`."""
    ys, _ = mla_decode_tp(cfg, [p], [x], positions, [x.device],
                          caches=[cache], write_pos=write_pos,
                          kv_valid_len=kv_valid_len)
    return ys[0], cache


def mla_decode_tp(cfg, ps, xs, positions, devices, *, caches, write_pos,
                  kv_valid_len):
    """:func:`mla_decode` over one replica's TP ranks: every rank computes
    the same latent rows and writes them into its own copy ``caches[t]``
    of the replica's cache, then attends that copy with its H/tp heads
    (its columns of ``k_up`` absorbed into q, of ``v_up`` reading the
    context out); its rows of ``o`` give a partial output, summed over the
    ranks.  Returns (the outputs, one per rank, ``caches``)."""
    tp = len(ps)
    if _cuts_heads(cfg, tp):
        return _mla_decode_cut(cfg, ps, xs, positions, devices, caches,
                               write_pos, kv_valid_len)
    H, dn, dv, r = (cfg.num_heads // tp, cfg.qk_nope_dim, cfg.v_head_dim,
                    cfg.kv_lora_rank)
    ys = []
    for t, (p, x, (c_cache, kr_cache), d) in enumerate(
            zip(ps, xs, caches, devices)):
        q_nope, q_rope, c_new, kr_new = _latent(cfg, p, x, positions.to(d),
                                                t, tp)
        ops.kv_cache_write_pair(c_cache, c_new[:, 0].to(c_cache.dtype),
                                kr_cache, kr_new[:, 0].to(kr_cache.dtype),
                                write_pos.to(d))
        # absorb: q_eff[b,h] = q_nope[b,h] · W_uk[:, h]^T  (W_uk: [r,
        # H*dn]); one f32-accumulated product per head, rounded once to
        # x's dtype
        w_uk = p["k_up"]["w"].reshape(r, H, dn).permute(1, 2, 0)   # [H,dn,r]
        q_eff = torch.matmul(q_nope[:, 0].transpose(0, 1), w_uk)  # [H,B,r]
        ctx = ops.mla_decode_attention(
            q_eff.transpose(0, 1).contiguous(), q_rope[:, 0].contiguous(),
            c_cache, kr_cache, kv_valid_len.to(d, torch.int32), _scale(cfg))
        # read out through W_uv: [r, H*dv]
        w_uv = p["v_up"]["w"].reshape(r, H, dv).transpose(0, 1)   # [H,r,dv]
        y = torch.matmul(ctx.transpose(0, 1), w_uv)                # [H,B,dv]
        ys.append(y.transpose(0, 1)[:, None])                  # [B,1,H,dv]
    return _tp_out(ps, ys, devices), caches


def _cut_absorb(cfg, ps, q_nope, devices):
    """q_eff [B, H, r] on rank 0 in q_nope's dtype: each rank multiplies
    the ``q_nope`` columns matching its ``k_up`` columns (``W_uk`` [r, H
    dn], cut anywhere) by them, head piece by head piece, in f32; rank 0
    adds each head's partials in rank order and rounds once.  A ``k_up``
    left whole is rank 0's alone."""
    B, H, dn = q_nope.shape
    r = cfg.kv_lora_rank
    w0 = ps[0]["k_up"]["w"]
    if w0.shape[-1] == H * dn:
        w_uk = w0.reshape(r, H, dn).permute(1, 2, 0)             # [H,dn,r]
        return torch.matmul(q_nope.transpose(0, 1), w_uk).transpose(0, 1)
    flat = q_nope.reshape(B, H * dn)
    q_eff = torch.zeros(B, H, r, dtype=torch.float32, device=devices[0])
    n = w0.shape[-1]
    for t, (p, d) in enumerate(zip(ps, devices)):
        k0 = t * n
        mine = place(flat[:, k0:k0 + n], d).float()
        w = p["k_up"]["w"].float()
        for h, a, b in _pieces(k0, k0 + n, dn):
            part = torch.matmul(mine[:, a - k0:b - k0], w[:, a - k0:b - k0].T)
            q_eff[:, h] += place(part, devices[0])
    return q_eff.to(q_nope.dtype)


def _mla_decode_cut(cfg, ps, xs, positions, devices, caches, write_pos,
                    kv_valid_len):
    """:func:`mla_decode_tp` where tp cuts a head (module note): every rank
    writes its latent rows into its copy; rank 0 gathers q and sums the
    ranks' absorbed partials; rank t attends its heads of its copy and
    reads columns [c0, c1) out through ``v_up``'s and ``o``'s."""
    tp = len(ps)
    dv = cfg.v_head_dim
    lat = _rank_latents(cfg, ps, xs, positions, devices)
    for (c_cache, kr_cache), (c_new, kr_new), d in zip(caches, lat,
                                                       devices):
        ops.kv_cache_write_pair(c_cache, c_new[:, 0].to(c_cache.dtype),
                                kr_cache, kr_new[:, 0].to(kr_cache.dtype),
                                write_pos.to(d))
    q_nope, q_rope = _cut_queries(cfg, ps, xs, positions, devices)
    q_eff = _cut_absorb(cfg, ps, q_nope[:, 0], devices)
    q_rope = q_rope[:, 0]
    ys, cols = [], []
    for t, (p, (c_cache, kr_cache), d) in enumerate(zip(ps, caches,
                                                        devices)):
        (h0, h1), (c0, c1) = _cut_plan(cfg, tp, t)
        ctx = ops.mla_decode_attention(
            place(q_eff[:, h0:h1].contiguous(), d),
            place(q_rope[:, h0:h1].contiguous(), d), c_cache, kr_cache,
            kv_valid_len.to(d, torch.int32), _scale(cfg))     # [B,n,r]
        w = p["v_up"]["w"]
        if w.shape[-1] != c1 - c0:
            w = w[:, c0:c1]                    # a v_up left whole
        ys.append(torch.cat([dot(ctx[:, h - h0], w[:, a - c0:b - c0])
                             for h, a, b in _pieces(c0, c1, dv)],
                            dim=-1)[:, None])              # [B,1,c1-c0]
        cols.append((c0, c1, c0))
    return _tp_out(ps, ys, devices, cols), caches
