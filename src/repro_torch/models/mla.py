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
standard attention: rank t holds its heads' columns of ``q`` (or
``q_up``), ``k_up`` and ``v_up`` and its rows of ``o``; ``kv_down``,
``kv_norm`` (and ``q_down``, ``q_norm``) are replicated, so every rank
computes the same latent and writes it into its own copy of the cache.
Heads split evenly over tp: a tp that cuts an MLA head raises
(``models.model.check_tp_heads``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import (_tp_out, apply_norm, apply_rope,
                                       linear, linear_cols, linear_init,
                                       norm_init, rope_tables)


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


def _queries(cfg, p, x, rank: int = 0, tp: int = 1):
    """q_nope, q_rope [B,S,heads,dn|dr]: all heads, or at ``tp`` > 1 TP
    rank ``rank``'s (``q`` or ``q_up`` its column shard; ``q_down`` and
    ``q_norm`` replicated)."""
    B, S, _ = x.shape
    H, dn, dr = cfg.num_heads // tp, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        q = linear_cols(p["q_up"], apply_norm(
            p["q_norm"], linear(p["q_down"], x), "rmsnorm"), rank)
    else:
        q = linear_cols(p["q"], x, rank)
    q = q.reshape(B, S, H, dn + dr)
    return q[..., :dn], q[..., dn:]


def _latent(cfg, p, x, positions, rank: int = 0, tp: int = 1):
    """(q_nope, roped q_rope of the rank's heads, c [B,S,r], roped kr
    [B,S,dr]); ``kv_down`` and ``kv_norm`` are replicated, so every rank
    computes the same latent."""
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    q_nope, q_rope = _queries(cfg, p, x, rank, tp)
    ckr = linear(p["kv_down"], x)
    c = apply_norm(p["kv_norm"], ckr[..., :r], "rmsnorm")
    cos, sin = rope_tables(positions, dr)
    q_rope = apply_rope(q_rope, cos, sin, dr)
    kr = apply_rope(ckr[..., None, r:], cos, sin, dr)[:, :, 0]
    return q_nope, q_rope, c, kr


def _scale(cfg) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)


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
