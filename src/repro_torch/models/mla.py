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
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_norm, apply_rope, linear,
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


def _queries(cfg, p, x):
    B, S, _ = x.shape
    H, dn, dr = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        q = linear(p["q_up"], apply_norm(p["q_norm"], linear(p["q_down"], x),
                                         "rmsnorm"))
    else:
        q = linear(p["q"], x)
    q = q.reshape(B, S, H, dn + dr)
    return q[..., :dn], q[..., dn:]


def _latent(cfg, p, x, positions):
    """(q_nope, roped q_rope, c [B,S,r], roped kr [B,S,dr])."""
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    q_nope, q_rope = _queries(cfg, p, x)
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
    tokens.  Returns (y [B,S,D], (c [B,S,r], kr [B,S,dr]))."""
    B, S, _ = x.shape
    H, dn, dr, dv = (cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    q_nope, q_rope, c, kr = _latent(cfg, p, x, positions)
    k_nope = linear(p["k_up"], c).reshape(B, S, H, dn)
    v = linear(p["v_up"], c).reshape(B, S, H, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(B, S, H, dr)], dim=-1)
    y = ops.flash_attention(q, k, v.contiguous(), True, _scale(cfg))
    return linear(p["o"], y.reshape(B, S, H * dv)), (c, kr)


def mla_decode(cfg, p, x, positions, cache, write_pos, kv_valid_len):
    """Absorbed single-token decode.  x [B,1,D]; ``cache`` = (c [B,Smax,r],
    kr [B,Smax,dr]), written in place: the new latent rows land at
    ``write_pos`` [B] (``ops.kv_cache_write_pair``, one launch for both;
    positions outside the cache drop), then the token attends positions
    ``< kv_valid_len[b]`` (``ops.mla_decode_attention``).  Returns (y
    [B,1,D], cache)."""
    B = x.shape[0]
    H, dn, dv, r = (cfg.num_heads, cfg.qk_nope_dim, cfg.v_head_dim,
                    cfg.kv_lora_rank)
    c_cache, kr_cache = cache
    q_nope, q_rope, c_new, kr_new = _latent(cfg, p, x, positions)
    ops.kv_cache_write_pair(c_cache, c_new[:, 0].to(c_cache.dtype),
                            kr_cache, kr_new[:, 0].to(kr_cache.dtype),
                            write_pos)
    # absorb: q_eff[b,h] = q_nope[b,h] · W_uk[:, h]^T  (W_uk: [r, H*dn]);
    # one f32-accumulated product per head, rounded once to x's dtype
    w_uk = p["k_up"]["w"].reshape(r, H, dn).permute(1, 2, 0)      # [H,dn,r]
    q_eff = torch.matmul(q_nope[:, 0].transpose(0, 1), w_uk)     # [H,B,r]
    ctx = ops.mla_decode_attention(
        q_eff.transpose(0, 1).contiguous(), q_rope[:, 0].contiguous(),
        c_cache, kr_cache, kv_valid_len.to(torch.int32), _scale(cfg))
    # read out through W_uv: [r, H*dv]
    w_uv = p["v_up"]["w"].reshape(r, H, dv).transpose(0, 1)      # [H,r,dv]
    y = torch.matmul(ctx.transpose(0, 1), w_uv)                   # [H,B,dv]
    out = linear(p["o"], y.transpose(0, 1).reshape(B, 1, H * dv))
    return out, cache
