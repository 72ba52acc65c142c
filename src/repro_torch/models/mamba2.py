"""Mamba2 / SSD (state-space duality) block — the port of
``repro.models.mamba2``.  [arXiv:2405.21060]

Shapes: x [B,S,D]; d_inner = expand*D; heads H = d_inner/head_dim (P);
state N = ssm_state; one B/C group (G = 1).  ``in_proj`` gives ``z | xBC |
dt`` split at ``d_inner`` and ``2*d_inner + 2N``; a depthwise causal conv
of width K (silu after the bias) runs over ``xBC``, whose channels are
then ``x | B | C``.

A prefill runs the scan through ``ops.ssd_scan`` — the hand-written CUDA
kernel on the card (the reference computes the same chunked scan in plain
jnp, ``_ssd_chunked``, and holds its Pallas kernel equal to it).  Decode is
the O(1) recurrent update in plain torch, as in the reference.  The decode
cache is ``{'conv': [B, K-1, d_inner + 2N] (the raw, pre-conv xBC tail),
'state': [B, H, N, P] f32}``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_norm, linear, linear_init,
                                       norm_init)


def mamba2_init(gen: torch.Generator, cfg, dtype, device, lead=()):
    """One SSD block's parameters, ``[*lead, ...]`` each (the reference's
    tree: ``in_proj``, ``conv_w`` [K, C], ``conv_b``, ``A_log`` /
    ``dt_bias`` / ``D_skip`` [H] f32, ``norm``, ``out_proj``)."""
    D = cfg.d_model
    di, N, H, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    conv_dim = di + 2 * N

    def per_layer(v):
        return v.to(device).expand(*lead, *v.shape).clone()
    return {
        "in_proj": linear_init(gen, D, 2 * di + 2 * N + H, dtype, device,
                               lead=lead),
        "conv_w": torch.randn(*lead, K, conv_dim, generator=gen,
                              device=device, dtype=torch.float32)
        .mul_(1.0 / math.sqrt(K)).to(dtype),
        "conv_b": torch.zeros(*lead, conv_dim, dtype=dtype, device=device),
        "A_log": per_layer(torch.log(torch.linspace(1.0, 16.0, H))),
        "dt_bias": torch.zeros(*lead, H, device=device),
        "D_skip": torch.ones(*lead, H, device=device),
        "norm": norm_init(di, "rmsnorm", dtype, device, lead),
        "out_proj": linear_init(gen, di, D, dtype, device, lead=lead),
    }


def _split_in_proj(cfg, h):
    di, N = cfg.d_inner, cfg.ssm_state
    return h[..., :di], h[..., di:2 * di + 2 * N], h[..., 2 * di + 2 * N:]


def _causal_conv(xBC, w, b):
    """Depthwise causal conv, width K: xBC [B,S,C], w [K,C] -> silu(conv +
    b), in xBC's dtype (the reference's sum of K shifted products)."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    y = sum(pad[:, i:i + S, :] * w[i][None, None] for i in range(K))
    return F.silu(y + b[None, None])


def _dt_and_A(p, dt):
    """softplus(dt + dt_bias) in f32 (``F.softplus`` returns x itself above
    20, where the reference's ``logaddexp(x, 0)`` is within 2e-9 of it)
    and A = -exp(A_log)."""
    return F.softplus(dt.float() + p["dt_bias"]), -torch.exp(p["A_log"])


def _gate_out(p, y, z, dtype):
    """D-skip already added: round to the working dtype, gate by silu(z),
    rmsnorm, out_proj."""
    y = apply_norm(p["norm"], y.to(dtype) * F.silu(z), "rmsnorm")
    return linear(p["out_proj"], y)


def mamba2_forward(cfg, p, x, return_cache=False):
    """Full-sequence SSD from a zero state.  x [B,S,D] -> y [B,S,D] (and,
    with ``return_cache``, the decode cache after the S tokens)."""
    Bsz, S, _ = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xBC_raw, dt = _split_in_proj(cfg, linear(p["in_proj"], x))
    xBC = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"])
    xh = xBC[..., :di].reshape(Bsz, S, H, P)
    dt, A = _dt_and_A(p, dt)
    y, state = ops.ssd_scan(xh.contiguous(), dt, A,
                            xBC[..., di:di + N].contiguous(),
                            xBC[..., di + N:].contiguous(), cfg.ssm_chunk)
    y = y + p["D_skip"][None, None, :, None] * xh.float()
    out = _gate_out(p, y.reshape(Bsz, S, di), z, x.dtype)
    if not return_cache:
        return out
    K = cfg.ssm_conv
    conv_tail = (xBC_raw[:, S - (K - 1):] if S >= K - 1
                 else F.pad(xBC_raw, (0, 0, K - 1 - S, 0)))
    return out, {"conv": conv_tail, "state": state}


def mamba2_decode(cfg, p, x, cache):
    """Single-token recurrent update.  x [B,1,D]; cache {'conv', 'state'}
    -> (y [B,1,D], new cache)."""
    Bsz = x.shape[0]
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xBC_new, dt = _split_in_proj(cfg, linear(p["in_proj"], x))
    conv_buf = torch.cat([cache["conv"], xBC_new], dim=1)        # [B,K,C]
    xBC = F.silu(torch.einsum("bkc,kc->bc", conv_buf, p["conv_w"])
                 + p["conv_b"])
    xh = xBC[:, :di].reshape(Bsz, H, P).float()
    Bm, Cm = xBC[:, di:di + N].float(), xBC[:, di + N:].float()
    dt, A = _dt_and_A(p, dt[:, 0])                                 # [B,H]
    decay = torch.exp(dt * A[None])
    state = cache["state"] * decay[:, :, None, None] + torch.einsum(
        "bn,bhp,bh->bhnp", Bm, xh, dt)
    y = torch.einsum("bn,bhnp->bhp", Cm, state)
    y = y + p["D_skip"][None, :, None] * xh
    out = _gate_out(p, y.reshape(Bsz, 1, di), z, x.dtype)
    return out, {"conv": conv_buf[:, 1:], "state": state}
