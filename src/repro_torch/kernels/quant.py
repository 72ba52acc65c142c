"""Symmetric per-row int8 quantization — the port's own copy of
``repro.kernels.quant``.

``scale = max(max|x|, EPS) / 127`` over the row, ``q = clip(round(x /
scale), -127, 127)`` as int8, computed in f32.  ``torch.round`` rounds
half to even, as ``jnp.round`` does, so both packages give the same int8
values and scales for the same rows.  The scale is a sidecar that travels
with its rows:

* KV blocks — one f32 scale per (block, slot) token row of each of k and
  v, as ``[NB, bs]`` pools addressed by the same block table as the int8
  entry pools;
* expert pages — one f32 scale per (page, bank), as ``moe_pool/*_scale``
  ``[pages]`` beside the int8 banks, addressed by the same page table.
"""
from __future__ import annotations

import torch

INT8_MAX = 127.0
#: floor on the row max so all-zero rows quantize to scale EPS/127, not 0/0
EPS = 1e-8


def quantize_rows(x: torch.Tensor, axes) -> tuple:
    """Quantize ``x`` to int8 with one shared scale per row, where a "row"
    is everything spanned by ``axes`` (``(-2, -1)`` for a KV token row
    ``[KVH, hd]`` or an expert page ``[D, F]``).  Returns ``(q, scale)``:
    ``q`` int8 of ``x.shape``, ``scale`` f32 of the remaining dims."""
    axes = tuple(axes)
    xf = x.float()
    amax = xf.abs().amax(dim=axes, keepdim=True)
    scale = amax.clamp_min(EPS) / INT8_MAX
    q = torch.round(xf / scale).clamp_(-INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scale.squeeze(axes)


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor, axes) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` up to rounding (f32 output)."""
    s = scale.float()
    for ax in sorted(tuple(axes)):
        s = s.unsqueeze(ax if ax >= 0 else q.dim() + ax)
    return q.float() * s
