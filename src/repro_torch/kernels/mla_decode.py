"""Absorbed MLA decode attention over the latent cache — CUDA launch
wrapper.

Port of the Pallas TPU kernel ``mla_decode_attention``
(``repro/kernels/mla_decode.py:73``); the kernels and their design note are
in ``csrc/mla_decode.cu``.  The bytes bound it (every latent row up to each
length read once: 6.64 MB for 5,764 context tokens of deepseek-v2-lite in
bf16, 2 µs).  bf16 runs on the tensor cores: one block per (sequence,
``TOKENS_PER_BLOCK`` tokens, ``HEADS_PER_BLOCK`` = 16 heads, the m of an
mma product), which reads each latent row of its span once for all 16
heads (a head count that is no multiple of 16 pads the last group).  f32
runs on CUDA cores, a block per (sequence, ``F32_HEADS_PER_BLOCK`` heads,
``F32_TOKENS_PER_BLOCK`` tokens).  Both merge a sequence's blocks in a
fixed order in the same launch: the last block of a sequence merges,
through a workspace, and counts on a buffer of counters, which every
launch leaves zero; ``_build`` keeps both per stream.

Two departures from the Pallas kernel, both kept by the plain version
``kernels/ref.py``'s ``mla_decode_attention_ref`` too:

* the scale is an argument (the model passes ``1/sqrt(dn+dr)``; the Pallas
  kernel derives ``1/sqrt(128+dr)`` or ``1/sqrt(r+dr)`` from the shapes,
  which differs from the model's on the reduced configs);
* any S works (the Pallas kernel asserts ``S % block_k == 0``): the
  kernels mask every token at or past the sequence's length (the staged
  tiles are zero there); a length of 0 gives zeros, as the Pallas kernel
  gives.

The wrapper takes CUDA tensors only: it checks device, dtype, shape,
contiguity and alignment, allocates the output, launches on PyTorch's
current stream and counts the launch.  ``kernels/ops.py`` dispatches CPU
tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"mla_decode_attention_launch":
               [_I] + [_P] * 9 + [_I] * 5 + [_F, _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (kv_lora_rank, qk_rope_dim) instances: deepseek-v2/v3 and their reduced
#: configs
SHAPES = ((512, 64), (64, 16))
#: heads and tokens a block serves, as in ``csrc/mla_decode.cu``: the
#: bf16 (tensor-core) kernel's and the f32 (CUDA-core) kernel's
HEADS_PER_BLOCK, TOKENS_PER_BLOCK = 16, 128
F32_HEADS_PER_BLOCK, F32_TOKENS_PER_BLOCK = 2, 256


def mla_decode_attention(q_eff: torch.Tensor, q_rope: torch.Tensor,
                         c_cache: torch.Tensor, kr_cache: torch.Tensor,
                         lengths: torch.Tensor, scale: float
                         ) -> torch.Tensor:
    """q_eff [B,H,r] (H even in f32); q_rope [B,H,dr]; c_cache [B,S,r];
    kr_cache [B,S,dr]; lengths [B] int32 (clamped to [0, S]) -> latent
    context [B,H,r] in q_eff's dtype."""
    dev = q_eff.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a {dev.type} tensor")
    if q_eff.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q_eff.dtype} (bfloat16 or "
                        f"float32)")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    for name, t in (("q_eff", q_eff), ("q_rope", q_rope),
                    ("c_cache", c_cache), ("kr_cache", kr_cache),
                    ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q_eff on {dev}")
        if t is not lengths and t.dtype != q_eff.dtype:
            raise TypeError(f"{name} dtype {t.dtype}, q_eff {q_eff.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    if q_eff.dim() != 3 or q_rope.dim() != 3 or c_cache.dim() != 3 \
            or kr_cache.dim() != 3:
        raise ValueError("shapes: q_eff [B,H,r], q_rope [B,H,dr], c_cache "
                         "[B,S,r], kr_cache [B,S,dr]")
    B, H, r = q_eff.shape
    S, dr = c_cache.shape[1], q_rope.shape[2]
    if q_rope.shape[:2] != (B, H) or tuple(c_cache.shape) != (B, S, r) \
            or tuple(kr_cache.shape) != (B, S, dr) \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"q_eff {tuple(q_eff.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, c_cache "
                         f"{tuple(c_cache.shape)}, kr_cache "
                         f"{tuple(kr_cache.shape)} and lengths "
                         f"{tuple(lengths.shape)} do not fit")
    if (r, dr) not in SHAPES:
        raise ValueError(f"(kv_lora_rank, qk_rope_dim) = {(r, dr)} not in "
                         f"{SHAPES}")
    if q_eff.dtype == torch.bfloat16:
        groups = -(-H // HEADS_PER_BLOCK)
        rows, span = groups * HEADS_PER_BLOCK, TOKENS_PER_BLOCK
    elif H % F32_HEADS_PER_BLOCK:
        raise ValueError(f"{H} heads: the f32 kernel takes an even count")
    else:
        groups = H // F32_HEADS_PER_BLOCK
        rows, span = H, F32_TOKENS_PER_BLOCK
    out = torch.empty_like(q_eff)
    # the splits of sequences longer than one block: [B,groups,splits,
    # heads a group,r] accumulators, then the same with (m, l) for r
    splits = max(1, -(-S // span))
    n_acc = B * rows * splits * r
    lib = _build.load("mla_decode", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        done = _build.split_counters(dev, stream, B * groups)
        ws = _build.split_workspace(dev, stream, n_acc + 2 * n_acc // r)
        rc = lib.mla_decode_attention_launch(
            _DTYPES[q_eff.dtype], q_eff.data_ptr(), q_rope.data_ptr(),
            c_cache.data_ptr(), kr_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), ws.data_ptr(), ws.data_ptr() + 4 * n_acc,
            done.data_ptr(), B, H, S, r, dr, float(scale), stream)
    _build.check(lib, rc, "mla_decode_attention")
    _build.count_launch(mla_decode_attention)
    return out


mla_decode_attention.launches = 0
