"""Causal blocked (flash) attention for a monolithic prefill — CUDA launch
wrapper.

Port of the Pallas TPU kernel ``flash_attention``
(``repro/kernels/flash_attention.py:72``); the kernel and its design note
are in ``csrc/flash_attention.cu``.  The bound is the operations (4·hd
per attended query, key and head: 8.6 GFLOP at S = 1024 on qwen3-30b-a3b,
8.7 µs at the bf16 tensor-core rate); the kernel runs them as scalar f32
FMAs on CUDA cores, one block per (64-row query tile, head, sequence)
with the accumulator in registers and a loop over key tiles that stops at
the causal limit.  The Pallas kernel needs S divisible by its tiles; this
one masks a ragged last tile itself, so any S >= 1 works (the serving
path's 64-token buckets are not all multiples of 128).

The wrapper takes CUDA tensors only: it checks device, dtype, shape,
contiguity and alignment, allocates the output, launches on PyTorch's
current stream and counts the launch.  ``kernels/ops.py`` dispatches CPU
tensors to ``kernels/ref.py``'s ``flash_attention_ref``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"flash_attention_launch":
               [_I] + [_P] * 4 + [_I] * 6 + [_F, _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q [B,S,H,hd]; k/v [B,S,KVH,hd] (query head h reads kv head
    h // (H/KVH)) -> [B,S,H,hd] in q's dtype; causal: row i attends rows
    t <= i.  hd in (64, 128)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a {dev.type} tensor")
    if q.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype} (bfloat16 or float32)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype}, q {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError("shapes: q [B,S,H,hd], k/v [B,S,KVH,hd]")
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    if k.shape[:2] != (B, S) or k.shape[3] != hd or H % KVH:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    lib = _build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_launch(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, S, H, KVH, hd, int(causal),
            1.0 / math.sqrt(hd), stream)
    _build.check(lib, rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
