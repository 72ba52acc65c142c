"""Blocked (flash) attention for a monolithic prefill — CUDA launch
wrapper: causal self-attention, with or without a sliding window, and
the non-causal attention of an encoder or of a cross-attention over
another sequence's keys.

Port of the Pallas TPU kernel ``flash_attention``
(``repro/kernels/flash_attention.py:72``); the kernel and its design note
are in ``csrc/flash_attention.cu``.  The bound is the operations (4·hd
per attended query, key and head: 8.6 GFLOP at S = 1024 on qwen3-30b-a3b,
8.7 µs at the bf16 tensor-core rate).  In bf16, every served path's type,
the kernel runs them on the tensor cores (``mma.sync`` m16n8k16, f32
sums): one block per (64-row query tile, head, sequence), each warp's 16
query rows and their output in registers, K/V tiles through a two-stage
``cp.async`` ring, a loop over key tiles that stops at the causal limit,
and the probabilities split into two bf16 parts before P·V so that the
output is the f32 answer rounded once.  In f32, the parity type, it runs
on CUDA cores.  The Pallas kernel needs S divisible by its tiles; this
one masks a ragged last tile itself, so any S >= 1 works (the serving
path's 64-token buckets are not all multiples of 128).  Head widths: q/k
and v of 64, 80 (zamba2's shared attention block) or 128, or q/k 192 with
v 128 (MLA's prefill: the reference pads v to 192 and trims the output;
this instance reads and writes 128), and the reduced configs' 16 and
MLA's 48 with v 32 (the launcher's and the closed loop's f32 runs on the
card); the scale is the caller's, ``1/sqrt(hd)`` by default.  The
training forward also asks for each row's log-sum-exp, which the
backward (``kernels/flash_attention_bwd.py``) reads.

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
               [_I] + [_P] * 5 + [_I] * 9 + [_F, _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (q/k head dim, v head dim) instances
HEAD_DIMS = ((16, 16), (48, 32), (64, 64), (80, 80), (128, 128), (192, 128))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None,
                    window: int | None = None, lse: bool = False):
    """q [B,Sq,H,hd]; k [B,Skv,KVH,hd]; v [B,Skv,KVH,hdv] (query head h
    reads kv head h // (H/KVH)) -> [B,Sq,H,hdv] in q's dtype; row i and
    key t are positions i and t.  causal (Sq = Skv): row i attends keys
    t <= i; ``window`` W: keys with i - t < W (a row that attends none
    gets the uniform mean of v, ``ref.flash_attention_ref``); scores
    scaled by ``scale`` (default ``1/sqrt(hd)``).  (hd, hdv) in
    ``HEAD_DIMS``.  With ``lse`` it returns (out, lse [B,H,Sq] f32): each
    row's log-sum-exp of its scaled scores, which the backward reads
    (``ref.flash_attention_lse_ref``); out is the same bits either way."""
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
    if q.dim() != 4 or k.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError("shapes: q [B,Sq,H,hd], k [B,Skv,KVH,hd], v "
                         "[B,Skv,KVH,hdv]")
    B, S, H, hd = q.shape
    Skv, KVH, hdv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != B or k.shape[3] != hd or H % KVH:
        raise ValueError(f"q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)}")
    if causal and Skv != S:
        raise ValueError(f"a causal attention attends its own {S} keys, "
                         f"not {Skv}")
    if window is not None and int(window) < 1:
        raise ValueError(f"window {window} must be at least 1")
    if (hd, hdv) not in HEAD_DIMS:
        raise ValueError(f"head dims (q/k, v) = {(hd, hdv)} not in "
                         f"{HEAD_DIMS}")
    scale = 1.0 / math.sqrt(hd) if scale is None else float(scale)
    out = q.new_empty((B, S, H, hdv))
    row_lse = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
               if lse else None)
    lib = _build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_launch(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None if row_lse is None else row_lse.data_ptr(),
            B, S, Skv, H, KVH, hd, hdv, int(causal),
            0 if window is None else int(window), scale, stream)
    _build.check(lib, rc, "flash_attention")
    _build.count_launch(flash_attention)
    return out if row_lse is None else (out, row_lse)


flash_attention.launches = 0
