"""The backward of causal flash self-attention — CUDA launch wrapper.

No TPU kernel corresponds: the reference trains through ``jax.grad`` of
its plain ``mha`` (``repro/models/layers.py:115``) and has no Pallas
backward.  The port's training forward runs the hand-written
``flash_attention`` kernel, so its gradient is a kernel of its own:
``csrc/flash_attention_bwd.cu`` (design note there).  Three launches on
PyTorch's current stream — D = rowsum(dO * O), then dK and dV a 64-key
tile at a time (a GQA group's query heads summed inside the block), then
dQ a 64-row query tile at a time — with no float atomics, so a launch
gives the same bits every time.  bf16 on the tensor cores, f32 on CUDA
cores; causal self-attention only (Skv = S, no window), at the (q/k, v)
head widths in ``HEAD_DIMS``.  The bound is the operations: 10 hd per
attended (query, key, head), 43 GFLOP (43.5 µs) at qwen3-30b-a3b's B = 2,
S = 1024.

The wrapper takes CUDA tensors only: it checks device, dtype, shape,
contiguity and alignment, allocates the gradients and the D scratch,
launches and counts the launch.  ``kernels/ops.py`` dispatches CPU
tensors to ``kernels/ref.py``'s ``flash_attention_bwd_ref``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"flash_attention_bwd_launch":
               [_I] + [_P] * 10 + [_I] * 6 + [_F, _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (q/k head dim, v head dim) instances: TEST_MOE's and the smoke
#: configs', qwen3-30b-a3b's and deepseek-v2-lite's MLA
HEAD_DIMS = ((16, 16), (48, 32), (64, 64), (128, 128), (192, 128))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, scale: float | None = None):
    """The gradient of causal self-attention: q [B,S,H,hd], k [B,S,KVH,hd],
    v [B,S,KVH,hdv], the forward's output o and its gradient do
    [B,S,H,hdv], the forward's row log-sum-exp lse [B,H,S] f32
    (``flash_attention(..., lse=True)``) -> (dq, dk, dv) in the inputs'
    dtype.  ``scale`` is the forward's (default ``1/sqrt(hd)``)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a {dev.type} tensor")
    if q.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype} (bfloat16 or float32)")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do),
                    ("lse", lse)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if t.dtype != (torch.float32 if name == "lse" else q.dtype):
            raise TypeError(f"{name} dtype {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("shapes: q [B,S,H,hd], k [B,S,KVH,hd], v "
                         "[B,S,KVH,hdv]")
    B, S, H, hd = q.shape
    KVH, hdv = k.shape[2], v.shape[3]
    if (k.shape != (B, S, KVH, hd) or v.shape[:3] != (B, S, KVH)
            or H % KVH or o.shape != (B, S, H, hdv)
            or do.shape != o.shape or lse.shape != (B, H, S)):
        raise ValueError(f"the backward is causal self-attention: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)}")
    if (hd, hdv) not in HEAD_DIMS:
        raise ValueError(f"head dims (q/k, v) = {(hd, hdv)} not in "
                         f"{HEAD_DIMS} (the other widths' backward is "
                         f"ROADMAP §1 item 7's open work)")
    scale = 1.0 / math.sqrt(hd) if scale is None else float(scale)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    dsum = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    lib = _build.load("flash_attention_bwd", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_bwd_launch(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, H, KVH, hd,
            hdv, scale, stream)
    _build.check(lib, rc, "flash_attention_bwd")
    _build.count_launch(flash_attention_bwd)
    return dq, dk, dv


flash_attention_bwd.launches = 0
