"""Mamba2 SSD chunk scan — CUDA launch wrapper.

Port of the Pallas TPU kernel ``ssd_scan`` (``repro/kernels/ssd_scan.py:67``);
the kernel and its design note are in ``csrc/ssd_scan.cu``.  The bytes bound
it (x, dt, B, C read once, y and the state written once: 28.05 MB at
mamba2-1.3b's 1,024-token prefill, 8.4 µs); the kernel runs one block per
(32 columns of P, head, sequence) with the chunk loop inside the block, the
[N, P] state in shared memory and C·Bᵀ recomputed per block as scalar f32
FMAs.  The Pallas wrapper broadcasts B and C to every head and transposes
x and y to head-major order; this kernel reads ``Bm[b]`` / ``Cm[b]`` once
per block and x and y in their [B,S,H,P] order.  The Pallas kernel needs S
divisible by the chunk; this one reads a ragged last chunk's rows past S
as dt = 0 and x = 0 (exact: decay 1, no input), so any S >= 1 works.

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates y and the state, launches on PyTorch's current
stream and counts the launch.  ``kernels/ops.py`` dispatches CPU tensors
to ``kernels/ref.py``'s ``ssd_scan_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"ssd_scan_launch": [_I] + [_P] * 7 + [_I] * 6 + [_P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: largest chunk Q = min(chunk, S) and state width N the kernel's shared
#: memory holds
MAX_CHUNK = 256
MAX_STATE = 256


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,P] (bf16 or f32); dt [B,S,H] f32; A [H] f32; Bm/Cm [B,S,N]
    of x's dtype -> (y [B,S,H,P] f32, final state [B,H,N,P] f32), in chunks
    of ``min(chunk, S)`` rows (at most ``MAX_CHUNK``)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a {dev.type} tensor")
    if x.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {x.dtype} (bfloat16 or float32)")
    for name, t, want in (("x", x, x.dtype), ("dt", dt, torch.float32),
                          ("A", A, torch.float32), ("Bm", Bm, x.dtype),
                          ("Cm", Cm, x.dtype)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, x on {dev}")
        if t.dtype != want:
            raise TypeError(f"{name} dtype {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 4:
        raise ValueError("x must be [B,S,H,P]")
    B, S, H, P = x.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    if dt.shape != (B, S, H) or A.shape != (H,) \
            or Bm.shape != (B, S, N) or Cm.shape != (B, S, N):
        raise ValueError(f"shapes: x [B,S,H,P], dt [B,S,H], A [H], Bm/Cm "
                         f"[B,S,N]; got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    if min(B, S, H, P, N) < 1 or chunk < 1:
        raise ValueError("empty input or chunk < 1")
    Q = min(int(chunk), S)
    if Q > MAX_CHUNK or N > MAX_STATE:
        raise ValueError(f"chunk {Q} or state width {N} above the kernel's "
                         f"{MAX_CHUNK} / {MAX_STATE}")
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=dev)
    state = torch.empty((B, H, N, P), dtype=torch.float32, device=dev)
    lib = _build.load("ssd_scan", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ssd_scan_launch(
            _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), state.data_ptr(), B,
            S, H, P, N, Q, stream)
    _build.check(lib, rc, "ssd_scan")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
