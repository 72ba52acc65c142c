"""Mamba2 SSD chunk scan — CUDA launch wrapper.

Port of the Pallas TPU kernel ``ssd_scan`` (``repro/kernels/ssd_scan.py:67``);
the kernels and their design note are in ``csrc/ssd_scan.cu``.  The bytes
bound it (x, dt, B, C read once, y and the state written once: 28.05 MB at
mamba2-1.3b's 1,024-token prefill, 8.4 µs).  bf16 x with N and P multiples
of 8, N <= ``MMA_MAX_STATE`` and P <= ``MMA_MAX_HEAD_DIM`` (every served
model) runs the chunk-parallel SSD algorithm on the tensor cores in three
launches: every chunk's own state contribution at once, the states passed
from chunk to chunk (an elementwise recurrence), then every chunk's rows
in tiles of 64, C·Bᵀ recomputed per block on the tensor cores.  f32, and
bf16 at other widths, run the sequential CUDA-core kernel (a block per 32
columns of P, head and sequence, walking the chunks in order).  The Pallas
wrapper broadcasts B and C to every head and transposes x and y to
head-major order; these kernels read ``Bm[b]`` / ``Cm[b]`` as they are and
x and y in their [B,S,H,P] order.  The Pallas kernel needs S divisible by
the chunk; these read a ragged last chunk's rows past S as dt = 0 and
x = 0 (exact: decay 1, no input), so any S >= 1 works.

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, picks the instance (``ssd_instance``), allocates y, the state
and the tensor-core instance's workspace, launches on PyTorch's current
stream and counts one launch per call, whatever the number of CUDA
kernels.  ``kernels/ops.py`` dispatches CPU tensors to ``kernels/ref.py``'s
``ssd_scan_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"ssd_scan_launch": [_I, _I] + [_P] * 8 + [_I] * 6 + [_P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: largest chunk Q = min(chunk, S) and state width N the kernel's shared
#: memory holds
MAX_CHUNK = 256
MAX_STATE = 256
#: the tensor-core instance's largest N and P, and the mma depth its
#: workspaces pad the chunk's rows and N to, as in ``csrc/ssd_scan.cu``
MMA_MAX_STATE, MMA_MAX_HEAD_DIM, PAD = 128, 64, 16


def _pad(v: int) -> int:
    return -(-v // PAD) * PAD


def ssd_instance(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor
                 ) -> str:
    """``"tensor_cores"`` for bf16 x with N and P multiples of 8 (16-byte
    rows), N <= ``MMA_MAX_STATE``, P <= ``MMA_MAX_HEAD_DIM`` and x, Bm,
    Cm 16-byte aligned; else ``"cuda_cores"``."""
    P, N = x.shape[-1], Bm.shape[-1]
    if x.dtype == torch.bfloat16 and N % 8 == 0 and P % 8 == 0 \
            and N <= MMA_MAX_STATE and P <= MMA_MAX_HEAD_DIM \
            and all(t.data_ptr() % 16 == 0 for t in (x, Bm, Cm)):
        return "tensor_cores"
    return "cuda_cores"


def workspace_bytes(B: int, S: int, H: int, P: int, N: int, Q: int) -> int:
    """The tensor-core instance's workspace: every chunk's own state
    contribution [B,H,nc,N,P] f32, the state entering each chunk split
    into bf16 hi and lo parts [B,H,nc,pad(N),P] (as mma fragments), each
    chunk's cumsum [B,H,nc,pad(Q)] f64 and decay [B,H,nc] f32."""
    bhc = B * H * -(-S // Q)
    return 4 * bhc * (N * P + _pad(N) * P + 2 * _pad(Q) + 1)


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
    mma = ssd_instance(x, Bm, Cm) == "tensor_cores"
    ws = torch.empty(workspace_bytes(B, S, H, P, N, Q) if mma else 0,
                     dtype=torch.uint8, device=dev)
    lib = _build.load("ssd_scan", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ssd_scan_launch(
            int(mma), _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
            state.data_ptr(), ws.data_ptr(), B, S, H, P, N, Q, stream)
    _build.check(lib, rc, "ssd_scan")
    _build.count_launch(ssd_scan)
    return y, state


ssd_scan.launches = 0
