"""In-place one-row write into the slot-contiguous KV cache — CUDA launch
wrapper.

Port of the Pallas TPU kernel ``kv_cache_write``
(``repro/kernels/kv_write.py:37``); the kernel and its design note are in
``csrc/kv_write.cu``.  The bytes bound it (each of the B new rows read and
written once: 16 KiB at B = 8 on qwen3-30b-a3b, nanoseconds), so one
launch is its cost: one block per row copies the row's raw bytes, 16 at a
time, with the position read on the device — no host synchronisation, no
dtype dispatch.

Contract (the plain version ``kernels/ref.py``'s ``kv_cache_write_ref``
keeps it too): ``cache`` is written in place and returned; a ``pos``
outside ``[0, S)`` writes nothing, as JAX's ``.at[].set(mode="drop")``
drops it.  The wrapper takes CUDA tensors only, checks them, launches on
PyTorch's current stream and counts the launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"kv_cache_write_launch":
               [_P] * 3 + [_I] * 2 + [ctypes.c_longlong, _I, _P]}


def kv_cache_write(cache: torch.Tensor, new: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
    """cache [B,S,KVH,hd]; new [B,KVH,hd] of the cache's dtype (the caller
    casts, as the reference's ``.astype(cache.dtype)`` does); pos [B]
    int32.  Writes ``cache[b, pos[b]] = new[b]`` in place and returns
    ``cache``."""
    dev = cache.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a {dev.type} tensor")
    if new.dtype != cache.dtype:
        raise TypeError(f"new dtype {new.dtype}, cache {cache.dtype}")
    if pos.dtype != torch.int32:
        raise TypeError(f"pos must be int32, got {pos.dtype}")
    for name, t in (("cache", cache), ("new", new), ("pos", pos)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, cache on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cache.dim() < 3 or new.shape != (cache.shape[0], *cache.shape[2:]) \
            or pos.shape != cache.shape[:1]:
        raise ValueError(f"shapes: cache [B,S,...], new [B,...], pos [B]; "
                         f"got {tuple(cache.shape)}, {tuple(new.shape)}, "
                         f"{tuple(pos.shape)}")
    B, S = cache.shape[:2]
    row_bytes = new[0].numel() * new.element_size()
    vec = int(row_bytes % 16 == 0 and cache.data_ptr() % 16 == 0
              and new.data_ptr() % 16 == 0)
    lib = _build.load("kv_write", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.kv_cache_write_launch(cache.data_ptr(), new.data_ptr(),
                                       pos.data_ptr(), B, S, row_bytes, vec,
                                       stream)
    _build.check(lib, rc, "kv_cache_write")
    kv_cache_write.launches += 1
    return cache


kv_cache_write.launches = 0
