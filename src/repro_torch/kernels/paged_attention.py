"""Paged attention over the KV block pool — CUDA launch wrappers.

Port of the Pallas TPU kernels ``block_paged_decode_attention``
(``repro/kernels/paged_attention.py:123``) and
``mixed_block_paged_attention`` (``:322``); the kernel and its design note
are in ``csrc/paged_attention.cu``.  These wrappers take CUDA tensors only:
they check device, dtype, shape and contiguity, allocate the output, launch
on PyTorch's current stream and count the launch.  ``kernels/ops.py``
dispatches CPU tensors to the plain versions in ``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "block_paged_decode_attention_launch":
        [_I] + [_P] * 6 + [_I] * 7 + [_F, _P],
    "mixed_block_paged_attention_launch":
        [_I] + [_P] * 7 + [_I] * 8 + [_F, _P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    return _build.load("paged_attention", _SIGNATURES)


def _check_common(q, k_pool, v_pool, block_tables, ints):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a {dev.type} tensor")
    if q.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype} (bfloat16 or float32)")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), *ints):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("block_tables", block_tables), *ints):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if k_pool.shape != v_pool.shape or k_pool.dim() != 4:
        raise ValueError(f"pools must match as [NB,bs,KVH,hd]: "
                         f"{tuple(k_pool.shape)} vs {tuple(v_pool.shape)}")
    H, hd = q.shape[-2], q.shape[-1]
    NB, bs, KVH, hd2 = k_pool.shape
    if hd2 != hd or H % KVH:
        raise ValueError(f"q heads/dim {H}/{hd} do not fit pool "
                         f"KVH/hd {KVH}/{hd2}")
    return NB, bs, KVH, hd


def block_paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 lengths: torch.Tensor) -> torch.Tensor:
    """q [B,H,hd]; k/v_pool [NB,bs,KVH,hd]; block_tables [B,MB] int32;
    lengths [B] int32 -> [B,H,hd].  Block ``ki`` of sequence ``b`` is pool
    row ``block_tables[b, ki]``; blocks at or past ``lengths[b]`` are never
    read."""
    NB, bs, KVH, hd = _check_common(q, k_pool, v_pool, block_tables,
                                    [("lengths", lengths)])
    B, H = q.shape[0], q.shape[1]
    if q.dim() != 3 or block_tables.dim() != 2 or block_tables.shape[0] != B \
            or lengths.shape != (B,):
        raise ValueError("shapes: q [B,H,hd], block_tables [B,MB], "
                         "lengths [B]")
    MB = block_tables.shape[1]
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.block_paged_decode_attention_launch(
            _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, H, KVH, hd, NB, bs, MB,
            1.0 / math.sqrt(hd), stream)
    _build.check(lib, rc, "block_paged_decode_attention")
    block_paged_decode_attention.launches += 1
    return out


block_paged_decode_attention.launches = 0


def mixed_block_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                block_tables: torch.Tensor,
                                ctx_lens: torch.Tensor,
                                q_lens: torch.Tensor) -> torch.Tensor:
    """Mixed chunked-prefill / decode attention.  q [B,Sq,H,hd];
    k/v_pool [NB,bs,KVH,hd]; block_tables [B,MB]; ctx_lens, q_lens [B]
    int32 -> [B,Sq,H,hd].  Row ``i`` of sequence ``b`` attends causally
    from position ``ctx_lens[b] - q_lens[b] + i``; rows ``i >= q_lens[b]``
    attend the whole context.  The kernel clamps the ``NB`` sentinel in
    the tables to ``NB - 1`` where it reads them; position masking keeps
    such rows inert."""
    NB, bs, KVH, hd = _check_common(q, k_pool, v_pool, block_tables,
                                    [("ctx_lens", ctx_lens),
                                     ("q_lens", q_lens)])
    if q.dim() != 4:
        raise ValueError("q must be [B,Sq,H,hd]")
    B, Sq, H = q.shape[0], q.shape[1], q.shape[2]
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or ctx_lens.shape != (B,) or q_lens.shape != (B,):
        raise ValueError("shapes: block_tables [B,MB], ctx_lens/q_lens [B]")
    MB = block_tables.shape[1]
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mixed_block_paged_attention_launch(
            _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), block_tables.data_ptr(), ctx_lens.data_ptr(),
            q_lens.data_ptr(), out.data_ptr(), B, Sq, H, KVH, hd, NB, bs, MB,
            1.0 / math.sqrt(hd), stream)
    _build.check(lib, rc, "mixed_block_paged_attention")
    mixed_block_paged_attention.launches += 1
    return out


mixed_block_paged_attention.launches = 0
