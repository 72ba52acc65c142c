"""Paged grouped expert matmul — CUDA launch wrapper and the expert FFN.

Port of the Pallas TPU kernel ``paged_gmm`` (``repro/kernels/moe_gmm.py:83``)
and of ``paged_expert_ffn`` (``:131``), which stays the same three-call
composition.  The kernel and its design note are in ``csrc/moe_gmm.cu``.
The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the output, launches on PyTorch's current stream and
counts the launch.  ``kernels/ops.py`` dispatches CPU tensors to the plain
versions in ``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"paged_gmm_launch": [_I] + [_P] * 4 + [_I] * 5 + [_P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_gmm(table: torch.Tensor, pool: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """out[e] = x[e] @ pool[table[e]] for each local expert e.

    table [E] int32; pool [P,D,F]; x [E,C,D] -> [E,C,F] in x's dtype.
    Aliased tables (several entries naming one page) are fine: every block
    only reads ``pool[table[e]]``."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a {dev.type} tensor")
    if x.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {x.dtype} (bfloat16 or float32)")
    if pool.dtype != x.dtype:
        raise TypeError(f"pool dtype {pool.dtype} != x dtype {x.dtype}")
    if table.dtype != torch.int32:
        raise TypeError(f"table must be int32, got {table.dtype}")
    for name, t in (("table", table), ("pool", pool), ("x", x)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 3 or pool.dim() != 3 or table.shape != (x.shape[0],) \
            or pool.shape[1] != x.shape[2]:
        raise ValueError(f"shapes: table [E], pool [P,D,F], x [E,C,D]; got "
                         f"{tuple(table.shape)}, {tuple(pool.shape)}, "
                         f"{tuple(x.shape)}")
    E, C, D = x.shape
    P, _, F = pool.shape
    out = torch.empty((E, C, F), dtype=x.dtype, device=dev)
    if E == 0 or C == 0:
        return out
    lib = _build.load("moe_gmm", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.paged_gmm_launch(_DTYPES[x.dtype], table.data_ptr(),
                                  x.data_ptr(), pool.data_ptr(),
                                  out.data_ptr(), E, C, D, F, P, stream)
    _build.check(lib, rc, "paged_gmm")
    paged_gmm.launches += 1
    return out


paged_gmm.launches = 0


def paged_expert_ffn(table_i, table_g, table_o, pool_i, pool_g, pool_o, x):
    """SwiGLU expert FFN over paged weights, ``down(up(x) * silu(gate(x)))``,
    as three ``paged_gmm`` launches with independent page tables.  Rounding
    points as the reference: ``h`` and ``g`` in x's dtype, ``silu`` of ``g``
    in f32 and rounded, then the product."""
    h = paged_gmm(table_i, pool_i, x)
    g = paged_gmm(table_g, pool_g, x)
    h = h * torch.nn.functional.silu(g.float()).to(h.dtype)
    return paged_gmm(table_o, pool_o, h)
