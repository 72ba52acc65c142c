"""Paged grouped expert matmul — CUDA launch wrappers and the expert FFNs.

Port of the Pallas TPU kernels ``paged_gmm`` (``repro/kernels/moe_gmm.py:83``)
and ``quant_paged_gmm`` (``:148``), and of ``paged_expert_ffn`` (``:131``)
and ``quant_paged_expert_ffn`` (``:192``), which stay the same three-call
compositions.  The kernels and their design note are in
``csrc/moe_gmm.cu``: bf16 x runs on the tensor cores, one pass over each
page for all of an expert's rows, over bf16 or int8 pages; f32 x and
ragged shapes run on CUDA cores.  :func:`gmm_instance` picks the instance
from the dtypes, D, F and the 16-byte alignment of x and the pool, never
from a failure.  The wrappers take CUDA tensors only: they check device,
dtype, shape and contiguity, allocate the output, launch on PyTorch's
current stream and count the launch.  ``kernels/ops.py`` dispatches CPU
tensors to the plain versions in ``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"paged_gmm_launch": [_I] + [_P] * 4 + [_I] * 6 + [_P],
               "quant_paged_gmm_launch": [_I] + [_P] * 5 + [_I] * 6 + [_P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel instances of ``csrc/moe_gmm.cu`` and their codes there: CUDA
#: cores (int8 pages by byte loads), CUDA cores with int8 pages by char4
#: loads, tensor cores
INSTANCES = {"fma": 0, "fma_char4": 1, "mma": 2}


def gmm_instance(x_dtype: torch.dtype, pool_dtype: torch.dtype, D: int,
                 F: int, x_ptr: int, pool_ptr: int) -> str:
    """The kernel instance that computes ``x @ page`` for x of ``x_dtype``
    [.., D] and pages of ``pool_dtype`` [D, F] at device addresses
    ``x_ptr`` and ``pool_ptr``: ``"mma"`` (tensor cores) for bf16 x whose
    rows and whose pages' rows come in 16-byte pieces (D % 8 == 0; F % 8
    == 0 for bf16 pages, F % 16 == 0 for int8) from 16-byte aligned
    tensors, which every served shape is; else the CUDA cores:
    ``"fma_char4"`` for int8 pages with F % 4 == 0 in a 4-byte aligned
    pool, ``"fma"`` otherwise (f32 x, the parity type, always)."""
    quant = pool_dtype == torch.int8
    if (x_dtype == torch.bfloat16 and D % 8 == 0 and F % (16 if quant else 8)
            == 0 and x_ptr % 16 == 0 and pool_ptr % 16 == 0):
        return "mma"
    if quant and F % 4 == 0 and pool_ptr % 4 == 0:
        return "fma_char4"
    return "fma"


def _check(table, pool, x, scales=None):
    """Checks shared by both wrappers (``scales``: the int8 pool's f32
    per-page scales [P]).  Returns (E, C, D, F, P)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a {dev.type} tensor")
    if x.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {x.dtype} (bfloat16 or float32)")
    pool_dtype = x.dtype if scales is None else torch.int8
    if pool.dtype != pool_dtype:
        raise TypeError(f"pool dtype {pool.dtype}, expected {pool_dtype}")
    if table.dtype != torch.int32:
        raise TypeError(f"table must be int32, got {table.dtype}")
    named = [("table", table), ("pool", pool), ("x", x)]
    if scales is not None:
        if scales.dtype != torch.float32:
            raise TypeError(f"scales must be float32, got {scales.dtype}")
        if scales.shape != pool.shape[:1]:
            raise ValueError(f"scales must be [P] = {pool.shape[0]}, got "
                             f"{tuple(scales.shape)}")
        named.append(("scales", scales))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 3 or pool.dim() != 3 or table.shape != (x.shape[0],) \
            or pool.shape[1] != x.shape[2]:
        raise ValueError(f"shapes: table [E], pool [P,D,F], x [E,C,D]; got "
                         f"{tuple(table.shape)}, {tuple(pool.shape)}, "
                         f"{tuple(x.shape)}")
    return (*x.shape, pool.shape[2], pool.shape[0])


def paged_gmm(table: torch.Tensor, pool: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """out[e] = x[e] @ pool[table[e]] for each local expert e.

    table [E] int32; pool [P,D,F]; x [E,C,D] -> [E,C,F] in x's dtype.
    Aliased tables (several entries naming one page) are fine: every block
    only reads ``pool[table[e]]``."""
    E, C, D, F, P = _check(table, pool, x)
    dev = x.device
    out = torch.empty((E, C, F), dtype=x.dtype, device=dev)
    if E == 0 or C == 0:
        return out
    inst = INSTANCES[gmm_instance(x.dtype, pool.dtype, D, F, x.data_ptr(),
                                  pool.data_ptr())]
    lib = _build.load("moe_gmm", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.paged_gmm_launch(_DTYPES[x.dtype], table.data_ptr(),
                                  x.data_ptr(), pool.data_ptr(),
                                  out.data_ptr(), E, C, D, F, P, inst, stream)
    _build.check(lib, rc, "paged_gmm")
    _build.count_launch(paged_gmm)
    return out


paged_gmm.launches = 0


def quant_paged_gmm(table: torch.Tensor, pool: torch.Tensor,
                    scales: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """:func:`paged_gmm` over int8 pages: pool int8 [P,D,F] with one f32
    scale per page, scales [P], read through the same table; x bf16 or
    f32 [E,C,D] -> [E,C,F] in x's dtype.  Each output is ``(sum_d x *
    w_i8) * scale``, rounded once."""
    E, C, D, F, P = _check(table, pool, x, scales)
    dev = x.device
    out = torch.empty((E, C, F), dtype=x.dtype, device=dev)
    if E == 0 or C == 0:
        return out
    inst = INSTANCES[gmm_instance(x.dtype, pool.dtype, D, F, x.data_ptr(),
                                  pool.data_ptr())]
    lib = _build.load("moe_gmm", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.quant_paged_gmm_launch(_DTYPES[x.dtype], table.data_ptr(),
                                        x.data_ptr(), pool.data_ptr(),
                                        scales.data_ptr(), out.data_ptr(), E,
                                        C, D, F, P, inst, stream)
    _build.check(lib, rc, "quant_paged_gmm")
    _build.count_launch(quant_paged_gmm)
    return out


quant_paged_gmm.launches = 0


def paged_expert_ffn(table_i, table_g, table_o, pool_i, pool_g, pool_o, x):
    """SwiGLU expert FFN over paged weights, ``down(up(x) * silu(gate(x)))``,
    as three ``paged_gmm`` launches with independent page tables.  Rounding
    points as the reference: ``h`` and ``g`` in x's dtype, ``silu`` of ``g``
    in f32 and rounded, then the product."""
    h = paged_gmm(table_i, pool_i, x)
    g = paged_gmm(table_g, pool_g, x)
    h = h * torch.nn.functional.silu(g.float()).to(h.dtype)
    return paged_gmm(table_o, pool_o, h)


def quant_paged_expert_ffn(table_i, table_g, table_o, pool_i, pool_g, pool_o,
                           scale_i, scale_g, scale_o, x):
    """:func:`paged_expert_ffn` over int8 pages with per-page f32 scales:
    three ``quant_paged_gmm`` launches, the same rounding points."""
    h = quant_paged_gmm(table_i, pool_i, scale_i, x)
    g = quant_paged_gmm(table_g, pool_g, scale_g, x)
    h = h * torch.nn.functional.silu(g.float()).to(h.dtype)
    return quant_paged_gmm(table_o, pool_o, scale_o, h)
