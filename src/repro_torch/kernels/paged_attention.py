"""Paged attention over the KV block pool, and decode attention over the
slot-contiguous KV cache — CUDA launch wrappers.

Port of the Pallas TPU kernels ``block_paged_decode_attention``
(``repro/kernels/paged_attention.py:123``), ``mixed_block_paged_attention``
(``:322``), their int8 variants ``quant_block_paged_decode_attention``
(``:217``) and ``quant_mixed_block_paged_attention`` (``:430``), and the
slot-contiguous ``paged_decode_attention`` (``:75``).  The three decodes
(bf16/f32 rows over the pool or the slot cache, int8 rows with their
scales over the pool) run the split-context kernel of
``csrc/paged_decode.cu``: one block per (context span of 128 tokens, kv
head, sequence).  The two mixed (chunked-prefill) attentions run
``csrc/paged_attention.cu``: in bf16 (bf16 or int8 pools) one block of
four warps per (tile of 64 query rows, kv head and sequence, context
span of 256 tokens) on the tensor cores; in f32 the CUDA-core kernel of
the first port.  A decode or a bf16 mixed attention whose rows attend
more than one span has its last block merge the spans in a fixed order
through a workspace and counters that ``_build.split_workspace`` /
``split_counters`` keep per stream.  Each source carries its design
note.  These wrappers take CUDA tensors only: they check device, dtype,
shape, contiguity and alignment, allocate the output, launch on
PyTorch's current stream and count the launch.  ``kernels/ops.py``
dispatches CPU tensors to the plain versions in ``kernels/ref.py``.

Every one of the five takes ``kv_head_offset`` and ``kv_heads``: it attends
kv heads ``[kv_head_offset, kv_head_offset + kv_heads)`` of a pool or cache
whose rows hold more (a TP rank's heads of the cache, which is replicated
over the ranks), reading them in place: the kernels step over a row of
the pool's full width and start at the offset head.  q carries ``kv_heads
* G`` heads.  The offset head's first byte is 16-byte aligned wherever
the head width is allowed at all.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "mixed_block_paged_attention_launch":
        [_I] + [_P] * 10 + [_I] * 10 + [_F, _P],
    "quant_mixed_block_paged_attention_launch":
        [_I] + [_P] * 12 + [_I] * 10 + [_F, _P],
}
_DECODE_SIGNATURES = {
    "block_paged_decode_attention_launch":
        [_I] + [_P] * 9 + [_I] * 9 + [_F, _P],
    "paged_decode_attention_launch": [_I] + [_P] * 9 + [_I] * 7 + [_F, _P],
    "quant_block_paged_decode_attention_launch":
        [_I] + [_P] * 11 + [_I] * 9 + [_F, _P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the split-context decode's limits: query heads per kv head, head width
#: (the bf16 mixed attention's widest head too)
MAX_GROUP, MAX_HEAD_DIM = 16, 128
#: context tokens one block of the split-context decode reads, as ``CH``
#: in ``csrc/paged_decode.cu``
TOKENS_PER_BLOCK = 128
#: the bf16 mixed attention's blocking, as ``TQ`` and ``SPAN`` in
#: ``csrc/paged_attention.cu``: query rows ((position, head) pairs of a kv
#: head) and context tokens a block reads
MIXED_ROWS_PER_BLOCK, MIXED_TOKENS_PER_BLOCK = 64, 256


def _lib():
    return _build.load("paged_attention", _SIGNATURES)


def _head_range(q, pool, kv_head_offset, kv_heads):
    """Check the kv heads ``[kv_head_offset, kv_head_offset + kv_heads)``
    of ``pool`` [..., KVH, hd] against q's H heads -> (KVH, kv_heads)."""
    KVH, hd = pool.shape[-2], pool.shape[-1]
    off = int(kv_head_offset)
    n = KVH - off if kv_heads is None else int(kv_heads)
    if off < 0 or n <= 0 or off + n > KVH:
        raise ValueError(f"kv heads [{off}, {off}+{n}) outside the pool's "
                         f"{KVH}")
    if q.shape[-2] % n:
        raise ValueError(f"{q.shape[-2]} query heads do not group over "
                         f"{n} kv heads")
    if off * hd * pool.element_size() % 16:
        raise ValueError(f"kv head {off} does not start 16-byte aligned in "
                         f"a row (head width {hd})")
    return KVH, n


def _check_common(q, k_pool, v_pool, block_tables, ints, scales=(),
                  kv_head_offset=0, kv_heads=None):
    """Checks shared by the four wrappers; ``scales`` are the int8 pools'
    ``(name, [NB,bs] f32)`` pairs (empty: pools of q's dtype).  Returns
    (NB, bs, KVH, kv_heads, hd): the pools' kv heads and the attended
    ones from ``kv_head_offset``."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a {dev.type} tensor")
    if q.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype} (bfloat16 or float32)")
    pool_dtype = torch.int8 if scales else q.dtype
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != pool_dtype:
            raise TypeError(f"{name} dtype {t.dtype}, expected {pool_dtype}")
    for name, t in scales:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.shape != k_pool.shape[:2]:
            raise ValueError(f"{name} must be [NB,bs] = "
                             f"{tuple(k_pool.shape[:2])}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), *ints, *scales):
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
    if hd2 != hd:
        raise ValueError(f"q heads/dim {H}/{hd} do not fit pool "
                         f"KVH/hd {KVH}/{hd2}")
    _, n = _head_range(q, k_pool, kv_head_offset, kv_heads)
    if scales and (hd % 8 or k_pool.data_ptr() % 8 or v_pool.data_ptr() % 8):
        raise ValueError("int8 pools are read 8 values at a time: hd must "
                         "be a multiple of 8 and the pools 8-byte aligned")
    return NB, bs, KVH, n, hd


def _decode_dims(q, block_tables, lengths):
    if q.dim() != 3 or block_tables.dim() != 2 \
            or block_tables.shape[0] != q.shape[0] \
            or lengths.shape != (q.shape[0],):
        raise ValueError("shapes: q [B,H,hd], block_tables [B,MB], "
                         "lengths [B]")
    return q.shape[0], q.shape[1], block_tables.shape[1]


def _mixed_dims(q, block_tables, ctx_lens, q_lens):
    if q.dim() != 4:
        raise ValueError("q must be [B,Sq,H,hd]")
    B = q.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or ctx_lens.shape != (B,) or q_lens.shape != (B,):
        raise ValueError("shapes: block_tables [B,MB], ctx_lens/q_lens [B]")
    return B, q.shape[1], q.shape[2], block_tables.shape[1]


def _mixed_launch(wrapper, q, kv, inputs, dims):
    """Launch ``<wrapper name>_launch(dtype, q, *inputs, out, ws_acc,
    ws_ml, done, *dims, 1/sqrt(hd), stream)`` of ``csrc/paged_attention.cu``
    (``dims`` = B, Sq, H, the attended kv heads, the pool's kv heads, the
    offset, hd, NB, bs, MB)
    on PyTorch's current stream, raise on a CUDA error, and count the
    launch on ``wrapper``.  bf16 runs the tensor-core kernel, with the
    stream's span workspace (``_build.split_workspace``) for every
    (row tile, kv head, sequence) and span of its table's positions; f32
    the CUDA-core kernel, which needs none.  ``kv`` are the K and V pools,
    also among ``inputs``."""
    B, Sq, H, hd = q.shape
    bs, KVH = kv[0].shape[1], dims[3]
    MB = dims[-1]
    if q.dtype == torch.bfloat16:
        if hd % 16 or hd > MAX_HEAD_DIM:
            raise ValueError(f"head dim {hd}: the bf16 mixed attention "
                             f"takes a multiple of 16, at most "
                             f"{MAX_HEAD_DIM} (whole k-steps of its "
                             f"tensor-core products)")
        if any(t.data_ptr() % 16 for t in (q, *kv)):
            raise ValueError("q and the pools must be 16-byte aligned "
                             "(read 16 bytes at a time)")
    lib = _lib()
    out = torch.empty_like(q)
    name = wrapper.__name__
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ws = (0, 0, 0)
        if q.dtype == torch.bfloat16:
            tiles = -(-Sq * (H // KVH) // MIXED_ROWS_PER_BLOCK)
            spans = max(1, -(-MB * bs // MIXED_TOKENS_PER_BLOCK))
            n_acc = B * KVH * tiles * spans * MIXED_ROWS_PER_BLOCK * hd
            done = _build.split_counters(q.device, stream, B * KVH * tiles)
            buf = _build.split_workspace(q.device, stream,
                                         n_acc + 2 * n_acc // hd)
            ws = (buf.data_ptr(), buf.data_ptr() + 4 * n_acc,
                  done.data_ptr())
        rc = getattr(lib, f"{name}_launch")(
            _DTYPES[q.dtype], q.data_ptr(), *(t.data_ptr() for t in inputs),
            out.data_ptr(), *ws, *dims, 1.0 / math.sqrt(hd), stream)
    _build.check(lib, rc, name)
    _build.count_launch(wrapper)
    return out


def _decode_launch(wrapper, q, kv, inputs, dims, context, scales=()):
    """Launch the split-context decode ``<wrapper name>_launch(dtype, q,
    *inputs, out, ws_acc, ws_ml, done, *dims, 1/sqrt(hd), stream)`` of
    ``csrc/paged_decode.cu`` on PyTorch's current stream, with a workspace
    for every span of ``context`` a block reads (``ceil(context /
    TOKENS_PER_BLOCK)`` per sequence and kv head; the stream's own,
    ``_build.split_workspace``); raise on a CUDA error, and count the
    launch on ``wrapper``.  ``kv`` are the K and V pools or caches and
    ``scales`` the int8 pools' scale pools, all also among ``inputs``;
    ``dims`` = B, H, the attended kv heads, the pool's kv heads, the
    offset, hd, then the layout's sizes."""
    B, H, hd = q.shape
    KVH = dims[2]
    G = H // KVH
    # f32 and int8 rows in whole 16-byte pieces; bf16 in whole 16-value
    # k-steps of the tensor-core products
    step = 4 if q.dtype == kv[0].dtype == torch.float32 else 16
    if G > MAX_GROUP or hd > MAX_HEAD_DIM or hd % step:
        raise ValueError(f"{H} query heads over {KVH} kv heads of width "
                         f"{hd}: the decode kernel takes at most "
                         f"{MAX_GROUP} heads per kv head and a head dim of "
                         f"at most {MAX_HEAD_DIM}, a multiple of {step}")
    if any(t.data_ptr() % 16 for t in (q, *kv)):
        raise ValueError("q and K/V must be 16-byte aligned (read 16 bytes "
                         "at a time)")
    if any(t.data_ptr() % 4 for t in scales):
        raise ValueError("the scale pools must be 4-byte aligned")
    lib = _build.load("paged_decode", _DECODE_SIGNATURES)
    splits = max(1, -(-context // TOKENS_PER_BLOCK))
    n_acc = B * KVH * splits * G * hd       # then B*KVH*splits*G (m, l)
    out = torch.empty_like(q)
    name = wrapper.__name__
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        done = _build.split_counters(q.device, stream, B * KVH)
        ws = _build.split_workspace(q.device, stream,
                                    n_acc + 2 * n_acc // hd)
        rc = getattr(lib, f"{name}_launch")(
            _DTYPES[q.dtype], q.data_ptr(),
            *(None if t is None else t.data_ptr() for t in inputs),
            out.data_ptr(), ws.data_ptr(), ws.data_ptr() + 4 * n_acc,
            done.data_ptr(), *dims, 1.0 / math.sqrt(hd), stream)
    _build.check(lib, rc, name)
    _build.count_launch(wrapper)
    return out


def block_paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 lengths: torch.Tensor, kv_head_offset=0,
                                 kv_heads=None) -> torch.Tensor:
    """q [B,H,hd]; k/v_pool [NB,bs,KVH,hd]; block_tables [B,MB] int32;
    lengths [B] int32, clamped to MB * bs -> [B,H,hd].  Block ``ki`` of
    sequence ``b`` is pool row ``block_tables[b, ki]``; blocks at or past
    ``lengths[b]`` are never read.  At most 16 query heads per kv head;
    hd at most 128, a multiple of 16 (bf16) or 4 (f32).  Kv heads from
    ``kv_head_offset`` (module note)."""
    NB, bs, KVH, n, hd = _check_common(q, k_pool, v_pool, block_tables,
                                       [("lengths", lengths)],
                                       kv_head_offset=kv_head_offset,
                                       kv_heads=kv_heads)
    B, H, MB = _decode_dims(q, block_tables, lengths)
    return _decode_launch(block_paged_decode_attention, q, (k_pool, v_pool),
                          (k_pool, v_pool, block_tables, lengths),
                          (B, H, n, KVH, kv_head_offset, hd, NB, bs, MB),
                          MB * bs)


block_paged_decode_attention.launches = 0


def mixed_block_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                block_tables: torch.Tensor,
                                ctx_lens: torch.Tensor,
                                q_lens: torch.Tensor, kv_head_offset=0,
                                kv_heads=None) -> torch.Tensor:
    """Mixed chunked-prefill / decode attention.  q [B,Sq,H,hd];
    k/v_pool [NB,bs,KVH,hd]; block_tables [B,MB]; ctx_lens, q_lens [B]
    int32 -> [B,Sq,H,hd].  Row ``i`` of sequence ``b`` attends causally
    from position ``ctx_lens[b] - q_lens[b] + i``; rows ``i >= q_lens[b]``
    attend the whole context.  The kernel clamps the ``NB`` sentinel in
    the tables to ``NB - 1`` where it reads them; position masking keeps
    such rows inert.  bf16: hd a multiple of 16, at most 128; q and the
    pools 16-byte aligned.  Kv heads from ``kv_head_offset`` (module
    note)."""
    NB, bs, KVH, n, hd = _check_common(q, k_pool, v_pool, block_tables,
                                       [("ctx_lens", ctx_lens),
                                        ("q_lens", q_lens)],
                                       kv_head_offset=kv_head_offset,
                                       kv_heads=kv_heads)
    B, Sq, H, MB = _mixed_dims(q, block_tables, ctx_lens, q_lens)
    return _mixed_launch(mixed_block_paged_attention, q, (k_pool, v_pool),
                         (k_pool, v_pool, block_tables, ctx_lens, q_lens),
                         (B, Sq, H, n, KVH, kv_head_offset, hd, NB, bs, MB))


mixed_block_paged_attention.launches = 0


def quant_block_paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                                       k_scale: torch.Tensor,
                                       v_pool: torch.Tensor,
                                       v_scale: torch.Tensor,
                                       block_tables: torch.Tensor,
                                       lengths: torch.Tensor,
                                       kv_head_offset=0,
                                       kv_heads=None) -> torch.Tensor:
    """:func:`block_paged_decode_attention` over int8 pools
    ``[NB,bs,KVH,hd]`` with f32 per-token scale pools ``k/v_scale``
    ``[NB,bs]`` (``quantize_rows`` over (KVH, hd)), read through the same
    table.  q bf16 or f32 -> [B,H,hd] in q's dtype.  At most 16 query
    heads per kv head; hd at most 128 and a multiple of 16 (whole 16-byte
    pieces of an int8 row); q and the pools 16-byte aligned.  Kv heads
    from ``kv_head_offset`` (module note), each token's scale covering its
    whole row."""
    NB, bs, KVH, n, hd = _check_common(
        q, k_pool, v_pool, block_tables, [("lengths", lengths)],
        scales=[("k_scale", k_scale), ("v_scale", v_scale)],
        kv_head_offset=kv_head_offset, kv_heads=kv_heads)
    B, H, MB = _decode_dims(q, block_tables, lengths)
    return _decode_launch(quant_block_paged_decode_attention, q,
                          (k_pool, v_pool),
                          (k_pool, k_scale, v_pool, v_scale, block_tables,
                           lengths),
                          (B, H, n, KVH, kv_head_offset, hd, NB, bs, MB),
                          MB * bs, (k_scale, v_scale))


quant_block_paged_decode_attention.launches = 0


def quant_mixed_block_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                                      k_scale: torch.Tensor,
                                      v_pool: torch.Tensor,
                                      v_scale: torch.Tensor,
                                      block_tables: torch.Tensor,
                                      ctx_lens: torch.Tensor,
                                      q_lens: torch.Tensor,
                                      kv_head_offset=0,
                                      kv_heads=None) -> torch.Tensor:
    """:func:`mixed_block_paged_attention` over int8 pools with f32
    per-token scale pools, as :func:`quant_block_paged_decode_attention`.
    At ``q_lens == 1`` it computes the int8 decode's function (another
    kernel, whose sums run in another order).  bf16 q: the limits of
    :func:`mixed_block_paged_attention`; f32 q: hd a multiple of 8 and
    8-byte aligned pools.  Kv heads from ``kv_head_offset`` (module
    note)."""
    NB, bs, KVH, n, hd = _check_common(
        q, k_pool, v_pool, block_tables,
        [("ctx_lens", ctx_lens), ("q_lens", q_lens)],
        scales=[("k_scale", k_scale), ("v_scale", v_scale)],
        kv_head_offset=kv_head_offset, kv_heads=kv_heads)
    B, Sq, H, MB = _mixed_dims(q, block_tables, ctx_lens, q_lens)
    return _mixed_launch(quant_mixed_block_paged_attention, q,
                         (k_pool, v_pool),
                         (k_pool, k_scale, v_pool, v_scale, block_tables,
                          ctx_lens, q_lens),
                         (B, Sq, H, n, KVH, kv_head_offset, hd, NB, bs, MB))


quant_mixed_block_paged_attention.launches = 0


def paged_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           lengths: torch.Tensor, kv_head_offset=0,
                           kv_heads=None, starts=None) -> torch.Tensor:
    """Decode attention over the slot-contiguous cache (the dense-KV
    serving mode).  q [B,H,hd]; k/v_cache [B,S_max,KVH,hd] of q's dtype;
    lengths [B] int32, clamped to S_max -> [B,H,hd].  Row b attends
    positions ``[starts[b], lengths[b])`` (``starts`` [B] int32, or None:
    from 0); positions outside are never read, and an empty range gives
    the uniform mean of all S_max rows of v, as the reference's ``-1e30``
    mask does (the windowed ring decode's;
    ``ref.paged_decode_attention_ref``).  The limits of
    :func:`block_paged_decode_attention` hold; kv heads from
    ``kv_head_offset`` (module note)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a {dev.type} tensor")
    if q.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype} (bfloat16 or float32)")
    ints = [("lengths", lengths)] + ([] if starts is None
                                     else [("starts", starts)])
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    *ints):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype}, expected {q.dtype}")
    for name, t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != q.shape[0] \
            or k_cache.shape[3] != q.shape[2] \
            or any(t.shape != (q.shape[0],) for _, t in ints):
        raise ValueError(f"shapes: q [B,H,hd], caches [B,S_max,KVH,hd], "
                         f"lengths and starts [B]; got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(lengths.shape)}")
    KVH, n = _head_range(q, k_cache, kv_head_offset, kv_heads)
    B, H, hd = q.shape
    S_max = k_cache.shape[1]
    return _decode_launch(paged_decode_attention, q, (k_cache, v_cache),
                          (k_cache, v_cache, lengths, starts),
                          (B, H, n, KVH, kv_head_offset, hd, S_max), S_max)


paged_decode_attention.launches = 0
