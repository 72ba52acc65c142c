"""In-place writes of new K/V rows into the KV caches — CUDA launch
wrappers.

Port of the Pallas TPU kernel ``kv_cache_write``
(``repro/kernels/kv_write.py:37``) and of the paged writes the reference
leaves to XLA's scatter (``.at[...].set(mode="drop")``, with
``quantize_rows`` on an int8 pool); the kernels and their design note are
in ``csrc/kv_write.cu``.  The bytes are tiny (a qwen3-30b-a3b decode step
writes 32 KiB of K and V), so a launch is the cost, and every instance
writes what one step of one layer writes in one launch:

* ``kv_cache_write`` — one slot-contiguous cache, ``cache[b, pos[b]] =
  new[b]`` (the Pallas kernel's function);
* ``kv_cache_write_pair`` — two slot caches with their own row widths (K
  and V, or MLA's latent ``c`` and rope key ``kr``) at the same positions;
* ``kv_paged_write`` — a decode step's K and V rows into the block pools at
  ``(write_block[b], lengths[b] % bs)``;
* ``kv_block_write`` — whole blocks of ``bs`` token rows into pool rows
  ``ids`` (a prefill chunk, or every layer of a monolithic prefill).

The paged instances convert rows to the pool's type, or quantize each
token row to int8 and write its f32 scale in the same launch.  Positions
outside ``[0, S)`` and pool ids outside ``[0, NB)`` (the ``NB`` sentinel)
write nothing; the kernel reads positions, ids and lengths on the device,
so no instance synchronises with the host.  Contract (the plain versions
in ``kernels/ref.py`` keep it too): the caches are written in place; the
wrappers take CUDA tensors only, check them, launch on PyTorch's current
stream and count every launch on ``kv_cache_write.launches``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "kv_slot_write_launch": [_P, _P, _L, _L, _I] * 2 + [_I, _P, _I, _I, _P],
    "kv_paged_write_launch": [_I, _I] + [_P] * 8 + [_L] * 4 + [_I] * 6
                             + [_P],
}
#: row types the paged kernel reads, and the pool types it writes
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _check_device(dev: torch.device, **tensors) -> None:
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel given a {dev.type} tensor")
    for name, t in tensors.items():
        if t is not None and t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")


def _check_index(name: str, t: torch.Tensor, n: int) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.shape != (n,) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous [{n}], got "
                         f"{tuple(t.shape)}")


def _rows_contiguous(t: torch.Tensor, lead: int) -> bool:
    """The dims after the first ``lead`` are laid out contiguously (each
    token row is one run of memory; the leading strides are free)."""
    step = 1
    for size, stride in zip(reversed(t.shape[lead:]),
                            reversed(t.stride()[lead:])):
        if size != 1 and stride != step:
            return False
        step *= size
    return True


def _launch(fn: str, *args) -> None:
    """Launch ``fn`` of the library on the current stream and count it."""
    lib = _build.load("kv_write", _SIGNATURES)
    stream = torch.cuda.current_stream().cuda_stream
    _build.check(lib, getattr(lib, fn)(*args, stream), fn)
    _build.count_launch(kv_cache_write)


def _slot_args(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
               what: str) -> tuple:
    """(cache, new, row bytes, new's row stride in bytes, vec) of one slot
    cache, checked."""
    if new.dtype != cache.dtype:
        raise TypeError(f"{what}: new dtype {new.dtype}, cache {cache.dtype}")
    if not cache.is_contiguous():
        raise ValueError(f"{what}: cache must be contiguous")
    if cache.dim() < 3 or new.shape != (cache.shape[0], *cache.shape[2:]) \
            or pos.shape != cache.shape[:1]:
        raise ValueError(f"{what} shapes: cache [B,S,...], new [B,...], pos "
                         f"[B]; got {tuple(cache.shape)}, {tuple(new.shape)}, "
                         f"{tuple(pos.shape)}")
    if not _rows_contiguous(new, 1):
        raise ValueError(f"{what}: each row of new must be contiguous")
    esz = new.element_size()
    row_bytes = new[0].numel() * esz
    stride = new.stride(0) * esz
    vec = int(row_bytes % 16 == 0 and stride % 16 == 0
              and cache.data_ptr() % 16 == 0 and new.data_ptr() % 16 == 0)
    return cache, new, row_bytes, stride, vec


def _slot_write(caches, pos):
    dev = caches[0][0].device
    _check_device(dev, pos=pos, **{f"cache{i}": c for i, (c, _) in
                                   enumerate(caches)},
                  **{f"new{i}": n for i, (_, n) in enumerate(caches)})
    B, S = caches[0][0].shape[:2]
    _check_index("pos", pos, B)
    args = [_slot_args(c, n, pos, f"cache {i}")
            for i, (c, n) in enumerate(caches)]
    if any(c.shape[:2] != (B, S) for c, *_ in args):
        raise ValueError("the two caches must share [B, S]")
    if B == 0:
        return
    flat = []
    for c, n, row_bytes, stride, vec in args + args[:1] * (2 - len(args)):
        flat += [c.data_ptr(), n.data_ptr(), row_bytes, stride, vec]
    with torch.cuda.device(dev):
        _launch("kv_slot_write_launch", *flat, len(args), pos.data_ptr(), B,
                S)


def kv_cache_write(cache: torch.Tensor, new: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
    """cache [B,S,...]; new [B,...] of the cache's dtype (the caller casts,
    as the reference's ``.astype(cache.dtype)`` does; each row contiguous,
    rows at any stride); pos [B] int32.  Writes ``cache[b, pos[b]] =
    new[b]`` in place and returns ``cache``."""
    _slot_write([(cache, new)], pos)
    return cache


def kv_cache_write_pair(cache_a: torch.Tensor, new_a: torch.Tensor,
                        cache_b: torch.Tensor, new_b: torch.Tensor,
                        pos: torch.Tensor) -> tuple:
    """:func:`kv_cache_write` of two caches that share [B, S] and ``pos``
    (each with its own row width and dtype), in one launch.  Returns
    ``(cache_a, cache_b)``."""
    _slot_write([(cache_a, new_a), (cache_b, new_b)], pos)
    return cache_a, cache_b


def _paged_write(k_pool, v_pool, k_new, v_new, ids, lengths, k_scale,
                 v_scale, lead: int, what: str):
    """Checks and launches one paged write.  Pools [L,NB,bs,*row] (``lead``
    = 0: the pools' own [NB,bs,*row], L = 1); rows [B,*row] (``lengths``
    given) or [L, n*bs, *row]."""
    dev = k_pool.device
    _check_device(dev, v_pool=v_pool, k_new=k_new, v_new=v_new, ids=ids,
                  lengths=lengths, k_scale=k_scale, v_scale=v_scale)
    if v_pool.shape != k_pool.shape or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"{what}: K pool {tuple(k_pool.shape)} "
                         f"{k_pool.dtype}, V pool {tuple(v_pool.shape)} "
                         f"{v_pool.dtype}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError(f"{what}: pools must be contiguous")
    L = k_pool.shape[0] if lead else 1
    NB, bs = k_pool.shape[lead:lead + 2]
    row_shape = k_pool.shape[lead + 2:]
    n = ids.shape[0] if ids.dim() == 1 else -1
    _check_index("ids", ids, n)
    if lengths is not None:
        _check_index("lengths", lengths, n)
        want = (n, *row_shape)
    else:
        want = (L, n * bs, *row_shape)
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if t.shape != want:
            raise ValueError(f"{what}: {name} {tuple(t.shape)}, expected "
                             f"{want}")
        if not _rows_contiguous(t, len(want) - len(row_shape)):
            raise ValueError(f"{what}: each row of {name} must be "
                             f"contiguous")
    if k_new.dtype != v_new.dtype or k_new.dtype not in (torch.float32,
                                                         torch.bfloat16):
        raise TypeError(f"{what}: rows must be float32 or bfloat16, got "
                        f"{k_new.dtype} and {v_new.dtype}")
    quant = k_pool.dtype == torch.int8
    if k_pool.dtype not in _CODES:
        raise TypeError(f"{what}: pool dtype {k_pool.dtype}")
    if quant:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s is None or s.dtype != torch.float32 \
                    or s.shape != k_pool.shape[:lead + 2] \
                    or not s.is_contiguous():
                raise ValueError(f"{what}: an int8 pool needs a contiguous "
                                 f"f32 {name} of "
                                 f"{tuple(k_pool.shape[:lead + 2])}")
    elif k_scale is not None or v_scale is not None:
        raise ValueError(f"{what}: scales given for a {k_pool.dtype} pool")
    if n == 0:
        return
    row = math.prod(row_shape)
    row_dim = len(want) - len(row_shape) - 1      # the token-row axis
    strides = []
    for t in (k_new, v_new):
        strides += [t.stride(row_dim), t.stride(0) if lengths is None else 0]
    esz = k_new.element_size()
    vec = int(row % 8 == 0
              and all(t.data_ptr() % 16 == 0
                      for t in (k_pool, v_pool, k_new, v_new))
              and all(s * esz % 16 == 0 for s in strides))
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        _launch("kv_paged_write_launch", _CODES[k_new.dtype],
                _CODES[k_pool.dtype], k_pool.data_ptr(), v_pool.data_ptr(),
                ptr(k_scale), ptr(v_scale),
                k_new.data_ptr(), v_new.data_ptr(), ids.data_ptr(),
                ptr(lengths), strides[0], strides[2], strides[1], strides[3],
                n, L, NB, bs, row, vec)


def kv_paged_write(k_pool: torch.Tensor, v_pool: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   write_block: torch.Tensor, lengths: torch.Tensor,
                   k_scale: torch.Tensor = None,
                   v_scale: torch.Tensor = None) -> None:
    """One decode step's rows into one layer's block pools, in one launch.
    Pools [NB,bs,KVH,hd] (bf16/f32, or int8 with f32 ``k_scale`` /
    ``v_scale`` [NB,bs]); k_new / v_new [B,KVH,hd] (f32 or bf16, each row
    contiguous); write_block, lengths [B] int32.  Row b goes to
    ``(write_block[b], lengths[b] % bs)``; a block outside ``[0, NB)``
    writes nothing."""
    _paged_write(k_pool, v_pool, k_new, v_new, write_block, lengths, k_scale,
                 v_scale, 0, "kv_paged_write")


def kv_block_write(k_pool: torch.Tensor, v_pool: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   ids: torch.Tensor, k_scale: torch.Tensor = None,
                   v_scale: torch.Tensor = None) -> None:
    """Whole blocks into the pools of L layers, in one launch.  Pools
    [L,NB,bs,KVH,hd] (scales [L,NB,bs] for int8); k_new / v_new [L, n*bs,
    KVH, hd] (token rows at any stride, each row contiguous); ids [n]
    int32.  Rows ``j*bs .. j*bs + bs - 1`` go to block ``ids[j]`` of every
    layer; an id outside ``[0, NB)`` writes nothing."""
    _paged_write(k_pool, v_pool, k_new, v_new, ids, None, k_scale, v_scale,
                 1, "kv_block_write")


kv_cache_write.launches = 0
