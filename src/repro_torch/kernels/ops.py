"""Public kernel entry points: dispatch by the tensor's device.

A CPU tensor goes to the plain PyTorch version (``kernels/ref.py``); a CUDA
tensor launches the hand-written kernel or raises — there is no fallback
and no environment switch.  The one explicit way to run the plain versions
on the card is the ``use_reference()`` context manager, which the tests and
``chip_smoke.py``'s comparison phase use.

The three decodes and the two mixed attentions take ``kv_head_offset``
and ``kv_heads``: the kv heads ``[kv_head_offset, kv_head_offset +
kv_heads)`` of a pool that holds more (a TP rank's heads of the replicated
cache; ``kernels/ref.py``'s module note), read in place.

``flash_attention`` has a gradient: where grad is enabled and an input
requires it, it runs the ``torch.autograd.Function`` ``_FlashAttention``,
whose forward also returns each row's log-sum-exp and whose backward is
the hand-written ``flash_attention_bwd`` kernel (the plain versions on
the CPU and under ``use_reference()``, a choice its forward records for
the backward, which the autograd engine runs on a thread of its own).
Every other call, serving's and a CUDA graph's, takes the path it always
took.  ``reference_contexts`` carries ``use_reference()`` into the
recomputation of a ``torch.utils.checkpoint`` block, which the backward
runs on that thread too.

Launch counts live on the kernel wrappers (``<wrapper>.launches``, one per
launch and nowhere else; a CUDA graph's replay adds the launches its
capture recorded, ``_build.count_launch``); ``launch_counts`` reads and
``reset_launch_counts`` zeroes them.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Dict, Iterator

import torch

from repro_torch.kernels import (flash_attention as _flash, kv_write,
                                 mla_decode, moe_gmm, paged_attention, ref)
from repro_torch.kernels import flash_attention_bwd as _flash_bwd
from repro_torch.kernels import ssd_scan as _ssd

_REFERENCE = contextvars.ContextVar("repro_torch_use_reference",
                                    default=False)

#: kernel name -> wrapper carrying its ``launches`` count
KERNELS = {
    "block_paged_decode_attention":
        paged_attention.block_paged_decode_attention,
    "mixed_block_paged_attention":
        paged_attention.mixed_block_paged_attention,
    "paged_gmm": moe_gmm.paged_gmm,
    "quant_block_paged_decode_attention":
        paged_attention.quant_block_paged_decode_attention,
    "quant_mixed_block_paged_attention":
        paged_attention.quant_mixed_block_paged_attention,
    "quant_paged_gmm": moe_gmm.quant_paged_gmm,
    "flash_attention": _flash.flash_attention,
    "flash_attention_bwd": _flash_bwd.flash_attention_bwd,
    "paged_decode_attention": paged_attention.paged_decode_attention,
    "kv_cache_write": kv_write.kv_cache_write,
    "mla_decode_attention": mla_decode.mla_decode_attention,
    "ssd_scan": _ssd.ssd_scan,
}


@contextlib.contextmanager
def use_reference() -> Iterator[None]:
    """Run the plain PyTorch versions on CUDA tensors inside the block."""
    token = _REFERENCE.set(True)
    try:
        yield
    finally:
        _REFERENCE.reset(token)


def reference_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: the recomputation of a
    checkpointed block runs in the mode (kernels or ``use_reference()``)
    its forward ran in."""
    again = use_reference() if _REFERENCE.get() else contextlib.nullcontext()
    return contextlib.nullcontext(), again


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _plain(t: torch.Tensor) -> bool:
    """True where the plain version runs: CPU tensors, or CUDA tensors
    inside ``use_reference()``."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return _REFERENCE.get()
    raise ValueError(f"no kernel for device {t.device}")


def block_paged_decode_attention(q, k_pool, v_pool, block_tables, lengths,
                                 kv_head_offset=0, kv_heads=None):
    """Block-table paged decode attention (every decode tick, every
    layer); see ``paged_attention.block_paged_decode_attention``."""
    if _plain(q):
        return ref.block_paged_decode_attention_ref(
            q, k_pool, v_pool, block_tables, lengths, kv_head_offset,
            kv_heads)
    return paged_attention.block_paged_decode_attention(
        q, k_pool, v_pool, block_tables, lengths, kv_head_offset, kv_heads)


def mixed_block_paged_attention(q, k_pool, v_pool, block_tables, ctx_lens,
                                q_lens, kv_head_offset=0, kv_heads=None):
    """Mixed chunked-prefill / decode attention (every prefill chunk,
    every layer); see ``paged_attention.mixed_block_paged_attention``."""
    if _plain(q):
        return ref.mixed_block_paged_attention_ref(
            q, k_pool, v_pool, block_tables, ctx_lens, q_lens,
            kv_head_offset, kv_heads)
    return paged_attention.mixed_block_paged_attention(
        q, k_pool, v_pool, block_tables, ctx_lens, q_lens, kv_head_offset,
        kv_heads)


def paged_gmm(table, pool, x):
    """out[e] = x[e] @ pool[table[e]]; see ``moe_gmm.paged_gmm``."""
    if _plain(x):
        return ref.paged_gmm_ref(table, pool, x)
    return moe_gmm.paged_gmm(table, pool, x)


def paged_expert_ffn(table_i, table_g, table_o, pool_i, pool_g, pool_o, x):
    """Paged SwiGLU expert FFN (the pooled-expert serving hot path): three
    ``paged_gmm`` launches on the card."""
    if _plain(x):
        return ref.paged_expert_ffn_ref(table_i, table_g, table_o,
                                        pool_i, pool_g, pool_o, x)
    return moe_gmm.paged_expert_ffn(table_i, table_g, table_o,
                                    pool_i, pool_g, pool_o, x)


def quant_block_paged_decode_attention(q, k_pool, k_scale, v_pool, v_scale,
                                       block_tables, lengths,
                                       kv_head_offset=0, kv_heads=None):
    """Int8 block-table paged decode attention (every decode tick, every
    layer, with ``kv_dtype="int8"``); see
    ``paged_attention.quant_block_paged_decode_attention``."""
    if _plain(q):
        return ref.quant_block_paged_decode_attention_ref(
            q, k_pool, k_scale, v_pool, v_scale, block_tables, lengths,
            kv_head_offset, kv_heads)
    return paged_attention.quant_block_paged_decode_attention(
        q, k_pool, k_scale, v_pool, v_scale, block_tables, lengths,
        kv_head_offset, kv_heads)


def quant_mixed_block_paged_attention(q, k_pool, k_scale, v_pool, v_scale,
                                      block_tables, ctx_lens, q_lens,
                                      kv_head_offset=0, kv_heads=None):
    """Int8 mixed chunked-prefill / decode attention (every prefill chunk,
    every layer, with ``kv_dtype="int8"``); see
    ``paged_attention.quant_mixed_block_paged_attention``."""
    if _plain(q):
        return ref.quant_mixed_block_paged_attention_ref(
            q, k_pool, k_scale, v_pool, v_scale, block_tables, ctx_lens,
            q_lens, kv_head_offset, kv_heads)
    return paged_attention.quant_mixed_block_paged_attention(
        q, k_pool, k_scale, v_pool, v_scale, block_tables, ctx_lens, q_lens,
        kv_head_offset, kv_heads)


def quant_paged_gmm(table, pool, scales, x):
    """out[e] = x[e] @ (pool[table[e]] * scales[table[e]]) over int8
    pages; see ``moe_gmm.quant_paged_gmm``."""
    if _plain(x):
        return ref.quant_paged_gmm_ref(table, pool, scales, x)
    return moe_gmm.quant_paged_gmm(table, pool, scales, x)


def quant_paged_expert_ffn(table_i, table_g, table_o, pool_i, pool_g, pool_o,
                           scale_i, scale_g, scale_o, x):
    """Paged SwiGLU expert FFN over int8 pages (``expert_dtype="int8"``):
    three ``quant_paged_gmm`` launches on the card."""
    if _plain(x):
        return ref.quant_paged_expert_ffn_ref(table_i, table_g, table_o,
                                              pool_i, pool_g, pool_o,
                                              scale_i, scale_g, scale_o, x)
    return moe_gmm.quant_paged_expert_ffn(table_i, table_g, table_o, pool_i,
                                          pool_g, pool_o, scale_i, scale_g,
                                          scale_o, x)


class _FlashAttention(torch.autograd.Function):
    """Causal self-attention with its gradient (the training forward):
    the forward saves q, k, v, the output and its rows' log-sum-exp, the
    backward runs ``flash_attention_bwd`` on them."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.plain, ctx.scale = _plain(q), scale
        if ctx.plain:
            o, lse = ref.flash_attention_lse_ref(q, k, v, True, scale)
        else:
            o, lse = _flash.flash_attention(q, k, v, True, scale, lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = (ref.flash_attention_bwd_ref if ctx.plain
               else _flash_bwd.flash_attention_bwd)
        return (*bwd(q, k, v, o, lse, do.contiguous(), ctx.scale), None)


def flash_attention(q, k, v, causal=True, scale=None, window=None):
    """Blocked attention over a whole prompt (every monolithic prefill,
    every layer; MLA's at q/k width 192 and v width 128), causal or not,
    over its own keys or another sequence's (a cross-attention's image
    keys), with or without a sliding ``window``; see
    ``flash_attention.flash_attention``.  Where grad is enabled and an
    input requires it (training), causal self-attention without a window
    runs ``_FlashAttention``; the backward of the others is not ported
    (ROADMAP §1 item 7)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if not causal or window is not None or k.shape[1] != q.shape[1]:
            raise NotImplementedError(
                "flash_attention's backward covers causal self-attention "
                "without a window; the rest is ROADMAP §1 item 7's open "
                "work")
        if scale is None:
            scale = 1.0 / math.sqrt(q.shape[-1])
        return _FlashAttention.apply(q, k, v, float(scale))
    if _plain(q):
        return ref.flash_attention_ref(q, k, v, causal, scale, window)
    return _flash.flash_attention(q, k, v, causal, scale, window)


def paged_decode_attention(q, k_cache, v_cache, lengths, kv_head_offset=0,
                           kv_heads=None, starts=None):
    """Decode attention over the slot-contiguous cache (every decode tick,
    every layer, with ``kv_mode="dense"``), positions ``[starts, lengths)``
    (a windowed ring's, or a cross-attention's image rows); see
    ``paged_attention.paged_decode_attention``."""
    if _plain(q):
        return ref.paged_decode_attention_ref(q, k_cache, v_cache, lengths,
                                              kv_head_offset, kv_heads,
                                              starts)
    return paged_attention.paged_decode_attention(
        q, k_cache, v_cache, lengths, kv_head_offset, kv_heads, starts)


def kv_cache_write(cache, new, pos):
    """``cache[b, pos[b]] = new[b]`` in place, positions outside ``[0, S)``
    dropped (the Pallas kernel's function); see
    ``kv_write.kv_cache_write``.  Returns ``cache``."""
    if _plain(cache):
        return ref.kv_cache_write_ref(cache, new, pos)
    return kv_write.kv_cache_write(cache, new, pos)


def kv_cache_write_pair(cache_a, new_a, cache_b, new_b, pos):
    """:func:`kv_cache_write` of two slot caches at the same positions in
    one launch (every decode tick, once per attention layer, with
    ``kv_mode="dense"``: K and V, or MLA's latent and rope key); see
    ``kv_write.kv_cache_write_pair``.  Returns ``(cache_a, cache_b)``."""
    if _plain(cache_a):
        return ref.kv_cache_write_pair_ref(cache_a, new_a, cache_b, new_b,
                                           pos)
    return kv_write.kv_cache_write_pair(cache_a, new_a, cache_b, new_b,
                                        pos.to(torch.int32))


def kv_paged_write(k_pool, v_pool, k_new, v_new, write_block, lengths,
                   k_scale=None, v_scale=None):
    """A decode step's K and V rows into one layer's block pools at
    ``(write_block[b], lengths[b] % bs)``, quantized with their scales on
    an int8 pool, blocks outside ``[0, NB)`` dropped (every decode tick,
    once per layer, with ``kv_mode="paged"``); see
    ``kv_write.kv_paged_write``.  In place."""
    if _plain(k_pool):
        return ref.kv_paged_write_ref(k_pool, v_pool, k_new, v_new,
                                      write_block, lengths, k_scale, v_scale)
    return kv_write.kv_paged_write(k_pool, v_pool, k_new, v_new,
                                   write_block.to(torch.int32),
                                   lengths.to(torch.int32), k_scale, v_scale)


def kv_block_write(k_pool, v_pool, k_new, v_new, ids, k_scale=None,
                   v_scale=None):
    """Whole blocks of K and V rows into pool blocks ``ids`` of L layers'
    pools, quantized with their scales on an int8 pool, ids outside ``[0,
    NB)`` dropped (every prefill chunk, once per layer; every monolithic
    prefill into the pool, once); see ``kv_write.kv_block_write``.  In
    place."""
    if _plain(k_pool):
        return ref.kv_block_write_ref(k_pool, v_pool, k_new, v_new, ids,
                                      k_scale, v_scale)
    return kv_write.kv_block_write(k_pool, v_pool, k_new, v_new,
                                   ids.to(torch.int32), k_scale, v_scale)


def mla_decode_attention(q_eff, q_rope, c_cache, kr_cache, lengths, scale):
    """Absorbed MLA decode over the latent cache (every decode tick, every
    layer of an MLA model) -> latent context [B,H,r]; see
    ``mla_decode.mla_decode_attention``."""
    if _plain(q_eff):
        return ref.mla_decode_attention_ref(q_eff, q_rope, c_cache, kr_cache,
                                            lengths, scale)
    return mla_decode.mla_decode_attention(q_eff, q_rope, c_cache, kr_cache,
                                           lengths, scale)


def ssd_scan(x, dt, A, Bm, Cm, chunk):
    """Mamba2 SSD chunk scan from a zero state (every prefill, every SSM
    layer) -> (y [B,S,H,P] f32, final state [B,H,N,P] f32); see
    ``ssd_scan.ssd_scan``."""
    if _plain(x):
        return ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk)
    return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk)
