"""Plain PyTorch versions of the ported kernels — the port of
``repro.kernels.ref`` for the three kernels on the serving path.

The CPU tests hold these against the Pallas kernels; ``chip_smoke.py``
holds the CUDA kernels against these on the card.  They repeat the
reference's arithmetic (f32 accumulation, ``-1e30`` masking, a softmax over
the whole gathered context) and are no yardstick of speed.

Gathers through a table clamp out-of-range rows to the last pool row,
which is what a JAX gather does with the ``NB`` sentinel; position masking
keeps such rows inert.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _gather_rows(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return pool[table.long().clamp(0, pool.shape[0] - 1)]


def paged_gmm_ref(table, pool, x):
    """out[e] = x[e] @ pool[table[e]]; x [E,C,D], pool [P,D,F] -> [E,C,F]."""
    w = _gather_rows(pool, table)
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def paged_expert_ffn_ref(table_i, table_g, table_o, pool_i, pool_g, pool_o,
                         x):
    """``down(up(x) * silu(gate(x)))`` over paged weights, with the
    reference's rounding points: ``h`` and ``g`` in the working dtype,
    ``silu`` of ``g`` in f32 and rounded, then the product."""
    h = paged_gmm_ref(table_i, pool_i, x)
    g = paged_gmm_ref(table_g, pool_g, x)
    h = h * torch.nn.functional.silu(g.float()).to(h.dtype)
    return paged_gmm_ref(table_o, pool_o, h)


def paged_decode_attention_ref(q, k_cache, v_cache, lengths):
    """q [B,H,hd]; caches [B,S,KVH,hd]; lengths [B] -> [B,H,hd]."""
    B, H, hd = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    qg = q.reshape(B, KVH, G, hd).float()
    s = torch.einsum("bkgh,btkh->bkgt", qg, k_cache.float()) / math.sqrt(hd)
    t = torch.arange(S, device=q.device)[None, None, None]
    s = torch.where(t < lengths.long()[:, None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkh->bkgh", p, v_cache.float())
    return o.reshape(B, H, hd).to(q.dtype)


def block_paged_decode_attention_ref(q, k_pool, v_pool, block_tables,
                                     lengths):
    """Block-table paged decode: q [B,H,hd]; k/v_pool [NB,bs,KVH,hd];
    block_tables [B,MB]; lengths [B] -> [B,H,hd].  Gathers each sequence's
    K/V through its table into a contiguous view, then runs the dense
    masked decode attention."""
    B, H, hd = q.shape
    bs, KVH = k_pool.shape[1], k_pool.shape[2]
    MB = block_tables.shape[1]
    k = _gather_rows(k_pool, block_tables).reshape(B, MB * bs, KVH, hd)
    v = _gather_rows(v_pool, block_tables).reshape(B, MB * bs, KVH, hd)
    return paged_decode_attention_ref(q, k, v, lengths)


def mixed_block_paged_attention_ref(q, k_pool, v_pool, block_tables,
                                    ctx_lens, q_lens):
    """Mixed chunked-prefill / decode attention over the block pool.

    q [B,Sq,H,hd]: row ``i`` of sequence ``b`` is the query at absolute
    position ``ctx_lens[b] - q_lens[b] + i``; mask ``pos < ctx & pos <=
    q_abs``.  Rows ``i >= q_lens[b]`` are padding and attend over the whole
    context.  ``q_lens[b] == 1`` is plain paged decode."""
    B, Sq, H, hd = q.shape
    bs, KVH = k_pool.shape[1], k_pool.shape[2]
    MB = block_tables.shape[1]
    G = H // KVH
    k = _gather_rows(k_pool, block_tables).reshape(B, MB * bs, KVH, hd)
    v = _gather_rows(v_pool, block_tables).reshape(B, MB * bs, KVH, hd)
    qg = q.reshape(B, Sq, KVH, G, hd).float()
    s = torch.einsum("bqkgh,btkh->bkgqt", qg, k.float()) / math.sqrt(hd)
    ctx = ctx_lens.long()
    q_abs = (ctx - q_lens.long())[:, None] + torch.arange(
        Sq, device=q.device)[None]                               # [B,Sq]
    t = torch.arange(MB * bs, device=q.device)
    mask = (t[None, None, None, None, :] < ctx[:, None, None, None, None]) \
        & (t[None, None, None, None, :] <= q_abs[:, None, None, :, None])
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkh->bqkgh", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)
