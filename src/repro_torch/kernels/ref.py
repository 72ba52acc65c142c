"""Plain PyTorch versions of the ported kernels — the port of
``repro.kernels.ref`` for the eleven kernels on the serving paths (bf16/f32
pools, int8 pools with f32 scales, the slot-contiguous KV cache of the
dense-KV mode with its monolithic prefill, the MLA latent cache, and the
Mamba2 SSD chunk scan), and of the training path's one kernel of its own:
the flash attention's backward, with the forward's row log-sum-exp that
it reads (``flash_attention_lse_ref``, ``flash_attention_bwd_ref``; the
reference has no kernel there and differentiates its ``mha`` with
``jax.grad``).

The CPU tests hold these against the Pallas kernels; ``chip_smoke.py``
holds the CUDA kernels against these on the card.  They repeat the
reference's arithmetic (f32 accumulation, ``-1e30`` masking, a softmax over
the whole gathered context, the SSD scan's chunked products) and are no
yardstick of speed.

Gathers through a table clamp out-of-range rows to the last pool row,
which is what a JAX gather does with the ``NB`` sentinel; position masking
keeps such rows inert.  The paged writes never clamp: an entry on the
sentinel is masked out before the scatter (on the CPU ``torch.nonzero``
syncs nothing), so it cannot land on a live row of block ``NB - 1``.

In-place contract: the ``kv_*write*_ref`` functions update the caches they
are given, as the CUDA kernels do and as the Pallas kernel's output
aliases its cache; every other function here allocates its output.

Head ranges: the three decodes and the two mixed attentions take
``kv_head_offset`` and ``kv_heads`` (default: every pool head from the
offset on).  They attend kv heads ``[kv_head_offset, kv_head_offset +
kv_heads)`` of a pool or cache that holds more (a TP rank's heads of the
replicated cache), q carrying ``kv_heads * G`` heads; the result equals the
plain version on those heads sliced out.  An int8 row's scale covers the
whole row, every head of the pool.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.quant import dequantize_rows, quantize_rows

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


def quant_paged_gmm_ref(table, pool, scales, x):
    """Dequantize-then-delegate for the int8 paged GMM: pool int8 [P,D,F],
    scales f32 [P] (one per page).  x is cast to f32 and the result back
    to x's dtype, as the reference oracle does.  The pages are gathered
    before they are dequantized (elementwise, so the same numbers as
    dequantizing the whole pool, without an f32 copy of it)."""
    w = dequantize_rows(_gather_rows(pool, table), _gather_rows(scales, table),
                        (-2, -1))
    return torch.einsum("ecd,edf->ecf", x.float(), w).to(x.dtype)


def quant_paged_expert_ffn_ref(table_i, table_g, table_o, pool_i, pool_g,
                               pool_o, scale_i, scale_g, scale_o, x):
    """:func:`paged_expert_ffn_ref` over int8 pages with per-page scales."""
    h = quant_paged_gmm_ref(table_i, pool_i, scale_i, x)
    g = quant_paged_gmm_ref(table_g, pool_g, scale_g, x)
    h = h * torch.nn.functional.silu(g.float()).to(h.dtype)
    return quant_paged_gmm_ref(table_o, pool_o, scale_o, h)


def _acc_type(t: torch.Tensor) -> torch.dtype:
    """The type the attention's plain versions compute in: f32, or f64
    for f64 inputs (``torch.autograd.gradcheck``'s type)."""
    return torch.promote_types(t.dtype, torch.float32)


def _flash_scores(q, k, causal, scale, window):
    """The masked, scaled scores of :func:`flash_attention_ref`, 1,024
    query rows at a time: yields [B,KVH,G,rows,Skv] in ``_acc_type``."""
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    kf = k.to(_acc_type(q))
    t = torch.arange(Skv, device=q.device)[None]
    for r0 in range(0, Sq, 1024):
        qg = q[:, r0:r0 + 1024].reshape(B, -1, KVH, G, hd).to(kf.dtype)
        s = torch.einsum("bqkgh,btkh->bkgqt", qg, kf) * scale
        i = torch.arange(r0, r0 + qg.shape[1], device=q.device)[:, None]
        mask = torch.ones(qg.shape[1], Skv, dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= t <= i
        if window is not None:
            mask &= i - t < window
        yield torch.where(mask, s, NEG_INF)


def flash_attention_ref(q, k, v, causal=True, scale=None, window=None):
    """q [B,Sq,H,hd]; k [B,Skv,KVH,hd]; v [B,Skv,KVH,hdv] (query head h
    reads kv head h // (H/KVH)) -> [B,Sq,H,hdv]; row i and key t are
    positions i and t.  causal (Sq = Skv): row i attends keys t <= i;
    ``window`` W: keys with i - t < W (the reference's sliding window, on
    the causal prefill and on a cross-attention alike); scores scaled by
    ``scale`` (default ``1/sqrt(hd)``).  A masked score is ``-1e30``, as in
    the reference's ``mha``: a row that attends no key (a cross row past
    the window) gets the uniform mean of all Skv rows of v.  The rows go
    1,024 at a time, as the reference's ``mha`` chunks them, which bounds
    the f32 scores held at once (a 9,216-token prompt's whole [S, S]
    score matrix would take 10.9 GB a sequence at 32 heads)."""
    B, Sq, H = q.shape[:3]
    vf = v.to(_acc_type(q))
    out = [torch.einsum("bkgqt,btkh->bqkgh", torch.softmax(s, dim=-1), vf)
           for s in _flash_scores(q, k, causal, scale, window)]
    return torch.cat(out, 1).reshape(B, Sq, H, v.shape[3]).to(q.dtype)


def flash_attention_lse_ref(q, k, v, causal=True, scale=None, window=None):
    """:func:`flash_attention_ref` and each row's log-sum-exp of its
    masked, scaled scores, lse [B,H,Sq] in f32 (f64 for f64 inputs): the
    units of ``s * scale``, so that row i's probabilities are ``exp(s *
    scale - lse[i])``, which :func:`flash_attention_bwd_ref` and the CUDA
    backward read."""
    B, Sq, H = q.shape[:3]
    vf = v.to(_acc_type(q))
    out, lse = [], []
    for s in _flash_scores(q, k, causal, scale, window):
        out.append(torch.einsum("bkgqt,btkh->bqkgh",
                                torch.softmax(s, dim=-1), vf))
        lse.append(torch.logsumexp(s, dim=-1))
    return (torch.cat(out, 1).reshape(B, Sq, H, v.shape[3]).to(q.dtype),
            torch.cat(lse, -1).reshape(B, H, Sq))


def flash_attention_bwd_ref(q, k, v, o, lse, do, scale=None):
    """The gradient of causal self-attention (:func:`flash_attention_ref`
    with ``causal=True``, Skv = S, no window) -> (dq, dk, dv) in q's, k's
    and v's types, each rounded once from f32 sums (f64 for f64 inputs).
    ``o`` [B,S,H,hdv] is the forward's output and ``lse`` [B,H,S] its
    rows' log-sum-exp (:func:`flash_attention_lse_ref`); ``do`` the
    output's gradient.  The textbook steps, 1,024 query rows at a time:
    P = exp(s * scale - lse), dV = P^T dO, dP = dO V^T, D_i = rowsum(dO
    * O), dS = P * (dP - D), dQ = scale dS K, dK = scale dS^T Q.  Under
    GQA a kv head's dK and dV sum over the query heads that read it."""
    B, S, H, hd = q.shape
    KVH, hdv = k.shape[2], v.shape[3]
    G = H // KVH
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    acc = _acc_type(q)
    kf, vf = k.to(acc), v.to(acc)
    dk = torch.zeros(B, S, KVH, hd, dtype=acc, device=q.device)
    dv = torch.zeros(B, S, KVH, hdv, dtype=acc, device=q.device)
    dq = []
    t = torch.arange(S, device=q.device)[None]
    for r0 in range(0, S, 1024):
        n = min(S - r0, 1024)
        qg, og, dog = (x[:, r0:r0 + n].reshape(B, n, KVH, G, -1).to(acc)
                       for x in (q, o, do))
        s = torch.einsum("bqkgh,btkh->bkgqt", qg, kf) * scale
        i = torch.arange(r0, r0 + n, device=q.device)[:, None]
        l = lse[:, :, r0:r0 + n].reshape(B, KVH, G, n, 1).to(acc)
        p = torch.where(t <= i, torch.exp(s - l), 0.0)
        dv += torch.einsum("bkgqt,bqkgh->btkh", p, dog)
        dp = torch.einsum("bqkgh,btkh->bkgqt", dog, vf)
        d = (dog * og).sum(-1).permute(0, 2, 3, 1)[..., None]
        ds = p * (dp - d)
        dq.append(torch.einsum("bkgqt,btkh->bqkgh", ds, kf) * scale)
        dk += torch.einsum("bkgqt,bqkgh->btkh", ds, qg) * scale
    return (torch.cat(dq, 1).reshape(B, S, H, hd).to(q.dtype),
            dk.to(k.dtype), dv.to(v.dtype))


def mla_decode_attention_ref(q_eff, q_rope, c_cache, kr_cache, lengths,
                             scale):
    """Absorbed MLA decode: q_eff [B,H,r], q_rope [B,H,dr], c_cache
    [B,S,r], kr_cache [B,S,dr], lengths [B] (clamped to S) -> the latent
    context [B,H,r] = softmax((q_eff·c + q_rope·kr) * scale) · c over the
    first ``lengths[b]`` rows, f32 inside, in q_eff's dtype.

    The scale is the caller's (the model passes ``1/sqrt(dn+dr)``; the
    reference's oracle derives ``1/sqrt(128+dr)`` or ``1/sqrt(r+dr)``
    from the shapes).  A length of 0 gives zeros, as the Pallas kernel,
    which skips every block, does; the reference's oracle would take a
    softmax over a row of ``-1e30`` and return the mean of ``c``."""
    c = c_cache.float()
    s = (torch.einsum("bhr,btr->bht", q_eff.float(), c)
         + torch.einsum("bhd,btd->bht", q_rope.float(),
                        kr_cache.float())) * scale
    t = torch.arange(c.shape[1], device=c.device)[None, None]
    keep = t < lengths.long()[:, None, None]
    p = torch.softmax(torch.where(keep, s, NEG_INF), dim=-1) * keep
    return torch.einsum("bht,btr->bhr", p, c).to(q_eff.dtype)


def kv_cache_write_ref(cache, new, pos):
    """cache [B,S,...]; new [B,...]; pos [B] -> ``cache``, written in place:
    ``cache[b, pos[b]] = new[b]`` cast to the cache's dtype; a ``pos``
    outside ``[0, S)`` writes nothing (JAX's ``mode="drop"``).  No host
    synchronisation: a dropped row rewrites the value it reads."""
    B, S = cache.shape[:2]
    p = pos.long()
    keep = (p >= 0) & (p < S)
    b = torch.arange(B, device=cache.device)
    p = p.clamp(0, S - 1)
    keep = keep.reshape(B, *([1] * (new.dim() - 1)))
    cache[b, p] = torch.where(keep, new.to(cache.dtype), cache[b, p])
    return cache


def kv_cache_write_pair_ref(cache_a, new_a, cache_b, new_b, pos):
    """:func:`kv_cache_write_ref` of two caches at the same positions ->
    ``(cache_a, cache_b)``."""
    return (kv_cache_write_ref(cache_a, new_a, pos),
            kv_cache_write_ref(cache_b, new_b, pos))


def _scatter_rows(pool, scale, index, rows, row_dims: int):
    """``pool[index] = rows`` in the pool's dtype, or, for an int8 pool,
    the rows quantized over their last ``row_dims`` dims and their scales
    into ``scale[index]``."""
    if scale is None:
        pool[index] = rows.to(pool.dtype)
        return
    q, s = quantize_rows(rows, tuple(range(-row_dims, 0)))
    pool[index] = q
    scale[index] = s


def kv_paged_write_ref(k_pool, v_pool, k_new, v_new, write_block, lengths,
                       k_scale=None, v_scale=None):
    """Decode-step write into one layer's pools [NB,bs,*row] (int8 pools
    with f32 scales [NB,bs]): row b of k_new / v_new [B,*row] goes to
    ``(write_block[b], lengths[b] % bs)``; a block outside ``[0, NB)``
    writes nothing (JAX's ``mode="drop"``).  In place."""
    NB, bs = k_pool.shape[:2]
    wb = write_block.long()
    keep = torch.nonzero((wb >= 0) & (wb < NB)).flatten()
    index = (wb[keep], (lengths.long() % bs)[keep])
    for pool, scale, new in ((k_pool, k_scale, k_new),
                             (v_pool, v_scale, v_new)):
        _scatter_rows(pool, scale, index, new[keep], k_pool.dim() - 2)


def kv_block_write_ref(k_pool, v_pool, k_new, v_new, ids, k_scale=None,
                       v_scale=None):
    """Whole-block write into the pools of L layers [L,NB,bs,*row] (int8
    pools with f32 scales [L,NB,bs]): rows ``j*bs .. j*bs + bs - 1`` of
    k_new / v_new [L, n*bs, *row] go to block ``ids[j]`` of every layer; an
    id outside ``[0, NB)`` writes nothing.  In place."""
    L, NB, bs = k_pool.shape[:3]
    row = k_pool.shape[3:]
    n = ids.shape[0]
    idl = ids.long()
    keep = torch.nonzero((idl >= 0) & (idl < NB)).flatten()
    for pool, scale, new in ((k_pool, k_scale, k_new),
                             (v_pool, v_scale, v_new)):
        rows = new.reshape(L, n, bs, *row)[:, keep]
        _scatter_rows(pool, scale, (slice(None), idl[keep]), rows, len(row))


def _heads(pool, kv_head_offset: int, kv_heads):
    """Kv heads ``[kv_head_offset, kv_head_offset + kv_heads)`` of a pool
    or cache [..., KVH, hd] (a view)."""
    n = pool.shape[-2] - kv_head_offset if kv_heads is None else kv_heads
    if kv_head_offset < 0 or n <= 0 \
            or kv_head_offset + n > pool.shape[-2]:
        raise ValueError(f"kv heads [{kv_head_offset}, {kv_head_offset}+{n})"
                         f" outside the pool's {pool.shape[-2]}")
    return pool[..., kv_head_offset:kv_head_offset + n, :]


def paged_decode_attention_ref(q, k_cache, v_cache, lengths,
                               kv_head_offset=0, kv_heads=None, starts=None):
    """q [B,H,hd]; caches [B,S,KVH,hd]; lengths [B] (clamped to S) ->
    [B,H,hd]; kv heads from ``kv_head_offset`` (module note).  Row b
    attends positions ``[starts[b], lengths[b])`` (``starts`` None: from
    0).  A masked score is ``-1e30``, as in the reference's ``mha``: an
    empty range gives the uniform mean of all S rows of v (the windowed
    ring decode's ``L >= 2W - 1``, ``models/model.py``'s ``_decode_slots``
    note)."""
    k_cache = _heads(k_cache, kv_head_offset, kv_heads)
    v_cache = _heads(v_cache, kv_head_offset, kv_heads)
    B, H, hd = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    qg = q.reshape(B, KVH, G, hd).float()
    s = torch.einsum("bkgh,btkh->bkgt", qg, k_cache.float()) / math.sqrt(hd)
    t = torch.arange(S, device=q.device)[None, None, None]
    keep = t < lengths.long()[:, None, None, None]
    if starts is not None:
        keep = keep & (t >= starts.long()[:, None, None, None])
    s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkh->bkgh", p, v_cache.float())
    return o.reshape(B, H, hd).to(q.dtype)


def block_paged_decode_attention_ref(q, k_pool, v_pool, block_tables,
                                     lengths, kv_head_offset=0,
                                     kv_heads=None):
    """Block-table paged decode: q [B,H,hd]; k/v_pool [NB,bs,KVH,hd];
    block_tables [B,MB]; lengths [B] -> [B,H,hd].  Gathers each sequence's
    K/V through its table into a contiguous view, then runs the dense
    masked decode attention.  Kv heads from ``kv_head_offset`` (module
    note)."""
    k_pool = _heads(k_pool, kv_head_offset, kv_heads)
    v_pool = _heads(v_pool, kv_head_offset, kv_heads)
    B, H, hd = q.shape
    bs, KVH = k_pool.shape[1], k_pool.shape[2]
    MB = block_tables.shape[1]
    k = _gather_rows(k_pool, block_tables).reshape(B, MB * bs, KVH, hd)
    v = _gather_rows(v_pool, block_tables).reshape(B, MB * bs, KVH, hd)
    return paged_decode_attention_ref(q, k, v, lengths)


def mixed_block_paged_attention_ref(q, k_pool, v_pool, block_tables,
                                    ctx_lens, q_lens, kv_head_offset=0,
                                    kv_heads=None):
    """Mixed chunked-prefill / decode attention over the block pool.

    q [B,Sq,H,hd]: row ``i`` of sequence ``b`` is the query at absolute
    position ``ctx_lens[b] - q_lens[b] + i``; mask ``pos < ctx & pos <=
    q_abs``.  Rows ``i >= q_lens[b]`` are padding and attend over the whole
    context.  ``q_lens[b] == 1`` is plain paged decode.  Kv heads from
    ``kv_head_offset`` (module note)."""
    k_pool = _heads(k_pool, kv_head_offset, kv_heads)
    v_pool = _heads(v_pool, kv_head_offset, kv_heads)
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


def quant_block_paged_decode_attention_ref(q, k_pool, k_scale, v_pool,
                                           v_scale, block_tables, lengths,
                                           kv_head_offset=0, kv_heads=None):
    """Dequantize-then-delegate for the int8 block-table decode: k/v_pool
    int8 [NB,bs,KVH,hd], k/v_scale f32 [NB,bs] (one per token row,
    ``quantize_rows`` over (KVH, hd)); the heads from ``kv_head_offset``
    (module note) are dequantized with their rows' scales."""
    k = dequantize_rows(_heads(k_pool, kv_head_offset, kv_heads), k_scale,
                        (-2, -1))
    v = dequantize_rows(_heads(v_pool, kv_head_offset, kv_heads), v_scale,
                        (-2, -1))
    return block_paged_decode_attention_ref(q, k, v, block_tables, lengths)


def quant_mixed_block_paged_attention_ref(q, k_pool, k_scale, v_pool,
                                          v_scale, block_tables, ctx_lens,
                                          q_lens, kv_head_offset=0,
                                          kv_heads=None):
    """Dequantize-then-delegate for the int8 mixed prefill/decode
    attention (same scale layout and head range as the int8 decode)."""
    k = dequantize_rows(_heads(k_pool, kv_head_offset, kv_heads), k_scale,
                        (-2, -1))
    v = dequantize_rows(_heads(v_pool, kv_head_offset, kv_heads), v_scale,
                        (-2, -1))
    return mixed_block_paged_attention_ref(q, k, v, block_tables, ctx_lens,
                                           q_lens)


def ssd_scan_ref(x, dt, A, Bm, Cm, chunk):
    """Mamba2 SSD chunk scan with one B/C group, the Pallas kernel's chunked
    arithmetic in f32: x [B,S,H,P]; dt [B,S,H] (> 0); A [H] (< 0); Bm/Cm
    [B,S,N] -> (y [B,S,H,P] f32, final state [B,H,N,P] f32), the state
    starting at zero.

    With Q = min(chunk, S) and ``acs`` the inclusive cumsum of ``dt * A``
    within a chunk, each chunk gives ``y = (C · state) * exp(acs) + ((C ·
    Bᵀ) ∘ exp(acs_i - acs_j)[i >= j] ∘ dt_j) · x`` and carries ``state *
    exp(acs[-1]) + (B * exp(acs[-1] - acs) * dt)ᵀ · x``.  A ragged last
    chunk (S not a multiple of Q, which the Pallas kernel refuses) is read
    as padded with rows of dt = 0 and x = B = C = 0: a decay of 1 and no
    input, so the padding changes neither y nor the state."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t):         # [B,S,...] f32, zero-padded -> [B,nc,Q,...]
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((Bsz, pad, *t.shape[2:]))], 1)
        return t.reshape(Bsz, nc, Q, *t.shape[2:])

    xc, dtc, bc, cc = chunks(x), chunks(dt), chunks(Bm), chunks(Cm)
    acs = torch.cumsum(dtc * A.float(), dim=2)                # [B,nc,Q,H]
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    state = x.new_zeros((Bsz, H, N, P), dtype=torch.float32)
    ys = []
    for c in range(nc):
        a, d, xq, bq, cq = acs[:, c], dtc[:, c], xc[:, c], bc[:, c], cc[:, c]
        y_off = torch.einsum("bqn,bhnp->bqhp", cq, state) \
            * torch.exp(a)[..., None]
        seg = a[:, :, None, :] - a[:, None, :, :]              # [B,Q,K,H]
        L = torch.exp(torch.where(causal[None, :, :, None], seg,
                                  float("-inf")))
        scores = torch.einsum("bqn,bkn->bqk", cq, bq)
        M = scores[..., None] * L * d[:, None]                 # [B,Q,K,H]
        y_diag = torch.einsum("bqkh,bkhp->bqhp", M, xq)
        decay_out = torch.exp(a[:, -1:] - a) * d               # [B,Q,H]
        state = state * torch.exp(a[:, -1])[:, :, None, None] \
            + torch.einsum("bkn,bkhp->bhnp", bq,
                           xq * decay_out[..., None])
        ys.append(y_off + y_diag)
    y = torch.stack(ys, 1).reshape(Bsz, nc * Q, H, P)[:, :S]
    return y, state
