"""Mixture-of-Experts layer — the port of ``repro.models.moe``: router,
capacity dispatch and combine, the single-shard paths over dense banks and
the pooled store, and ``moe_ep``, the expert-parallel path across logical
devices.

Capacity convention (GShard): every expert gets ``C = ceil(T * top_k / E *
capacity_factor)`` slots; slots come from a cumulative count over the
flattened (token, k) order and overflow entries are dropped.  At decode
with 8 sequences, top-8 of 128 experts and factor 1.25, C is one token.

Where the reference's JAX idioms do not carry over:

* ``jax.lax.top_k`` breaks ties toward the lower index; ``torch.topk``
  promises no order on CUDA, so ``route`` takes a stable descending sort;
* the reference's combine ``y.at[token_idx].add(...)`` sums the k
  contributions of a token in order, in the working dtype; ``index_add_``
  on CUDA uses atomics (order varies run to run), so the combine gathers
  ``[T, k, D]`` and adds over k in order instead;
* dropped writes (``mode="drop"``) go to an extra overflow slot that is
  sliced off, and dropped reads (``mode="fill"``) read a zero slot;
* the reference's ``moe_local`` / ``moe_local_pooled`` also return the
  load-balance aux loss, a training term that serving discards; here they
  return the output only and append the loss to a list ``aux`` when the
  caller (the training forward) gives one, so the serving steps and
  their CUDA graphs compute none of it;
* ``routing_counts`` adds ones into a zeroed [E] tensor where the
  reference's ``.at[].add`` does: ``torch.bincount`` would read the
  largest index back to the host to size its output, which a CUDA graph
  capture cannot hold.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import local_view, tp_broadcast
from repro_torch.kernels import ops
from repro_torch.models.layers import dot, mlp_apply, mlp_apply_tp


def router_init(gen, d_model, num_experts, device, lead=()):
    # router math is always f32 for stability
    return {"w": torch.randn(*lead, d_model, num_experts, generator=gen,
                             device=device, dtype=torch.float32)
            .mul_(1.0 / math.sqrt(d_model))}


def _topk(p, x, top_k: int):
    """x [T, D] -> (probs [T,E], topk_idx [T,k] int64, topk_w [T,k] f32)."""
    logits = torch.matmul(x.float(), p["w"].float())
    probs = torch.softmax(logits, dim=-1)
    topk_w, topk_idx = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    topk_w, topk_idx = topk_w[:, :top_k], topk_idx[:, :top_k]
    return probs, topk_idx, topk_w / topk_w.sum(-1, keepdim=True)


def _aux_loss(probs, topk_idx):
    """The GShard/Switch load-balance auxiliary loss of one MoE layer: E
    times the sum over experts of the mean router probability and the
    share of tokens whose first choice it is (f32 scalar; no gradient
    reaches it through the choices)."""
    E = probs.shape[-1]
    me = probs.mean(0)
    ce = F.one_hot(topk_idx[:, 0], E).float().mean(0)
    return E * torch.sum(me * ce)


def route(p, x, top_k: int):
    """x [T, D] -> (topk_idx [T,k] int32, topk_w [T,k] f32, aux_loss)."""
    probs, topk_idx, topk_w = _topk(p, x, top_k)
    return topk_idx.to(torch.int32), topk_w, _aux_loss(probs, topk_idx)


def _dispatch_indices(topk_idx, num_experts: int, capacity: int):
    """Flattened (token, k) entries -> (expert_flat [T*k], slot [T*k],
    keep [T*k] bool); dropped entries get ``slot == capacity``."""
    expert_flat = topk_idx.reshape(-1).long()
    onehot = F.one_hot(expert_flat, num_experts)
    pos = torch.cumsum(onehot, dim=0) - 1                   # [Tk, E]
    slot = (pos * onehot).sum(-1)                            # [Tk]
    keep = slot < capacity
    slot = torch.where(keep, slot, torch.full_like(slot, capacity))
    return expert_flat, slot, keep


def capacity_for(tokens: int, cfg) -> int:
    return max(1, int(math.ceil(tokens * cfg.top_k / cfg.num_experts
                                * cfg.capacity_factor)))


def routing_counts(topk_idx, num_experts: int):
    """topk_idx [T, k] -> per-expert routed-token counts [E] int32 (router
    demand; capacity dropping ignored), with no read back to the host."""
    idx = topk_idx.reshape(-1).long()
    return torch.zeros(num_experts, dtype=torch.int32,
                       device=idx.device).index_add_(
        0, idx, torch.ones_like(idx, dtype=torch.int32))


def _expert_ffn(xg, wi, wg, wo):
    """Dense banks: xg [E, C, D]; wi/wg [E, D, F]; wo [E, F, D].  Three
    batched products, each accumulated in f32 and rounded once to xg's
    dtype (``dot``), with ``silu`` in f32 of the rounded gate: the
    rounding points of the pooled path's ``paged_expert_ffn``.  The
    reference's dense einsum keeps the gate product in f32 until after
    ``silu``; in f32 the two are the same function, in bf16 they differ by
    one rounding of the gate.  Casting the banks to f32 instead would copy
    every expert's weights (2.4 GB a layer at full size) on every step."""
    h = dot(xg, wi)
    g = dot(xg, wg)
    h = h * F.silu(g.float()).to(h.dtype)
    return dot(h, wo)


def _scatter(x, k: int, lead, where, C: int):
    """Dispatch buffer ``lead + [C, D]`` holding each kept (token, k) entry
    at ``where`` (index tensors over ``lead``, then the slot); dropped
    entries (slot ``C``) land in an overflow slot that is cut off."""
    T, D = x.shape
    token_idx = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = torch.zeros((*lead, C + 1, D), dtype=x.dtype, device=x.device)
    buf[where] = x[token_idx]
    return buf[..., :C, :]


def _combine(yg, where, topk_w, keep):
    """Each token's k expert outputs from ``yg`` (``lead + [C, D]``, read
    at ``where``; dropped entries read a zero slot), weighted and summed
    over k in order in the working dtype -> [T, D]."""
    T, k = topk_w.shape
    D = yg.shape[-1]
    yg = torch.cat([yg, yg.new_zeros((*yg.shape[:-2], 1, D))], dim=-2)
    w_flat = topk_w.reshape(T * k).to(yg.dtype)
    contrib = (yg[where] * (w_flat * keep)[:, None]).reshape(T, k, D)
    y = contrib[:, 0]
    for j in range(1, k):                          # in order, working dtype
        y = y + contrib[:, j]
    return y


def _moe_local_body(cfg, p, x, capacity, expert_ffn, return_counts=False,
                    aux=None):
    """Single-shard dispatch / combine shared by the dense banks and the
    pooled store; ``expert_ffn(xg [E, C, D]) -> [E, C, D]`` is the only
    difference between them.  The router's aux loss is appended to the
    list ``aux`` where one is given (training); serving gives none and
    computes none.  ``return_counts``: also the router's per-expert token
    counts [E] (routing telemetry)."""
    T, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    C = capacity or capacity_for(T, cfg)
    probs, topk_idx, topk_w = _topk(p["router"], x, k)
    if aux is not None:
        aux.append(_aux_loss(probs, topk_idx))
    expert_flat, slot, keep = _dispatch_indices(topk_idx, E, C)
    where = (expert_flat, slot)
    yg = expert_ffn(_scatter(x, k, (E,), where, C).contiguous())
    y = _combine(yg, where, topk_w, keep)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x)
    if return_counts:
        return y, routing_counts(topk_idx, E)
    return y


def moe_local(cfg, p, x, capacity=None, return_counts=False, aux=None):
    """x [T, D] -> [T, D] over dense banks {wi, wg, wo} [E, D, F|D] (and
    the routing counts [E] with ``return_counts``); the aux loss goes to
    the list ``aux`` where one is given."""
    return _moe_local_body(
        cfg, p, x, capacity,
        lambda xg: _expert_ffn(xg, p["wi"], p["wg"], p["wo"]),
        return_counts, aux)


def moe_local_pooled(cfg, p, pool, x, capacity=None, return_counts=False):
    """Single-shard MoE over the pooled weight store: ``p["gtable"]`` [E]
    is each expert's global pool row and ``pool`` holds the banks
    ``{wi, wg, wo}`` as ``[pages, D, F]`` / ``[pages, F, D]``; the expert
    FFN reads pages through the table (``ops.paged_expert_ffn``: three
    paged-GMM launches on the card).  An int8 store also holds the
    per-page f32 scale banks ``{wi,wg,wo}_scale`` [pages], read through the
    same table (``ops.quant_paged_expert_ffn``).  x [T, D] -> [T, D] (and
    the routing counts [E] with ``return_counts``)."""
    return _moe_local_body(cfg, p, x, capacity,
                           _paged_ffn(p["gtable"], pool), return_counts)


def _paged_ffn(table, pool):
    """The expert FFN over ``pool``'s pages ``table`` [E]: xg [E, C, D] ->
    [E, C, D]; int8 pages with their scale banks if the pool has them."""
    if "wi_scale" in pool:
        return lambda xg: ops.quant_paged_expert_ffn(
            table, table, table, pool["wi"], pool["wg"], pool["wo"],
            pool["wi_scale"], pool["wg_scale"], pool["wo_scale"], xg)
    return lambda xg: ops.paged_expert_ffn(table, table, table, pool["wi"],
                                           pool["wg"], pool["wo"], xg)


def _packed_ffn(xg, eid, wi, wg, wo):
    """The packed body's expert FFN: xg [S, D] through every local expert
    of the banks (wi/wg [E_local, D, F], wo [E_local, F, D]; ``_expert_ffn``'s
    products and rounding points), then each row's own expert ``eid`` [S]
    selected; ``eid == E_local`` (an empty slot) selects a zero row."""
    y_all = _expert_ffn(xg.expand(wi.shape[0], *xg.shape), wi, wg, wo)
    y_all = torch.cat([y_all, y_all.new_zeros((1, *xg.shape))])
    return y_all[eid, torch.arange(xg.shape[0], device=xg.device)]


# ---------------------------------------------------------------- EP path

def _rows_to_shards(xs, n: int, devices):
    """Rows of the groups ``xs`` (in order, one global token list) padded
    with zero rows to ``n`` a device and split into one [n, D] shard per
    device in ``devices``, each built on its device.  A shard that is one
    group's rows on that device already is that group's view."""
    out, groups, base = [], [], 0
    for x in xs:
        groups.append((base, x))
        base += x.shape[0]
    for i, dev in enumerate(devices):
        lo, hi = i * n, (i + 1) * n
        pieces = [x[max(lo, a) - a:min(hi, a + x.shape[0]) - a]
                  for a, x in groups if a < hi and a + x.shape[0] > lo]
        if len(pieces) == 1 and pieces[0].shape[0] == n \
                and pieces[0].device == dev:
            out.append(pieces[0])
            continue
        pieces = [t.to(dev) for t in pieces]
        got = sum(t.shape[0] for t in pieces)
        if got < n:
            pieces.append(xs[0].new_zeros((n - got, xs[0].shape[1]),
                                          device=dev))
        out.append(torch.cat(pieces))
    return out


def _shards_to_rows(ys, n: int, xs):
    """The inverse of ``_rows_to_shards``: each group's rows back on its
    own device."""
    out, base = [], 0
    for x in xs:
        a, b = base, base + x.shape[0]
        base = b
        pieces = [y[max(a, i * n) - i * n:min(b, (i + 1) * n) - i * n]
                  for i, y in enumerate(ys)
                  if i * n < b and (i + 1) * n > a]
        if len(pieces) == 1 and pieces[0].device == x.device:
            out.append(pieces[0])
        else:
            out.append(torch.cat([t.to(x.device) for t in pieces]))
    return out


def moe_ep(cfg, p, x, parallel, capacity=None, pool=None, owners=None,
           return_counts=False):
    """Expert-parallel MoE across ``parallel``'s logical devices
    (``distributed.sharding.ParallelCtx``), EP = DP x TP in slot order.

    ``x`` is [B, S, D], or a list of such row groups that together make the
    global batch in order (one group per DP replica at decode, each on its
    replica's device); the result has the same form.  At tp > 1 a group is
    the list of its replica's TP ranks' copies of the same rows, rank 0
    first: the rows are routed once, from rank 0's copy, and the group's
    result is one copy per rank (``tp_broadcast``), each with the shared
    expert's output split over the ranks and summed (``mlp_apply_tp``).
    ``p`` is one layer's
    sharded MoE parameters: the router, replicated; and either dense banks
    ``{wi, wg, wo}`` [E, D, F|D] split over the E axis, or, with ``pool``
    (the sharded page pools ``[ndev * pages, D, F|D]``, and their per-page
    scale banks for int8), the page-table index arrays ``tables`` [ndev,
    Elm] (one row per device) and ``edest`` / ``eslot`` [E].  ``owners``
    names each group's logical device (default: the first whose
    ``torch.device`` holds it), or for a group of rank copies its ranks'
    logical devices; shared experts run there on its shards.

    As the reference's shard_map body: the T rows are padded to a multiple
    of n_ep with zero rows (which are routed too — every expert ties, the
    first k win — and take capacity) and split into n_ep even shards; each
    device routes its shard with capacity ``capacity_for(T_pad / n_ep)``
    and fills a send buffer [n_ep, Elm, C, D]; the all-to-all is an
    explicit copy of each buffer's block j onto device j; device j runs
    its experts on [Elm, n_ep * C, D] (``ops.paged_expert_ffn`` over its
    pool slice and table row, or the dense banks); the outputs go back the
    same way and each device combines its own rows.

    With ``parallel.moe_dispatch == "packed"`` and dense banks (pooled
    pages keep the expert-slot body, as in the reference) the body is the
    reference's ``_moe_ep_shard_packed``: each device packs its entries
    per destination device into [n_ep, C2, D], C2 = ceil(t_local * k /
    n_ep * capacity_factor), an entry's slot its rank among the earlier
    entries for that destination (kept where slot < C2), beside a [n_ep,
    C2] local expert id (``elm`` marks an empty slot); device j computes
    every local expert's FFN on every received row and selects the row's
    own expert (``_packed_ffn``); the combine weighs by ``topk_w * keep``.

    ``return_counts``: also the router's per-expert token counts [E] int32
    over the T rows (the zero pad rows left out), on the first device —
    the reference replays its router on those rows; here each device
    counts the rows of its shard that are not padding.  Returns (the
    result, counts)."""
    single = torch.is_tensor(x)
    groups = [x] if single else list(x)
    ranked = [g if isinstance(g, (list, tuple)) else None for g in groups]
    xs = [g[0] if r is not None else g for g, r in zip(groups, ranked)]
    D = xs[0].shape[-1]
    flat = [t.reshape(-1, D) for t in xs]
    devs = [parallel.torch_device(d) for d in parallel.devices]
    n_ep = len(devs)
    T = sum(t.shape[0] for t in flat)
    T_pad = -(-T // n_ep) * n_ep
    t_local = max(1, T_pad // n_ep)
    E, k = cfg.num_experts, cfg.top_k
    pooled = pool is not None and "tables" in p
    packed = parallel.moe_dispatch == "packed" and not pooled
    if packed:
        C = capacity or max(1, math.ceil(t_local * k / n_ep
                                         * cfg.capacity_factor))
    else:
        C = capacity or capacity_for(t_local, cfg)
    if pooled:
        elm = p["tables"].shape[-1]
    else:
        if not p["wi"].sharding.axes(0):
            raise ValueError(f"dense banks of {E} experts are not split "
                             f"over {n_ep} devices (E % n_ep != 0)")
        elm = E // n_ep

    shards = _rows_to_shards(flat, t_local, devs)
    sends, wheres, gates, eids = [], [], [], []
    counts = None
    for i, (dev, xi) in enumerate(zip(parallel.devices, shards)):
        _, topk_idx, topk_w = _topk({"w": p["router"]["w"].shard(dev)}, xi,
                                    k)
        valid = min(t_local, T - i * t_local)
        if return_counts and valid > 0:
            c = routing_counts(topk_idx[:valid], E).to(devs[0])
            counts = c if counts is None else counts + c
        if packed:
            expert_flat = topk_idx.reshape(-1).long()
            dest, slot, keep = _dispatch_indices(expert_flat // elm, n_ep, C)
            where, lead = (dest, slot), (n_ep,)
            eid = torch.full((n_ep, C + 1), elm, dtype=torch.long,
                             device=xi.device)
            eid[where] = expert_flat % elm
            eids.append(eid[:, :C])
        else:
            expert_flat, slot, keep = _dispatch_indices(topk_idx, E, C)
            if pooled:
                dest = p["edest"].shard(dev).long()[expert_flat]
                e_loc = p["eslot"].shard(dev).long()[expert_flat]
            else:
                dest, e_loc = expert_flat // elm, expert_flat % elm
            where, lead = (dest, e_loc, slot), (n_ep, elm)
        sends.append(_scatter(xi, k, lead, where, C))
        wheres.append(where)
        gates.append((topk_w, keep))

    backs = []
    for j, (dev, tdev) in enumerate(zip(parallel.devices, devs)):
        recv = torch.stack([s[j].to(tdev) for s in sends])   # all-to-all
        if packed:
            eid = torch.stack([e[j].to(tdev) for e in eids])
            backs.append(_packed_ffn(
                recv.reshape(n_ep * C, D), eid.reshape(n_ep * C),
                p["wi"].shard(dev), p["wg"].shard(dev),
                p["wo"].shard(dev)).reshape(n_ep, C, D))
            continue
        xg = recv.transpose(0, 1).reshape(elm, n_ep * C, D).contiguous()
        if pooled:
            yg = _paged_ffn(p["tables"].shard(dev)[0],
                            local_view(pool, dev))(xg)
        else:
            yg = _expert_ffn(xg, p["wi"].shard(dev), p["wg"].shard(dev),
                             p["wo"].shard(dev))
        backs.append(yg.reshape(elm, n_ep, C, D).transpose(0, 1))

    ys = []
    for i, tdev in enumerate(devs):
        ret = torch.stack([b[i].to(tdev) for b in backs])   # all-to-all
        topk_w, keep = gates[i]
        ys.append(_combine(ret, wheres[i], topk_w, keep))

    out = _shards_to_rows(ys, t_local, flat)
    out = [y.reshape(t.shape) for y, t in zip(out, xs)]
    if owners is None:
        owners = [next(d for d in parallel.devices
                       if parallel.torch_device(d) == t.device)
                  for t in xs]
    for g, (t, dev) in enumerate(zip(xs, owners)):
        if ranked[g] is None:
            if "shared" in p:
                out[g] = out[g] + mlp_apply(local_view(p["shared"], dev), t)
            continue
        tdevs = [parallel.torch_device(d) for d in dev]
        out[g] = tp_broadcast(out[g], tdevs)
        if "shared" in p:
            sh = mlp_apply_tp([local_view(p["shared"], d) for d in dev],
                              ranked[g], tdevs,
                              cfg.moe_d_ff * cfg.num_shared_experts)
            out[g] = [y + s for y, s in zip(out[g], sh)]
    out = out[0] if single else out
    return (out, counts) if return_counts else out
