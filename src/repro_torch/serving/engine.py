"""Inference engine on one device: continuous batching over the
slot-contiguous KV cache or the paged KV pool, with monolithic or chunked
prefill — the port of the one-device serving half of
``repro.serving.engine``.

Dense KV (``kv=None`` at ``bind``, the reference's default) keeps one
cache row ``[L, B, ...]`` per slot (K/V or MLA latent rows of max_len
positions; a Mamba2 model's conv tail and SSD state); each admitted
request is prefilled at admission, padded to a bucket, and its cache
overwrites the slot row.  Paged KV keeps a block *pool* ``[L, NB, bs, ...]`` and each slot a
block table (``serving/kv_blocks.py``): admission is gated by free blocks,
shared prompt prefixes are copy-on-write, and when the pool runs dry the
lowest-priority sequence is preempted (freed + re-queued; recomputed on
resume).  With ``prefill_chunk > 0`` each tick runs at most
``prefill_budget`` prompt tokens as ``prefill_chunk``-token chunks
(``serving/scheduler.py``), into the pool's blocks or the slot's row;
with ``prefill_chunk == 0`` the whole prompt is prefilled at admission.
Every tick ends with one decode step for every runnable slot.

The step functions are plain callables keyed like the reference's compiled
executables (``decode``, ``prefill_{S_pad}``, ``chunk_prefill_{C}``, and
with routing telemetry ``decode_routed``: every ``routing_sample_every``-th
tick runs it, and its routing counts, behind the tokens in the one tensor
the tick reads back, go into ``routing_stats``).  On
the card the IMM captures these steps as CUDA graphs (``core/graphs.py``:
the decode steps, the chunk step, and without chunking one prefill graph
per given bucket and replica) and ``bind`` hands them over: the engine then
fills their static inputs and replays them in place of the eager calls,
and reads each prefill's or chunk's token once, right after it.  A paged
bucket built lazily (``_prefill``) runs eagerly.  The steps update the
cache in place: the reference donates it to its jitted steps, here the
rows are written directly.

On several logical devices (``parallel``, from ``engine_parallel_ctx``) the
cache is sharded per DP replica and each replica's steps address its own
slice: the engine keeps global block ids (the block manager's) and hands
each replica its tables and ids local to its pool slice, with that slice's
size as the ``NB`` sentinel; a dense-KV prefill writes the slot's row in
its replica's slice. At tp > 1 each TP rank of a replica holds a copy of
its slice, and every write (a prefill's row, a step's KV, a copy-on-write
block) goes into every copy. A rebind (``bind`` after a scale event) keeps
the surviving slots, their lengths, tokens and block tables.

A scale-down first empties the doomed slots (``admit_limit`` and above):
they drain, or their sequences migrate (``plan_migration`` reserves a
sharing component's blocks on a survivor partition and pauses its
sequences; ``copy_block`` copies each block pair on a ``TransferEngine``
worker; ``finish_migration`` re-homes the slots).  No step replaces a leaf
of ``engine.cache``: every step, prefill and copy writes rows in place, so
a copy on a worker thread and a step on the serving thread touch disjoint
rows of the same tensors and need no lock (the reference's jitted steps
donate the cache and replace its handle, hence its ``_cache_lock``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.transfer import ready_events
from repro_torch.distributed.sharding import ParallelCtx, ShardedTensor
from repro_torch.models import model as M
from repro_torch.serving.kv_blocks import KVBlockManager, MigrationTicket
from repro_torch.serving.scheduler import (PrefillJob, TokenBudgetScheduler,
                                           prefix_skip)


def engine_parallel_ctx(mesh) -> ParallelCtx:
    """The engine's context on a mesh: EP over every device, the expert
    FFN unsplit."""
    return ParallelCtx(devices=mesh.devices, dp=mesh.dp, tp=mesh.tp,
                       all_devices=mesh.all_devices)


def _local_rows(leaf) -> int:
    """Rows of the batch / block axis one replica holds."""
    if isinstance(leaf, ShardedTensor):
        return next(iter(leaf.shards.values())).shape[1]
    return leaf.shape[1]


def _next_tokens(res, tokens, active):
    """A decode step's greedy tokens (inactive slots keep theirs) and,
    after a routed step, its routing counts flattened behind them: one
    int32 tensor [B (+ L_moe * E)], which the engine reads back to the
    host in one copy."""
    logits, cache, *counts = res
    nxt = torch.where(active, torch.argmax(logits, dim=-1).to(torch.int32),
                      tokens)
    if counts:
        nxt = torch.cat([nxt, counts[0].reshape(-1).to(nxt.device)])
    return nxt, cache


def _decode_fn(mcfg, params, cache, tokens, lengths, active, *,
               parallel=None, collect_routing=False):
    """Greedy decode over the slot-contiguous cache; inactive slots keep
    their token (their rows are rewritten by the next prefill).  With
    ``collect_routing`` (the ``decode_routed`` twin) the routing counts
    follow the tokens (``_next_tokens``)."""
    return _next_tokens(
        M.decode_step(mcfg, params, tokens[:, None], cache, lengths,
                      parallel=parallel, collect_routing=collect_routing),
        tokens, active)


def _paged_decode_fn(mcfg, params, cache, tokens, lengths, active,
                     block_tables, *, parallel=None, collect_routing=False):
    """Greedy paged decode: the write block comes from each sequence's
    length; inactive slots write to the ``NB`` sentinel row (dropped) and
    keep their token.  ``block_tables`` and ``NB`` are each replica's
    local ones.  ``collect_routing``: as ``_decode_fn``."""
    NB, bs = _local_rows(cache["k"]), cache["k"].shape[2]
    col = (lengths.long() // bs).clamp(max=block_tables.shape[1] - 1)
    wb = block_tables.gather(1, col[:, None])[:, 0]
    wb = torch.where(active, wb, torch.full_like(wb, NB))
    return _next_tokens(
        M.paged_decode_step(mcfg, params, tokens[:, None], cache, lengths,
                            block_tables, wb, parallel=parallel,
                            collect_routing=collect_routing),
        tokens, active)


def _greedy(logits) -> torch.Tensor:
    """The argmax token of a one-sequence step as a [1] int32 tensor: the
    caller reads it, outside a captured graph."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _prefill_fn(mcfg, max_len, params, cache, tokens, length, row, *,
                parallel=None, replica: int = 0):
    """Prefill one request (padded to a bucket) into cache row ``row``
    ([1] int32 device tensor; a Python int is filled into one): the whole
    row is overwritten, zeros past the bucket, as the reference's update of
    its ``max_len``-padded cache does, by one indexed copy a leaf.
    ``length`` [1] int32.  Returns (the argmax token at position ``length -
    1`` as a [1] int32 tensor, cache).  With ``parallel`` replica
    ``replica`` runs it, ``row`` is local to its slice, and every copy its
    TP ranks hold takes the row."""
    copies = [cache]
    if parallel is not None:
        copies = [{n: v.shard(d) for n, v in cache.items()}
                  for d in parallel.replica_devices(replica)]
    if not torch.is_tensor(row):
        row = torch.full((1,), int(row), dtype=torch.int32,
                         device=tokens.device)
    logits, small = M.prefill(mcfg, params,
                              {"tokens": tokens,
                               "lengths": length.reshape(1)},
                              max_len=max_len, parallel=parallel,
                              replica=replica)
    for rows in copies:
        for name, leaf in rows.items():
            leaf.index_copy_(1, row.to(leaf.device).long().reshape(1),
                             small[name].to(leaf.device, leaf.dtype))
    return _greedy(logits), cache


def _paged_prefill_fn(mcfg, params, cache, tokens, length, block_ids, *,
                      parallel=None, replica: int = 0):
    """Prefill one request and scatter its KV into pool blocks
    ``block_ids`` [S_pad/bs] (``NB`` marks padding and CoW-shared prefix
    blocks, which already hold the same tokens — or a co-owner's tokens
    beyond this prompt — and are not rewritten); with ``parallel``, on
    replica ``replica``, ids local to its slice.  ``length`` [1] int32.
    Returns (the argmax token as a [1] int32 tensor, cache)."""
    S_pad = tokens.shape[1]
    logits, small = M.prefill(mcfg, params,
                              {"tokens": tokens,
                               "lengths": length.reshape(1)},
                              max_len=S_pad, parallel=parallel,
                              replica=replica)
    cache = M.write_prefill_to_blocks(cache, small, block_ids,
                                      parallel=parallel, replica=replica)
    return _greedy(logits), cache


def _chunk_prefill_fn(mcfg, params, cache, tokens, start, length, row, *,
                      parallel=None, replica: int = 0):
    """One dense-KV prefill chunk: tokens [1, C] are prompt positions
    [start, start+C) of cache row ``row`` (with ``parallel``: local to
    replica ``replica``'s slice); ``length`` = prompt tokens covered after
    this chunk; ``start``, ``length`` and ``row`` are [1] int32 tensors.
    Returns (the argmax token at the last valid position as a [1] int32
    tensor, cache)."""
    logits, cache = M.chunk_prefill_step(mcfg, params, tokens, cache, start,
                                         length, row, parallel=parallel,
                                         replica=replica)
    return _greedy(logits), cache


def _paged_chunk_prefill_fn(mcfg, params, cache, tokens, start, length,
                            block_tables, chunk_ids, *, parallel=None,
                            replica: int = 0):
    """One paged prefill chunk: the chunk's KV lands in pool rows
    ``chunk_ids`` (``NB`` = padding or CoW-shared block; dropped) and
    attention reads the whole context through ``block_tables`` [1, MB]
    (with ``parallel``: on replica ``replica``, local to its slice);
    ``start`` and ``length`` are [1] int32 tensors.  Returns (the argmax
    token at the last valid position as a [1] int32 tensor, cache): the
    caller reads it, outside a captured graph."""
    logits, cache = M.paged_chunk_prefill_step(mcfg, params, tokens, cache,
                                               start, length, block_tables,
                                               chunk_ids, parallel=parallel,
                                               replica=replica)
    return _greedy(logits), cache


def compile_step_functions(mcfg, *, max_len: int, prefill_buckets=(64,),
                           kv_mode: str = "dense", prefill_chunk: int = 0,
                           parallel: Optional[ParallelCtx] = None,
                           collect_routing: bool = False
                           ) -> Tuple[Dict[str, Callable], float]:
    """The step callables of an instance, keyed like the reference's
    executables: ``decode``, ``prefill_{S_pad}`` for each bucket, with
    ``prefill_chunk`` ``chunk_prefill_{C}``, and with ``collect_routing``
    ``decode_routed`` (the decode step that also gives the routing
    counts); ``parallel`` for an instance on several logical devices.
    Eager PyTorch needs no compilation; returns (callables, seconds) as
    the reference does."""
    t0 = time.perf_counter()
    paged = kv_mode == "paged"
    dec = _paged_decode_fn if paged else _decode_fn
    out = {"decode": partial(dec, mcfg, parallel=parallel)}
    if collect_routing:
        if not M.routing_stats_supported(mcfg):
            raise ValueError(f"{mcfg.name}: routing telemetry unsupported")
        out["decode_routed"] = partial(dec, mcfg, parallel=parallel,
                                       collect_routing=True)
    if paged:
        prefill = partial(_paged_prefill_fn, mcfg, parallel=parallel)
    else:
        prefill = partial(_prefill_fn, mcfg, max_len, parallel=parallel)
    for S_pad in prefill_buckets:
        out[f"prefill_{S_pad}"] = prefill
    if prefill_chunk:
        if not M.chunk_prefill_supported(mcfg):
            raise ValueError(f"{mcfg.name}: chunked prefill unsupported")
        out[f"chunk_prefill_{prefill_chunk}"] = partial(
            _paged_chunk_prefill_fn if paged else _chunk_prefill_fn, mcfg,
            parallel=parallel)
    return out, time.perf_counter() - t0


@dataclasses.dataclass
class SlotState:
    rid: int = -1
    remaining: int = 0
    active: bool = False
    priority: int = 0
    # live KV migration (scale-down): a migrating slot's sequence is paused
    # (its blocks are frozen while the copies are in flight); a reserved
    # slot is the migration's destination and admits nothing else
    migrating: bool = False
    reserved: bool = False
    # chunked prefill: admitted but not fully prefilled — occupies the slot
    # (and its KV blocks) but is excluded from decode until the final chunk
    prefilling: bool = False


@dataclasses.dataclass
class MigrationJob:
    """One in-flight slot migration: a sharing component of doomed slots
    moving to reserved survivor slots.  ``ticket.pairs`` is the copy list;
    ``moves`` maps each sequence to its (src_slot, dst_slot); ``ready``
    maps each CUDA device the copies run on to an event recorded on its
    default stream at planning, after the last step that wrote the source
    rows (the copies' side streams wait on it; empty on the CPU)."""
    ticket: MigrationTicket
    moves: List[Tuple[int, int, int]]      # (rid, src_slot, dst_slot)
    ready: Dict = dataclasses.field(default_factory=dict)


class InferenceEngine:
    """Continuous-batching engine bound to one device's parameters, cache
    and step functions."""

    #: most prefill buckets built lazily (paged mode) and kept, least
    #: recently used first out; buckets given at bind are never evicted
    MAX_LAZY_PREFILL = 8

    def __init__(self, mcfg, *, batch_per_replica: int, max_len: int,
                 prefill_bucket: int = 64, prefill_chunk: int = 0,
                 prefill_budget: Optional[int] = None,
                 routing_sample_every: int = 0, device="cuda"):
        self.mcfg = mcfg
        # routing telemetry: every Nth decode tick runs the decode_routed
        # twin and adds its counts to the histogram (0: never)
        self.routing_sample_every = routing_sample_every
        self._routing_counts: Optional[np.ndarray] = None
        self._routing_samples = 0
        self.batch_per_replica = batch_per_replica
        self.max_len = max_len
        self.prefill_bucket = prefill_bucket
        # > 0: prefill in fixed chunks under a per-tick token budget
        # (serving/scheduler.py); 0: the whole prompt at admission
        self.prefill_chunk = prefill_chunk
        self.device = torch.device(device)
        self.scheduler = (TokenBudgetScheduler(prefill_chunk, prefill_budget)
                          if prefill_chunk > 0 else None)
        self._prefilling: List[PrefillJob] = []       # FIFO, admission order
        # slot -> (full prompt, resumed): host-side context for chunk jobs
        self._chunk_ctx: Dict[int, Tuple[np.ndarray, bool]] = {}
        self._lazy_prefill: "OrderedDict[str, None]" = OrderedDict()
        self.cfg = None
        self.params = None
        self.cache = None
        self.compiled: Dict[str, Callable] = {}
        # the configuration's CUDA graphs (``core/graphs.StepGraphs``), or
        # None: the eager steps
        self.graphs = None
        self.slots: List[SlotState] = []
        self.lengths: Optional[np.ndarray] = None
        self.tokens: Optional[np.ndarray] = None
        self.generated: Dict[int, List[int]] = {}
        self.kv: Optional[KVBlockManager] = None
        self.parallel: Optional[ParallelCtx] = None
        self.block_tables: Optional[np.ndarray] = None
        self._preempted_pending: List[int] = []   # rids awaiting re-queue
        self._resume_rids: set = set()            # preempted at least once
        self._finished_at_admission: List[int] = []
        self.preemptions = 0
        self._step_count = 0
        self.admit_limit: Optional[int] = None  # scale-down barrier

    # ------------------------------------------------------------- binding
    @property
    def num_slots(self) -> int:
        return 0 if self.cfg is None else self.cfg.dp * self.batch_per_replica

    @property
    def paged(self) -> bool:
        return self.kv is not None

    def bind(self, cfg, params, cache, compiled,
             kv: Optional[KVBlockManager] = None,
             parallel: Optional[ParallelCtx] = None, graphs=None):
        """Attach the instance's parameters, cache and step functions;
        ``kv`` is the block manager of a paged pool (None: dense KV),
        ``parallel`` the context of an instance on several logical
        devices, ``graphs`` its steps captured over these very tensors
        (None: the eager steps).  A rebind keeps the
        surviving slots' requests, lengths, tokens and block tables (their
        KV stays where it is)."""
        old_slots, old_lengths = self.slots, self.lengths
        old_tokens, old_tables = self.tokens, self.block_tables
        self.cfg = cfg
        self.params, self.cache = params, cache
        self.compiled = compiled
        self.graphs = graphs
        self.kv = kv
        self.parallel = parallel
        n = self.num_slots
        self.slots = [SlotState() for _ in range(n)]
        self.lengths = np.zeros((n,), np.int32)
        self.tokens = np.zeros((n,), np.int32)
        if self.prefill_chunk:
            if not M.chunk_prefill_supported(self.mcfg):
                raise ValueError("chunked prefill unsupported for this "
                                 "model")
        if self.paged:
            bs = kv.block_size
            if self.max_len % bs or self.prefill_bucket % bs \
                    or self.prefill_chunk % bs:
                raise ValueError("max_len, prefill buckets and "
                                 "prefill_chunk must be block-size "
                                 "multiples")
            # padding rows hold the NB sentinel (never block id 0, a valid
            # row); NB tracks the current pool, so a rebind rebuilds the
            # tables from the block manager
            self.block_tables = np.full((n, self.max_len // bs),
                                        kv.num_blocks, np.int32)
        for i in range(min(len(old_slots), n)):
            self.slots[i] = old_slots[i]
            self.lengths[i] = old_lengths[i]
            self.tokens[i] = old_tokens[i]
            if self.paged and old_tables is not None \
                    and self.slots[i].active:
                tbl = self.kv.block_table(self.slots[i].rid)
                self.block_tables[i, :len(tbl)] = tbl
        # chunk jobs survive a rebind slot for slot
        self._prefilling = [j for j in self._prefilling if j.slot < n]
        self._chunk_ctx = {s: c for s, c in self._chunk_ctx.items() if s < n}
        self._lazy_prefill = OrderedDict(
            (k, None) for k in self._lazy_prefill if k in compiled)

    def unbind(self) -> None:
        """Drop every device reference the engine holds (a park): the
        parameters, the cache, the step functions and their graphs, the
        block manager and tables, the slots and the chunk jobs.  The HMM
        has the weights in its host snapshot; a handle kept here would
        keep the device memory alive.  Refuses while a sequence is live,
        so a park never drops a request."""
        if self.active_count():
            raise RuntimeError("unbind with live sequences")
        self.cfg = None
        self.params = self.cache = None
        self.compiled = {}
        self.graphs = None
        self.kv = None
        self.parallel = None
        self.block_tables = None
        self.slots = []
        self.lengths = self.tokens = None
        self._prefilling = []
        self._chunk_ctx = {}
        self._lazy_prefill = OrderedDict()

    def free_slots(self) -> List[int]:
        """Slots that may admit: inactive, not reserved for a migration,
        and below ``admit_limit`` during a scale-down."""
        lim = (self.admit_limit if self.admit_limit is not None
               else len(self.slots))
        return [i for i, s in enumerate(self.slots)
                if not s.active and not s.reserved and i < lim]

    def drained(self, keep: int) -> bool:
        """True when every slot from ``keep`` on is inactive (a scale-down
        may commit)."""
        return all(not s.active for s in self.slots[keep:])

    def active_count(self) -> int:
        return sum(1 for s in self.slots if s.active)

    def utilization(self) -> float:
        """Occupied share of the admissible serving capacity (drives load
        estimation): block-pool occupancy paged, slot occupancy dense;
        during a scale-down the capacity is what survives it."""
        if self.paged:
            cap = self.kv.num_blocks
            if self.admit_limit is not None:
                parts = max(1, self.admit_limit // self.batch_per_replica)
                cap = min(cap, parts * self.kv.blocks_per_partition)
            return self.kv.used_blocks() / max(cap, 1)
        lim = (len(self.slots) if self.admit_limit is None
               else max(1, min(self.admit_limit, len(self.slots))))
        return self.active_count() / max(lim, 1)

    def block_nbytes(self) -> int:
        """Device bytes of ONE pool block across all layers/tensors."""
        return sum(leaf.nbytes // leaf.shape[1]
                   for leaf in self.cache.values())

    def kv_stats(self) -> Optional[Dict[str, float]]:
        """Block-pool stats (None for the dense layout)."""
        if not self.paged:
            return None
        st = self.kv.stats()
        st["preemptions"] = self.preemptions
        st["block_bytes"] = self.block_nbytes()
        st["migration_bytes"] = self.kv.migrated_blocks * self.block_nbytes()
        return st

    # ------------------------------------------------------------- serving
    def _partition(self, slot: int) -> int:
        return slot // self.batch_per_replica

    def _local_ids(self, ids: np.ndarray, replicas) -> np.ndarray:
        """Global block ids (rows of ``ids``, the NB sentinel included) ->
        ids in each row's replica's pool slice, ``replicas`` giving each
        row's replica; unchanged on one device."""
        if self.parallel is None:
            return ids
        bpp = self.kv.blocks_per_partition
        base = (np.asarray(replicas) * bpp).reshape(
            (-1,) + (1,) * (ids.ndim - 1))
        return np.where(ids >= self.kv.num_blocks, bpp,
                        ids - base).astype(np.int32)

    def _replica_kw(self, slot: int) -> Dict[str, int]:
        """The step's ``replica`` argument for a request in ``slot``."""
        if self.parallel is None:
            return {}
        return {"replica": self._partition(slot)}

    def _full_prompt(self, req, prompt: np.ndarray) -> np.ndarray:
        """Preemption resume (recompute mode): the effective prompt is the
        original prompt plus everything generated before eviction."""
        if req.rid in self._resume_rids and self.generated.get(req.rid):
            return np.concatenate(
                [np.asarray(prompt, np.int32),
                 np.asarray(self.generated[req.rid], np.int32)])
        return np.asarray(prompt, np.int32)

    def can_admit(self, req, prompt: np.ndarray, slot: int) -> bool:
        if not self.paged:
            return True
        full = self._full_prompt(req, prompt)
        # +1: the first decode token must be appendable without preemption
        return self.kv.can_allocate(len(full) + 1, self._partition(slot),
                                    tokens=[int(t) for t in full])

    def preferred_slots(self, req, prompt: np.ndarray,
                        free: List[int]) -> List[int]:
        """Prefix-cache-aware admission order: free slots whose partition
        holds the longest registered prefix of this prompt come first;
        ties keep slot order (the dense layout keeps slot order)."""
        if not self.paged or len(free) <= 1:
            return list(free)
        toks = [int(t) for t in self._full_prompt(req, prompt)]
        score = {p: len(self.kv.prefix_match_blocks(p, toks))
                 for p in {self._partition(s) for s in free}}
        return sorted(free, key=lambda s: (-score[self._partition(s)], s))

    def start_request(self, req, prompt: np.ndarray, slot: int):
        """Admit ``req`` into ``slot``.  Monolithic mode
        (``prefill_chunk == 0``) prefills the whole prompt, padded to a
        multiple of the bucket, here and returns the first generated token;
        chunked mode only allocates KV and enqueues a job, and returns None
        (the first token arrives from ``decode_tick``)."""
        if self.prefill_chunk:
            return self._start_request_chunked(req, prompt, slot)
        resume = req.rid in self._resume_rids
        full = self._full_prompt(req, prompt)
        S = len(full)
        bucket = self.prefill_bucket
        S_pad = max(bucket, -(-S // bucket) * bucket)
        toks = np.zeros((1, S_pad), np.int32)
        toks[0, :S] = full
        r = self._partition(slot)
        # the span closes once the first token is on the host, so it holds
        # the prefill's device time too (the time to first token)
        with obs.get_tracer().span("prefill.request", cat="serve",
                                   args={"rid": req.rid, "S_pad": S_pad}):
            if self.paged:
                alloc = self.kv.allocate(
                    req.rid, S, partition=r,
                    priority=getattr(req, "priority", 0),
                    tokens=[int(t) for t in full])
                bs = self.kv.block_size
                ids = np.full((S_pad // bs,), self.kv.num_blocks, np.int32)
                for j, b in enumerate(alloc.blocks):
                    if j >= alloc.num_shared:  # shared prefix: not rewritten
                        ids[j] = b
                where = self._local_ids(ids, [r])
            else:
                # the slot's row in its replica's slice
                where = np.array([self._local_row(slot)], np.int32)
            first = self._run_prefill(S_pad, slot, toks, S, where)
            if self.paged:
                # the NB sentinel, never block 0 (a valid row), clears the
                # previous occupant's rows
                self.block_tables[slot, :] = self.kv.num_blocks
                self.block_tables[slot, :len(alloc.blocks)] = alloc.blocks
        produced = len(self.generated.get(req.rid, [])) if resume else 0
        remaining = req.output_len - produced - 1
        self.slots[slot] = SlotState(rid=req.rid, remaining=remaining,
                                     active=remaining > 0,
                                     priority=getattr(req, "priority", 0))
        self.lengths[slot] = S
        self.tokens[slot] = first
        if resume:
            self._resume_rids.discard(req.rid)
            self.generated[req.rid].append(first)
        else:
            self.generated[req.rid] = [first]
        if remaining <= 0:
            # the prefill token was the last (output_len 1, or a resume
            # with only its final token left): report completion here, the
            # request never reaches decode_tick
            self.slots[slot].active = False
            if self.paged:
                self.kv.free(req.rid)
            self._finished_at_admission.append(req.rid)
        return first

    def _start_request_chunked(self, req, prompt: np.ndarray, slot: int):
        """Chunked admission: no model compute runs here.  Paged KV is
        allocated up-front (occupancy-gated like ``can_admit``) but prefix
        chains register only as chunks are written (``register_written``)
        — a matching arrival must never bind to blocks whose contents are
        still pending — and the job starts past the CoW-shared prefix
        (``prefix_skip``); dense KV starts at 0 in the slot's row.  Returns
        None: the first token arrives from ``decode_tick`` when the final
        chunk lands."""
        resume = req.rid in self._resume_rids
        full = self._full_prompt(req, prompt)
        S = len(full)
        start = 0
        if self.paged:
            alloc = self.kv.allocate(req.rid, S,
                                     partition=self._partition(slot),
                                     priority=getattr(req, "priority", 0),
                                     tokens=[int(t) for t in full],
                                     register=False)
            self.block_tables[slot, :] = self.kv.num_blocks
            self.block_tables[slot, :len(alloc.blocks)] = alloc.blocks
            start = prefix_skip(alloc.num_shared, self.kv.block_size, S)
        produced = len(self.generated.get(req.rid, [])) if resume else 0
        remaining = req.output_len - produced - 1
        self.slots[slot] = SlotState(rid=req.rid, remaining=remaining,
                                     active=True, prefilling=True,
                                     priority=getattr(req, "priority", 0))
        self.lengths[slot] = S
        if resume:
            self._resume_rids.discard(req.rid)
        self._chunk_ctx[slot] = (full,
                                 resume and bool(self.generated.get(req.rid)))
        self._prefilling.append(PrefillJob(slot=slot, rid=req.rid,
                                           pos=start, total=S))
        return None

    def drain_finished_at_admission(self) -> List[int]:
        """Requests whose prefill produced their final token."""
        out, self._finished_at_admission = self._finished_at_admission, []
        return out

    def _prefill(self, S_pad: int) -> Callable:
        """The prefill step for a bucket.  Dense KV serves only the buckets
        it was given, as the reference does; paged mode builds an unseen
        bucket (preemption resumes grow prompts past the given set) and
        keeps at most ``MAX_LAZY_PREFILL`` such buckets, least recently
        used first out."""
        key = f"prefill_{S_pad}"
        if key in self.compiled:
            if key in self._lazy_prefill:
                self._lazy_prefill.move_to_end(key)
            return self.compiled[key]
        if not self.paged:
            raise KeyError(f"no prefill step for bucket {S_pad} (dense KV "
                           f"serves only the prefill_buckets it was given)")
        self.compiled[key] = partial(_paged_prefill_fn, self.mcfg,
                                     parallel=self.parallel)
        self._lazy_prefill[key] = None
        while len(self._lazy_prefill) > self.MAX_LAZY_PREFILL:
            old, _ = self._lazy_prefill.popitem(last=False)
            self.compiled.pop(old, None)
        return self.compiled[key]

    def _run_prefill(self, S_pad: int, slot: int, toks: np.ndarray,
                     length: int, where: np.ndarray) -> int:
        """One monolithic prefill of ``toks`` [1, S_pad] for ``slot``: its
        bucket's graph on the slot's replica where the set holds one, else
        the eager step; ``where`` is the slot's local row (dense KV) or the
        block ids local to the replica's pool slice (paged).  Returns the
        first token, read once, right after the step."""
        if self.graphs is not None and self.graphs.has_prefill(S_pad):
            first = self.graphs.prefill(self._partition(slot), toks, length,
                                        where)
        else:
            first, self.cache = self._prefill(S_pad)(
                self.params, self.cache, self._to_device(toks),
                self._to_device(np.array([length], np.int32)),
                self._to_device(where), **self._replica_kw(slot))
        return int(first[0])

    def _chunk_prefill(self) -> Callable:
        return self.compiled[f"chunk_prefill_{self.prefill_chunk}"]

    def _local_row(self, slot: int) -> int:
        """A slot's row in its replica's slice of the slot cache."""
        if self.parallel is None:
            return slot
        return slot % self.batch_per_replica

    # -------------------------------------------------- paged bookkeeping
    def _slot_of(self, rid: int) -> int:
        for i, s in enumerate(self.slots):
            if s.rid == rid and s.active:
                return i
        raise KeyError(rid)

    def _preempt_slot(self, slot: int) -> None:
        """Evict a sequence under pool pressure: free its blocks, park the
        rid for the server to re-queue; it restarts in recompute mode."""
        s = self.slots[slot]
        if s.prefilling:
            self._prefilling = [j for j in self._prefilling
                                if j.slot != slot]
            self._chunk_ctx.pop(slot, None)
        self.kv.preempt(s.rid)
        self.preemptions += 1
        obs.get_tracer().instant("preempt", cat="serve",
                                 args={"rid": s.rid, "slot": slot})
        self._resume_rids.add(s.rid)
        self._preempted_pending.append(s.rid)
        self.slots[slot] = SlotState()

    def drain_preempted(self) -> List[int]:
        out, self._preempted_pending = self._preempted_pending, []
        return out

    # ------------------------------------- live migration (scale-down)
    def doomed_active_slots(self) -> List[int]:
        """Active slots the pending scale-down evicts (at or above
        ``admit_limit``), migrating ones included."""
        if self.admit_limit is None:
            raise RuntimeError("no scale-down is pending")
        return [i for i, s in enumerate(self.slots)
                if s.active and i >= self.admit_limit]

    def copy_block(self, src: int, dst: int) -> None:
        """Copy pool row ``src`` of replica ``src // bpp`` into row ``dst``
        of replica ``dst // bpp`` in place, every layer and leaf (an int8
        pool's scale rows too), each TP rank's copy of the source slice
        into the same rank's copy of the destination slice, so the copies
        stay bitwise equal.  A copy-on-write block stays in its partition
        (on the serving thread); a migration copy crosses replicas (on a
        TransferEngine worker, on the card under its side stream) and
        writes only a reserved block."""
        bpp = self.kv.blocks_per_partition
        r, q = src // bpp, dst // bpp
        for leaf in self.cache.values():
            if isinstance(leaf, ShardedTensor):
                tp = self.parallel.tp
                for t in range(tp):
                    s_t = leaf.shard(self.parallel.devices[r * tp + t])
                    d_t = leaf.shard(self.parallel.devices[q * tp + t])
                    d_t[:, dst - q * bpp].copy_(s_t[:, src - r * bpp])
            else:
                leaf[:, dst].copy_(leaf[:, src])

    def prewarm_block_copy(self) -> None:
        """The reference builds its block-copy executable here, on the
        serving thread, before the workers issue it.  The port's copy is
        eager: a self-copy of block 0 (a content no-op) runs the path
        once."""
        self.copy_block(0, 0)

    def plan_migration(self) -> Optional[MigrationJob]:
        """Plan ONE component move off a doomed partition, or None.

        Takes the first doomed partition with unmigrated live sequences,
        groups them into block-sharing components (the unit that keeps CoW
        refcounts) and places each onto a survivor partition with enough
        free slots and free blocks.  A component no survivor can ever hold
        falls back to recompute preemption (freed and re-queued, restarted
        after the switchover); one waiting only on survivor slots is left
        for a later call (admission is paused, so slots only free up)."""
        if not self.paged or self.admit_limit is None:
            raise RuntimeError("migration needs paged KV and a pending "
                               "scale-down")
        keep_parts = self.admit_limit // self.batch_per_replica
        bpr = self.batch_per_replica
        slot_of = {s.rid: i for i, s in enumerate(self.slots) if s.active}
        for part in range(keep_parts, self.kv.num_partitions):
            for comp in self.kv.share_components(part):
                if any(self.kv.migrating(s) for s in comp):
                    continue
                if any(r not in slot_of for r in comp):
                    continue            # finishing this tick; skip
                need = self.kv.migration_need(comp)
                placed = None
                for q in range(keep_parts):
                    free = [i for i in range(q * bpr, (q + 1) * bpr)
                            if not self.slots[i].active
                            and not self.slots[i].reserved
                            and i < self.admit_limit]
                    if len(free) >= len(comp) \
                            and self.kv.free_blocks(q) >= need:
                        placed = (q, free)
                        break
                if placed is None:
                    if len(comp) <= bpr and any(
                            self.kv.free_blocks(q) >= need
                            for q in range(keep_parts)):
                        continue        # blocks exist; waiting on slots
                    # no survivor can ever hold this component: recompute
                    for rid in sorted(comp):
                        self._preempt_slot(slot_of[rid])
                    continue
                q, free = placed
                ticket = self.kv.begin_migration(comp, q)
                moves = []
                for rid, dst in zip(sorted(comp), free):
                    src = slot_of[rid]
                    self.slots[src].migrating = True
                    self.slots[dst] = SlotState(reserved=True)
                    moves.append((rid, src, dst))
                # the copies read the source rows the last step wrote on
                # the default stream: their side streams wait for this
                return MigrationJob(ticket=ticket, moves=moves,
                                    ready=ready_events(self._devices()))
        return None

    def _devices(self) -> List[torch.device]:
        if self.parallel is None:
            return [self.device]
        return [self.parallel.torch_device(d) for d in self.parallel.devices]

    def finish_migration(self, job: MigrationJob) -> None:
        """Cut-over after every pair of ``job.ticket`` landed: commit the
        block-table rewrite, re-home each slot's state to its survivor
        slot, and resume decoding there."""
        obs.get_tracer().instant(
            "kv.migrate", cat="serve",
            args={"rids": sorted(r for r, _, _ in job.moves),
                  "blocks": len(job.ticket.pairs)})
        self.kv.commit_migration(job.ticket)
        NB = self.kv.num_blocks
        for rid, src, dst in job.moves:
            st = self.slots[src]
            if st.rid != rid or not st.migrating:
                raise RuntimeError(f"slot {src} no longer holds migrating "
                                   f"seq {rid}")
            st.migrating = False
            self.slots[dst] = st
            self.slots[src] = SlotState()
            self.lengths[dst] = self.lengths[src]
            self.tokens[dst] = self.tokens[src]
            tbl = self.kv.block_table(rid)
            self.block_tables[dst, :] = NB
            self.block_tables[dst, :len(tbl)] = tbl
            self.block_tables[src, :] = NB
            # a mid-prefill sequence resumes chunking on its survivor slot
            # (chunk ids come from the committed block table at execution)
            for j in self._prefilling:
                if j.slot == src:
                    j.slot = dst
            if src in self._chunk_ctx:
                self._chunk_ctx[dst] = self._chunk_ctx.pop(src)

    def cancel_migration(self, job: MigrationJob) -> None:
        """Abort an in-flight migration: the reservation unwinds, the
        source tables were never touched, and the paused sequences resume
        decoding in place."""
        self.kv.abort_migration(job.ticket)
        for _, src, dst in job.moves:
            if self.slots[src].migrating:
                self.slots[src].migrating = False
            if self.slots[dst].reserved:
                self.slots[dst] = SlotState()

    def _ensure_append(self, slot: int) -> bool:
        """Reserve the write slot for this sequence's next token, preempting
        lower-priority sequences in the same partition when the pool is dry.
        Returns False if the sequence itself was preempted."""
        rid = self.slots[slot].rid
        while True:
            try:
                r = self.kv.append(rid)
                break
            except MemoryError:
                part = self._partition(slot)
                cands = [s.rid for i, s in enumerate(self.slots)
                         if s.active and self._partition(i) == part]
                victim = self.kv.victim(candidates=cands)
                if victim is None or victim == rid:
                    self._preempt_slot(slot)
                    return False
                self._preempt_slot(self._slot_of(victim))
        if r is not None:
            if r.cow_src is not None:
                self.copy_block(r.cow_src, r.block)
                obs.get_tracer().instant(
                    "kv.cow_copy", cat="serve",
                    args={"src": r.cow_src, "dst": r.block})
            j = int(self.lengths[slot]) // self.kv.block_size
            self.block_tables[slot, j] = r.block
        return True

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @obs.traced("prefill.chunks", cat="serve")
    def _run_prefill_chunks(self) -> List[Tuple[int, int, bool]]:
        """The tick's prefill phase: at most ``prefill_budget`` prompt
        tokens as ``prefill_chunk``-token chunks in admission order.  Chunk
        block ids are derived from the block manager at execution time.
        Returns first-token events for jobs whose final chunk landed.  A
        migrating sequence's job is paused until its move lands."""
        for job in self._prefilling:
            job.paused = self.slots[job.slot].migrating
        plans = self.scheduler.plan(self._prefilling)
        out: List[Tuple[int, int, bool]] = []
        C = self.prefill_chunk
        jobs = {j.slot: j for j in self._prefilling}
        for plan in plans:
            slot = plan.slot
            job = jobs[slot]
            full, resumed = self._chunk_ctx[slot]
            toks = np.zeros((1, C), np.int32)
            toks[0, :plan.take] = full[plan.start:plan.start + plan.take]
            upto = plan.start + plan.take
            r = [self._partition(slot)]
            if self.paged:
                where = self._chunk_blocks(job, plan.start, r)
            else:
                # dense KV: the slot's row in its replica's slice
                where = (np.array([self._local_row(slot)], np.int32),)
            if self.graphs is not None:
                first = self.graphs.chunk(r[0], toks, plan.start, upto,
                                          *where)
            else:
                first, self.cache = self._chunk_prefill()(
                    self.params, self.cache, self._to_device(toks),
                    self._to_device(np.array([plan.start], np.int32)),
                    self._to_device(np.array([upto], np.int32)),
                    *map(self._to_device, where), **self._replica_kw(slot))
            job.pos = upto
            if self.paged:
                # written blocks become matchable for later arrivals
                self.kv.register_written(job.rid, [int(t) for t in full],
                                         upto)
            if plan.final:
                out.append(self._finish_prefill(slot, job, int(first),
                                                resumed))
        return out

    def _chunk_blocks(self, job: PrefillJob, start: int, replicas
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """A paged chunk's block table [1, MB] and the pool rows [C/bs] it
        writes, local to its replica's slice, from the block manager at
        execution time: the NB sentinel drops writes to padding, CoW-shared
        prefix blocks, and (on the rounded-down ``prefix_skip`` start)
        recomputed rows."""
        C, bs, NB = self.prefill_chunk, self.kv.block_size, self.kv.num_blocks
        sb = self.kv.seq(job.rid)
        j0 = start // bs
        ids = np.full((C // bs,), NB, np.int32)
        for k in range(C // bs):
            j = j0 + k
            if sb.num_shared <= j < len(sb.blocks):
                ids[k] = sb.blocks[j]
        tbl = np.full((1, self.max_len // bs), NB, np.int32)
        bt = self.kv.block_table(job.rid)
        tbl[0, :len(bt)] = bt
        return (self._local_ids(tbl, replicas),
                self._local_ids(ids, replicas))

    def _finish_prefill(self, slot: int, job: PrefillJob, first: int,
                        resumed: bool) -> Tuple[int, int, bool]:
        """Final chunk landed: record the first generated token and move the
        slot into the decode pool (it decodes this same tick)."""
        s = self.slots[slot]
        s.prefilling = False
        self._prefilling.remove(job)
        self._chunk_ctx.pop(slot, None)
        self.tokens[slot] = first
        if resumed:
            self.generated[s.rid].append(first)
        else:
            self.generated[s.rid] = [first]
        fin = s.remaining <= 0
        if fin:
            # output_len 1 (or a resume with only its final token left)
            s.active = False
            if self.paged:
                self.kv.free(s.rid)
        return (s.rid, first, fin)

    @obs.traced("decode.tick", cat="serve")
    def decode_tick(self) -> List[Tuple[int, int, bool]]:
        """One engine tick: the prefill phase when chunking (at most
        ``prefill_budget`` prompt tokens), then one decode step for every
        runnable slot — decode runs every tick regardless of prefill
        backlog.  Runnable: active, not mid-prefill and not paused by an
        in-flight migration (its blocks are frozen until the copies land,
        then it resumes on its survivor slot).  Returns [(rid, token,
        finished)]; prefill completions come first."""
        pre: List[Tuple[int, int, bool]] = []
        if self.scheduler is not None and self._prefilling:
            pre = self._run_prefill_chunks()
        if self.paged:
            # highest priority first, oldest first on ties: pressure
            # evicts from the low-priority/young end before it reaches them
            order = sorted((i for i, s in enumerate(self.slots)
                            if s.active and not s.migrating
                            and not s.prefilling),
                           key=lambda i: (-self.slots[i].priority,
                                          self.slots[i].rid))
            for slot in order:
                if self.slots[slot].active:
                    self._ensure_append(slot)
        runnable = [s.active and not s.migrating and not s.prefilling
                    for s in self.slots]
        if not any(runnable):
            return pre
        active = np.array(runnable)
        self._step_count += 1
        # routing telemetry: every Nth tick runs the twin that also gives
        # the routing counts (the same arithmetic otherwise)
        routed = (self.routing_sample_every > 0
                  and "decode_routed" in self.compiled
                  and self._step_count % self.routing_sample_every == 0)
        args = [self.tokens, self.lengths, active]
        if self.paged:
            parts = np.arange(len(self.slots)) // self.batch_per_replica
            args.append(self._local_ids(self.block_tables, parts))
        if self.graphs is not None:
            nxt = (self.graphs.decode_routed(*args) if routed
                   else self.graphs.decode(*args))
        else:
            nxt, self.cache = self.compiled[
                "decode_routed" if routed else "decode"](
                self.params, self.cache, *map(self._to_device, args))
        # the tokens and, routed, the counts behind them: one copy
        nxt = nxt.cpu().numpy()
        if routed:
            self._accumulate_routing(nxt[len(self.slots):].reshape(
                -1, self.mcfg.num_experts))
        out = []
        for i, s in enumerate(self.slots):
            if not active[i]:
                continue
            self.lengths[i] += 1
            self.tokens[i] = nxt[i]
            self.generated[s.rid].append(int(nxt[i]))
            s.remaining -= 1
            fin = s.remaining <= 0 or self.lengths[i] >= self.max_len - 1
            if fin:
                s.active = False
                if self.paged:
                    self.kv.free(s.rid)
            out.append((s.rid, int(nxt[i]), fin))
        return pre + out

    # --------------------------------------------------- routing telemetry
    def _accumulate_routing(self, counts) -> None:
        """Add one sampled tick's [L_moe, E] expert counts to the host-side
        histogram and record a skew counter sample.  A change of shape (a
        rebind to another routed step) restarts the counts and the sample
        count together."""
        c = np.asarray(counts, np.int64)
        if self._routing_counts is None or \
                self._routing_counts.shape != c.shape:
            self._routing_counts = np.zeros_like(c)
            self._routing_samples = 0
        self._routing_counts += c
        self._routing_samples += 1
        tr = obs.get_tracer()
        if tr.enabled:
            tot = np.maximum(c.sum(axis=-1), 1)
            tr.counter("routing.top_expert_share",
                       float((c.max(axis=-1) / tot).mean()), cat="routing")

    def reset_routing_stats(self) -> None:
        """Restart the routing histogram (counts and sample count): at a
        scale's switchover and at a rebalance commit, whose new placement
        the old counts no longer describe."""
        self._routing_counts = None
        self._routing_samples = 0

    def routing_stats(self) -> Optional[dict]:
        """The accumulated per-expert routing histogram (None until a
        sampled tick has landed): ``counts`` [L_moe, E] token counts, and
        the layer-averaged skew metrics ``top_expert_share`` (the busiest
        expert's share) and ``expert_cv`` (the counts' coefficient of
        variation) — the signal the rebalancer acts on."""
        if self._routing_counts is None or self._routing_samples == 0:
            return None
        c = self._routing_counts.astype(np.float64)
        tot = np.maximum(c.sum(axis=-1), 1.0)
        share = c.max(axis=-1) / tot
        mean = np.maximum(c.mean(axis=-1), 1e-9)
        cv = c.std(axis=-1) / mean
        return {"samples": self._routing_samples,
                "counts": self._routing_counts.copy(),
                "top_expert_share": float(share.mean()),
                "expert_cv": float(cv.mean())}
