"""Inference engine on one device: continuous batching over the paged KV
pool with chunked prefill — the port of the one-device serving half of
``repro.serving.engine``.

The cache is a block *pool* ``[L, NB, bs, ...]`` and each slot holds a
block table (``serving/kv_blocks.py``).  Admission is gated by free blocks,
shared prompt prefixes are copy-on-write, and when the pool runs dry the
lowest-priority sequence is preempted (freed + re-queued; recomputed on
resume).  Each tick runs at most ``prefill_budget`` prompt tokens as
``prefill_chunk``-token chunks (``serving/scheduler.py``), then one decode
step for every runnable slot.

The step functions are plain callables keyed like the reference's compiled
executables (``decode``, ``chunk_prefill_{C}``); PyTorch runs them eagerly.
They update the pool in place: the reference donates it to its jitted
steps, here the rows are written directly.
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.models import model as M
from repro_torch.serving.kv_blocks import KVBlockManager
from repro_torch.serving.scheduler import (PrefillJob, TokenBudgetScheduler,
                                           prefix_skip)


def _paged_decode_fn(mcfg, params, cache, tokens, lengths, active,
                     block_tables):
    """Greedy paged decode: the write block comes from each sequence's
    length; inactive slots write to the ``NB`` sentinel row (dropped) and
    keep their token."""
    NB, bs = cache["k"].shape[1], cache["k"].shape[2]
    col = (lengths.long() // bs).clamp(max=block_tables.shape[1] - 1)
    wb = block_tables.gather(1, col[:, None])[:, 0]
    wb = torch.where(active, wb, torch.full_like(wb, NB))
    logits, cache = M.paged_decode_step(mcfg, params, tokens[:, None], cache,
                                        lengths, block_tables, wb)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.where(active, nxt, tokens), cache


def _paged_chunk_prefill_fn(mcfg, params, cache, tokens, start, length,
                            block_tables, chunk_ids):
    """One paged prefill chunk: the chunk's KV lands in pool rows
    ``chunk_ids`` (``NB`` = padding or CoW-shared block; dropped) and
    attention reads the whole context through ``block_tables`` [1, MB].
    The returned token is the argmax at the last valid position."""
    logits, cache = M.paged_chunk_prefill_step(mcfg, params, tokens, cache,
                                               start, length, block_tables,
                                               chunk_ids)
    return int(torch.argmax(logits, dim=-1)[0]), cache


def compile_step_functions(mcfg, *, prefill_chunk: int
                           ) -> Tuple[Dict[str, Callable], float]:
    """The step callables of an instance, keyed like the reference's
    executables: ``decode`` and ``chunk_prefill_{C}``.  Eager PyTorch needs
    no compilation; returns (callables, seconds) as the reference does."""
    t0 = time.perf_counter()
    if not M.chunk_prefill_supported(mcfg):
        raise ValueError(f"{mcfg.name}: chunked prefill unsupported")
    out = {"decode": partial(_paged_decode_fn, mcfg),
           f"chunk_prefill_{prefill_chunk}":
               partial(_paged_chunk_prefill_fn, mcfg)}
    return out, time.perf_counter() - t0


@dataclasses.dataclass
class SlotState:
    rid: int = -1
    remaining: int = 0
    active: bool = False
    priority: int = 0
    # chunked prefill: admitted but not fully prefilled — occupies the slot
    # (and its KV blocks) but is excluded from decode until the final chunk
    prefilling: bool = False


class InferenceEngine:
    """Continuous-batching engine bound to one device's parameters, pool
    and step functions."""

    def __init__(self, mcfg, *, batch_per_replica: int, max_len: int,
                 prefill_bucket: int = 64, prefill_chunk: int = 64,
                 prefill_budget: Optional[int] = None, device="cuda"):
        if prefill_chunk <= 0:
            raise NotImplementedError(
                "prefill_chunk=0 (monolithic prefill) is not ported yet")
        self.mcfg = mcfg
        self.batch_per_replica = batch_per_replica
        self.max_len = max_len
        self.prefill_bucket = prefill_bucket
        self.prefill_chunk = prefill_chunk
        self.device = torch.device(device)
        self.scheduler = TokenBudgetScheduler(prefill_chunk, prefill_budget)
        self._prefilling: List[PrefillJob] = []       # FIFO, admission order
        # slot -> (full prompt, resumed): host-side context for chunk jobs
        self._chunk_ctx: Dict[int, Tuple[np.ndarray, bool]] = {}
        self.cfg = None
        self.params = None
        self.cache = None
        self.compiled: Dict[str, Callable] = {}
        self.slots: List[SlotState] = []
        self.lengths: Optional[np.ndarray] = None
        self.tokens: Optional[np.ndarray] = None
        self.generated: Dict[int, List[int]] = {}
        self.kv: Optional[KVBlockManager] = None
        self.block_tables: Optional[np.ndarray] = None
        self._preempted_pending: List[int] = []   # rids awaiting re-queue
        self._resume_rids: set = set()            # preempted at least once
        self.preemptions = 0
        self._step_count = 0

    # ------------------------------------------------------------- binding
    @property
    def num_slots(self) -> int:
        return 0 if self.cfg is None else self.cfg.dp * self.batch_per_replica

    def bind(self, cfg, params, cache, compiled, kv: KVBlockManager):
        """Attach the instance's parameters, pool and step functions."""
        self.cfg = cfg
        self.params, self.cache = params, cache
        self.compiled = compiled
        self.kv = kv
        n = self.num_slots
        self.slots = [SlotState() for _ in range(n)]
        self.lengths = np.zeros((n,), np.int32)
        self.tokens = np.zeros((n,), np.int32)
        if not M.chunk_prefill_supported(self.mcfg):
            raise ValueError("chunked prefill unsupported for this model")
        bs = kv.block_size
        if self.max_len % bs or self.prefill_bucket % bs \
                or self.prefill_chunk % bs:
            raise ValueError("max_len, prefill buckets and prefill_chunk "
                             "must be block-size multiples")
        # padding rows hold the NB sentinel (never block id 0, a valid row)
        self.block_tables = np.full((n, self.max_len // bs), kv.num_blocks,
                                    np.int32)

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if not s.active]

    def utilization(self) -> float:
        """Block-pool occupancy (drives load estimation)."""
        return self.kv.used_blocks() / max(self.kv.num_blocks, 1)

    def block_nbytes(self) -> int:
        """Device bytes of ONE pool block across all layers/tensors."""
        return sum(leaf.nbytes // leaf.shape[1]
                   for leaf in self.cache.values())

    def kv_stats(self) -> Dict[str, float]:
        st = self.kv.stats()
        st["preemptions"] = self.preemptions
        st["block_bytes"] = self.block_nbytes()
        return st

    # ------------------------------------------------------------- serving
    def _partition(self, slot: int) -> int:
        return slot // self.batch_per_replica

    def _full_prompt(self, req, prompt: np.ndarray) -> np.ndarray:
        """Preemption resume (recompute mode): the effective prompt is the
        original prompt plus everything generated before eviction."""
        if req.rid in self._resume_rids and self.generated.get(req.rid):
            return np.concatenate(
                [np.asarray(prompt, np.int32),
                 np.asarray(self.generated[req.rid], np.int32)])
        return np.asarray(prompt, np.int32)

    def can_admit(self, req, prompt: np.ndarray, slot: int) -> bool:
        full = self._full_prompt(req, prompt)
        # +1: the first decode token must be appendable without preemption
        return self.kv.can_allocate(len(full) + 1, self._partition(slot),
                                    tokens=[int(t) for t in full])

    def preferred_slots(self, req, prompt: np.ndarray,
                        free: List[int]) -> List[int]:
        """Prefix-cache-aware admission order: free slots whose partition
        holds the longest registered prefix of this prompt come first;
        ties keep slot order."""
        if len(free) <= 1:
            return list(free)
        toks = [int(t) for t in self._full_prompt(req, prompt)]
        score = {p: len(self.kv.prefix_match_blocks(p, toks))
                 for p in {self._partition(s) for s in free}}
        return sorted(free, key=lambda s: (-score[self._partition(s)], s))

    def start_request(self, req, prompt: np.ndarray, slot: int):
        """Chunked admission: no model compute runs here.  KV is allocated
        up-front (occupancy-gated like ``can_admit``) but prefix chains
        register only as chunks are written (``register_written``) — a
        matching arrival must never bind to blocks whose contents are still
        pending.  The job starts past the CoW-shared prefix
        (``prefix_skip``).  Returns None: the first token arrives from
        ``decode_tick`` when the final chunk lands."""
        resume = req.rid in self._resume_rids
        full = self._full_prompt(req, prompt)
        S = len(full)
        alloc = self.kv.allocate(req.rid, S, partition=self._partition(slot),
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

    def _chunk_prefill(self) -> Callable:
        return self.compiled[f"chunk_prefill_{self.prefill_chunk}"]

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

    def _copy_block(self, src: int, dst: int) -> None:
        """Physical copy-on-write: duplicate pool row ``src`` into ``dst``
        across all layers, in place (one block row moved, not a pool
        copy)."""
        for leaf in self.cache.values():
            leaf[:, dst] = leaf[:, src]

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
                self._copy_block(r.cow_src, r.block)
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
        Returns first-token events for jobs whose final chunk landed."""
        plans = self.scheduler.plan(self._prefilling)
        out: List[Tuple[int, int, bool]] = []
        C = self.prefill_chunk
        bs = self.kv.block_size
        NB = self.kv.num_blocks
        jobs = {j.slot: j for j in self._prefilling}
        for plan in plans:
            slot = plan.slot
            job = jobs[slot]
            full, resumed = self._chunk_ctx[slot]
            toks = np.zeros((1, C), np.int32)
            toks[0, :plan.take] = full[plan.start:plan.start + plan.take]
            upto = plan.start + plan.take
            sb = self.kv.seq(job.rid)
            j0 = plan.start // bs
            # pool rows this chunk writes: the NB sentinel drops writes to
            # padding, CoW-shared prefix blocks, and (on the rounded-down
            # prefix_skip start) recomputed rows
            ids = np.full((C // bs,), NB, np.int32)
            for k in range(C // bs):
                j = j0 + k
                if sb.num_shared <= j < len(sb.blocks):
                    ids[k] = sb.blocks[j]
            tbl = np.full((1, self.max_len // bs), NB, np.int32)
            bt = self.kv.block_table(job.rid)
            tbl[0, :len(bt)] = bt
            first, self.cache = self._chunk_prefill()(
                self.params, self.cache, self._to_device(toks), plan.start,
                upto, self._to_device(tbl), self._to_device(ids))
            job.pos = upto
            # written blocks become matchable for later arrivals
            self.kv.register_written(job.rid, [int(t) for t in full], upto)
            if plan.final:
                out.append(self._finish_prefill(slot, job, int(first),
                                                resumed))
        return out

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
            self.kv.free(s.rid)
        return (s.rid, first, fin)

    @obs.traced("decode.tick", cat="serve")
    def decode_tick(self) -> List[Tuple[int, int, bool]]:
        """One engine tick: the prefill phase (at most ``prefill_budget``
        prompt tokens), then one decode step for every runnable slot —
        decode runs every tick regardless of prefill backlog.  Returns
        [(rid, token, finished)]; prefill completions come first."""
        pre: List[Tuple[int, int, bool]] = []
        if self._prefilling:
            pre = self._run_prefill_chunks()
        # highest priority first, oldest first on ties: pressure evicts
        # from the low-priority/young end before it reaches them
        order = sorted((i for i, s in enumerate(self.slots)
                        if s.active and not s.prefilling),
                       key=lambda i: (-self.slots[i].priority,
                                      self.slots[i].rid))
        for slot in order:
            if self.slots[slot].active:
                self._ensure_append(slot)
        runnable = [s.active and not s.prefilling for s in self.slots]
        if not any(runnable):
            return pre
        active = np.array(runnable)
        self._step_count += 1
        nxt, self.cache = self.compiled["decode"](
            self.params, self.cache, self._to_device(self.tokens),
            self._to_device(self.lengths), self._to_device(active),
            self._to_device(self.block_tables))
        nxt = nxt.cpu().numpy()
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
                self.kv.free(s.rid)
            out.append((s.rid, int(nxt[i]), fin))
        return pre + out
