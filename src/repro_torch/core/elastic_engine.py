"""``ElasticServer`` — the port of ``repro.core.elastic_engine
.ElasticServer``'s ``__init__``, ``boot``, ``submit``, ``tick``, ``step``,
``queue_depth``, ``utilization``, and its scale-up: ``stage_scale``,
``switchover`` and ``scale_to``.

On one device (``ElasticConfig(1, 1, (0,))``) an instance serves a
standard-attention decoder, an MLA decoder (over its latent cache) or a
Mamba2 model, attention-free or hybrid (over its per-slot SSD state and,
hybrid, the shared block's K/V); the last two with dense KV and monolithic
prefill only, as in the reference. On several logical devices
(``all_devices``) a standard-attention decoder serves at any tp whose split
keeps every head whole: each DP replica runs its attention on its own
shards and slots (at tp > 1 split over its TP ranks, with explicit sums
between them), the MoE runs expert-parallel across every device, and the
server scales DP up while it serves: ``stage_scale`` stages the target's
weights between ticks (the engine keeps serving on the old instance),
``switchover`` commits them and rebinds the engine, whose surviving slots
continue on the same KV shards.

The defaults are the reference's: the slot-contiguous KV cache
(``kv_mode="dense"``), dense expert banks (``expert_mode="dense"``) and a
monolithic prefill at admission (``prefill_chunk=0``); the paged KV pool,
pooled expert pages, chunked prefill and the int8 stores are the other
modes.  Dense KV with chunked prefill is not ported yet and raises.  So do
a TP degree that cuts a head, a server-level scale-down (it needs Slice
B's KV migration or drain), overlapped staging, rebalancing and parking:
their knobs keep the reference's names and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from repro_torch import obs
from repro_torch.core.hmm import (HMM, REBALANCE, SLICE_B, SLICE_C,
                                  TELEMETRY, TransferStats, not_ported)
from repro_torch.core.topology import ElasticConfig
from repro_torch.distributed.sharding import make_instance_mesh
from repro_torch.models.model import check_tp_heads, chunk_prefill_supported
from repro_torch.serving.engine import (InferenceEngine,
                                        compile_step_functions,
                                        engine_parallel_ctx)
from repro_torch.serving.workload import Request


@dataclasses.dataclass
class ScaleEvent:
    """One scale event.  ``stats`` is the HMM's ``last_stats``: the
    staging's bytes, and after ``switchover`` also the commit's.
    ``compile_hit``: whether the target's step functions were ready
    without compiling — always True in the port, whose eager step
    functions are built in microseconds at switchover (the reference
    reports its IMM's executable cache).  ``stall_s`` is the serve loop's
    time blocked on staging (all of ``stage_s`` with serial staging);
    ``stage_wall_s`` freezes the staging's wall time, which ``stats``
    later adds the commit to.  ``migrated_blocks`` and ``migration_bytes``
    count a scale-down's live KV moves (Slice B; 0 here)."""
    t: float
    src: str
    dst: str
    stats: TransferStats
    compile_hit: bool
    stage_s: float
    switch_s: float
    stall_s: float = 0.0
    staging: str = "serial"
    stage_wall_s: float = 0.0
    migrated_blocks: int = 0
    migration_bytes: int = 0


class ElasticServer:
    def __init__(self, mcfg, *, tp: int, batch_per_replica: int,
                 max_len: int, prefill_buckets=(64,), all_devices=None,
                 policy=None, seed: int = 0,
                 kv_mode: str = "dense", kv_block_size: int = 16,
                 kv_blocks_per_replica: Optional[int] = None,
                 expert_mode: str = "dense",
                 expert_pool_pages: Optional[int] = None,
                 staging: str = "serial", transfer_workers: int = 4,
                 scaledown: str = "migrate",
                 prefill_chunk: int = 0,
                 prefill_budget: Optional[int] = None,
                 routing_sample_every: int = 0,
                 rebalance=None,
                 expert_slot_slack: Optional[int] = None,
                 expert_host_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 expert_dtype: Optional[str] = None,
                 imm_cache=None, device="cuda"):
        not_ported("policy", policy, None, SLICE_C)
        not_ported("scaledown", scaledown, "migrate", SLICE_B)
        not_ported("routing_sample_every", routing_sample_every, 0,
                   TELEMETRY)
        not_ported("rebalance", rebalance, None, REBALANCE)
        not_ported("imm_cache", imm_cache, None, SLICE_B)
        not_ported("expert_slot_slack", expert_slot_slack or 0, 0,
                   REBALANCE)
        check_tp_heads(mcfg, tp)
        if prefill_chunk and not chunk_prefill_supported(mcfg):
            raise ValueError(f"{mcfg.name}: chunked prefill unsupported "
                             f"(as in the reference)")
        if prefill_chunk and kv_mode == "dense":
            raise NotImplementedError(
                "dense KV with prefill_chunk > 0 is not ported yet")
        self.mcfg = mcfg
        self.kv_mode = kv_mode
        # int8 storage: the HMM owns the layout (int8 pools with f32 scale
        # sidecars) and checks the values
        self.kv_dtype = kv_dtype
        self.expert_dtype = expert_dtype
        self.expert_mode = expert_mode
        self.prefill_chunk = prefill_chunk
        self.prefill_buckets = tuple(prefill_buckets)
        self.hmm = HMM(mcfg, tp, batch_per_replica=batch_per_replica,
                       max_len=max_len, all_devices=all_devices, seed=seed,
                       kv_mode=kv_mode, kv_block_size=kv_block_size,
                       kv_blocks_per_replica=kv_blocks_per_replica,
                       expert_mode=expert_mode,
                       expert_pool_pages=expert_pool_pages,
                       staging=staging, transfer_workers=transfer_workers,
                       expert_host_pages=expert_host_pages,
                       kv_dtype=kv_dtype, expert_dtype=expert_dtype,
                       device=device)
        self.engine = InferenceEngine(mcfg,
                                      batch_per_replica=batch_per_replica,
                                      max_len=max_len,
                                      prefill_bucket=min(prefill_buckets),
                                      prefill_chunk=prefill_chunk,
                                      prefill_budget=prefill_budget,
                                      device=self.hmm.device)
        self.queue: List[Request] = []
        self.requests: Dict[int, Request] = {}
        self.events: List[ScaleEvent] = []
        self._staged_cfg: Optional[ElasticConfig] = None

    # ------------------------------------------------------------ lifecycle
    def boot(self, cfg: ElasticConfig, params=None):
        """Boot on ``cfg``: the HMM draws the weights on the devices, or
        adopts ``params`` (the reference's converted global parameters, as
        the tests pass them), then the engine binds the instance."""
        self.hmm.boot(cfg, params)
        self._bind(cfg)

    def _bind(self, cfg: ElasticConfig):
        """Bind the engine to the HMM's active instance on ``cfg``; the
        cache's ownership moves to the engine."""
        parallel = None
        if cfg.ndev > 1:
            parallel = engine_parallel_ctx(
                make_instance_mesh(cfg, self.hmm.all_devices))
        compiled, _ = compile_step_functions(
            self.mcfg, max_len=self.hmm.max_len,
            prefill_buckets=self.prefill_buckets, kv_mode=self.kv_mode,
            prefill_chunk=self.prefill_chunk, parallel=parallel)
        self.engine.bind(cfg, self.hmm.params, self.hmm.cache, compiled,
                         kv=self.hmm.kv_blocks, parallel=parallel)
        self.hmm.cache = None

    def scale_to(self, new_cfg: ElasticConfig) -> ScaleEvent:
        """Stage and switch over; the engine may serve between the two
        (``stage_scale`` then ``switchover``)."""
        ev = self.stage_scale(new_cfg)
        self.switchover()
        return ev

    def stage_scale(self, new_cfg: ElasticConfig) -> ScaleEvent:
        """Stage ``new_cfg``'s weights (all increments back to back) while
        the active instance stays serveable.  Scale-up only: a server
        scale-down needs Slice B's KV migration or drain."""
        if self.engine.cfg is None:
            raise RuntimeError("boot() the server before scaling it")
        if new_cfg.ndev < self.engine.cfg.ndev:
            raise NotImplementedError(
                "a server scale-down is not ported yet: it needs the live "
                "KV migration (scaledown='migrate') or the drain of "
                f"{SLICE_B} (HMM.begin_scale toward fewer devices, then "
                f"commit or abort, is ported)")
        t0 = time.perf_counter()
        self.hmm.scale(new_cfg)                  # weights only; serving free
        return self._record_stage(new_cfg, time.perf_counter() - t0)

    def _record_stage(self, new_cfg: ElasticConfig, stage_s: float
                      ) -> ScaleEvent:
        self._staged_cfg = new_cfg
        ev = ScaleEvent(t=time.time(), src=self.hmm.active_cfg.describe(),
                        dst=new_cfg.describe(), stats=self.hmm.last_stats,
                        compile_hit=True, stage_s=stage_s, switch_s=0.0,
                        stall_s=stage_s, stage_wall_s=self.hmm.last_stats.wall_s)
        self.events.append(ev)
        return ev

    def switchover(self):
        """Commit the staged instance (the live cache grows: surviving
        replicas' shards are reused, new ones zeroed) and rebind the
        engine to it; the surviving slots continue where they were."""
        if self._staged_cfg is None:
            raise RuntimeError("nothing is staged: stage_scale first")
        t0 = time.perf_counter()
        new_cfg = self._staged_cfg
        self.hmm.commit(live_cache=self.engine.cache)
        self._bind(new_cfg)
        self._staged_cfg = None
        self.events[-1].switch_s = time.perf_counter() - t0

    # -------------------------------------------------------------- serving
    def submit(self, req: Request):
        kv = self.hmm.kv_blocks
        if kv is not None:
            # fail fast on a request no partition can EVER hold: admission
            # is FIFO head-of-line, so letting it queue would stall serving
            need = kv.blocks_needed(req.prompt_len + req.output_len)
            if need > kv.blocks_per_partition:
                raise ValueError(
                    f"request {req.rid} needs {need} KV blocks at completion"
                    f" but a partition holds {kv.blocks_per_partition}")
        self.requests[req.rid] = req
        self.queue.append(req)

    def tick(self, now: float) -> List[int]:
        """One engine tick: admit queued requests into free slots (FIFO;
        paged: gated by free KV blocks, the head request tries every free
        slot, longest registered prefix first) — a monolithic prefill runs
        here and gives the first token — then one engine tick of prefill
        chunks and decode.  Sequences preempted under pool pressure re-enter
        at the front of the queue.  Returns rids finished this tick."""
        tr = obs.get_tracer()
        free = self.engine.free_slots()
        while self.queue and free:
            req = self.queue[0]
            slot = next((s for s in
                         self.engine.preferred_slots(req, req.prompt, free)
                         if self.engine.can_admit(req, req.prompt, s)), None)
            if slot is None:
                break                   # head-of-line blocks; no skipping
            free.remove(slot)
            self.queue.pop(0)
            tr.instant("req.admit", cat="req",
                       args={"rid": req.rid, "slot": slot})
            first = self.engine.start_request(req, req.prompt, slot)
            if first is None:
                continue    # chunked: the first token comes from decode_tick
            if req.first_token_s is None:
                req.first_token_s = now
                req.token_times = [now]
                tr.instant("req.first_token", cat="req",
                           args={"rid": req.rid})
            elif req.token_times is not None:   # preemption resume
                req.token_times.append(now)
        finished = []
        for rid in self.engine.drain_finished_at_admission():
            self.requests[rid].finish_s = now
            finished.append(rid)
            tr.instant("req.finish", cat="req", args={"rid": rid})
        for rid, tok, fin in self.engine.decode_tick():
            req = self.requests[rid]
            if req.first_token_s is None:
                # the final chunk's token is the TTFT mark
                req.first_token_s = now
                req.token_times = [now]
                tr.instant("req.first_token", cat="req", args={"rid": rid})
            elif req.token_times is not None:
                req.token_times.append(now)
            if fin:
                req.finish_s = now
                finished.append(rid)
                tr.instant("req.finish", cat="req", args={"rid": rid})
        preempted = self.engine.drain_preempted()
        if preempted:
            self.queue[:0] = [self.requests[r] for r in preempted]
        return finished

    # --------------------------------------------- ServingBackend protocol
    def step(self, now: float) -> List[Request]:
        """One driver quantum == one engine tick; returns finished Requests."""
        return [self.requests[rid] for rid in self.tick(now)]

    def queue_depth(self) -> int:
        return len(self.queue)

    def utilization(self) -> float:
        return self.engine.utilization()

    def kv_stats(self):
        """Block-pool stats (None for the dense layout)."""
        return self.engine.kv_stats()
