"""The serving half of ``ElasticServer`` on one device — the port of
``repro.core.elastic_engine.ElasticServer``'s ``__init__``, ``boot``,
``submit``, ``tick``, ``step``, ``queue_depth`` and ``utilization``.

One ``ElasticConfig(1, 1, (0,))`` instance serves a standard-attention
decoder, an MLA decoder (over its latent cache) or a Mamba2 model,
attention-free or hybrid (over its per-slot SSD state and, hybrid, the
shared block's K/V); the last two with dense KV and monolithic prefill
only, as in the reference.  The defaults are the
reference's: the slot-contiguous KV cache
(``kv_mode="dense"``), dense expert banks (``expert_mode="dense"``) and a
monolithic prefill at admission (``prefill_chunk=0``); the paged KV pool,
pooled expert pages, chunked prefill and the int8 stores are the other
modes.  Dense KV with chunked prefill is not ported yet and raises.
The elastic half — scale events, KV migration, rebalancing, parking —
exists only across devices and belongs to the multi-card slice: its knobs
keep the reference's names and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch import obs
from repro_torch.core.hmm import HMM, not_ported
from repro_torch.core.topology import ElasticConfig
from repro_torch.models.model import chunk_prefill_supported
from repro_torch.serving.engine import InferenceEngine, compile_step_functions
from repro_torch.serving.workload import Request


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
        not_ported("policy", policy, None)
        not_ported("scaledown", scaledown, "migrate")
        not_ported("routing_sample_every", routing_sample_every, 0)
        not_ported("rebalance", rebalance, None)
        not_ported("imm_cache", imm_cache, None)
        not_ported("expert_slot_slack", expert_slot_slack or 0, 0)
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

    # ------------------------------------------------------------ lifecycle
    def boot(self, cfg: ElasticConfig, params=None):
        """Boot on ``cfg`` (one device): the HMM draws the weights on the
        device, or adopts ``params`` (the reference's converted parameters,
        as the tests pass them), then the engine binds the pool."""
        self.hmm.boot(cfg, params)
        compiled, _ = compile_step_functions(
            self.mcfg, max_len=self.hmm.max_len,
            prefill_buckets=self.prefill_buckets, kv_mode=self.kv_mode,
            prefill_chunk=self.prefill_chunk)
        self.engine.bind(cfg, self.hmm.params, self.hmm.cache, compiled,
                         kv=self.hmm.kv_blocks)
        self.hmm.cache = None  # ownership moves to the engine

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
