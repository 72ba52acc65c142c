"""Inference Management Module — the port of ``repro.core.imm`` (paper
§4.5).

Keeps an LRU cache of *pre-initialized* inference instances.  In the paper
a standby instance is an inference process that has done every one-time
setup except binding weights; in the reference it is the AOT-compiled step
functions of an instance's (mesh, shapes), and ``activate`` binds them to
the HMM's arrays, a metadata-only step.  In the port a standby instance
holds the step callables of ``serving.engine.compile_step_functions`` for
its configuration (bound to its mesh's parallel context) and, once it is
given tensors, their ``core/graphs.StepGraphs``: the decode step (and,
with ``collect_routing``, its routing twin), the chunk steps and, without
chunking, every given prefill bucket captured as CUDA graphs over exactly
those tensors, the counterpart of the reference's compile (on the CPU no
graph is captured and the eager steps serve).

``preinitialize(cfg, params, cache, limit)`` captures the set where the
instance holds none over these tensors, at most ``limit`` graphs a call;
a scale captures its target's set during staging, on the serving thread,
over the staged tensors (``HMM.staged_tensors``): overlapped, one graph a
poll, so the server's ticks run between the captures.  ``activate`` binds a cached set only if the
tensors it attaches are exactly those the set was captured over
(``graphs.Binding``), else it captures afresh and counts a miss.  The
capture time goes into ``compile_s_total`` and the instance's
``compile_s``; evicting an instance drops its graphs.
``ScaleEvent.compile_hit`` reports whether the target's set was ready
before ``switchover``.  ``cuda_graphs=False`` keeps the eager steps on the
card: the comparison twin of tests and ``chip_smoke.py``.

A fleet's servers share one LRU (``shared_cache``).  A set's graphs hold
one server's tensors, so every instance belongs to the IMM that built it
(its key starts with that IMM's ``owner`` token): two servers of one model
never bind, release or recapture each other's set, and an eviction never
drops another server's live set (the one its engine serves on).  ``has``
keeps the reference's meaning: a standby instance of this model and
configuration is cached, whichever server built it.  ``release_all``
drops every set of this server (a park: the graphs' closures hold the
parked tensors, and the graph pool its memory).

A set is bound only over the very tensors it was captured on, and a
scale frees its source's tensors or drops its target's: so at every
``activate`` (a switchover, an unpark's commit) and at every abort of a
scale or an unpark (the server hands ``release_standby`` to its HMM's
``abort_listeners``) each other instance of this server whose set names a
tensor the live set does not hold gives up its graphs and binding, whose
closures would keep that tensor allocated, and which can never be bound
again.  A set whose every
tensor the live set holds frees nothing and can be bound again (a model
without expert index arrays scaled up reuses every tensor of its source,
and the way back down finds them all): it is kept.  The instances stay
cached, so ``has`` and the hit and miss counters keep their meaning.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.graphs import Binding, StepGraphs
from repro_torch.core.topology import ElasticConfig
from repro_torch.core.transfer import cuda_devices
from repro_torch.distributed.sharding import ParallelCtx, make_instance_mesh
from repro_torch.serving.engine import (compile_step_functions,
                                        engine_parallel_ctx)


@dataclasses.dataclass
class StandbyInstance:
    cfg: ElasticConfig
    mesh: Any
    compiled: Dict[str, Any]
    compile_s: float
    parallel: Optional[ParallelCtx] = None   # None on one device
    activations: int = 0
    # the tensors the step set was built over, and its CUDA graphs (None
    # on the CPU or with cuda_graphs=False)
    binding: Optional[Binding] = None
    graphs: Optional[StepGraphs] = None
    # the IMM that built it, and whether its engine serves on this set
    owner: int = 0
    live: bool = False

    def release(self) -> None:
        """Drop the graphs and the binding (an evicted or stale set)."""
        self.graphs = None
        self.binding = None


_OWNERS = itertools.count(1)


class IMM:
    def __init__(self, mcfg, hmm, *, batch_per_replica: int, max_len: int,
                 prefill_buckets=(64,), prefill_chunk: int = 0,
                 lru_capacity: int = 4, collect_routing: bool = False,
                 shared_cache: Optional[
                     "OrderedDict[Tuple, StandbyInstance]"] = None,
                 cuda_graphs: bool = True):
        self.mcfg = mcfg
        self.hmm = hmm
        self.batch_per_replica = batch_per_replica
        self.max_len = max_len
        self.prefill_buckets = tuple(prefill_buckets)
        self.prefill_chunk = prefill_chunk
        # routing telemetry: also build (and on the card capture) the
        # decode step that gives the routing counts
        self.collect_routing = collect_routing
        self.lru_capacity = lru_capacity
        # a fleet shares one LRU across its servers (the same OrderedDict
        # passed to every IMM); keys carry the owner and the model's
        # identity
        self._cache: "OrderedDict[Tuple, StandbyInstance]" = (
            shared_cache if shared_cache is not None else OrderedDict())
        self.owner = next(_OWNERS)
        self.stats = {"preinit_hits": 0, "preinit_misses": 0,
                      "compile_s_total": 0.0, "captures": 0}
        # on the card: one capture stream and one graph memory pool.  The
        # stream comes from the high-priority pool, the TransferEngine's
        # from the default-priority one, so it is neither theirs nor the
        # default stream
        self.cuda_graphs = cuda_graphs and hmm.device.type == "cuda"
        self._stream = self._pool = None
        self._warm = False     # the capture stream has run every step
        if self.cuda_graphs:
            self._stream = torch.cuda.Stream(device=hmm.device, priority=-1)
            self._pool = torch.cuda.graph_pool_handle()

    def _key(self, cfg: ElasticConfig) -> Tuple:
        """This IMM's cache key of ``cfg``'s instance: the owner, then
        ``model_key``."""
        return (self.owner,) + self.model_key(cfg)

    def model_key(self, cfg: ElasticConfig) -> Tuple:
        """Everything that shapes an instance's step functions: the model,
        the compile-affecting knobs and the configuration."""
        hmm = self.hmm
        return (repr(self.mcfg),
                self.batch_per_replica, self.max_len,
                self.prefill_buckets, self.prefill_chunk,
                self.collect_routing,
                hmm.kv_mode, hmm.kv_block_size, hmm.kv_blocks_per_replica,
                hmm.expert_mode, hmm.expert_pool_pages,
                hmm.expert_slot_slack,
                hmm.kv_dtype, hmm.expert_dtype,
                cfg.dp, cfg.tp, cfg.devices)

    def has(self, cfg: ElasticConfig) -> bool:
        """True if a standby instance of this model and ``cfg`` is cached,
        built by this server or another one sharing the cache (the
        reference's ``compile_hit``; touches neither the LRU order nor the
        counters)."""
        key = self.model_key(cfg)
        return any(k[1:] == key for k in self._cache)

    def preinitialize(self, cfg: ElasticConfig, params=None, cache=None,
                      limit: Optional[int] = None) -> StandbyInstance:
        """Build (or fetch) a standby instance for ``cfg``: its step
        functions and, given ``params`` and ``cache``, its step set bound
        to exactly those tensors, capturing at most ``limit`` of its
        pending graphs (None: all of them)."""
        key = self._key(cfg)
        if key in self._cache:
            self._cache.move_to_end(key)
            inst = self._cache[key]
            if params is not None:
                self._bind(inst, params, cache, limit)
            return inst
        t0 = time.perf_counter()
        mesh = make_instance_mesh(cfg, self.hmm.all_devices)
        parallel = engine_parallel_ctx(mesh) if cfg.ndev > 1 else None
        compiled, _ = compile_step_functions(
            self.mcfg, max_len=self.max_len,
            prefill_buckets=self.prefill_buckets, kv_mode=self.hmm.kv_mode,
            prefill_chunk=self.prefill_chunk, parallel=parallel,
            collect_routing=self.collect_routing)
        dt = time.perf_counter() - t0
        inst = StandbyInstance(cfg, mesh, compiled, dt, parallel,
                               owner=self.owner)
        self._cache[key] = inst
        self.stats["compile_s_total"] += dt
        self._evict()
        if params is not None:
            self._bind(inst, params, cache, limit)
        return inst

    def _evict(self) -> None:
        """Drop least recently used instances past ``lru_capacity``: this
        server's any, another server's only if its engine does not serve
        on it."""
        while len(self._cache) > self.lru_capacity:
            old = next((k for k, inst in self._cache.items()
                        if inst.owner == self.owner or not inst.live), None)
            if old is None:
                return
            self._cache.pop(old).release()

    def release_all(self) -> None:
        """Drop the graph set of every instance of this server (a park):
        the step functions stay cached, and a fresh graph pool replaces
        the one whose graphs are all gone."""
        for inst in self._cache.values():
            if inst.owner == self.owner:
                inst.release()
                inst.live = False
        if self.cuda_graphs:
            self._pool = torch.cuda.graph_pool_handle()

    def release_standby(self) -> None:
        """Drop the graphs and the binding of every instance of this
        server that its engine does not serve on and whose set names a
        tensor the live set does not hold (a scale's freed source, an
        aborted target's staged tensors): such a set is never bound
        again, and it alone would keep that tensor allocated.  Another
        server's sets are left as they are."""
        mine = [i for i in self._cache.values() if i.owner == self.owner]
        live = {id(t) for i in mine if i.live and i.binding is not None
                for t in i.binding.tensors()}
        for inst in mine:
            if not inst.live and inst.binding is not None and any(
                    t is None or id(t) not in live
                    for t in inst.binding.tensors()):
                inst.release()

    def ready(self, cfg: ElasticConfig) -> bool:
        """True if ``cfg``'s instance is cached and holds a bound step set
        with every graph captured."""
        inst = self._cache.get(self._key(cfg))
        return (inst is not None and inst.binding is not None
                and (inst.graphs is None or not inst.graphs.pending))

    def _bind(self, inst: StandbyInstance, params, cache,
              limit: Optional[int] = None) -> bool:
        """Bind ``inst``'s step set to ``params`` and ``cache`` and, on the
        card, capture at most ``limit`` of its pending graphs (None: all).
        True if the set was already complete over exactly these tensors;
        else a set over other tensors is dropped for a fresh one, and
        False."""
        t0 = time.perf_counter()
        if inst.binding is None or not inst.binding.matches(params, cache):
            inst.release()      # a stale set's pool memory is reusable
            if self.cuda_graphs:
                devs = cuda_devices(inst.mesh.torch_device(d)
                                    for d in inst.cfg.devices)
                if len(devs) != 1:
                    raise NotImplementedError(
                        f"CUDA graphs of an instance on {len(devs)} cards "
                        f"are not ported (pass cuda_graphs=False)")
                hmm = self.hmm
                paged = hmm.kv_mode == "paged"
                inst.graphs = StepGraphs(
                    inst.compiled, params, cache,
                    slots=inst.cfg.dp * self.batch_per_replica,
                    max_len=self.max_len, paged=paged,
                    block_size=hmm.kv_block_size,
                    nb=hmm.kv_blocks_per_replica if paged else 0,
                    chunk=self.prefill_chunk,
                    # a chunked engine never runs its prefill buckets
                    buckets=(() if self.prefill_chunk
                             else self.prefill_buckets),
                    replicas=inst.cfg.dp,
                    device=devs[0], stream=self._stream, pool=self._pool,
                    warmup=not self._warm)
                self._warm = True
            inst.binding = Binding(params, cache)
            self.stats["captures"] += 1
        elif inst.graphs is None or not inst.graphs.pending:
            return True
        if inst.graphs is not None:
            try:
                inst.graphs.capture(limit)
            except BaseException:
                inst.release()
                raise
        dt = time.perf_counter() - t0
        inst.compile_s += dt
        self.stats["compile_s_total"] += dt
        return False

    def activate(self, cfg: ElasticConfig, staged: bool = False):
        """Attach a standby instance to the HMM's tensors: bind its step
        set if it was captured over exactly these, else capture it now.
        Returns (instance, params, cache, was_preinitialized)."""
        key = self._key(cfg)
        attached, _, params, cache = (self.hmm.attach_staged() if staged
                                      else self.hmm.attach_active())
        if self._key(attached) != key:
            raise RuntimeError(f"the HMM holds {attached.describe()}, not "
                               f"{cfg.describe()}")
        inst = self.preinitialize(cfg)
        hit = self._bind(inst, params, cache)
        self.stats["preinit_hits" if hit else "preinit_misses"] += 1
        inst.activations += 1
        for other in self._cache.values():
            if other.owner == self.owner:
                other.live = other is inst
        self.release_standby()
        return inst, params, cache, hit
