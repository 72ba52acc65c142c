"""Inference Management Module — the port of ``repro.core.imm`` (paper
§4.5), thin.

Keeps an LRU cache of *pre-initialized* inference instances.  In the paper
a standby instance is an inference process that has done every one-time
setup except binding weights; in the reference it is the AOT-compiled step
functions of an instance's (mesh, shapes).  The port's step functions are
eager PyTorch callables: a standby instance holds the dict of
``serving.engine.compile_step_functions`` for its configuration (bound to
its mesh's parallel context) and no weights, and ``activate`` binds it to
the HMM's live tensors — a metadata-only step.  ``ScaleEvent.compile_hit``
reports whether the target was already in the cache.  Capturing the step
functions as CUDA graphs, the counterpart of the reference's compile, is
left to a later slice.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.topology import ElasticConfig
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


class IMM:
    def __init__(self, mcfg, hmm, *, batch_per_replica: int, max_len: int,
                 prefill_buckets=(64,), prefill_chunk: int = 0,
                 lru_capacity: int = 4,
                 shared_cache: Optional[
                     "OrderedDict[Tuple, StandbyInstance]"] = None):
        self.mcfg = mcfg
        self.hmm = hmm
        self.batch_per_replica = batch_per_replica
        self.max_len = max_len
        self.prefill_buckets = tuple(prefill_buckets)
        self.prefill_chunk = prefill_chunk
        self.lru_capacity = lru_capacity
        # a fleet shares one LRU across its servers (the same OrderedDict
        # passed to every IMM); keys carry the model's identity
        self._cache: "OrderedDict[Tuple, StandbyInstance]" = (
            shared_cache if shared_cache is not None else OrderedDict())
        self.stats = {"preinit_hits": 0, "preinit_misses": 0,
                      "compile_s_total": 0.0}

    def _key(self, cfg: ElasticConfig) -> Tuple:
        """Everything that shapes an instance's step functions: the model,
        the compile-affecting knobs and the configuration."""
        hmm = self.hmm
        return (repr(self.mcfg),
                self.batch_per_replica, self.max_len,
                self.prefill_buckets, self.prefill_chunk,
                hmm.kv_mode, hmm.kv_block_size, hmm.kv_blocks_per_replica,
                hmm.expert_mode, hmm.expert_pool_pages,
                hmm.kv_dtype, hmm.expert_dtype,
                cfg.dp, cfg.tp, cfg.devices)

    def has(self, cfg: ElasticConfig) -> bool:
        """True if a standby instance for ``cfg`` is cached (touches
        neither the LRU order nor the counters)."""
        return self._key(cfg) in self._cache

    def preinitialize(self, cfg: ElasticConfig) -> StandbyInstance:
        """Build (or fetch) a standby instance for ``cfg``: its step
        functions, no weights."""
        key = self._key(cfg)
        if key in self._cache:
            self._cache.move_to_end(key)
            return self._cache[key]
        t0 = time.perf_counter()
        mesh = make_instance_mesh(cfg, self.hmm.all_devices)
        parallel = engine_parallel_ctx(mesh) if cfg.ndev > 1 else None
        compiled, _ = compile_step_functions(
            self.mcfg, max_len=self.max_len,
            prefill_buckets=self.prefill_buckets, kv_mode=self.hmm.kv_mode,
            prefill_chunk=self.prefill_chunk, parallel=parallel)
        dt = time.perf_counter() - t0
        inst = StandbyInstance(cfg, mesh, compiled, dt, parallel)
        self._cache[key] = inst
        self.stats["compile_s_total"] += dt
        while len(self._cache) > self.lru_capacity:
            self._cache.popitem(last=False)
        return inst

    def activate(self, cfg: ElasticConfig, staged: bool = False):
        """Attach a standby instance to the HMM's tensors.  Returns
        (instance, params, cache, was_preinitialized)."""
        key = self._key(cfg)
        hit = key in self._cache
        self.stats["preinit_hits" if hit else "preinit_misses"] += 1
        inst = self.preinitialize(cfg)
        inst.activations += 1
        attached, _, params, cache = (self.hmm.attach_staged() if staged
                                      else self.hmm.attach_active())
        if self._key(attached) != key:
            raise RuntimeError(f"the HMM holds {attached.describe()}, not "
                               f"{cfg.describe()}")
        return inst, params, cache, hit
