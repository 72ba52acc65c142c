"""HBM Management Module — the port of ``repro.core.hmm``: boot on one or
several logical devices, and the scale path (stage, commit, abort).

The HMM owns the model weights and the KV cache independently of the
serving instance.  Two expert stores (``expert_mode``): dense banks
``blocks/moe/{wi,wg,wo}`` ``[L, E, D, F|D]`` (the reference's default), or
a page *pool* per bank (``moe_pool/{wi,wg,wo}`` [pages, D, F|D]) addressed
through the ``ExpertPageTable``'s index arrays; both cover the ``L -
first_k_dense`` MoE layers.  Two KV layouts (``kv_mode``): the
slot-contiguous cache ``[L, B, max_len, KVH, hd]`` (the default; an MLA
model's latent ``{c: [L, B, max_len, r], kr: [L, B, max_len, dr]}``; a
Mamba2 model's per-slot ``{conv, state}`` and a hybrid's shared-attention
``{attn_k, attn_v}``), or a block pool ``[L, NB, bs, KVH, hd]`` with its
host-side ``KVBlockManager`` (standard attention only, as the reference
asserts).

``kv_dtype="int8"`` stores the KV pool as int8 entries with per-token f32
scale pools on the same block axis; ``expert_dtype="int8"`` stores the
expert banks as int8 pages with per-page f32 scale banks
(``moe_pool/{wi,wg,wo}_scale``) addressed by the same page table.  As in
the reference, they need the paged KV pool and the pooled store.

On one device the parameters and the cache are plain tensors.  On several
logical devices (``all_devices``, indexed by the configuration's device
ids) they are trees of ``distributed.sharding.ShardedTensor`` laid out as
the reference's ``param_shardings`` / ``cache_shardings`` lay them out:
TP splits over 'tp', experts (dense bank E axis, pool page axis, table
rows) over ('dp', 'tp') = EP, the rest replicated (``param_sharding``, one
leaf's rule); the cache splits its batch or block axis over 'dp'
(``cache_sharding``), so each TP rank of a replica holds a copy of its
slice.  A configuration whose TP split would cut a query or kv head
raises at boot (``models.model.check_tp_heads``): the model steps compute
head-aligned splits only.

``scale`` (``begin_scale`` + ``stage_increment``) stages the target's
weights while the old instance serves: a shard whose (index, logical
device) is unchanged is reused — the same tensor, zero-copy; a shard that
exists on another logical device is copied (``p2p``); dense expert banks
regroup page by page (``_assemble_rows``); the pooled store moves exactly
the min-move ``Migration`` list, one page at a time.  ``begin_scale``
allocates every staged destination and every new replica's zeroed KV
shard on the caller's (serving) thread, so the staging units only copy,
and the target's tensors exist — for its CUDA graphs to be captured over —
before they are filled (``staged_tensors``).  ``commit`` grows the live
cache (survivors' shards reused, the new replicas' shards made at
``begin_scale`` adopted) and swaps the page table; ``abort`` drops the
staged state.  The byte accounting
(``TransferStats``) follows the reference's field for field.  All of it
goes by logical id: two logical devices on one card are two devices, and a
move between them is a real copy.

Staging runs serially on the caller's thread (``staging="serial"``, one
unit per ``stage_increment``) or on the background ``TransferEngine``
(``staging="overlap"``: ``begin_scale`` submits every unit and
``poll_staging`` observes them; on the card each worker issues its copies
on a side CUDA stream, ``core/transfer.py``).  Both run the same
``_stage_unit`` calls, so their byte accounting is equal field by field.
Rebalancing and parking are later slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
import re
import threading
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.expert_pages import ExpertPageTable, pooled_layout
from repro_torch.core.topology import ElasticConfig
from repro_torch.device import logical_devices, resolve_device, torch_dtype
from repro_torch.distributed.sharding import (Mesh, NamedSharding,
                                              ShardedTensor, check_devices,
                                              index_shape, make_instance_mesh,
                                              tree_leaves_with_path,
                                              tree_map_with_path)
from repro_torch.kernels.quant import quantize_rows
from repro_torch.models.model import (check_mla_heads, check_tp_heads,
                                      dense_cache_supported, init_cache,
                                      init_expert_bank, init_paged_cache,
                                      init_params, paged_cache_supported)
from repro_torch.core.transfer import (TransferEngine, TransferOp,
                                      cuda_devices, ready_events)
from repro_torch.serving.kv_blocks import KVBlockManager


def not_ported(knob: str, value, default, where: str) -> None:
    """Refuse a knob of the reference outside the ported slices, naming
    the slice (ROADMAP §1) that will port it."""
    if value != default:
        raise NotImplementedError(
            f"{knob}={value!r} is not ported yet (only {default!r}): {where}")


SLICE_C = "Slice C, the closed loop (ROADMAP §1 item 3)"
TELEMETRY = "routing telemetry (ROADMAP §1 item 4)"
REBALANCE = "the rebalancer and host tier (ROADMAP §1 item 5)"


def _idx_key(index) -> tuple:
    return tuple((s.start, s.stop, s.step) for s in index)


@dataclasses.dataclass
class TransferStats:
    """Bytes a boot, scale or commit moved, as the reference counts them.
    The rebalancer's and the parking tier's fields stay 0 in the port."""
    zero_copy_bytes: int = 0
    p2p_bytes: int = 0
    local_bytes: int = 0
    init_bytes: int = 0
    zero_copy_count: int = 0
    p2p_count: int = 0
    wall_s: float = 0.0
    op_s: float = 0.0
    # expert-weight sub-accounting (included in the totals above)
    expert_p2p_bytes: int = 0
    expert_zero_copy_bytes: int = 0
    expert_local_bytes: int = 0
    expert_replica_bytes: int = 0
    expert_d2h_bytes: int = 0
    expert_h2d_bytes: int = 0
    d2h_bytes: int = 0
    h2d_bytes: int = 0

    #: the additive byte / count fields (timing fields excluded)
    BYTE_FIELDS = ("zero_copy_bytes", "p2p_bytes", "local_bytes",
                   "init_bytes", "zero_copy_count", "p2p_count",
                   "expert_p2p_bytes", "expert_zero_copy_bytes",
                   "expert_local_bytes", "expert_replica_bytes",
                   "expert_d2h_bytes", "expert_h2d_bytes",
                   "d2h_bytes", "h2d_bytes")

    def merge(self, o: "TransferStats"):
        for f in self.BYTE_FIELDS + ("wall_s", "op_s"):
            setattr(self, f, getattr(self, f) + getattr(o, f))


# --------------------------------------------------------- reshard-with-reuse

def _holders(arr: ShardedTensor) -> Dict[tuple, List[Tuple[int, Any]]]:
    """Shard index -> [(logical device, shard)] of ``arr``."""
    old: Dict[tuple, List[Tuple[int, Any]]] = {}
    for dev, index, data in arr.addressable_shards:
        old.setdefault(_idx_key(index), []).append((dev, data))
    return old


def reshard_destination(arr: ShardedTensor, new_sharding: NamedSharding,
                        expert_dim: Optional[int] = None) -> ShardedTensor:
    """``arr`` under ``new_sharding`` before anything is copied: each shard
    that already lives on the right logical device with the right index is
    that tensor; every other one is allocated here (uninitialised), for
    ``reshard_with_reuse`` to fill.  Raises where a shard has no source."""
    shape = arr.shape
    old = _holders(arr)
    mesh = new_sharding.mesh
    out = {}
    for dev, index in new_sharding.devices_indices_map(shape).items():
        same = [h for h in old.get(_idx_key(index), []) if h[0] == dev]
        if same:
            out[dev] = same[0][1]
        elif old.get(_idx_key(index)) or expert_dim is not None:
            out[dev] = torch.empty(index_shape(shape, index),
                                   dtype=arr.dtype,
                                   device=mesh.torch_device(dev))
        else:
            raise ValueError(f"no source for shard {_idx_key(index)} of "
                             f"{shape}")
    return ShardedTensor(shape, new_sharding, out)


def reshard_with_reuse(arr: ShardedTensor, new_sharding: NamedSharding,
                       stats: TransferStats, expert_dim: Optional[int],
                       dst: ShardedTensor) -> ShardedTensor:
    """Rebuild ``arr`` under ``new_sharding`` into ``dst``
    (``reshard_destination``'s), reusing each shard that already lives on
    the right logical device with the right index (the same tensor),
    copying one that lives on another logical device, and — with
    ``expert_dim`` — assembling a shard whose slice boundaries changed
    piece by piece along that dimension."""
    old = _holders(arr)
    for dev, index in new_sharding.devices_indices_map(arr.shape).items():
        holders = old.get(_idx_key(index), [])
        data = dst.shard(dev)
        if any(h[0] == dev for h in holders):
            stats.zero_copy_bytes += data.nbytes
            stats.zero_copy_count += 1
        elif holders:
            data.copy_(holders[0][1])
            stats.p2p_bytes += data.nbytes
            stats.p2p_count += 1
        else:
            _assemble_rows(arr, index, expert_dim, dev, data, stats)
    return dst


def _assemble_rows(arr: ShardedTensor, index, dim: int, dev: int,
                   out: torch.Tensor, stats: TransferStats) -> torch.Tensor:
    """Piecewise (per-page) assembly of one target shard along ``dim`` into
    ``out``: every old shard's overlap with the target slice is copied in,
    counted as local when that shard is on logical device ``dev`` and as
    p2p otherwise."""
    n = arr.shape[dim]
    lo, hi, _ = index[dim].indices(n)
    pieces = []
    for sdev, sindex, data in arr.addressable_shards:
        slo, shi, _ = sindex[dim].indices(n)
        olo, ohi = max(lo, slo), min(hi, shi)
        if olo >= ohi:
            continue
        sub = data.narrow(dim, olo - slo, ohi - olo)
        if sdev == dev:
            stats.local_bytes += sub.nbytes
        else:
            stats.p2p_bytes += sub.nbytes
            stats.p2p_count += 1
        pieces.append((olo, sub))
    if sum(p.shape[dim] for _, p in pieces) != hi - lo:
        raise ValueError(f"the old shards of {arr.shape} cover rows "
                         f"{lo}:{hi} of dim {dim} more or less than once")
    for olo, sub in pieces:
        out.narrow(dim, olo - lo, sub.shape[dim]).copy_(sub)
    return out


# ---------------------------------------------------------------------- HMM

class HMM:
    """Holds the weights and the KV cache of an instance on one or several
    logical devices, and stages and commits its scale events."""

    def __init__(self, mcfg, tp: int, *, batch_per_replica: int,
                 max_len: int, all_devices=None, seed: int = 0,
                 kv_mode: str = "dense", kv_block_size: int = 16,
                 kv_blocks_per_replica: Optional[int] = None,
                 expert_mode: str = "dense",
                 expert_pool_pages: Optional[int] = None,
                 expert_slot_slack: int = 0,
                 expert_host_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 expert_dtype: Optional[str] = None,
                 staging: str = "serial", transfer_workers: int = 4,
                 device="cuda"):
        if staging not in ("serial", "overlap"):
            raise ValueError(f"unknown staging {staging!r}")
        not_ported("expert_slot_slack", expert_slot_slack, 0, REBALANCE)
        not_ported("expert_host_pages", expert_host_pages, None, REBALANCE)
        if kv_mode not in ("dense", "paged"):
            raise ValueError(f"unknown kv_mode {kv_mode!r}")
        if expert_mode not in ("dense", "pooled"):
            raise ValueError(f"unknown expert_mode {expert_mode!r}")
        if expert_mode == "pooled" and not mcfg.is_moe:
            raise ValueError(f"{mcfg.name}: expert_mode='pooled' requires a "
                             f"MoE model")
        if not dense_cache_supported(mcfg):
            raise ValueError(f"{mcfg.name}: only standard-attention, "
                             f"MLA and Mamba2 decoders are ported")
        if kv_mode == "paged" and not paged_cache_supported(mcfg):
            raise ValueError(f"{mcfg.name} does not support the paged KV "
                             f"layout (MLA caches its latent per slot, "
                             f"Mamba2 its SSD state)")
        if kv_mode == "paged" and max_len % kv_block_size:
            raise ValueError("max_len must be a multiple of kv_block_size")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r} (None or "
                             f"'int8')")
        if expert_dtype not in (None, "int8"):
            raise ValueError(f"unsupported expert_dtype {expert_dtype!r} "
                             f"(None or 'int8')")
        # the int8 stores keep their scales per block and per page
        if kv_dtype is not None and kv_mode != "paged":
            raise ValueError("kv_dtype='int8' requires kv_mode='paged' "
                             "(block-wise scales)")
        if expert_dtype is not None and expert_mode != "pooled":
            raise ValueError("expert_dtype='int8' requires "
                             "expert_mode='pooled' (per-page scales)")
        self.kv_dtype = kv_dtype
        self.expert_dtype = expert_dtype
        self.device = resolve_device(device)
        # logical device id -> torch.device; several ids may name one card
        self.all_devices = logical_devices(all_devices, self.device)
        self.mcfg = mcfg
        self.tp = tp
        self.batch_per_replica = batch_per_replica
        self.max_len = max_len
        self.seed = seed
        # 'overlap': staging units run on the background TransferEngine
        # while the serving thread keeps ticking
        self.staging_mode = staging
        self.transfer_workers = transfer_workers
        self._transfer: Optional[TransferEngine] = None
        self.transfer_engine()      # its side streams, before any staging
        self._stage_lock = threading.Lock()
        self.kv_mode = kv_mode
        self.expert_mode = expert_mode
        self.kv_block_size = kv_block_size
        # dense-equivalent capacity by default; pressure experiments pass a
        # smaller pool to force preemption
        self.kv_blocks_per_replica = (
            kv_blocks_per_replica
            or batch_per_replica * (max_len // kv_block_size))
        # per-device pool pages, fixed at boot for the HMM's lifetime
        self.expert_pool_pages = expert_pool_pages
        self.page_table: Optional[ExpertPageTable] = None
        self.kv_blocks: Optional[KVBlockManager] = None
        self.active_cfg: Optional[ElasticConfig] = None
        self.params: Any = None
        self.cache: Any = None
        self.staged: Optional[Tuple] = None
        self.boot_s = 0.0
        self.last_stats: Optional[TransferStats] = None
        self.last_migrations: Optional[List] = None
        # begin_scale to commit or abort: (cfg, mesh, the staged parameter
        # tree, {cache leaf: {logical device: new zeroed KV shard}})
        self._scale_target: Optional[Tuple] = None
        self._reset_stage_session()

    @property
    def _n_moe_layers(self) -> int:
        return self.mcfg.num_layers - self.mcfg.first_k_dense

    def expert_page_nbytes(self) -> int:
        """Bytes of ONE (layer, expert) page across all three banks; int8
        pages count their entries plus the three per-page f32 scales that
        travel with them."""
        bpe = torch_dtype(self.expert_dtype or self.mcfg.dtype).itemsize
        scale = 3 * 4 if self.expert_dtype is not None else 0
        return 3 * self.mcfg.d_model * self.mcfg.moe_d_ff * bpe + scale

    # ----------------------------------------------------------- shardings
    def param_sharding(self, path: str, shape, mesh: Mesh) -> NamedSharding:
        """TP over 'tp'; experts over ('dp','tp') = EP; the rest replicated
        over 'dp' (attention replicas) — the reference's rules."""
        stacked = 1 if ("blocks/" in path or "cross_blocks/" in path) else 0
        ntp = mesh.tp
        nep = mesh.dp * mesh.tp
        s: List[Any] = [None] * len(shape)
        ep = ("dp", "tp")
        if re.search(r"moe/w[igo]$", path):
            if shape[stacked] % nep == 0:
                s[stacked] = ep
        elif re.search(r"moe_pool/w[igo](_scale)?$", path):
            if shape[0] % nep == 0:
                s[0] = ep
        elif re.search(r"moe/tables$", path):
            if shape[stacked] % nep == 0:
                s[stacked] = ep
        elif not re.search(r"moe/(edest|eslot|gtable)$", path):
            rules = [
                (r"attn/q/w$|attn/q_up/w$|xattn/q/w$", stacked + 1),
                (r"attn/(k|v)/w$|xattn/(k|v)/w$", stacked + 1),
                (r"attn/o/w$|xattn/o/w$", stacked + 0),
                (r"attn/(k|v)_up/w$", stacked + 1),
                (r"(mlp|shared)/(up|gate)/w$", stacked + 1),
                (r"(mlp|shared)/down/w$", stacked + 0),
                (r"lm_head/w$", 1),
                (r"embed$", 0),
            ]
            for pat, dim in rules:
                if re.search(pat, path) and dim < len(shape) \
                        and shape[dim] % ntp == 0 and shape[dim] >= ntp:
                    s[dim] = "tp"
                    break
        return NamedSharding(mesh, tuple(s))

    @staticmethod
    def cache_sharding(shape, mesh: Mesh) -> NamedSharding:
        """[L, B or NB, ...]: the batch or block axis over 'dp'."""
        s: List[Any] = [None] * len(shape)
        if len(shape) >= 2 and shape[1] % mesh.dp == 0:
            s[1] = "dp"
        return NamedSharding(mesh, tuple(s))

    def _cache_template(self, cfg: ElasticConfig) -> Dict[str, Tuple]:
        """name -> (shape, dtype) of ``cfg``'s cache (nothing allocated)."""
        cache = self.make_cache(cfg, device="meta")
        return {k: (tuple(v.shape), v.dtype) for k, v in cache.items()}

    def make_cache(self, cfg: ElasticConfig, device=None):
        """Freshly zeroed decode cache for ``cfg`` on ``device`` (dense rows
        or the paged block pool, per ``kv_mode``)."""
        device = self.device if device is None else device
        if self.kv_mode == "paged":
            return init_paged_cache(
                self.mcfg, cfg.dp * self.kv_blocks_per_replica,
                self.kv_block_size, device=device, kv_dtype=self.kv_dtype)
        return init_cache(self.mcfg, cfg.dp * self.batch_per_replica,
                          self.max_len, device=device)

    def _sharded_cache(self, cfg: ElasticConfig, mesh: Mesh):
        """``cfg``'s cache as zeroed shards, made on each device."""
        out = {}
        for name, (shape, dtype) in self._cache_template(cfg).items():
            sh = self.cache_sharding(shape, mesh)
            out[name] = ShardedTensor(shape, sh, {
                d: torch.zeros(index_shape(shape, idx), dtype=dtype,
                               device=mesh.torch_device(d))
                for d, idx in sh.devices_indices_map(shape).items()})
        return out

    def _pooled_index_arrays(self, table, cfg: ElasticConfig):
        return pooled_layout(table, cfg, self._n_moe_layers,
                             self.mcfg.num_experts, self.expert_pool_pages)

    # ----------------------------------------------------------------- boot
    @obs.traced("hmm.boot", cat="hmm")
    def boot(self, cfg: ElasticConfig, params=None) -> float:
        """First boot: draw the parameters on the devices (or take
        ``params``, the reference's converted global parameters in this
        HMM's expert layout — ``convert.params_from_jax`` — and shard
        them), fill the expert store, and create the KV cache (and, paged,
        its block manager).  Returns the seconds it took."""
        check_devices(cfg, self.all_devices)
        if cfg.tp != self.tp:
            raise ValueError(f"{cfg.describe()}: the HMM was built for "
                             f"tp={self.tp}")
        check_tp_heads(self.mcfg, cfg.tp)
        check_mla_heads(self.mcfg, cfg.tp,
                        [self.all_devices[d] for d in cfg.devices])
        t0 = time.perf_counter()
        layout = None
        if self.mcfg.is_moe:
            L, E = self._n_moe_layers, self.mcfg.num_experts
            pooled = self.expert_mode == "pooled"
            if pooled and self.expert_pool_pages is None:
                # room for staging (active + migrated-in pages) and for
                # scaling down to half the boot device count
                self.expert_pool_pages = min(
                    2 * L * math.ceil(E / cfg.ndev), L * E)
            self.page_table = ExpertPageTable(
                L, E, pool_pages_per_device=(self.expert_pool_pages
                                             if pooled else 0))
            self.page_table.initial_place(cfg)
            if pooled:
                layout = self._pooled_index_arrays(self.page_table.active,
                                                   cfg)
        if cfg.ndev == 1:
            self._boot_one(cfg, params, layout)
        else:
            mesh = make_instance_mesh(cfg, self.all_devices)
            self.params = (self._init_sharded_params(cfg, mesh, layout)
                           if params is None
                           else self._adopt_sharded(params, mesh, layout))
            self.cache = self._sharded_cache(cfg, mesh)
        if self.kv_mode == "paged":
            self.kv_blocks = KVBlockManager(cfg.dp,
                                            self.kv_blocks_per_replica,
                                            self.kv_block_size)
        self.active_cfg = cfg
        self.boot_s = time.perf_counter() - t0
        self.last_stats = TransferStats(wall_s=self.boot_s)
        return self.boot_s

    def _boot_one(self, cfg: ElasticConfig, params, layout):
        """One device: plain tensors on it."""
        self.device = self.all_devices[cfg.devices[0]]
        if self.expert_mode == "pooled":
            params = (self._init_pooled_params(cfg, layout) if params is None
                      else self._adopt(params, layout))
        else:
            params = (self._init_dense_params() if params is None
                      else self._adopt(params))
        self.params = params
        self.cache = self.make_cache(cfg)

    def _expert_banks(self, dev):
        """Yield each MoE layer's freshly drawn routed expert bank
        ``(l, {wi, wg, wo})`` on ``dev``, from one generator seeded with
        ``seed + 1``: every store and device count holds the same
        numbers."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed + 1)
        for l in range(self._n_moe_layers):
            yield l, init_expert_bank(self.mcfg, gen,
                                      torch_dtype(self.mcfg.dtype), dev)

    def _bank_shapes(self):
        D, Fd = self.mcfg.d_model, self.mcfg.moe_d_ff
        return {"wi": (D, Fd), "wg": (D, Fd), "wo": (Fd, D)}

    def _init_dense_params(self):
        """Random parameters with dense expert banks ``blocks/moe/{wi, wg,
        wo}`` [L, E, D, F|D], filled one layer at a time, so the banks (58
        GB at full size) are never held twice."""
        mcfg, dev = self.mcfg, self.device
        params = init_params(mcfg, self.seed, device=dev)
        if not mcfg.is_moe:
            return params
        L, E = self._n_moe_layers, mcfg.num_experts
        dtype = torch_dtype(mcfg.dtype)
        moe = params["blocks"]["moe"]
        for k, shape in self._bank_shapes().items():
            moe[k] = torch.empty((L, E, *shape), dtype=dtype, device=dev)
        for l, bank in self._expert_banks(dev):
            for k in ("wi", "wg", "wo"):
                moe[k][l] = bank.pop(k)
            del bank
        return params

    def _pool_banks(self, rows: int, dev):
        """Zeroed page pools of ``rows`` pages (and, int8, their scale
        banks) on ``dev``."""
        quant = self.expert_dtype is not None
        pdt = torch.int8 if quant else torch_dtype(self.mcfg.dtype)
        pool = {k: torch.zeros((rows, *shape), dtype=pdt, device=dev)
                for k, shape in self._bank_shapes().items()}
        if quant:
            for k in list(pool):
                pool[k + "_scale"] = torch.zeros((rows,), dtype=torch.float32,
                                                 device=dev)
        return pool

    def _write_pages(self, pool, bank, pages, experts=None):
        """Write ``bank``'s experts ``experts`` (all by default) into pool
        rows ``pages`` (int8: quantized on the device, one scale per
        page)."""
        dev = pool["wi"].device
        pages = pages.to(dev)
        for k in self._bank_shapes():
            w = bank.pop(k)
            if experts is not None:
                w = w[experts]
            if self.expert_dtype is not None:
                q, sc = quantize_rows(w, (-2, -1))
                pool[k][pages] = q.to(dev)
                pool[k + "_scale"][pages] = sc.to(dev)
            else:
                pool[k][pages] = w.to(dev)

    def _init_pooled_params(self, cfg: ElasticConfig, layout):
        """Random parameters with the experts written layer by layer
        straight into their ``initial_place`` pages: the dense banks are
        never held beside the pool (at full size that would be the 58 GB
        of expert weights twice)."""
        mcfg, dev = self.mcfg, self.device
        params = init_params(mcfg, self.seed, device=dev)
        pool = self._pool_banks(cfg.ndev * self.expert_pool_pages, dev)
        for l, bank in self._expert_banks(dev):
            pages = torch.from_numpy(layout["gtable"][l].astype(np.int64)
                                     ).to(dev)
            self._write_pages(pool, bank, pages)
        params["blocks"]["moe"].update(
            {k: torch.from_numpy(v).to(dev) for k, v in layout.items()})
        params["moe_pool"] = pool
        return params

    def _check_layout(self, params, layout) -> None:
        """Given parameters must be in this HMM's expert layout: dense
        banks (``layout`` None), or the pooled store whose page tables are
        this HMM's placement and whose pages are of its store dtype."""
        moe = params["blocks"].get("moe", {})
        if layout is None:
            if "moe_pool" in params or (self.mcfg.is_moe
                                        and "wi" not in moe):
                raise ValueError("params must hold dense expert banks "
                                 "(blocks/moe/wi, wg, wo) for "
                                 "expert_mode='dense'")
            return
        if "moe_pool" not in params or "gtable" not in moe:
            raise ValueError("params must be in the pooled layout "
                             "(moe_pool + blocks/moe/gtable)")
        got = moe["gtable"].cpu().numpy()
        if not np.array_equal(got, layout["gtable"]):
            raise ValueError("params' page tables differ from the "
                             "initial placement of this configuration")
        pool = params["moe_pool"]
        quant = self.expert_dtype is not None
        if (pool["wi"].dtype == torch.int8) != quant \
                or ("wi_scale" in pool) != quant:
            raise ValueError(f"params' expert pool ({pool['wi'].dtype}, "
                             f"scales: {'wi_scale' in pool}) does not "
                             f"match expert_dtype={self.expert_dtype!r}")

    def _adopt(self, params, layout=None):
        """Move given parameters to the device, checking their layout."""
        self._check_layout(params, layout)
        return tree_map_with_path(
            lambda _, t: t.to(self.device).contiguous(), params)

    def _init_sharded_params(self, cfg: ElasticConfig, mesh: Mesh, layout):
        """Random parameters over several logical devices: the non-expert
        leaves drawn once on the first device and sharded (that device
        keeps the whole-tensor shards it drew), the experts drawn layer by
        layer there and written into each device's shard — the same
        numbers as a one-device boot."""
        first = cfg.devices[0]
        dev0 = mesh.torch_device(first)
        params = init_params(self.mcfg, self.seed, device=dev0)
        if layout is not None:
            params["blocks"]["moe"].update(
                {k: torch.from_numpy(v) for k, v in layout.items()})
        out = tree_map_with_path(
            lambda path, t: ShardedTensor.from_tensor(
                t.to(dev0), self.param_sharding(path, t.shape, mesh),
                keep_on=first),
            params)
        if not self.mcfg.is_moe:
            return out
        L, E = self._n_moe_layers, self.mcfg.num_experts
        if layout is not None:
            ppd = self.expert_pool_pages
            pools = {d: self._pool_banks(ppd, mesh.torch_device(d))
                     for d in cfg.devices}
            owned = defaultdict(list)       # (layer, device) -> [(page, e)]
            for (l, e), ref in self.page_table.active.items():
                owned[(l, ref.device)].append((ref.page, e))
            for l, bank in self._expert_banks(dev0):
                for d in cfg.devices:
                    if not owned[(l, d)]:
                        continue            # more devices than experts
                    pages, experts = zip(*owned[(l, d)])
                    self._write_pages(pools[d], dict(bank),
                                      torch.tensor(pages),
                                      torch.tensor(experts, device=dev0))
                del bank
            out["moe_pool"] = {}
            for k in pools[first]:
                shape = (cfg.ndev * ppd,) + tuple(pools[first][k].shape[1:])
                out["moe_pool"][k] = ShardedTensor(
                    shape, self.param_sharding(f"moe_pool/{k}", shape, mesh),
                    {d: pools[d][k] for d in cfg.devices})
            return out
        dtype = torch_dtype(self.mcfg.dtype)
        moe = out["blocks"]["moe"]
        for k, shape in self._bank_shapes().items():
            full = (L, E) + shape
            sh = self.param_sharding(f"blocks/moe/{k}", full, mesh)
            moe[k] = ShardedTensor(full, sh, {
                d: torch.empty(index_shape(full, idx), dtype=dtype,
                               device=mesh.torch_device(d))
                for d, idx in sh.devices_indices_map(full).items()})
        for l, bank in self._expert_banks(dev0):
            for k in self._bank_shapes():
                for d, idx, shard in moe[k].addressable_shards:
                    shard[l] = bank[k][idx[1]]
            del bank
        return out

    def _adopt_sharded(self, params, mesh: Mesh, layout):
        """Shard given global parameters over the logical devices, each
        device taking a copy of its pieces."""
        self._check_layout(params, layout)
        return tree_map_with_path(
            lambda path, t: ShardedTensor.from_tensor(
                t, self.param_sharding(path, t.shape, mesh)),
            params)

    # ---------------------------------------------------------------- scale
    def scale(self, new_cfg: ElasticConfig) -> TransferStats:
        """Stage ``new_cfg``'s weights while the old instance keeps serving
        (``begin_scale``, then ``stage_increment`` to the end, or
        ``join_staging`` when overlapped).  The KV cache grows at
        ``commit``.  Returns the staging's stats."""
        self.begin_scale(new_cfg)
        if self.staging_mode == "overlap":
            self.join_staging()
        else:
            while self.stage_increment():
                pass
        return self.last_stats

    @obs.traced("hmm.begin_scale", cat="hmm")
    def begin_scale(self, new_cfg: ElasticConfig) -> int:
        """Open a staging session toward ``new_cfg`` (one work unit per
        parameter leaf) and return the number of units.  Serial: nothing
        moves yet, ``stage_increment`` runs the units.  Overlap: every unit
        is submitted to the background ``TransferEngine`` now; drive it
        with ``poll_staging`` (or block on ``join_staging``).  The pooled
        store stages its page remap here (``stage_remap(min_move=True)``),
        so each pool bank's unit moves exactly the ``Migration`` list."""
        if self.active_cfg is None:
            raise RuntimeError("boot() the HMM before scaling it")
        if self._stage_work is not None:
            raise RuntimeError("staging already in progress")
        if new_cfg.tp != self.tp:
            raise ValueError("TP is fixed during scaling (§4.1)")
        if self.active_cfg.ndev == 1 or new_cfg.ndev == 1:
            raise NotImplementedError(
                "scaling from or to one device is not ported yet (boot on "
                "two or more logical devices)")
        t0 = time.perf_counter()
        mesh = make_instance_mesh(new_cfg, self.all_devices)
        if self.expert_mode == "pooled":
            self.last_migrations = self.page_table.stage_remap(
                new_cfg, min_move=True)
            self._stage_layout = self._pooled_index_arrays(
                self.page_table.staged, new_cfg)
        work = []
        dst = {}
        for path, leaf in tree_leaves_with_path(self.params):
            sh = self.param_sharding(path, leaf.shape, mesh)
            kind, expert_dim = "reshard", None
            if re.search(r"moe/w[igo]$", path):
                # dense banks regroup at page granularity
                expert_dim = 1 if "blocks/" in path else 0
                kind = "expert_bank"
            elif re.search(r"moe_pool/(w[igo](?:_scale)?)$", path):
                kind = "pool:" + path.rsplit("/", 1)[1]
            elif re.search(r"moe/(tables|edest|eslot|gtable)$", path):
                kind = "index:" + path.rsplit("/", 1)[1]
            # every destination is made here, on the caller's thread
            dst[path] = self._stage_destination(leaf, sh, expert_dim, kind,
                                                new_cfg, mesh)
            work.append((path, leaf, sh, expert_dim, kind, dst[path]))
        self._stage_work = work
        self._stage_cursor = 0
        self._scale_target = (
            new_cfg, mesh,
            tree_map_with_path(lambda path, _: dst[path], self.params),
            self._new_kv_shards(new_cfg, mesh))
        self._stage_stats = TransferStats(wall_s=time.perf_counter() - t0)
        if self.staging_mode == "overlap":
            self._stage_t0 = t0
            devs = cuda_devices(self.all_devices[d] for d in
                                set(self.active_cfg.devices)
                                | set(new_cfg.devices))
            ops = [TransferOp(index=i, label=unit[0], devices=devs,
                              fn=self._make_stage_op(unit[1:], new_cfg,
                                                     mesh))
                   for i, unit in enumerate(work)]
            # the side streams wait for everything the serving thread has
            # issued so far (the boot's writes included) before they read
            self._stage_session = self.transfer_engine().submit(
                ops, after=ready_events(devs))
        return len(work)

    def transfer_engine(self) -> TransferEngine:
        """The HMM's background TransferEngine (made with the HMM, and
        again after ``close``; kept across scale events): overlapped
        staging's units and, in every staging mode, a scale-down's live KV
        block copies ride it."""
        if self._transfer is None:
            self._transfer = TransferEngine(self.transfer_workers,
                                            devices=self.all_devices)
        return self._transfer

    def close(self) -> None:
        """Stop the TransferEngine's worker threads (after any session)."""
        if self._transfer is not None:
            self._transfer.shutdown()
            self._transfer = None

    @property
    def staging_remaining(self) -> int:
        if self._stage_work is None:
            return 0
        if self._stage_session is not None:
            return self._stage_session.remaining()
        return len(self._stage_work) - self._stage_cursor

    @property
    def staging_in_flight(self) -> bool:
        """True while an overlapped session has ops pending or running."""
        return (self._stage_session is not None
                and not self._stage_session.finished())

    def _make_stage_op(self, unit, new_cfg: ElasticConfig, mesh: Mesh):
        """One background op: ``_stage_unit`` into a private TransferStats,
        merged into the session's under the lock (addition commutes, so the
        totals equal the serial order's).  The op's time (to its copies'
        landing) is added to ``op_s`` when the session completes."""
        session_stats = self._stage_stats
        leaf, sh, expert_dim, kind, dst = unit

        def run():
            sub = TransferStats()
            out = self._stage_unit(leaf, sh, expert_dim, kind, new_cfg,
                                   mesh, sub, dst)
            with self._stage_lock:
                session_stats.merge(sub)
            return out

        return run

    def _stage_destination(self, leaf, sh, expert_dim, kind,
                           new_cfg: ElasticConfig, mesh: Mesh
                           ) -> ShardedTensor:
        """A staging unit's staged leaf, allocated (not filled) on the
        caller's thread: a reused shard is the live tensor, a copied or
        assembled one is new, a pool bank's new device slice is zeroed;
        the index arrays are uploaded whole (no weight bytes)."""
        if kind.startswith("pool:"):
            ppd = self.expert_pool_pages
            shape = (new_cfg.ndev * ppd,) + tuple(leaf.shape[1:])
            sharding = NamedSharding(mesh, (("dp", "tp"),))
            return ShardedTensor(shape, sharding, {
                dev: (leaf.shards[dev] if dev in leaf.shards
                      else torch.zeros((ppd, *leaf.shape[1:]),
                                       dtype=leaf.dtype,
                                       device=mesh.torch_device(dev)))
                for dev in new_cfg.devices})
        if kind.startswith("index:"):
            name = kind.split(":", 1)[1]
            arr = _upload(np.asarray(self._stage_layout[name], np.int32),
                          mesh.torch_device(new_cfg.devices[0]))
            spec = (None, ("dp", "tp"), None) if name == "tables" else ()
            return ShardedTensor.from_tensor(arr, NamedSharding(mesh, spec))
        return reshard_destination(leaf, sh, expert_dim)

    def _stage_unit(self, leaf, sh, expert_dim, kind, new_cfg: ElasticConfig,
                    mesh: Mesh, stats: TransferStats, dst: ShardedTensor):
        """Execute ONE unit of staging work: copy into ``dst``, the staged
        leaf ``_stage_destination`` made, return it, and add its bytes to
        ``stats``."""
        if kind.startswith("pool:"):
            return self._migrate_pool_bank(leaf, new_cfg, stats, dst)
        if kind.startswith("index:"):
            return dst          # uploaded in begin_scale; no weight bytes
        if kind == "expert_bank":
            # track the expert sub-bytes, so that the dense regroup and the
            # pooled remap compare directly
            sub = TransferStats()
            reshard_with_reuse(leaf, sh, sub, expert_dim, dst)
            sub.expert_p2p_bytes = sub.p2p_bytes
            sub.expert_zero_copy_bytes = sub.zero_copy_bytes
            sub.expert_local_bytes = sub.local_bytes
            stats.merge(sub)
            return dst
        return reshard_with_reuse(leaf, sh, stats, expert_dim, dst)

    @obs.traced("hmm.stage_increment", cat="hmm")
    def stage_increment(self, max_tensors: int = 1) -> bool:
        """Stage up to ``max_tensors`` parameter leaves toward the target
        opened by ``begin_scale``.  Safe between serving ticks: staging
        only reads the live weights (a pool bank's migrated-in pages land
        in pages the active table leaves free), and the KV cache is not
        touched until ``commit``.  Returns True while units remain; the
        last one assembles the staged tree, after which ``attach_staged``
        and ``commit`` are legal.  An overlapped session is driven with
        ``poll_staging`` / ``join_staging`` instead."""
        if self._stage_work is None:
            raise RuntimeError("no staging session open")
        if self._stage_session is not None:
            raise RuntimeError(
                "the staging session is overlapped (background "
                "TransferEngine); drive it with poll_staging() or "
                "join_staging(), not stage_increment()")
        t0 = time.perf_counter()
        stats = self._stage_stats
        new_cfg, mesh = self._scale_target[:2]
        end = min(self._stage_cursor + max(1, max_tensors),
                  len(self._stage_work))
        for _, *unit in self._stage_work[self._stage_cursor:end]:
            u0 = time.perf_counter()
            self._stage_unit(*unit[:4], new_cfg, mesh, stats, unit[4])
            stats.op_s += time.perf_counter() - u0
        self._stage_cursor = end
        stats.wall_s += time.perf_counter() - t0
        if self._stage_cursor < len(self._stage_work):
            return True
        self._finalize_staging()
        return False

    def poll_staging(self) -> bool:
        """Overlap: a bounded completion poll (at most about 2 ms).  True
        once every op has landed and the staged tree is assembled
        (``attach_staged`` and ``commit`` legal); False while ops are in
        flight.  A failed op aborts the whole session and re-raises.

        The poll waits a little rather than returning at once: a serve loop
        spinning on an idle engine is pure Python and would otherwise keep
        the interpreter from the worker threads."""
        if self._stage_work is None:
            return self.staged is not None
        if self._stage_session is None:
            raise RuntimeError(
                "the staging session is serial; drive it with "
                "stage_increment()")
        sess = self._stage_session
        if not sess.finished():
            sess.join(timeout=0.002)    # bounded yield to the workers
            if not sess.finished():
                return False
        failed = sess.failed_ops()
        if failed:
            err = failed[0].error
            self.abort()
            raise RuntimeError(
                f"staging transfer op {failed[0].label!r} failed "
                f"({len(failed)} op(s)); session aborted") from err
        # the staging window: begin_scale to the last op's landing; op_s
        # the sum of the ops' own times, for the overlap efficiency
        stats = self._stage_stats
        stats.op_s += sess.op_seconds
        stats.wall_s = max(sess.last_done_t - self._stage_t0, stats.wall_s)
        self._finalize_staging()
        return True

    def join_staging(self) -> bool:
        """Overlap: block until the session completes, then finalize (the
        committing barrier).  True if a staged tree is ready."""
        if self._stage_work is None:
            return self.staged is not None
        if self._stage_session is None:
            raise RuntimeError(
                "the staging session is serial; drive it with "
                "stage_increment()")
        self._stage_session.join()
        return self.poll_staging()

    def _finalize_staging(self):
        """The staged tree (``begin_scale``'s destinations, now filled) is
        ready; the dense banks record the contiguous placement they now
        hold as the staged page table (the pooled store staged its
        min-move remap in ``begin_scale``)."""
        t0 = time.perf_counter()
        stats = self._stage_stats
        new_cfg, mesh, new_params, _ = self._scale_target
        if self._stage_session is not None:
            # the default streams read what the side streams wrote
            for op in self._stage_session.ops:
                for dev, ev in op.events.items():
                    torch.cuda.current_stream(dev).wait_event(ev)
        if self.page_table is not None and self.page_table.staged is None:
            self.page_table.stage_remap(new_cfg, min_move=False)
        self.staged = (new_cfg, mesh, new_params)
        stats.wall_s += time.perf_counter() - t0
        self.last_stats = stats
        self._reset_stage_session()

    def _migrate_pool_bank(self, leaf: ShardedTensor, new_cfg: ElasticConfig,
                           stats: TransferStats, dst: ShardedTensor
                           ) -> ShardedTensor:
        """Rebuild one pooled bank for ``new_cfg`` into ``dst``: every
        surviving device's pool slice is reused, new devices start from
        zeros, and exactly the staged ``Migration`` list is copied, one
        page per copy between logical devices.  A migrated-in page is written into its
        destination slice in place: its page is one the active table
        leaves free, so the serving instance never reads it (the
        reference's immutable arrays take a new buffer instead)."""
        row_shape = leaf.shape[1:]
        row_bytes = math.prod(row_shape) * leaf.dtype.itemsize
        migs_by_dst: Dict[int, List] = defaultdict(list)
        for m in self.last_migrations:
            migs_by_dst[m.dst.device].append(m)
        # pages that stay put are this bank's zero-copy reuse
        staged, active = self.page_table.staged, self.page_table.active
        unchanged = sum(1 for k, r in active.items() if staged.get(k) == r)
        stats.zero_copy_bytes += unchanged * row_bytes
        stats.zero_copy_count += unchanged
        stats.expert_zero_copy_bytes += unchanged * row_bytes

        for dev in new_cfg.devices:
            local = dst.shard(dev)
            for m in migs_by_dst.get(dev, ()):
                local[m.dst.page].copy_(leaf.shards[m.src.device][m.src.page])
                stats.p2p_bytes += row_bytes
                stats.p2p_count += 1
                stats.expert_p2p_bytes += row_bytes
        return dst

    def _reset_stage_session(self):
        self._stage_session = None          # overlap only
        self._stage_t0 = 0.0
        self._stage_work: Optional[List[Tuple]] = None
        self._stage_cursor = 0
        self._stage_stats: Optional[TransferStats] = None
        self._stage_layout: Optional[Dict[str, np.ndarray]] = None

    def _new_kv_shards(self, new_cfg: ElasticConfig, mesh: Mesh
                       ) -> Dict[str, Dict[int, torch.Tensor]]:
        """The zeroed KV shards of ``new_cfg``'s cache that no live shard
        provides: each (index, logical device) of its sharding that the
        active configuration's sharding does not hold (a new replica's
        slice, each TP rank's copy)."""
        old_mesh = make_instance_mesh(self.active_cfg, self.all_devices)
        old_tpl = self._cache_template(self.active_cfg)
        out: Dict[str, Dict[int, torch.Tensor]] = {}
        for name, (shape, dtype) in self._cache_template(new_cfg).items():
            old_shape = old_tpl[name][0]
            held = {(d, _idx_key(i)) for d, i in self.cache_sharding(
                old_shape, old_mesh).devices_indices_map(old_shape).items()}
            out[name] = {
                dev: torch.zeros(index_shape(shape, index), dtype=dtype,
                                 device=mesh.torch_device(dev))
                for dev, index in self.cache_sharding(
                    shape, mesh).devices_indices_map(shape).items()
                if (dev, _idx_key(index)) not in held}
        return out

    def _target_cache(self, live_cache, new_cfg: ElasticConfig, mesh: Mesh,
                      new_kv, stats: TransferStats):
        """``new_cfg``'s cache: the surviving replicas' shards of
        ``live_cache`` as they are, the new replicas' from ``new_kv``
        (``_new_kv_shards``).  Dense rows split the batch axis, the paged
        pool the block axis: either way a surviving shard keeps its (index,
        logical device) and is adopted as it is — every live block table
        stays valid."""
        out = {}
        for name, (shape, _) in self._cache_template(new_cfg).items():
            old = _holders(live_cache[name])
            sh = self.cache_sharding(shape, mesh)
            shards = {}
            for dev, index in sh.devices_indices_map(shape).items():
                if dev in new_kv[name]:
                    data = new_kv[name][dev]
                    stats.init_bytes += data.nbytes
                else:
                    data = next(t for d, t in old[_idx_key(index)]
                                if d == dev)
                    stats.zero_copy_bytes += data.nbytes
                    stats.zero_copy_count += 1
                shards[dev] = data
            out[name] = ShardedTensor(shape, sh, shards)
        return out

    # --------------------------------------------------------------- attach
    def staged_tensors(self, live_cache):
        """The scale target's (cfg, mesh, params, cache) from
        ``begin_scale`` until ``commit`` or ``abort``: the staged tree (its
        copies may still be in flight) and the cache ``commit`` adopts —
        ``live_cache``'s surviving shards and the new replicas' zeroed
        ones.  Nothing may read them before the staging has landed; a CUDA
        graph may be captured over them."""
        if self._scale_target is None:
            raise RuntimeError("no scale is staging")
        new_cfg, mesh, params, new_kv = self._scale_target
        return (new_cfg, mesh, params,
                self._target_cache(live_cache, new_cfg, mesh, new_kv,
                                   TransferStats()))

    def attach_staged(self):
        """The staged instance's handles: (cfg, mesh, params, cache)."""
        if self.staged is None:
            raise RuntimeError("nothing is staged")
        new_cfg, mesh, params = self.staged
        return new_cfg, mesh, params, self.cache

    def attach_active(self):
        return (self.active_cfg,
                make_instance_mesh(self.active_cfg, self.all_devices),
                self.params, self.cache)

    @obs.traced("hmm.commit", cat="hmm")
    def commit(self, live_cache=None) -> TransferStats:
        """Switchover: the staged weights become active, and the live KV
        cache (``live_cache``, the engine's; surviving replicas' shards
        reused as they are, new replicas zeroed) takes the new replica
        count.  Shrinking the block pool needs the evicted partitions
        free.  Old-only buffers become unreferenced (the paper's deferred
        FREE)."""
        if self._stage_session is not None:
            self.join_staging()         # committing is a barrier
        if self.staged is None:
            raise RuntimeError("nothing is staged: begin_scale and "
                               "stage_increment first")
        new_cfg, mesh, params = self.staged
        stats = TransferStats()
        t0 = time.perf_counter()
        if live_cache is not None:
            self.cache = live_cache
        self.cache = self._target_cache(self.cache, new_cfg, mesh,
                                        self._scale_target[3], stats)
        self._scale_target = None
        if self.kv_blocks is not None:
            if new_cfg.dp >= self.kv_blocks.num_partitions:
                self.kv_blocks.grow_partitions(new_cfg.dp)
            else:
                self.kv_blocks.shrink_partitions(new_cfg.dp)
        self.active_cfg = new_cfg
        self.params = params
        self.staged = None
        if self.page_table is not None and self.page_table.staged is not None:
            self.page_table.commit()
        stats.wall_s = time.perf_counter() - t0
        if self.last_stats is not None:
            self.last_stats.merge(stats)
        return stats

    @obs.traced("hmm.abort", cat="hmm")
    def abort(self):
        """Abandon any staged state, also a session with ops in flight:
        cancel-or-join first (pending ops never start, running ones land),
        then unwind the page table, so no worker sees the unwound table.
        Idempotent; frees every staged-only page exactly once
        (``ExpertPageTable.abort``)."""
        if self._stage_session is not None:
            self._stage_session.cancel()
        self.staged = None
        self._scale_target = None
        self.last_migrations = None
        self._reset_stage_session()
        if self.page_table is not None:
            self.page_table.abort()


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``.  On the card through pinned memory with an
    async copy: a pageable copy synchronises the stream, which
    ``begin_scale`` must not do while the serving loop runs under
    ``set_sync_debug_mode("error")``."""
    t = torch.from_numpy(a)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)

