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
slice.  Like the reference's rule, the split of q, k, v and o may cut a
head (qwen3-30b-a3b's 4 kv heads at tp = 8: 64 of a head's 128 columns a
rank); the steps compute it (``models.layers``' and ``models.mla``'s
module notes).

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

The skew rebalancer's session (pooled store only): ``begin_rebalance``
stages replicate / demote / drop / promote actions on the page table and
submits one copy op per replicate (the primary's page of every bank into
the replica's fresh page, which no table names until commit) and per
demote (the page into its host page's rows of the pinned-host tier,
``_HostTier``) to the TransferEngine, on the card on its side streams,
while serving goes on;
``poll_rebalance`` observes them, ``commit_rebalance`` (on the serving
thread) makes the default stream wait for them, publishes the demoted rows
as the pinned-host tier, and writes the replica-aware index arrays into
the bound ``tables`` / ``edest`` / ``eslot`` / ``gtable`` tensors in
place, so every captured graph stays valid; ``abort_rebalance`` cancels
or joins the copies before it frees their pages.  The table width has
``expert_slot_slack`` spare slots per rank for the replicas.  A scale
moves a demoted expert that must move from its host rows
(``expert_h2d_bytes``, not P2P).

Scale to zero (``park``, ``begin_unpark``): ``park`` snapshots every
weight bank into pinned host memory — each dense leaf's distinct shards
and each expert page's rows, a demoted page's tier rows taken as they
are — synchronises once, and drops every device tensor.  The HMM has one
pinned allocator, ``_PinnedArena`` (128 MiB slabs, pinned once each; a
leaf past a slab gets its own block): the host tier's slabs are carved
from it, and the snapshot takes it over.  ``begin_unpark(target)`` opens
a staging session like ``begin_scale``'s: it allocates the target's
tensors and its fresh KV cache on the serving thread (zeroed pool
slices; the index arrays of a fresh ``initial_place``), and its units
copy the snapshot into them host to device (overlapped: on the
TransferEngine's side streams).  ``commit`` adopts them and frees the
snapshot, its pinned memory with it; ``abort`` keeps it, so the unpark
can be retried.  The byte fields are the reference's: the park counts
each dense leaf's logical bytes once and one page per device-resident
page in ``d2h_bytes``; the unpark counts every device shard (whole pool
slices, their zero rows too) in ``h2d_bytes``, and the rows it copies in
``h2d_copied_bytes``.

One device on either side of a scale, a park or an unpark: the
instance's plain tensors are read as the shards of its one-device mesh,
every index ``slice(None)`` (``_sharded_view``), as the reference's
one-device arrays are, so the same staging, byte accounting and commit
run; a one-device target's staged tree and cache are its shards as plain
tensors again (``_plain``).  A DP1 source's KV shards are keyed whole
and a DP2 target's by replica, and the reverse, so such a commit zeroes
the KV, as the reference's ``_grow_cache`` does (ROADMAP §3, "Parity
held").
"""
from __future__ import annotations

import dataclasses
import math
import re
import threading
import time
from collections import defaultdict
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

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
from repro_torch.models.model import (check_mla_heads,
                                      dense_cache_supported, init_cache,
                                      init_expert_bank, init_paged_cache,
                                      init_params, paged_cache_supported)
from repro_torch.core.transfer import (TransferEngine, TransferOp,
                                      cuda_devices, ready_events)
from repro_torch.serving.kv_blocks import KVBlockManager


def _idx_key(index) -> tuple:
    return tuple((s.start, s.stop, s.step) for s in index)


@dataclasses.dataclass
class TransferStats:
    """Bytes a boot, scale, commit or rebalance moved, as the reference
    counts them.  ``expert_replica_bytes``: pages copied to make replicas;
    ``expert_d2h_bytes``: pages demoted into the pinned-host tier;
    ``expert_h2d_bytes``: host-tier pages copied back at a scale (not in
    ``p2p_bytes``), or an unpark's live pages.  ``d2h_bytes``: a park's
    snapshot; ``h2d_bytes``: an unpark's stream, every device shard whole
    as the reference counts it; ``h2d_copied_bytes`` (not a reference
    field): the bytes the unpark's copies moved, which leave out the
    zero rows of the pool slices."""
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
    h2d_copied_bytes: int = 0

    #: the additive byte / count fields (timing fields excluded)
    BYTE_FIELDS = ("zero_copy_bytes", "p2p_bytes", "local_bytes",
                   "init_bytes", "zero_copy_count", "p2p_count",
                   "expert_p2p_bytes", "expert_zero_copy_bytes",
                   "expert_local_bytes", "expert_replica_bytes",
                   "expert_d2h_bytes", "expert_h2d_bytes",
                   "d2h_bytes", "h2d_bytes")

    def merge(self, o: "TransferStats"):
        for f in self.BYTE_FIELDS + ("wall_s", "op_s", "h2d_copied_bytes"):
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
        # called at the end of every ``abort`` (the IMM drops the aborted
        # target's graph set there)
        self.abort_listeners: List[Callable[[], None]] = []
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
        # spare table slots per rank beyond ceil(E / ndev): room for the
        # rebalancer's replicas; the width is fixed for the HMM's lifetime
        self.expert_slot_slack = int(expert_slot_slack)
        # the pinned-host tier's capacity in pages (None: every expert once)
        self.expert_host_pages = expert_host_pages
        # the host tier's bytes: (layer, expert) -> {bank: pinned row}, rows
        # of the tier's slabs (made at the first demote)
        self._expert_host_pool: Dict[Tuple[int, int],
                                     Dict[str, torch.Tensor]] = {}
        self._host_tier: Optional[_HostTier] = None
        # the one pinned-host allocator: the tier's slabs, then a park's
        # snapshot (which takes it over), made at first use
        self._arena: Optional[_PinnedArena] = None
        # the rebalance session (begin_rebalance to commit or abort)
        self._rebalance_ops = None
        self._rebalance_session = None
        self._rebalance_stats: Optional[TransferStats] = None
        self._rebalance_load = None
        self._rebalance_t0 = 0.0
        self.last_rebalance_stats: Optional[TransferStats] = None
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
        # tree, {cache leaf: {logical device: new zeroed KV shard}}); an
        # unpark's: (cfg, mesh, the staged tree, its fresh cache)
        self._scale_target: Optional[Tuple] = None
        # the parked snapshot (park to an unpark's commit), the unpark
        # session's fresh page table, and the last park's timings
        self._parked: Optional[_Parked] = None
        self._unpark = False
        self._unpark_table: Optional[ExpertPageTable] = None
        self.last_park: Optional[Dict[str, float]] = None
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

    def _sharded_view(self, tree, cfg: ElasticConfig, cache: bool = False):
        """``tree`` as ``cfg``'s mesh holds it: on one device its plain
        tensors as the one shard each of a ``ShardedTensor`` (every index
        ``slice(None)``, the same tensors), by the parameter rule or, with
        ``cache``, the cache's; on several devices ``tree`` itself."""
        if cfg.ndev > 1:
            return tree
        mesh = make_instance_mesh(cfg, self.all_devices)
        dev = cfg.devices[0]
        return tree_map_with_path(
            lambda path, t: ShardedTensor(
                t.shape, (self.cache_sharding(t.shape, mesh) if cache else
                          self.param_sharding(path, t.shape, mesh)),
                {dev: t}), tree)

    @staticmethod
    def _plain(tree, cfg: ElasticConfig):
        """A tree of ``cfg``'s ``ShardedTensor``s as the instance holds it:
        on one device each leaf's one shard, plain; else ``tree``."""
        if cfg.ndev > 1:
            return tree
        return tree_map_with_path(lambda _, t: t.shard(cfg.devices[0]),
                                  tree)

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

    def _pooled_index_arrays(self, table, cfg: ElasticConfig,
                             replicas=None, load=None):
        """The pooled path's index arrays from a page-table dict, the
        tables ``expert_slot_slack`` slots wider than ceil(E / ndev);
        ``replicas`` / ``load``: the replica-aware serving assignment
        (``pooled_layout``).  A scale's staging passes neither: its staged
        table names each expert's kept copy."""
        elm = (math.ceil(self.mcfg.num_experts / cfg.ndev)
               + self.expert_slot_slack)
        return pooled_layout(table, cfg, self._n_moe_layers,
                             self.mcfg.num_experts, self.expert_pool_pages,
                             replicas=replicas, load=load,
                             slots_per_rank=elm)

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
            self.page_table = self._fresh_table()
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
        return init_params(self.mcfg, self.seed, device=self.device,
                           experts=True)

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
        check_devices(new_cfg, self.all_devices)
        t0 = time.perf_counter()
        mesh = make_instance_mesh(new_cfg, self.all_devices)
        if self.expert_mode == "pooled":
            self.last_migrations = self.page_table.stage_remap(
                new_cfg, min_move=True)
            self._stage_layout = self._pooled_index_arrays(
                self.page_table.staged, new_cfg)
        work = []
        dst = {}
        for path, leaf in tree_leaves_with_path(
                self._sharded_view(self.params, self.active_cfg)):
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
            self._plain(tree_map_with_path(lambda path, _: dst[path],
                                           self.params), new_cfg),
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
        if kind == "unpark":
            # a cold start: ``leaf`` is the parked snapshot's host leaf
            return self._put_host_leaf(leaf, dst, stats)
        if kind.startswith("pool:"):
            return self._migrate_pool_bank(leaf, new_cfg, stats, dst,
                                           kind.split(":", 1)[1])
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
        if (self.page_table is not None and self.page_table.staged is None
                and not self._unpark):
            # an unpark's fresh table (begin_unpark) has no live placement
            # to remap from
            self.page_table.stage_remap(new_cfg, min_move=False)
        self.staged = (new_cfg, mesh, new_params)
        stats.wall_s += time.perf_counter() - t0
        self.last_stats = stats
        self._reset_stage_session()

    def _migrate_pool_bank(self, leaf: ShardedTensor, new_cfg: ElasticConfig,
                           stats: TransferStats, dst: ShardedTensor,
                           bank: str) -> ShardedTensor:
        """Rebuild one pooled bank (``bank``: "wi", "wo_scale", ...) for
        ``new_cfg`` into ``dst``: every surviving device's pool slice is
        reused, new devices start from zeros, and exactly the staged
        ``Migration`` list is copied, one page per copy between logical
        devices.  A migrated-in page is written into its destination slice
        in place: its page is one the active table leaves free, so the
        serving instance never reads it (the reference's immutable arrays
        take a new buffer instead).  A migration whose source is the
        pinned-host tier (``src.device == HOST``) copies the expert's host
        row, counted in ``expert_h2d_bytes`` and not in ``p2p_bytes``."""
        row_shape = leaf.shape[1:]
        row_bytes = math.prod(row_shape) * leaf.dtype.itemsize
        migs_by_dst: Dict[int, List] = defaultdict(list)
        for m in self.last_migrations:
            migs_by_dst[m.dst.device].append(m)
        # pages that stay put are this bank's zero-copy reuse: an expert
        # kept in place through any copy (primary or replica)
        staged, active = self.page_table.staged, self.page_table.active
        replicas = self.page_table.replicas
        unchanged = sum(
            1 for k, r in active.items()
            if staged.get(k) == r or staged.get(k) in replicas.get(k, ()))
        stats.zero_copy_bytes += unchanged * row_bytes
        stats.zero_copy_count += unchanged
        stats.expert_zero_copy_bytes += unchanged * row_bytes

        for dev in new_cfg.devices:
            local = dst.shard(dev)
            for m in migs_by_dst.get(dev, ()):
                if m.src.is_host:
                    local[m.dst.page].copy_(
                        self._expert_host_pool[(m.layer, m.expert)][bank],
                        non_blocking=True)
                    stats.expert_h2d_bytes += row_bytes
                    continue
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
        stays valid.  A one-device side is read and given as plain
        tensors (``_sharded_view``, ``_plain``)."""
        live_cache = self._sharded_view(live_cache, self.active_cfg,
                                        cache=True)
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
        return self._plain(out, new_cfg)

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
        if self._unpark:
            return new_cfg, mesh, params, new_kv     # its fresh cache
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
        if self._unpark:
            return self._commit_unpark(new_cfg, params, stats, t0)
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
        if new_cfg.ndev == 1:
            self.device = self.all_devices[new_cfg.devices[0]]
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
        (``ExpertPageTable.abort``).  Then each of ``abort_listeners``
        runs."""
        if self._stage_session is not None:
            self._stage_session.cancel()
        self.staged = None
        self._scale_target = None
        self.last_migrations = None
        self._reset_stage_session()
        # an unpark's snapshot stays: the unpark can be tried again
        self._unpark = False
        self._unpark_table = None
        if self.page_table is not None:
            self.page_table.abort()
        for fn in self.abort_listeners:
            fn()

    # -------------------------------------------------------- scale to zero
    def _fresh_table(self) -> ExpertPageTable:
        """An empty page table of this HMM's store (nothing placed)."""
        pooled = self.expert_mode == "pooled"
        return ExpertPageTable(
            self._n_moe_layers, self.mcfg.num_experts,
            pool_pages_per_device=(self.expert_pool_pages if pooled else 0),
            host_pool_pages=self.expert_host_pages)

    def _pinned_arena(self) -> "_PinnedArena":
        if self._arena is None:
            self._arena = _PinnedArena(pin=self.device.type == "cuda")
        return self._arena

    @obs.traced("hmm.park", cat="hmm")
    def park(self) -> TransferStats:
        """Scale to zero devices: snapshot every weight bank into pinned
        host memory and drop every device tensor the HMM holds.  A dense
        leaf keeps its distinct shards (a TP split's pieces; a replicated
        leaf once); the pooled store keeps each (layer, expert)'s rows: a
        page demoted to the host tier is absorbed, its tier rows taken as
        they are (a demote keeps the device page, so the reference counts
        and copies it again; ``d2h_bytes`` keeps that count), any other
        page is copied out.  The snapshot takes over the HMM's pinned
        arena, the tier's slabs with it.  Every pinned buffer is made
        before the first copy (``last_park`` splits the two), and the park
        synchronises once, after the copies.  The KV cache is not kept:
        the server parks only with no sequence in flight, and
        ``begin_unpark`` makes a fresh one.  No staging or rebalance
        session may be open.  Returns the stats, the snapshot in
        ``d2h_bytes`` (one ``expert_page_nbytes`` per device-resident
        page)."""
        if self.active_cfg is None:
            raise RuntimeError("nothing to park")
        if self._stage_work is not None or self.staged is not None:
            raise RuntimeError("park is mutually exclusive with scale "
                               "staging")
        if self._rebalance_ops is not None:
            raise RuntimeError("park is mutually exclusive with rebalancing")
        cfg = self.active_cfg
        t0 = time.perf_counter()
        stats = TransferStats()
        arena = self._pinned_arena()
        pin0 = arena.pin_s
        copies: List[Tuple[torch.Tensor, torch.Tensor]] = []   # (host, dev)

        def snapshot(_, leaf: ShardedTensor) -> _HostLeaf:
            pieces = {}
            for _, index, data in leaf.addressable_shards:
                if _idx_key(index) not in pieces:
                    host = arena.empty(tuple(data.shape), data.dtype)
                    copies.append((host, data))
                    pieces[_idx_key(index)] = (index, host)
                    stats.d2h_bytes += data.nbytes
            return _HostLeaf(leaf.shape, pieces)
        tree = tree_map_with_path(snapshot, self._sharded_view(
            {k: v for k, v in self.params.items() if k != "moe_pool"}, cfg))
        pages = None
        if self.expert_mode == "pooled":
            pages = {}
            slices = self._pool_slices()
            page_bytes = self.expert_page_nbytes()
            for key, ref in self.page_table.active.items():
                if not ref.is_host:
                    stats.d2h_bytes += page_bytes
                    stats.expert_d2h_bytes += page_bytes
                if key in self._expert_host_pool:
                    pages[key] = self._expert_host_pool[key]   # absorbed
                    continue
                rows = {}
                for bank, devs in slices.items():
                    src = devs[ref.device][ref.page]
                    rows[bank] = arena.empty(tuple(src.shape), src.dtype)
                    copies.append((rows[bank], src))
                pages[key] = rows
        t1 = time.perf_counter()
        for host, dev in copies:
            host.copy_(dev, non_blocking=True)
        for d in cuda_devices(self.all_devices[i] for i in cfg.devices):
            torch.cuda.synchronize(d)       # the one sync: they have landed
        copy_s = time.perf_counter() - t1
        total = (sum(leaf.nbytes for _, leaf in tree_leaves_with_path(tree))
                 + sum(r.nbytes for rows in (pages or {}).values()
                       for r in rows.values()))
        copied = sum(h.nbytes for h, _ in copies)
        self._parked = _Parked(tree, pages, total, arena)
        self.params = None
        self.cache = None
        self.kv_blocks = None
        self.active_cfg = None
        # the demoted rows live on in the snapshot, which owns the arena
        self._expert_host_pool = {}
        self._host_tier = None
        self._arena = None
        if self.page_table is not None:
            self.page_table = self._fresh_table()
        stats.wall_s = time.perf_counter() - t0
        self.last_stats = stats
        self.last_park = {"pin_s": arena.pin_s - pin0, "copy_s": copy_s,
                          "pinned_bytes": arena.pinned_bytes,
                          "copied_bytes": copied,
                          "absorbed_bytes": total - copied,
                          "bytes": total}
        return stats

    @property
    def parked(self) -> bool:
        return self._parked is not None

    def parked_bytes(self) -> int:
        """Bytes of the parked snapshot (0 unless parked)."""
        return self._parked.nbytes if self._parked is not None else 0

    @obs.traced("hmm.begin_unpark", cat="hmm")
    def begin_unpark(self, cfg: ElasticConfig) -> int:
        """Open a staging session that streams the parked snapshot to
        ``cfg``'s devices: ``begin_scale``'s discipline (serial units in
        ``stage_increment``; overlapped on the TransferEngine's side
        streams, polled with ``poll_staging``).  Every destination tensor
        and the fresh KV cache are made here, on the caller's thread, with
        no host sync: the target's graphs can be captured over them
        (``staged_tensors``) while the copies land.  The pooled store gets
        a fresh ``initial_place`` at ``cfg``: its pool slices start zeroed
        and each live page's rows are copied into its slot.  ``commit``
        adopts the tensors and the cache (and a fresh KV block manager)
        and frees the snapshot; ``abort`` keeps it.  Returns the unit
        count."""
        if self._parked is None:
            raise RuntimeError("not parked")
        if self._stage_work is not None:
            raise RuntimeError("staging already in progress")
        if cfg.tp != self.tp:
            raise ValueError("TP is fixed across park and unpark (§4.1)")
        check_devices(cfg, self.all_devices)
        t0 = time.perf_counter()
        mesh = make_instance_mesh(cfg, self.all_devices)
        snap = self._parked
        table = None
        if self.page_table is not None:
            table = self._fresh_table()
            table.initial_place(cfg)
        src = tree_map_with_path(lambda _, leaf: leaf, snap.tree)
        if self.expert_mode == "pooled":
            pin = self.device.type == "cuda"
            moe = src["blocks"]["moe"]
            for name, arr in self._pooled_index_arrays(table.active,
                                                       cfg).items():
                t = torch.from_numpy(np.ascontiguousarray(arr, np.int32))
                moe[name] = _HostLeaf.whole(t.pin_memory() if pin else t)
            ppd = self.expert_pool_pages
            src["moe_pool"] = {}
            for bank, row in next(iter(snap.pages.values())).items():
                rows = defaultdict(list)
                for key, ref in table.active.items():
                    rows[ref.device].append((ref.page, snap.pages[key][bank]))
                src["moe_pool"][bank] = _HostPool(
                    (cfg.ndev * ppd,) + tuple(row.shape), row.dtype,
                    dict(rows))
        work, dst = [], {}
        for path, leaf in tree_leaves_with_path(src):
            sh = self.param_sharding(path, leaf.shape, mesh)
            dtype = leaf.dtype
            # pool slices start zeroed (the rows of no page)
            alloc = torch.zeros if isinstance(leaf, _HostPool) else torch.empty
            dst[path] = ShardedTensor(leaf.shape, sh, {
                d: alloc(index_shape(leaf.shape, idx), dtype=dtype,
                         device=mesh.torch_device(d))
                for d, idx in sh.devices_indices_map(leaf.shape).items()})
            work.append((path, leaf, sh, None, "unpark", dst[path]))
        self._stage_work = work
        self._stage_cursor = 0
        self._scale_target = (
            cfg, mesh,
            self._plain(tree_map_with_path(lambda path, _: dst[path], src),
                        cfg),
            self._plain(self._sharded_cache(cfg, mesh), cfg))
        self._unpark = True
        self._unpark_table = table
        self._stage_stats = TransferStats(wall_s=time.perf_counter() - t0)
        if snap.pages is not None:
            # the live pages' share of the stream
            self._stage_stats.expert_h2d_bytes += (
                len(snap.pages) * self.expert_page_nbytes())
        if self.staging_mode == "overlap":
            self._stage_t0 = t0
            devs = cuda_devices(self.all_devices[d] for d in cfg.devices)
            ops = [TransferOp(index=i, label=f"unpark:{unit[0]}",
                              devices=devs,
                              fn=self._make_stage_op(unit[1:], cfg, mesh))
                   for i, unit in enumerate(work)]
            # the side streams wait for the zero fills issued above
            self._stage_session = self.transfer_engine().submit(
                ops, after=ready_events(devs))
        return len(work)

    def _put_host_leaf(self, leaf, dst: ShardedTensor,
                       stats: TransferStats) -> ShardedTensor:
        """One unpark unit: the parked ``leaf`` into its staged ``dst``,
        shard by shard, asynchronously from pinned memory (on the card on
        the worker's side stream).  ``h2d_bytes`` counts every device
        shard whole, as the reference streams it; ``h2d_copied_bytes``
        what was copied (a pool slice's live rows only)."""
        for dev, index, data in dst.addressable_shards:
            stats.h2d_bytes += data.nbytes
            if isinstance(leaf, _HostPool):
                for page, row in leaf.rows.get(dev, ()):
                    data[page].copy_(row, non_blocking=True)
                    stats.h2d_copied_bytes += row.nbytes
            else:
                stats.h2d_copied_bytes += leaf.copy_into(data, index)
        return dst

    def _commit_unpark(self, cfg: ElasticConfig, params,
                       stats: TransferStats, t0: float) -> TransferStats:
        """The unpark's switchover: the streamed weights, the fresh KV
        cache made at ``begin_unpark`` (``init_bytes``: its logical bytes,
        which the reference allocates here) and the fresh page table
        become active; the snapshot is freed, its pinned memory given back
        to the system (the caching host allocator would keep it)."""
        cache = self._scale_target[3]
        stats.init_bytes += sum(leaf.nbytes for leaf in cache.values())
        self.cache = cache
        if self.kv_mode == "paged":
            self.kv_blocks = KVBlockManager(cfg.dp,
                                            self.kv_blocks_per_replica,
                                            self.kv_block_size)
        self.active_cfg = cfg
        self.params = params
        self.staged = None
        self._scale_target = None
        if cfg.ndev == 1:
            self.device = self.all_devices[cfg.devices[0]]
        if self._unpark_table is not None:
            self.page_table = self._unpark_table
        self._unpark = False
        self._unpark_table = None
        pinned = self._parked.arena.pin
        self._parked = None
        if pinned:
            torch._C._host_emptyCache()
        stats.wall_s = time.perf_counter() - t0
        if self.last_stats is not None:
            self.last_stats.merge(stats)
        return stats

    # ------------------------------------------------------------ rebalance
    def _pool_slices(self) -> Dict[str, Dict[int, torch.Tensor]]:
        """bank -> {logical device: its pool slice} of the active store."""
        out = {}
        for bank, leaf in self.params["moe_pool"].items():
            out[bank] = (dict(leaf.shards) if isinstance(leaf, ShardedTensor)
                         else {self.active_cfg.devices[0]: leaf})
        return out

    @obs.traced("hmm.begin_rebalance", cat="hmm")
    def begin_rebalance(self, actions, load=None) -> int:
        """Open a rebalance session: stage ``actions``
        (``ExpertPageTable.stage_rebalance``) and submit one copy op per
        replicate and per demote to the TransferEngine, where they run
        while serving goes on — on the card on its side streams, after
        everything the serving thread has issued (a replica's page may be
        one a dropped replica left, which earlier steps read).  A
        replicate copies the primary's page of every bank (the int8
        scales too) into the replica's page, which no table names until
        commit; a demote copies it into the rows of its host page in the
        pinned-host tier (``_HostTier``: a slab that is not pinned yet is
        pinned on the worker, off the serving thread).
        ``load``: the [L_moe, E] routing counts the commit's serving
        assignment weighs.  Returns the number of copy ops; drive with
        ``poll_rebalance`` and ``commit_rebalance``, or unwind with
        ``abort_rebalance``."""
        if self.expert_mode != "pooled":
            raise RuntimeError("rebalance requires expert_mode='pooled'")
        if self._stage_work is not None or self.staged is not None:
            raise RuntimeError("rebalance is mutually exclusive with scale "
                               "staging")
        if self._rebalance_ops is not None:
            raise RuntimeError("a rebalance is already in progress")
        self._rebalance_t0 = time.perf_counter()
        ops = self.page_table.stage_rebalance(actions)
        self._rebalance_ops = ops
        self._rebalance_load = (np.asarray(load, np.float64)
                                if load is not None else None)
        self._rebalance_stats = TransferStats()
        slices = self._pool_slices()
        if self._host_tier is None:
            self._host_tier = _HostTier(
                {b: (tuple(t.shape[1:]), t.dtype)
                 for b, t in self.params["moe_pool"].items()},
                self.page_table.host_pool_pages, self._pinned_arena())
        page_bytes = self.expert_page_nbytes()
        work, devs = [], set()
        for i, op in enumerate(ops):
            if op.kind not in ("replicate", "demote"):
                continue
            src = {b: rows[op.src.device][op.src.page]
                   for b, rows in slices.items()}
            if op.kind == "demote":
                dst, on = op.dst.page, [op.src.device]
            else:
                dst = {b: rows[op.dst.device][op.dst.page]
                       for b, rows in slices.items()}
                on = [op.src.device, op.dst.device]
            on = cuda_devices(self.all_devices[d] for d in on)
            devs.update(on)
            work.append(TransferOp(
                index=i, label=f"rebalance:{op.kind}:{op.layer}.{op.expert}",
                fn=partial(self._rebalance_copy, op.kind, src, dst,
                           page_bytes), devices=on))
        self._rebalance_session = (
            self.transfer_engine().submit(work, after=ready_events(devs))
            if work else None)
        return len(work)

    def _rebalance_copy(self, kind: str, src, dst, page_bytes: int):
        """One copy op of a rebalance session: every bank's row ``src`` into
        ``dst`` (a demote's host page: its rows in the pinned-host tier) —
        asynchronous on the card, on the worker's side stream — its page
        counted as replica or D2H bytes.  Returns the rows written."""
        if isinstance(dst, int):
            dst = self._host_tier.rows(dst)
        for bank, row in src.items():
            dst[bank].copy_(row, non_blocking=True)
        sub = TransferStats()
        if kind == "demote":
            sub.expert_d2h_bytes = page_bytes
        else:
            sub.expert_replica_bytes = page_bytes
        with self._stage_lock:
            self._rebalance_stats.merge(sub)
        return dst

    @property
    def rebalance_in_flight(self) -> bool:
        return (self._rebalance_session is not None
                and not self._rebalance_session.finished())

    def poll_rebalance(self) -> bool:
        """A bounded completion poll (at most about 2 ms), as
        ``poll_staging``: True once every copy op has landed
        (``commit_rebalance`` legal).  A failed op aborts the session
        (both tiers as before) and re-raises."""
        if self._rebalance_ops is None:
            return False
        sess = self._rebalance_session
        if sess is not None:
            if not sess.finished():
                sess.join(timeout=0.002)
                if not sess.finished():
                    return False
            failed = sess.failed_ops()
            if failed:
                err = failed[0].error
                self.abort_rebalance()
                raise RuntimeError(
                    f"rebalance copy op {failed[0].label!r} failed "
                    f"({len(failed)} op(s)); session aborted") from err
        return True

    @obs.traced("hmm.commit_rebalance", cat="hmm")
    def commit_rebalance(self, load=None) -> TransferStats:
        """The rebalance's switchover, on the serving thread: the default
        streams wait for the copies, the demoted rows become the host
        tier's, the page table commits (freeing dropped replicas' and
        promoted experts' pages), and the replica-aware serving assignment
        (least-loaded over ``load``, by default the counts given to
        ``begin_rebalance``) is written into the bound index tensors of
        every logical device in place: the shapes stay (the slack is in
        the width), so the bound steps and graphs stay valid, and every
        copy is byte-identical, so the tokens do not change.  The new
        layout is computed on a clone first: a slot overflow aborts the
        whole session and raises before anything changes."""
        if self._rebalance_ops is None:
            raise RuntimeError("no rebalance session open")
        sess = self._rebalance_session
        if sess is not None:
            sess.join()
            if not self.poll_rebalance():     # raises on a failed op
                raise RuntimeError("the rebalance session did not finish")
        t0 = time.perf_counter()
        ops, cfg, stats = (self._rebalance_ops, self.active_cfg,
                           self._rebalance_stats)
        if load is None:
            load = self._rebalance_load
        preview = self.page_table.clone()
        preview.commit_rebalance()
        try:
            layout = self._pooled_index_arrays(
                preview.active, cfg, replicas=preview.replicas, load=load)
        except ValueError:
            self.abort_rebalance()
            raise
        rows = {}
        if sess is not None:
            for top in sess.ops:
                rows[top.index] = top.result
                for dev, ev in top.events.items():
                    torch.cuda.current_stream(dev).wait_event(ev)
        for i, op in enumerate(ops):
            if op.kind == "demote":
                self._expert_host_pool[op.key] = rows[i]
            elif op.kind == "promote":
                self._expert_host_pool.pop(op.key, None)
        self.page_table.commit_rebalance()
        moe = self.params["blocks"]["moe"]
        for name, arr in layout.items():
            leaf = moe[name]
            parts = (leaf.addressable_shards
                     if isinstance(leaf, ShardedTensor)
                     else [(None, (slice(None),), leaf)])
            for _, index, t in parts:
                t.copy_(_upload(np.ascontiguousarray(arr[index], np.int32),
                                t.device))
        if sess is not None:
            stats.op_s = sess.op_seconds
            stats.wall_s = max(sess.last_done_t - self._rebalance_t0, 0.0)
        stats.wall_s += time.perf_counter() - t0
        self.last_rebalance_stats = stats
        self._reset_rebalance()
        return stats

    @obs.traced("hmm.abort_rebalance", cat="hmm")
    def abort_rebalance(self) -> None:
        """Cancel-or-join the session's copies (no worker writes a page
        after this), then unwind it: the fresh pages return to their pools
        and no demoted row is published — both tiers as before
        ``begin_rebalance``.  Idempotent."""
        if self._rebalance_session is not None:
            self._rebalance_session.cancel()
        self._reset_rebalance()
        if self.page_table is not None:
            self.page_table.abort_rebalance()

    def _reset_rebalance(self) -> None:
        self._rebalance_ops = None
        self._rebalance_session = None
        self._rebalance_stats = None
        self._rebalance_load = None

    def host_tier_bytes(self) -> int:
        """Resident bytes of the pinned-host tier: the demoted pages and,
        parked, the whole-model snapshot."""
        return (len(self._expert_host_pool) * self.expert_page_nbytes()
                + self.parked_bytes())


class _HostTier:
    """The pinned-host tier's memory: per bank, slabs of ``slab`` pages,
    each carved from the HMM's ``_PinnedArena`` when a demote first needs
    one of its pages and kept; host page p (the page table's ``HOST``
    pool) is row ``p % slab`` of slab ``p // slab``.  Page locking costs
    20-25 times a copy's time on an H100's host link
    (``tools/torch_host_tier_rates.py``), so memory is pinned once and a
    promoted page's rows serve a later demote; a slab is at most one
    arena slab (or the tier's ``capacity`` pages where they take less).
    A park absorbs the demoted pages' rows into its snapshot."""

    def __init__(self, banks: Dict[str, Tuple[tuple, torch.dtype]],
                 capacity: int, arena: "_PinnedArena"):
        self.banks = banks
        self.arena = arena
        row = max(math.prod(shape) * dtype.itemsize
                  for shape, dtype in banks.values())
        self.slab = max(1, min(arena.SLAB_BYTES // row, capacity))
        self._slabs: Dict[Tuple[str, int], torch.Tensor] = {}
        self._lock = threading.Lock()

    def rows(self, page: int) -> Dict[str, torch.Tensor]:
        """Host page ``page``'s row of every bank (its slabs made here)."""
        k, r = divmod(page, self.slab)
        with self._lock:
            for bank, (shape, dtype) in self.banks.items():
                if (bank, k) not in self._slabs:
                    self._slabs[(bank, k)] = self.arena.empty(
                        (self.slab, *shape), dtype)
            return {b: self._slabs[(b, k)][r] for b in self.banks}

    def pinned_bytes(self) -> int:
        with self._lock:
            return sum(t.nbytes for t in self._slabs.values())


class _PinnedArena:
    """The HMM's pinned host memory — the host tier's slabs, then the
    parked snapshot, which takes the arena over — as tensors carved from
    128 MiB slabs (a power of two, so the caching host allocator rounds
    nothing up), each slab pinned once when it is made.  A tensor goes to
    the first slab with room at its end; one past a slab gets a block of
    its own.  ``pin=False`` (CPU tensors): pageable memory.  Pinning that
    fails raises: the copies would synchronise on pageable memory."""

    SLAB_BYTES = 128 << 20
    ALIGN = 512

    def __init__(self, pin: bool):
        self.pin = pin
        self.blocks: List[torch.Tensor] = []
        self.pin_s = 0.0                    # seconds spent allocating
        self._tails: List[List] = []        # [slab, first free byte]
        self._lock = threading.Lock()

    @property
    def pinned_bytes(self) -> int:
        return sum(b.nbytes for b in self.blocks)

    def _block(self, n: int) -> torch.Tensor:
        t0 = time.perf_counter()
        block = torch.empty(n, dtype=torch.uint8, pin_memory=self.pin)
        self.pin_s += time.perf_counter() - t0
        self.blocks.append(block)
        return block

    def empty(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        n = math.prod(shape) * dtype.itemsize
        with self._lock:
            if n > self.SLAB_BYTES:
                buf, off = self._block(n), 0
            else:
                tail = next((t for t in self._tails
                             if t[1] + n <= self.SLAB_BYTES), None)
                if tail is None:
                    tail = [self._block(self.SLAB_BYTES), 0]
                    self._tails.append(tail)
                buf, off = tail
                tail[1] = -(-(off + n) // self.ALIGN) * self.ALIGN
        return buf[off:off + n].view(dtype).view(shape)


class _HostLeaf:
    """A parked parameter leaf: its distinct shards in host memory,
    ``pieces``: index key -> (index, host tensor)."""

    def __init__(self, shape: tuple, pieces: Dict[tuple, Tuple]):
        self.shape = tuple(shape)
        self.pieces = pieces

    @classmethod
    def whole(cls, t: torch.Tensor) -> "_HostLeaf":
        index = tuple(slice(None) for _ in t.shape)
        return cls(tuple(t.shape), {_idx_key(index): (index, t)})

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.pieces.values()))[1].dtype

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for _, t in self.pieces.values())

    def copy_into(self, out: torch.Tensor, index) -> int:
        """Fill ``out``, the leaf's shard at ``index``: from the piece at
        that very index in one copy, else from each piece's overlap with it
        (a dense expert bank whose EP split changed).  Returns the bytes."""
        hit = self.pieces.get(_idx_key(index))
        if hit is not None:
            out.copy_(hit[1], non_blocking=True)
            return out.nbytes
        n = 0
        for pindex, piece in self.pieces.values():
            n += _copy_overlap(out, index, piece, pindex, self.shape)
        return n


class _HostPool:
    """An unpark's source for one pool bank of ``shape``: logical device
    -> [(page, host row)], each live page's row at its fresh slot."""

    def __init__(self, shape: tuple, dtype: torch.dtype,
                 rows: Dict[int, List[Tuple[int, torch.Tensor]]]):
        self.shape, self.dtype, self.rows = tuple(shape), dtype, rows


@dataclasses.dataclass
class _Parked:
    """A parked HMM's snapshot: the parameter tree without the page pool
    (``_HostLeaf`` leaves), the pooled store's rows by (layer, expert)
    (None with dense banks), its bytes, and the arena that holds them."""
    tree: Any
    pages: Optional[Dict[Tuple[int, int], Dict[str, torch.Tensor]]]
    nbytes: int
    arena: _PinnedArena


def _copy_overlap(out: torch.Tensor, out_index, src: torch.Tensor,
                  src_index, shape) -> int:
    """Copy into ``out`` (the shard at ``out_index`` of a leaf of
    ``shape``) the part of ``src`` (the shard at ``src_index``) the two
    share; returns its bytes."""
    o, s = [], []
    for n, a, b in zip(shape, out_index, src_index):
        alo, ahi, _ = a.indices(n)
        blo, bhi, _ = b.indices(n)
        lo, hi = max(alo, blo), min(ahi, bhi)
        if lo >= hi:
            return 0
        o.append(slice(lo - alo, hi - alo))
        s.append(slice(lo - blo, hi - blo))
    dst = out[tuple(o)]
    _copy_blocks(dst, src[tuple(s)])
    return dst.nbytes


def _copy_blocks(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` in blocks that are contiguous on both sides: a
    copy from a strided host view would go through a pageable copy and
    synchronise."""
    if dst.dim() == 0 or (dst.is_contiguous() and src.is_contiguous()):
        dst.copy_(src, non_blocking=True)
        return
    for i in range(dst.shape[0]):
        _copy_blocks(dst[i], src[i])


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``.  On the card through pinned memory with an
    async copy: a pageable copy synchronises the stream, which
    ``begin_scale`` must not do while the serving loop runs under
    ``set_sync_debug_mode("error")``."""
    t = torch.from_numpy(a)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)

