"""Virtual expert pages — the port's own copy of the parts of
``repro.core.expert_pages`` the serving and scaling paths use.

Each device owns a fixed page *pool* (one page = one (layer, expert) weight
block) plus a page *table* mapping logical experts to pool rows.  The paged
grouped-matmul kernel (``kernels/moe_gmm.py``) reads pages through the
table, so an expert remap rewrites the table and moves no weight bytes.

Double-buffered tables: ``stage_remap`` builds the target table and its
migration list while the active table keeps serving; ``commit`` swaps it
in and frees the old homes of migrated experts; ``abort`` frees the staged
pages.

The skew rebalancer extends the table two ways:

* **replica sets** — a (layer, expert) may map to further device
  ``PageRef`` s beyond its primary.  Replicas are byte-identical copies,
  so which one serves an expert's tokens is a host-side layout decision
  (``pooled_layout`` picks the least-loaded candidate rank): the dispatch
  arithmetic is unchanged and the tokens stay bit-identical;
* **a pinned-host page tier** (logical device ``HOST``) — a cold expert is
  *demoted*: its bytes are copied device-to-host into a host page while the
  device primary keeps serving.  At a scale event a host-backed expert
  that must move is copied back host-to-device instead of between devices.

Both are staged under the scale remap's two-phase discipline
(``stage_rebalance`` / ``commit_rebalance`` / ``abort_rebalance``), and at
most one session, a scale remap or a rebalance, is open at a time.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.topology import ElasticConfig, expert_owner


#: logical device id of the pinned-host page tier (never a device slot)
HOST = -1


@dataclasses.dataclass(frozen=True)
class PageRef:
    device: int
    page: int          # index into that device's pool

    @property
    def is_host(self) -> bool:
        return self.device == HOST


@dataclasses.dataclass(frozen=True)
class Migration:
    layer: int
    expert: int
    src: PageRef       # src.device == HOST: copied from the pinned tier
    dst: PageRef


@dataclasses.dataclass(frozen=True)
class RebalanceOp:
    """One staged rebalance action with its allocated destination:

    * ``replicate`` — copy the expert from its primary ``src`` onto ``dst``
      (a fresh device page);
    * ``demote`` — copy the expert's bytes into ``dst`` (a fresh pinned-host
      page); the device primary keeps serving;
    * ``drop_replica`` — retire the replica ``src`` (no bytes move; the page
      frees at commit);
    * ``promote`` — retire the host copy ``src`` (no bytes move; the host
      page frees at commit)."""
    kind: str
    layer: int
    expert: int
    src: PageRef
    dst: Optional[PageRef] = None

    @property
    def key(self) -> Tuple[int, int]:
        return (self.layer, self.expert)


class ExpertPageTable:
    """Tracks (layer, expert) -> PageRef for the active and staged
    configs, with replica sets and the pinned-host tier.

    ``active`` holds exactly one *device* primary per (layer, expert);
    ``replicas`` hold further device copies; ``host`` at most one
    pinned-host copy per expert.  At most one session — a scale remap or a
    rebalance — is open at a time."""

    def __init__(self, num_layers: int, num_experts: int,
                 pool_pages_per_device: int = 0,
                 host_pool_pages: Optional[int] = None):
        self.num_layers = num_layers
        self.num_experts = num_experts
        # default: room for every page twice (staging headroom) on one device
        self.pool_pages = pool_pages_per_device or 2 * num_layers * num_experts
        # the pinned-host tier's capacity: by default every expert once
        self.host_pool_pages = (num_layers * num_experts
                                if host_pool_pages is None else host_pool_pages)
        self.active: Dict[Tuple[int, int], PageRef] = {}
        # further byte-identical device copies per (layer, expert)
        self.replicas: Dict[Tuple[int, int], Tuple[PageRef, ...]] = {}
        # pinned-host copies (device == HOST); the HMM holds their bytes
        self.host: Dict[Tuple[int, int], PageRef] = {}
        self.staged: Optional[Dict[Tuple[int, int], PageRef]] = None
        self.staged_rebalance: Optional[List[RebalanceOp]] = None
        self._free: Dict[int, List[int]] = {}

    def _pool_size(self, device: int) -> int:
        return self.host_pool_pages if device == HOST else self.pool_pages

    def _ensure_pool(self, device: int):
        if device not in self._free:
            self._free[device] = list(range(self._pool_size(device)))

    def _alloc(self, device: int) -> int:
        self._ensure_pool(device)
        if not self._free[device]:
            tier = ("host page tier" if device == HOST
                    else f"page pool on device {device}")
            raise MemoryError(f"{tier} exhausted")
        return self._free[device].pop()

    def pages_in_use(self, device: int) -> int:
        self._ensure_pool(device)
        return self._pool_size(device) - len(self._free[device])

    def replica_count(self, layer: int, expert: int) -> int:
        return len(self.replicas.get((layer, expert), ()))

    def demoted(self) -> List[Tuple[int, int]]:
        """(layer, expert) keys with a copy in the pinned-host tier."""
        return sorted(self.host)

    def clone(self) -> "ExpertPageTable":
        """An independent copy for what-if staging (the driver's cost
        projections, the rebalance commit's preview): the maps and the
        free lists are copied, so staging on the clone leaves this table
        as it was (``PageRef``s are immutable and shared)."""
        t = ExpertPageTable(self.num_layers, self.num_experts,
                            pool_pages_per_device=self.pool_pages,
                            host_pool_pages=self.host_pool_pages)
        t.active = dict(self.active)
        t.replicas = dict(self.replicas)
        t.host = dict(self.host)
        t.staged = dict(self.staged) if self.staged is not None else None
        t.staged_rebalance = (list(self.staged_rebalance)
                              if self.staged_rebalance is not None else None)
        t._free = {d: list(v) for d, v in self._free.items()}
        return t

    def initial_place(self, cfg: ElasticConfig) -> None:
        """First boot: allocate a page per (layer, expert) on its owner."""
        assert not self.active
        for l in range(self.num_layers):
            for e in range(self.num_experts):
                d = expert_owner(e, self.num_experts, cfg)
                self.active[(l, e)] = PageRef(d, self._alloc(d))

    def stage_remap(self, new_cfg: ElasticConfig,
                    min_move: bool = True) -> List[Migration]:
        """Build the target table and the pages that must move.

        ``min_move=True`` (the paper's): per layer, balanced per-device
        capacities (``E // ndev``, one more on the first ``E % ndev``
        devices); every expert stays on its current device while that
        device has room — placement need not be contiguous in logical
        expert order — and the rest go, in expert order, to the device with
        the most room left.  ``min_move=False``: the contiguous
        ``expert_owner`` placement (the dense banks' layout).

        An expert that stays keeps its page; one that moves gets a fresh
        page on its new device and a ``Migration``.  The active table
        serves until ``commit``.  A pool that runs dry raises
        ``MemoryError`` with the pool as before the call.

        Over replicas and the host tier (``min_move``): any copy of an
        expert, primary first and then its replicas in creation order,
        keeps it in place; an expert that must move is copied from its
        host copy where it has one (``src.device == HOST``).  ``commit``
        retires every replica the new placement did not keep."""
        if self.staged is not None:
            raise RuntimeError(
                "a staged remap is already open; commit() or abort() it "
                "before staging another one")
        if self.staged_rebalance is not None:
            raise RuntimeError(
                "a rebalance session is open; commit_rebalance() or "
                "abort_rebalance() before staging a scale remap")
        E = self.num_experts
        devs = list(new_cfg.devices)
        staged: Dict[Tuple[int, int], PageRef] = {}
        migrations: List[Migration] = []
        try:
            if not min_move:
                for (l, e), ref in self.active.items():
                    owner = expert_owner(e, E, new_cfg)
                    if owner == ref.device:
                        staged[(l, e)] = ref
                    else:
                        dst = PageRef(owner, self._alloc(owner))
                        staged[(l, e)] = dst
                        migrations.append(Migration(l, e, ref, dst))
                self.staged = staged
                return migrations
            base, extra = divmod(E, len(devs))
            for l in range(self.num_layers):
                caps = {d: base + (1 if i < extra else 0)
                        for i, d in enumerate(devs)}
                pending: List[Tuple[int, PageRef]] = []
                for e in range(E):
                    copies = ((self.active[(l, e)],)
                              + self.replicas.get((l, e), ()))
                    kept = next((c for c in copies
                                 if caps.get(c.device, 0) > 0), None)
                    if kept is not None:
                        staged[(l, e)] = kept             # stays in place
                        caps[kept.device] -= 1
                    else:
                        pending.append((e, self.active[(l, e)]))
                for e, ref in pending:                    # most room first
                    dst_dev = max(caps, key=lambda d: caps[d])
                    caps[dst_dev] -= 1
                    dst = PageRef(dst_dev, self._alloc(dst_dev))
                    staged[(l, e)] = dst
                    # a demoted expert comes back from the host tier
                    src = self.host.get((l, e), ref)
                    migrations.append(Migration(l, e, src, dst))
            self.staged = staged
            return migrations
        except BaseException:
            for m in migrations:          # the pool as before the call
                self._free[m.dst.device].append(m.dst.page)
            raise

    def commit(self) -> List[PageRef]:
        """Switch to the staged table; returns the pages freed: the old
        homes of migrated experts and every replica the new placement did
        not keep (a kept replica becomes the primary).  Host copies stay:
        weights never change, so they never go stale."""
        if self.staged is None:
            raise RuntimeError("no staged remap open; call stage_remap() "
                               "before commit()")
        to_free: List[PageRef] = []
        for key, old_ref in self.active.items():
            if self.staged[key] != old_ref:
                self._free[old_ref.device].append(old_ref.page)
                to_free.append(old_ref)
        for key, refs in self.replicas.items():
            for ref in refs:
                if ref != self.staged[key]:
                    self._free[ref.device].append(ref.page)
                    to_free.append(ref)
        self.replicas = {}
        self.active = self.staged
        self.staged = None
        return to_free

    def abort(self) -> None:
        """Drop the staged table, freeing its fresh pages.  Idempotent;
        pages the active table or a replica set also holds are never
        freed, and each staged page is freed once."""
        if self.staged is None:
            return
        live = set(self.active.values())
        for refs in self.replicas.values():
            live.update(refs)
        freed = set()
        for ref in self.staged.values():
            if ref not in live and ref not in freed:
                freed.add(ref)
                self._ensure_pool(ref.device)
                self._free[ref.device].append(ref.page)
        self.staged = None

    def stage_rebalance(self, actions: List[Tuple]) -> List[RebalanceOp]:
        """Open a rebalance session: resolve each action and allocate its
        destination page.  ``actions`` entries (``RebalanceOp``):

        * ``("replicate", layer, expert, dst_device)``
        * ``("demote", layer, expert)``
        * ``("drop_replica", layer, expert, device)``
        * ``("promote", layer, expert)``

        Nothing moves yet: ``commit_rebalance`` applies the ops,
        ``abort_rebalance`` returns every fresh page.  A failing action
        (unknown expert or kind, a copy already there, a pool run dry)
        returns the pages this call took and raises, the table as before."""
        if self.staged is not None:
            raise RuntimeError(
                "a staged scale remap is open; rebalance sessions are "
                "mutually exclusive with scale events")
        if self.staged_rebalance is not None:
            raise RuntimeError(
                "a rebalance session is already open; commit_rebalance() "
                "or abort_rebalance() it first")
        ops: List[RebalanceOp] = []
        try:
            for act in actions:
                kind, l, e = act[0], act[1], act[2]
                key = (l, e)
                primary = self.active.get(key)
                if primary is None:
                    raise KeyError(f"unknown expert {key}")
                if kind == "replicate":
                    dst_dev = act[3]
                    holders = {primary.device}
                    holders.update(r.device
                                   for r in self.replicas.get(key, ()))
                    if dst_dev in holders:
                        raise ValueError(
                            f"{key} already has a copy on device {dst_dev}")
                    dst = PageRef(dst_dev, self._alloc(dst_dev))
                    ops.append(RebalanceOp("replicate", l, e, primary, dst))
                elif kind == "demote":
                    if key in self.host:
                        raise ValueError(f"{key} is already demoted")
                    dst = PageRef(HOST, self._alloc(HOST))
                    ops.append(RebalanceOp("demote", l, e, primary, dst))
                elif kind == "drop_replica":
                    src = next((r for r in self.replicas.get(key, ())
                                if r.device == act[3]), None)
                    if src is None:
                        raise ValueError(
                            f"{key} has no replica on device {act[3]}")
                    ops.append(RebalanceOp("drop_replica", l, e, src))
                elif kind == "promote":
                    if key not in self.host:
                        raise ValueError(f"{key} is not demoted")
                    ops.append(RebalanceOp("promote", l, e, self.host[key]))
                else:
                    raise ValueError(f"unknown rebalance action {kind!r}")
        except BaseException:
            for op in ops:          # the pages this call took
                if op.dst is not None:
                    self._free[op.dst.device].append(op.dst.page)
            raise
        self.staged_rebalance = ops
        return ops

    def commit_rebalance(self) -> List[PageRef]:
        """Apply the staged rebalance; returns the pages freed by
        ``drop_replica`` and ``promote`` (``replicate`` and ``demote``
        pages become live)."""
        if self.staged_rebalance is None:
            raise RuntimeError("no rebalance session open; call "
                               "stage_rebalance() before commit_rebalance()")
        freed: List[PageRef] = []
        for op in self.staged_rebalance:
            key = op.key
            if op.kind == "replicate":
                self.replicas[key] = self.replicas.get(key, ()) + (op.dst,)
            elif op.kind == "demote":
                self.host[key] = op.dst
            elif op.kind == "drop_replica":
                kept = tuple(r for r in self.replicas[key] if r != op.src)
                if kept:
                    self.replicas[key] = kept
                else:
                    del self.replicas[key]
                self._free[op.src.device].append(op.src.page)
                freed.append(op.src)
            elif op.kind == "promote":
                del self.host[key]
                self._free[HOST].append(op.src.page)
                freed.append(op.src)
        self.staged_rebalance = None
        return freed

    def abort_rebalance(self) -> None:
        """Drop the rebalance session, returning every fresh page to its
        pool (``drop_replica`` and ``promote`` touched nothing).
        Idempotent; both tiers end as before ``stage_rebalance``."""
        if self.staged_rebalance is None:
            return
        for op in self.staged_rebalance:
            if op.dst is not None:
                self._ensure_pool(op.dst.device)
                self._free[op.dst.device].append(op.dst.page)
        self.staged_rebalance = None

    def device_table(self, cfg: ElasticConfig, layer: int,
                     device: int, staged: bool = False) -> List[int]:
        """Pool indices of the experts ``device`` owns for ``layer``, in
        logical expert order — the indirection vector the MoE kernel reads
        (of the staged table with ``staged``)."""
        if staged and self.staged is None:
            raise RuntimeError("no staged remap open")
        table = self.staged if staged else self.active
        rows = [(e, ref.page) for (l, e), ref in table.items()
                if l == layer and ref.device == device]
        rows.sort()
        return [p for _, p in rows]

    def owners(self, layer: int) -> Dict[int, List[int]]:
        """Device -> the experts it holds for ``layer``, ascending."""
        out: Dict[int, List[int]] = defaultdict(list)
        for (l, e), ref in self.active.items():
            if l == layer:
                out[ref.device].append(e)
        for v in out.values():
            v.sort()
        return out


def pooled_layout(table: Dict[Tuple[int, int], PageRef], cfg: ElasticConfig,
                  num_layers: int, num_experts: int,
                  pages_per_device: int,
                  replicas: Optional[Dict[Tuple[int, int],
                                          Tuple[PageRef, ...]]] = None,
                  load: Optional[np.ndarray] = None,
                  slots_per_rank: Optional[int] = None
                  ) -> Dict[str, np.ndarray]:
    """Flatten a page-table mapping into the index arrays the pooled MoE
    path consumes (host-side numpy), with ``Elm = slots_per_rank or
    ceil(E / ndev)`` (min-move keeps each device's count within the
    default; a larger width is the rebalancer's slot slack):

    * ``tables`` [L, ndev, Elm] int32 — per (layer, device-rank) the LOCAL
      pool-page index of each expert it serves, logical-expert order,
      padded with page 0 (pad slots receive no tokens);
    * ``edest``  [L, E] int32 — serving device rank per expert;
    * ``eslot``  [L, E] int32 — the expert's slot within its rank's table;
    * ``gtable`` [L, E] int32 — GLOBAL pool row (rank * pages_per_device +
      local page) per expert, for the single-shard pooled path.

    With ``replicas``, each expert's tokens go to its least-loaded copy:
    experts in descending ``load`` order (routing counts, [L, E] or [E];
    uniform when None) each take the candidate rank (the primary's or a
    replica's) with the least load so far, the primary on ties, among the
    ranks with a free slot; a layer where some expert finds none raises
    ``ValueError``.  The slots are then laid out in ascending expert order.
    Every copy is byte-identical, so the tokens do not change."""
    ndev = cfg.ndev
    elm = slots_per_rank or math.ceil(num_experts / ndev)
    if load is None:
        load_le = np.ones((num_layers, num_experts), np.float64)
    else:
        load_le = np.broadcast_to(np.asarray(load, np.float64),
                                  (num_layers, num_experts))
    tables = np.zeros((num_layers, ndev, elm), np.int32)
    edest = np.zeros((num_layers, num_experts), np.int32)
    eslot = np.zeros((num_layers, num_experts), np.int32)
    gtable = np.zeros((num_layers, num_experts), np.int32)
    replicas = replicas or {}
    for l in range(num_layers):
        # each expert's serving copy: the least-loaded candidate rank
        chosen: Dict[int, PageRef] = {}
        rank_load = [0.0] * ndev
        rank_slots = [0] * ndev
        for e in sorted(range(num_experts),
                        key=lambda e: (-load_le[l, e], e)):
            best = None
            cands = [table[(l, e)]] + list(replicas.get((l, e), ()))
            for i, ref in enumerate(cands):
                r = cfg.slot(ref.device)
                if rank_slots[r] >= elm:
                    continue                      # the rank's table is full
                k = (rank_load[r], i)             # the primary wins ties
                if best is None or k < best[0]:
                    best = (k, ref, r)
            if best is None:
                raise ValueError(
                    f"layer {l}: no candidate rank for expert {e} has a "
                    f"free slot (Elm={elm}); raise slots_per_rank "
                    f"(replication slack) or rebalance")
            _, ref, r = best
            chosen[e] = ref
            rank_load[r] += float(load_le[l, e])
            rank_slots[r] += 1
        counts = [0] * ndev
        for e in range(num_experts):          # ascending e == logical order
            ref = chosen[e]
            r = cfg.slot(ref.device)
            s = counts[r]
            counts[r] += 1
            tables[l, r, s] = ref.page
            edest[l, e] = r
            eslot[l, e] = s
            gtable[l, e] = r * pages_per_device + ref.page
    return {"tables": tables, "edest": edest, "eslot": eslot,
            "gtable": gtable}
