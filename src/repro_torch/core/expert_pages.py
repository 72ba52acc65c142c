"""Virtual expert pages — the port's own copy of the parts of
``repro.core.expert_pages`` the serving and scaling paths use.

Each device owns a fixed page *pool* (one page = one (layer, expert) weight
block) plus a page *table* mapping logical experts to pool rows.  The paged
grouped-matmul kernel (``kernels/moe_gmm.py``) reads pages through the
table, so an expert remap rewrites the table and moves no weight bytes.

Double-buffered tables: ``stage_remap`` builds the target table and its
migration list while the active table keeps serving; ``commit`` swaps it
in and frees the old homes of migrated experts; ``abort`` frees the staged
pages.  Replicas and the pinned-host tier of the skew rebalancer are not
ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.topology import ElasticConfig, expert_owner


@dataclasses.dataclass(frozen=True)
class PageRef:
    device: int
    page: int          # index into that device's pool


@dataclasses.dataclass(frozen=True)
class Migration:
    layer: int
    expert: int
    src: PageRef
    dst: PageRef


class ExpertPageTable:
    """Tracks (layer, expert) -> PageRef for the active and staged
    configs.  At most one staged remap is open at a time."""

    def __init__(self, num_layers: int, num_experts: int,
                 pool_pages_per_device: int = 0):
        self.num_layers = num_layers
        self.num_experts = num_experts
        # default: room for every page twice (staging headroom) on one device
        self.pool_pages = pool_pages_per_device or 2 * num_layers * num_experts
        self.active: Dict[Tuple[int, int], PageRef] = {}
        self.staged: Optional[Dict[Tuple[int, int], PageRef]] = None
        self._free: Dict[int, List[int]] = {}

    def _ensure_pool(self, device: int):
        if device not in self._free:
            self._free[device] = list(range(self.pool_pages))

    def _alloc(self, device: int) -> int:
        self._ensure_pool(device)
        if not self._free[device]:
            raise MemoryError(f"page pool on device {device} exhausted")
        return self._free[device].pop()

    def pages_in_use(self, device: int) -> int:
        self._ensure_pool(device)
        return self.pool_pages - len(self._free[device])

    def clone(self) -> "ExpertPageTable":
        """An independent copy for what-if staging (the driver's cost
        projections): the active and staged maps and the free lists are
        copied, so staging on the clone leaves this table as it was
        (``PageRef``s are immutable and shared)."""
        t = ExpertPageTable(self.num_layers, self.num_experts,
                            pool_pages_per_device=self.pool_pages)
        t.active = dict(self.active)
        t.staged = dict(self.staged) if self.staged is not None else None
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
        ``MemoryError`` with the pool as before the call."""
        if self.staged is not None:
            raise RuntimeError(
                "a staged remap is already open; commit() or abort() it "
                "before staging another one")
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
                    ref = self.active[(l, e)]
                    if caps.get(ref.device, 0) > 0:
                        staged[(l, e)] = ref              # stays in place
                        caps[ref.device] -= 1
                    else:
                        pending.append((e, ref))
                for e, ref in pending:                    # most room first
                    dst_dev = max(caps, key=lambda d: caps[d])
                    caps[dst_dev] -= 1
                    dst = PageRef(dst_dev, self._alloc(dst_dev))
                    staged[(l, e)] = dst
                    migrations.append(Migration(l, e, ref, dst))
            self.staged = staged
            return migrations
        except BaseException:
            for m in migrations:          # the pool as before the call
                self._free[m.dst.device].append(m.dst.page)
            raise

    def commit(self) -> List[PageRef]:
        """Switch to the staged table; returns the pages freed (the old
        homes of migrated experts)."""
        if self.staged is None:
            raise RuntimeError("no staged remap open; call stage_remap() "
                               "before commit()")
        to_free: List[PageRef] = []
        for key, old_ref in self.active.items():
            if self.staged[key] != old_ref:
                self._free[old_ref.device].append(old_ref.page)
                to_free.append(old_ref)
        self.active = self.staged
        self.staged = None
        return to_free

    def abort(self) -> None:
        """Drop the staged table, freeing its fresh pages.  Idempotent;
        pages the active table also holds are never freed, and each staged
        page is freed once."""
        if self.staged is None:
            return
        live = set(self.active.values())
        freed = set()
        for ref in self.staged.values():
            if ref not in live and ref not in freed:
                freed.add(ref)
                self._ensure_pool(ref.device)
                self._free[ref.device].append(ref.page)
        self.staged = None

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
                  slots_per_rank: Optional[int] = None
                  ) -> Dict[str, np.ndarray]:
    """Flatten a page-table mapping into the index arrays the pooled MoE
    path consumes (host-side numpy), as the reference builds them without
    replicas:

    * ``tables`` [L, ndev, Elm] int32 — per (layer, device-rank) the LOCAL
      pool-page index of each owned expert, logical-expert order, padded
      with page 0 (pad slots receive no tokens), ``Elm = slots_per_rank or
      ceil(E / ndev)`` (min-move keeps each device's count within that);
    * ``edest``  [L, E] int32 — serving device rank per expert;
    * ``eslot``  [L, E] int32 — the expert's slot within its rank's table;
    * ``gtable`` [L, E] int32 — GLOBAL pool row (rank * pages_per_device +
      local page) per expert, for the single-shard pooled path.
    """
    ndev = cfg.ndev
    elm = slots_per_rank or math.ceil(num_experts / ndev)
    tables = np.zeros((num_layers, ndev, elm), np.int32)
    edest = np.zeros((num_layers, num_experts), np.int32)
    eslot = np.zeros((num_layers, num_experts), np.int32)
    gtable = np.zeros((num_layers, num_experts), np.int32)
    for l in range(num_layers):
        counts = [0] * ndev
        for e in range(num_experts):          # ascending e == logical order
            ref = table[(l, e)]
            r = cfg.slot(ref.device)
            s = counts[r]
            if s >= elm:
                raise ValueError(f"layer {l}: rank {r} owns more than "
                                 f"{elm} experts")
            counts[r] += 1
            tables[l, r, s] = ref.page
            edest[l, e] = r
            eslot[l, e] = s
            gtable[l, e] = r * pages_per_device + ref.page
    return {"tables": tables, "edest": edest, "eslot": eslot,
            "gtable": gtable}
