"""Virtual expert pages — the port's own copy of the parts of
``repro.core.expert_pages`` the one-card serving path uses.

Each device owns a fixed page *pool* (one page = one (layer, expert) weight
block) plus a page *table* mapping logical experts to pool rows.  The paged
grouped-matmul kernel (``kernels/moe_gmm.py``) reads pages through the
table, so an expert remap rewrites the table and moves no weight bytes.
Staged remaps, replicas and the pinned-host tier belong to the multi-card
slice and are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.topology import ElasticConfig, expert_owner


@dataclasses.dataclass(frozen=True)
class PageRef:
    device: int
    page: int          # index into that device's pool


class ExpertPageTable:
    """Tracks (layer, expert) -> PageRef for the active config."""

    def __init__(self, num_layers: int, num_experts: int,
                 pool_pages_per_device: int = 0):
        self.num_layers = num_layers
        self.num_experts = num_experts
        # default: room for every page twice (staging headroom) on one device
        self.pool_pages = pool_pages_per_device or 2 * num_layers * num_experts
        self.active: Dict[Tuple[int, int], PageRef] = {}
        self._free: Dict[int, List[int]] = {}

    def _alloc(self, device: int) -> int:
        if device not in self._free:
            self._free[device] = list(range(self.pool_pages))
        if not self._free[device]:
            raise MemoryError(f"page pool on device {device} exhausted")
        return self._free[device].pop()

    def initial_place(self, cfg: ElasticConfig) -> None:
        """First boot: allocate a page per (layer, expert) on its owner."""
        assert not self.active
        for l in range(self.num_layers):
            for e in range(self.num_experts):
                d = expert_owner(e, self.num_experts, cfg)
                self.active[(l, e)] = PageRef(d, self._alloc(d))

    def device_table(self, cfg: ElasticConfig, layer: int,
                     device: int) -> List[int]:
        """Pool indices of the experts ``device`` owns for ``layer``, in
        logical expert order — the indirection vector the MoE kernel reads."""
        rows = [(e, ref.page) for (l, e), ref in self.active.items()
                if l == layer and ref.device == device]
        rows.sort()
        return [p for _, p in rows]


def pooled_layout(table: Dict[Tuple[int, int], PageRef], cfg: ElasticConfig,
                  num_layers: int, num_experts: int,
                  pages_per_device: int) -> Dict[str, np.ndarray]:
    """Flatten a page-table mapping into the index arrays the pooled MoE
    path consumes (host-side numpy), as the reference builds them without
    replicas:

    * ``tables`` [L, ndev, Elm] int32 — per (layer, device-rank) the LOCAL
      pool-page index of each owned expert, logical-expert order, padded
      with page 0 (pad slots receive no tokens), ``Elm = ceil(E / ndev)``;
    * ``edest``  [L, E] int32 — serving device rank per expert;
    * ``eslot``  [L, E] int32 — the expert's slot within its rank's table;
    * ``gtable`` [L, E] int32 — GLOBAL pool row (rank * pages_per_device +
      local page) per expert, for the single-shard pooled path.
    """
    ndev = cfg.ndev
    elm = math.ceil(num_experts / ndev)
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
