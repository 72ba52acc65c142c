"""Skew-aware expert rebalance policy — the port's own copy of
``repro.serving.rebalance``.

Host-side decision logic: ``ElasticServer`` runs it through an HMM
rebalance session.  The policy reads the routing histogram
(``routing_stats()``: [L_moe, E] token counts) and emits
``ExpertPageTable.stage_rebalance`` actions:

* **replicate** a hot expert (per-layer share > ``hot_factor``/E) onto the
  device carrying the least routed load, up to ``max_replicas`` extra
  copies, within the table width's slot slack;
* **demote** a cold expert (share < ``cold_factor``/E) into the pinned-host
  tier: its device primary keeps serving, and at the next scale event it
  is copied back host-to-device instead of between devices;
* **drop_replica** / **promote** undo the above when an expert's share
  falls back below / climbs back above the fair share 1/E.

With ``hot_factor > 1 > cold_factor`` an expert crosses different
thresholds to gain and to lose a copy (gain at ``hot_factor``/E, lose at
1/E; demote at ``cold_factor``/E, promote at 1/E), so shares near either
threshold do not flap.  ``cooldown_s`` spaces the passes, and
``min_samples`` keeps the policy from acting on a young histogram.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class RebalancePolicy:
    """Decides rebalance actions from a routing histogram.

    Thresholds are factors of the uniform share 1/E (per layer):
    ``hot_factor=2.0`` means "twice the fair share".  ``max_actions``
    bounds one pass so a single decision never stages an unbounded
    transfer batch."""
    hot_factor: float = 2.0
    cold_factor: float = 0.25
    min_samples: int = 4
    cooldown_s: float = 0.0
    max_replicas: int = 1
    max_actions: int = 8
    _last_t: Optional[float] = dataclasses.field(default=None, repr=False)

    def decide(self, stats: Optional[dict], page_table, cfg, now: float,
               slots_per_rank: Optional[int] = None) -> List[Tuple]:
        """Actions for ``ExpertPageTable.stage_rebalance`` (possibly empty).

        ``stats``: ``routing_stats()`` dict (``counts`` [L_moe, E] aligned
        with the page table's layer indices).  ``slots_per_rank``: compiled
        table width per rank; replications that would overflow any rank's
        slot budget are skipped (the table-width slack is the hard bound).
        An accepted pass records ``now`` for the cooldown clock."""
        if stats is None or stats.get("samples", 0) < self.min_samples:
            return []
        if self._last_t is not None and self.cooldown_s > 0 \
                and now - self._last_t < self.cooldown_s:
            return []
        counts = np.asarray(stats["counts"], np.float64)
        L, E = counts.shape
        ndev = cfg.ndev
        if ndev < 2:
            return []          # nowhere to replicate, nothing to balance
        fair = 1.0 / E
        # per-rank copy counts (primary + replicas) per layer, for the
        # slot-budget feasibility check
        copies: Dict[Tuple[int, int], int] = {}
        for (l, e), ref in page_table.active.items():
            r = cfg.slot(ref.device)
            copies[(l, r)] = copies.get((l, r), 0) + 1
        for (l, e), refs in page_table.replicas.items():
            for ref in refs:
                r = cfg.slot(ref.device)
                copies[(l, r)] = copies.get((l, r), 0) + 1
        # routed load per rank per layer under the CURRENT placement — the
        # least-loaded rank is the replication target
        rank_load = np.zeros((L, ndev), np.float64)
        for (l, e), ref in page_table.active.items():
            if l < L:
                rank_load[l, cfg.slot(ref.device)] += counts[l, e]

        actions: List[Tuple] = []

        def room(l: int, r: int) -> bool:
            return (slots_per_rank is None
                    or copies.get((l, r), 0) < slots_per_rank)

        for l in range(L):
            tot = max(counts[l].sum(), 1.0)
            share = counts[l] / tot
            # hottest-first so the bounded action budget goes to the worst
            # offenders; coldest-first for demotions likewise
            for e in np.argsort(-share):
                e = int(e)
                if len(actions) >= self.max_actions:
                    break
                key = (l, e)
                nrep = page_table.replica_count(l, e)
                holders = {page_table.active[key].device}
                holders.update(ref.device
                               for ref in page_table.replicas.get(key, ()))
                if share[e] > self.hot_factor * fair:
                    if key in page_table.host:
                        actions.append(("promote", l, e))   # hot again
                        continue
                    if nrep >= self.max_replicas:
                        continue
                    cand = [r for r in range(ndev)
                            if cfg.devices[r] not in holders and room(l, r)]
                    if cand:
                        r = min(cand, key=lambda r: (rank_load[l, r], r))
                        copies[(l, r)] = copies.get((l, r), 0) + 1
                        actions.append(
                            ("replicate", l, e, cfg.devices[r]))
                elif share[e] < fair and nrep > 0:
                    # fell back below average: retire the newest replica
                    ref = page_table.replicas[key][-1]
                    copies[(l, cfg.slot(ref.device))] -= 1
                    actions.append(("drop_replica", l, e, ref.device))
                elif share[e] < self.cold_factor * fair \
                        and key not in page_table.host and nrep == 0:
                    actions.append(("demote", l, e))
                elif share[e] > fair and key in page_table.host:
                    actions.append(("promote", l, e))
            if len(actions) >= self.max_actions:
                break
        if actions:
            self._last_t = now
        return actions[: self.max_actions]


def max_rank_load(counts: np.ndarray, edest: np.ndarray,
                  ndev: int) -> float:
    """Layer-averaged max per-rank routed-token share under a serving
    assignment — the imbalance metric the rebalancer lowers.  ``counts``
    [L, E] token counts, ``edest`` [L, E] serving rank per expert."""
    L, E = counts.shape
    out = 0.0
    for l in range(L):
        tot = max(float(counts[l].sum()), 1.0)
        loads = np.zeros(ndev, np.float64)
        for e in range(E):
            loads[int(edest[l, e])] += counts[l, e]
        out += loads.max() / tot
    return out / max(L, 1)
