"""Minimal-cost scaling plans — the port's own copy of
``repro.core.scaling_plan`` (paper §4.4, Fig. 6).

Given (old ``ElasticConfig`` | None, new ``ElasticConfig``) and the
model's logical tensors (``core/topology.py:model_tensors``), a plan says
for every shard of the target one of:

* ``ZERO_COPY`` — the device already holds the bytes; the new instance
  reuses them (in the port: the same tensor);
* ``P2P``       — copy from a device that holds identical bytes;
* ``DISK``      — load from storage (first boot, or the baselines);
* ``HOST``      — copy from the pinned-host tier: a demoted expert that
  must move is copied host-to-device instead of between devices;
* ``INIT``      — fresh allocation of state (the KV cache of new replicas);
* ``FREE``      — release after the switchover.

The planner prefers zero-copy > P2P > disk for every shard that exists
anywhere (TP stays fixed, paper §4.1).  ``STRATEGIES`` holds the paper's
baselines beside it.  ``core/costmodel.py`` prices a plan.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.topology import ElasticConfig, TensorDesc, expert_owner


class Op(enum.Enum):
    ZERO_COPY = "zero_copy"
    P2P = "p2p"
    DISK = "disk"
    HOST = "host"
    INIT = "init"
    FREE = "free"


@dataclasses.dataclass(frozen=True)
class ShardKey:
    """Identifies shard *content* (not placement)."""
    tensor: str
    part: int        # tp_rank for 'tp', 0 for replicated/expert, dp_rank for kv


@dataclasses.dataclass(frozen=True)
class PlanStep:
    op: Op
    key: ShardKey
    nbytes: int
    dst: int                    # device id
    src: Optional[int] = None   # device id for P2P


@dataclasses.dataclass
class ScalingPlan:
    steps: List[PlanStep]
    old: Optional[ElasticConfig]
    new: ElasticConfig

    def bytes_by_op(self) -> Dict[Op, int]:
        out: Dict[Op, int] = defaultdict(int)
        for s in self.steps:
            out[s.op] += s.nbytes
        return dict(out)

    def host_bytes_per_device(self) -> Dict[int, int]:
        """Destination device -> bytes it takes from the pinned-host tier."""
        out: Dict[int, int] = defaultdict(int)
        for s in self.steps:
            if s.op == Op.HOST:
                out[s.dst] += s.nbytes
        return dict(out)


# ---------------------------------------------------------------- placement

def placement(tensors: Sequence[TensorDesc],
              cfg: ElasticConfig,
              expert_assignment: Optional[Dict[Tuple[int, int], int]] = None
              ) -> Dict[int, Dict[ShardKey, int]]:
    """device -> {shard_key -> nbytes} under ``cfg``.

    ``expert_assignment``: optional {(layer, expert) -> device} from the
    virtual page table (min-move placement); defaults to the contiguous
    ``expert_owner`` layout the dense-array execution path uses."""
    num_experts = 1 + max((t.expert for t in tensors if t.kind == "expert"),
                          default=0)
    out: Dict[int, Dict[ShardKey, int]] = {d: {} for d in cfg.devices}
    for t in tensors:
        if t.kind == "replicated":
            for d in cfg.devices:
                out[d][ShardKey(t.name, 0)] = t.nbytes
        elif t.kind == "tp":
            for d in cfg.devices:
                out[d][ShardKey(t.name, cfg.tp_rank(d))] = t.nbytes
        elif t.kind == "expert":
            if expert_assignment is not None:
                d = expert_assignment[(t.layer, t.expert)]
            else:
                d = expert_owner(t.expert, num_experts, cfg)
            out[d][ShardKey(t.name, 0)] = t.nbytes
        elif t.kind == "kv":
            for d in cfg.devices:
                out[d][ShardKey(t.name, cfg.dp_rank(d) * cfg.tp
                                + cfg.tp_rank(d))] = t.nbytes
        else:
            raise ValueError(t.kind)
    return out


# ------------------------------------------------------------------ planner

def plan_elastic(tensors: Sequence[TensorDesc],
                 old: Optional[ElasticConfig],
                 new: ElasticConfig,
                 expert_assignment_old=None,
                 expert_assignment_new=None,
                 host_resident: Optional[set] = None) -> ScalingPlan:
    """ElasticMoE's planner: zero-copy > P2P > disk; KV reused or INIT.

    The expert assignments ({(layer, expert) -> device}) are a page
    table's min-move placement; the default is the contiguous layout of
    the dense expert banks.  ``host_resident``: the (layer, expert) keys
    with a copy in the pinned-host tier; such an expert that must move is
    an ``Op.HOST`` step (copied host-to-device), not P2P, as
    ``HMM._migrate_pool_bank`` copies it."""
    if old is not None and old.tp != new.tp:
        raise ValueError("ElasticMoE scales DP and EP only; TP is fixed "
                         "(paper §4.1)")
    new_place = placement(tensors, new, expert_assignment_new)
    old_place = placement(tensors, old, expert_assignment_old) if old else {}
    kv_names = {t.name for t in tensors if t.kind == "kv"}
    host_names = {t.name for t in tensors if t.kind == "expert"
                  and (t.layer, t.expert) in (host_resident or ())}

    # content -> devices holding it under the old config
    holders: Dict[ShardKey, List[int]] = defaultdict(list)
    for d, shards in old_place.items():
        for key in shards:
            holders[key].append(d)

    steps: List[PlanStep] = []
    rr: Dict[ShardKey, int] = defaultdict(int)  # round-robin source pick
    for d, shards in new_place.items():
        for key, nbytes in shards.items():
            if d in old_place and key in old_place[d]:
                steps.append(PlanStep(Op.ZERO_COPY, key, nbytes, dst=d))
            elif key.tensor in kv_names:
                steps.append(PlanStep(Op.INIT, key, nbytes, dst=d))
            elif key.tensor in host_names:
                steps.append(PlanStep(Op.HOST, key, nbytes, dst=d))
            elif holders.get(key):
                srcs = holders[key]
                src = srcs[rr[key] % len(srcs)]
                rr[key] += 1
                steps.append(PlanStep(Op.P2P, key, nbytes, dst=d, src=src))
            else:
                steps.append(PlanStep(Op.DISK, key, nbytes, dst=d))

    # frees: anything held before but not needed after (applied post-switch)
    for d, shards in old_place.items():
        for key, nbytes in shards.items():
            if d not in new_place or key not in new_place[d]:
                steps.append(PlanStep(Op.FREE, key, nbytes, dst=d))
    return ScalingPlan(steps, old, new)


# ------------------------------------------------------- baseline strategies

def _check_disjoint(old, new) -> None:
    if old is not None and set(old.devices) & set(new.devices):
        raise ValueError(f"{new.describe()} must use devices disjoint from "
                         f"{old.describe()}")


def plan_cold_restart(tensors, old, new) -> ScalingPlan:
    """Tear down, then disk-load everything (downtime = full boot)."""
    steps: List[PlanStep] = []
    if old:
        for d, shards in placement(tensors, old).items():
            for key, nbytes in shards.items():
                steps.append(PlanStep(Op.FREE, key, nbytes, dst=d))
    kv_names = {t.name for t in tensors if t.kind == "kv"}
    for d, shards in placement(tensors, new).items():
        for key, nbytes in shards.items():
            op = Op.INIT if key.tensor in kv_names else Op.DISK
            steps.append(PlanStep(op, key, nbytes, dst=d))
    return ScalingPlan(steps, old, new)


def plan_extravagant(tensors, old, new) -> ScalingPlan:
    """New instance on *fresh* devices, old keeps running until ready.

    ``new.devices`` must be disjoint from ``old.devices``."""
    _check_disjoint(old, new)
    kv_names = {t.name for t in tensors if t.kind == "kv"}
    steps: List[PlanStep] = []
    for d, shards in placement(tensors, new).items():
        for key, nbytes in shards.items():
            op = Op.INIT if key.tensor in kv_names else Op.DISK
            steps.append(PlanStep(op, key, nbytes, dst=d))
    if old:
        for d, shards in placement(tensors, old).items():
            for key, nbytes in shards.items():
                steps.append(PlanStep(Op.FREE, key, nbytes, dst=d))
    return ScalingPlan(steps, old, new)


def plan_colocated(tensors, old, new) -> ScalingPlan:
    """New instance disk-loads onto (a superset of) the same devices while
    the old copy stays resident -> double weights on shared devices."""
    kv_names = {t.name for t in tensors if t.kind == "kv"}
    steps: List[PlanStep] = []
    for d, shards in placement(tensors, new).items():
        for key, nbytes in shards.items():
            op = Op.INIT if key.tensor in kv_names else Op.DISK
            steps.append(PlanStep(op, key, nbytes, dst=d))
    if old:
        for d, shards in placement(tensors, old).items():
            for key, nbytes in shards.items():
                steps.append(PlanStep(Op.FREE, key, nbytes, dst=d))
    return ScalingPlan(steps, old, new)


def plan_horizontal(tensors, old, new_replica: ElasticConfig) -> ScalingPlan:
    """Add an independent full replica on fresh devices (old untouched)."""
    _check_disjoint(old, new_replica)
    kv_names = {t.name for t in tensors if t.kind == "kv"}
    steps = []
    for d, shards in placement(tensors, new_replica).items():
        for key, nbytes in shards.items():
            op = Op.INIT if key.tensor in kv_names else Op.DISK
            steps.append(PlanStep(op, key, nbytes, dst=d))
    return ScalingPlan(steps, old, new_replica)


def plan_unpark(tensors, new: ElasticConfig) -> ScalingPlan:
    """A cold start from the parked snapshot (scale to zero): every weight
    shard of ``new`` comes from the pinned-host tier (``Op.HOST``, one lane
    per destination device), the KV cache is a fresh ``INIT``.  No disk
    and no P2P: the unpark is bounded by the host link."""
    kv_names = {t.name for t in tensors if t.kind == "kv"}
    steps: List[PlanStep] = []
    for d, shards in placement(tensors, new).items():
        for key, nbytes in shards.items():
            op = Op.INIT if key.tensor in kv_names else Op.HOST
            steps.append(PlanStep(op, key, nbytes, dst=d))
    return ScalingPlan(steps, None, new)


STRATEGIES = {
    "elastic": plan_elastic,
    "cold_restart": plan_cold_restart,
    "extravagant": plan_extravagant,
    "colocated": plan_colocated,
    "horizontal": plan_horizontal,
}


def plan_elastic_paged(tensors, old, new, page_table,
                       first_k_dense: int = 0) -> ScalingPlan:
    """The elastic plan over the page table's min-move expert placement.
    Stages the remap on ``page_table`` (the caller commits or aborts it,
    or passes a clone); a pool that cannot take the target's pages raises
    ``MemoryError`` from ``stage_remap``.  An expert kept in place through
    any of its copies (primary or replica) is a zero-copy step; a moved
    expert with a copy in the table's pinned-host tier is an ``Op.HOST``
    step, the others P2P — as ``HMM._migrate_pool_bank`` counts them."""
    host = {(l + first_k_dense, e) for (l, e) in page_table.host}
    page_table.stage_remap(new)
    a_old, a_new = {}, {}
    for (l, e), ref in page_table.staged.items():
        a_new[(l + first_k_dense, e)] = ref.device
        resident = {page_table.active[(l, e)]}
        resident.update(page_table.replicas.get((l, e), ()))
        a_old[(l + first_k_dense, e)] = (
            ref.device if ref in resident
            else page_table.active[(l, e)].device)
    return plan_elastic(tensors, old, new,
                        expert_assignment_old=a_old,
                        expert_assignment_new=a_new,
                        host_resident=host)


def plan_elastic_min_move(tensors, old: ElasticConfig, new: ElasticConfig,
                          mcfg) -> ScalingPlan:
    """``plan_elastic_paged`` from a fresh contiguous placement at ``old``:
    the projection for a caller with no live page table (a server booted
    at ``old``, remapped min-move to ``new``)."""
    from repro_torch.core.expert_pages import ExpertPageTable
    table = ExpertPageTable(mcfg.num_layers - mcfg.first_k_dense,
                            mcfg.num_experts)
    table.initial_place(old)
    return plan_elastic_paged(tensors, old, new, table,
                              first_k_dense=mcfg.first_k_dense)
