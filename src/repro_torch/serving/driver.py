"""The closed-loop autoscaling driver — the port's own copy of
``repro.serving.driver``: the scaling task's phases, the shared admission
gate, and the paper's Coordinator loop (§4.3).

One ``ClusterDriver`` owns a ``DevicePool``, feeds finished requests to
the SLO-aware ``LoadEstimator`` (``core/coordinator.py``), picks the next
``ElasticConfig`` with the cost model (``transition_cost``), and runs the
transition as a resumable ``ScalingTask``, one non-blocking poll a serving
tick, so the server keeps producing tokens while it scales.  It runs over
any ``ServingBackend``; the port's is ``core/elastic_engine.ElasticServer``.

The driver's clock is virtual, as the reference's: ``run`` advances ``t``
by ``DriverConfig.dt`` a tick and hands it to ``backend.step``, whatever
the tick took on the wall, so every timestamp of a request, the SLO and
every ``DriverEvent.t`` are in driver seconds.  ``projected_scale_s`` is
the cost model's time on the paper's cluster (``core/costmodel.py``), not
the card's.

A rung of the ladder may be a single device: the port's server scales
from and to one device as the reference's does (``core/hmm.py``'s
one-device note).

Lifecycle of a ``ScalingTask``::

    IDLE -> STAGING -> COMPILING -> [MIGRATING | DRAINING]
                                          -> COMMITTING -> DONE
                \\________________________________________/-> ABORTED

MIGRATING/DRAINING only occur on a scale-down: with paged KV and
``scaledown="migrate"`` (the default) live sequences' KV blocks are copied
onto survivor partitions in the background and the doomed devices release
as soon as the copies land; ``scaledown="drain"`` (and the dense layout)
lets the doomed slots run to completion.  Every arrow is taken by an
``advance(now)`` call between serving ticks.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import (Dict, List, Optional, Protocol, Sequence, Tuple, Union,
                    runtime_checkable)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.coordinator import LoadEstimator, ScalingPolicy
from repro_torch.core.costmodel import plan_cost, unpark_cost
from repro_torch.core.scaling_plan import (STRATEGIES, placement,
                                           plan_elastic_min_move,
                                           plan_elastic_paged, plan_unpark)
from repro_torch.core.topology import (ElasticConfig, kv_cache_bytes,
                                       model_tensors)
from repro_torch.serving.metrics import latency_percentiles
from repro_torch.serving.workload import Request, merge_arrivals


class ScalePhase(enum.Enum):
    STAGING = "staging"        # weights moving; serving continues
    COMPILING = "compiling"    # IMM: the target's step functions
    MIGRATING = "migrating"    # scale-down: live KV blocks copy to survivors
    DRAINING = "draining"      # scale-down: doomed slots run to completion
    COMMITTING = "committing"  # switchover: the new instance takes traffic
    DONE = "done"
    ABORTED = "aborted"

    @property
    def terminal(self) -> bool:
        return self in (ScalePhase.DONE, ScalePhase.ABORTED)


class ScalingTask(Protocol):
    """A resumable scaling transition.  ``advance`` is a non-blocking
    completion poll: it observes progress, moves the phase machine on when
    a phase has completed, and returns the current phase; the caller may
    serve a tick between any two polls."""
    target: ElasticConfig
    phase: ScalePhase

    def advance(self, now: float) -> ScalePhase: ...


def admission_during_scale(strategy: str) -> Tuple[str, bool]:
    """Admission while a transition is in flight: ``(capacity,
    admit_new)``, capacity ``'old'`` (the old instance keeps serving) or
    ``'none'`` (downtime).

    * elastic / colocated — the old instance serves, new admissions pause
      until the switchover,
    * extravagant / horizontal — the old instance is untouched, admissions
      continue (the new devices are extra),
    * cold_restart — the old instance is torn down first: downtime."""
    if strategy == "cold_restart":
        return "none", False
    if strategy in ("extravagant", "horizontal"):
        return "old", True
    return "old", False


def projected_migration_blocks(used_blocks: float, old_dp: int,
                               new_dp: int) -> int:
    """The blocks a scale-down's projection moves: the doomed partitions'
    share of the current occupancy (slots fill partition-major and
    admission pauses during the transition, so occupancy is about uniform
    over the partitions).  The server migrates the exact per-sequence
    block sets; the ``DriverEvent`` records both."""
    if new_dp >= old_dp or old_dp <= 0:
        return 0
    return int(math.ceil(used_blocks * (old_dp - new_dp) / old_dp))


def transition_plan(mcfg: ModelConfig, tp: int, old: ElasticConfig,
                    new: ElasticConfig, *, strategy: str = "elastic",
                    kv_seq_len: int = 4096, kv_batch: int = 8,
                    expert_mode: str = "dense", page_table=None,
                    kv_dtype: Optional[str] = None,
                    expert_dtype: Optional[str] = None):
    """The plan of one transition and the devices' resident bytes before
    it: ``(scaling_plan.ScalingPlan, {device: bytes})``.

    ``expert_mode='pooled'`` plans the elastic transition over the
    min-move expert placement (``plan_elastic_paged``): only the experts
    that move count as P2P bytes.  ``page_table`` is the server's live
    table, so the plan starts from its actual, possibly non-contiguous
    placement; it is cloned, never changed.  Without one (or while it has
    a remap staged), a fresh contiguous placement at ``old`` is assumed.
    ``kv_dtype`` / ``expert_dtype`` ('int8') size the KV and the expert
    pages at their storage width, scales included."""
    kvb = kv_cache_bytes(mcfg, kv_batch, kv_seq_len, kv_dtype=kv_dtype)
    tensors = model_tensors(mcfg, tp, kv_bytes_per_replica=kvb,
                            expert_dtype=expert_dtype)
    if (expert_mode == "pooled" and mcfg.is_moe and old is not None
            and strategy == "elastic"):
        if page_table is not None and page_table.staged is None:
            plan = plan_elastic_paged(tensors, old, new, page_table.clone(),
                                      first_k_dense=mcfg.first_k_dense)
        else:
            plan = plan_elastic_min_move(tensors, old, new, mcfg)
    else:
        plan = STRATEGIES[strategy](tensors, old, new)
    resident = {d: sum(s.values())
                for d, s in placement(tensors, old).items()}
    return plan, resident


def transition_cost(mcfg: ModelConfig, tp: int, old: ElasticConfig,
                    new: ElasticConfig, *, strategy: str = "elastic",
                    preinit: bool = True, staging: str = "serial",
                    kv_migration_bytes: int = 0, **plan_kw):
    """Plan and cost of one transition (a ``costmodel.ScalingCost``): the
    ``ClusterDriver`` ranks and vetoes its candidate targets with it.
    ``plan_kw`` are ``transition_plan``'s.  ``staging`` projects the
    serial or the overlapped transfers (``costmodel.plan_cost``);
    ``kv_migration_bytes``: a migrating scale-down's KV copies
    (``projected_migration_blocks`` x the block's bytes)."""
    plan, resident = transition_plan(mcfg, tp, old, new, strategy=strategy,
                                     **plan_kw)
    return plan_cost(plan, preinit=preinit, strategy=strategy,
                     resident_bytes_per_device=resident, staging=staging,
                     kv_migration_bytes=kv_migration_bytes)


def unpark_transition_cost(mcfg: ModelConfig, tp: int, new: ElasticConfig,
                           *, preinit: bool = True, staging: str = "overlap",
                           kv_seq_len: int = 4096,
                           kv_dtype: Optional[str] = None,
                           expert_dtype: Optional[str] = None):
    """Plan and cost of a cold start from the parked snapshot at ``new``
    (a ``costmodel.ScalingCost`` whose ``downtime_s`` is its scale time):
    the ``FleetDriver``'s unpark projection, as ``transition_cost`` is its
    scale projection.  The KV is priced at a batch of 8, as
    ``transition_plan``'s default."""
    kvb = kv_cache_bytes(mcfg, 8, kv_seq_len, kv_dtype=kv_dtype)
    tensors = model_tensors(mcfg, tp, kv_bytes_per_replica=kvb,
                            expert_dtype=expert_dtype)
    return unpark_cost(plan_unpark(tensors, new), preinit=preinit,
                       staging=staging)


# ------------------------------------------------------------- device pool

class DevicePool:
    """Who owns which device id.  Every id of the pool belongs to one
    owner (a model name) or is free; a claim that would book a device
    twice, or a release by another owner, raises ``ValueError``.
    ``check_invariants`` asserts conservation: owned and free make up the
    pool, with no device in both and none leaked."""

    def __init__(self, devices: Sequence[int]):
        devs = tuple(int(d) for d in devices)
        if len(set(devs)) != len(devs):
            raise ValueError(f"duplicate device ids in pool: {devs}")
        self.devices: Tuple[int, ...] = devs
        self._known = frozenset(devs)
        self._owner: Dict[int, str] = {}

    def claim(self, owner: str, devs: Sequence[int]) -> Tuple[int, ...]:
        """Atomically claim ``devs`` for ``owner``.  Raises ValueError if
        any device is outside the pool or already owned (by anyone,
        including ``owner`` itself — a double-claim is a bookkeeping bug,
        not a no-op)."""
        devs = tuple(int(d) for d in devs)
        for d in devs:
            if d not in self._known:
                raise ValueError(f"device {d} is not in the pool "
                                 f"{self.devices}")
            holder = self._owner.get(d)
            if holder is not None:
                raise ValueError(
                    f"device {d} already owned by {holder!r} — refusing to "
                    f"double-book it for {owner!r}")
        if len(set(devs)) != len(devs):
            raise ValueError(f"duplicate device ids in claim: {devs}")
        for d in devs:
            self._owner[d] = owner
        return devs

    def release(self, owner: str, devs: Sequence[int]) -> None:
        """Return ``devs`` to the free set.  Raises ValueError unless every
        device is currently owned by ``owner``."""
        devs = tuple(int(d) for d in devs)
        for d in devs:
            holder = self._owner.get(d)
            if holder != owner:
                raise ValueError(
                    f"device {d} is owned by {holder!r}, not {owner!r} — "
                    f"refusing the release")
        for d in devs:
            del self._owner[d]

    def owned(self, owner: str) -> Tuple[int, ...]:
        return tuple(d for d in self.devices if self._owner.get(d) == owner)

    def free(self) -> Tuple[int, ...]:
        return tuple(d for d in self.devices if d not in self._owner)

    def owners(self) -> Dict[int, str]:
        return dict(self._owner)

    def check_invariants(
            self, leases: Optional[Dict[str, Sequence[int]]] = None) -> None:
        """Pool conservation: every device is free xor owned by exactly one
        model; nothing outside the pool is tracked.  ``leases``: the
        caller's {owner -> devices} view, asserted to agree with the
        allocator exactly."""
        for d in self._owner:
            assert d in self._known, f"unknown device {d} tracked"
        free = set(self.free())
        owned = set(self._owner)
        assert not (free & owned), f"devices both free and owned: {free & owned}"
        assert free | owned == self._known, \
            f"devices leaked: {self._known - free - owned}"
        if leases is not None:
            seen: Dict[int, str] = {}
            for owner, devs in leases.items():
                for d in devs:
                    assert d not in seen, \
                        f"device {d} leased to both {seen[d]!r} and {owner!r}"
                    seen[d] = owner
                    assert self._owner.get(d) == owner, \
                        f"lease says {owner!r} holds {d}, allocator says " \
                        f"{self._owner.get(d)!r}"
            assert set(seen) == owned, \
                f"allocator/lease mismatch: {set(seen) ^ owned}"


@runtime_checkable
class ServingBackend(Protocol):
    """What the ClusterDriver needs from a serving system; the port's
    ``core/elastic_engine.ElasticServer`` implements it.  The reference's
    protocol also asks for ``routing_stats`` (routing telemetry, not
    ported): the driver reads it through ``getattr`` and records None."""

    def submit(self, req: Request) -> None: ...

    def step(self, now: float) -> List[Request]:
        """Serve one tick/quantum ending at ``now``; returns requests that
        finished during it."""
        ...

    def queue_depth(self) -> int: ...

    def utilization(self) -> float:
        """Fraction of serving capacity currently occupied, in [0, 1]."""
        ...

    def current_config(self) -> ElasticConfig: ...

    def start_scale(self, target: ElasticConfig) -> ScalingTask: ...

    def prewarm(self, target: ElasticConfig) -> None:
        """Optional: pre-initialize a standby instance for ``target``."""
        ...

    def capacity(self, cfg: ElasticConfig) -> int:
        """Concurrent-request capacity of ``cfg`` on this backend."""
        ...

    def kv_stats(self) -> Optional[dict]:
        """The paged pool's stats (num_blocks / used_blocks / utilization
        / preemptions / block_bytes), or None with dense KV."""
        ...


# ------------------------------------------------------------------ driver

@dataclasses.dataclass
class DriverConfig:
    """Target-selection and pacing knobs for the ClusterDriver."""
    dt: float = 0.05               # driver tick quantum, seconds
    max_step_dp: int = 2           # furthest rung considered per decision
    min_dp: int = 1
    settle_s: float = 0.0          # extra hysteresis after a completed scale
    prewarm_next: bool = True      # keep a standby instance one rung up


@dataclasses.dataclass
class DriverEvent:
    t: float
    direction: str                 # 'up' | 'down'
    src: str
    dst: str
    projected_scale_s: float       # cost-model projection used for selection
    kv_util: Optional[float] = None    # block-pool occupancy at decision
    preemptions: int = 0               # cumulative, at decision time
    staging: Optional[str] = None      # staging mode used for the projection
    # filled in when the ScalingTask completes (None until then / if the
    # backend does not report them): serve-loop time lost to staging work,
    # Σ transfer-op time / staging wall-clock (>1 = real overlap), and the
    # zero-drain scale-down's live KV-block migration volume
    stall_s: Optional[float] = None
    overlap_eff: Optional[float] = None
    migrated_blocks: Optional[int] = None
    migration_bytes: Optional[int] = None
    # serving-latency snapshot at decision time (finished requests so far;
    # NaN until the first finish): metrics.latency_percentiles
    ttft_p50: Optional[float] = None
    ttft_p99: Optional[float] = None
    itl_p50: Optional[float] = None
    itl_p99: Optional[float] = None
    # routing-telemetry snapshot at decision time (None when the backend
    # collects none, as the port's server does)
    routing_samples: Optional[int] = None
    routing_top_share: Optional[float] = None
    routing_cv: Optional[float] = None


class ClusterDriver:
    """SLO-aware closed loop: the estimator's decision -> the cost model's
    target -> the ScalingTask, one non-blocking poll a tick (a serial
    staging does one increment inside the poll).

    The driver owns the device pool and the LoadEstimator; the backend
    serves.  ``run()`` is the paper's §5 lifecycle as a loop that may be
    called again with more arrivals (its state persists).  Its clock is
    virtual: ``t`` moves by ``config.dt`` a tick.
    """

    def __init__(self, backend: ServingBackend, policy: ScalingPolicy, *,
                 mcfg: ModelConfig, tp: int,
                 device_pool: Union[DevicePool, Sequence[int]],
                 config: Optional[DriverConfig] = None):
        self.backend = backend
        self.estimator = LoadEstimator(policy)
        self.mcfg = mcfg
        self.tp = tp
        # Pool ownership lives in the DevicePool allocator, not the driver:
        # a raw id sequence gets its own private pool; passing a shared
        # DevicePool makes double-booking (two drivers claiming overlapping
        # ids) raise at construction instead of silently aliasing devices.
        if not isinstance(device_pool, DevicePool):
            device_pool = DevicePool(device_pool)
        self.allocator = device_pool
        self.pool: Tuple[int, ...] = self.allocator.claim(
            mcfg.name, self.allocator.devices)
        self.config = config or DriverConfig()
        self.task: Optional[ScalingTask] = None
        self.events: List[DriverEvent] = []
        self.finished: List[Request] = []
        self.t = 0.0
        self._last_done_t = -math.inf
        self._pending: List[Request] = []
        self._pi = 0
        # Cost-model settings: the backend's own stores and staging, so
        # projections cost what it will execute (the elastic strategy and
        # the default hardware model)
        # pooled expert store => min-move expert migration in projections
        self._expert_mode = getattr(backend, "expert_mode", "dense")
        # overlapped staging => overlap transfer pipeline in projections
        self._staging = getattr(backend, "staging_mode", "serial")
        # migrate-mode scale-down => projections cost migration bytes via
        # the shared projected_migration_blocks policy, not drain time
        self._scaledown = getattr(backend, "scaledown_mode", "drain")
        # quantized pools => projections size KV / expert-page bytes at the
        # storage element width (halved transfer volumes for int8)
        self._kv_dtype = getattr(backend, "kv_dtype", None)
        self._expert_dtype = getattr(backend, "expert_dtype", None)

    # ------------------------------------------------------ target selection
    def _target_for_dp(self, dp: int) -> ElasticConfig:
        return ElasticConfig(dp=dp, tp=self.tp,
                             devices=tuple(self.pool[:dp * self.tp]))

    def _fits_pool(self, dp: int) -> bool:
        return dp * self.tp <= len(self.pool)

    def ladder(self) -> List[ElasticConfig]:
        max_dp = len(self.pool) // self.tp
        return [self._target_for_dp(d)
                for d in range(self.config.min_dp, max_dp + 1)]

    def projection(self, old: ElasticConfig, new: ElasticConfig) -> dict:
        """``transition_cost``'s keyword arguments for ``old -> new``: the
        backend's stores and staging, its live page table, and a
        migrating scale-down's projected KV bytes."""
        page_table = None
        if self._expert_mode == "pooled":
            # cost from the server's live placement (after earlier
            # remaps), not from a contiguous boot at `old`
            page_table = getattr(getattr(self.backend, "hmm", None),
                                 "page_table", None)
        kv_mig = 0
        if new.dp < old.dp and self._scaledown == "migrate":
            # the live occupancy that must leave the doomed partitions
            kv = getattr(self.backend, "kv_stats", lambda: None)() or {}
            kv_mig = (projected_migration_blocks(
                kv.get("used_blocks", 0), old.dp, new.dp)
                * int(kv.get("block_bytes", 0)))
        return dict(expert_mode=self._expert_mode, page_table=page_table,
                    staging=self._staging, kv_migration_bytes=kv_mig,
                    kv_dtype=self._kv_dtype, expert_dtype=self._expert_dtype)

    def projected_cost_s(self, old: ElasticConfig,
                         new: ElasticConfig) -> float:
        """The cost model's scale time of the transition
        (``transition_cost`` over ``projection``), or ``math.inf`` when
        the live page pool cannot hold the target's pages."""
        try:
            return transition_cost(self.mcfg, self.tp, old, new,
                                   **self.projection(old, new)).scale_time_s
        except MemoryError:
            # the live page pool cannot host this target's staged pages —
            # executing the transition would fail the same way, so veto the
            # candidate instead of crashing the control loop
            return math.inf

    def select_target(self, direction: str
                      ) -> Optional[Tuple[ElasticConfig, float]]:
        """Pick the next config at step granularity; returns
        ``(target, projected_scale_s)`` or None.

        Up: the smallest rung (within ``max_step_dp``) whose backend capacity
        covers current demand (active + queued), falling back to the largest
        affordable rung; a candidate the live page pool cannot host is
        vetoed.  Down: one rung, only if the remaining capacity still covers
        the active load with headroom.
        """
        cur = self.backend.current_config()
        cfg = self.config
        if direction == "up":
            rungs = [d for d in range(cur.dp + 1, cur.dp + cfg.max_step_dp + 1)
                     if self._fits_pool(d)]
            if not rungs:
                return None
            demand = (self.backend.utilization()
                      * self.backend.capacity(cur)
                      + self.backend.queue_depth())
            affordable = []
            for d in rungs:
                cand = self._target_for_dp(d)
                proj = self.projected_cost_s(cur, cand)
                if math.isfinite(proj):
                    affordable.append((cand, proj))
            if not affordable:
                return None
            for cand, proj in affordable:
                if self.backend.capacity(cand) >= demand:
                    return cand, proj
            return affordable[-1]
        # down: one rung, with capacity headroom for what's still running
        d = cur.dp - 1
        if d < cfg.min_dp:
            return None
        cand = self._target_for_dp(d)
        active = self.backend.utilization() * self.backend.capacity(cur)
        if self.backend.capacity(cand) < active * 1.25 \
                or self.backend.queue_depth():
            return None
        proj = self.projected_cost_s(cur, cand)
        if not math.isfinite(proj):
            return None                # live page pool cannot host the target
        return cand, proj

    # -------------------------------------------------------------- the loop
    def run(self, requests: Sequence[Request], until: float) -> List[Request]:
        """Advance the closed loop to ``until``.  ``requests`` are *added* to
        the pending arrival set; call again with more to continue."""
        if requests:
            self._pending = merge_arrivals(self._pending, self._pi, requests)
            self._pi = 0
        cfgd = self.config
        while self.t < until:
            t = self.t
            while self._pi < len(self._pending) \
                    and self._pending[self._pi].arrival_s <= t:
                self.backend.submit(self._pending[self._pi])
                self._pi += 1
            # serve one tick, then one non-blocking task poll (serial
            # backends do at most one staging increment inside it) — the
            # serve loop never waits on a bulk transfer
            finished = self.backend.step(t)
            for r in finished:
                self.estimator.record(r)
            self.finished.extend(finished)
            if self.task is not None:
                phase = self.task.advance(t)
                if phase.terminal:
                    if self.events:
                        # completion metrics into the event log: stall +
                        # overlap efficiency (metrics.summarize surfaces
                        # the backend-level aggregate)
                        ev = self.events[-1]
                        ev.stall_s = getattr(self.task, "stall_s", None)
                        ev.overlap_eff = getattr(
                            self.task, "overlap_efficiency", None)
                        ev.migrated_blocks = getattr(
                            self.task, "migrated_blocks", None)
                        ev.migration_bytes = getattr(
                            self.task, "migration_bytes", None)
                    self.task = None
                    self._last_done_t = t
            elif t - self._last_done_t >= cfgd.settle_s:
                decision = self.estimator.decide(
                    t, self.backend.queue_depth(),
                    self.backend.utilization())
                if decision:
                    picked = self.select_target(decision)
                    if picked is not None:
                        target, proj = picked
                        cur = self.backend.current_config()
                        kv = getattr(self.backend, "kv_stats",
                                     lambda: None)()
                        rt = getattr(self.backend, "routing_stats",
                                     lambda: None)() or {}
                        self.events.append(DriverEvent(
                            t=t, direction=decision, src=cur.describe(),
                            dst=target.describe(), projected_scale_s=proj,
                            kv_util=(kv or {}).get("utilization"),
                            preemptions=int((kv or {}).get(
                                "preemptions", 0)),
                            staging=self._staging,
                            routing_samples=rt.get("samples"),
                            routing_top_share=rt.get("top_expert_share"),
                            routing_cv=rt.get("expert_cv"),
                            **latency_percentiles(self.finished)))
                        self.task = self.backend.start_scale(target)
                        if cfgd.prewarm_next and decision == "up":
                            nxt = target.dp + 1
                            if self._fits_pool(nxt):
                                self.backend.prewarm(
                                    self._target_for_dp(nxt))
            self.t += cfgd.dt
        return self.finished
