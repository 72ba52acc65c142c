"""The fleet driver — the port's own copy of ``repro.serving.fleet``: one
shared ``DevicePool``, several models.

A ``ClusterDriver`` owns its whole pool for one backend; a ``FleetDriver``
arbitrates one pool among several backends (the port's ``ElasticServer``,
or anything with the ``ServingBackend`` methods and ``park`` /
``start_unpark``):

* each model keeps its own ``LoadEstimator`` (its SLO window, cooldown
  and confirm timer), and the driver scores each candidate move with the
  shared cost model (``transition_cost``, ``unpark_transition_cost``) and
  runs it as that model's ``ScalingTask``.  A scale-up's devices are
  claimed at decision time; a scale-down's return to the pool only when
  its task commits, so they serve until then;
* scale to zero: a model with ``min_devices == 0`` idle for
  ``park_after_idle_s`` parks (its snapshot in pinned host memory, every
  device released), and the next queued request unparks it;
* the pool is conserved: every claim and release goes through the
  allocator (a double booking raises), and ``check_invariants`` holds
  the allocator against each model's lease every tick.

Backends address their devices logically (``0 .. ndev - 1``: indices into
an ``ElasticServer``'s ``all_devices``); the pool's ids are the ledger.
Hysteresis is layered: each estimator's ``cooldown_s`` and ``confirm_s``,
the driver's ``settle_s`` after a transition, and ``park_after_idle_s``.

The clock is virtual, as the ``ClusterDriver``'s: ``run`` moves ``t`` by
``FleetConfig.dt`` a tick; the projections are the cost model's times on
the paper's cluster (``core/costmodel.py``), not the card's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Union

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.coordinator import LoadEstimator, ScalingPolicy
from repro_torch.core.topology import ElasticConfig
from repro_torch.serving.driver import (DevicePool, ScalingTask,
                                        transition_cost,
                                        unpark_transition_cost)
from repro_torch.serving.metrics import latency_percentiles
from repro_torch.serving.workload import Request, merge_arrivals


@dataclasses.dataclass
class FleetModelSpec:
    """One model of the fleet: its backend and its scaling envelope."""
    name: str
    backend: object                  # ServingBackend + park / start_unpark
    policy: ScalingPolicy
    mcfg: ModelConfig
    tp: int
    # the model never scales below ceil(min_devices / tp) replicas; 0 also
    # allows it to park
    min_devices: int = 0
    # how long an idle model with min_devices == 0 waits before it parks
    park_after_idle_s: float = 60.0


@dataclasses.dataclass
class FleetConfig:
    dt: float = 0.05
    settle_s: float = 10.0           # no decision this soon after a move
    step_dp: int = 1
    max_step_dp: int = 2
    sample_every_s: float = 5.0      # the timeline's sampling period


@dataclasses.dataclass
class FleetEvent:
    """One move of the allocator: 'up', 'down', 'park' or 'unpark'."""
    t: float
    model: str
    kind: str
    src: str
    dst: str
    projected_s: float = 0.0
    queue_depth: int = 0
    free_devices: int = 0


@dataclasses.dataclass
class _ModelState:
    spec: FleetModelSpec
    estimator: LoadEstimator
    lease: List[int]                 # the pool ids the model holds
    task: Optional[ScalingTask] = None
    task_kind: Optional[str] = None  # 'up' | 'down' | 'unpark'
    task_prev_lease: int = 0         # the lease's size before the claim
    parked: bool = False
    idle_since: Optional[float] = None
    last_done_t: float = -math.inf
    device_seconds: float = 0.0      # the integral of len(lease) dt
    pending: List[Request] = dataclasses.field(default_factory=list)
    pi: int = 0
    finished: List[Request] = dataclasses.field(default_factory=list)


class FleetDriver:
    """The closed loop over several models sharing one ``DevicePool``."""

    def __init__(self, specs: Sequence[FleetModelSpec],
                 device_pool: Union[DevicePool, Sequence[int]],
                 config: Optional[FleetConfig] = None):
        if not isinstance(device_pool, DevicePool):
            device_pool = DevicePool(device_pool)
        self.pool = device_pool
        self.config = config or FleetConfig()
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate model names {names}")
        self.states: Dict[str, _ModelState] = {}
        for spec in specs:
            cfg = spec.backend.current_config()
            ndev = cfg.ndev if cfg is not None else 0
            # the backend's boot devices are claimed from the pool (a pool
            # that cannot hold them all raises)
            lease = (list(self.pool.claim(spec.name,
                                          self.pool.free()[:ndev]))
                     if ndev else [])
            if len(lease) != ndev:
                raise ValueError(
                    f"pool cannot cover {spec.name}'s boot config "
                    f"({ndev} devices; {len(self.pool.devices)} in pool)")
            self.states[spec.name] = _ModelState(
                spec=spec, estimator=LoadEstimator(spec.policy), lease=lease,
                parked=(cfg is None) or getattr(spec.backend, "parked",
                                                False))
        self.t = 0.0
        self.events: List[FleetEvent] = []
        self.timeline: List[dict] = []     # leases sampled every period
        self._next_sample_t = 0.0
        self.check_invariants()

    def check_invariants(self) -> None:
        """Every pool id is free or leased to exactly one model, as the
        models' leases say."""
        self.pool.check_invariants(
            {name: st.lease for name, st in self.states.items()})

    # ----------------------------------------------------------- projections
    def _min_dp(self, spec: FleetModelSpec) -> int:
        return max(1, math.ceil(spec.min_devices / spec.tp))

    def _logical(self, dp: int, tp: int) -> ElasticConfig:
        return ElasticConfig(dp=dp, tp=tp, devices=tuple(range(dp * tp)))

    def _projected_scale_s(self, st: _ModelState, old: ElasticConfig,
                           new: ElasticConfig) -> float:
        """The cost model's scale time of ``old -> new`` with the backend's
        stores, staging and live page table; ``math.inf`` when its page
        pool cannot hold the target."""
        b = st.spec.backend
        try:
            return transition_cost(
                st.spec.mcfg, st.spec.tp, old, new,
                expert_mode=getattr(b, "expert_mode", "dense"),
                page_table=getattr(getattr(b, "hmm", None), "page_table",
                                   None),
                staging=getattr(b, "staging_mode", "serial"),
                kv_dtype=getattr(b, "kv_dtype", None),
                expert_dtype=getattr(b, "expert_dtype", None)).scale_time_s
        except MemoryError:
            return math.inf

    def _projected_unpark_s(self, st: _ModelState,
                            new: ElasticConfig) -> float:
        b = st.spec.backend
        return unpark_transition_cost(
            st.spec.mcfg, st.spec.tp, new,
            staging=getattr(b, "staging_mode", "serial"),
            kv_dtype=getattr(b, "kv_dtype", None),
            expert_dtype=getattr(b, "expert_dtype", None)).scale_time_s

    def _record(self, st: _ModelState, kind: str, src: str, dst: str,
                proj: float = 0.0) -> None:
        self.events.append(FleetEvent(
            t=self.t, model=st.spec.name, kind=kind, src=src, dst=dst,
            projected_s=proj, queue_depth=st.spec.backend.queue_depth(),
            free_devices=len(self.pool.free())))
        obs.get_tracer().instant(f"fleet.{kind}", cat="fleet", t=self.t,
                                 tid="fleet",
                                 args={"model": st.spec.name, "src": src,
                                       "dst": dst})

    # ------------------------------------------------------- task lifecycle
    def _advance_task(self, st: _ModelState, t: float) -> None:
        if st.task is None:
            return
        phase = st.task.advance(t)
        if not phase.terminal:
            return
        name = st.spec.name
        aborted = phase.name == "ABORTED"
        if st.task_kind == "down" and not aborted:
            # the shrink committed: the lease's tail returns to the pool,
            # where other models can claim it
            new_n = st.task.target.ndev
            self.pool.release(name, st.lease[new_n:])
            del st.lease[new_n:]
        elif st.task_kind in ("up", "unpark") and aborted:
            # the claim made at decision time goes back (an aborted unpark
            # stays parked)
            self.pool.release(name, st.lease[st.task_prev_lease:])
            del st.lease[st.task_prev_lease:]
        if st.task_kind == "unpark" and not aborted:
            st.parked = False
            st.idle_since = None
        st.task = None
        st.task_kind = None
        st.last_done_t = t

    # ------------------------------------------------------------ decisions
    def _decide(self, st: _ModelState, t: float) -> None:
        if st.task is not None or t - st.last_done_t < self.config.settle_s:
            return
        if st.parked:
            self._maybe_unpark(st, t)
            return
        b = st.spec.backend
        decision = st.estimator.decide(t, b.queue_depth(), b.utilization())
        if decision == "up":
            self._scale_up(st, t)
        elif decision == "down":
            self._scale_down(st, t)
        else:
            self._maybe_park(st, t)

    def _maybe_unpark(self, st: _ModelState, t: float) -> None:
        """A parked model with a queue unparks as soon as the pool holds
        its smallest legal configuration: the smallest rung whose capacity
        covers the queue, else the largest the pool holds."""
        spec, b = st.spec, st.spec.backend
        if b.queue_depth() == 0:
            return
        free = self.pool.free()
        min_dp = self._min_dp(spec)
        max_dp = len(free) // spec.tp
        if max_dp < min_dp:
            return                      # the pool is spent; try next tick
        demand = b.queue_depth()
        dp = next((d for d in range(min_dp, max_dp + 1)
                   if b.capacity(self._logical(d, spec.tp)) >= demand),
                  max_dp)
        target = self._logical(dp, spec.tp)
        proj = self._projected_unpark_s(st, target)
        st.task_prev_lease = len(st.lease)
        st.lease.extend(self.pool.claim(spec.name, free[:dp * spec.tp]))
        self._record(st, "unpark", "parked", target.describe(), proj)
        st.task = b.start_unpark(target)
        st.task_kind = "unpark"

    def _scale_up(self, st: _ModelState, t: float) -> None:
        spec, b, cfgd = st.spec, st.spec.backend, self.config
        cur = b.current_config()
        free = self.pool.free()
        max_extra_dp = len(free) // spec.tp
        rungs = [d for d in range(cur.dp + cfgd.step_dp,
                                  cur.dp + cfgd.max_step_dp * cfgd.step_dp
                                  + 1, cfgd.step_dp)
                 if d - cur.dp <= max_extra_dp]
        if not rungs:
            return                      # the pool is spent; try next tick
        demand = b.utilization() * b.capacity(cur) + b.queue_depth()
        scored = []
        for d in rungs:
            cand = self._logical(d, spec.tp)
            proj = self._projected_scale_s(st, cur, cand)
            if math.isfinite(proj):
                scored.append((cand, proj))
        if not scored:
            return
        target, proj = next(((c, p) for c, p in scored
                             if b.capacity(c) >= demand), scored[-1])
        delta = target.ndev - cur.ndev
        st.task_prev_lease = len(st.lease)
        st.lease.extend(self.pool.claim(spec.name, free[:delta]))
        self._record(st, "up", cur.describe(), target.describe(), proj)
        st.task = b.start_scale(target)
        st.task_kind = "up"

    def _scale_down(self, st: _ModelState, t: float) -> None:
        spec, b, cfgd = st.spec, st.spec.backend, self.config
        cur = b.current_config()
        d = cur.dp - cfgd.step_dp
        if d < self._min_dp(spec):
            return
        cand = self._logical(d, spec.tp)
        active = b.utilization() * b.capacity(cur)
        if b.capacity(cand) < active * 1.25 or b.queue_depth():
            return
        proj = self._projected_scale_s(st, cur, cand)
        if not math.isfinite(proj):
            return
        self._record(st, "down", cur.describe(), cand.describe(), proj)
        # the devices return when the task commits (_advance_task): the
        # model serves on them until then
        st.task = b.start_scale(cand)
        st.task_kind = "down"

    def _maybe_park(self, st: _ModelState, t: float) -> None:
        spec, b = st.spec, st.spec.backend
        if spec.min_devices > 0:
            return
        if not (b.queue_depth() == 0 and b.utilization() == 0.0):
            st.idle_since = None
            return
        if st.idle_since is None:
            st.idle_since = t
            return
        if t - st.idle_since < spec.park_after_idle_s:
            return
        self._record(st, "park", b.current_config().describe(), "parked")
        b.park()
        self.pool.release(spec.name, st.lease)
        st.lease.clear()
        st.parked = True
        st.idle_since = None
        st.last_done_t = t

    # -------------------------------------------------------------- the loop
    def run(self, arrivals: Dict[str, Sequence[Request]],
            until: float) -> Dict[str, List[Request]]:
        """Advance the loop to ``until``.  ``arrivals``: model name -> new
        requests, added to that model's pending arrivals (call again with
        more to continue).  Returns each model's finished requests."""
        for name, reqs in (arrivals or {}).items():
            st = self.states[name]
            if reqs:
                st.pending = merge_arrivals(st.pending, st.pi, reqs)
                st.pi = 0
        cfgd = self.config
        while self.t < until:
            t = self.t
            for st in self.states.values():
                # a parked model takes submissions: its queue unparks it
                while st.pi < len(st.pending) \
                        and st.pending[st.pi].arrival_s <= t:
                    st.spec.backend.submit(st.pending[st.pi])
                    st.pi += 1
                finished = st.spec.backend.step(t)
                for r in finished:
                    st.estimator.record(r)
                st.finished.extend(finished)
                st.device_seconds += len(st.lease) * cfgd.dt
            for st in self.states.values():
                self._advance_task(st, t)
            for st in self.states.values():
                self._decide(st, t)
            if t >= self._next_sample_t:
                self.timeline.append(
                    {"t": round(t, 6),
                     **{n: len(s.lease) for n, s in self.states.items()},
                     "free": len(self.pool.free())})
                self._next_sample_t = t + cfgd.sample_every_s
            self.check_invariants()
            self.t += cfgd.dt
        return {name: st.finished for name, st in self.states.items()}

    # ------------------------------------------------------------- reporting
    def device_seconds(self) -> Dict[str, float]:
        return {n: st.device_seconds for n, st in self.states.items()}

    def finished_requests(self) -> Dict[str, List[Request]]:
        return {n: st.finished for n, st in self.states.items()}

    def summary(self) -> dict:
        """Each model's moves, device hours and latency percentiles."""
        out = {}
        for name, st in self.states.items():
            kinds = [e.kind for e in self.events if e.model == name]
            out[name] = {"ups": kinds.count("up"),
                         "downs": kinds.count("down"),
                         "parks": kinds.count("park"),
                         "unparks": kinds.count("unpark"),
                         "device_hours": st.device_seconds / 3600.0,
                         **latency_percentiles(st.finished)}
        return out
