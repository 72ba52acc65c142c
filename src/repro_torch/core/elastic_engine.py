"""``ElasticServer`` — the port of ``repro.core.elastic_engine``: a
server that boots on one or several logical devices, serves, and scales
while it serves.

An encoder (no decode) and a VLM (a ``Request`` carries no image) are
refused at construction; their steps are ``models.model``'s.  On one
device (``ElasticConfig(1, 1, (0,))``) an instance serves a
standard-attention decoder, an MLA decoder (over its latent cache) or a
Mamba2 model, attention-free or hybrid (over its per-slot SSD state and,
hybrid, the shared block's K/V); the last two with dense KV and monolithic
prefill only, as in the reference.  On several logical devices
(``all_devices``) a standard-attention decoder serves at any tp whose split
keeps every head whole: each DP replica runs its attention on its own
shards and slots (at tp > 1 split over its TP ranks, with explicit sums
between them), and the MoE runs expert-parallel across every device.

Scaling (the paper's §5), also from and to one device (the HMM reads a
one-device instance's tensors as shards of its one-device mesh, and the
engine switches between the one-device and the ``parallel`` steps at the
switchover): ``start_scale(target)`` opens an
``EngineScalingTask`` whose ``advance(now)`` is a non-blocking poll, and
``tick()`` serves between any two polls; ``scale_to`` and ``stage_scale``
+ ``switchover`` are the blocking forms.  The phases are the reference's
(``serving/driver.ScalePhase``): STAGING (the HMM stages the target's
weights — serially, one unit a poll, or with ``staging="overlap"`` on the
background ``TransferEngine``, on the card on side CUDA streams, while the
default stream keeps decoding) -> COMPILING (the IMM captures the target's
CUDA graphs over its staged tensors; overlapped, on the serving thread
while the copies run, one graph a poll) -> on a scale-down MIGRATING
(``scaledown="migrate"``, paged KV: the doomed slots' live sequences have
their KV blocks copied onto survivor partitions while the survivors
decode; the doomed devices release as soon as the copies land) or DRAINING (``scaledown="drain"``, and any
dense-KV server: the doomed slots stop admitting and run to completion) ->
COMMITTING (``switchover``: the surviving slots continue on the same KV
shards, and the target's graphs are bound, not captured) -> DONE, or
ABORTED.  While a task is in flight new admissions
pause and in-flight decodes continue (``admission_during_scale``).

The defaults are the reference's: the slot-contiguous KV cache
(``kv_mode="dense"``), dense expert banks (``expert_mode="dense"``) and a
monolithic prefill at admission (``prefill_chunk=0``); the paged KV pool,
pooled expert pages, chunked prefill (into either KV layout) and the int8
stores are the other modes.  A TP degree that cuts a head raises.

Scale to zero: ``park()`` (idle servers only) snapshots every weight bank
into pinned host memory and drops every device tensor — the HMM's, the
engine's and every CUDA graph set this server captured — so the card's
memory is freed; ``tick`` then returns ``[]``, ``utilization`` is 0,
``current_config`` is None, and ``submit`` queues.  ``start_unpark(target)``
opens an ``UnparkTask``: STAGING (the snapshot streams host to device —
overlapped, on the TransferEngine's side streams while the IMM captures
the target's graphs one a poll on the serving thread; serial, one unit a
poll, then COMPILING) -> COMMITTING (the fresh KV cache and the engine
bound) -> DONE, after which the server serves with the tokens of a server
never parked.  ``serving/fleet.py``'s ``FleetDriver`` parks and unparks.

Skew-aware rebalancing (standard-attention MoE models, pooled pages):
``routing_sample_every=N`` runs every Nth decode tick's twin that also
gives the routing counts (on the card its own CUDA graph) and keeps their
histogram (``routing_stats``); a ``RebalancePolicy`` (``rebalance=``)
turns it into replicate / demote / drop / promote actions, which ``tick``
drives through a ``RebalanceTask`` (STAGING: the HMM's copies on the
TransferEngine while serving goes on; COMMITTING: the index arrays written
in place) — never while a scale is in flight, and a scale aborts an open
rebalance first.  ``expert_slot_slack`` (1 by default with a policy) is
the table's spare width for replicas; ``expert_host_pages`` bounds the
pinned-host tier.  Replicas are byte-identical, so the tokens are those of
a server without a policy.

The server is a ``serving/driver.ServingBackend``: the ``ClusterDriver``
drives it through ``step``, ``start_scale`` and the load signals.  With a
``policy`` it also keeps its own ``LoadEstimator``, which ``tick`` feeds
with every finished request and ``autoscale_decision`` asks, as the
launcher (``launch/serve.py``) does.
"""
from __future__ import annotations

import dataclasses
import math
import time
from functools import partial
from typing import Dict, List, Optional

from repro_torch import obs
from repro_torch.core.coordinator import LoadEstimator
from repro_torch.core.hmm import HMM, TransferStats
from repro_torch.core.imm import IMM
from repro_torch.core.topology import ElasticConfig
from repro_torch.core.transfer import TransferOp
from repro_torch.models.model import chunk_prefill_supported
from repro_torch.serving.driver import ScalePhase, admission_during_scale
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.rebalance import RebalancePolicy
from repro_torch.serving.workload import Request


@dataclasses.dataclass
class ScaleEvent:
    """One scale event.  ``stats`` is the HMM's ``last_stats``: the
    staging's bytes, and after ``switchover`` also the commit's.
    ``compile_hit``: whether the target's step set (on the card its CUDA
    graphs) was ready before ``switchover``.  ``stall_s`` is the serve
    loop's time blocked on staging work: all of ``stage_s`` on the
    blocking forms, the time spent inside ``advance`` polls for a task.
    Overlapped, the copies add next to nothing to it, but the target's
    capture on the serving thread does (on an H100 about a second for
    eight of qwen3-30b-a3b's layers at DP6), one graph a poll.
    ``stage_wall_s`` freezes the staging's wall time, which ``stats``
    later adds the commit to.  ``migrated_blocks`` and ``migration_bytes``
    count a scale-down's live KV moves (0 for a scale-up or a drain)."""
    t: float
    src: str
    dst: str
    stats: TransferStats
    compile_hit: bool
    stage_s: float
    switch_s: float
    stall_s: float = 0.0
    staging: str = "serial"
    stage_wall_s: float = 0.0
    migrated_blocks: int = 0
    migration_bytes: int = 0


class EngineScalingTask:
    """A resumable scale transition over the engine (``driver.ScalingTask``).

    ``advance`` is a non-blocking completion poll; what runs inside it
    depends on the HMM's staging mode:

    * ``staging="serial"`` — one staging unit per ``advance``, then a
      COMPILING advance (the IMM captures the target's step set);
    * ``staging="overlap"`` — the units already run on the background
      ``TransferEngine`` (submitted at ``start_scale``); each ``advance``
      captures one graph of the target's step set on the serving thread
      while the copies proceed (STAGING with COMPILING), so ticks run
      between the captures; once all are captured, later ones poll.

    A scale-down continues into MIGRATING (``scaledown="migrate"``: the
    live sequences' blocks are copied onto survivor partitions as
    per-block ops on the HMM's TransferEngine while decode ticks proceed)
    or DRAINING, then COMMITTING (``switchover``) and DONE.  ``tick()`` is
    legal between every two ``advance`` calls.
    """

    def __init__(self, server: "ElasticServer", target: ElasticConfig):
        if server._active_task is not None \
                and not server._active_task.phase.terminal:
            raise RuntimeError("a scale event is already in flight")
        # a scale goes first: an open rebalance is aborted (the page table
        # holds one session at a time)
        server._preempt_rebalance()
        self.server = server
        self.target = target
        self.phase = ScalePhase.STAGING
        self.staging_mode = server.hmm.staging_mode
        self.increments_total = server.hmm.begin_scale(target) + 1  # +compile
        self.increments_done = 0
        self.stats: TransferStats = server.hmm._stage_stats
        # the staging-only snapshot, frozen when STAGING completes
        # (``stats`` keeps accumulating: commit merges the KV grow into it)
        self.stage_stats: Optional[TransferStats] = None
        self.event: Optional[ScaleEvent] = None
        self.stall_s = 0.0      # serve-loop time spent inside advance()
        self._compile_hit: Optional[bool] = None
        self._captured = False  # the target's step set, overlapped
        self._down = target.ndev < server.engine.cfg.ndev
        self._keep = target.dp * server.engine.batch_per_replica
        self._migrate = self._down and server.scaledown_mode == "migrate"
        self._mig_inflight: List = []   # (MigrationJob, TransferSession)
        self._mig_warm = False
        self.migrated_blocks = 0
        self.migration_bytes = 0
        if self._down:
            # stop admitting into doomed slots right away, so the drain
            # overlaps the staging instead of following it
            server.engine.admit_limit = self._keep
        server._active_task = self

    @property
    def phase(self) -> ScalePhase:
        return self._phase

    @phase.setter
    def phase(self, new: ScalePhase) -> None:
        """Every transition emits one ``scale.<PHASE>`` span on the
        ``"scale"`` lane (ABORTED unwinds included)."""
        tr = obs.get_tracer()
        now = tr.now()
        old = getattr(self, "_phase", None)
        self._phase = new
        if old is not None and old is not new:
            tr.complete(f"scale.{old.name}", self._phase_t0, now,
                        cat="scale", tid="scale",
                        args={"target": self.target.describe(),
                              "next": new.name})
        self._phase_t0 = now

    @property
    def done(self) -> bool:
        return self.phase.terminal

    @property
    def overlap_efficiency(self) -> Optional[float]:
        """Sum of the transfer ops' times over the staging wall (> 1: the
        copies overlapped each other); None until staging completed."""
        st = self.stage_stats
        if st is None or st.wall_s <= 0 or st.op_s <= 0:
            return None
        return st.op_s / st.wall_s

    def _finish_staging(self):
        """STAGING complete: freeze the snapshot, record the event (the
        target's step set was captured over the overlapped polls) and move
        on."""
        self.stage_stats = dataclasses.replace(self.stats)
        self.event = self.server._record_stage(self.target,
                                               self.stats.wall_s)
        if self._compile_hit is not None:
            self.event.compile_hit = self._compile_hit
        self.phase = self._scaledown_phase()

    def _scaledown_phase(self) -> ScalePhase:
        if not self._down:
            return ScalePhase.COMMITTING
        return (ScalePhase.MIGRATING if self._migrate
                else ScalePhase.DRAINING)

    def _unwind_failed(self):
        """A staging, compile or migration step raised: release the task's
        state so the server keeps serving on the active configuration
        (``hmm.abort`` is idempotent)."""
        self.server.hmm.abort()
        if self._down:
            self.server.engine.admit_limit = None
        self.server._staged_cfg = None
        self.server._active_task = None
        self.phase = ScalePhase.ABORTED

    def advance(self, now: float) -> ScalePhase:
        ph = self.phase
        if ph is ScalePhase.STAGING:
            t0 = time.perf_counter()
            try:
                if self.staging_mode == "overlap":
                    imm = self.server.imm
                    if self._compile_hit is None:
                        self._compile_hit = imm.has(self.target)
                    if not self._captured:
                        # one graph a poll, on the serving thread while the
                        # TransferEngine moves the bytes
                        imm.preinitialize(self.target,
                                          *self.server._staged_tensors(),
                                          limit=1)
                        self._captured = imm.ready(self.target)
                    if self._captured and self.server.hmm.poll_staging():
                        self.increments_done = self.increments_total
                        self._finish_staging()
                    else:
                        self.increments_done = (
                            self.increments_total - 1
                            - self.server.hmm.staging_remaining)
                else:
                    more = self.server.hmm.stage_increment()
                    self.increments_done += 1
                    if not more:
                        self.stage_stats = dataclasses.replace(self.stats)
                        self.phase = ScalePhase.COMPILING
            except BaseException:
                self._unwind_failed()
                raise
            self.stall_s += time.perf_counter() - t0
        elif ph is ScalePhase.COMPILING:
            t0 = time.perf_counter()
            self.increments_done += 1
            try:
                # the staging's own time (the HMM's), not the wall since
                # the task opened, which holds the ticks between polls
                self.event = self.server._record_stage(self.target,
                                                       self.stats.wall_s)
            except BaseException:
                self._unwind_failed()
                raise
            self.phase = self._scaledown_phase()
            self.stall_s += time.perf_counter() - t0
        elif ph is ScalePhase.MIGRATING:
            t0 = time.perf_counter()
            try:
                if self._advance_migration():
                    self.phase = ScalePhase.COMMITTING
            except BaseException:
                self._cancel_migrations()
                self._unwind_failed()
                raise
            self.stall_s += time.perf_counter() - t0
        elif ph is ScalePhase.DRAINING:
            if self.server.engine.drained(self._keep):
                self.phase = ScalePhase.COMMITTING
        elif ph is ScalePhase.COMMITTING:
            self.server.switchover()
            self.phase = ScalePhase.DONE
            self.server._active_task = None
        if self.event is not None:
            self.event.stall_s = self.stall_s
        return self.phase

    def _advance_migration(self) -> bool:
        """One MIGRATING poll: harvest the landed copy sessions (cut their
        slots over), submit new component moves, and report whether every
        doomed partition is empty.  The copies run as TransferOps on the
        HMM's TransferEngine (on the card on side streams that first wait
        for the step that last wrote the source rows), so decode ticks
        between polls overlap them."""
        eng = self.server.engine
        for job, sess in list(self._mig_inflight):
            if not sess.finished():
                continue
            self._mig_inflight.remove((job, sess))
            failed = sess.failed_ops()
            if failed:
                eng.cancel_migration(job)
                raise RuntimeError(
                    f"KV migration copy op {failed[0].label!r} failed "
                    f"({len(failed)} op(s)); scale-down aborted"
                ) from failed[0].error
            # finished() means landed: the cut-over's first step reads
            # destination rows that are written
            eng.finish_migration(job)
            self.migrated_blocks += job.ticket.num_blocks
            self.migration_bytes += job.ticket.num_blocks * eng.block_nbytes()
            if self.event is not None:
                # per harvest: a committed component stays moved even if
                # a later abort lands
                self.event.migrated_blocks = self.migrated_blocks
                self.event.migration_bytes = self.migration_bytes
        while True:
            job = eng.plan_migration()
            if job is None:
                break
            if not self._mig_warm:
                eng.prewarm_block_copy()
                self._mig_warm = True
            ops = [TransferOp(index=i, label=f"kvmig:{s}->{d}",
                              fn=partial(eng.copy_block, s, d),
                              devices=tuple(job.ready))
                   for i, (s, d) in enumerate(job.ticket.pairs)]
            sess = self.server.hmm.transfer_engine().submit(ops,
                                                            after=job.ready)
            self._mig_inflight.append((job, sess))
        if self._mig_inflight:
            # a bounded yield to the copy workers, as poll_staging gives:
            # with the doomed sequences paused and the survivors idle the
            # serve loop is a pure Python spin that would starve them
            self._mig_inflight[0][1].join(timeout=0.002)
        return not self._mig_inflight and not eng.doomed_active_slots()

    def _cancel_migrations(self):
        """Abort barrier for in-flight migrations: cancel-or-join every
        copy session first (no worker touches the cache afterwards), then
        unwind the tickets and slots — the tables were never flipped, so
        the paused sequences resume where they were."""
        for job, sess in self._mig_inflight:
            sess.cancel()
            self.server.engine.cancel_migration(job)
        self._mig_inflight = []

    def abort(self):
        if self.phase not in (ScalePhase.STAGING, ScalePhase.COMPILING,
                              ScalePhase.MIGRATING, ScalePhase.DRAINING):
            raise RuntimeError(f"cannot abort a task in {self.phase.name}")
        self._cancel_migrations()
        self.server.hmm.abort()
        if self._down:
            # re-open the slots closed in __init__
            self.server.engine.admit_limit = None
        self.server._staged_cfg = None
        self.server._active_task = None
        self.phase = ScalePhase.ABORTED


class UnparkTask:
    """A resumable cold start from the parked snapshot
    (``driver.ScalingTask``), the scale-from-zero twin of
    ``EngineScalingTask``: ``begin_unpark`` opened the HMM's session (the
    target's tensors and fresh KV cache made, overlapped copies
    submitted).  Overlapped, each STAGING ``advance`` captures one graph
    of the target's set over those tensors while the copies land (an
    ``unpark.compile`` span each), then polls; serial, one unit a poll and
    a COMPILING poll.  COMMITTING binds the engine; the next ``tick``
    serves.  No MIGRATING or DRAINING: a parked server has no sequence.
    ``compile_hit``'s meaning is the reference's (``IMM.has`` before the
    first capture); ``capture_s`` is the time spent capturing.  Each
    transition emits an ``unpark.<PHASE>`` span on the ``"scale"``
    lane."""

    def __init__(self, server: "ElasticServer", target: ElasticConfig):
        if not server.parked:
            raise RuntimeError("unpark requires a parked server")
        if server._active_task is not None \
                and not server._active_task.phase.terminal:
            raise RuntimeError("a scale event is already in flight")
        self.server = server
        self.target = target
        self.phase = ScalePhase.STAGING
        self.staging_mode = server.hmm.staging_mode
        self.increments_total = server.hmm.begin_unpark(target) + 1
        self.increments_done = 0
        self.stats: TransferStats = server.hmm._stage_stats
        self.stage_stats: Optional[TransferStats] = None
        self.event: Optional[ScaleEvent] = None
        self.stall_s = 0.0
        self.capture_s = 0.0
        self._compile_hit: Optional[bool] = None
        self._captured = False
        server._active_task = self

    @property
    def phase(self) -> ScalePhase:
        return self._phase

    @phase.setter
    def phase(self, new: ScalePhase) -> None:
        tr = obs.get_tracer()
        now = tr.now()
        old = getattr(self, "_phase", None)
        self._phase = new
        if old is not None and old is not new:
            tr.complete(f"unpark.{old.name}", self._phase_t0, now,
                        cat="scale", tid="scale",
                        args={"target": self.target.describe(),
                              "next": new.name})
        self._phase_t0 = now

    @property
    def done(self) -> bool:
        return self.phase.terminal

    def _unwind_failed(self):
        """A step raised: abort the HMM's session.  The snapshot stays, so
        a later ``start_unpark`` can try again."""
        self.server.hmm.abort()
        self.server._active_task = None
        self.phase = ScalePhase.ABORTED

    def _capture(self, limit: Optional[int]) -> None:
        """The target's step set over its staged tensors, at most ``limit``
        graphs (None: all), in an ``unpark.compile`` span."""
        imm, tr = self.server.imm, obs.get_tracer()
        if self._compile_hit is None:
            self._compile_hit = imm.has(self.target)
        c0 = tr.now()
        t0 = time.perf_counter()
        imm.preinitialize(self.target, *self.server._staged_tensors(),
                          limit=limit)
        self._captured = imm.ready(self.target)
        self.capture_s += time.perf_counter() - t0
        tr.complete("unpark.compile", c0, tr.now(), cat="scale", tid="scale",
                    args={"hit": self._compile_hit,
                          "target": self.target.describe()})

    def advance(self, now: float) -> ScalePhase:
        ph = self.phase
        hmm = self.server.hmm
        if ph is ScalePhase.STAGING:
            t0 = time.perf_counter()
            try:
                if self.staging_mode == "overlap":
                    if not self._captured:
                        self._capture(limit=1)
                    if self._captured and hmm.poll_staging():
                        self.increments_done = self.increments_total
                        self.stage_stats = dataclasses.replace(self.stats)
                        self.phase = ScalePhase.COMMITTING
                    else:
                        self.increments_done = (self.increments_total - 1
                                                - hmm.staging_remaining)
                else:
                    more = hmm.stage_increment()
                    self.increments_done += 1
                    if not more:
                        self.stage_stats = dataclasses.replace(self.stats)
                        self.phase = ScalePhase.COMPILING
            except BaseException:
                self._unwind_failed()
                raise
            self.stall_s += time.perf_counter() - t0
        elif ph is ScalePhase.COMPILING:
            t0 = time.perf_counter()
            self.increments_done += 1
            try:
                self._capture(limit=None)
            except BaseException:
                self._unwind_failed()
                raise
            self.phase = ScalePhase.COMMITTING
            self.stall_s += time.perf_counter() - t0
        elif ph is ScalePhase.COMMITTING:
            self.server._unpark_switchover(self)
            self.phase = ScalePhase.DONE
            self.server._active_task = None
        return self.phase

    def abort(self):
        if self.phase not in (ScalePhase.STAGING, ScalePhase.COMPILING):
            raise RuntimeError(f"cannot abort a task in {self.phase.name}")
        self._unwind_failed()


@dataclasses.dataclass
class RebalanceEvent:
    """One committed (or aborted) rebalance pass."""
    t: float
    actions: int
    replicated: int = 0
    demoted: int = 0
    dropped: int = 0
    promoted: int = 0
    stats: Optional[TransferStats] = None
    aborted: bool = False


class RebalanceTask:
    """A resumable expert rebalance: STAGING (the HMM's replica and
    demotion copies run on its TransferEngine while ``tick`` serves) ->
    COMMITTING (the page table commits and the index arrays are written in
    place) -> DONE, or ABORTED (``abort``: every staged page freed, the
    serving layout untouched).  It never pauses admission: the serving
    assignment changes only at commit, between two ticks.  Each phase
    emits a ``rebalance.<PHASE>`` span on the ``"rebalance"`` lane."""

    def __init__(self, server: "ElasticServer", actions: List, load=None):
        self.server = server
        self.actions = list(actions)
        self.event: Optional[RebalanceEvent] = None
        self.stats: Optional[TransferStats] = None
        self._load = load
        self.phase = ScalePhase.STAGING
        try:
            self.ops_total = server.hmm.begin_rebalance(actions, load=load)
        except BaseException:
            self.phase = ScalePhase.ABORTED
            raise
        server._rebalance_task = self

    @property
    def phase(self) -> ScalePhase:
        return self._phase

    @phase.setter
    def phase(self, new: ScalePhase) -> None:
        tr = obs.get_tracer()
        now = tr.now()
        old = getattr(self, "_phase", None)
        self._phase = new
        if old is not None and old is not new:
            tr.complete(f"rebalance.{old.name}", self._phase_t0, now,
                        cat="rebalance", tid="rebalance",
                        args={"actions": len(self.actions),
                              "next": new.name})
        self._phase_t0 = now

    @property
    def done(self) -> bool:
        return self.phase.terminal

    def advance(self, now: float) -> ScalePhase:
        ph = self.phase
        if ph is ScalePhase.STAGING:
            try:
                if self.server.hmm.poll_rebalance():
                    self.phase = ScalePhase.COMMITTING
            except BaseException:
                # poll_rebalance aborted the HMM's session
                self.server._rebalance_task = None
                self.phase = ScalePhase.ABORTED
                raise
        elif ph is ScalePhase.COMMITTING:
            try:
                self.stats = self.server.hmm.commit_rebalance(load=self._load)
            except BaseException:
                self.server._rebalance_task = None
                self.phase = ScalePhase.ABORTED
                raise
            # the histogram described the old placement
            self.server.engine.reset_routing_stats()
            self.event = self._record(now)
            self.server._rebalance_task = None
            self.phase = ScalePhase.DONE
        return self.phase

    def _record(self, now: float) -> RebalanceEvent:
        kinds = [a[0] for a in self.actions]
        ev = RebalanceEvent(t=now, actions=len(self.actions),
                            replicated=kinds.count("replicate"),
                            demoted=kinds.count("demote"),
                            dropped=kinds.count("drop_replica"),
                            promoted=kinds.count("promote"),
                            stats=self.stats)
        self.server.rebalance_events.append(ev)
        return ev

    def abort(self):
        if self.phase not in (ScalePhase.STAGING, ScalePhase.COMMITTING):
            raise RuntimeError(f"cannot abort a task in {self.phase.name}")
        self.server.hmm.abort_rebalance()
        self.server._rebalance_task = None
        self.server.rebalance_events.append(
            RebalanceEvent(t=time.time(), actions=len(self.actions),
                           aborted=True))
        self.phase = ScalePhase.ABORTED


class ElasticServer:
    def __init__(self, mcfg, *, tp: int, batch_per_replica: int,
                 max_len: int, prefill_buckets=(64,), all_devices=None,
                 policy=None, seed: int = 0,
                 kv_mode: str = "dense", kv_block_size: int = 16,
                 kv_blocks_per_replica: Optional[int] = None,
                 expert_mode: str = "dense",
                 expert_pool_pages: Optional[int] = None,
                 staging: str = "serial", transfer_workers: int = 4,
                 scaledown: str = "migrate",
                 prefill_chunk: int = 0,
                 prefill_budget: Optional[int] = None,
                 routing_sample_every: int = 0,
                 rebalance: Optional[RebalancePolicy] = None,
                 expert_slot_slack: Optional[int] = None,
                 expert_host_pages: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 expert_dtype: Optional[str] = None,
                 imm_cache=None, cuda_graphs: bool = True, device="cuda"):
        if not mcfg.has_decode:
            raise NotImplementedError(
                f"{mcfg.name} is encoder-only: no serving decode (as "
                f"launch/serve.py says); models.model.forward runs it")
        if mcfg.arch_type == "vlm":
            raise NotImplementedError(
                f"{mcfg.name}: a Request carries no image, so a VLM server "
                f"would prefill without one (the reference's server attends "
                f"the prompt as its image: ROADMAP §3, \"The VLM server\"); "
                f"models.model's prefill and decode_step take "
                f"image_embeds")
        if mcfg.attn_window is not None:
            raise NotImplementedError(
                f"{mcfg.name}: a sliding window runs on one device only, so "
                f"a windowed server could not scale (ROADMAP §1 item 6); "
                f"models.model's prefill and decode_step take the window")
        if scaledown not in ("migrate", "drain"):
            raise ValueError(f"unknown scaledown {scaledown!r}")
        if prefill_chunk and not chunk_prefill_supported(mcfg):
            raise ValueError(f"{mcfg.name}: chunked prefill unsupported "
                             f"(as in the reference)")
        self.mcfg = mcfg
        self.kv_mode = kv_mode
        # int8 storage: the HMM owns the layout (int8 pools with f32 scale
        # sidecars) and checks the values
        self.kv_dtype = kv_dtype
        self.expert_dtype = expert_dtype
        self.expert_mode = expert_mode
        self.prefill_chunk = prefill_chunk
        self.prefill_buckets = tuple(prefill_buckets)
        # scale-down: 'migrate' (paged KV only: live sequences' blocks are
        # copied onto survivor partitions) or 'drain' (the doomed slots
        # run to completion).  The dense layout has no block indirection
        # to rewrite, so it always drains.
        self.scaledown_mode = scaledown if kv_mode == "paged" else "drain"
        # 'overlap': staging runs on the HMM's background TransferEngine
        # while tick() keeps serving
        self.staging_mode = staging
        # skew-aware rebalancing: the policy's replicas need spare table
        # width, so a policy makes the slot slack 1 by default
        self.rebalance_policy = rebalance
        if expert_slot_slack is None:
            expert_slot_slack = 1 if rebalance is not None else 0
        self.hmm = HMM(mcfg, tp, batch_per_replica=batch_per_replica,
                       max_len=max_len, all_devices=all_devices, seed=seed,
                       kv_mode=kv_mode, kv_block_size=kv_block_size,
                       kv_blocks_per_replica=kv_blocks_per_replica,
                       expert_mode=expert_mode,
                       expert_pool_pages=expert_pool_pages,
                       staging=staging, transfer_workers=transfer_workers,
                       expert_slot_slack=expert_slot_slack,
                       expert_host_pages=expert_host_pages,
                       kv_dtype=kv_dtype, expert_dtype=expert_dtype,
                       device=device)
        # routing telemetry: every Nth decode tick also gives the routing
        # counts (0: off, and no routed step is built)
        self.routing_sample_every = routing_sample_every
        # ``imm_cache``: an OrderedDict shared across a fleet's servers, so
        # the standby LRU is bounded once (keys carry the model identity);
        # ``cuda_graphs=False``: the eager steps on the card (the twin that
        # tests and chip_smoke.py compare the graphs with)
        self.imm = IMM(mcfg, self.hmm, batch_per_replica=batch_per_replica,
                       max_len=max_len, prefill_buckets=prefill_buckets,
                       prefill_chunk=prefill_chunk, shared_cache=imm_cache,
                       collect_routing=routing_sample_every > 0,
                       cuda_graphs=cuda_graphs)
        # an aborted scale's or unpark's target set is never bound: the
        # IMM drops it at every HMM abort
        self.hmm.abort_listeners.append(self.imm.release_standby)
        self.engine = InferenceEngine(mcfg,
                                      batch_per_replica=batch_per_replica,
                                      max_len=max_len,
                                      prefill_bucket=min(prefill_buckets),
                                      prefill_chunk=prefill_chunk,
                                      prefill_budget=prefill_budget,
                                      routing_sample_every=(
                                          routing_sample_every),
                                      device=self.hmm.device)
        self.estimator = LoadEstimator(policy) if policy else None
        self.queue: List[Request] = []
        self.requests: Dict[int, Request] = {}
        self.events: List[ScaleEvent] = []
        self.rebalance_events: List[RebalanceEvent] = []
        self._staged_cfg: Optional[ElasticConfig] = None
        self._active_task: Optional[EngineScalingTask] = None
        self._rebalance_task: Optional[RebalanceTask] = None

    # ------------------------------------------------------------ lifecycle
    def boot(self, cfg: ElasticConfig, params=None):
        """Boot on ``cfg``: the HMM draws the weights on the devices, or
        adopts ``params`` (the reference's converted global parameters, as
        the tests pass them), then the IMM's instance binds the engine."""
        self.hmm.boot(cfg, params)
        self._bind(*self.imm.activate(cfg)[:3])

    def _bind(self, inst, params, cache):
        """Bind the engine to an activated instance; the cache's ownership
        moves to the engine."""
        self.engine.bind(inst.cfg, params, cache, inst.compiled,
                         kv=self.hmm.kv_blocks, parallel=inst.parallel,
                         graphs=inst.graphs)
        self.hmm.cache = None

    def _staged_tensors(self):
        """The staging target's parameters and the cache its commit will
        adopt (the IMM captures its graphs over them)."""
        return self.hmm.staged_tensors(self.engine.cache)[2:]

    def preinitialize(self, cfg: ElasticConfig):
        """Warm the IMM for an anticipated configuration."""
        self.imm.preinitialize(cfg)

    def prewarm(self, target: ElasticConfig) -> None:
        self.preinitialize(target)

    def scale_to(self, new_cfg: ElasticConfig) -> ScaleEvent:
        """Stage and switch over; the engine may serve between the two
        (``stage_scale`` then ``switchover``).  A scale-down's doomed slots
        must be idle by then (``start_scale`` migrates or drains them)."""
        ev = self.stage_scale(new_cfg)
        self.switchover()
        return ev

    def stage_scale(self, new_cfg: ElasticConfig) -> ScaleEvent:
        """Stage ``new_cfg``'s weights (all units back to back, or joined
        when overlapped) while the active instance stays serveable.  The
        incremental form is ``start_scale``; both record through
        ``_record_stage``."""
        if self.engine.cfg is None:
            raise RuntimeError("boot() the server before scaling it")
        self._preempt_rebalance()
        t0 = time.perf_counter()
        self.hmm.scale(new_cfg)                  # weights only; serving free
        return self._record_stage(new_cfg, time.perf_counter() - t0)

    def _record_stage(self, new_cfg: ElasticConfig, stage_s: float
                      ) -> ScaleEvent:
        hit = self.imm.has(new_cfg)
        t0 = time.perf_counter()
        # the target's graphs, over its staged tensors (no-op when bound)
        self.imm.preinitialize(new_cfg, *self._staged_tensors())
        stage_s += time.perf_counter() - t0
        self._staged_cfg = new_cfg
        if new_cfg.ndev < self.engine.cfg.ndev:
            # scale-down: stop admitting into the slots that are evicted
            self.engine.admit_limit = (new_cfg.dp
                                       * self.engine.batch_per_replica)
        ev = ScaleEvent(t=time.time(), src=self.hmm.active_cfg.describe(),
                        dst=new_cfg.describe(), stats=self.hmm.last_stats,
                        compile_hit=hit, stage_s=stage_s, switch_s=0.0,
                        # blocking callers stall for the whole stage; a
                        # task overwrites it with its measured polls
                        stall_s=stage_s, staging=self.staging_mode,
                        stage_wall_s=self.hmm.last_stats.wall_s)
        self.events.append(ev)
        return ev

    def switchover(self):
        """Commit the staged instance (the live cache grows or shrinks:
        surviving replicas' shards are reused, new ones zeroed) and rebind
        the engine to it; the surviving slots continue where they were.
        A scale-down needs its doomed slots empty (migrated or drained)."""
        if self._staged_cfg is None:
            raise RuntimeError("nothing is staged: stage_scale first")
        new_cfg = self._staged_cfg
        keep = new_cfg.dp * self.engine.batch_per_replica
        if new_cfg.ndev < self.engine.cfg.ndev and (
                not self.engine.drained(keep)
                or any(s.reserved for s in self.engine.slots[keep:])):
            raise RuntimeError(
                f"slots from {keep} on are still live: migrate or drain "
                f"them (start_scale) before the switchover")
        t0 = time.perf_counter()
        self.hmm.commit(live_cache=self.engine.cache)
        inst, params, cache, hit = self.imm.activate(new_cfg)
        self._bind(inst, params, cache)
        # the routing histogram described the old placement
        self.engine.reset_routing_stats()
        self.engine.admit_limit = None
        self._staged_cfg = None
        if self.events:
            self.events[-1].switch_s = time.perf_counter() - t0
            self.events[-1].compile_hit = hit

    def start_scale(self, target: ElasticConfig) -> EngineScalingTask:
        """Open a resumable scaling task; ``advance`` it between ticks
        (``scale_to`` is the blocking equivalent)."""
        if self.engine.cfg is None:
            raise RuntimeError("boot() the server before scaling it")
        return EngineScalingTask(self, target)

    # -------------------------------------------------------- scale to zero
    @property
    def parked(self) -> bool:
        return self.hmm.parked

    def park(self) -> TransferStats:
        """Scale to zero devices: the HMM snapshots every weight bank into
        pinned host memory, the engine drops its tensors and graphs, and
        the IMM every graph set this server captured, so the device memory
        is freed.  Legal only when idle (empty queue, no live slot, no
        scale in flight; an open rebalance is aborted), so a park never
        drops a request.  ``submit`` stays legal; ``start_unpark`` brings
        the server back."""
        if self._active_task is not None and not self._active_task.done:
            raise RuntimeError("cannot park during a scale event")
        self._preempt_rebalance()
        if self.queue or self.engine.active_count():
            raise RuntimeError("park requires a drained server (queue "
                               "empty, no live slots)")
        stats = self.hmm.park()
        self.engine.unbind()
        self.imm.release_all()
        self._staged_cfg = None
        return stats

    def start_unpark(self, target: ElasticConfig) -> UnparkTask:
        """Open a resumable cold start from the parked snapshot (the twin
        of ``start_scale``); ``advance`` it between ticks until DONE."""
        return UnparkTask(self, target)

    def _unpark_switchover(self, task: UnparkTask):
        """An unpark's commit: the HMM adopts the streamed weights and the
        fresh KV cache, and the engine binds the target's instance (its
        graphs captured during STAGING)."""
        t0 = time.perf_counter()
        target = task.target
        self.hmm.commit()
        inst, params, cache, hit = self.imm.activate(target)
        self._bind(inst, params, cache)
        self.engine.reset_routing_stats()
        self.engine.admit_limit = None
        ev = ScaleEvent(t=time.time(), src="parked", dst=target.describe(),
                        stats=self.hmm.last_stats,
                        compile_hit=(task._compile_hit
                                     if task._compile_hit is not None
                                     else hit),
                        stage_s=task.stats.wall_s,
                        switch_s=time.perf_counter() - t0,
                        stall_s=task.stall_s, staging=self.staging_mode,
                        stage_wall_s=(task.stage_stats.wall_s
                                      if task.stage_stats else 0.0))
        self.events.append(ev)
        task.event = ev

    # -------------------------------------------------------------- serving
    def submit(self, req: Request):
        kv = self.hmm.kv_blocks
        if kv is not None:
            # fail fast on a request no partition can EVER hold: admission
            # is FIFO head-of-line, so letting it queue would stall serving
            need = kv.blocks_needed(req.prompt_len + req.output_len)
            if need > kv.blocks_per_partition:
                raise ValueError(
                    f"request {req.rid} needs {need} KV blocks at completion"
                    f" but a partition holds {kv.blocks_per_partition}")
        self.requests[req.rid] = req
        self.queue.append(req)

    def tick(self, now: float) -> List[int]:
        """One engine tick: admit queued requests into free slots (FIFO;
        paged: gated by free KV blocks, the head request tries every free
        slot, longest registered prefix first) — a monolithic prefill runs
        here and gives the first token — then one engine tick of prefill
        chunks and decode.  While a scaling task is in flight new
        admissions pause and in-flight decodes continue (the shared
        ``admission_during_scale`` gate).  Sequences preempted under pool
        pressure re-enter at the front of the queue.  Returns rids
        finished this tick; parked, nothing serves ([]) and the queue
        accrues."""
        if self.parked:
            return []
        tr = obs.get_tracer()
        admitting = True
        if self._active_task is not None \
                and not self._active_task.phase.terminal:
            _, admitting = admission_during_scale("elastic")
        free = self.engine.free_slots()
        while admitting and self.queue and free:
            req = self.queue[0]
            slot = next((s for s in
                         self.engine.preferred_slots(req, req.prompt, free)
                         if self.engine.can_admit(req, req.prompt, s)), None)
            if slot is None:
                break                   # head-of-line blocks; no skipping
            free.remove(slot)
            self.queue.pop(0)
            tr.instant("req.admit", cat="req",
                       args={"rid": req.rid, "slot": slot})
            first = self.engine.start_request(req, req.prompt, slot)
            if first is None:
                continue    # chunked: the first token comes from decode_tick
            if req.first_token_s is None:
                req.first_token_s = now
                req.token_times = [now]
                tr.instant("req.first_token", cat="req",
                           args={"rid": req.rid})
            elif req.token_times is not None:   # preemption resume
                req.token_times.append(now)
        finished = []
        for rid in self.engine.drain_finished_at_admission():
            req = self.requests[rid]
            req.finish_s = now
            finished.append(rid)
            tr.instant("req.finish", cat="req", args={"rid": rid})
            if self.estimator:
                self.estimator.record(req)
        for rid, tok, fin in self.engine.decode_tick():
            req = self.requests[rid]
            if req.first_token_s is None:
                # the final chunk's token is the TTFT mark
                req.first_token_s = now
                req.token_times = [now]
                tr.instant("req.first_token", cat="req", args={"rid": rid})
            elif req.token_times is not None:
                req.token_times.append(now)
            if fin:
                req.finish_s = now
                finished.append(rid)
                tr.instant("req.finish", cat="req", args={"rid": rid})
                if self.estimator:
                    self.estimator.record(req)
        preempted = self.engine.drain_preempted()
        if preempted:
            self.queue[:0] = [self.requests[r] for r in preempted]
        # advance an open rebalance, or let the policy open one: its copies
        # run on the HMM's TransferEngine, so this does not block the tick
        self._drive_rebalance(now)
        return finished

    # ------------------------------------------------------------ decisions
    def autoscale_decision(self, now: float) -> Optional[str]:
        """The policy's 'up' | 'down' | None at ``now`` (None without a
        policy)."""
        if not self.estimator:
            return None
        return self.estimator.decide(now, len(self.queue), self.utilization())

    # --------------------------------------------- ServingBackend protocol
    def step(self, now: float) -> List[Request]:
        """One driver quantum == one engine tick; returns finished Requests."""
        return [self.requests[rid] for rid in self.tick(now)]

    def queue_depth(self) -> int:
        return len(self.queue)

    def utilization(self) -> float:
        return 0.0 if self.parked else self.engine.utilization()

    def kv_stats(self):
        """Block-pool stats (None for the dense layout)."""
        return self.engine.kv_stats()

    def routing_stats(self) -> Optional[dict]:
        """The routing histogram of the sampled decode ticks since the last
        placement change (None when sampling is off or before a sample)."""
        return self.engine.routing_stats()

    def scaling_summary(self) -> Optional[dict]:
        """Staging-overlap and migration totals over the recorded scale
        events (None before the first): ``decode_stall_s`` the serve
        loop's time blocked on staging, ``overlap_efficiency`` the mean of
        the ops' summed time over the staging wall."""
        if not self.events:
            return None
        effs = [ev.stats.op_s / ev.stage_wall_s for ev in self.events
                if ev.stage_wall_s > 0 and ev.stats.op_s > 0]
        return {"staging_mode": self.staging_mode,
                "scaledown_mode": self.scaledown_mode,
                "decode_stall_s": sum(ev.stall_s for ev in self.events),
                "overlap_efficiency":
                    sum(effs) / len(effs) if effs else None,
                "migrated_blocks": sum(ev.migrated_blocks
                                       for ev in self.events),
                "migration_bytes": sum(ev.migration_bytes
                                       for ev in self.events)}

    def current_config(self) -> Optional[ElasticConfig]:
        """The active configuration; None while parked."""
        return self.hmm.active_cfg

    # ---------------------------------------------------- expert rebalance
    def _preempt_rebalance(self) -> None:
        """Abort an open rebalance: a scale goes first, and the page table
        holds one session at a time."""
        task = self._rebalance_task
        if task is not None and not task.done:
            task.abort()

    def start_rebalance(self, actions: List, load=None) -> RebalanceTask:
        """Open a rebalance over explicit ``stage_rebalance`` actions;
        ``tick`` advances it to its end."""
        if self._rebalance_task is not None and not self._rebalance_task.done:
            raise RuntimeError("a rebalance is already in flight")
        return RebalanceTask(self, actions, load=load)

    def maybe_rebalance(self, now: float) -> Optional[RebalanceTask]:
        """One policy pass: the routing histogram goes to the
        ``RebalancePolicy``, and its actions, if any, open a
        ``RebalanceTask``.  A pool that cannot take them skips the pass
        (the policy tries again after its cooldown)."""
        if self.rebalance_policy is None or self.expert_mode != "pooled":
            return None
        stats = self.engine.routing_stats()
        cfg = self.hmm.active_cfg
        elm = (math.ceil(self.mcfg.num_experts / cfg.ndev)
               + self.hmm.expert_slot_slack)
        actions = self.rebalance_policy.decide(
            stats, self.hmm.page_table, cfg, now, slots_per_rank=elm)
        if not actions:
            return None
        try:
            return self.start_rebalance(actions, load=stats["counts"])
        except MemoryError as err:
            obs.get_tracer().instant("rebalance.skip", cat="rebalance",
                                     args={"reason": str(err)})
            return None

    def _drive_rebalance(self, now: float) -> None:
        """The per-tick rebalance pump: advance the open task, else ask the
        policy — never while a scale is in flight."""
        task = self._rebalance_task
        if task is not None and not task.done:
            task.advance(now)
            return
        if self.rebalance_policy is None:
            return
        if self._active_task is not None \
                and not self._active_task.phase.terminal:
            return
        self.maybe_rebalance(now)

    def rebalance_summary(self) -> Optional[dict]:
        """The rebalance passes' totals (None before the first pass)."""
        if not self.rebalance_events:
            return None
        done = [ev for ev in self.rebalance_events if not ev.aborted]
        return {"passes": len(done),
                "aborted": len(self.rebalance_events) - len(done),
                "replicated": sum(ev.replicated for ev in done),
                "demoted": sum(ev.demoted for ev in done),
                "dropped": sum(ev.dropped for ev in done),
                "promoted": sum(ev.promoted for ev in done),
                "replica_bytes": sum(ev.stats.expert_replica_bytes
                                     for ev in done if ev.stats),
                "d2h_bytes": sum(ev.stats.expert_d2h_bytes
                                 for ev in done if ev.stats),
                "host_tier_bytes": self.hmm.host_tier_bytes()}

    def capacity(self, cfg: ElasticConfig) -> int:
        return cfg.dp * self.engine.batch_per_replica
