"""Token-budget chunk scheduler for continuous batching (DESIGN.md §8).

The port's own copy of ``repro.serving.scheduler`` (pure host-side policy;
the port imports nothing of the JAX package), driven by the port's
``serving/engine.py``.

Each engine tick runs one decode step for every active slot plus at most
``budget`` prefill tokens, consumed as fixed-size ``chunk``-token buckets
(one compiled shape) in admission (FIFO) order.  A chunk is only scheduled
when the remaining per-tick budget covers its valid tokens — chunks are
never split below the bucket, so in paged mode every non-final chunk
boundary stays block-aligned.  Prefix-cache-aware admission seeds a job's
``pos`` past the CoW-shared prefix, charging only the non-shared tail.

Properties pinned by tests/test_scheduler_properties.py: the per-tick
budget is never exceeded; each job's chunks arrive in order and exactly
cover ``[skip, total)``; decode never starves (every tick decodes all
active slots regardless of prefill backlog).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch import obs


@dataclass
class PrefillJob:
    """One admitted request's outstanding prefill work.

    ``pos`` is the next un-prefilled token (starts at the prefix-cache skip,
    always block-aligned in paged mode); ``total`` the full prompt length.
    ``paused`` freezes a job (its blocks are mid-migration).
    """
    slot: int
    rid: int
    pos: int
    total: int
    paused: bool = False

    @property
    def remaining(self) -> int:
        return self.total - self.pos


@dataclass(frozen=True)
class ChunkPlan:
    """One scheduled prefill chunk: ``take`` valid tokens at ``start``
    (the compiled bucket may be wider; the tail is padding)."""
    slot: int
    rid: int
    start: int
    take: int
    final: bool


@dataclass
class TokenBudgetScheduler:
    """Plans which prefill chunks run this tick.

    ``chunk``: compiled bucket width in tokens (engine: ``prefill_chunk``).
    ``budget``: max prefill tokens charged per tick; defaults to ``chunk``
    (one full bucket).  Decode tokens are not charged against it — decode
    runs every tick for every active slot by construction, which is the
    no-starvation guarantee.
    """
    chunk: int
    budget: Optional[int] = None

    def __post_init__(self):
        assert self.chunk > 0
        if self.budget is None:
            self.budget = self.chunk
        assert self.budget >= self.chunk, \
            "budget below one chunk would stall prefill forever"

    def plan(self, jobs: List[PrefillJob]) -> List[ChunkPlan]:
        """FIFO, no skipping: the head job drains before later jobs see any
        budget, and planning stops at the first job whose next chunk does
        not fit — order is admission order, so TTFT stays FIFO-fair."""
        out: List[ChunkPlan] = []
        left = self.budget
        for job in jobs:
            if job.paused:
                continue
            pos = job.pos
            while pos < job.total:
                take = min(self.chunk, job.total - pos)
                if take > left:
                    return self._record(out)
                out.append(ChunkPlan(slot=job.slot, rid=job.rid, start=pos,
                                     take=take, final=pos + take == job.total))
                pos += take
                left -= take
            if left <= 0:
                break
        return self._record(out)

    @staticmethod
    def _record(out: List[ChunkPlan]) -> List[ChunkPlan]:
        # shared policy code => one instrumentation point covers both
        # backends (DESIGN.md §9); no-op under the NULL_TRACER
        tr = obs.get_tracer()
        if tr.enabled and out:
            tr.instant("chunk.plan", cat="serve",
                       args={"chunks": len(out),
                             "tokens": sum(p.take for p in out),
                             "rids": sorted({p.rid for p in out})})
        return out


def prefix_skip(num_shared: int, block_size: int, prompt_len: int) -> int:
    """Block-aligned prefill start for a prompt whose first ``num_shared``
    blocks were matched in the CoW prefix registry.

    At least one token is always computed (the last position's logits
    sample the first output token), so when the shared prefix covers the
    whole prompt the start rounds down to the last block boundary before
    ``prompt_len - 1`` — those few recomputed tokens land on sentinel
    (shared) rows and are dropped, not rewritten.
    """
    if num_shared <= 0:
        return 0
    return min(num_shared * block_size,
               ((prompt_len - 1) // block_size) * block_size)
