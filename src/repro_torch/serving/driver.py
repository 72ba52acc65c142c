"""The scaling task's phases — the port's own copy of the parts of
``repro.serving.driver`` that a server scaling while it serves needs: the
``ScalePhase`` machine, the ``ScalingTask`` protocol and the shared
admission gate.  The closed loop itself (``ClusterDriver``, ``DevicePool``)
is not ported yet.

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

import enum
from typing import Protocol, Tuple

from repro_torch.core.topology import ElasticConfig


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
