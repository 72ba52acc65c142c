"""The Coordinator's SLO-aware load estimator (paper §4.3) — the port's
own copy of ``repro.core.coordinator``: windowed SLO attainment and the
queue turn into 'up' / 'down' decisions, with a cooldown and an optional
persistence requirement against flapping.  ``serving/driver.py``'s
``ClusterDriver`` picks the target for a decision."""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Optional

from repro_torch.serving.metrics import SLO, meets_slo
from repro_torch.serving.workload import Request


@dataclasses.dataclass
class ScalingPolicy:
    """Scale up when the windowed attainment drops below
    ``low_watermark`` or the queue reaches ``queue_scale_up``; scale down
    when attainment stays at or above ``high_watermark`` with utilization
    below ``idle_utilization`` and an empty queue.

    ``confirm_s``: the raw signal must persist continuously this many
    seconds before a direction is emitted (0: act at once).  The driver
    asks every tick, so persistence in time, not a count of calls, is the
    guard against a momentary blip; ``cooldown_s`` is the other.
    """
    slo: SLO
    low_watermark: float = 0.90
    high_watermark: float = 0.98
    window: int = 32                  # requests per decision window
    cooldown_s: float = 20.0
    queue_scale_up: int = 8           # also scale up on queue backlog
    confirm_s: float = 0.0
    idle_utilization: float = 0.4


class LoadEstimator:
    def __init__(self, policy: ScalingPolicy):
        self.policy = policy
        self.recent: Deque[bool] = deque(maxlen=policy.window)
        self.last_action_t: float = -1e9
        self._sig_dir: Optional[str] = None
        self._sig_t0: float = 0.0

    def record(self, req: Request):
        ok = meets_slo(req, self.policy.slo)
        if ok is not None:
            self.recent.append(ok)

    def attainment(self) -> Optional[float]:
        if len(self.recent) < max(4, self.policy.window // 4):
            return None
        return sum(self.recent) / len(self.recent)

    def _raw_signal(self, queue_depth: int,
                    utilization: float) -> Optional[str]:
        att = self.attainment()
        if queue_depth >= self.policy.queue_scale_up or \
                (att is not None and att < self.policy.low_watermark):
            return "up"
        if att is not None and att >= self.policy.high_watermark \
                and utilization < self.policy.idle_utilization \
                and queue_depth == 0:
            return "down"
        return None

    def decide(self, now: float, queue_depth: int,
               utilization: float) -> Optional[str]:
        """'up' | 'down' | None.  A direction commits the decision: the
        cooldown starts and the attainment window empties."""
        if now - self.last_action_t < self.policy.cooldown_s:
            # drop a tracked signal: confirm_s asks for continuous
            # presence, and presence during a cooldown is unobserved
            self._sig_dir = None
            return None
        sig = self._raw_signal(queue_depth, utilization)
        if sig is None:
            self._sig_dir = None
            return None
        if sig != self._sig_dir:
            self._sig_dir, self._sig_t0 = sig, now
        if now - self._sig_t0 < self.policy.confirm_s:
            return None
        self.last_action_t = now
        self.recent.clear()
        self._sig_dir = None
        return sig
