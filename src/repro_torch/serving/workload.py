"""Requests: the port's own copy of ``repro.serving.workload.Request``
(the synthetic workload generators are not ported yet)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    arrival_s: float
    prompt_len: int
    output_len: int
    prompt: Optional[np.ndarray] = None      # token ids (engine runs)
    priority: int = 0                        # paged KV: preemption order

    # filled by the engine
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    token_times: Optional[List[float]] = None

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s
