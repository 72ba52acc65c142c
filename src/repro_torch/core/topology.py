"""Elastic instance topology: the port's own copy of the parts of
``repro.core.topology`` the serving and scaling paths use (the logical
tensor descriptions that the cost planner reads are not ported).

Conventions (paper §2.1, §4.1): an instance runs on ``dp * tp`` devices,
experts are EP-distributed with ``ep = dp * tp``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """One serving configuration: which devices, and how they're organized."""
    dp: int
    tp: int
    devices: Tuple[int, ...]           # global device ids, slot order

    def __post_init__(self):
        if len(self.devices) != self.dp * self.tp:
            raise ValueError(
                f"{self.dp}x{self.tp} != {len(self.devices)} devices")

    @property
    def ep(self) -> int:
        return self.dp * self.tp       # paper's EP = TP x DP convention

    @property
    def ndev(self) -> int:
        return len(self.devices)

    def slot(self, device: int) -> int:
        return self.devices.index(device)

    def tp_rank(self, device: int) -> int:
        return self.slot(device) % self.tp

    def dp_rank(self, device: int) -> int:
        return self.slot(device) // self.tp

    def ep_rank(self, device: int) -> int:
        return self.slot(device)       # one EP rank per device

    def describe(self) -> str:
        return f"DP{self.dp}-TP{self.tp}-EP{self.ep}@{list(self.devices)}"


def expert_owner(expert: int, num_experts: int, cfg: ElasticConfig) -> int:
    """Device owning ``expert`` under round-robin-contiguous EP placement."""
    per = math.ceil(num_experts / cfg.ep)
    rank = min(expert // per, cfg.ep - 1)
    return cfg.devices[rank]
