"""Config registry of the port: ``get_config(name)``.

The port serves one model so far, qwen3-30b-a3b; the other reference
architectures join as their paths are ported.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.qwen3_30b_a3b import CONFIG as _qwen3moe

REGISTRY = {c.name: c for c in (_qwen3moe,)}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return reduced(get_config(name[: -len("-smoke")]))
    if name not in REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ModelConfig", "REGISTRY", "get_config", "reduced"]
