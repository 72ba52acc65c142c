"""Config registry of the port: ``get_config(name)``.

The port serves qwen3-30b-a3b (standard attention), the MLA models
deepseek-v2-lite-16b and deepseek-v3 (the latter at ``reduced()`` size
only), the Mamba2 models mamba2-1.3b (attention-free) and zamba2-2.7b
(hybrid, one shared attention block), and the dense decoders yi-6b,
qwen1.5-0.5b, stablelm-3b and chatglm3-6b with arctic-480b (a MoE with a
dense residual MLP); the other reference architectures (the VLM, the
encoder) join as their paths are ported.
"""
from __future__ import annotations

from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.chatglm3_6b import CONFIG as _chatglm3
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as _dsv2lite
from repro_torch.configs.deepseek_v3 import CONFIG as _dsv3
from repro_torch.configs.mamba2_13b import CONFIG as _mamba2
from repro_torch.configs.qwen15_05b import CONFIG as _qwen15
from repro_torch.configs.qwen3_30b_a3b import CONFIG as _qwen3moe
from repro_torch.configs.stablelm_3b import CONFIG as _stablelm
from repro_torch.configs.yi_6b import CONFIG as _yi
from repro_torch.configs.zamba2_27b import CONFIG as _zamba2

REGISTRY = {c.name: c for c in (_dsv2lite, _qwen3moe, _dsv3, _mamba2,
                                _zamba2, _yi, _qwen15, _stablelm, _chatglm3,
                                _arctic)}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return reduced(get_config(name[: -len("-smoke")]))
    if name not in REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ModelConfig", "REGISTRY", "get_config", "reduced"]
