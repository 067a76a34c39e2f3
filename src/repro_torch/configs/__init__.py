"""Config registry: ``get_config("<arch-id>")``."""
from __future__ import annotations

from typing import Dict

from .base import ModelConfig, PruningConfig
from .archs import (COMMAND_R_PLUS_104B, DEIT_SMALL, GRANITE_MOE_3B_A800M,
                    LLAMA_3_2_VISION_90B, MINITRON_4B, QWEN2_MOE_A2_7B,
                    QWEN3_14B, RWKV6_1_6B, STABLELM_1_6B, WHISPER_BASE,
                    ZAMBA2_1_2B)

_REGISTRY: Dict[str, ModelConfig] = {
    c.name: c for c in (DEIT_SMALL, COMMAND_R_PLUS_104B, QWEN3_14B,
                        MINITRON_4B, STABLELM_1_6B, QWEN2_MOE_A2_7B,
                        GRANITE_MOE_3B_A800M, LLAMA_3_2_VISION_90B,
                        WHISPER_BASE, ZAMBA2_1_2B, RWKV6_1_6B)}


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


__all__ = ["ModelConfig", "PruningConfig", "get_config", "DEIT_SMALL",
           "COMMAND_R_PLUS_104B", "QWEN3_14B", "MINITRON_4B",
           "STABLELM_1_6B", "QWEN2_MOE_A2_7B", "GRANITE_MOE_3B_A800M",
           "LLAMA_3_2_VISION_90B", "WHISPER_BASE", "ZAMBA2_1_2B",
           "RWKV6_1_6B"]
