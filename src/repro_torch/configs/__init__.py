"""Config registry: ``get_config("<arch-id>")``."""
from __future__ import annotations

from typing import Dict

from .base import ModelConfig, PruningConfig
from .archs import DEIT_SMALL

_REGISTRY: Dict[str, ModelConfig] = {DEIT_SMALL.name: DEIT_SMALL}


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


__all__ = ["ModelConfig", "PruningConfig", "get_config", "DEIT_SMALL"]
