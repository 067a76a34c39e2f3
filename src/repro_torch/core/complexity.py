"""Token-count helpers shared by the serving layers (host-side copy of the
counterpart in the reference package's ``core/complexity.py``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def vit_num_tokens(cfg: ModelConfig) -> int:
    n_patches = (cfg.image_size // cfg.patch_size) ** 2
    return n_patches + 1  # + CLS
