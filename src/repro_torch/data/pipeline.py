"""Deterministic synthetic data for every modality the port trains — the
port of the reference package's ``data/pipeline.py`` (numpy only; the
same draws, so both packages make bit-identical batches).

Batch ``i`` is a pure function of (seed, step, shard), so any replacement
host can recompute its shard without coordination, and a restart resumes
mid-epoch exactly (``dist/fault.RestartableLoop`` relies on it). Batches
are host arrays; a step moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    num_shards: int = 1
    shard_index: int = 0


def _rng(seed: int, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, shard]))


def synthetic_lm_batch(cfg: ModelConfig, shape: ShapeConfig, dc: DataConfig,
                       step: int, local_batch: Optional[int] = None
                       ) -> Dict[str, np.ndarray]:
    """Markov-ish synthetic tokens (learnable structure, not uniform noise:
    token t+1 ~ (t*7 + 11 + noise) mod V), so a falling train loss is a
    real signal."""
    B = local_batch or shape.global_batch // dc.num_shards
    S = shape.seq_len
    g = _rng(dc.seed, step, dc.shard_index)
    first = g.integers(0, cfg.vocab_size, size=(B, 1))
    noise = g.integers(0, 3, size=(B, S - 1))
    toks = [first]
    for i in range(S - 1):
        toks.append((toks[-1] * 7 + 11 + noise[:, i:i + 1]) % cfg.vocab_size)
    batch = {"tokens": np.concatenate(toks, axis=1).astype(np.int32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = g.standard_normal(
            (B, cfg.num_vision_tokens, cfg.vision_d_model or cfg.d_model),
            dtype=np.float32).astype(np.float32)
    if cfg.family == "audio":
        batch["audio_frames"] = g.standard_normal(
            (B, cfg.num_audio_frames, cfg.d_model)).astype(np.float32)
        batch["tokens"] = batch["tokens"][:, : max(S // 8, 8)]
    return batch


def synthetic_vit_batch(cfg: ModelConfig, batch_size: int, dc: DataConfig,
                        step: int) -> Dict[str, np.ndarray]:
    """Class-conditional Gaussian patches: images of class c are centered
    at pattern(c), so a ViT can actually fit them."""
    g = _rng(dc.seed, step, dc.shard_index)
    n = (cfg.image_size // cfg.patch_size) ** 2
    pdim = cfg.patch_size ** 2 * 3
    labels = g.integers(0, cfg.num_classes, size=(batch_size,))
    centers = _class_centers(cfg.num_classes, n, pdim, dc.seed)
    patches = centers[labels] + 0.5 * g.standard_normal(
        (batch_size, n, pdim)).astype(np.float32)
    return {"patches": patches.astype(np.float32),
            "labels": labels.astype(np.int32)}


# class centers per (classes, patches, patch dim, seed): 602 MB of fp32 at
# full-width DeiT-Small, so each is drawn once per process
_center_cache: Dict = {}


def _class_centers(num_classes: int, n: int, pdim: int, seed: int):
    key = (num_classes, n, pdim, seed)
    if key not in _center_cache:
        g = np.random.default_rng(seed + 1234)
        _center_cache[key] = g.standard_normal(
            (num_classes, n, pdim)).astype(np.float32)
    return _center_cache[key]


def batches(cfg: ModelConfig, shape: ShapeConfig, dc: DataConfig,
            start_step: int = 0, local_batch: Optional[int] = None
            ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield synthetic_lm_batch(cfg, shape, dc, step, local_batch)
        step += 1
