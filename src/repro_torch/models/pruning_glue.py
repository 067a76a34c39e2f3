"""Glue between the paper's pruning (core/) and the model params (the ViT
and the dense LMs) — the port of the reference package's
``models/pruning_glue.py``: identify prunable weights in a param tree,
create score parameters, and produce masked params and hard block masks.

Prunable groups:
  * attention projections  wq/wk/wv/wo (block scores)
  * MLP                    wi (column score vector), wo (row score vector)
  * everything else (embeddings, norms, head) is dense.

Paths are strings like ``layers/{i}/attn/wq`` and the tree is walked in
the reference's order (dict keys sorted, lists by index). The port keeps
one dict per layer, so every prunable leaf is 2-D and owns its own scores
(per layer and matrix, as in the paper); the reference stacks the LMs'
layers (``layers/attn/wq`` [L, ...]), and ``convert.lm_scores_from_jax``
splits its scores into these paths. The ViT's paths are the reference's
own.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import block_pruning as BP
from repro_torch.tree import Path, flatten_with_path, map_with_path
from repro_torch.tree import path_str as _path_str

_ATTN_KEYS = {"wq": "block", "wk": "block", "wv": "block", "wo": "block"}
_MLP_COL = {"wi", "wg", "cm_wk"}
_MLP_ROW = {"wo", "cm_wv"}


def prunable_kind(path: Path, leaf: torch.Tensor) -> str | None:
    """Return "block" | "col" | "row" | None for a param leaf."""
    if leaf.ndim < 2:
        return None
    keys = [p for p in path if isinstance(p, str)]
    k = keys[-1] if keys else ""
    if any(p in ("attn", "xattn", "shared_attn") for p in keys) \
            and k in _ATTN_KEYS:
        return "block"
    if any(p in ("mlp", "moe", "shared", "cm_wk", "cm_wv") for p in keys):
        if k in _MLP_COL:
            return "col"
        if k in _MLP_ROW:
            return "row"
    return None


def _check_2d(ps: str, leaf: torch.Tensor) -> None:
    if leaf.ndim != 2:
        raise NotImplementedError(
            f"{ps}: stacked layer axes (shape {tuple(leaf.shape)}) are not "
            f"taken: the port keeps one 2-D weight per layer and matrix; "
            f"convert the reference's stacked LM trees with "
            f"convert.lm_params_from_jax / lm_scores_from_jax")


def init_scores(cfg: ModelConfig, params: Dict,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Score dict {path: scores} at the prunable leaves, drawn in tree
    order from ``generator``."""
    b = cfg.pruning.block_size
    out = {}
    for path, leaf in flatten_with_path(params):
        kind = prunable_kind(path, leaf)
        if kind is None:
            continue
        ps = _path_str(path)
        _check_2d(ps, leaf)
        out[ps] = BP.init_scores_for(leaf, b, kind, generator)
    return out


def apply_pruning(cfg: ModelConfig, params: Dict, scores: Dict,
                  r_b: float | None = None) -> Dict:
    """Masked params for the forward pass: differentiable in ``params``
    and, through the straight-through estimator, in ``scores``."""
    p = cfg.pruning
    if r_b is None:
        r_b = p.r_b
    if r_b >= 1.0 or not scores:
        return params
    b = p.block_size

    def mask_one(path, leaf):
        kind = prunable_kind(path, leaf)
        ps = _path_str(path)
        if kind is None or ps not in scores:
            return leaf
        if (kind == "block" and not p.prune_msa) or \
                (kind in ("col", "row") and not p.prune_mlp):
            return leaf
        _check_2d(ps, leaf)
        s = scores[ps]
        if kind == "block":
            return BP.masked_weight(leaf, s, r_b, b)
        return BP.masked_weight_vector(leaf, s, r_b,
                                       axis=1 if kind == "col" else 0)

    return map_with_path(mask_one, params)


def regularizer(scores: Dict) -> torch.Tensor:
    """Eq. 8: Σ σ(S) over all score tensors (λ applied by the caller)."""
    return BP.sparsity_regularizer(scores)


def hard_masks(cfg: ModelConfig, params: Dict,
               scores: Dict) -> Dict[str, torch.Tensor]:
    """Binary block masks for packing / size accounting."""
    p = cfg.pruning
    out = {}
    for path, leaf in flatten_with_path(params):
        kind = prunable_kind(path, leaf)
        ps = _path_str(path)
        if kind != "block" or ps not in scores:
            continue
        _check_2d(ps, leaf)
        out[ps] = BP.hard_block_mask(scores[ps], p.r_b, tuple(leaf.shape),
                                     p.block_size)
    return out
