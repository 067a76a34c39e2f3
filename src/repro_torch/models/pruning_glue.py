"""Glue between the paper's pruning (core/) and the model params (the ViT
and the dense, MoE, hybrid and SSM LMs) — the port of the reference
package's ``models/pruning_glue.py``: identify prunable weights in a param
tree, create score parameters, and produce masked params and hard block
masks.

Prunable groups:
  * attention projections  wq/wk/wv/wo (block scores), the hybrid's
    ``shared_attn`` block among them
  * MLP / expert FFN       wi, wg (column score vector), wo (row score
    vector); RWKV6's channel mix ``cm_wk`` (columns) and ``cm_wv`` (rows)
  * everything else (embeddings, norms, the router, head, the Mamba2 and
    RWKV6 time-mix projections and the scans' parameters) is dense.

Paths are strings like ``layers/{i}/attn/wq`` and the tree is walked in
the reference's order (dict keys sorted, lists by index). The port keeps
one dict per layer, so a prunable leaf is one 2-D matrix with its own
scores (per layer and matrix, as in the paper), except an MoE layer's
expert banks ``layers/{i}/moe/w*`` [E, M1, M2]: each expert's matrix owns
its own score vector (scores [E, n]) and keeps its own top-k, as the
reference's vmap over the stacked axes gives. The reference stacks the
LMs' layers (``layers/attn/wq`` [L, ...]), and
``convert.lm_scores_from_jax`` splits its scores into these paths. The
ViT's paths are the reference's own.
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


def _check_shape(path: Path, leaf: torch.Tensor, kind: str) -> None:
    """A prunable leaf is one matrix, or an MoE layer's expert bank [E, M1,
    M2] pruned by columns or rows."""
    if leaf.ndim == 2 or (leaf.ndim == 3 and kind in ("col", "row")
                          and "moe" in path and "shared" not in path):
        return
    raise NotImplementedError(
        f"{_path_str(path)}: stacked layer axes (shape {tuple(leaf.shape)}) "
        f"are not taken: the port keeps one 2-D weight per layer and "
        f"matrix (an MoE layer's expert banks [E, M1, M2] by columns or "
        f"rows); convert the reference's stacked LM trees with "
        f"convert.lm_params_from_jax / lm_scores_from_jax")


def init_scores(cfg: ModelConfig, params: Dict,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Score dict {path: scores} at the prunable leaves, drawn in tree
    order from ``generator`` (an expert bank's expert by expert)."""
    b = cfg.pruning.block_size
    out = {}
    for path, leaf in flatten_with_path(params):
        kind = prunable_kind(path, leaf)
        if kind is None:
            continue
        _check_shape(path, leaf, kind)
        out[_path_str(path)] = BP.init_scores_for(leaf, b, kind, generator)
    return out


def apply_pruning(cfg: ModelConfig, params: Dict, scores: Dict,
                  r_b: float | None = None) -> Dict:
    """Masked params for the forward pass: differentiable in ``params``
    and, through the straight-through estimator, in ``scores``. An expert
    bank's experts each keep their own top-k."""
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
        _check_shape(path, leaf, kind)
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
        _check_shape(path, leaf, kind)
        out[ps] = BP.hard_block_mask(scores[ps], p.r_b, tuple(leaf.shape),
                                     p.block_size)
    return out
