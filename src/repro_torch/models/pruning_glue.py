"""Glue between the paper's pruning (core/) and the ViT params — the port
of the reference package's ``models/pruning_glue.py``: identify prunable
weights in a param tree, create score parameters, and produce masked
params and hard block masks.

Prunable groups:
  * attention projections  wq/wk/wv/wo (block scores)
  * MLP                    wi (column score vector), wo (row score vector)
  * everything else (embeddings, norms, head) is dense.

Paths are the reference's strings (``layers/{i}/attn/wq``) and the tree
is walked in the reference's order (dict keys sorted, lists by index), so
a scores dict converted from the reference package keys the same leaves.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import block_pruning as BP

_ATTN_KEYS = {"wq": "block", "wk": "block", "wv": "block", "wo": "block"}
_MLP_COL = {"wi", "wg", "cm_wk"}
_MLP_ROW = {"wo", "cm_wv"}

Path = Tuple[Any, ...]


def flatten_with_path(tree) -> Iterator[Tuple[Path, torch.Tensor]]:
    """Leaves of a nested dict/list tree with their key paths, in the
    order ``jax.tree_util`` flattens the same tree (sorted dict keys)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            for path, leaf in flatten_with_path(tree[key]):
                yield (key,) + path, leaf
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            for path, leaf in flatten_with_path(sub):
                yield (i,) + path, leaf
    else:
        yield (), tree


def map_with_path(fn, tree, path: Path = ()):
    """Rebuild ``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _path_str(path: Path) -> str:
    return "/".join(str(p) for p in path)


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
            f"{ps}: stacked layer axes belong to the LM families, which "
            f"this package does not serve yet (ROADMAP queue A, LM path)")


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
    """Masked params for the forward pass."""
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
