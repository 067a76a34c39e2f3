"""Static block weight pruning (paper §IV-A), forward half — the port of
the reference package's ``core/block_pruning.py``.

Every prunable weight ``W ∈ R^{M1×M2}`` owns a score matrix
``S ∈ R^{⌈M1/b⌉×⌈M2/b⌉}`` (one score per ``b×b`` block). The binary mask is
built by global top-k selection over ``S`` (keep rate ``r_b``) and applied
as ``W ⊙ M``. MLP weights are pruned by whole columns / rows via score
vectors (paper Fig. 3). The straight-through estimator that trains the
scores belongs to the training slice; here the mask is a plain forward.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


def _hard_topk(scores: torch.Tensor, keep: int) -> torch.Tensor:
    """Binary mask keeping the ``keep`` largest entries of ``scores``;
    ties at the threshold are kept (the reference's rule)."""
    flat = scores.reshape(-1)
    keep = int(keep)
    if keep >= flat.shape[0]:
        return torch.ones_like(scores)
    if keep <= 0:
        return torch.zeros_like(scores)
    kth = torch.sort(flat, descending=True).values[keep - 1]
    return (scores >= kth).to(scores.dtype)


def score_shape(w_shape: Tuple[int, int], block_size: int) -> Tuple[int, int]:
    m1, m2 = w_shape
    b = block_size
    return (math.ceil(m1 / b), math.ceil(m2 / b))


def expand_block_mask(block_mask: torch.Tensor, w_shape: Tuple[int, int],
                      block_size: int) -> torch.Tensor:
    """Expand a (m, n) block mask to a full (M1, M2) element mask."""
    b = block_size
    full = block_mask.repeat_interleave(b, dim=0).repeat_interleave(b, dim=1)
    return full[: w_shape[0], : w_shape[1]]


def num_kept_blocks(w_shape: Tuple[int, int], block_size: int,
                    r_b: float) -> int:
    m, n = score_shape(w_shape, block_size)
    return max(1, math.ceil(m * n * r_b))


def masked_weight(w: torch.Tensor, scores: torch.Tensor, r_b: float,
                  block_size: int) -> torch.Tensor:
    """``W ⊙ M`` with the mask derived from block ``scores``."""
    if r_b >= 1.0:
        return w
    keep = num_kept_blocks(tuple(w.shape), block_size, r_b)
    bm = _hard_topk(scores, keep)
    full = expand_block_mask(bm, tuple(w.shape), block_size)
    return w * full.to(w.dtype)


def masked_weight_vector(w: torch.Tensor, scores: torch.Tensor, r_b: float,
                         axis: int) -> torch.Tensor:
    """MLP column (``axis=1``) / row (``axis=0``) pruning via top-k on a
    score vector of length ``w.shape[axis]``."""
    if r_b >= 1.0:
        return w
    n = w.shape[axis]
    keep = max(1, math.ceil(n * r_b))
    m = _hard_topk(scores, keep)
    shape = [1, 1]
    shape[axis] = n
    return w * m.reshape(shape).to(w.dtype)


def init_scores_for(w: torch.Tensor, block_size: int, kind: str,
                    generator: torch.Generator) -> torch.Tensor:
    """Score parameter for weight ``w``: "block" -> 2-D block scores;
    "col"/"row" -> score vector for MLP column/row pruning. Small random
    init, drawn from ``generator`` on the CPU and moved to ``w``'s
    device."""
    if kind == "block":
        shape = score_shape(tuple(w.shape), block_size)
    elif kind == "col":
        shape = (w.shape[1],)
    elif kind == "row":
        shape = (w.shape[0],)
    else:
        raise ValueError(kind)
    s = 0.01 * torch.randn(shape, generator=generator, dtype=torch.float32)
    return s.to(w.device)


def hard_block_mask(scores: torch.Tensor, r_b: float,
                    w_shape: Tuple[int, int],
                    block_size: int) -> torch.Tensor:
    keep = num_kept_blocks(w_shape, block_size, r_b)
    return _hard_topk(scores, keep)
