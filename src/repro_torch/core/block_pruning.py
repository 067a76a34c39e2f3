"""Static block weight pruning (paper §IV-A) — the port of the reference
package's ``core/block_pruning.py``.

Every prunable weight ``W ∈ R^{M1×M2}`` owns a learnable score matrix
``S ∈ R^{⌈M1/b⌉×⌈M2/b⌉}`` (one score per ``b×b`` block). The binary mask is
built by global top-k selection over ``S`` (keep rate ``r_b``) and applied
as ``W ⊙ M``. Gradients reach ``S`` through a straight-through estimator
(:class:`SteTopkMask`) that treats the top-k as the identity:

    forward :  M = 1[S ∈ top-k(S)]
    backward:  dL/dS_ij = Σ_{(u,v) ∈ block ij} dL/d(W⊙M)_uv · W_uv

MLP weights are pruned by whole columns (``wi``) / rows (``wo``) via score
vectors (paper Fig. 3); MSA weights use 2-D block scores, with the
alternate pattern tying a ``W_p`` block column to a ``W_proj`` block row
(paper Fig. 2). The sparsity regularizer (Eq. 8) is ``λ · Σ σ(S)``.

A stack of matrices ``[..., M1, M2]`` (an MoE layer's expert bank) owns one
score vector per matrix (``[..., M2]`` or ``[..., M1]``) and keeps the top-k
of each, as the reference's vmap over its leading axes does; the top-k of
every matrix is taken in one batched pass.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.tree import leaves


def _hard_topk(scores: torch.Tensor, keep: int,
               lead: int = 0) -> torch.Tensor:
    """Binary mask keeping the ``keep`` largest entries of ``scores``;
    ties at the threshold are kept (the reference's rule). With ``lead``
    leading axes, the top-k is taken per index of those axes (one sort
    along the rest, each row's ``keep``-th value its threshold)."""
    flat = scores.reshape(scores.shape[:lead] + (-1,))
    keep = int(keep)
    if keep >= flat.shape[-1]:
        return torch.ones_like(scores)
    if keep <= 0:
        return torch.zeros_like(scores)
    kth = torch.sort(flat, dim=-1, descending=True).values[..., keep - 1:keep]
    return (flat >= kth).reshape(scores.shape).to(scores.dtype)


class SteTopkMask(torch.autograd.Function):
    """Straight-through top-k mask: the forward is :func:`_hard_topk`, the
    backward passes the cotangent through unchanged (no gradient to
    ``keep``)."""

    @staticmethod
    def forward(ctx, scores: torch.Tensor, keep: int,
                lead: int = 0) -> torch.Tensor:
        return _hard_topk(scores, keep, lead)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None, None


def ste_topk_mask(scores: torch.Tensor, keep: int,
                  lead: int = 0) -> torch.Tensor:
    """Binary mask keeping the ``keep`` largest entries of ``scores`` (ties
    at the threshold kept; per index of the ``lead`` leading axes), with
    the straight-through gradient."""
    return SteTopkMask.apply(scores, int(keep), int(lead))


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
    """``W ⊙ M`` with the STE mask derived from block ``scores``."""
    if r_b >= 1.0:
        return w
    keep = num_kept_blocks(tuple(w.shape), block_size, r_b)
    bm = ste_topk_mask(scores, keep)
    full = expand_block_mask(bm, tuple(w.shape), block_size)
    return w * full.to(w.dtype)


def masked_weight_vector(w: torch.Tensor, scores: torch.Tensor, r_b: float,
                         axis: int) -> torch.Tensor:
    """MLP column (``axis=1``) / row (``axis=0``) pruning via top-k on a
    score vector of length ``M2`` / ``M1``. ``w`` may be a stack ``[...,
    M1, M2]`` with ``scores`` ``[..., n]``: each matrix keeps its own
    top-k."""
    if r_b >= 1.0:
        return w
    lead = w.ndim - 2
    n = w.shape[lead + axis]
    keep = max(1, math.ceil(n * r_b))
    m = ste_topk_mask(scores, keep, lead)
    shape = list(w.shape[:lead]) + [1, 1]
    shape[lead + axis] = n
    return w * m.reshape(shape).to(w.dtype)


def alternate_tie_mask(block_mask_p: torch.Tensor) -> torch.Tensor:
    """Alternate pattern (paper Fig. 2): a fully pruned block column of
    ``W_p`` makes the matching block row of ``W_proj`` redundant. Returns
    the per-block-row keep vector of ``W_proj``."""
    return (block_mask_p.sum(dim=0) > 0).to(block_mask_p.dtype)


def head_retained_ratio(block_mask_p: torch.Tensor,
                        heads: int) -> torch.Tensor:
    """Fraction of heads with at least one surviving block column (paper
    Table VI "Head Retained Ratio")."""
    n = block_mask_p.shape[1]
    per_head = block_mask_p.reshape(block_mask_p.shape[0], heads, n // heads)
    return (per_head.sum(dim=(0, 2)) > 0).float().mean()


def init_scores_for(w: torch.Tensor, block_size: int, kind: str,
                    generator: torch.Generator) -> torch.Tensor:
    """Score parameter for weight ``w``: "block" -> 2-D block scores;
    "col"/"row" -> score vector for MLP column/row pruning. Small random
    init, drawn from ``generator`` on the CPU and moved to ``w``'s
    device. A stack ``w`` [..., M1, M2] gets one score tensor per matrix,
    drawn matrix by matrix in order."""
    m1, m2 = w.shape[-2:]
    if kind == "block":
        shape = score_shape((m1, m2), block_size)
    elif kind == "col":
        shape = (m2,)
    elif kind == "row":
        shape = (m1,)
    else:
        raise ValueError(kind)
    lead = tuple(w.shape[:-2])
    s = torch.stack([
        0.01 * torch.randn(shape, generator=generator, dtype=torch.float32)
        for _ in range(math.prod(lead))])
    return s.reshape(lead + tuple(shape)).to(w.device)


def sparsity_regularizer(scores_tree) -> torch.Tensor:
    """λ-free Eq. 8 term: ``Σ σ(S)`` over every score tensor in the
    tree."""
    ls = leaves(scores_tree)
    if not ls:
        return torch.zeros(())
    return sum(torch.sigmoid(s).sum() for s in ls)


def apply_pruning_to_param(name: str, w: torch.Tensor, scores: torch.Tensor,
                           r_b: float, block_size: int) -> torch.Tensor:
    """Dispatch by the score tensor's rank: 2-D block masks (MSA) vs MLP
    column (``wi``-like names) / row score vectors."""
    if scores.ndim == 2:
        return masked_weight(w, scores, r_b, block_size)
    axis = 1 if name.endswith(("w_int", "wi", "w_in")) else 0
    return masked_weight_vector(w, scores, r_b, axis=axis)


def hard_block_mask(scores: torch.Tensor, r_b: float,
                    w_shape: Tuple[int, int],
                    block_size: int) -> torch.Tensor:
    keep = num_kept_blocks(w_shape, block_size, r_b)
    return _hard_topk(scores, keep)


def density_stats(block_mask: torch.Tensor) -> Dict[str, float]:
    """Per-column density statistics of a block mask (α in Table II)."""
    col_counts = block_mask.sum(dim=0)
    total = block_mask.shape[0]
    return {
        "density": float(block_mask.float().mean()),
        "alpha": float((col_counts / total).mean()),
        "max_col": int(col_counts.max()),
        "min_col": int(col_counts.min()),
    }
