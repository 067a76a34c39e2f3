"""Dynamic token pruning (paper §IV-B) — the Token Dropping Module (TDM),
hard variant; the port of the reference package's ``core/token_pruning.py``.

Token importance is the CLS row of the attention matrix averaged over
heads. Given keep-rate ``r_t``, the top ``⌈(N−1)·r_t⌉`` non-CLS tokens are
retained and the remainder is fused into one token by score-weighted
aggregation; CLS is always kept, so the output holds ``1 + k + 1`` tokens.

Top-k is **stable**: ties break toward the lower index, as
``jax.lax.top_k`` does. Token-padded rows of a ragged batch score exactly
0, so with this rule they lose every tie against a real token and are
never kept; ``torch.topk`` on the card makes no such promise.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


def num_kept_tokens(n_tokens: int, r_t: float, has_cls: bool = True) -> int:
    """Static retained-token count: CLS + top-k + 1 fused token."""
    n_body = n_tokens - 1 if has_cls else n_tokens
    k = max(1, math.ceil(n_body * r_t))
    return (1 if has_cls else 0) + k + 1  # +1 fused token


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest entries along the last
    axis, in descending order, ties toward the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def drop_weights(s_body: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k selection and fusion weights of the hard TDM over body scores
    ``s_body`` [B, n_body]: ``(top_idx [B, k], w [B, n_body])`` with ``w``
    the normalized scores of the dropped rows (0 at kept rows)."""
    _, top_idx = stable_topk(s_body, k)
    keep = torch.zeros(s_body.shape, dtype=torch.bool, device=s_body.device)
    keep.scatter_(1, top_idx, True)
    w = torch.where(keep, 0.0, s_body.float())
    return top_idx, w / (w.sum(dim=1, keepdim=True) + 1e-9)


def tdm(z: torch.Tensor, scores: torch.Tensor, r_t: float | None,
        has_cls: bool = True, k: int | None = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token Dropping Module, plain PyTorch.

    z      : ``[B, N, D]`` token matrix (CLS at index 0 when ``has_cls``).
    scores : ``[B, N]`` importance (CLS position ignored when ``has_cls``).
    ``k``  : kept-token count; required when rows are token-padded (the
    count comes from each request's *real* token count), else derived from
    N and ``r_t``. Padded positions must score 0.
    Returns ``(z_out [B, N_kept, D], kept_idx [B, k])``.
    """
    B, N, D = z.shape
    n_body = N - 1 if has_cls else N
    if k is None:
        k = max(1, math.ceil(n_body * r_t))
    body = z[:, 1:, :] if has_cls else z
    s_body = scores[:, 1:] if has_cls else scores
    top_idx, w = drop_weights(s_body, k)
    kept = torch.gather(body, 1, top_idx[..., None].expand(B, k, D))
    fused = torch.einsum("bn,bnd->bd", w.to(z.dtype), body)
    parts = [z[:, :1, :]] if has_cls else []
    parts += [kept, fused[:, None, :]]
    return torch.cat(parts, dim=1), top_idx
