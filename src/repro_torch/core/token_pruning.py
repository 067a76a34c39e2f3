"""Dynamic token pruning (paper §IV-B) — the Token Dropping Module (TDM),
hard and soft variants; the port of the reference package's
``core/token_pruning.py``.

Token importance is the CLS row of the attention matrix averaged over
heads. Given keep-rate ``r_t``, the top ``⌈(N−1)·r_t⌉`` non-CLS tokens are
retained and the remainder is fused into one token by score-weighted
aggregation; CLS is always kept, so the output holds ``1 + k + 1`` tokens.

Top-k is **stable**: ties break toward the lower index, as
``jax.lax.top_k`` does. Token-padded rows of a ragged batch score exactly
0, so with this rule they lose every tie against a real token and are
never kept; ``torch.topk`` on the card makes no such promise.

The soft variant (:func:`tdm_soft`) keeps one persistent package token
that carries the dropped tokens' score mass across TDM layers.

Beyond the paper, the same scoring prunes the LMs' KV caches in decode
(:func:`kv_prune_scores`, :func:`select_kv_keep`, :func:`compact_kv_cache`).
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


def package_weights(s_body: torch.Tensor, k: int,
                    pkg_mass: torch.Tensor | None = None,
                    pkg_pos: torch.Tensor | None = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k selection and RAW package weights of the soft TDM over body
    scores ``s_body`` [B, n_body]: ``(top_idx [B, k], w [B, n_body])``.
    ``w`` holds the dropped rows' scores, 0 at kept rows and, when a
    package exists (``pkg_mass`` [B]), the carried mass at the package row
    ``pkg_pos`` [B] (body index; default the last body row), which scores
    ``-inf`` in the selection so it is never kept."""
    B, n_body = s_body.shape
    s32 = s_body.float()
    is_pkg = None
    sel = s32
    if pkg_mass is not None:
        if pkg_pos is None:
            pkg_pos = torch.full((B,), n_body - 1, dtype=torch.int64,
                                 device=s_body.device)
        pos = torch.arange(n_body, device=s_body.device)
        is_pkg = pos[None, :] == pkg_pos.to(torch.int64)[:, None]
        sel = s32.masked_fill(is_pkg, float("-inf"))
    _, top_idx = stable_topk(sel, k)
    keep = torch.zeros(s_body.shape, dtype=torch.bool, device=s_body.device)
    keep.scatter_(1, top_idx, True)
    w = torch.where(keep, 0.0, s32)
    if is_pkg is not None:
        w = torch.where(is_pkg, pkg_mass.float()[:, None], w)
    return top_idx, w


def tdm_soft(z: torch.Tensor, scores: torch.Tensor, r_t: float | None = None,
             has_cls: bool = True, k: int | None = None,
             pkg_mass: torch.Tensor | None = None,
             pkg_pos: torch.Tensor | None = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft-pruning TDM: the dropped tokens fold into ONE persistent
    package token instead of a fresh fused token at every TDM. At each
    TDM the previous package re-enters the aggregation at its carried mass,

        package' = (sum_dropped s_i z_i + mass z_pkg) / (sum s_i + mass),
        mass'    = sum_dropped s_i + mass,

    with RAW (un-normalized) weights, the form the ``token_package`` kernel
    computes. The output length is the hard TDM's (``1 + k + 1``).

    z, scores, ``k``: as in :func:`tdm` (padded rows must score 0).
    ``pkg_mass`` [B]: the carried mass when a body row of ``z`` is a
    package from an earlier soft TDM (``None`` for the first); the package
    is pinned out of the top-k, so ``k <= N_body - 1`` (a ``k`` derived
    from ``r_t`` clamps itself, an explicit one raises). ``pkg_pos`` [B]:
    the package's body index per row (default the last body row; the
    serving engine passes ``n_valid - 2`` for token-padded tiles).

    Returns ``(z_out [B, k + 2, D], new_mass [B])``.
    """
    B, N, D = z.shape
    n_body = N - 1 if has_cls else N
    if k is None:
        k = max(1, math.ceil(n_body * r_t))
        if pkg_mass is not None:
            k = min(k, n_body - 1)
    if pkg_mass is not None and k > n_body - 1:
        raise ValueError(f"soft TDM with a package row keeps the package "
                         f"plus k={k} of {n_body - 1} real body tokens — "
                         f"k must be <= {n_body - 1}")
    body = z[:, 1:, :] if has_cls else z
    s_body = scores[:, 1:] if has_cls else scores
    top_idx, w = package_weights(s_body, k, pkg_mass, pkg_pos)
    kept = torch.gather(body, 1, top_idx[..., None].expand(B, k, D))
    denom = w.sum(dim=1, keepdim=True) + 1e-9
    package = torch.einsum("bn,bnd->bd", w, body.float()) / denom
    parts = [z[:, :1, :]] if has_cls else []
    parts += [kept, package.to(z.dtype)[:, None, :]]
    return torch.cat(parts, dim=1), w.sum(dim=1)


# ---------------------------------------------------------------------------
# Beyond-paper: dynamic KV-cache pruning for decode (SpAtten-style adaptation
# of the paper's token scoring to autoregressive serving).
# ---------------------------------------------------------------------------
def kv_prune_scores(accum_attn: torch.Tensor, cache_len,
                    start=None) -> torch.Tensor:
    """``accum_attn [B, N_cache]`` is attention mass accumulated over decode
    steps and heads. Returns the same scores, masked to ``-inf`` outside
    the valid cache window ``[start, cache_len)`` — both may be scalar or
    per-slot ``[B]``; ``start`` masks left-padding so pad slots never
    compete with real tokens."""
    n = accum_attn.shape[-1]
    pos = torch.arange(n, device=accum_attn.device)
    valid = pos < torch.as_tensor(cache_len,
                                  device=accum_attn.device)[..., None]
    if start is not None:
        valid = valid & (pos >= torch.as_tensor(
            start, device=accum_attn.device)[..., None])
    return torch.where(valid, accum_attn, float("-inf"))


def select_kv_keep(accum_attn: torch.Tensor, keep: int,
                   invalid_first: bool = False) -> torch.Tensor:
    """Indices of the ``keep`` highest-mass cached tokens, ties toward the
    lower index (as ``jax.lax.top_k``: ties are certain right after a
    prune, which resets the mass to zeros).

    ``keep`` is clamped to the score width, and picks whose score is
    ``-inf`` (slots masked out by :func:`kv_prune_scores`) are grouped away
    from the valid picks: valid indices stay in temporal order and invalid
    ones are packed at the back — or at the front with
    ``invalid_first=True``, so a caller can express the garbage prefix as
    a per-slot ``start`` offset."""
    n = accum_attn.shape[-1]
    keep = max(1, min(keep, n))
    vals, idx = stable_topk(accum_attn, keep)
    invalid = torch.isneginf(vals)
    if invalid_first:
        key = torch.where(invalid, idx, idx + n)
    else:
        key = torch.where(invalid, idx + n, idx)
    return torch.sort(key, dim=-1).values % n


def compact_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                     keep_idx: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather kept cache entries to the front. Shapes: ``[B, N, H, Dh]``;
    keep_idx ``[B, keep]``."""
    def gather(c):
        idx = keep_idx[:, :, None, None].expand(-1, -1, *c.shape[2:])
        return torch.gather(c, 1, idx)
    return gather(k_cache), gather(v_cache)
