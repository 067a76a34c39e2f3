"""Token drop — the hard TDM, ``[B, N, D] -> [B, k+2, D]``.

Kernel K3 of the port: ``kernels/csrc/token_drop.cu`` replaces the
reference package's Pallas ``_token_drop_kernel`` / ``token_drop_pallas``
(``kernels/token_drop/token_drop.py``) and the top-k and weights its
wrapper computes outside it; on the reference main path this stage is
``token_pruning.tdm``. What bounds it on the H100 and how the design
answers that is noted in the CUDA source.

On the card one call is one launch: the kernel reads the tokens and the
scores in place, selects the top k (stable, ties toward the lower index),
forms the normalized drop weights, copies CLS and the kept rows and writes
the fused row. Nothing runs before it but views; what it does not take
(more than :data:`MAX_TOKENS` tokens, D not a multiple of 4, a z that is
not contiguous and 16-byte aligned) raises, and nothing is copied to make
it fit.

Training (Algorithm 1): when grad is enabled and a CUDA input requires
it, :class:`TokenDrop` runs: ``token_drop_f32`` also writing the kept
indices, and ``token_drop_bwd_f32`` giving the gradients of z and of the
scores, the gradient JAX takes of ``token_pruning.tdm``.
:func:`token_drop_bwd_plain` is its plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import token_pruning as TP
from repro_torch.kernels import backend

NAME = "token_drop"
# the largest N the TDM kernels take: their shared memory holds the scores
# and ranks of 1024 body rows (``csrc/tdm_tile.cuh``, kMaxBody)
MAX_TOKENS = 1025


def token_drop_plain(z: torch.Tensor, scores: torch.Tensor,
                     k: int) -> torch.Tensor:
    """Plain version of the kernel: the TDM's einsum (``TP.tdm``)."""
    return TP.tdm(z, scores, None, has_cls=True, k=k)[0]


def token_drop_bwd_plain(z: torch.Tensor, scores: torch.Tensor,
                         kept_idx: torch.Tensor, y: torch.Tensor,
                         dy: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``token_drop_bwd_f32``: the gradient of the hard
    TDM with CLS (``TP.tdm``) by the kernel's formulas, given the forward's
    kept indices [B, k] and output ``y`` [B, k + 2, D] and the output's
    gradient ``dy``. With S the dropped scores' sum + 1e-9, w = s / S at
    the dropped rows, dy_f and y_f the fused rows: dz is dy's row at CLS
    and at each kept row, w dy_f at a dropped row; dscores is (<dy_f, z_n>
    - <dy_f, y_f>) / S at a dropped row (<dy_f, y_f> = sum_m w_m <dy_f,
    z_m>) and exactly 0 at CLS and at the kept rows. Returns (dz [B, N,
    D], dscores [B, N])."""
    B, N, D = z.shape
    k = kept_idx.shape[1]
    idx = kept_idx.long()
    s_body = scores[:, 1:].float()
    keep = torch.zeros(s_body.shape, dtype=torch.bool, device=z.device)
    keep.scatter_(1, idx, True)
    drop = torch.where(keep, 0.0, s_body)
    denom = drop.sum(dim=1, keepdim=True) + 1e-9
    w = drop / denom
    dyf = dy[:, k + 1].float()
    g = torch.einsum("bd,bnd->bn", dyf, z[:, 1:].float())
    c = (dyf * y[:, k + 1].float()).sum(dim=-1, keepdim=True)
    ds_body = torch.where(keep, 0.0, (g - c) / denom)
    dz_body = w[..., None] * dyf[:, None, :]
    dz_body.scatter_(1, idx[..., None].expand(B, k, D), dy[:, 1:k + 1])
    return (torch.cat([dy[:, :1], dz_body], dim=1),
            torch.cat([torch.zeros_like(ds_body[:, :1]), ds_body], dim=1))


def card_operands(name: str, z: torch.Tensor, scores: torch.Tensor) -> int:
    """Check, for the TDM kernel ``name``, what it takes, raising on
    anything else; returns the scores' row stride (the kernel reads them
    in place, body from column 1)."""
    B, N, D = z.shape
    if z.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes fp32 tokens and scores, got "
                        f"{z.dtype} and {scores.dtype}")
    if N > MAX_TOKENS:
        raise ValueError(f"{name} kernel takes at most {MAX_TOKENS} tokens, "
                         f"got N={N}")
    if D % 4:
        raise ValueError(f"{name} kernel takes D a multiple of 4, got {D}")
    if not z.is_contiguous() or z.data_ptr() % 16:
        raise ValueError(f"{name} kernel takes a contiguous, 16-byte "
                         f"aligned z")
    if tuple(scores.shape) != (B, N) or scores.stride(1) != 1:
        raise ValueError(f"{name} kernel takes scores [{B}, {N}] with unit "
                         f"column stride, got {tuple(scores.shape)} strides "
                         f"{scores.stride()}")
    return scores.stride(0)


def _token_drop_cuda(z, scores, k: int, with_idx: bool):
    """``(out, kept_idx)`` by ``token_drop_f32``, ``kept_idx`` [B, k] int32
    with ``with_idx``, else None."""
    B, N, D = z.shape
    s_stride = card_operands(NAME, z, scores)
    out = torch.empty((B, k + 2, D), dtype=torch.float32, device=z.device)
    idx = (torch.empty((B, k), dtype=torch.int32, device=z.device)
           if with_idx else None)
    backend.launch(NAME, "token_drop_f32", z.device, z.data_ptr(),
                   scores.data_ptr(), out.data_ptr(),
                   None if idx is None else idx.data_ptr(), B, N, D, k,
                   s_stride)
    return out, idx


def _token_drop_bwd_cuda(z, scores, kept_idx, y, dy):
    """(dz, dscores) by ``token_drop_bwd_f32``: one launch."""
    B, N, D = z.shape
    k = kept_idx.shape[1]
    s_stride = card_operands("token_drop_bwd", z, scores)
    dy = backend.aligned(dy)
    dz = torch.empty_like(z)
    dscores = torch.empty((B, N), dtype=torch.float32, device=z.device)
    backend.launch(NAME, "token_drop_bwd_f32", z.device, z.data_ptr(),
                   scores.data_ptr(), kept_idx.data_ptr(), y.data_ptr(),
                   dy.data_ptr(), dz.data_ptr(), dscores.data_ptr(), B, N, D,
                   k, s_stride)
    return dz, dscores


class TokenDrop(torch.autograd.Function):
    """The hard TDM on the card with its gradient: the forward is
    ``token_drop_f32`` writing the kept indices beside its output, the
    backward ``token_drop_bwd_f32`` (the gradients of z and of the
    scores). Returns ``(z_out, kept_idx)``, ``kept_idx`` [B, k] int32 and
    not differentiable."""

    @staticmethod
    def forward(ctx, z, scores, k):
        out, idx = _token_drop_cuda(z, scores, k, with_idx=True)
        ctx.save_for_backward(z, scores, idx, out)
        ctx.mark_non_differentiable(idx)
        ctx.set_materialize_grads(False)
        return out, idx

    @staticmethod
    def backward(ctx, dout, _didx):
        z, scores, idx, out = ctx.saved_tensors
        return (*_token_drop_bwd_cuda(z, scores, idx, out, dout), None)


def token_drop(z: torch.Tensor, scores: torch.Tensor,
               k: int) -> torch.Tensor:
    """Hard TDM with CLS at row 0. z: [B, N, D] fp32; scores: [B, N]
    (token-padded rows must score exactly 0); ``k`` kept body tokens.
    Returns [B, k + 2, D]: CLS, the kept rows in top-k order, the fused
    row. The kernel runs for CUDA tensors, the plain version for CPU
    tensors; when grad is enabled and a CUDA input requires it,
    :class:`TokenDrop` (the kernel, writing the kept indices its backward
    reads, and the backward)."""
    B, N, D = z.shape
    if not 1 <= k <= N - 1:
        raise ValueError(f"k={k} outside [1, {N - 1}]")
    if not backend.on_card(z, scores):
        return token_drop_plain(z, scores, k)
    if torch.is_grad_enabled() and (z.requires_grad
                                    or scores.requires_grad):
        return TokenDrop.apply(z, scores, k)[0]
    return _token_drop_cuda(z, scores, k, with_idx=False)[0]
