"""Token drop — the hard TDM's gather + fuse, ``[B, N, D] -> [B, k+2, D]``.

Kernel K3 of the port: ``kernels/csrc/token_drop.cu`` replaces the
reference package's Pallas ``_token_drop_kernel`` / ``token_drop_pallas``
(``kernels/token_drop/token_drop.py``); on the reference main path this
stage is ``token_pruning.tdm``. What bounds it on the H100 and how the
design answers that is noted in the CUDA source.

The top-k (stable, ties toward the lower index) and the normalized drop
weights are computed here, outside the kernel, as in the reference; the
kernel copies CLS and the kept rows and writes the fused row, so the
wrapper does no concatenation.
"""
from __future__ import annotations

import torch

from repro_torch.core import token_pruning as TP
from repro_torch.kernels import backend

NAME = "token_drop"


def token_drop_plain(z: torch.Tensor, scores: torch.Tensor,
                     k: int) -> torch.Tensor:
    """Plain version of the kernel: the TDM's einsum (``TP.tdm``)."""
    return TP.tdm(z, scores, None, has_cls=True, k=k)[0]


def _token_drop_cuda(z: torch.Tensor, keep_idx: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    B, N, D = z.shape
    k = keep_idx.shape[1]
    out = torch.empty((B, k + 2, D), dtype=torch.float32, device=z.device)
    backend.launch(NAME, "token_drop_f32", z.device, z.data_ptr(),
                   keep_idx.data_ptr(), w.data_ptr(), out.data_ptr(),
                   B, N, D, k)
    return out


def token_drop(z: torch.Tensor, scores: torch.Tensor, k: int) -> torch.Tensor:
    """Hard TDM with CLS at row 0. z: [B, N, D] fp32; scores: [B, N]
    (token-padded rows must score exactly 0); ``k`` kept body tokens.
    Returns [B, k + 2, D]: CLS, the kept rows in top-k order, the fused
    row. The kernel runs for CUDA tensors, the plain version for CPU
    tensors."""
    B, N, D = z.shape
    if not 1 <= k <= N - 1:
        raise ValueError(f"k={k} outside [1, {N - 1}]")
    if not backend.on_card(z, scores):
        return token_drop_plain(z, scores, k)
    if z.dtype != torch.float32:
        raise TypeError(f"token_drop kernel takes fp32 tokens, got {z.dtype}")
    keep_idx, w = TP.drop_weights(scores[:, 1:], k)
    return _token_drop_cuda(z.contiguous(),
                            keep_idx.to(torch.int32).contiguous(),
                            w.contiguous())
