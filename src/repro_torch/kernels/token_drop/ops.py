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
"""
from __future__ import annotations

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
    s_stride = card_operands(NAME, z, scores)
    out = torch.empty((B, k + 2, D), dtype=torch.float32, device=z.device)
    backend.launch(NAME, "token_drop_f32", z.device, z.data_ptr(),
                   scores.data_ptr(), out.data_ptr(), B, N, D, k, s_stride)
    return out
