"""Attention for the ViT, plain PyTorch versions — the non-causal half of
the reference package's ``models/attention.py``.

These are the references the ``flash_attention`` kernel is held against
(``kernels/flash_attention``): the same math as the reference's
``flash_attention_jnp`` (non-causal, per-row ``kv_len``) and
``attention_probs_row``. They materialize the full score matrix, which is
fine for a reference and for the CPU tests.
"""
from __future__ import annotations

from typing import Optional

import torch


def _key_mask(kv_len: Optional[torch.Tensor], B: int, Nk: int,
              device) -> Optional[torch.Tensor]:
    """[B, Nk] bool, True at keys < kv_len[b]."""
    if kv_len is None:
        return None
    pos = torch.arange(Nk, device=device)
    lens = torch.as_tensor(kv_len, device=device).reshape(-1, 1)
    return (pos[None, :] < lens).expand(B, Nk)


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal attention. q: [B, Nq, H, Dh]; k, v: [B, Nk, H, Dh];
    ``kv_len`` ([B] or scalar) masks keys >= kv_len per row. Returns
    [B, Nq, H, Dh] in q's dtype (fp32 math)."""
    B, Nq, H, Dh = q.shape
    Nk = k.shape[1]
    if scale is None:
        scale = Dh ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _key_mask(kv_len, B, Nk, q.device)
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def attention_probs_row(q_row: torch.Tensor, k: torch.Tensor,
                        kv_len: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention of ONE query row against all keys, per head —
    what the TDM scoring needs (the CLS row). q_row: [B, H, Dh];
    k: [B, Nk, H, Dh]. Masked keys get probability exactly 0. Returns
    probs [B, H, Nk]."""
    B, Nk, H, Dh = k.shape
    if scale is None:
        scale = Dh ** -0.5
    s = torch.einsum("bhd,bkhd->bhk", q_row.float(), k.float()) * scale
    mask = _key_mask(kv_len, B, Nk, k.device)
    if mask is not None:
        s = s.masked_fill(~mask[:, None, :], float("-inf"))
    return torch.softmax(s, dim=-1)
