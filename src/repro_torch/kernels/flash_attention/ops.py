"""Flash attention for the packed ViT: non-causal, per-row ``kv_len``, and
the TDM scores (head-mean CLS-row probabilities) as a by-product.

Kernel K2 of the port: ``kernels/csrc/flash_attention.cu`` replaces the
reference package's Pallas ``_flash_kernel`` / ``flash_attention_pallas``
(``kernels/flash_attention/flash_attention.py``) in the form the main path
needs — on the reference main path these stages are ``flash_attention_jnp``
and ``attention_probs_row`` (``core/packed_runner.py``). Two entry points:
``flash_attention_f32`` for fp32 operands and ``flash_attention_f16`` for
the fp16 tier's fp16-cast ones (fp32 arithmetic; the output comes back in
fp16, as ``flash_attention_jnp`` returns ``q.dtype``). Causal mode, with
``q_offset`` and the GQA head repeat, belongs to the LM serving path and is
not ported. What bounds the kernel on the H100 and how the design answers
that is noted in the CUDA source.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import backend
from repro_torch.models.attention import (attention_probs_row,
                                          flash_attention_torch)

NAME = "flash_attention"
ENTRY_POINTS = {torch.float32: "flash_attention_f32",
                torch.float16: "flash_attention_f16"}
HEAD_DIMS = (16, 64)  # head widths the kernel is instantiated for:
# full DeiT-Small (64) and its reduced test config (16)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: ``(o [B, N, H, Dh], probs [B, H, N])``
    with ``probs`` the CLS row's per-head attention probabilities."""
    o = flash_attention_torch(q, k, v, kv_len=kv_len)
    return o, attention_probs_row(q[:, 0], k, kv_len=kv_len)


def _attention_cuda(q, k, v, kv_len, collect_scores: bool):
    B, N, H, Dh = q.shape
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {Dh}")
    o = torch.empty_like(q)
    probs = (torch.empty((B, H, N), dtype=torch.float32, device=q.device)
             if collect_scores else None)
    backend.launch(NAME, ENTRY_POINTS[q.dtype], q.device, q.data_ptr(),
                   k.data_ptr(), v.data_ptr(),
                   None if kv_len is None else kv_len.data_ptr(),
                   o.data_ptr(), None if probs is None else probs.data_ptr(),
                   B, N, H, Dh, Dh ** -0.5)
    return o, probs


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[torch.Tensor] = None,
                    collect_scores: bool = False, causal: bool = False
                    ) -> Union[torch.Tensor,
                               Tuple[torch.Tensor, torch.Tensor]]:
    """q, k, v: [B, N, H, Dh], all fp32 or all fp16; ``kv_len`` [B] int32
    (keys >= kv_len[b] are masked; every row needs at least one key;
    ``None`` = all N). Returns ``o`` [B, N, H, Dh] in q's dtype, or
    ``(o, scores [B, N])`` with ``collect_scores`` — the CLS row's
    probabilities averaged over heads, fp32, exactly 0 at masked keys. The
    kernel runs for CUDA tensors, the plain version for CPU tensors.
    ``causal=True`` raises: causal attention is the LM path's mode."""
    if causal:
        raise NotImplementedError(
            "causal flash attention (q_offset, GQA) belongs to the LM "
            "serving path, a later slice of the port (ROADMAP queue A, "
            "item 8)")
    B, N, H, Dh = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, N, H, Dh] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not backend.on_card(q, k, v):
        o, probs = attention_plain(q, k, v, kv_len)
    else:
        if q.dtype not in ENTRY_POINTS or not (
                k.dtype == v.dtype == q.dtype):
            raise TypeError(f"flash_attention kernel takes q, k, v all fp32 "
                            f"or all fp16, got {q.dtype}, {k.dtype}, "
                            f"{v.dtype}")
        if kv_len is not None:
            kv_len = torch.as_tensor(kv_len, dtype=torch.int32,
                                     device=q.device).contiguous()
            if kv_len.shape != (B,):
                raise ValueError(f"kv_len must have shape ({B},), got "
                                 f"{tuple(kv_len.shape)}")
        o, probs = _attention_cuda(q.contiguous(), k.contiguous(),
                                   v.contiguous(), kv_len, collect_scores)
    if not collect_scores:
        return o
    return o, probs.mean(dim=1)
