"""Gradient compression for a data-parallel all-reduce: int8 per-tensor
quantization with error feedback (EF-SGD style residual accumulation) —
the port of the reference package's ``optim/compression.py``.

Quantizing the gradients cuts the collective's bytes 4x; error feedback
keeps the quantization noise from biasing convergence: the residual
``g - dequant(quant(g))`` is added back into the next step's gradient.
Wrap the gradient tree between the backward and the optimizer update:
``q, s, state = compress_grads(grads, state)``, all-reduce ``q``, then
``decompress_grads(q, s)``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten


class EFState(NamedTuple):
    residual: Any  # tree like grads


def init_ef_state(grads_like: Any) -> EFState:
    return EFState(tree_map(torch.zeros_like, grads_like))


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q, scale)."""
    amax = g.abs().max() + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale


def compress_grads(grads: Any, state: EFState) -> Tuple[Any, Any, EFState]:
    """Returns (quantized tree, scales tree, new EF state)."""
    qs, ss, rs = [], [], []
    for g, r in zip(leaves(grads), leaves(state.residual)):
        g = g + r
        q, s = quantize(g)
        qs.append(q)
        ss.append(s)
        rs.append(g - dequantize(q, s, g.dtype))
    return (unflatten(grads, qs), unflatten(grads, ss),
            EFState(unflatten(grads, rs)))


def decompress_grads(q_tree: Any, s_tree: Any, dtype=torch.float32) -> Any:
    return tree_map(lambda q, s: dequantize(q, s, dtype), q_tree, s_tree)
