"""Shared neural-net layers (plain functions over param dicts) — the ViT
half of the reference package's ``models/layers.py``.

All matmul weights are stored ``[in, out]``, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with the population variance, computed in fp32."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * scale + bias).to(dt)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: torch.Tensor | None = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def gelu_mlp(x: torch.Tensor, p) -> torch.Tensor:
    """Classic transformer FFN: gelu(x·wi + bi)·wo + bo, with the tanh
    form of GELU."""
    h = F.gelu(linear(x, p["wi"], p.get("bi")), approximate="tanh")
    return linear(h, p["wo"], p.get("bo"))


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32) -> torch.Tensor:
    scale = (2.0 / (in_dim + out_dim)) ** 0.5
    return scale * torch.randn((in_dim, out_dim), generator=generator,
                               dtype=dtype)
