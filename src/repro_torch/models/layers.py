"""Shared neural-net layers (plain functions over param dicts) — the port
of the reference package's ``models/layers.py``: the ViT's LayerNorm and
GELU MLP, and the LMs' RMSNorm, rotary embeddings and SwiGLU MLP.

All matmul weights are stored ``[in, out]``, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm computed in fp32, returned in x's dtype."""
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with the population variance, computed in fp32."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * scale + bias).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding, split-half (non-interleaved) form. x: [..., N, H,
    Dh]; positions: broadcastable to [..., N] (per row: [B, N]). cos and
    sin in fp32; the result is cast back to x's dtype."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # [Dh/2]
    angles = positions[..., None].float() * freqs  # [..., N, Dh/2]
    angles = angles[..., None, :]  # head axis
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


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


def glu_mlp(x: torch.Tensor, p) -> torch.Tensor:
    """SwiGLU feed-forward: (silu(x·wg) ⊙ (x·wi)) · wo."""
    g = F.silu(linear(x, p["wg"]))
    u = linear(x, p["wi"])
    return linear(g * u, p["wo"])


# Initializers draw on the generator's device, so a generator on the card
# makes full-width weights there without a pass through host memory.
def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32) -> torch.Tensor:
    scale = (2.0 / (in_dim + out_dim)) ** 0.5
    return scale * torch.randn((in_dim, out_dim), generator=generator,
                               dtype=dtype, device=generator.device)


def embed_init(generator: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32) -> torch.Tensor:
    return 0.02 * torch.randn((vocab, dim), generator=generator, dtype=dtype,
                              device=generator.device)
