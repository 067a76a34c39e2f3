"""Cubic sparsity scheduler (paper §VI, following movement pruning [17])
and the fine-pruning LR schedule — the port of the reference package's
``core/schedule.py``.

``r_b`` is scheduled from full density 1.0 to its final value with a
warm-up (dense) phase, a cubic decay phase and a cool-down (constant)
phase:

    r(t) = r_f + (1 - r_f) * (1 - (t - t_w) / (T - t_w - t_c))^3

Both functions take the step as an int or a 0-d tensor and return a 0-d
fp32 tensor on the step's device, so a training step computes them on the
card without a host round trip.
"""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cubic_keep_rate(step, total_steps: int, final_rate: float,
                    warmup_steps: int = 0,
                    cooldown_steps: int = 0) -> torch.Tensor:
    """Keep-rate at ``step``."""
    t = _step(step)
    t_w = float(warmup_steps)
    t_end = float(total_steps - cooldown_steps)
    span = max(t_end - t_w, 1.0)
    frac = torch.clamp((t - t_w) / span, 0.0, 1.0)
    r = final_rate + (1.0 - final_rate) * (1.0 - frac) ** 3
    final = torch.full_like(t, final_rate)
    return torch.where(t < t_w, torch.ones_like(t),
                       torch.where(t >= t_end, final, r))


def linear_warmup_cosine(step, total_steps: int, base_lr: float,
                         warmup_steps: int = 0,
                         min_lr: float = 0.0) -> torch.Tensor:
    """LR schedule for the fine-pruning runs (AdamW in the paper)."""
    t = _step(step)
    warm = base_lr * t / max(warmup_steps, 1)
    span = max(total_steps - warmup_steps, 1)
    frac = torch.clamp((t - warmup_steps) / span, 0.0, 1.0)
    cos = min_lr + 0.5 * (base_lr - min_lr) * (1 + torch.cos(math.pi * frac))
    return torch.where(t < warmup_steps, warm, cos)
