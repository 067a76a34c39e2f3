"""Mixture-of-Experts FFN with capacity-based grouped dispatch — the port of
the reference package's ``models/moe.py``.

Each token goes to its top-k experts. The (token, k) pairs fill a dense
``[E_pad, C, D]`` buffer: each expert takes its first ``C`` pairs in token
order and drops the rest (GShard semantics; padded banks receive nothing,
the router scores only the real experts). The expert FFNs run as three
batched products over every bank, and each token's outputs come back
weighted by its renormalized gates.

The arithmetic is the reference's; its form is chosen for the card, with no
host wait and a fixed order of floating-point adds:

* a pair's rank within its expert is a cumsum over a one-hot of the pairs in
  token order, the rank the reference's stable sort by expert gives; no
  bincount, no sort by expert, no shape that depends on the data;
* the dispatch is a plain scatter into unique (expert, rank) rows, dropped
  pairs going to one spare row that is sliced away (the reference adds into
  zeros, which gives the same values);
* the combine gathers each token's K outputs and sums them from zero in
  ascending expert order, rounding in the activation dtype after each add:
  the order in which the reference's scatter-add applies its expert-sorted
  updates. Nothing accumulates through atomics, so two calls on the card
  agree bitwise.

Under autograd the gradients are the reference's: through the gates to the
router's probabilities (and their renormalization), the aux through
``probs.mean(0)`` only (the routed fractions carry none), and each kept
pair's rows back to its token, its K copies summed by a reduction. Dropped
pairs read and write the spare row, so they pass 0. The backward of the
combine writes each pair's gradient to its row (:class:`_GatherRows`):
every real row is written once, and only the discarded spare row is
written by several pairs, so no row is summed through atomics and two
backwards on the card agree bitwise.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.token_pruning import stable_topk
from repro_torch.models import layers as L


def _bank(g: torch.Generator, n: int, in_dim: int, out_dim: int,
          dtype) -> torch.Tensor:
    """``n`` stacked ``dense_init`` matrices, ``[n, in, out]``."""
    return torch.randn((n, in_dim, out_dim), generator=g, dtype=dtype,
                       device=g.device).mul_((2.0 / (in_dim + out_dim)) ** 0.5)


def init_moe_params(g: torch.Generator, cfg, dtype=torch.float32) -> Dict:
    """One layer's router, expert banks (``moe_num_experts_padded`` of
    them) and optional shared expert, drawn on the generator's device."""
    D, F_ = cfg.d_model, cfg.d_ff
    E = cfg.moe_num_experts_padded
    p = {"router": L.dense_init(g, D, cfg.moe_num_experts, dtype),
         "wg": _bank(g, E, D, F_, dtype),
         "wi": _bank(g, E, D, F_, dtype),
         "wo": _bank(g, E, F_, D, dtype)}
    shared_ff = cfg.moe_shared_d_ff or (cfg.d_ff * cfg.moe_num_shared)
    if shared_ff:
        p["shared"] = {"wg": L.dense_init(g, D, shared_ff, dtype),
                       "wi": L.dense_init(g, D, shared_ff, dtype),
                       "wo": L.dense_init(g, shared_ff, D, dtype)}
    return p


def moe_capacity(num_tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float = 1.25) -> int:
    c = math.ceil(num_tokens * top_k / num_experts * capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8 for tiling


class Routing(NamedTuple):
    """Where one call's (token, k) pairs go; ``[T, K]`` each, k in top-k
    order (descending probability)."""
    gate: torch.Tensor    # fp32 gates, renormalized over the k
    expert: torch.Tensor  # int64 expert index
    slot: torch.Tensor    # int64 row expert * C + rank of the dispatch
    #                       buffer, or E_pad * C (the spare row) if dropped
    kept: torch.Tensor    # bool: rank < C
    aux: torch.Tensor     # 0-d fp32 Switch load-balancing loss
    capacity: int         # C


def route(xf: torch.Tensor, p: Dict, cfg,
          capacity_factor: Optional[float] = None,
          expert: Optional[torch.Tensor] = None) -> Routing:
    """Route the tokens ``xf`` [T, D]: router in the activation dtype, fp32
    softmax, top-k with ties toward the lower index, capacity ``C`` from
    this call's own ``T``. ``expert`` [T, K] (int64) replaces the top-k's
    choices, so that a run replays another's routing (the card-vs-CPU
    checks do): gates, ranks and the aux follow from it as from the top-k."""
    T = xf.shape[0]
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    probs = torch.softmax(L.linear(xf, p["router"]).float(), dim=-1)
    if expert is None:
        gate, expert = stable_topk(probs, K)
    else:
        gate = probs.gather(1, expert)
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
    # pairs in token order against experts: a pair's rank within its
    # expert is the count of earlier pairs routed there
    onehot = (expert.reshape(-1, 1)
              == torch.arange(E, device=xf.device)).to(torch.int32)
    ce = onehot.sum(0).float() / (T * K)  # fraction routed per expert
    aux = E * torch.sum(probs.mean(0) * ce)
    C = moe_capacity(T, E, K, capacity_factor)
    rank = (onehot.cumsum(0) - 1).gather(1, expert.reshape(-1, 1))
    rank = rank.reshape(T, K)
    kept = rank < C
    slot = torch.where(kept, expert * C + rank,
                       cfg.moe_num_experts_padded * C)
    return Routing(gate, expert, slot, kept, aux, C)


class _GatherRows(torch.autograd.Function):
    """``rows[idx]`` for ``idx`` [T, K] whose entries repeat only at the
    last row (the spare row). The backward copies each pair's gradient
    into its row instead of summing: a real row receives exactly one, and
    the spare row, which dropped pairs write over one another, is
    discarded by the caller."""

    @staticmethod
    def forward(ctx, rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.n_rows = rows.shape[0]
        return rows[idx]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (idx,) = ctx.saved_tensors
        D = g.shape[-1]
        out = g.new_zeros((ctx.n_rows, D))
        out.index_copy_(0, idx.reshape(-1), g.reshape(-1, D))
        return out, None


def moe_ffn(x: torch.Tensor, p: Dict, cfg,
            capacity_factor: Optional[float] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D]. Returns ``(y [B, S, D], aux)``: the routed experts'
    SwiGLU outputs, gate-weighted, plus the shared expert's when the layer
    has one; ``aux`` the Switch load-balancing loss (fp32)."""
    B, S, D = x.shape
    K, E_pad = cfg.moe_top_k, cfg.moe_num_experts_padded
    xf = x.reshape(B * S, D)
    r = route(xf, p, cfg, capacity_factor)
    C = r.capacity
    buf = xf.new_zeros((E_pad * C + 1, D))
    # each token's K copies (the backward sums them in a reduction)
    pairs = xf[:, None].expand(B * S, K, D).reshape(B * S * K, D)
    buf.index_copy_(0, r.slot.reshape(-1), pairs)
    buf = buf[:-1].view(E_pad, C, D)
    # grouped expert FFN: [E, C, D] x [E, D, F] -> [E, C, F]
    g = F.silu(torch.bmm(buf, p["wg"].to(x.dtype)))
    u = torch.bmm(buf, p["wi"].to(x.dtype))
    y_e = torch.bmm(g * u, p["wo"].to(x.dtype)).reshape(E_pad * C, D)
    rows = torch.cat([y_e, y_e.new_zeros((1, D))])  # the spare row reads 0
    # each token's pairs in ascending expert order, summed in that order
    # (``order`` permutes each row, so the gates' gather has one gradient
    # per element)
    _, order = torch.sort(r.expert, dim=1)
    part = (_GatherRows.apply(rows, r.slot.gather(1, order))
            * r.gate.gather(1, order).to(x.dtype)[..., None]).unbind(1)
    yf = part[0]
    for k in range(1, K):
        yf = yf + part[k]
    if "shared" in p:
        yf = yf + L.glu_mlp(xf, p["shared"])
    return yf.reshape(B, S, D), r.aux
