"""AdamW (decoupled weight decay) over the port's trees — the port of the
reference package's ``optim/adamw.py``, with its arithmetic:

* the gradients are clipped by their global norm, scaled by
  ``min(1, grad_clip / (norm + 1e-9))``;
* bias correction takes the step in fp32;
* ``lr`` is a float or a callable of the (1-based) step;
* weight decay applies only to leaves with ``ndim >= 2`` (the matrices,
  the 2-D block-score matrices among them), not to biases, norms or the
  MLP score vectors.

The update is functional: it returns new params and a new state and
leaves its inputs as they are. It runs on the leaves' device with
``torch._foreach_*`` ops (a few launches per tree, not per leaf) and
never reads a value back to the host.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    mu: Any
    nu: Any


class AdamW(NamedTuple):
    lr: "Callable[[torch.Tensor], torch.Tensor] | float" = 2e-5
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        ls = leaves(params)
        dev = ls[0].device if ls else None
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState]:
        step = state.step + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        g = leaves(grads)
        if self.grad_clip > 0:
            scale = torch.clamp(self.grad_clip / (global_norm(g) + 1e-9),
                                max=1.0)
            g = torch._foreach_mul(g, scale)

        b1, b2 = self.b1, self.b2
        mu = torch._foreach_add(torch._foreach_mul(leaves(state.mu), b1),
                                torch._foreach_mul(g, 1 - b1))
        nu = torch._foreach_add(torch._foreach_mul(leaves(state.nu), b2),
                                torch._foreach_mul(torch._foreach_mul(g, g),
                                                   1 - b2))
        t = step.to(torch.float32)
        c1 = 1 - b1 ** t
        c2 = 1 - b2 ** t
        delta = list(torch._foreach_div(
            torch._foreach_div(mu, c1),
            torch._foreach_add(torch._foreach_sqrt(
                torch._foreach_div(nu, c2)), self.eps)))
        p = leaves(params)
        for i, leaf in enumerate(p):
            if leaf.ndim >= 2:
                delta[i] = delta[i] + self.weight_decay * leaf
        new = torch._foreach_sub(p, torch._foreach_mul(delta, lr))
        return unflatten(params, new), AdamWState(
            step, unflatten(state.mu, mu), unflatten(state.nu, nu))


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ ‖leaf‖²) over the tree, in fp32."""
    ls = [leaf.float() for leaf in leaves(tree)]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(ls)))
