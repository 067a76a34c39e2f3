"""AdamW (decoupled weight decay) over the port's trees — the port of the
reference package's ``optim/adamw.py``, with its arithmetic:

* the gradients are clipped by their global norm, scaled by
  ``min(1, grad_clip / (norm + 1e-9))``;
* bias correction takes the step in fp32;
* ``lr`` is a float or a callable of the (1-based) step;
* weight decay applies only to leaves with ``ndim >= 2`` (the matrices,
  the 2-D block-score matrices among them), not to biases, norms or the
  MLP score vectors — unless the caller passes its own per-leaf ``decay``
  (the LM's step does: the reference stacks the LM's layers, where every
  per-layer leaf has ``ndim >= 2``).

The update is functional: it returns new params and a new state and
leaves its inputs as they are. It runs on the leaves' device with
``torch._foreach_*`` ops (a few launches per tree, not per leaf) and
never reads a value back to the host.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

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
    def update(self, grads, state: AdamWState, params,
               decay: Optional[Sequence[bool]] = None
               ) -> Tuple[Any, AdamWState]:
        """One step. ``decay``: per leaf of ``params`` in flatten order,
        whether weight decay applies (default: ``ndim >= 2``)."""
        step = state.step + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        g = leaves(grads)
        if self.grad_clip > 0:
            scale = torch.clamp(self.grad_clip / (global_norm(g) + 1e-9),
                                max=1.0)
            g = torch._foreach_mul(g, scale)

        # the reference's arithmetic, operation for operation, each
        # intermediate made once and updated in place (the peak is the
        # params, the gradients, both moments old and new and two
        # temporaries: ~8 copies of the params for an LM of 1.6 B)
        b1, b2 = self.b1, self.b2
        mu = torch._foreach_mul(leaves(state.mu), b1)
        tmp = torch._foreach_mul(g, 1 - b1)
        torch._foreach_add_(mu, tmp)
        nu = torch._foreach_mul(leaves(state.nu), b2)
        tmp = torch._foreach_mul(g, g)
        del g
        torch._foreach_mul_(tmp, 1 - b2)
        torch._foreach_add_(nu, tmp)
        del tmp
        t = step.to(torch.float32)
        c1 = 1 - b1 ** t
        c2 = 1 - b2 ** t
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        delta = list(torch._foreach_div(mu, c1))
        torch._foreach_div_(delta, denom)
        del denom
        p = leaves(params)
        if decay is None:
            decay = [leaf.ndim >= 2 for leaf in p]
        for i, leaf in enumerate(p):
            if decay[i]:
                delta[i].add_(self.weight_decay * leaf)
        torch._foreach_mul_(delta, lr)
        new = torch._foreach_sub(p, delta)
        del delta
        return unflatten(params, new), AdamWState(
            step, unflatten(state.mu, mu), unflatten(state.nu, nu))


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ ‖leaf‖²) over the tree, in fp32."""
    ls = [leaf.float() for leaf in leaves(tree)]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(ls)))
