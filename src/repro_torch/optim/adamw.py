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

Two forms share that arithmetic, operation for operation, so they give
bitwise-equal results. :meth:`AdamW.update` is functional: it returns new
params and a new state and leaves its inputs as they are (its peak is the
params, the gradients, both moments old and new and two temporaries).
:meth:`AdamW.update_` is the counterpart of the reference's donated
buffers: it scales the gradients by the clip, and updates the params and
both moments, in place, one group of leaves at a time, so the temporaries
are one group's. Both run on the leaves' device with ``torch._foreach_*``
ops (a few launches per group of leaves, not per leaf) and never read a
value back to the host.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten

# The in-place update's group of consecutive leaves, in elements: its
# temporaries (the squared gradients, the denominator, the step) are three
# fp32 copies of a group, 768 MiB at most (a larger leaf is a group alone)
GROUP_NUMEL = 1 << 26


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

    def _lr_and_corrections(self, step: torch.Tensor):
        lr = self.lr(step) if callable(self.lr) else self.lr
        t = step.to(torch.float32)
        return lr, 1 - self.b1 ** t, 1 - self.b2 ** t

    def _clip_scale(self, g) -> Optional[torch.Tensor]:
        if self.grad_clip <= 0:
            return None
        return torch.clamp(self.grad_clip / (global_norm(g) + 1e-9), max=1.0)

    def _group(self, g, mu, nu, p, decay, lr, c1, c2, fresh: bool):
        """The reference's arithmetic on one group of leaves (``g`` clipped
        already): returns the new ``(mu, nu, p)``, new lists when
        ``fresh``, else ``mu``, ``nu`` and ``p`` updated in place."""
        b1, b2 = self.b1, self.b2
        if fresh:
            mu = torch._foreach_mul(mu, b1)
            nu = torch._foreach_mul(nu, b2)
        else:
            torch._foreach_mul_(mu, b1)
            torch._foreach_mul_(nu, b2)
        tmp = torch._foreach_mul(g, 1 - b1)
        torch._foreach_add_(mu, tmp)
        tmp = torch._foreach_mul(g, g)
        torch._foreach_mul_(tmp, 1 - b2)
        torch._foreach_add_(nu, tmp)
        del tmp
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        delta = list(torch._foreach_div(mu, c1))
        torch._foreach_div_(delta, denom)
        del denom
        dec = [i for i, d in enumerate(decay) if d]
        if dec:
            wd = torch._foreach_mul([p[i] for i in dec], self.weight_decay)
            torch._foreach_add_([delta[i] for i in dec], wd)
            del wd
        torch._foreach_mul_(delta, lr)
        if fresh:
            return mu, nu, torch._foreach_sub(p, delta)
        torch._foreach_sub_(p, delta)
        return mu, nu, p

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params,
               decay: Optional[Sequence[bool]] = None
               ) -> Tuple[Any, AdamWState]:
        """One step, functional. ``decay``: per leaf of ``params`` in
        flatten order, whether weight decay applies (default: ``ndim >=
        2``)."""
        step = state.step + 1
        lr, c1, c2 = self._lr_and_corrections(step)
        g, p = leaves(grads), leaves(params)
        scale = self._clip_scale(g)
        if scale is not None:
            g = torch._foreach_mul(g, scale)
        if decay is None:
            decay = [leaf.ndim >= 2 for leaf in p]
        mu, nu, new = self._group(g, leaves(state.mu), leaves(state.nu), p,
                                  decay, lr, c1, c2, fresh=True)
        return unflatten(params, new), AdamWState(
            step, unflatten(state.mu, mu), unflatten(state.nu, nu))

    @torch.no_grad()
    def update_(self, grads, state: AdamWState, params,
                decay: Optional[Sequence[bool]] = None
                ) -> Tuple[Any, AdamWState]:
        """One step in place, bitwise :meth:`update`'s: ``grads`` are scaled
        by the clip, ``params``, ``state.mu`` and ``state.nu`` updated, and
        the same ``params`` returned with a state holding the same moment
        trees and the next step. The global norm is taken over the whole
        tree first; then consecutive leaves are updated in groups of at
        most ``GROUP_NUMEL`` elements (a larger leaf alone), so the
        temporaries are one group's."""
        step = state.step + 1
        lr, c1, c2 = self._lr_and_corrections(step)
        g, p = leaves(grads), leaves(params)
        mu, nu = leaves(state.mu), leaves(state.nu)
        scale = self._clip_scale(g)
        if scale is not None:
            torch._foreach_mul_(g, scale)
        if decay is None:
            decay = [leaf.ndim >= 2 for leaf in p]
        start, n = 0, 0
        for i, leaf in enumerate(p):
            n += leaf.numel()
            if n >= GROUP_NUMEL or i == len(p) - 1:
                sl = slice(start, i + 1)
                self._group(g[sl], mu[sl], nu[sl], p[sl], decay[sl], lr, c1,
                            c2, fresh=False)
                start, n = i + 1, 0
        return params, AdamWState(step, state.mu, state.nu)


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ ‖leaf‖²) over the tree, in fp32."""
    ls = [leaf.float() for leaf in leaves(tree)]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(ls)))
