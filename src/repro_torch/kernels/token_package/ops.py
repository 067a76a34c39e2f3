"""Token package — the soft TDM,
``[B, N, D] -> ([B, k+2, D], new_mass [B])``.

Kernel K4 of the port: ``kernels/csrc/token_package.cu`` replaces the
reference package's Pallas ``_token_package_kernel`` /
``token_package_pallas`` (``kernels/token_package/token_package.py``) and
the top-k and weights its wrapper computes outside it; on the reference
main path this stage is ``token_pruning.tdm_soft``. What bounds it on the
H100 and how the design answers that is noted in the CUDA source.

On the card one call is one launch: the kernel reads the tokens, the
scores, the carried mass and the package position in place, selects the
top k (stable, the package pinned out), forms the raw weights, copies CLS
and the kept rows, writes the package row normalised by the weight sum and
returns that sum as the new mass. Unlike the reference's Pallas wrapper,
which pins the package at the last body row, the package position is per
row (``pkg_pos``, int32 or int64): the serving path pins each request's
package at ``n_valid - 2`` in token-padded tiles.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import token_pruning as TP
from repro_torch.kernels import backend
from repro_torch.kernels.token_drop.ops import card_operands

NAME = "token_package"


def token_package_plain(z: torch.Tensor, scores: torch.Tensor, k: int,
                        pkg_mass: Optional[torch.Tensor] = None,
                        pkg_pos: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: the soft TDM (``TP.tdm_soft``)."""
    return TP.tdm_soft(z, scores, has_cls=True, k=k, pkg_mass=pkg_mass,
                       pkg_pos=pkg_pos)


def _row_vector(what: str, t: torch.Tensor, B: int,
                dtypes: Tuple[torch.dtype, ...]) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"token_package kernel takes {what} as "
                        f"{' or '.join(map(str, dtypes))}, got {t.dtype}")
    if tuple(t.shape) != (B,) or not t.is_contiguous():
        raise ValueError(f"token_package kernel takes a contiguous {what} "
                         f"[{B}], got {tuple(t.shape)}")


def token_package(z: torch.Tensor, scores: torch.Tensor, k: int,
                  pkg_mass: Optional[torch.Tensor] = None,
                  pkg_pos: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft TDM with CLS at row 0. z: [B, N, D] fp32; scores: [B, N]
    (token-padded rows must score exactly 0); ``k`` kept body tokens;
    ``pkg_mass`` [B] the carried package mass (``None`` at the first soft
    TDM, where no package exists); ``pkg_pos`` [B] each row's package body
    index (default the last body row). Returns ``(out [B, k + 2, D],
    new_mass [B])``: CLS, the kept rows in top-k order, the package row.
    The kernel runs for CUDA tensors, the plain version for CPU tensors."""
    B, N, D = z.shape
    k_max = N - 2 if pkg_mass is not None else N - 1
    if not 1 <= k <= k_max:
        raise ValueError(f"k={k} outside [1, {k_max}]")
    tensors = [t for t in (z, scores, pkg_mass, pkg_pos) if t is not None]
    if not backend.on_card(*tensors):
        return token_package_plain(z, scores, k, pkg_mass, pkg_pos)
    s_stride = card_operands(NAME, z, scores)
    if pkg_mass is None:
        pkg_pos = None  # no package: the position is not read
    else:
        _row_vector("pkg_mass", pkg_mass, B, (torch.float32,))
    if pkg_pos is not None:
        _row_vector("pkg_pos", pkg_pos, B, (torch.int32, torch.int64))
    out = torch.empty((B, k + 2, D), dtype=torch.float32, device=z.device)
    mass = torch.empty((B,), dtype=torch.float32, device=z.device)
    backend.launch(NAME, "token_package_f32", z.device, z.data_ptr(),
                   scores.data_ptr(),
                   None if pkg_mass is None else pkg_mass.data_ptr(),
                   None if pkg_pos is None else pkg_pos.data_ptr(),
                   out.data_ptr(), mass.data_ptr(), B, N, D, k, s_stride,
                   int(pkg_pos is not None and pkg_pos.dtype == torch.int64))
    return out, mass
