"""Block-compressed weight format + offline load balancing (paper §V-A,
§V-D1) — the port of the reference package's ``core/packing.py``.

Pruned weights are stored column-major as *blocks*: per block-column, a
header of surviving row-block indices followed by the blocks themselves,

    blocks  : [n_cols, max_kept, b, b]   (zero-padded per column)
    header  : [n_cols, max_kept] int32   (row-block index, -1 = padding)
    counts  : [n_cols]          int32

which the SBMM kernel (``kernels/sbmm``) walks per block column. Packing
runs offline in numpy exactly as in the reference, so ``header`` and
``col_perm`` are identical by construction; only the final tensors are
torch tensors on the caller's device.

Offline load balancing: ``balance_columns`` orders columns heaviest-first
(LPT); the permutation is folded into the stored layout and undone after
the SBMM (``kernels.sbmm.sbmm``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass
class PackedWeight:
    """Block-compressed representation of a pruned weight matrix."""

    blocks: torch.Tensor  # [n_cols, max_kept, b, b]
    header: torch.Tensor  # [n_cols, max_kept] int32; -1 padding
    counts: torch.Tensor  # [n_cols] int32
    col_perm: np.ndarray  # permutation applied to block-columns
    shape: Tuple[int, int]
    block_size: int
    # stored slot of each logical block column (int64, on the blocks'
    # device): ``y_logical[:, c] = y_stored[:, inv_perm[c]]``. Built with
    # the weight, so no forward pays a host-to-device copy for it.
    inv_perm: torch.Tensor = dataclasses.field(init=False, repr=False,
                                               compare=False)

    def __post_init__(self) -> None:
        inv = np.empty(self.n_cols, dtype=np.int64)
        inv[np.asarray(self.col_perm)] = np.arange(self.n_cols)
        self.inv_perm = torch.as_tensor(inv, device=self.blocks.device)

    @property
    def n_cols(self) -> int:
        return self.blocks.shape[0]

    @property
    def max_kept(self) -> int:
        return self.blocks.shape[1]

    def to(self, device: "str | torch.device") -> "PackedWeight":
        """This weight with its tensors on ``device`` (itself when they
        are there already)."""
        device = torch.device(device)
        if self.blocks.device == device:
            return self
        return PackedWeight(self.blocks.to(device), self.header.to(device),
                            self.counts.to(device), self.col_perm,
                            self.shape, self.block_size)

    def nbytes(self) -> int:
        """Model-size contribution: stored blocks + headers (paper metric),
        each at its actual dtype width."""
        kept = int(self.counts.sum())
        b = self.block_size
        return (kept * b * b * self.blocks.element_size()
                + kept * self.header.element_size())

    def to_dense(self) -> torch.Tensor:
        """Reconstruct the (masked) dense weight — the packing oracle."""
        m1, m2 = self.shape
        b = self.block_size
        n_rows = math.ceil(m1 / b)
        blocks = self.blocks.detach().cpu().numpy()
        header = self.header.cpu().numpy()
        dense = np.zeros((n_rows * b, self.n_cols * b), dtype=blocks.dtype)
        for pc in range(self.n_cols):
            c = int(self.col_perm[pc])  # logical column stored at slot pc
            for s in range(self.max_kept):
                r = int(header[pc, s])
                if r < 0:
                    continue
                dense[r * b:(r + 1) * b, c * b:(c + 1) * b] = blocks[pc, s]
        return torch.as_tensor(dense[:m1, :m2], device=self.blocks.device)


def balance_columns(col_counts: np.ndarray, lanes: int = 8) -> np.ndarray:
    """Offline workload assignment (paper §V-D1): heaviest-first column
    order, the classic LPT heuristic for round-robin lane assignment."""
    return np.argsort(-np.asarray(col_counts), kind="stable")


def pack_weight(w: np.ndarray, block_mask: np.ndarray, block_size: int,
                lanes: int = 8,
                device: "str | torch.device" = "cpu") -> PackedWeight:
    """Pack ``w`` under ``block_mask`` (shape ``score_shape(w.shape, b)``);
    numpy throughout, tensors placed on ``device`` at the end."""
    m1, m2 = w.shape
    b = block_size
    n_rows, n_cols = block_mask.shape
    pad = np.zeros((n_rows * b, n_cols * b), dtype=w.dtype)
    pad[:m1, :m2] = w

    col_counts = block_mask.sum(axis=0).astype(np.int64)
    perm = balance_columns(col_counts, lanes)
    max_kept = max(1, int(col_counts.max()))

    blocks = np.zeros((n_cols, max_kept, b, b), dtype=w.dtype)
    header = np.full((n_cols, max_kept), -1, dtype=np.int32)
    counts = np.zeros((n_cols,), dtype=np.int32)
    for pc, c in enumerate(perm):
        rows = np.nonzero(block_mask[:, c])[0]
        counts[pc] = len(rows)
        for s, r in enumerate(rows):
            header[pc, s] = r
            blocks[pc, s] = pad[r * b:(r + 1) * b, c * b:(c + 1) * b]
    return PackedWeight(
        blocks=torch.as_tensor(blocks, device=device),
        header=torch.as_tensor(header, device=device),
        counts=torch.as_tensor(counts, device=device),
        col_perm=np.asarray(perm),
        shape=(m1, m2),
        block_size=b,
    )
