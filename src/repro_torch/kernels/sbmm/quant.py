"""Dequant-in-kernel SBMM — int8 blocks with fp32 scales times fp32
activations, for the int8 tier.

The counterpart of the reference package's Pallas ``_sbmm_quant_kernel`` /
``sbmm_quant_pallas`` (``kernels/sbmm/quant.py``): ``kernels/csrc/
sbmm_quant.cu`` runs the SBMM tile of ``sbmm.cu`` with int8 blocks
dequantized as ``float(q) * scale`` once they are staged, through one of
two entry points — ``sbmm_i8_block`` (``scales [C, S]``) or
``sbmm_i8_channel`` (``scales [C, S, b]``, one per output column of each
block). :func:`~repro_torch.kernels.sbmm.ops.sbmm` launches them for a
:class:`~repro_torch.core.quant.QuantizedPackedWeight`; what bounds them
on the H100 and how the design answers that is noted in the CUDA source.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import dequantize_blocks
from repro_torch.kernels import backend
from repro_torch.kernels.sbmm.ops import launch_tile, sbmm_plain

NAME = "sbmm_quant"


def sbmm_quant_plain(x: torch.Tensor, blocks: torch.Tensor,
                     header: torch.Tensor, scales: torch.Tensor,
                     col_map: torch.Tensor, n_out: int) -> torch.Tensor:
    """Plain version of the kernel: dequantize the blocks densely, then the
    plain SBMM (stored block column ``j`` at ``col_map[j]``, the first
    ``n_out`` columns). x: [M, K] with K a multiple of b."""
    return sbmm_plain(x, dequantize_blocks(blocks, scales), header, col_map,
                      n_out)


def sbmm_quant_raw(x: torch.Tensor, blocks: torch.Tensor,
                   header: torch.Tensor,
                   scales: torch.Tensor) -> torch.Tensor:
    """x [M, K] (K a multiple of b) -> y [M, C·b] in stored column order,
    over int8 blocks with fp32 scales: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if blocks.dtype != torch.int8:
        raise TypeError(f"sbmm_quant takes int8 blocks, got {blocks.dtype}")
    C, _, b, _ = blocks.shape
    col_map = torch.arange(C, dtype=torch.int32, device=header.device)
    if not backend.on_card(x, blocks, header, scales):
        return sbmm_quant_plain(x, blocks, header, scales, col_map, C * b)
    return launch_tile(x, blocks, header, col_map, C * b, scales)
