"""Dequant-in-kernel SBMM — int8 blocks with fp32 scales times fp32
activations, for the int8 tier.

The counterpart of the reference package's Pallas ``_sbmm_quant_kernel`` /
``sbmm_quant_pallas`` (``kernels/sbmm/quant.py``): ``kernels/csrc/
sbmm_quant.cu`` runs the SBMM tile of ``sbmm.cu`` with int8 blocks
dequantized as ``float(q) * scale`` while they are staged, through one of
two entry points — ``sbmm_i8_block`` (``scales [C, S]``) or
``sbmm_i8_channel`` (``scales [C, S, b]``, one per output column of each
block). What bounds it on the H100 and how the design answers that is
noted in the CUDA source.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import dequantize_blocks
from repro_torch.kernels import backend

NAME = "sbmm_quant"


def sbmm_quant_plain(x: torch.Tensor, blocks: torch.Tensor,
                     header: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: dequantize the blocks densely, then the
    plain SBMM. x: [M, K] with K a multiple of b; returns [M, C·b] in
    stored column order."""
    from repro_torch.kernels.sbmm.ops import sbmm_plain  # ops imports us
    return sbmm_plain(x, dequantize_blocks(blocks, scales), header)


def _sbmm_quant_cuda(x: torch.Tensor, blocks: torch.Tensor,
                     header: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    M, K = x.shape
    C, S, b, _ = blocks.shape
    if b != 16:
        raise ValueError(f"the sbmm_quant kernel takes 16x16 blocks, got {b}")
    entry = "sbmm_i8_block" if scales.dim() == 2 else "sbmm_i8_channel"
    want = (C, S) if scales.dim() == 2 else (C, S, b)
    if tuple(scales.shape) != want:
        raise ValueError(f"{entry} takes scales of shape {want}, got "
                         f"{tuple(scales.shape)}")
    y = torch.empty((M, C * b), dtype=torch.float32, device=x.device)
    backend.launch(NAME, entry, x.device, x.data_ptr(), blocks.data_ptr(),
                   scales.data_ptr(), header.data_ptr(), y.data_ptr(),
                   M, K, C, S)
    return y


def sbmm_quant_raw(x: torch.Tensor, blocks: torch.Tensor,
                   header: torch.Tensor,
                   scales: torch.Tensor) -> torch.Tensor:
    """x [M, K] (K a multiple of b) -> y [M, C·b] in stored column order,
    over int8 blocks with fp32 scales: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if blocks.dtype != torch.int8:
        raise TypeError(f"sbmm_quant takes int8 blocks, got {blocks.dtype}")
    if not backend.on_card(x, blocks, header, scales):
        return sbmm_quant_plain(x, blocks, header, scales)
    if (x.dtype != torch.float32 or header.dtype != torch.int32
            or scales.dtype != torch.float32):
        raise TypeError(f"sbmm_quant kernel takes fp32 x, int32 header and "
                        f"fp32 scales, got {x.dtype}, {header.dtype} and "
                        f"{scales.dtype}")
    return _sbmm_quant_cuda(x.contiguous(), blocks.contiguous(),
                            header.contiguous(), scales.contiguous())
