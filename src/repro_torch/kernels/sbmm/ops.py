"""SBMM — block-sparse ``y = x @ W`` over a :class:`PackedWeight`.

Kernel K1 of the port: ``kernels/csrc/sbmm.cu`` replaces the reference
package's Pallas ``_sbmm_kernel`` / ``sbmm_pallas`` (``kernels/sbmm/
sbmm.py``) and its wrapper ``ops.sbmm``. What bounds it on the H100 and
how the design answers that is noted in the CUDA source.

:func:`sbmm` is what the packed runner calls. It flattens the leading
axes, pads K to the block size, runs :func:`sbmm_raw` (the kernel on the
card, :func:`sbmm_plain` on the CPU), and undoes the load-balancing column
permutation exactly as the reference wrapper does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.packing import PackedWeight
from repro_torch.kernels import backend

NAME = "sbmm"


def sbmm_plain(x: torch.Tensor, blocks: torch.Tensor,
               header: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: scatter the kept blocks into a dense
    ``[K, C·b]`` weight (stored column order) and multiply. x: [M, K]
    with K a multiple of b; returns [M, C·b]."""
    C, S, b, _ = blocks.shape
    n_rb = x.shape[1] // b
    valid = header >= 0
    cols = torch.arange(C, device=header.device)[:, None].expand(C, S)
    w = torch.zeros((n_rb, C, b, b), dtype=torch.float32, device=x.device)
    w[header[valid].long(), cols[valid]] = blocks[valid].float()
    return x.float() @ w.permute(0, 2, 1, 3).reshape(n_rb * b, C * b)


def _sbmm_cuda(x: torch.Tensor, blocks: torch.Tensor,
               header: torch.Tensor) -> torch.Tensor:
    M, K = x.shape
    C, S, b, _ = blocks.shape
    if b != 16:
        raise ValueError(f"the sbmm kernel takes 16x16 blocks, got {b}")
    y = torch.empty((M, C * b), dtype=torch.float32, device=x.device)
    lib = backend.library(NAME)
    err = lib.sbmm_f32(x.data_ptr(), blocks.data_ptr(), header.data_ptr(),
                       y.data_ptr(), M, K, C, S,
                       backend.stream_ptr(x.device))
    backend.check(NAME, err)
    backend.count_launch(NAME)
    return y


def sbmm_raw(x: torch.Tensor, blocks: torch.Tensor,
             header: torch.Tensor) -> torch.Tensor:
    """x [M, K] (K a multiple of b) -> y [M, C·b] in stored column order:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    if blocks.dtype != torch.float32:
        raise NotImplementedError(
            f"sbmm over {blocks.dtype} blocks belongs to the fp16/int8 "
            f"tiers (ROADMAP queue B, int8 dequant SBMM)")
    if not backend.on_card(x, blocks, header):
        return sbmm_plain(x, blocks, header)
    if x.dtype != torch.float32 or header.dtype != torch.int32:
        raise TypeError(f"sbmm kernel takes fp32 x and int32 header, got "
                        f"{x.dtype} and {header.dtype}")
    return _sbmm_cuda(x.contiguous(), blocks.contiguous(),
                      header.contiguous())


def pad_input(x: torch.Tensor, packed: PackedWeight) -> torch.Tensor:
    """x [..., K] -> [M, K'] with K' padded to a multiple of the block."""
    x2 = x.reshape(-1, x.shape[-1])
    k_pad = (-x2.shape[1]) % packed.block_size
    return F.pad(x2, (0, k_pad)) if k_pad else x2


def unpermute(y: torch.Tensor, packed: PackedWeight) -> torch.Tensor:
    """[M, C·b] in stored column order -> [M, M2] in logical order: slot
    pc holds logical block column col_perm[pc]."""
    M, C, b = y.shape[0], packed.n_cols, packed.block_size
    y = y.view(M, C, b).index_select(1, packed.inv_perm).reshape(M, C * b)
    return y[:, :packed.shape[1]]


def sbmm(x: torch.Tensor, packed: PackedWeight) -> torch.Tensor:
    """Full SBMM: ``y = x @ W_masked`` in logical column order.
    x: [..., K]; returns [..., M2]."""
    if x.shape[-1] != packed.shape[0]:
        raise ValueError(f"sbmm: x has {x.shape[-1]} input features, the "
                         f"packed weight takes {packed.shape[0]}")
    y = sbmm_raw(pad_input(x, packed), packed.blocks, packed.header)
    return unpermute(y, packed).reshape(x.shape[:-1] + (packed.shape[1],))
