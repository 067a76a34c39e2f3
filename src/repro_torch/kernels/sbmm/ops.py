"""SBMM — block-sparse ``y = x @ W`` over a packed weight.

Kernel K1 of the port: ``kernels/csrc/sbmm.cu`` replaces the reference
package's Pallas ``_sbmm_kernel`` / ``sbmm_pallas`` (``kernels/sbmm/
sbmm.py``) and its wrapper ``ops.sbmm``. One library, two entry points:
``sbmm_f32`` over fp32 blocks (the fp32 tier) and ``sbmm_f16w`` over fp16
blocks (the fp16 tier), both multiplying and accumulating in fp32, as the
reference's ``jnp.dot`` of fp32 x with an fp16 block does. The int8
entry points (``kernels.sbmm.quant``) share the tile and this module's
launcher. What bounds it on the H100 and how the design answers that is
noted in the CUDA source.

Every entry point writes stored block column ``j`` to output block column
``col_map[j]`` and drops output columns at or past ``n_out``.
:func:`sbmm`, which the packed runner calls, passes the weight's
``col_map`` (its load-balancing permutation) and logical width, so one
launch gives ``y`` in logical order, as the reference wrapper's un-permute
and slice do; :func:`sbmm_raw` passes ``arange(C)`` and ``C·b``, the
stored order of the reference's ``sbmm_ref``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.packing import PackedWeight
from repro_torch.core.quant import QuantizedPackedWeight, dequantize_blocks
from repro_torch.kernels import backend

NAME = "sbmm"
ENTRY_POINTS = {torch.float32: "sbmm_f32", torch.float16: "sbmm_f16w"}


def sbmm_plain(x: torch.Tensor, blocks: torch.Tensor, header: torch.Tensor,
               col_map: torch.Tensor, n_out: int) -> torch.Tensor:
    """Plain version of the kernel: scatter the kept blocks into a dense
    weight with stored block column ``j`` at block column ``col_map[j]``,
    multiply, keep the first ``n_out`` columns. x: [M, K] with K a multiple
    of b; returns [M, n_out]."""
    C, S, b, _ = blocks.shape
    n_rb = x.shape[1] // b
    valid = header >= 0
    cols = col_map.to(device=header.device, dtype=torch.long)[:, None]
    w = torch.zeros((n_rb, C, b, b), dtype=torch.float32, device=x.device)
    w[header[valid].long(), cols.expand(C, S)[valid]] = blocks[valid].float()
    y = x.float() @ w.permute(0, 2, 1, 3).reshape(n_rb * b, C * b)
    return y[:, :n_out]


def launch_tile(x: torch.Tensor, blocks: torch.Tensor, header: torch.Tensor,
                col_map: torch.Tensor, n_out: int,
                scales: "torch.Tensor | None" = None) -> torch.Tensor:
    """One launch of the SBMM entry point for these blocks (and scales):
    y [M, n_out] fp32. Checks what the kernel takes and raises on anything
    else; it never copies an input."""
    M, K = x.shape
    C, S, b, _ = blocks.shape
    if scales is None:
        lib, entry = NAME, ENTRY_POINTS.get(blocks.dtype)
        if entry is None:
            raise TypeError(f"sbmm takes fp32 or fp16 blocks, got "
                            f"{blocks.dtype} (int8 blocks come with "
                            f"scales: sbmm_quant_raw)")
        copied = (x, blocks)  # 16 bytes at a time
    else:
        lib = "sbmm_quant"
        entry = "sbmm_i8_block" if scales.dim() == 2 else "sbmm_i8_channel"
        want = (C, S) if scales.dim() == 2 else (C, S, b)
        if scales.shape != want:
            raise ValueError(f"{entry} takes scales of shape {want}, got "
                             f"{tuple(scales.shape)}")
        if blocks.dtype is not torch.int8 or \
                scales.dtype is not torch.float32:
            raise TypeError(f"{entry} takes int8 blocks and fp32 scales, "
                            f"got {blocks.dtype} and {scales.dtype}")
        copied = (x, blocks, scales)
    if b != 16:
        raise ValueError(f"the {lib} kernel takes 16x16 blocks, got {b}")
    i32 = torch.int32
    if x.dtype is not torch.float32 or not (header.dtype is
                                            col_map.dtype is i32):
        raise TypeError(f"{entry} takes fp32 x and int32 header and "
                        f"col_map, got {x.dtype}, {header.dtype} and "
                        f"{col_map.dtype}")
    tensors = (*copied, header, col_map)
    if not all([t.is_contiguous() for t in tensors]):
        raise ValueError(f"{entry} takes contiguous tensors")
    ptrs = [t.data_ptr() for t in tensors]
    if any([p % 16 for p in ptrs[:len(copied)]]):
        raise ValueError(f"{entry} copies x, the blocks and the scales 16 "
                         f"bytes at a time: each must start 16-byte "
                         f"aligned")
    y = x.new_empty((M, n_out))
    backend.launch(lib, entry, x.device, *ptrs, y.data_ptr(), M, K, C, S,
                   n_out)
    return y


def sbmm_raw(x: torch.Tensor, blocks: torch.Tensor,
             header: torch.Tensor) -> torch.Tensor:
    """x [M, K] (K a multiple of b) -> y [M, C·b] in stored column order,
    over fp32 or fp16 blocks: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if blocks.dtype not in ENTRY_POINTS:
        raise TypeError(f"sbmm takes fp32 or fp16 blocks, got "
                        f"{blocks.dtype} (int8 blocks come with scales: "
                        f"sbmm_quant_raw)")
    C, _, b, _ = blocks.shape
    col_map = torch.arange(C, dtype=torch.int32, device=header.device)
    if not backend.on_card(x, blocks, header):
        return sbmm_plain(x, blocks, header, col_map, C * b)
    return launch_tile(x, blocks, header, col_map, C * b)


def pad_input(x: torch.Tensor, packed) -> torch.Tensor:
    """x [..., K] -> [M, K'] with K' padded to a multiple of the block."""
    x2 = x if x.dim() == 2 else x.reshape(-1, x.shape[-1])
    k_pad = (-x2.shape[1]) % packed.block_size
    return F.pad(x2, (0, k_pad)) if k_pad else x2


def sbmm(x: torch.Tensor,
         packed: "PackedWeight | QuantizedPackedWeight") -> torch.Tensor:
    """Full SBMM: ``y = x @ W_masked`` in logical column order. A
    :class:`QuantizedPackedWeight` runs an int8 dequant-in-kernel entry
    point, a :class:`PackedWeight` the fp32 or fp16-block one; on the card
    that is one launch. x: [..., K]; returns [..., M2]."""
    K, n_out = packed.shape
    if x.shape[-1] != K:
        raise ValueError(f"sbmm: x has {x.shape[-1]} input features, the "
                         f"packed weight takes {K}")
    xp = pad_input(x, packed)
    scales = (packed.scales if isinstance(packed, QuantizedPackedWeight)
              else None)
    if backend.on_card(xp, packed.blocks):
        y = launch_tile(xp, packed.blocks, packed.header, packed.col_map,
                        n_out, scales)
    else:
        blocks = (packed.blocks if scales is None
                  else dequantize_blocks(packed.blocks, scales))
        y = sbmm_plain(xp, blocks, packed.header, packed.col_map, n_out)
    return y if x.dim() == 2 else y.reshape(x.shape[:-1] + (n_out,))
