"""Quantized packed weights — the fp16 and int8 serving tiers; the port of
the reference package's ``core/quant.py``.

The int8 format keeps the exact ``blocks``/``header`` layout of
:class:`~repro_torch.core.packing.PackedWeight` (which the SBMM kernels
walk) with int8 blocks, plus float scales per kept block
(``scales [C, S]``) or per output channel of each kept block
(``scales [C, S, b]``, over the block's output columns — the serving
default). The dequant-in-kernel SBMM (``kernels.sbmm.quant``) multiplies
them in as it stages each block.

Precisions:

* ``fp32`` — the reference path;
* ``fp16`` — float16 blocks; the SBMM converts them to fp32 as it stages
  them, and the attention runs on fp16-cast q/k/v;
* ``int8`` — symmetric int8 blocks and fp32 scales.

Quantization runs in numpy with the reference's own arithmetic:
``scale = max|w| / 127`` (1.0 where the block or channel is all zero),
``q = clip(rint(w / scale), -127, 127)``. The same fp32 blocks therefore
give bit-identical int8 blocks and scales in both packages; only the
final tensors are torch tensors, on the source weight's device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.core.packing import PackedWeight, col_map_of

__all__ = ["PRECISIONS", "PRECISION_BYTES", "GRANULARITIES",
           "QuantizedPackedWeight", "quantize_packed", "dequantize_packed",
           "dequantize_blocks", "quantization_error", "quantize_packed_dict",
           "packed_dict_nbytes", "max_abs_error"]

PRECISIONS = ("fp32", "fp16", "int8")
PRECISION_BYTES = {"fp32": 4, "fp16": 2, "int8": 1}
GRANULARITIES = ("block", "channel")

_QMAX = 127.0  # symmetric int8: [-127, 127]


@dataclasses.dataclass
class QuantizedPackedWeight:
    """Block-compressed weight with int8 blocks and fp32 dequant scales:
    the :class:`PackedWeight` layout plus ``scales``, ``[C, S]`` per block
    or ``[C, S, b]`` per output channel."""

    blocks: torch.Tensor   # [n_cols, max_kept, b, b] int8
    scales: torch.Tensor   # [n_cols, max_kept] or [n_cols, max_kept, b] f32
    header: torch.Tensor   # [n_cols, max_kept] int32; -1 padding
    counts: torch.Tensor   # [n_cols] int32
    col_perm: np.ndarray
    shape: Tuple[int, int]
    block_size: int
    granularity: str = "block"
    # logical block column of each stored one, as in PackedWeight
    col_map: torch.Tensor = dataclasses.field(init=False, repr=False,
                                              compare=False)

    def __post_init__(self) -> None:
        self.col_map = col_map_of(self.col_perm, self.blocks.device)

    @property
    def n_cols(self) -> int:
        return self.blocks.shape[0]

    @property
    def max_kept(self) -> int:
        return self.blocks.shape[1]

    def to(self, device: "str | torch.device") -> "QuantizedPackedWeight":
        """This weight with its tensors on ``device`` (itself when they
        are there already)."""
        device = torch.device(device)
        if self.blocks.device == device:
            return self
        return QuantizedPackedWeight(
            self.blocks.to(device), self.scales.to(device),
            self.header.to(device), self.counts.to(device), self.col_perm,
            self.shape, self.block_size, self.granularity)

    def nbytes(self) -> int:
        """Model-size contribution: int8 blocks + headers + dequant scales,
        each at its actual dtype width (kept entries only)."""
        kept = int(self.counts.sum())
        b = self.block_size
        scales_per_block = b if self.granularity == "channel" else 1
        return (kept * b * b * self.blocks.element_size()
                + kept * self.header.element_size()
                + kept * scales_per_block * self.scales.element_size())

    def to_dense(self) -> torch.Tensor:
        """Dequantized dense reconstruction (the quantization oracle)."""
        return dequantize_packed(self).to_dense()


def _expand_scales(scales: np.ndarray) -> np.ndarray:
    """[C, S] -> [C, S, 1, 1] (block) or [C, S, b] -> [C, S, 1, b]
    (per output channel: axis 3 is the block's output-column axis)."""
    if scales.ndim == 2:
        return scales[:, :, None, None]
    return scales[:, :, None, :]


def _symmetric_scales(blocks: np.ndarray, granularity: str) -> np.ndarray:
    if granularity not in GRANULARITIES:
        raise ValueError(f"granularity must be one of {GRANULARITIES}, "
                         f"got {granularity!r}")
    if granularity == "block":
        amax = np.abs(blocks).max(axis=(2, 3))        # [C, S]
    else:
        amax = np.abs(blocks).max(axis=2)             # [C, S, b]
    return np.where(amax > 0.0, amax / _QMAX, 1.0).astype(np.float32)


def dequantize_blocks(blocks: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """``float(q) * scale`` per block ([C, S] scales) or per output column
    ([C, S, b] scales, over the block's last axis): the dequantized blocks
    the int8 SBMM kernel stages, bitwise."""
    s = scales[:, :, None, None] if scales.dim() == 2 else scales[:, :, None]
    return blocks.float() * s.float()


def _host(t: torch.Tensor, dtype=np.float32) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), dtype)


def quantize_packed(pw: PackedWeight, precision: str = "int8",
                    granularity: str = "block"
                    ) -> Union[PackedWeight, QuantizedPackedWeight]:
    """``pw`` at ``precision``: itself at ``fp32``, a :class:`PackedWeight`
    with float16 blocks at ``fp16``, a :class:`QuantizedPackedWeight` with
    symmetric scales at ``granularity`` at ``int8``. The result lies on
    ``pw``'s device (the numpy pass reads the blocks once from it)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    if precision == "fp32":
        return pw
    if precision == "fp16":
        return PackedWeight(
            blocks=pw.blocks.to(torch.float16), header=pw.header,
            counts=pw.counts, col_perm=pw.col_perm, shape=pw.shape,
            block_size=pw.block_size)
    dev = pw.blocks.device
    blocks = _host(pw.blocks)
    scales = _symmetric_scales(blocks, granularity)
    q = np.clip(np.rint(blocks / _expand_scales(scales)),
                -_QMAX, _QMAX).astype(np.int8)
    return QuantizedPackedWeight(
        blocks=torch.as_tensor(q, device=dev),
        scales=torch.as_tensor(scales, device=dev),
        header=pw.header, counts=pw.counts, col_perm=pw.col_perm,
        shape=pw.shape, block_size=pw.block_size, granularity=granularity)


def dequantize_packed(qpw) -> PackedWeight:
    """Back to an fp32 :class:`PackedWeight`: ``float(q) * scale`` for int8
    blocks, a plain upcast for fp16 blocks."""
    if isinstance(qpw, PackedWeight):
        return PackedWeight(
            blocks=qpw.blocks.float(), header=qpw.header, counts=qpw.counts,
            col_perm=qpw.col_perm, shape=qpw.shape,
            block_size=qpw.block_size)
    return PackedWeight(
        blocks=dequantize_blocks(qpw.blocks, qpw.scales), header=qpw.header,
        counts=qpw.counts, col_perm=qpw.col_perm, shape=qpw.shape,
        block_size=qpw.block_size)


def quantization_error(pw: PackedWeight, qpw) -> float:
    """Max-abs weight delta between the fp32 packed weight and the
    dequantized ``qpw``."""
    a = _host(pw.blocks)
    b = _host(dequantize_packed(qpw).blocks)
    return float(np.abs(a - b).max()) if a.size else 0.0


def quantize_packed_dict(packed: Dict[str, PackedWeight],
                         precision: str = "int8",
                         granularity: str = "block") -> Dict[str, object]:
    """Every weight of a ``pack_model`` dict at ``precision``."""
    return {k: quantize_packed(v, precision, granularity)
            for k, v in packed.items()}


def max_abs_error(packed: Dict[str, PackedWeight],
                  qpacked: Dict[str, object]) -> float:
    """Max-abs weight delta across a whole quantized model dict."""
    return max((quantization_error(packed[k], qpacked[k])
                for k in packed), default=0.0)


def packed_dict_nbytes(packed: Dict[str, object]) -> int:
    """Total packed model bytes (blocks + headers + scales) of a
    {path: PackedWeight | QuantizedPackedWeight} dict."""
    return sum(w.nbytes() for w in packed.values())
