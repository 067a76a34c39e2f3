"""Cycle-accurate performance model of the paper's accelerator (Table III,
Algorithm 2, §V-E) — the cost model the serving planner prices tiles with.
Its cycles are the paper's FPGA cycles; nothing here is a GPU figure.

FPGA cycle model (from Algorithm 2's loop nest): multiplying an
``(M1, M2)`` input by an ``(M2, D)`` weight, with ``H`` heads, block size
``b``, PE-array ``p_h × p_t × p_c`` and ``p_pe²`` MACs per PE, and per-column
retained-block ratio ``φ`` (φ=1 for DBMM):

    cycles = ⌈H/p_h⌉ · ⌈⌈D'/b⌉/p_c⌉ · ⌈⌈M1/b⌉/p_t⌉ · (φ·⌈M2/b⌉) · b³/p_pe²

DHBMM (per-head dense, e.g. Q·Kᵀ) uses per-head matrix sizes with the same
nest. The paper's U250 instance: p_h=4, p_t=12, p_c=2, p_pe=8, 300 MHz.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.configs.base import ModelConfig, PruningConfig


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    p_h: int = 4
    p_t: int = 12
    p_c: int = 2
    p_pe: int = 8
    freq_hz: float = 300e6

    @property
    def macs_per_cycle(self) -> int:
        return self.p_h * self.p_t * self.p_c * self.p_pe ** 2


PAPER_U250 = AcceleratorConfig()

# Precision throughput multipliers for the modeled PE array: halving the
# operand width doubles the MACs each p_pe² cell packs per cycle (the
# classic DSP-packing argument on FPGAs; on the MXU, int8/fp16 tiles hit
# the higher-throughput systolic modes). Deliberately coarse — the planner
# only needs the ORDERING (int8 < fp16 < fp32) and a stable ratio;
# ``TileCostModel.calibrate`` owns the absolute scale.
PRECISION_SPEEDUP = {"fp32": 1.0, "fp16": 2.0, "int8": 4.0}


def precision_speedup(precision: str) -> float:
    try:
        return PRECISION_SPEEDUP[precision]
    except KeyError:
        raise ValueError(
            f"precision must be one of {tuple(PRECISION_SPEEDUP)}, "
            f"got {precision!r}") from None


def _ceil(a: float, b: float) -> int:
    return math.ceil(a / b)


def sbmm_cycles(M1: int, M2: int, D: int, H: int, b: int,
                acc: AcceleratorConfig, phi: float = 1.0,
                mode: str = "pipelined") -> int:
    """Cycles for SBMM/DBMM per Table III. ``D = H·D'``.

    ``mode="strict"`` evaluates Algorithm 2's loop nest literally (every
    partially-filled iteration costs a full iteration) — an upper bound.
    ``mode="pipelined"`` is work-conserving: leftover PE rows of one
    iteration are filled with the next iteration's blocks (the paper's MPCA
    streams column blocks back-to-back, which is how the reported 3.19 ms
    dense / 0.868 ms pruned latencies are achievable on 6144 MACs)."""
    Dp = D // max(H, 1)
    per_block = b * b * b / acc.p_pe ** 2
    inner = max(1, math.ceil(phi * _ceil(M2, b)))
    if mode == "strict":
        outer = (_ceil(H, acc.p_h)
                 * _ceil(_ceil(Dp, b), acc.p_c)
                 * _ceil(_ceil(M1, b), acc.p_t))
        return int(outer * inner * per_block)
    n_block_pairs = H * _ceil(Dp, b) * _ceil(M1, b) * inner
    pes = acc.p_h * acc.p_t * acc.p_c
    return int(math.ceil(n_block_pairs / pes) * per_block)


def dhbmm_cycles(M1: int, M2: int, D: int, H: int, b: int,
                 acc: AcceleratorConfig, mode: str = "pipelined") -> int:
    """Per-head dense block matmul (stage ii/iii: Q·Kᵀ, A·V). ``(M1, M2)``
    and ``(M2, D)`` are the per-head operand shapes."""
    per_block = b * b * b / acc.p_pe ** 2
    inner = _ceil(M2, b)
    if mode == "strict":
        outer = (_ceil(H, acc.p_h)
                 * _ceil(_ceil(D, b), acc.p_c)
                 * _ceil(_ceil(M1, b), acc.p_t))
        return int(outer * inner * per_block)
    n_block_pairs = H * _ceil(D, b) * _ceil(M1, b) * inner
    pes = acc.p_h * acc.p_t * acc.p_c
    return int(math.ceil(n_block_pairs / pes) * per_block)


def encoder_cycles(N: int, cfg: ModelConfig, p: PruningConfig,
                   acc: AcceleratorConfig, has_tdm: bool,
                   mode: str = "pipelined") -> Dict[str, int]:
    """Cycle estimate for one pruned encoder layer at token count ``N``."""
    D, H, Dp, Dmlp = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff
    b = p.block_size
    phi = p.r_b if p.weight_pruning_enabled else 1.0
    n_kept = N
    if has_tdm:
        n_kept = 1 + max(1, math.ceil((N - 1) * p.r_t)) + 1

    # stage i: Z(N×D) × W_qkv(D×3D)  — SBMM (sparse weights)
    qkv = sbmm_cycles(N, D, 3 * H * Dp, H, b, acc, phi, mode)
    # stage ii: per-head Q(N×D')·Kᵀ(D'×N) — DHBMM
    qk = dhbmm_cycles(N, Dp, N, H, b, acc, mode)
    # stage iii: per-head A(N×N)·V(N×D') — DHBMM
    av = dhbmm_cycles(N, N, Dp, H, b, acc, mode)
    # stage iv: concat(N×HD') × W_proj(HD'×D) — SBMM
    proj = sbmm_cycles(N, H * Dp, D, 1, b, acc, phi, mode)
    # TDM: bitonic sort network is fully pipelined; shuffle streams one token
    # row per cycle through the index network -> ~N·D/(b·p_pe²) cycles
    tdm = _ceil(N * D, b * acc.p_pe ** 2) if has_tdm else 0
    # softmax/GELU stream through the EM overlapped with MPCA; LN/residual
    # add a non-overlapped epilogue per stage
    em = 4 * _ceil(N * D, acc.p_h * acc.p_t * acc.p_c * acc.p_pe)
    # MLP: two DBMMs at reduced width (column/row pruning keeps r_b of D_mlp)
    dmlp_kept = int(Dmlp * phi)
    mlp1 = sbmm_cycles(n_kept, D, dmlp_kept, 1, b, acc, 1.0, mode)
    mlp2 = sbmm_cycles(n_kept, dmlp_kept, D, 1, b, acc, 1.0, mode)
    total = qkv + qk + av + proj + tdm + em + mlp1 + mlp2
    return {"qkv": qkv, "qk": qk, "av": av, "proj": proj, "tdm": tdm,
            "em": em, "mlp": mlp1 + mlp2, "total": total}


def vit_segment_cycles(cfg: ModelConfig, seg, n_tokens: int,
                       acc: AcceleratorConfig = PAPER_U250,
                       mode: str = "pipelined",
                       precision: str = "fp32") -> float:
    """Cycles for ONE image row of a ``core.packed_runner`` segment at a
    (padded) token count of ``n_tokens`` — the per-stage pricing the
    serving ``TileCostModel`` uses to trade padding against dispatches
    (merge decisions) and to estimate remaining work (deadline slack).
    Segment forms: ``("embed",) | ("layers", lo, hi) | ("tdm", i) |
    ("head",)``. ``precision`` scales the encoder-segment cost by the PE
    array's narrower-operand throughput (``PRECISION_SPEEDUP``); embed and
    head always run fp32 in the serving path, so only the weight-bearing
    ``layers``/``tdm`` segments get the discount."""
    p = cfg.pruning
    kind = seg[0]
    speed = precision_speedup(precision)
    if kind == "embed":
        pdim = cfg.patch_size ** 2 * 3
        return float(sbmm_cycles(n_tokens, pdim, cfg.d_model, 1,
                                 p.block_size, acc, mode=mode))
    if kind == "layers":
        return float((seg[2] - seg[1]) * encoder_cycles(
            n_tokens, cfg, p, acc, has_tdm=False, mode=mode)["total"]
            / speed)
    if kind == "tdm":
        return float(encoder_cycles(n_tokens, cfg, p, acc, has_tdm=True,
                                    mode=mode)["total"] / speed)
    if kind == "head":
        return float(sbmm_cycles(1, cfg.d_model, cfg.num_classes, 1,
                                 p.block_size, acc, mode=mode)
                     + dhbmm_cycles(n_tokens, cfg.d_model, 1, 1,
                                    p.block_size, acc, mode=mode))
    raise ValueError(f"unknown segment kind {kind!r}")
