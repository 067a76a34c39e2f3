"""Analytic computational-complexity models (paper Tables I & II) and
model size (Table VI) — the port of the reference package's
``core/complexity.py``; the serving layers use :func:`vit_num_tokens`.

Table I (dense encoder, batch B, N tokens, H heads, per-head dim D',
embedding D, MLP dim D_mlp):

    LayerNorm (×2)     : B·N·D
    Residual  (×2)     : B·N·D
    MSA   (×1)         : 4·B·H·N·D·D' + 2·B·H·N²·D'
    MLP   (×1)         : 2·B·N·D·D_mlp

Table II (pruned encoder):

    LN1 + Res1         : 2·B·N·D
    LN2 + Res2         : 2·B·N_kept·D
    MSA                : B·H_kept·N·D'·D·(3α + α') + 2·B·H_kept·N²·D'
    TDM                : B·N·(H + N + D)
    MLP                : 2·B·N_kept·D·D_mlp·α_mlp       (α_mlp = r_b)

The paper reports **MACs** in Table VI; these formulas count MACs
(1 MAC = 2 FLOPs).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

from repro_torch.configs.base import ModelConfig, PruningConfig


@dataclasses.dataclass
class EncoderDims:
    B: int
    N: int
    H: int
    Dp: int      # per-head dim D'
    D: int
    Dmlp: int


def dense_encoder_macs(d: EncoderDims) -> Dict[str, float]:
    ln = d.B * d.N * d.D
    res = d.B * d.N * d.D
    msa = 4 * d.B * d.H * d.N * d.D * d.Dp + 2 * d.B * d.H * d.N ** 2 * d.Dp
    mlp = 2 * d.B * d.N * d.D * d.Dmlp
    return {
        "layernorm": 2 * ln,
        "residual": 2 * res,
        "msa": msa,
        "mlp": mlp,
        "total": 2 * ln + 2 * res + msa + mlp,
    }


def pruned_encoder_macs(d: EncoderDims, *, alpha: float, alpha_proj: float,
                        h_kept: int, n_kept: int, alpha_mlp: float,
                        has_tdm: bool) -> Dict[str, float]:
    ln1 = d.B * d.N * d.D
    ln2 = d.B * n_kept * d.D
    res1 = d.B * d.N * d.D
    res2 = d.B * n_kept * d.D
    msa = (d.B * h_kept * d.N * d.Dp * d.D * (3 * alpha + alpha_proj)
           + 2 * d.B * h_kept * d.N ** 2 * d.Dp)
    tdm = d.B * d.N * (d.H + d.N + d.D) if has_tdm else 0
    mlp = 2 * d.B * n_kept * d.D * d.Dmlp * alpha_mlp
    return {
        "layernorm": ln1 + ln2,
        "residual": res1 + res2,
        "msa": msa,
        "tdm": tdm,
        "mlp": mlp,
        "total": ln1 + ln2 + res1 + res2 + msa + tdm + mlp,
    }


def vit_num_tokens(cfg: ModelConfig) -> int:
    n_patches = (cfg.image_size // cfg.patch_size) ** 2
    return n_patches + 1  # + CLS


def model_macs(cfg: ModelConfig, batch: int = 1,
               pruning: PruningConfig | None = None) -> Dict[str, float]:
    """End-to-end MACs for a ViT under the paper's pruning model.

    Token counts shrink at each TDM layer (keep top ⌈(N−1)·r_t⌉ + CLS + 1
    fused). Weight pruning contributes α = α' = α_mlp = r_b on average
    (global top-k keeps r_b of all blocks; the expected per-column retained
    ratio equals r_b)."""
    p = pruning or cfg.pruning
    N = vit_num_tokens(cfg)
    H = cfg.num_heads
    Dp = cfg.head_dim
    D = cfg.d_model
    Dmlp = cfg.d_ff

    if p.weight_pruning_enabled:
        alpha = alpha_proj = alpha_mlp = p.r_b
        # head-retention measured empirically stays near 1 for r_b >= 0.5
        h_kept = H
    else:
        alpha = alpha_proj = alpha_mlp = 1.0
        h_kept = H

    per_layer: List[Dict[str, float]] = []
    total = 0.0
    n = N
    for layer in range(cfg.num_layers):
        has_tdm = p.token_pruning_enabled and layer in p.tdm_layers
        if has_tdm:
            n_body = n - 1
            n_kept = 1 + max(1, math.ceil(n_body * p.r_t)) + 1
        else:
            n_kept = n
        d = EncoderDims(B=batch, N=n, H=H, Dp=Dp, D=D, Dmlp=Dmlp)
        if p.weight_pruning_enabled or p.token_pruning_enabled:
            macs = pruned_encoder_macs(
                d, alpha=alpha, alpha_proj=alpha_proj, h_kept=h_kept,
                n_kept=n_kept, alpha_mlp=alpha_mlp, has_tdm=has_tdm)
        else:
            macs = dense_encoder_macs(d)
        per_layer.append(macs)
        total += macs["total"]
        n = n_kept
    # patch embedding + classifier head
    embed = batch * (N - 1) * (cfg.patch_size ** 2 * 3) * D
    head = batch * cfg.num_classes * D
    total += embed + head
    return {"total": total, "per_layer": per_layer, "embed": embed,
            "head": head}


def model_size_bytes(cfg: ModelConfig, pruning: PruningConfig | None = None,
                     dtype_bytes: int = 4) -> int:
    """Paper-style model size. Pruned MSA tensors store only surviving
    blocks (+4-byte headers per block); pruned MLP tensors shrink by r_b;
    embeddings / LN / biases stay dense. The paper's Table VI sizes are in
    fp32 'M parameters' equivalents (22M baseline)."""
    p = pruning or cfg.pruning
    D, H, Dp, Dmlp = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff
    r = p.r_b if p.weight_pruning_enabled else 1.0
    b = p.block_size

    msa_dense = 4 * D * H * Dp  # q,k,v,proj
    mlp_dense = 2 * D * Dmlp
    per_layer = 0
    if p.weight_pruning_enabled:
        n_blocks_msa = 4 * math.ceil(D / b) * math.ceil(H * Dp / b)
        kept = math.ceil(n_blocks_msa * r)
        per_layer += kept * b * b * dtype_bytes + kept * 4
        per_layer += int(mlp_dense * r) * dtype_bytes
    else:
        per_layer += (msa_dense + mlp_dense) * dtype_bytes
    per_layer += (4 * D + 2 * D + Dmlp + 2 * 2 * D) * dtype_bytes  # biases+LN
    embed = ((cfg.patch_size ** 2 * 3) * D + (vit_num_tokens(cfg)) * D
             + cfg.num_classes * D) * dtype_bytes
    return cfg.num_layers * per_layer + embed


def compression_ratio(cfg: ModelConfig, pruning: PruningConfig) -> float:
    dense = model_size_bytes(cfg, PruningConfig())
    pruned = model_size_bytes(cfg, pruning)
    return dense / pruned
