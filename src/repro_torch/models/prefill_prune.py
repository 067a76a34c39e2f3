"""Token-pruned LM prefill: the paper's TDM on a causal prompt, the port of
the reference package's ``models/prefill_prune.py``.

For a decoder-only LM, prefill is encoder-like from the viewpoint of the
last position: prompt tokens that the last row attends little to add
little to the next-token prediction. At ``cfg.pruning.tdm_layers`` the
TDM drops them, scoring by the last query row's attention probabilities
(the CLS row's analog) averaged over heads, and fuses the dropped ones
into one carrier token, as the paper fuses inattentive image patches.

Kept tokens stay in temporal order and keep their RoPE positions; the last
token (the predictor) is always kept; the carrier, placed just before it,
takes the largest kept position, as the reference gives it. The layers run
in a Python loop because each TDM layer changes the sequence length. On
the card every layer's attention is the causal prefill kernel
(``flash_prefill_bf16``) over the shrinking sequence, and each TDM layer's
score row is one launch of the causal decode kernel
(``flash_decode_bf16``, its probability output); the TDM itself is tensor
code on ``[B, N, D]``, as the reference's is jnp. Dense LMs only, plain or
with qk-norm, as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import token_pruning as TP
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M


@torch.no_grad()
def pruned_prefill_logits(cfg: ModelConfig, params: Dict,
                          tokens: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """The last position's logits with the TDM applied during the prefill
    of ``tokens`` [B, N] (on the params' device: the card's kernels for
    CUDA tensors, the plain versions on the CPU). Returns ``(logits [B,
    vocab] fp32, tokens left after the last TDM layer)``."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"prefill TDM runs the dense LMs only (plain or qk-norm), as in "
            f"the reference; got family {cfg.family!r}")
    p = cfg.pruning
    adt = getattr(torch, cfg.dtype)
    B, N = tokens.shape
    x = params["embed"][tokens].to(adt)
    positions = torch.arange(N, device=x.device).expand(B, N)
    for i, lp in enumerate(params["layers"]):
        has_tdm = p.token_pruning_enabled and i in p.tdm_layers
        res = A.attention_block(L.rms_norm(x, lp["ln1"], cfg.norm_eps),
                                lp["attn"], cfg, positions=positions,
                                collect_scores=has_tdm, score_row=-1)
        x = x + res[0]
        x = x + L.glu_mlp(L.rms_norm(x, lp["ln2"], cfg.norm_eps), lp["mlp"])
        if has_tdm:
            x, positions = _tdm_causal(x, positions, res[2], p.r_t)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = x[:, -1] @ M.unembed_matrix(params).to(adt)
    return logits.float(), x.shape[1]


def _tdm_causal(x: torch.Tensor, positions: torch.Tensor,
                scores: torch.Tensor, r_t: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TDM on a causal prompt: keep the last token, keep the top
    ``ceil((N - 1) r_t)`` of the rest by score (ties toward the lower
    index, as ``jax.lax.top_k``) in temporal order with their positions,
    and fuse the others into one carrier with weights ``s / (sum s +
    1e-9)`` at the largest kept position. Returns ``(x_out [B, k + 2, D],
    positions [B, k + 2])``."""
    B, N, D = x.shape
    body, body_pos, s_body = x[:, :-1], positions[:, :-1], scores[:, :-1]
    k = max(1, math.ceil((N - 1) * r_t))
    top_idx, w = TP.drop_weights(s_body, k)
    top_idx = torch.sort(top_idx, dim=-1).values  # temporal order
    kept = torch.gather(body, 1, top_idx[..., None].expand(B, k, D))
    kept_pos = torch.gather(body_pos, 1, top_idx)
    fused = torch.einsum("bn,bnd->bd", w.to(x.dtype), body)
    fused_pos = kept_pos.max(dim=1).values
    x_out = torch.cat([kept, fused[:, None], x[:, -1:]], dim=1)
    pos_out = torch.cat([kept_pos, fused_pos[:, None], positions[:, -1:]],
                        dim=1)
    return x_out, pos_out
