"""The ViT (the paper's model): params, patchify and the dense oracle
forward — the ViT half of the reference package's ``models/model.py``.

Params are a nested dict with the reference's layout (``layers`` is a
list of per-layer dicts, weights ``[in, out]``), so trees converted from
the reference package (``repro_torch.convert``) drop in unchanged.
:func:`forward_vit` runs plain PyTorch only — no kernel — and is the
masked-dense oracle the packed path is held against.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import token_pruning as TP
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L


class Output(NamedTuple):
    logits: torch.Tensor


def _attn_params(g: torch.Generator, cfg: ModelConfig) -> Dict:
    H, Dh, D = cfg.num_heads, cfg.head_dim, cfg.d_model
    p = {"wq": L.dense_init(g, D, H * Dh), "wk": L.dense_init(g, D, H * Dh),
         "wv": L.dense_init(g, D, H * Dh), "wo": L.dense_init(g, H * Dh, D)}
    if cfg.use_bias:
        p.update(bq=torch.zeros(H * Dh), bk=torch.zeros(H * Dh),
                 bv=torch.zeros(H * Dh), bo=torch.zeros(D))
    return p


def _mlp_params(g: torch.Generator, cfg: ModelConfig) -> Dict:
    D, F = cfg.d_model, cfg.d_ff
    p = {"wi": L.dense_init(g, D, F), "wo": L.dense_init(g, F, D)}
    if cfg.use_bias:
        p.update(bi=torch.zeros(F), bo=torch.zeros(D))
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: "str | torch.device" = "cuda") -> Dict:
    """Random fp32 ViT params drawn from ``generator`` (on the CPU, so a
    seed gives the same weights on every device), placed on ``device``.
    The init rules match the reference's; the numbers differ (another
    generator) — tests convert the reference's params instead."""
    if cfg.family != "vit":
        raise NotImplementedError(
            f"family {cfg.family!r}: this package serves the ViT only")
    dev = resolve_device(device)
    g = generator
    D = cfg.d_model
    n_patches = (cfg.image_size // cfg.patch_size) ** 2
    patch_dim = cfg.patch_size ** 2 * 3
    params = {
        "patch_embed": L.dense_init(g, patch_dim, D),
        "patch_bias": torch.zeros(D),
        "cls": 0.02 * torch.randn((1, 1, D), generator=g),
        "pos": 0.02 * torch.randn((n_patches + 1, D), generator=g),
        "layers": [
            {"ln1_s": torch.ones(D), "ln1_b": torch.zeros(D),
             "ln2_s": torch.ones(D), "ln2_b": torch.zeros(D),
             "attn": _attn_params(g, cfg), "mlp": _mlp_params(g, cfg)}
            for _ in range(cfg.num_layers)],
        "ln_f_s": torch.ones(D),
        "ln_f_b": torch.zeros(D),
        "head": L.dense_init(g, D, cfg.num_classes),
    }
    return to_device(params, dev)


def to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """images: [B, H, W, 3] -> [B, N, patch*patch*3]."""
    B, H, W, C = images.shape
    ph, pw = H // patch, W // patch
    x = images.reshape(B, ph, patch, pw, patch, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, ph * pw, patch * patch * C)


def forward_vit(cfg: ModelConfig, params: Dict, patches: torch.Tensor,
                use_tdm: Optional[bool] = None) -> Output:
    """patches: [B, N, P²·3], fp32 throughout. Applies the TDM at
    ``cfg.pruning.tdm_layers`` when token pruning is enabled."""
    p = cfg.pruning
    if use_tdm is None:
        use_tdm = p.token_pruning_enabled
    H, Dh = cfg.num_heads, cfg.head_dim
    x = L.linear(patches.float(), params["patch_embed"], params["patch_bias"])
    B, N, D = x.shape
    cls = params["cls"].float().expand(B, 1, D)
    x = torch.cat([cls, x], dim=1) + params["pos"][None, : N + 1]

    for i, lp in enumerate(params["layers"]):
        has_tdm = use_tdm and (i in p.tdm_layers)
        h = L.layer_norm(x, lp["ln1_s"], lp["ln1_b"], cfg.norm_eps)
        ap = lp["attn"]
        n = h.shape[1]
        q = L.linear(h, ap["wq"], ap.get("bq")).reshape(B, n, H, Dh)
        k = L.linear(h, ap["wk"], ap.get("bk")).reshape(B, n, H, Dh)
        v = L.linear(h, ap["wv"], ap.get("bv")).reshape(B, n, H, Dh)
        o = A.flash_attention_torch(q, k, v).reshape(B, n, H * Dh)
        x = x + L.linear(o, ap["wo"], ap.get("bo"))
        if has_tdm:
            scores = A.attention_probs_row(q[:, 0], k).mean(dim=1)
            x, _ = TP.tdm(x, scores, p.r_t, has_cls=True)
        h = L.layer_norm(x, lp["ln2_s"], lp["ln2_b"], cfg.norm_eps)
        x = x + L.gelu_mlp(h, lp["mlp"])

    x = L.layer_norm(x, params["ln_f_s"], params["ln_f_b"], cfg.norm_eps)
    return Output(L.linear(x[:, 0], params["head"]).float())
