"""The models: the ViT (the paper's model) and the dense, MoE, VLM (gated
cross-attention layers over vision tokens), audio (Whisper's
encoder-decoder), hybrid (Mamba2 with a shared attention block) and SSM
(RWKV6) LM families — params, patchify, the ViT's dense oracle forward, the
LM forward and the LM's training loss; the port of the reference package's
``models/model.py``.

Params are a nested dict with the reference's layout, except that
``layers`` is a list of per-layer dicts where the reference stacks them
on a leading axis (weights ``[in, out]``); ``convert`` turns the
reference's trees into this layout. :func:`forward_vit` is the forward
that training differentiates and the masked-dense oracle the packed path is
held against: its attention and TDM go through the ``flash_attention`` and
``token_drop`` kernel wrappers, so on CUDA tensors they are the kernels
(in training with their backward kernels) and on CPU tensors the plain
versions, which autograd differentiates; as an oracle it runs on the
CPU. :func:`forward_lm` runs its attention through the ``flash_attention``
kernel wrapper (the kernels for CUDA tensors; in training the causal
kernel pair with its backward) and, in train mode, checkpoints each layer
by ``cfg.remat_policy`` as the reference's ``_remat`` does. The MoE
family runs the same attention layers with ``models/moe.moe_ffn`` in place
of the SwiGLU MLP, and each layer's load-balancing loss is carried out of
its checkpoint into the training loss. The VLM and audio families'
cross-attention and Whisper's encoder run the non-causal form of the
``flash_attention`` wrapper, the non-causal bf16 kernels on the card (in
training with their backward kernel). The hybrid and SSM families run
``models/ssm``'s blocks, whose scans
are the ``ssm_scan`` kernels on the card (in training with their backward
kernels), its shared attention block the causal kernel pair.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.core import token_pruning as TP
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.token_drop import ops as TD
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.tree import tree_map

# LM families ``forward_lm`` runs
LM_FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid", "ssm")


class Output(NamedTuple):
    logits: Optional[torch.Tensor]
    caches: Any = None    # LM prefill/decode: the serve-cache list
    hidden: Optional[torch.Tensor] = None  # LM: the final-norm hidden states
    aux_loss: Any = 0.0   # LM: the MoE load-balancing loss summed over layers


def _attn_params(g: torch.Generator, cfg: ModelConfig,
                 dtype=torch.float32, kv_from: Optional[int] = None) -> Dict:
    """q, k, v and output projections; ``kv_from``: the width k and v are
    projected from (a cross-attention layer's vision tokens), else D."""
    H, KV, Dh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    dev = g.device
    d_kv = kv_from or D
    p = {"wq": L.dense_init(g, D, H * Dh, dtype),
         "wk": L.dense_init(g, d_kv, KV * Dh, dtype),
         "wv": L.dense_init(g, d_kv, KV * Dh, dtype),
         "wo": L.dense_init(g, H * Dh, D, dtype)}
    zeros = lambda n: torch.zeros(n, dtype=dtype, device=dev)
    if cfg.use_bias:
        p.update(bq=zeros(H * Dh), bk=zeros(KV * Dh), bv=zeros(KV * Dh),
                 bo=zeros(D))
    if cfg.qk_norm:
        p.update(q_norm=torch.ones(Dh, dtype=dtype, device=dev),
                 k_norm=torch.ones(Dh, dtype=dtype, device=dev))
    return p


def _mlp_params(g: torch.Generator, cfg: ModelConfig, glu: bool = False,
                dtype=torch.float32) -> Dict:
    D, F = cfg.d_model, cfg.d_ff
    if glu:
        return {"wg": L.dense_init(g, D, F, dtype),
                "wi": L.dense_init(g, D, F, dtype),
                "wo": L.dense_init(g, F, D, dtype)}
    p = {"wi": L.dense_init(g, D, F, dtype),
         "wo": L.dense_init(g, F, D, dtype)}
    if cfg.use_bias:
        p.update(bi=torch.zeros(F, dtype=dtype, device=g.device),
                 bo=torch.zeros(D, dtype=dtype, device=g.device))
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: "str | torch.device" = "cuda") -> Dict:
    """Random params drawn from ``generator`` and placed on ``device``. The
    init rules match the reference's; the numbers differ (another
    generator) — tests convert the reference's params instead.

    The ViT's are fp32, drawn on the CPU so a seed gives the same weights
    on every device. The dense and MoE LMs' are in ``cfg.param_dtype``
    and drawn on the generator's device: a generator on the card makes
    full-width weights there without a pass through host memory."""
    if cfg.fuse_qkv:
        raise NotImplementedError(
            "fuse_qkv (a training perf lever of the reference's "
            "launch/perf.py) is not ported; the port keeps wq, wk, wv apart")
    if cfg.family in LM_FAMILIES:
        return _init_lm(cfg, generator, resolve_device(device))
    if cfg.family != "vit":
        raise NotImplementedError(
            f"family {cfg.family!r}: this package runs the ViT and the "
            f"{', '.join(LM_FAMILIES)} LMs")
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


def _init_lm(cfg: ModelConfig, g: torch.Generator,
             dev: torch.device) -> Dict:
    """embed → layers → RMSNorm → unembed (``model.py:94-183`` of the
    reference, stacked layers as lists). Dense and MoE: ``layers`` of
    [RMSNorm, attention, RMSNorm, SwiGLU or MoE FFN]. Hybrid: ``stages``
    (each ``attn_layer_period`` Mamba2 layers ``{"ln", "mamba"}``), one
    ``shared_attn`` block (a dense layer) applied after every stage, and a
    ``tail`` of the remaining Mamba2 layers. SSM: ``layers`` of RWKV6
    blocks. VLM: ``stages`` = ``{"self": [n_stages][n_self] dense layers,
    "cross": [n_stages] gated cross layers}`` (``vlm_layout``), a cross
    layer's k and v projected from the vision tokens' width and its
    ``gate`` a 0-d tensor at 0, as the reference initializes it. Audio:
    ``enc_layers`` (encoder layers with a GELU MLP), ``enc_pos`` [frames,
    D], ``enc_ln_f``, and decoder ``layers`` of [RMSNorm, self-attention,
    RMSNorm ``ln_x``, cross-attention ``xattn``, RMSNorm, GELU MLP]."""
    dtype = getattr(torch, cfg.param_dtype)
    D = cfg.d_model
    ones = lambda: torch.ones(D, dtype=dtype, device=g.device)
    p: Dict[str, Any] = {
        "embed": L.embed_init(g, cfg.vocab_size, D, dtype),
        "ln_f": ones(),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = L.dense_init(g, D, cfg.vocab_size, dtype)

    def layer():
        lp = {"ln1": ones(), "ln2": ones(),
              "attn": _attn_params(g, cfg, dtype)}
        if cfg.family == "moe":
            lp["moe"] = MOE.init_moe_params(g, cfg, dtype)
        else:
            lp["mlp"] = _mlp_params(g, cfg, glu=True, dtype=dtype)
        return lp

    def mamba():
        return {"ln": ones(), "mamba": SSM.init_mamba_params(g, cfg, dtype)}

    def cross_layer():
        return {"ln1": ones(), "ln2": ones(),
                "attn": _attn_params(g, cfg, dtype,
                                     kv_from=cfg.vision_d_model or D),
                "mlp": _mlp_params(g, cfg, glu=True, dtype=dtype),
                "gate": torch.zeros((), dtype=dtype, device=g.device)}

    def audio_layer(decoder: bool):
        lp = {"ln1": ones(), "ln2": ones(),
              "attn": _attn_params(g, cfg, dtype)}
        if decoder:
            lp.update(ln_x=ones(), xattn=_attn_params(g, cfg, dtype))
        lp["mlp"] = _mlp_params(g, cfg, glu=False, dtype=dtype)
        return lp
    if cfg.family == "vlm":
        n_stages, n_self = vlm_layout(cfg)
        p["stages"] = {"self": [[layer() for _ in range(n_self)]
                                for _ in range(n_stages)],
                       "cross": [cross_layer() for _ in range(n_stages)]}
    elif cfg.family == "audio":
        p["enc_layers"] = [audio_layer(False)
                           for _ in range(cfg.encoder_layers)]
        p["layers"] = [audio_layer(True) for _ in range(cfg.num_layers)]
        p["enc_ln_f"] = ones()
        p["enc_pos"] = 0.02 * torch.randn(
            (cfg.num_audio_frames, D), generator=g, dtype=dtype,
            device=g.device)
    elif cfg.family == "hybrid":
        period, n_stages, rem = hybrid_layout(cfg)
        p["stages"] = [[mamba() for _ in range(period)]
                       for _ in range(n_stages)]
        p["shared_attn"] = layer()
        if rem:
            p["tail"] = [mamba() for _ in range(rem)]
    elif cfg.family == "ssm":
        p["layers"] = [SSM.init_rwkv_params(g, cfg, dtype)
                       for _ in range(cfg.num_layers)]
    else:
        p["layers"] = [layer() for _ in range(cfg.num_layers)]
    return to_device(p, dev)


def hybrid_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(period, stages, tail layers) of a hybrid config."""
    period = cfg.attn_layer_period
    n_stages = cfg.num_layers // period
    return period, n_stages, cfg.num_layers - n_stages * period


def vlm_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(stages, self-attention layers per stage) of a VLM config: each
    stage is ``cross_attn_period - 1`` dense layers and one gated cross
    layer; layers past the last whole stage are not built, as in the
    reference."""
    period = cfg.cross_attn_period
    return cfg.num_layers // period, period - 1


def num_caches(cfg: ModelConfig) -> int:
    """Entries of the serve-cache list of ``cfg``: one per layer, for the
    hybrid one more per stage (its shared block's ``KVCache``), for the
    VLM one per self-attention layer (its cross layers keep none)."""
    if cfg.family == "hybrid":
        return cfg.num_layers + hybrid_layout(cfg)[1]
    if cfg.family == "vlm":
        n_stages, n_self = vlm_layout(cfg)
        return n_stages * n_self
    return cfg.num_layers


def to_device(tree, device: torch.device):
    return tree_map(lambda t: t.to(device), tree)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """images: [B, H, W, 3] -> [B, N, patch*patch*3]."""
    B, H, W, C = images.shape
    ph, pw = H // patch, W // patch
    x = images.reshape(B, ph, patch, pw, patch, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, ph * pw, patch * patch * C)


def forward_vit(cfg: ModelConfig, params: Dict, patches: torch.Tensor,
                use_tdm: Optional[bool] = None) -> Output:
    """patches: [B, N, P²·3], fp32 throughout. Applies the TDM at
    ``cfg.pruning.tdm_layers`` when token pruning is enabled. Attention and
    the TDM run through the kernel wrappers, which pick by device alone
    (module docstring)."""
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
        if has_tdm:
            o, scores = FA.flash_attention(q, k, v, collect_scores=True)
        else:
            o = FA.flash_attention(q, k, v)
        x = x + L.linear(o.reshape(B, n, H * Dh), ap["wo"], ap.get("bo"))
        if has_tdm:
            x = TD.token_drop(x, scores, TP.num_kept_tokens(n, p.r_t) - 2)
        h = L.layer_norm(x, lp["ln2_s"], lp["ln2_b"], cfg.norm_eps)
        x = x + L.gelu_mlp(h, lp["mlp"])

    x = L.layer_norm(x, params["ln_f_s"], params["ln_f_b"], cfg.norm_eps)
    return Output(L.linear(x[:, 0], params["head"]).float())


# ===========================================================================
# The dense LM
# ===========================================================================
def unembed_matrix(params: Dict) -> torch.Tensor:
    w = params.get("unembed")
    return w if w is not None else params["embed"].T


def _save_matmuls(ctx, op, *args, **kwargs):
    """``dots`` policy: keep the outputs of the products without batch
    dimensions (the projections, ``aten.mm``), recompute the rest — the
    counterpart of JAX's ``dots_with_no_batch_dims_saveable``."""
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


_REMAT = {"full": {},
          "dots": {"context_fn": functools.partial(
              create_selective_checkpoint_contexts, _save_matmuls)}}


def _lm_layer(cfg: ModelConfig, x: torch.Tensor, lp: Dict, cache,
              valid_start) -> Tuple[torch.Tensor, Any]:
    """One pre-norm layer: attention then SwiGLU, each residual."""
    eps = cfg.norm_eps
    h, nc = A.attention_block(L.rms_norm(x, lp["ln1"], eps), lp["attn"], cfg,
                              cache=cache, valid_start=valid_start)
    x = x + h
    return x + L.glu_mlp(L.rms_norm(x, lp["ln2"], eps), lp["mlp"]), nc


def _moe_layer(cfg: ModelConfig, x: torch.Tensor, lp: Dict, cache,
               valid_start) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """One pre-norm MoE layer: attention then the MoE FFN, each residual
    (the reference's ``_moe_layer_fwd``). Left-pad tokens are masked out
    of attention only: they route and take expert capacity as the
    reference's do."""
    eps = cfg.norm_eps
    h, nc = A.attention_block(L.rms_norm(x, lp["ln1"], eps), lp["attn"], cfg,
                              cache=cache, valid_start=valid_start)
    x = x + h
    y, aux = MOE.moe_ffn(L.rms_norm(x, lp["ln2"], eps), lp["moe"], cfg)
    return x + y, nc, aux


def _cross_layer(cfg: ModelConfig, x: torch.Tensor, lp: Dict,
                 vis: torch.Tensor) -> torch.Tensor:
    """The VLM's gated cross-attention layer (the reference's
    ``_cross_layer_fwd``): k and v projected from the vision tokens ``vis``
    [B, Nv, Dv] without bias, attention with no mask and no RoPE, added as
    ``tanh(gate) * h``; then a SwiGLU MLP."""
    eps = cfg.norm_eps
    k, v = _cross_kv(cfg, vis, lp["attn"])
    h, _ = A.attention_block(L.rms_norm(x, lp["ln1"], eps), lp["attn"], cfg,
                             causal=False, use_rope=False, kv_override=(k, v))
    x = x + torch.tanh(lp["gate"]).to(x.dtype) * h
    return x + L.glu_mlp(L.rms_norm(x, lp["ln2"], eps), lp["mlp"])


def _vlm_stage(cfg: ModelConfig, x: torch.Tensor, self_layers: List[Dict],
               cross: Dict, vis: torch.Tensor, caches: List,
               valid_start) -> Tuple[torch.Tensor, List]:
    """One VLM stage (the reference's ``stage``): its self-attention
    layers, each with its cache (None in train mode), then its gated cross
    layer. Returns (x, the layers' new caches). Train mode checkpoints the
    whole stage, as the reference rematerializes it."""
    new = []
    for lp, cache in zip(self_layers, caches):
        x, nc = _lm_layer(cfg, x, lp, cache, valid_start)
        new.append(nc)
    return _cross_layer(cfg, x, cross, vis), new


def _cross_kv(cfg: ModelConfig, src: torch.Tensor,
              ap: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention keys and values [B, Nk, KV, Dh] projected from
    ``src`` [B, Nk, Dk] by ``wk`` and ``wv`` alone: the reference adds no
    ``bk``/``bv`` here, even where the params hold them."""
    B, Nk, _ = src.shape
    KV, Dh = cfg.num_kv_heads, cfg.head_dim
    return (L.linear(src, ap["wk"]).reshape(B, Nk, KV, Dh),
            L.linear(src, ap["wv"]).reshape(B, Nk, KV, Dh))


def _encoder_layer(cfg: ModelConfig, x: torch.Tensor,
                   lp: Dict) -> torch.Tensor:
    """One layer of Whisper's encoder: non-causal self-attention (RoPE
    applied, as in the reference) and a GELU MLP, each residual."""
    eps = cfg.norm_eps
    h, _ = A.attention_block(L.rms_norm(x, lp["ln1"], eps), lp["attn"], cfg,
                             causal=False)
    x = x + h
    return x + L.gelu_mlp(L.rms_norm(x, lp["ln2"], eps), lp["mlp"])


def _decoder_layer(cfg: ModelConfig, x: torch.Tensor, lp: Dict,
                   enc: torch.Tensor, cache,
                   valid_start) -> Tuple[torch.Tensor, Any]:
    """One layer of Whisper's decoder: causal self-attention, then
    cross-attention over the encoder's output ``enc`` (its k and v
    projected again on every call, as the reference does), then a GELU
    MLP, each residual."""
    eps = cfg.norm_eps
    h, nc = A.attention_block(L.rms_norm(x, lp["ln1"], eps), lp["attn"], cfg,
                              cache=cache, valid_start=valid_start)
    x = x + h
    k, v = _cross_kv(cfg, enc, lp["xattn"])
    h, _ = A.attention_block(L.rms_norm(x, lp["ln_x"], eps), lp["xattn"],
                             cfg, causal=False, use_rope=False,
                             kv_override=(k, v))
    x = x + h
    return x + L.gelu_mlp(L.rms_norm(x, lp["ln2"], eps), lp["mlp"]), nc


def encode_audio(cfg: ModelConfig, params: Dict,
                 audio_frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over ``audio_frames`` [B, F, D] (the stub
    frontend's output): plus ``enc_pos`` (tiled when F exceeds the table,
    as the reference does for longer stub inputs), the encoder layers, then
    ``enc_ln_f``. Returns [B, F, D] in the activation dtype."""
    adt = getattr(torch, cfg.dtype)
    pos_tab = params["enc_pos"]
    nf = audio_frames.shape[1]
    if nf > pos_tab.shape[0]:
        pos_tab = pos_tab.repeat(-(-nf // pos_tab.shape[0]), 1)
    enc = audio_frames.to(adt) + pos_tab[None, :nf].to(adt)
    for lp in params["enc_layers"]:
        enc = _encoder_layer(cfg, enc, lp)
    return L.rms_norm(enc, params["enc_ln_f"], cfg.norm_eps)


def forward_lm(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
               mode: str = "train", caches: Optional[List] = None,
               logits_for: str = "all",
               valid_start: Optional[torch.Tensor] = None,
               vision_embeds: Optional[torch.Tensor] = None,
               audio_frames: Optional[torch.Tensor] = None) -> Output:
    """LM forward (dense, MoE, VLM, audio, hybrid or SSM): ``tokens``
    [B, N] int.

    ``mode``: "train" (full sequence, no cache), "prefill" (full sequence
    into ``caches``) or "decode" (one token per row against ``caches``);
    ``caches`` is the list of ``steps.init_caches``: for the dense, MoE
    and audio families one ``KVCache`` per (decoder) layer, for the VLM one
    per self-attention layer in execution order, updated in place
    (``attention_block``); for the hybrid a ``MambaState`` per Mamba2
    layer and a ``KVCache`` per stage's shared block, in execution order;
    for the SSM one ``RWKVState`` per layer. Recurrent states are
    functional: ``Output.caches`` holds new ones. The hybrid and SSM
    families take no ``valid_start``; in train mode the hybrid runs
    without checkpoints, as the reference's does, the VLM checkpoints each
    stage (its self-attention layers and its cross layer together) and the
    audio family each decoder layer, not the encoder's. ``logits_for``: "all"
    gives [B, N, V] logits, "last" only the final position's
    ([B, 1, V]), "none" none (hidden states only). Logits are computed
    in the activation dtype (``cfg.dtype``) and returned in fp32.
    ``valid_start`` ([B] int32):
    per-row index of the first real token; earlier (left-padded)
    positions are masked out of every attention and of the KV
    ``attn_mass`` accumulation. In train mode with grad enabled, each layer
    runs under ``torch.utils.checkpoint`` by ``cfg.remat_policy``: "full"
    recomputes the layer in the backward, "dots" keeps its projections'
    outputs and recomputes the rest, "none" keeps everything.
    ``Output.aux_loss`` is the MoE load-balancing loss summed over layers
    (0.0 for the dense family), differentiable through each layer's router
    in train mode.

    The VLM takes ``vision_embeds`` [B, Nv, Dv] in every mode: each stage
    runs its self-attention layers, then its gated cross layer over them.
    The audio family takes ``audio_frames`` [B, F, D] in train and prefill
    mode (:func:`encode_audio`); prefill returns ``Output.caches`` as the
    pair ``(KV caches, encoder output)``, which decode takes as its
    ``caches`` in place of the frames (the reference's pair)."""
    fam = cfg.family
    moe = fam == "moe"
    if fam not in LM_FAMILIES:
        raise NotImplementedError(
            f"forward_lm runs the {', '.join(LM_FAMILIES)} families, not "
            f"{fam!r}")
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got "
                         f"{mode!r}")
    adt = getattr(torch, cfg.dtype)
    eps = cfg.norm_eps
    x = params["embed"][tokens].to(adt)
    want_cache = mode != "train"
    enc = None
    if fam == "audio":
        if mode == "decode" and isinstance(caches, tuple):
            caches, enc = caches  # the encoder's output, kept at prefill
        elif audio_frames is None:
            raise ValueError(f"the audio family takes audio_frames in "
                             f"mode {mode!r}, or in decode the "
                             f"(caches, encoder output) pair of prefill")
        else:
            enc = encode_audio(cfg, params, audio_frames)
    if fam == "vlm" and vision_embeds is None:
        raise ValueError("the VLM family takes vision_embeds in every mode")
    if want_cache and (caches is None or len(caches) != num_caches(cfg)):
        raise ValueError(f"mode {mode!r} needs the serve-cache list of "
                         f"models/steps.init_caches ({num_caches(cfg)} "
                         f"entries)")
    if fam in ("hybrid", "ssm"):
        if valid_start is not None:
            raise ValueError(
                f"family {fam!r} takes no valid_start: recurrent state "
                f"cannot mask pad tokens it has absorbed, so it is served "
                f"unpadded")
        x, new_caches = _forward_recurrent(cfg, params, x,
                                           caches if want_cache else None,
                                           _remat_run(cfg, mode))
        return _lm_head(cfg, params, x, new_caches, logits_for, 0.0)
    new_caches = [] if want_cache else None
    run = _remat_run(cfg, mode)
    cache_it = iter(caches) if want_cache else None

    def next_cache():
        return next(cache_it) if want_cache else None
    if fam == "vlm":
        vis = vision_embeds.to(adt)
        st = params["stages"]
        for self_layers, cross in zip(st["self"], st["cross"]):
            x, ncs = run(_vlm_stage, x, self_layers, cross, vis,
                         [next_cache() for _ in self_layers], valid_start)
            if want_cache:
                new_caches.extend(ncs)
        return _lm_head(cfg, params, x, new_caches, logits_for, 0.0)
    if fam == "audio":
        for lp in params["layers"]:
            x, nc = run(_decoder_layer, x, lp, enc, next_cache(),
                        valid_start)
            if want_cache:
                new_caches.append(nc)
        return _lm_head(cfg, params, x,
                        (new_caches, enc) if want_cache else None,
                        logits_for, 0.0)
    aux_total = 0.0
    layer = _moe_layer if moe else _lm_layer
    for lp in params["layers"]:
        out = run(layer, x, lp, next_cache(), valid_start)
        x = out[0]
        if moe:
            aux_total = aux_total + out[2]
        if want_cache:
            new_caches.append(out[1])
    return _lm_head(cfg, params, x, new_caches, logits_for, aux_total)


def _remat_run(cfg: ModelConfig, mode: str):
    """``run(fn, *args)``: ``fn(cfg, *args)``, under
    ``torch.utils.checkpoint`` by ``cfg.remat_policy`` in train mode with
    grad enabled (the reference's ``_remat``)."""
    policy = cfg.remat_policy
    if policy not in ("full", "dots", "none"):
        raise ValueError(f"remat_policy must be full, dots or none, got "
                         f"{policy!r}")
    ckpt = (mode == "train" and policy != "none"
            and torch.is_grad_enabled())

    def run(fn, *args):
        if ckpt:
            return checkpoint(fn, cfg, *args, use_reentrant=False,
                              **_REMAT[policy])
        return fn(cfg, *args)
    return run


def _lm_head(cfg: ModelConfig, params: Dict, x: torch.Tensor, caches,
             logits_for: str, aux_total) -> Output:
    """Final RMSNorm, then the unembedding in the activation dtype."""
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    if logits_for == "none":
        return Output(None, caches, hidden=x, aux_loss=aux_total)
    w_un = unembed_matrix(params).to(x.dtype)
    # The final position's logits come from one product whatever
    # ``logits_for`` asks, so "last" is bitwise the last row of "all": a
    # BLAS may round a row differently with the row count of the product.
    last = (x[:, -1] @ w_un)[:, None]
    if logits_for == "last" or x.shape[1] == 1:
        logits = last
    else:
        logits = torch.cat([x[:, :-1] @ w_un, last], dim=1)
    return Output(logits.float(), caches, hidden=x, aux_loss=aux_total)


def _rwkv_layer(cfg: ModelConfig, x: torch.Tensor,
                lp: Dict) -> torch.Tensor:
    """One RWKV6 block from zero state (train mode), its output alone."""
    return SSM.rwkv_block(x, lp, cfg)[0]


def _forward_recurrent(cfg: ModelConfig, params: Dict, x: torch.Tensor,
                       caches: Optional[List], run) -> Tuple[torch.Tensor,
                                                             Optional[List]]:
    """The hybrid and SSM families' layers (the reference's
    ``_forward_hybrid`` and ``ssm`` branch). ``caches``: the flat list of
    ``steps.init_caches`` in execution order, or None (train mode: every
    state starts at zero, the shared block runs without a cache). Hybrid:
    per stage, its Mamba2 layers (residual, behind an RMSNorm), then the
    shared attention block with that stage's own ``KVCache``; then the
    tail's Mamba2 layers, never checkpointed, as in the reference. SSM: the
    RWKV6 blocks, in train mode each through ``run`` (checkpointed by
    ``cfg.remat_policy``, as the reference's ``ssm`` branch). Returns (x,
    the new states and caches in the same order, or None)."""
    it = iter(caches) if caches is not None else None
    new: Optional[List] = [] if caches is not None else None

    def state():
        return next(it) if it is not None else None

    def keep(c):
        if new is not None:
            new.append(c)

    eps = cfg.norm_eps
    if cfg.family == "ssm":
        for lp in params["layers"]:
            if it is None:
                x = run(_rwkv_layer, x, lp)
                continue
            x, st = SSM.rwkv_block(x, lp, cfg, state())
            keep(st)
        return x, new

    def mamba(x, lp):
        y, st = SSM.mamba_block(L.rms_norm(x, lp["ln"], eps), lp["mamba"],
                                cfg, state())
        keep(st)
        return x + y
    for stage in params["stages"]:
        for lp in stage:
            x = mamba(x, lp)
        x, nc = _lm_layer(cfg, x, params["shared_attn"], state(), None)
        keep(nc)
    for lp in params.get("tail", ()):
        x = mamba(x, lp)
    return x, new


# ===========================================================================
# Losses
# ===========================================================================
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 ignore: int = -1) -> torch.Tensor:
    """Mean token-level cross entropy; ``labels == ignore`` masked out."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels != ignore
    safe = torch.where(valid, labels, 0).long()
    ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    return -(ll * valid).sum() / valid.sum().clamp(min=1)


def _xent_chunk(h: torch.Tensor, w_un: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    """Σ log p(label) over one chunk's valid positions: unembed in h's
    dtype, log-softmax in fp32."""
    logits = (h @ w_un.to(h.dtype)).float()
    logp = torch.log_softmax(logits, dim=-1)
    valid = labels != -1
    safe = torch.where(valid, labels, 0).long()
    ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    return (ll * valid).sum()


def chunked_lm_xent(cfg: ModelConfig, params: Dict, hidden: torch.Tensor,
                    labels: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """Next-token CE without materializing [B, S, V] logits: the sequence in
    chunks, unembed + log-softmax + gather per chunk, each chunk under
    ``torch.utils.checkpoint`` (with grad enabled), so the backward
    recomputes its logits and the peak is one chunk's [B, chunk, V] fp32.
    Labels of -1 are masked out; a sequence that ``chunk`` does not divide
    is padded with such labels (the reference's ``chunked_lm_xent``)."""
    B, S, D = hidden.shape
    w_un = unembed_matrix(params)
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        hidden = torch.cat([hidden, hidden.new_zeros((B, pad, D))], dim=1)
        labels = torch.cat([labels, labels.new_full((B, pad), -1)], dim=1)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S + pad, chunk):
        h, lab = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            part = checkpoint(_xent_chunk, h, w_un, lab, use_reentrant=False)
        else:
            part = _xent_chunk(h, w_un, lab)
        tot = tot - part
    cnt = (labels != -1).sum()
    return tot / cnt.clamp(min=1)


def lm_loss(cfg: ModelConfig, params: Dict,
            batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """The LM's training loss on ``batch["tokens"]`` [B, S]: next-token CE
    (labels shifted left, -1 at the last position) by
    :func:`chunked_lm_xent` over ``forward_lm``'s final-norm hidden states,
    plus 0.01 x ``Output.aux_loss`` (0 for the dense family). Returns
    ``(total, {"ce", "aux"})``."""
    tokens = batch["tokens"]
    out = forward_lm(cfg, params, tokens, mode="train", logits_for="none",
                     vision_embeds=batch.get("vision_embeds"),
                     audio_frames=batch.get("audio_frames"))
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)],
                       dim=1)
    loss = chunked_lm_xent(cfg, params, out.hidden, labels,
                           chunk=cfg.loss_chunk)
    aux = torch.as_tensor(out.aux_loss, dtype=torch.float32,
                          device=loss.device)
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}
