"""Step functions — the reference package's ``models/steps.py`` for the
families this package runs: the ViT's training step, every LM family's
training step (with the paper's block pruning trained jointly, per expert
in an MoE layer's banks, and gradient accumulation over microbatches;
the VLM and audio families take their modality input from the batch), and
the serve steps of the dense, MoE, VLM, audio, hybrid
and SSM LMs: cache constructors, whole-batch prefill, per-slot prefill (a
B=1 prefill scattered into one row of the live batched cache; dense and
MoE) and the decode step.

The reference jits these; PyTorch runs them eagerly, so they are plain
functions. Caches are a flat list (:func:`init_caches`); every step
updates the ``KVCache``s it is given in place, replaces the recurrent
states with new ones, and returns the list. The audio family's prefill
returns the pair ``(list, encoder output)``, which its decode steps take
and return (the reference's pair).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import pruning_glue as PG
from repro_torch.models import ssm as SSM
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import (flatten_with_path, leaves, path_str, tree_map,
                              unflatten)

# Families whose serve state is pure KV cache — left-padding can be masked
# exactly via valid_start (the reference's list). Recurrent state (ssm,
# hybrid) cannot mask pad tokens it has absorbed: those families are served
# through the whole-batch path, unmasked, as in the reference.
MASKABLE_FAMILIES = ("dense", "moe", "vlm", "audio")

# Families whose serve state is purely per-layer KV caches — a single slot
# can be prefilled in isolation and scattered into the live batch.
SLOT_PREFILL_FAMILIES = ("dense", "moe")

# LM families this package serves and trains (besides the ViT): all that
# ``forward_lm`` runs
SERVE_FAMILIES = M.LM_FAMILIES
TRAIN_FAMILIES = M.LM_FAMILIES


def _require_served(cfg: ModelConfig) -> None:
    if cfg.family not in SERVE_FAMILIES:
        raise NotImplementedError(
            f"no serve steps for family {cfg.family!r}; this package serves "
            f"{SERVE_FAMILIES}")


def _require_trained(cfg: ModelConfig) -> None:
    if cfg.family not in TRAIN_FAMILIES:
        raise NotImplementedError(
            f"no LM training step for family {cfg.family!r}; this package "
            f"trains the {', '.join(TRAIN_FAMILIES)} LMs")


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device="cuda") -> List:
    """Zeroed serve caches for ``cfg`` on ``device`` (the card unless the
    CPU is asked for), as one flat list in execution order: dense and MoE,
    one ``KVCache`` per layer; VLM, one per self-attention layer, stage by
    stage (``n_self`` each; the cross layers keep no cache); audio, one
    per decoder layer (the encoder's output joins them at prefill); hybrid,
    per stage its Mamba2 layers' ``MambaState``s and then its shared
    block's ``KVCache``, then the tail's ``MambaState``s; SSM, one
    ``RWKVState`` per layer. Recurrent
    states hold their carried activations (conv buffer, token shifts) in
    ``dtype`` and their recurrences in fp32, as the reference's."""
    _require_served(cfg)
    device = resolve_device(device)
    kv = lambda: A.init_kv_cache(batch, max_len, cfg.num_kv_heads,
                                 cfg.head_dim, dtype, device)
    if cfg.family == "ssm":
        return [SSM.init_rwkv_state(batch, cfg, dtype, device)
                for _ in range(cfg.num_layers)]
    if cfg.family == "hybrid":
        period, n_stages, rem = M.hybrid_layout(cfg)
        mamba = lambda: SSM.init_mamba_state(batch, cfg, dtype, device)
        out: List = []
        for _ in range(n_stages):
            out += [mamba() for _ in range(period)] + [kv()]
        return out + [mamba() for _ in range(rem)]
    return [kv() for _ in range(M.num_caches(cfg))]


def make_prefill(cfg: ModelConfig):
    """``prefill(params, batch, caches) -> (next_token [B], caches)``;
    ``batch`` may carry "valid_start" ([B] int32): first real token per
    row — left-padded prompt positions are masked out of self-attention
    (not of cross-attention, as in the reference) — and carries the
    modality input of the VLM ("vision_embeds") or the audio family
    ("audio_frames"). The audio family's ``caches`` come back as the pair
    ``(caches, encoder output)``."""
    _require_served(cfg)

    def prefill(params, batch, caches):
        out = M.forward_lm(cfg, params, batch["tokens"], mode="prefill",
                           caches=caches, logits_for="last",
                           valid_start=batch.get("valid_start"),
                           vision_embeds=batch.get("vision_embeds"),
                           audio_frames=batch.get("audio_frames"))
        return torch.argmax(out.logits[:, -1], dim=-1), out.caches
    return prefill


def _blank_row_caches(caches: List[A.KVCache]) -> List[A.KVCache]:
    """A zeroed B=1 copy of the serve caches (KVCache entries only)."""
    def one(c):
        if not isinstance(c, A.KVCache):
            raise TypeError(
                "per-slot prefill needs a pure KV-cache list; got "
                f"{type(c).__name__} (recurrent/encoder state — use the "
                "whole-batch prefill path)")
        return A.KVCache(*(torch.zeros((1,) + t.shape[1:], dtype=t.dtype,
                                       device=t.device) for t in c))
    return [one(c) for c in caches]


def _scatter_row_caches(live: List[A.KVCache], row: List[A.KVCache],
                        slot: int) -> List[A.KVCache]:
    """Write the B=1 caches ``row`` into batch row ``slot`` of ``live``, in
    place, and return ``live``."""
    for dst, src in zip(live, row):
        for d, s in zip(dst, src):
            d[slot] = s[0].to(d.dtype)
    return live


def make_prefill_slot(cfg: ModelConfig):
    """Prefill ONE admitted prompt into one slot of the live batched cache.

    Returns ``prefill_slot(params, batch, caches, slot) -> (next_token [1],
    caches)``: ``batch["tokens"]`` is a single (bucket-padded) prompt row
    ``[1, Lb]`` with ``batch["valid_start"]`` ``[1]`` marking its left
    padding. The prompt runs through a B=1 prefill against a blank cache
    row, which is then written into batch row ``slot`` of ``caches`` —
    admission costs one prompt's FLOPs instead of a whole-batch
    re-prefill."""
    if cfg.family not in SLOT_PREFILL_FAMILIES:
        raise ValueError(
            f"per-slot prefill unsupported for family '{cfg.family}' "
            f"(supported: {SLOT_PREFILL_FAMILIES}); serve this family "
            "through the whole-batch prefill path")

    def prefill_slot(params, batch, caches, slot: int):
        row = _blank_row_caches(caches)
        out = M.forward_lm(cfg, params, batch["tokens"], mode="prefill",
                           caches=row, logits_for="last",
                           valid_start=batch.get("valid_start"))
        next_tok = torch.argmax(out.logits[:, -1], dim=-1)  # [1]
        return next_tok, _scatter_row_caches(caches, out.caches, slot)
    return prefill_slot


def make_decode_step(cfg: ModelConfig):
    """One token in, one token out, caches updated in place:
    ``decode(params, token [B, 1], caches, vision_embeds=None,
    valid_start=None) -> (next_token [B], caches)``. The VLM takes its
    ``vision_embeds`` at every step; the audio family takes prefill's
    ``(caches, encoder output)`` pair as ``caches``."""
    _require_served(cfg)

    def decode(params, token, caches, vision_embeds=None, valid_start=None):
        out = M.forward_lm(cfg, params, token, mode="decode", caches=caches,
                           valid_start=valid_start,
                           vision_embeds=vision_embeds)
        return torch.argmax(out.logits[:, -1], dim=-1), out.caches
    return decode


# families with cross layers, whose params hold leaves the reference's
# loss never reaches: the cross layers' ``bk`` / ``bv`` (the VLM's
# ``stages/cross/<i>/attn``, Whisper's ``layers/<i>/xattn``), which
# ``model._cross_kv`` leaves out as the reference does
CROSS_FAMILIES = ("vlm", "audio")


def _zero_unused(trainables, flat: List[torch.Tensor],
                 grads: List[Optional[torch.Tensor]]) -> List[torch.Tensor]:
    """``grads`` with a zero in place of each cross layer's ``bk`` / ``bv``
    gradient that autograd left out (jax.grad's zero); any other leaf the
    loss does not reach raises."""
    out = []
    for (path, _), t, d in zip(flatten_with_path(trainables), flat, grads):
        if d is None:
            keys = path_str(path).split("/")
            if keys[-1] not in ("bk", "bv") or not (
                    "xattn" in keys or "cross" in keys):
                raise RuntimeError(f"the loss does not reach the leaf "
                                   f"{path_str(path)}")
            d = torch.zeros_like(t)
        out.append(d)
    return out


def make_grad_fn(cfg: ModelConfig, with_pruning: Optional[bool] = None):
    """Returns ``grads(params, batch, scores=None) -> (loss, parts,
    grads)``: the gradient of the LM's training loss (any LM family; the
    MoE's includes 0.01 x the aux through its routers; the VLM's and the
    audio family's ``batch`` carries "vision_embeds" / "audio_frames"
    beside "tokens"), the half of
    :func:`make_train_step` before the optimizer. ``grads`` has the
    trainables' structure: ``{"params", "scores"}`` when ``scores`` are
    given (the paper's simultaneous pruning: the STE through
    ``pruning_glue.apply_pruning``, plus ``lambda_reg`` x the sparsity
    regularizer), else the params alone. With ``cfg.microbatches`` M > 1
    the batch splits along dim 0 into M pieces and the gradients, the loss
    and its parts are averaged over them (the reference's scan: g_acc +
    g / M from zeros)."""
    _require_trained(cfg)
    p = cfg.pruning
    use_prune = (p.weight_pruning_enabled if with_pruning is None
                 else with_pruning)
    cross_families = cfg.family in CROSS_FAMILIES

    def one(trainables, batch):
        flat = [t.detach().requires_grad_(True) for t in leaves(trainables)]
        tr = unflatten(trainables, flat)
        wrapped = isinstance(tr, dict) and "scores" in tr
        params = tr["params"] if wrapped else tr
        scores = tr["scores"] if wrapped else None
        if use_prune and scores:
            params = PG.apply_pruning(cfg, params, scores)
        total, parts = M.lm_loss(cfg, params, batch)
        if use_prune and scores:
            total = total + p.lambda_reg * PG.regularizer(scores)
        grads = list(torch.autograd.grad(total, flat,
                                         allow_unused=cross_families))
        if cross_families:
            grads = _zero_unused(trainables, flat, grads)
        return (total.detach(), {k: v.detach() for k, v in parts.items()},
                unflatten(trainables, grads))

    def grads(params, batch, scores=None):
        trainables = ({"params": params, "scores": scores} if scores
                      else params)
        n = cfg.microbatches
        if n <= 1:
            return one(trainables, batch)
        micro = {k: v.chunk(n) for k, v in batch.items()}
        if any(len(c) != n or c[0].shape[0] * n != v.shape[0]
               for c, v in zip(micro.values(), batch.values())):
            raise ValueError(f"microbatches={n} must divide the batch "
                             f"{[tuple(v.shape) for v in batch.values()]}")
        g_acc = tree_map(torch.zeros_like, trainables)
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=leaves(trainables)[0].device)
        parts_all: Dict[str, list] = {}
        for m in range(n):
            loss, parts, g = one(trainables,
                                 {k: v[m] for k, v in micro.items()})
            g_acc = tree_map(lambda a, b: a + b / n, g_acc, g)
            loss_acc = loss_acc + loss / n
            for k, v in parts.items():
                parts_all.setdefault(k, []).append(v)
        return (loss_acc, {k: torch.stack(v).mean()
                           for k, v in parts_all.items()}, g_acc)
    return grads


# the reference's trees that stack their layers on leading axes: the
# layers of the dense, MoE and SSM families, the hybrid's stages and tail
_STACKED = frozenset(("layers", "stages", "tail"))


def stacked_decay(trainables) -> List[bool]:
    """AdamW's weight-decay rule (``ndim >= 2``) as the reference applies it
    to the LM, whose layers are stacked on a leading axis: every leaf of a
    layer is decayed (norm scales, MLP score vectors, the MoE router,
    expert banks and their score vectors, the Mamba2 and RWKV6 layers'
    vectors too), other leaves (the hybrid's shared block among them) by
    their own ``ndim``. In flatten order."""
    return [leaf.ndim >= 2
            or not _STACKED.isdisjoint(path_str(path).split("/"))
            for path, leaf in flatten_with_path(trainables)]


def make_train_step(cfg: ModelConfig, optimizer: Optional[AdamW] = None,
                    with_pruning: Optional[bool] = None):
    """Returns ``step(params, opt_state, batch, scores=None) -> (params,
    scores, opt_state, metrics)``, the reference's signature: the gradient
    of :func:`make_grad_fn`, then the AdamW update over ``{"params",
    "scores"}`` (the paper's weights and scores trained jointly) or over
    the params alone, in place (``AdamW.update_``, the reference's donated
    buffers): the params, scores and moments passed in are the ones
    returned, updated. ``opt_state`` must be ``optimizer.init`` of the same
    trainables; ``batch["tokens"]`` [B, S] on the params' device;
    ``metrics`` ``{"loss", "ce", "aux"}`` as 0-d tensors. Weight decay
    follows the reference's stacked layout (:func:`stacked_decay`). The
    forward is
    ``forward_lm`` in train mode: on the card, attention runs the causal
    kernel pair (``flash_prefill_bf16`` writing the log-sum-exp, and
    ``flash_prefill_bwd_bf16``) and, for cross-attention and Whisper's
    encoder, the non-causal pair (the same entry points with ``causal``
    0), the scans their kernels and backward kernels (``mamba_scan_f32`` /
    ``mamba_scan_bwd_f32``, ``wkv6_f32`` / ``wkv6_bwd_f32``), and the
    layers are checkpointed by ``cfg.remat_policy`` (the hybrid's and
    Whisper's encoder's are not, the VLM's by stage, as in the
    reference)."""
    opt = optimizer or AdamW()
    grad_fn = make_grad_fn(cfg, with_pruning)

    def step(params, opt_state, batch, scores=None):
        trainables = ({"params": params, "scores": scores} if scores
                      else params)
        loss, parts, grads = grad_fn(params, batch, scores)
        new_tr, new_opt = opt.update_(grads, opt_state, trainables,
                                      decay=stacked_decay(trainables))
        metrics = {"loss": loss, **parts}
        if scores:
            return new_tr["params"], new_tr["scores"], new_opt, metrics
        return new_tr, None, new_opt, metrics
    return step


def make_vit_train_step(cfg: ModelConfig, optimizer: Optional[AdamW] = None):
    """ViT classification training (no distillation; ``core/simultaneous``
    has the paper's Algorithm 1). Returns ``step(params, opt_state, batch)
    -> (params, opt_state, {"loss"})`` over tensors on one device; the
    forward is :func:`~repro_torch.models.model.forward_vit`,
    differentiated by autograd (on the card its attention and TDM run on
    the kernels and their backward kernels)."""
    opt = optimizer or AdamW(lr=1e-3)

    def step(params, opt_state, batch):
        flat = [t.detach().requires_grad_(True) for t in leaves(params)]
        tr = unflatten(params, flat)
        out = M.forward_vit(cfg, tr, batch["patches"])
        loss = M.softmax_xent(out.logits, batch["labels"])
        grads = torch.autograd.grad(loss, flat)
        params, opt_state = opt.update(unflatten(params, list(grads)),
                                       opt_state, params)
        return params, opt_state, {"loss": loss.detach()}
    return step
