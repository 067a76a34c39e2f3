"""Simultaneous Fine-Pruning (paper Algorithm 1) — the port of the
reference package's ``core/simultaneous.py``.

Trains a student ViT with BOTH prunings active:
  * static block weight pruning — masks recomputed from scores every step
    through the straight-through estimator, keep rate ``r_b(t)`` driven
    by the cubic scheduler;
  * dynamic token pruning — the TDM active in the student's forward at
    ``cfg.pruning.tdm_layers``;
and recovers accuracy by knowledge distillation from an unpruned teacher:

  L_net = λ_distill · T²·KL(p_t(T) || p_s(T)) + λ_task · (CE + λ‖σ(S)‖)

The forward is :func:`~repro_torch.models.model.forward_vit`,
differentiated by autograd: on the card its attention and TDM run on the
kernels in both directions (``flash_attention_f32`` with
``flash_attention_bwd_f32``, ``token_drop_f32`` with
``token_drop_bwd_f32``) and its matmuls on cuBLAS; on the CPU they are the
plain versions. Gradients come from ``torch.autograd.grad`` over the
params and scores, then the AdamW update, all on the state's device.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.schedule import cubic_keep_rate
from repro_torch.models import model as M
from repro_torch.models import pruning_glue as PG
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.tree import leaves, tree_map, unflatten


def distillation_loss(student_logits: torch.Tensor,
                      teacher_logits: torch.Tensor,
                      temperature: float) -> torch.Tensor:
    """Eq. 9: T² · KL(p_teacher(T) || p_student(T))."""
    T = temperature
    pt = torch.softmax(teacher_logits / T, dim=-1)
    log_ps = torch.log_softmax(student_logits / T, dim=-1)
    log_pt = torch.log_softmax(teacher_logits / T, dim=-1)
    kl = (pt * (log_pt - log_ps)).sum(dim=-1).mean()
    return T * T * kl


class PruneTrainState(NamedTuple):
    params: Any
    scores: Any
    opt_state: AdamWState
    step: torch.Tensor  # 0-d int32


def init_state(cfg: ModelConfig, generator: torch.Generator,
               optimizer: Optional[AdamW] = None,
               device: "str | torch.device" = "cuda"
               ) -> Tuple[PruneTrainState, AdamW]:
    """Student params, then its scores, drawn from ``generator``; the
    optimizer's zero state; all on ``device`` (the card unless the CPU is
    asked for)."""
    opt = optimizer or AdamW(lr=2e-5, weight_decay=0.01)  # paper §VI
    params = M.init_params(cfg, generator, device=device)
    scores = PG.init_scores(cfg, params, generator)
    tr = {"params": params, "scores": scores}
    step = torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)
    return PruneTrainState(params, scores, opt.init(tr), step), opt


def student_params(cfg: ModelConfig, params, scores, r_b: torch.Tensor):
    """The student's weights at scheduled keep rate ``r_b``: the masks keep
    the FINAL rate's block count (a static keep count), and the schedule
    moves the student from the dense to the masked weights by
    interpolation (the reference's rule), ``(1-blend)·dense +
    blend·masked`` over every leaf, ``blend`` 0 at r_b = 1 and 1 at the
    final rate. Differentiable in ``params`` and, through the STE, in
    ``scores``."""
    p = cfg.pruning
    masked = PG.apply_pruning(cfg, params, scores, r_b=p.r_b)
    blend = (1.0 - r_b) / max(1.0 - p.r_b, 1e-6)  # 0 dense, 1 pruned
    return tree_map(lambda d, m: (1 - blend) * d + blend * m, params, masked)


def make_simultaneous_step(cfg: ModelConfig, teacher_cfg: ModelConfig,
                           opt: AdamW, total_steps: int,
                           warmup_frac: float = 0.1,
                           cooldown_frac: float = 0.1):
    """Algorithm 1, one optimization step:
    ``step_fn(state, teacher_params, batch) -> (new_state, metrics)``.

    ``teacher_params`` is the frozen unpruned teacher (ViT-Base in the
    paper; any same-task model works), run without gradients and without
    the TDM. The student's r_b follows the cubic schedule; r_t is constant
    (the TDM has no parameters). ``batch`` holds "patches" [B, N, P²·3]
    fp32 and "labels" [B] on the state's device. ``metrics`` are 0-d
    tensors on that device (read them when needed: reading one waits for
    the step)."""
    p = cfg.pruning
    warm = int(total_steps * warmup_frac)
    cool = int(total_steps * cooldown_frac)

    def loss_fn(trainables, teacher_params, batch, step):
        params, scores = trainables["params"], trainables["scores"]
        r_b = cubic_keep_rate(step, total_steps, p.r_b, warm, cool)
        s_out = M.forward_vit(cfg, student_params(cfg, params, scores, r_b),
                              batch["patches"])
        with torch.no_grad():
            t_logits = M.forward_vit(teacher_cfg, teacher_params,
                                     batch["patches"], use_tdm=False).logits

        ce = M.softmax_xent(s_out.logits, batch["labels"])
        reg = PG.regularizer(scores)
        distill = distillation_loss(s_out.logits, t_logits,
                                    p.distill_temperature)
        task = ce + p.lambda_reg * reg
        total = p.lambda_distill * distill + p.lambda_task * task
        return total, {"ce": ce, "distill": distill, "reg": reg, "r_b": r_b}

    def step_fn(state: PruneTrainState, teacher_params, batch
                ) -> Tuple[PruneTrainState, Dict[str, torch.Tensor]]:
        trainables = {"params": state.params, "scores": state.scores}
        flat = [t.detach().requires_grad_(True) for t in leaves(trainables)]
        loss, parts = loss_fn(unflatten(trainables, flat), teacher_params,
                              batch, state.step)
        grads = torch.autograd.grad(loss, flat)
        new_tr, new_opt = opt.update(unflatten(trainables, list(grads)),
                                     state.opt_state, trainables)
        new_state = PruneTrainState(new_tr["params"], new_tr["scores"],
                                    new_opt, state.step + 1)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in parts.items()}}
        return new_state, metrics

    return step_fn
