"""Training launcher: configs, synthetic data, the training step, and
(with ``--ckpt``) the fault-tolerant loop and checkpointing — the port of
the reference package's ``launch/train.py`` for the ViT and every LM
family (``dense``, ``moe``, ``vlm``, ``audio``, ``hybrid``, ``ssm``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch deit-small \
        [--full] [--steps 50] [--batch 8] [--lr 1e-3] [--ckpt DIR] \
        [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        [--full] [--seq 128] [--prune] [--ckpt DIR] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch granite-moe-3b-a800m [--full] [--seq 512] [--prune] ...
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \
        [--full] [--seq 512] [--prune] ...      # or rwkv6-1.6b
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base \
        [--full] [--seq 512] ...
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch llama-3.2-vision-90b [--full] ...

The reduced config is the default; ``--full`` trains the architecture at
full width and depth, except where its fp32 training state does not fit
one card: there ``CARD_CUTS`` cuts the depth (Llama-3.2-Vision-90B to
2 layers, one self-attention and one gated cross layer), and says so.
``--device`` picks the card (``cuda``, the default) or the CPU. Weights are random, drawn from seed 0 with a
``torch.Generator`` (the LM's on the device, so full-width weights are
made there), scores from seed 7 on the CPU; batches are
``data.synthetic_vit_batch`` / ``synthetic_lm_batch`` by step (the VLM's
with its vision embeddings, the audio family's with its audio frames and
seq / 8 decoder tokens, as the reference's pipeline shapes them), so a run
restarted from ``--ckpt`` resumes exactly (the checkpoint holds params,
scores and the optimizer's state). The ViT's step is
``models/steps.make_vit_train_step`` (classification, AdamW; the paper's
Algorithm 1 is ``core/simultaneous``); the LM's is
``models/steps.make_train_step`` (next-token CE plus the MoE's 0.01 x aux,
AdamW in place; with ``--prune`` the paper's block pruning at block 16,
r_b 0.5, per expert in an MoE layer's banks, trained jointly through the
STE, as the reference's ``--prune``: the hybrid's shared attention block
and its MLP, RWKV6's channel-mix ``cm_wk`` / ``cm_wv``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import (DataConfig, synthetic_lm_batch,
                              synthetic_vit_batch)
from repro_torch.dist.fault import FaultConfig, RestartableLoop
from repro_torch.kernels.backend import host_to_device, resolve_device
from repro_torch.models import model as M
from repro_torch.models import pruning_glue as PG
from repro_torch.models import steps as ST
from repro_torch.optim import AdamW


def make_state_factory(cfg, opt, device: torch.device, seed: int = 0,
                       with_scores: bool = False):
    """``make_state() -> {"params", "scores", "opt", "step"}``: params from
    a ``torch.Generator`` seeded ``seed`` (the ViT's drawn on the CPU, the
    LM's on ``device``), scores (``with_scores``) from one seeded ``seed +
    7`` on the CPU, and the optimizer's zero state over both."""
    def make_state():
        gen = torch.Generator("cpu" if cfg.family == "vit" else device)
        params = M.init_params(cfg, gen.manual_seed(seed), device=device)
        scores = (PG.init_scores(cfg, params,
                                 torch.Generator().manual_seed(seed + 7))
                  if with_scores else None)
        tr = {"params": params, "scores": scores} if with_scores else params
        return {"params": params, "scores": scores, "opt": opt.init(tr),
                "step": 0}
    return make_state


# full-width configs whose fp32 training state (params, gradients and two
# moments, 16 B a parameter) does not fit one 80 GB card at full depth:
# the depth ``--full`` trains. Llama-3.2-Vision-90B: one stage of its
# period 5 and the embeddings are 6.38 B params (~102 GB); 2 layers of the
# reference's reduced period 2 (one self-attention and one gated cross
# layer) are 3.81 B (~61 GB).
CARD_CUTS = {"llama-3.2-vision-90b": dict(num_layers=2, cross_attn_period=2)}


def train_config(arch: str, reduced: bool = True):
    """The config ``train`` runs for ``arch``: reduced, or at full width
    and depth but for the cut ``CARD_CUTS`` gives it."""
    cfg = get_config(arch)
    if reduced:
        return cfg.reduced()
    return cfg.replace(**CARD_CUTS.get(cfg.name, {}))


def prune_config(cfg):
    """``--prune``: the paper's block weight pruning at block 16, r_b 0.5
    (no token pruning, r_t 1.0), the config's own ``lambda_reg``."""
    pr = cfg.pruning
    return cfg.replace(pruning=type(pr)(block_size=16, r_b=0.5, r_t=1.0,
                                        lambda_reg=pr.lambda_reg))


def train(arch: str, steps: int = 50, batch: int = 8, seq: int = 128,
          lr: float = 1e-3, ckpt_dir: str | None = None, reduced: bool = True,
          checkpoint_every: int = 20, prune: bool = False,
          log_every: int = 10, seed: int = 0,
          device: "str | torch.device" = "cuda"):
    cfg = train_config(arch, reduced)
    if not reduced and cfg.name in CARD_CUTS:
        print(f"{cfg.name}: full width, depth cut to one card's fp32 "
              f"training state: {CARD_CUTS[cfg.name]}")
    dev = resolve_device(device)
    opt = AdamW(lr=lr)
    dc = DataConfig(seed=seed)
    lm = cfg.family in ST.TRAIN_FAMILIES
    if lm and prune:
        cfg = prune_config(cfg)

    if lm:
        shape = ShapeConfig("custom", seq_len=seq, global_batch=batch,
                            kind="train")
        lstep = ST.make_train_step(cfg, opt, with_pruning=prune)

        def step_wrap(state, batch_np):
            b = {k: host_to_device(a, dev, dtype=a.dtype)
                 for k, a in batch_np.items()}
            params, scores, opt_state, metrics = lstep(
                state["params"], state["opt"], b, state["scores"])
            return ({"params": params, "scores": scores, "opt": opt_state,
                     "step": state["step"] + 1}, metrics)

        def data_fn(step):
            return synthetic_lm_batch(cfg, shape, dc, step,
                                      local_batch=batch)
    else:
        vstep = ST.make_vit_train_step(cfg, opt)

        def step_wrap(state, batch_np):
            b = {"patches": host_to_device(batch_np["patches"], dev),
                 "labels": host_to_device(batch_np["labels"], dev,
                                          dtype=batch_np["labels"].dtype)}
            params, opt_state, metrics = vstep(state["params"], state["opt"],
                                               b)
            return ({"params": params, "scores": None, "opt": opt_state,
                     "step": state["step"] + 1}, metrics)

        def data_fn(step):
            return synthetic_vit_batch(cfg, batch, dc, step)

    make_state = make_state_factory(cfg, opt, dev, seed,
                                    with_scores=lm and prune)
    if ckpt_dir:
        loop = RestartableLoop(
            CheckpointManager(ckpt_dir, keep=2),
            FaultConfig(checkpoint_every=checkpoint_every),
            make_state=make_state, step_fn=step_wrap, data_fn=data_fn,
            state_to_tree=lambda s: {"params": s["params"],
                                     "scores": s["scores"], "opt": s["opt"]},
            tree_to_state=lambda t, s: {**s, **t})
        return loop.run(steps)

    losses = []
    state = make_state()
    t0 = time.time()
    for i in range(steps):
        state, metrics = step_wrap(state, data_fn(i))
        losses.append(float(metrics["loss"]))
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)")
    return {"losses": losses, "state": state}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128,
                    help="sequence length (the LMs)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--prune", action="store_true",
                    help="the paper's block weight pruning (the LMs)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = train(args.arch, args.steps, args.batch, args.seq, args.lr,
                args.ckpt, args.reduced, prune=args.prune,
                device=args.device)
    if out["losses"]:
        print(f"final loss: {out['losses'][-1]:.4f}")
    return out


if __name__ == "__main__":
    main()
