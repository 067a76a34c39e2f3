#!/usr/bin/env python3
"""Probe the port's LM training step (``models/steps.make_train_step``) on
full-width StableLM-1.6B on one NVIDIA GPU, at ``chip_smoke.py``'s setup
(params from seed 0 drawn on the card, scores from seed 7, ``launch/train``'s
``--prune`` pruning: block 16, r_b 0.5; batches of 8 x 512 tokens from
``synthetic_lm_batch`` by step; bf16 activations, full remat):

    python3 tools/lm_train_probe.py [--lrs 1e-4,3e-4,1e-3] [--steps 6]
                                    [--skip-cpu]

1. The kernels' compiler report (``nvcc -Xptxas -v``: registers, shared
   memory and spills of each causal kernel).
2. Step 0's loss and gradients at full width cut to 2 layers, batch 2,
   seq 128, on the card (bf16, kernels) against the CPU (fp32, plain):
   per leaf the largest |card - CPU| over the leaf's largest |CPU
   gradient|, the 12 worst leaves first, and the loss, by
   ``chip_smoke.lm_step0_card_vs_cpu`` (``--skip-cpu`` leaves this out).
3. For each AdamW learning rate (weight decay 0.01), ``--steps`` steps of
   the full model from the same seed: the loss per step, the wall of each
   step (host clock around synchronized steps) and the peak device
   memory.

The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BATCH, SEQ = 8, 512


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lrs", default="1e-4,3e-4,1e-3")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--skip-cpu", action="store_true")
    args = ap.parse_args()
    import torch
    import chip_smoke as CS  # puts ROOT/src on the path
    from repro_torch.configs import STABLELM_1_6B
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, synthetic_lm_batch
    from repro_torch.kernels import backend
    from repro_torch.launch import train as LT
    from repro_torch.models import steps as ST
    from repro_torch.optim import AdamW

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = backend.resolve_device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    backend.build(["flash_prefill", "flash_prefill_bwd"], verbose=True)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)

    cfg = LT.prune_config(STABLELM_1_6B)
    if not args.skip_cpu:
        loss_c, loss_h, cpu_s, launches, rows = CS.lm_step0_card_vs_cpu(
            torch, dev, cfg)
        print(f"step 0 at 2 layers, batch 2, seq 128: loss card "
              f"{loss_c:.6f} CPU {loss_h:.6f} (CPU {cpu_s:.1f} s); card "
              f"launches {launches}", flush=True)
        for r, d, m, p in rows[:12]:
            print(f"  {r:.4g} = {d:.4g} / {m:.4g}  {p}", flush=True)

    shape = ShapeConfig("t", SEQ, BATCH, "train")
    host = [synthetic_lm_batch(cfg, shape, DataConfig(), i)["tokens"]
            for i in range(args.steps)]
    for lr in (float(x) for x in args.lrs.split(",")):
        opt = AdamW(lr=lr, weight_decay=0.01)
        state = LT.make_state_factory(cfg, opt, dev, with_scores=True)()
        step = ST.make_train_step(cfg, opt, with_pruning=True)
        p, s, o = state["params"], state["scores"], state["opt"]
        del state  # a step's old state is freed as the new one is made
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        losses, walls = [], []
        for i in range(args.steps):
            toks = torch.from_numpy(host[i]).to(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, s, o, m = step(p, o, {"tokens": toks}, s)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(round(m["loss"].item(), 4))
        print(f"lr {lr:g}: losses {losses}; wall per step (ms) "
              f"{[round(w * 1e3, 1) for w in walls]}; peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB",
              flush=True)
        del p, s, o
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
