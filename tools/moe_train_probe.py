#!/usr/bin/env python3
"""Probe the port's MoE training step (``models/steps.make_train_step``) on
full-width Granite-MoE-3B-A800M on one NVIDIA GPU, at ``chip_smoke.py``'s
setup (params from seed 0 drawn on the card, scores from seed 7,
``launch/train``'s ``--prune`` pruning: block 16, r_b 0.5, per expert;
batches from ``synthetic_lm_batch`` by step; bf16 activations, full remat,
AdamW in place at ``chip_smoke.LM_TRAIN_LR``):

    python3 tools/moe_train_probe.py [--batches 8,6,4] [--steps 4]
                                     [--skip-cpu]

1. Step 0's loss and gradients at full width cut to 2 layers, batch 2,
   seq 128, on the card (kernels) against the CPU (plain attention), both
   with bf16 activations, by ``chip_smoke.moe_step0_card_vs_cpu``: per
   layer the tokens the CPU routes otherwise when free (with their
   experts and gaps to the k-th probability) and the tokens kept
   otherwise; the 12 worst leaves (largest |card - CPU| over the leaf's
   largest |CPU gradient|) with the card's routing replayed on the CPU
   and routing freely (``--skip-cpu`` leaves this out).
2. For each batch of ``--batches`` x 512 tokens until one fits:
   ``--steps`` steps of the full model, the loss, aux and wall of each
   (host clock around synchronized steps) and the peak device memory; a
   batch that runs out of memory is reported and the next tried.

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

SEQ = 512


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="8,6,4")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--skip-cpu", action="store_true")
    args = ap.parse_args()
    import torch
    import chip_smoke as CS  # puts ROOT/src on the path
    from repro_torch.configs import GRANITE_MOE_3B_A800M
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
    print(f"build: {backend.build():.2f} s", flush=True)
    cfg = LT.prune_config(GRANITE_MOE_3B_A800M)

    if not args.skip_cpu:
        loss_c, loss_r, loss_h, cpu_s, launches, flips, rows, free = \
            CS.moe_step0_card_vs_cpu(torch, dev, cfg)
        print(f"step 0 at 2 layers (CPU {cpu_s:.1f} s, two runs): loss card "
              f"{loss_c:.6f}, CPU with the card's routing {loss_r:.6f}, "
              f"CPU routing freely {loss_h:.6f}; launches {launches}",
              flush=True)
        for i, f in enumerate(flips):
            print(f"  layer {i}: routed otherwise {f['routed']}, kept "
                  f"otherwise {f['kept']}, d {f['d']:.4g}, largest gap / 2d "
                  f"{f['worst']:.3f}; flips {f['flips']}", flush=True)
        for label, rs in (("the card's routing replayed", rows),
                          ("routing freely", free)):
            print(f"  worst leaves, CPU {label}:", flush=True)
            for r, d, m, path in rs[:12]:
                print(f"    {r:.4g}  max|d| {d:.4g}  max|CPU| {m:.4g}  "
                      f"{path}", flush=True)

    opt = AdamW(lr=CS.LM_TRAIN_LR, weight_decay=0.01)
    step = ST.make_train_step(cfg, opt, with_pruning=True)
    for batch in (int(b) for b in args.batches.split(",")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        state = LT.make_state_factory(cfg, opt, dev, with_scores=True)()
        params, scores, opt_state = (state["params"], state["scores"],
                                     state["opt"])
        del state
        shape = ShapeConfig("t", SEQ, batch, "train")
        walls, out = [], []
        try:
            for i in range(args.steps):
                toks = torch.from_numpy(synthetic_lm_batch(
                    cfg, shape, DataConfig(), i)["tokens"]).to(dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, scores, opt_state, m = step(
                    params, opt_state, {"tokens": toks}, scores)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                out.append({k: round(v.item(), 4) for k, v in m.items()})
        except torch.OutOfMemoryError as e:
            print(f"batch {batch} x {SEQ}: out of memory after "
                  f"{len(walls)} steps (peak "
                  f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} "
                  f"GiB): {str(e)[:200]}", flush=True)
            del params, scores, opt_state
            continue
        print(f"batch {batch} x {SEQ}: metrics {out}; wall per step (ms) "
              f"{[round(w * 1e3, 1) for w in walls]}; peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB",
              flush=True)
        break
    return 0


if __name__ == "__main__":
    sys.exit(main())
