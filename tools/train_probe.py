#!/usr/bin/env python3
"""Probe the port's Algorithm-1 training step (``core/simultaneous``) on
full-width DeiT-Small on one NVIDIA GPU, at ``chip_smoke.py``'s setup
(student and scores from seed 0, a dense teacher from seed 1, batches of
64 from ``synthetic_vit_batch`` by step, ``total_steps`` 20):

    python3 tools/train_probe.py [--lrs 2e-5,1e-4,3e-4,1e-3] [--steps 11]

1. For each AdamW learning rate (weight decay 0.01), ``--steps`` steps
   from the same state: the loss per step, and the cross entropy and
   distillation terms at the first and last step.
2. Step 0's gradients on the card against the same step's on the CPU:
   the global norm on each, then per leaf (params and scores, before the
   clip) the largest |card - CPU|, the leaf's largest |gradient| and their
   ratio, the 25 worst leaves first.

The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


class CaptureGrads:
    """Stands in for the optimizer: keeps the gradients, moves nothing."""

    def update(self, grads, state, params):
        self.grads = grads
        return params, state


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lrs", default="2e-5,1e-4,3e-4,1e-3")
    ap.add_argument("--steps", type=int, default=11)
    args = ap.parse_args()
    import torch
    from repro_torch.configs import DEIT_SMALL
    from repro_torch.core import simultaneous as SIM
    from repro_torch.data import DataConfig, synthetic_vit_batch
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.models import model as M
    from repro_torch.optim import AdamW, global_norm
    from repro_torch.tree import flatten_with_path, path_str, tree_map

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = resolve_device("cuda")
    cfg = DEIT_SMALL
    host = [synthetic_vit_batch(cfg, 64, DataConfig(seed=0), i)
            for i in range(args.steps)]

    def on(d, b):
        return {k: torch.from_numpy(v).to(d) for k, v in b.items()}

    def start(opt):
        state, _ = SIM.init_state(cfg, torch.Generator().manual_seed(0), opt,
                                  device=dev)
        teacher = M.init_params(cfg, torch.Generator().manual_seed(1),
                                device=dev)
        return state, teacher

    for lr in (float(x) for x in args.lrs.split(",")):
        opt = AdamW(lr=lr, weight_decay=0.01)
        state, teacher = start(opt)
        step = SIM.make_simultaneous_step(cfg, cfg, opt, 20)
        ms = []
        for b in host:
            state, m = step(state, teacher, on(dev, b))
            ms.append({k: v.item() for k, v in m.items()})
        print(f"lr {lr}: losses {[round(m['loss'], 4) for m in ms]}; ce / "
              f"distill first {ms[0]['ce']:.4f} / {ms[0]['distill']:.4f}, "
              f"last {ms[-1]['ce']:.4f} / {ms[-1]['distill']:.4f}",
              flush=True)
        del state, teacher

    state, teacher = start(AdamW())
    grads = {}
    for d in (dev, torch.device("cpu")):
        cap = CaptureGrads()
        SIM.make_simultaneous_step(cfg, cfg, cap, 20)(
            tree_map(lambda t: t.to(d), state),
            tree_map(lambda t: t.to(d), teacher), on(d, host[0]))
        grads[d.type] = tree_map(lambda t: t.cpu(), cap.grads)
    print(f"step 0 global gradient norm: card "
          f"{global_norm(grads['cuda']).item()!r}, CPU "
          f"{global_norm(grads['cpu']).item()!r}", flush=True)
    rows = []
    for (path, a), (_, c) in zip(flatten_with_path(grads["cuda"]),
                                 flatten_with_path(grads["cpu"])):
        diff, big = (a - c).abs().max().item(), c.abs().max().item()
        rows.append((diff, big, path_str(path)))
    rows.sort(reverse=True)
    for diff, big, path in rows[:25]:
        print(f"  {path:40s} max|card - CPU| {diff:.3e}  max|g| {big:.3e}  "
              f"ratio {diff / max(big, 1e-30):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
