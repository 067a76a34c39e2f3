#!/usr/bin/env python3
"""Probe the port's Algorithm-1 training step (``core/simultaneous``) on
full-width DeiT-Small on one NVIDIA GPU, at ``chip_smoke.py``'s setup
(student and scores from seed 0, a dense teacher from seed 1, batches of
64 from ``synthetic_vit_batch`` by step, ``total_steps`` 20):

    python3 tools/train_probe.py [--lrs 2e-5,1e-4,3e-4,1e-3] [--steps 11]
                                 [--parts tdm,lr,grads]

0. (``tdm``) Step 0's student forward on the card and on the CPU: at
   each TDM, the largest |card - CPU| of the TDM scores, the largest
   |kernel - plain| of the card's scores (the plain CLS-row
   probabilities recomputed on the card from the kernel's own q and k),
   the smallest gap between the k-th and (k+1)-th largest score on each
   device, the rows whose kept tokens come in another top-k order, and
   for every row that keeps other tokens: its gaps, its largest |card -
   CPU| score difference and the tokens that changed sides. Scores and
   tokens are compared by token identity (a TDM's fused row is a token
   of its own), so an earlier order swap does not count again.
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


def tdm_probe(torch, cfg, start, batch, dev) -> None:
    """Part 0 (module docstring): the TDM scores of step 0's student
    forward, card against CPU."""
    from repro_torch.core import schedule as S
    from repro_torch.core import simultaneous as SIM
    from repro_torch.core import token_pruning as TP
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.token_drop import ops as TD
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    state, _ = start
    p = cfg.pruning
    r_b = S.cubic_keep_rate(torch.zeros((), dtype=torch.int32), 20, p.r_b,
                            2, 2)
    seen, run = ([], []), [0]  # by run: the card's, then the CPU's
    inner_fa = FA.flash_attention
    inner_card, inner_plain = TD._token_drop_cuda, TP.tdm

    def flash_attention(q, k, v, *a, collect_scores=False, **kw):
        out = inner_fa(q, k, v, *a, collect_scores=collect_scores, **kw)
        if collect_scores:
            seen[run[0]].append(
                [out[1].detach(), A.attention_probs_row(
                    q[:, 0].detach(), k.detach()).mean(dim=1)])
        return out

    # the kept indices: the kernel's index output on the card (asked for
    # here; the rows are the same bit for bit), TP.tdm's on the CPU
    def on_card(z, scores, k, with_idx):
        out = inner_card(z, scores, k, True)
        seen[run[0]][-1] += [k, out[1].long()]
        return out

    def plain(z, scores, r_t, has_cls=True, k=None):
        out = inner_plain(z, scores, r_t, has_cls, k)
        seen[run[0]][-1] += [k, out[1].long()]
        return out
    FA.flash_attention = flash_attention
    TD._token_drop_cuda, TP.tdm = on_card, plain
    try:
        for run[0], d in enumerate((dev, torch.device("cpu"))):
            tr = tree_map(lambda t: t.to(d), state)
            with torch.no_grad():
                M.forward_vit(cfg, SIM.student_params(
                    cfg, tr.params, tr.scores, r_b.to(d)),
                    batch["patches"].to(d))
    finally:
        FA.flash_attention = inner_fa
        TD._token_drop_cuda, TP.tdm = inner_card, inner_plain

    def gaps(sc, k):
        v = sc[:, 1:].sort(dim=1, descending=True).values
        return v[:, k - 1] - v[:, k]

    # each position's token identity at a TDM's input, per run: the input's
    # tokens 0 .. N, and -(t + 1) for the row TDM t fuses; scores and kept
    # sets are compared by identity, since two near-tied kept tokens can
    # take each other's places in top-k order on one device
    ids = [torch.arange(seen[0][0][0].shape[1]).expand(
        seen[0][0][0].shape[0], -1)] * 2
    for t, (layer, card, cpu) in enumerate(zip(p.tdm_layers, *seen)):
        s_card, s_plain, k, idx_card = (x.cpu() if torch.is_tensor(x) else x
                                        for x in card)
        s_cpu, _, _, idx_cpu = cpu
        order = [i.argsort(dim=1) for i in ids]
        by_id = [s.gather(1, o) for s, o in zip((s_card, s_cpu), order)]
        kept = [i[:, 1:].gather(1, x) for i, x in zip(ids, (idx_card,
                                                          idx_cpu))]
        g_card, g_cpu = gaps(s_card, k), gaps(s_cpu, k)
        swapped = torch.nonzero((kept[0] != kept[1]).any(dim=1))[:, 0]
        print(f"tdm layer {layer} (k = {k}): max|card - CPU| scores by "
              f"token {(by_id[0] - by_id[1]).abs().max().item():.3e}, "
              f"max|kernel - plain| on the card "
              f"{(s_card - s_plain).abs().max().item():.3e}; smallest k-th "
              f"gap card {g_card.min().item():.3e} (row "
              f"{int(g_card.argmin())}), CPU {g_cpu.min().item():.3e}; "
              f"largest score {s_cpu.max().item():.3e}; rows whose kept "
              f"tokens come in another top-k order "
              f"{swapped.tolist()}",
              flush=True)
        d_rows = (by_id[0] - by_id[1]).abs().max(dim=1).values
        for row in range(s_cpu.shape[0]):
            a, b = set(kept[0][row].tolist()), set(kept[1][row].tolist())
            if a != b:
                print(f"  row {row}: kept tokens differ, card keeps "
                      f"{sorted(a - b)} and CPU {sorted(b - a)}; k-th gap "
                      f"card {g_card[row].item():.3e}, CPU "
                      f"{g_cpu[row].item():.3e}; max|card - CPU| on the row "
                      f"{d_rows[row].item():.3e}", flush=True)
        B = s_cpu.shape[0]
        ids = [torch.cat([i[:, :1], c, torch.full((B, 1), -(t + 1))], dim=1)
               for i, c in zip(ids, kept)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lrs", default="2e-5,1e-4,3e-4,1e-3")
    ap.add_argument("--steps", type=int, default=11)
    ap.add_argument("--parts", default="tdm,lr,grads")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
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

    if "tdm" in parts:
        tdm_probe(torch, cfg, start(AdamW()), on(dev, host[0]), dev)
    for lr in (float(x) for x in args.lrs.split(",") if "lr" in parts):
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

    if "grads" not in parts:
        return 0
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
