#!/usr/bin/env python3
"""The ViT's serve outputs and Algorithm-1 training step of one or more
checkouts of this repository on one NVIDIA GPU, in turns, each in its own
process:

    python3 tools/vit_train_ab.py PARENT . . PARENT

where each argument is a directory that holds ``src/repro_torch`` and
``chip_smoke.py`` (for example a ``git archive`` of the parent commit
unpacked under a directory ``.gitignore`` lists). Compare two checkouts
only within one run.

For each checkout it prints one JSON line, from that checkout's code and
``chip_smoke.py`` helpers:

* ``serve``: sha256 of the logits of ``chip_smoke.py``'s 16-request stream
  served once by full-width DeiT-Small (``VisionEngine``, 4 slots, depth
  1, weights from seed 0, scores from seed 7) at fp32 with hard TDM and at
  fp16 and int8 with every other request soft-pruned, and of
  ``forward_vit_packed`` on two images with the TDM; equal digests mean
  bitwise-equal logits;
* ``train``: Algorithm 1 on full-width DeiT-Small as ``chip_smoke.py``'s
  training phase runs it (batch 64, AdamW lr 1e-4, ``total_steps`` 20):
  one warm-up step, then ``STEPS`` steps each timed on the host's clock
  between synchronizations (wall ms, median and all), the losses, the
  peak device memory, and one profiled step's device busy ms, idle share
  and device ms by part (attention forward and backward, TDM forward and
  backward, the fp32 GEMMs, the rest) and its top device entries.

The card's name and power limit come first.
"""
from __future__ import annotations

import hashlib
import os
import statistics
import sys
import time

STEPS = 6  # timed training steps after the warm-up

# device entries by part of the training step, first match wins
PARTS = (("attention forward", ("flash_attention_f32",)),
         ("attention backward", ("flash_attention_bwd_f32",)),
         ("tdm forward", ("token_drop_f32",)),
         ("tdm backward", ("token_drop_bwd_f32",)),
         ("fp32 gemm", ("gemm", "sgemm", "cutlass", "Kernel2")))


def digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def serve_digests(torch, CS, backend, cfg, dev) -> dict:
    import numpy as np
    from repro_torch.core import packed_runner as PR
    from repro_torch.models import model as M
    from repro_torch.models import pruning_glue as PG
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    scores = PG.init_scores(cfg, params, torch.Generator().manual_seed(7))
    res = {}
    for precision, soft in (("fp32", False), ("fp16", True), ("int8", True)):
        eng = CS.make_engine(cfg, params, scores, 1, dev,
                             precision=precision)
        out = CS.serve_stream(torch, backend, eng, soft=soft)[1]
        res[f"{precision}{' soft' if soft else ''}"] = digest(
            np.asarray(out[u], np.float32) for u in sorted(out))
    n = (cfg.image_size // cfg.patch_size) ** 2
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, n, cfg.patch_size ** 2 * 3)), dtype=torch.float32).to(dev)
    y = PR.forward_vit_packed(cfg, eng.segments.params, eng.segments.packed,
                              x, use_tdm=True, device=dev).logits
    res["packed forward"] = digest([y.cpu().numpy()])
    return res


def train_step(torch, CS, cfg, dev) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import simultaneous as SIM
    from repro_torch.data import DataConfig, synthetic_vit_batch
    from repro_torch.models import model as M
    from repro_torch.optim import AdamW
    opt = AdamW(lr=1e-4, weight_decay=0.01)
    state, _ = SIM.init_state(cfg, torch.Generator().manual_seed(0), opt,
                              device=dev)
    teacher = M.init_params(cfg, torch.Generator().manual_seed(1),
                            device=dev)
    step = SIM.make_simultaneous_step(cfg, cfg, opt, 20)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                synthetic_vit_batch(cfg, 64, DataConfig(seed=0), i).items()}
               for i in range(STEPS + 2)]
    state, m = step(state, teacher, batches[0])  # warm-up
    losses = [m["loss"].item()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    walls = []
    for i in range(1, STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, teacher, batches[i])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, teacher, batches[-1])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
    rows = CS._device_rows(prof)
    busy = sum(r[2] for r in rows) / 1e3
    parts = {name: [0, 0.0] for name, _ in PARTS}
    parts["other"] = [0, 0.0]
    for n, k, us in rows:
        key = next((name for name, keys in PARTS
                    if any(s in n for s in keys)), "other")
        parts[key][0] += k
        parts[key][1] += us / 1e3
    wall = statistics.median(walls)
    return dict(
        wall_ms_median=wall, wall_ms=walls, losses=losses,
        peak_gib=peak, profiled_wall_ms=dt, busy_ms=busy,
        idle_share_unprofiled=1.0 - busy / wall,
        idle_share_profiled=1.0 - busy / dt,
        device_launches=sum(r[1] for r in rows),
        parts={k: {"launches": v[0], "ms": v[1]} for k, v in parts.items()},
        top=[[n[:80], k, us / 1e3] for n, k, us in rows[:12]])


def one(tree: str) -> dict:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import chip_smoke as CS  # puts tree/src on the path
    import torch
    from repro_torch.configs import DEIT_SMALL
    from repro_torch.kernels import backend
    dev = backend.resolve_device("cuda")
    build_s = backend.build()
    return {"tree": tree, "build_s": build_s,
            "serve": serve_digests(torch, CS, backend, DEIT_SMALL, dev),
            "train": train_step(torch, CS, DEIT_SMALL, dev)}


if __name__ == "__main__":
    from ab_runner import run
    sys.exit(run(sys.argv[1:], one, os.path.abspath(__file__), __doc__))
