#!/usr/bin/env python3
"""Device time of the non-causal bf16 kernels under the host's plan and
under every other split of the keys, on one NVIDIA GPU:

    python3 tools/noncausal_sweep.py

At each case of ``chip_smoke.MM_NONCAUSAL_CASES`` with Dh 64 or 128, on
bf16 inputs made from a seed: for a prefill, one and two warpgroups a
block with every whole count of key chunks up to ``ops.MAX_CHUNKS``; for
a decode, every whole count of key splits up to ``ops.MAX_SPLITS``. Each
runs through the wrapper (``flash_attention``) with the plan function of
``kernels/flash_attention/ops.py`` replaced, and prints its device µs a
launch (``torch.profiler``, ``causal_ab._device_us``), the host's own plan
marked; the card's name and power limit come first. The plans'
constants (``PREFILL_BLOCKS_PER_SM``, ``DECODE_BLOCKS_PER_SM``) are read
off this sweep.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def whole_counts(n_kt: int, cap: int):
    """The chunk counts up to ``cap`` that leave no chunk empty."""
    return [n for n in range(1, min(n_kt, cap) + 1)
            if n == -(-n_kt // -(-n_kt // n))]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from causal_ab import _device_us
    from chip_smoke import MM_NONCAUSAL_CASES  # puts ROOT/src on the path
    import torch
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import ops as FA
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = backend.resolve_device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = FA.noncausal_prefill_plan, FA.noncausal_decode_plan
    g = torch.Generator().manual_seed(12)
    for label, q_shape, kv_shape in MM_NONCAUSAL_CASES:
        if q_shape[3] not in (64, 128):
            continue
        q = torch.randn(q_shape, generator=g).to(dev, torch.bfloat16)
        k, v = (torch.randn(kv_shape, generator=g).to(dev, torch.bfloat16)
                for _ in range(2))
        B, Nq, Hq, _ = q_shape
        Nk, KV = kv_shape[1], kv_shape[2]
        n_kt = -(-Nk // FA.NONCAUSAL_TILE)
        if Nq == 1:
            host = plans[1](B, Hq, KV, Nk, sms)
            choices = whole_counts(n_kt, FA.MAX_SPLITS)
        else:
            host = plans[0](B, Nq, Hq, KV, Nk, sms)
            choices = [(w, n) for w in (1, 2)
                       for n in whole_counts(n_kt, FA.MAX_CHUNKS)]
        times = []
        for choice in choices:
            if Nq == 1:
                FA.noncausal_decode_plan = lambda *a, c=choice: c
            else:
                FA.noncausal_prefill_plan = lambda *a, c=choice: c
            times.append((choice, sum(_device_us(
                lambda: flash_attention(q, k, v)).values())))
        FA.noncausal_prefill_plan, FA.noncausal_decode_plan = plans
        print(f"{label}: q {list(q_shape)} over {list(kv_shape)}: "
              + ", ".join(f"{c}{' (plan)' if c == host else ''} {us:.2f}"
                          for c, us in times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
