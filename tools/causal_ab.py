#!/usr/bin/env python3
"""The serve path's causal attention kernels of one or more checkouts of
this repository on one NVIDIA GPU, in turns, each in its own process:

    python3 tools/causal_ab.py PARENT . . PARENT

where each argument is a directory that holds ``src/repro_torch`` (for
example a ``git archive`` of the parent commit unpacked under a directory
``.gitignore`` lists). Compare two checkouts only within one run.

For each checkout, ``flash_attention(causal=True)`` on the same bf16
inputs at ``chip_smoke.py``'s LM serve shapes (full-width Minitron-4B: 24
query over 8 KV heads, Dh 128, a 572-slot cache; a prefill of a 512-token
bucket with ``kv_start`` 12, a batch-4 decode, and a decode row over 9
splits), made from a seed on the CPU: the sha256 of each output's bytes
(o, and the decode rows' head-mean probabilities), so equal hashes across
checkouts mean bitwise-equal outputs, and the wall ms per call (CUDA
events around 10 back-to-back calls, median of 21 runs). One JSON line per
checkout; the card's name and power limit come first.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = (  # label, B, Nq, q_offset, kv_len, kv_start (chip_smoke.py's)
    ("prefill kv_start=12", 1, 512, [0], [512], [12]),
    ("decode", 4, 1, [129, 289, 419, 570], [130, 290, 420, 571],
     [32, 56, 0, 12]),
    ("decode 9 splits", 1, 1, [571], [572], [0]))


def one(tree: str) -> dict:
    """Hash and time the causal wrapper of the checkout at ``tree``."""
    sys.path.insert(0, ROOT)
    from chip_smoke import time_ms  # puts ROOT/src on the path
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import flash_attention
    dev = backend.resolve_device("cuda")
    build_s = backend.build(["flash_decode", "flash_prefill"])
    Hq, KV, Dh, S = 24, 8, 128, 572
    g = torch.Generator().manual_seed(8)
    res = {"tree": tree, "build_s": build_s}
    for label, B, Nq, off, lens, starts in CASES:
        q = torch.randn((B, Nq, Hq, Dh), generator=g).to(dev, torch.bfloat16)
        k, v = (torch.randn((B, S, KV, Dh), generator=g).to(
            dev, torch.bfloat16) for _ in range(2))
        bounds = [torch.tensor(x, dtype=torch.int32, device=dev)
                  for x in (off, lens, starts)]

        def call(q=q, k=k, v=v, b=bounds, decode=Nq == 1):
            return flash_attention(q, k, v, causal=True, q_offset=b[0],
                                   kv_len=b[1], kv_start=b[2],
                                   collect_scores=decode)
        out = call()
        out = out if isinstance(out, tuple) else (out,)
        torch.cuda.synchronize()
        res[label] = dict(
            sha256=[hashlib.sha256(t.contiguous().view(torch.uint8).cpu()
                                   .numpy().tobytes()).hexdigest()[:16]
                    for t in out],
            ms=time_ms(call))
    return res


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for tree in argv:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", tree]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
