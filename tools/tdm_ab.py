#!/usr/bin/env python3
"""Time the TDM wrappers (``token_drop``, ``token_package``) of one or more
checkouts of this repository on one NVIDIA GPU, in turns, each in its own
process:

    python3 tools/tdm_ab.py PARENT . . PARENT

where each argument is a directory that holds ``src/repro_torch`` (for
example a ``git archive`` of the parent commit unpacked under a directory
``.gitignore`` lists). Compare two checkouts only within one run.

For each checkout, at ``chip_smoke.py``'s shapes (hard TDM: z [4, 197,
384], k = 138, rows with 197, 180, 160 and 140 real tokens; soft TDM: z
[4, 140, 384], k = 70, rows with 140, 120, 100 and 72 real tokens, each
row's package at n_valid - 2, int32, with carried masses), on random
scores, it prints one JSON line: per wrapper, the wall ms per call (CUDA
events around 10 back-to-back calls, median of 21 runs), the host's ms to
issue one call, and from ``torch.profiler`` over 20 calls the device
kernels per call, the device us per call summed over all the call's device
work, the TDM kernel's device us per launch, and the device entries by
name. The card's name and power limit come first.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_profile(torch, fn, symbol, n=20):
    """Device work of ``n`` calls of ``fn`` (the second of two profiled
    runs; a process's first session can miss its first kernel)."""
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import _device_rows
    for _ in range(2):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    rows = _device_rows(prof)
    mine = [r for r in rows if symbol in r[0]]
    return dict(
        kernels_per_call=sum(r[1] for r in rows) / n,
        call_device_us=sum(r[2] for r in rows) / n,
        kernel_device_us=(sum(r[2] for r in mine) / sum(r[1] for r in mine)
                          if mine else None),
        device_rows=[[name[:80], calls / n, us / n]
                     for name, calls, us in rows])


def inputs(torch, dev, seed, B, N, D, n_valid):
    g = torch.Generator().manual_seed(seed)
    z = torch.randn((B, N, D), generator=g).to(dev)
    s = torch.rand((B, N), generator=g)
    for b, nv in enumerate(n_valid):
        s[b, nv:] = 0.0
    return z, (s / s.sum(dim=1, keepdim=True)).to(dev), g


def one(tree: str) -> dict:
    """Measure the wrappers of the checkout at ``tree`` (this process),
    timed by ``chip_smoke.py``'s clocks of this checkout."""
    sys.path.insert(0, ROOT)
    from chip_smoke import host_ms, time_ms  # puts ROOT/src on the path
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    from repro_torch.kernels import backend
    from repro_torch.kernels.token_drop import token_drop
    from repro_torch.kernels.token_package import token_package
    dev = backend.resolve_device("cuda")
    build_s = backend.build(["token_drop", "token_package"])
    z, s, _ = inputs(torch, dev, 3, 4, 197, 384, (197, 180, 160, 140))
    n_valid = (140, 120, 100, 72)
    z2, s2, g = inputs(torch, dev, 4, 4, 140, 384, n_valid)
    mass = torch.rand((4,), generator=g).to(dev)
    pos = torch.tensor([n - 2 for n in n_valid], dtype=torch.int32,
                       device=dev)
    calls = {"token_drop": (lambda: token_drop(z, s, 138),
                            "token_drop_f32_kernel"),
             "token_package": (lambda: token_package(z2, s2, 70, mass, pos),
                               "token_package_f32_kernel")}
    res = {"tree": tree, "build_s": build_s}
    for name, (fn, symbol) in calls.items():
        res[name] = dict(ms=time_ms(fn), host_ms=host_ms(torch, fn),
                         **device_profile(torch, fn, symbol))
    return res


if __name__ == "__main__":
    from ab_runner import run
    sys.exit(run(sys.argv[1:], one, os.path.abspath(__file__), __doc__))
