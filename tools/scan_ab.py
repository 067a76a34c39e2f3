#!/usr/bin/env python3
"""The recurrent scans ``mamba_scan_f32`` and ``wkv6_f32`` of one or more
checkouts of this repository on one NVIDIA GPU, in turns, each in its own
process:

    python3 tools/scan_ab.py PARENT . . PARENT

where each argument is a directory that holds ``src/repro_torch`` (for
example a ``git archive`` of the parent commit unpacked under a directory
``.gitignore`` lists). Compare two checkouts only within one run.

For each checkout, each scan at its model's full widths (Zamba2-1.2B: 64
heads of dh 64, state 64; RWKV6-1.6B: 32 heads of dh 64) on inputs made
from a seed on the CPU as ``chip_smoke.scan_inputs`` makes them, at
``chip_smoke.SCAN_FORMS`` (the serve's prefill B 4 x S 512, its re-prefill
length S 500 and decode B 4) and at B 4 x S of ``SWEEP`` (where the
sequential and chunked forms cross): the sha256 of y and of the final
state (equal hashes across checkouts mean bitwise-equal outputs), their
largest error against the plain loop over max(1, max|plain|), the wall ms
per call (CUDA events around 10 back-to-back calls, median of 21 runs) and
the device µs per launch (``torch.profiler`` over 20 calls), by kernel.
Then, per model, one whole-batch re-prefill of the full-width serve (B 4 x
S 500, ``chip_smoke.profile_reprefill``): its wall, device time and the
scan's part of it. One JSON line per checkout; the card's name and power
limit come first.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP = (16, 32, 48, 64, 96, 128)


def one(tree: str) -> dict:
    """Hash, check and time both scans of the checkout at ``tree``."""
    sys.path.insert(0, ROOT)
    from chip_smoke import (SCAN_FORMS, SCAN_KERNELS, lm_serve_params,
                            profile_reprefill, scan_inputs, time_ms)
    from causal_ab import _device_us, _sha
    entries = {"mamba": "mamba_scan_f32_", "wkv6": "wkv6_f32_"}
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    from repro_torch import configs
    from repro_torch.kernels import backend
    from repro_torch.kernels.ssm_scan import ops as SS
    dev = backend.resolve_device("cuda")
    build_s = backend.build(["mamba_scan", "wkv6"])
    res = {"tree": tree, "build_s": build_s}
    cases = (*SCAN_FORMS, *(("sweep", 4, S) for S in SWEEP))
    for kind, entry, _, cfg_name in SCAN_KERNELS:
        cfg = getattr(configs, cfg_name)
        fn, plain = ((SS.mamba_scan, SS.mamba_scan_plain) if kind == "mamba"
                     else (SS.wkv6, SS.wkv6_plain))
        g = torch.Generator().manual_seed(12)
        for label, B, S in cases:
            args = scan_inputs(torch, dev, kind, cfg, B, S, g)
            call = lambda a=args: fn(*a)
            y, s = call()
            y_ref, s_ref = plain(*args)
            torch.cuda.synchronize()
            # a profiler window has been seen to lose its device records:
            # such a window is profiled again
            for _ in range(3):
                by_kernel = _device_us(call)
                if any(entries[kind] in k for k in by_kernel):
                    break
            res[f"{entry} {label} B {B} x S {S}"] = dict(
                sha256=[_sha(y), _sha(s)],
                rel_err=[((a - r).abs().max() / max(1.0, r.abs().max()))
                         .item() for a, r in ((y, y_ref), (s, s_ref))],
                ms=time_ms(call), device_us=sum(by_kernel.values()),
                device_us_by_kernel=by_kernel)
            del y, s, y_ref, s_ref, args
    for kind, entry, _, cfg_name in SCAN_KERNELS:
        cfg = getattr(configs, cfg_name)
        params = lm_serve_params(torch, dev, cfg, cfg.name)
        res[f"re-prefill {cfg.name}"] = profile_reprefill(
            torch, dev, cfg, params, cfg.name, entry)
        del params
        torch.cuda.empty_cache()
    return res


if __name__ == "__main__":
    from ab_runner import run
    sys.exit(run(sys.argv[1:], one, os.path.abspath(__file__), __doc__))
