#!/usr/bin/env python3
"""The ViT's fp32 attention backward ``flash_attention_bwd_f32`` of one or
more checkouts of this repository on one NVIDIA GPU, in turns, each in its
own process:

    python3 tools/vit_attn_bwd_ab.py PARENT . . PARENT

where each argument is a directory that holds ``src/repro_torch`` (for
example a ``git archive`` of the parent commit unpacked under a directory
``.gitignore`` lists). Compare two checkouts only within one run.

For each checkout, at ``chip_smoke.VIT_ATTN_CASES`` (Algorithm 1's shapes
at full-width DeiT-Small, batch 64, then the reduced config's), on fp32
inputs made from a seed on the CPU: the forward with the log-sum-exp
(``flash_attention_f32``), then the backward with the CLS probabilities'
gradient as the training step passes it (dscores / H, a broadcast view
over heads) and without it. Per case and form: the sha256 of dq, dk, dv
(equal hashes across checkouts mean bitwise-equal outputs), their largest
error against ``attention_bwd_plain`` over max(1, max|plain|), the wall
ms per call (CUDA events around 10 back-to-back calls, median of 21 runs)
and the device µs per call by kernel (``torch.profiler`` over 20 calls).
One JSON line per checkout; the card's name and power limit come first.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(tree: str) -> dict:
    """Hash, check and time the backward of the checkout at ``tree``."""
    sys.path.insert(0, ROOT)
    from chip_smoke import VIT_ATTN_CASES, time_ms  # puts ROOT/src on the path
    from causal_ab import _device_us, _sha
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import ops as FA
    dev = backend.resolve_device("cuda")
    build_s = backend.build(["flash_attention", "flash_attention_bwd"])
    g = torch.Generator().manual_seed(12)
    res = {"tree": tree, "build_s": build_s}
    for label, B, N, H, Dh in VIT_ATTN_CASES:
        q, k, v, do = (torch.randn((B, N, H, Dh), generator=g).to(dev)
                       for _ in range(4))
        dsc = torch.randn((B, N), generator=g).to(dev)
        o, _, lse = FA._attention_cuda(q, k, v, None, True, with_lse=True)
        for form, dprobs in (("dprobs", (dsc[:, None, :] / H).expand(
                B, H, N)), ("no dprobs", None)):
            def bwd(q=q, k=k, v=v, o=o, do=do, lse=lse, dprobs=dprobs):
                return FA._attention_bwd_cuda(q, k, v, o, do, lse, dprobs)
            grads = bwd()
            ref = FA.attention_bwd_plain(q, k, v, o, do, lse, dprobs)
            torch.cuda.synchronize()
            by_kernel = _device_us(bwd)
            res[f"{label} [{B}, {N}, {H}, {Dh}], {form}"] = dict(
                sha256=[_sha(t) for t in grads],
                rel_err=[((a - r).abs().max() / max(1.0, r.abs().max()))
                         .item() for a, r in zip(grads, ref)],
                ms=time_ms(bwd), device_us=sum(by_kernel.values()),
                device_us_by_kernel=by_kernel)
            del grads, ref
    return res


if __name__ == "__main__":
    from ab_runner import run
    sys.exit(run(sys.argv[1:], one, os.path.abspath(__file__), __doc__))
