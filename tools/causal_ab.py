#!/usr/bin/env python3
"""The bf16 attention kernels, causal and non-causal, of one or more
checkouts of this repository on one NVIDIA GPU, in turns, each in its own
process:

    python3 tools/causal_ab.py PARENT . . PARENT

where each argument is a directory that holds ``src/repro_torch`` (for
example a ``git archive`` of the parent commit unpacked under a directory
``.gitignore`` lists). Compare two checkouts only within one run.

For each checkout, on the same bf16 inputs made from a seed on the CPU:

* the serve cases: ``flash_attention(causal=True)`` at ``chip_smoke.py``'s
  LM serve shapes (full-width Minitron-4B: 24 query over 8 KV heads, Dh
  128, a 572-slot cache; a prefill of a 512-token bucket with
  ``kv_start`` 12, a batch-4 decode, and a decode row over 9 splits; the
  prefill and the batch-4 decode at StableLM-1.6B's 32 heads of Dh 64 and
  at Granite-MoE-3B-A800M's 24 over 8 of Dh 64), each with its device µs
  per call by kernel;
* the training cases, at ``chip_smoke.LM_TRAIN_CASES`` (StableLM-1.6B
  [8, 512, 32, 64] and GQA 3:1 [2, 512, 24/8, 64]): the forward with the
  log-sum-exp (``flash_prefill_bf16``: o, lse) and the backward
  (``flash_prefill_bwd_bf16``: dq, dk, dv), each with its device µs per
  call by kernel (``torch.profiler`` over 20 calls), and SDPA's forward +
  backward (``is_causal=True``) on the same inputs (``sdpa_us``);
* the non-causal training cases, at ``chip_smoke.MM_TRAIN_CASES``
  (Whisper-base's encoder and cross-attention, Llama-3.2-Vision-90B's
  cross layer, the ragged Dh-16 tiles): the same records for the
  non-causal forward with lse and ``flash_prefill_bwd_bf16`` with
  ``causal`` 0, inputs as ``chip_smoke.check_noncausal_training`` makes
  them, and SDPA's forward + backward (``enable_gqa=True``);
* the SASS of each kernel of the backward's library, as a sha256 of its
  ``cuobjdump -sass`` text by kernel name (equal hashes: the same
  instructions);

* the non-causal bf16 cases, at ``chip_smoke.MM_NONCAUSAL_CASES``
  (Whisper-base's encoder and cross-attention, Llama-3.2-Vision-90B's
  cross layers, the reduced configs' Dh 16 and the design's other
  branches): ``flash_attention(q, k, v)`` on bf16 inputs made as
  ``chip_smoke.check_flash_attention_noncausal`` makes them, with its
  device µs per call by kernel and, on the same inputs,
  ``F.scaled_dot_product_attention(enable_gqa=True)``'s (``sdpa_us``,
  all its device work).

For each output the sha256 of its bytes (equal hashes across checkouts
mean bitwise-equal outputs), and the wall ms per call (CUDA events around
10 back-to-back calls, median of 21 runs). One JSON line per checkout;
the card's name and power limit come first.
"""
from __future__ import annotations

import hashlib
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = (  # label, B, Nq, q_offset, kv_len, kv_start (chip_smoke.py's)
    ("prefill kv_start=12", 1, 512, [0], [512], [12]),
    ("decode", 4, 1, [129, 289, 419, 570], [130, 290, 420, 571],
     [32, 56, 0, 12]),
    ("decode 9 splits", 1, 1, [571], [572], [0]))
HEADS = (24, 8, 128)  # Minitron-4B's Hq, KV, Dh


def serve_cases():
    """(case, (Hq, KV, Dh)) of every serve case: ``CASES`` at Minitron-4B's
    heads, then ``chip_smoke.LM_DH64`` and ``LM_GQA3`` at StableLM-1.6B's
    and Granite-MoE-3B-A800M's."""
    from chip_smoke import LM_DH64, LM_GQA3
    return ([(c, HEADS) for c in CASES] + [(c, (32, 32, 64)) for c in LM_DH64]
            + [(c, (24, 8, 64)) for c in LM_GQA3])


def _sha(t) -> str:
    import torch
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def _device_us(fn, n: int = 20) -> dict:
    """Device µs per call of each kernel ``fn`` runs on the card, by kernel
    name, from ``torch.profiler`` over ``n`` calls after one warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import _device_rows
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name, _, us in _device_rows(prof):
        m = re.search(r"\w+_kernel", name)
        key = m.group(0) if m else name[:60]
        out[key] = out.get(key, 0.0) + us / n
    return out


def _sdpa_us(torch, q, k, v, do, causal: bool) -> float:
    """Device µs of SDPA's forward and backward on [B, N, H, Dh] bf16
    inputs (GQA repeat by ``enable_gqa``), all its kernels."""
    import torch.nn.functional as F
    leaves = [t.transpose(1, 2).detach().clone().requires_grad_(True)
              for t in (q, k, v)]
    doh = do.transpose(1, 2).contiguous()

    def sdpa():
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                             enable_gqa=True)
        return torch.autograd.grad(out, leaves, doh)
    return sum(_device_us(sdpa).values())


def _pair(torch, label, fwd, bwd, time_ms, sdpa_us) -> dict:
    """Hashes, wall ms and device µs by kernel of a forward with lse and
    its backward; SDPA's device µs beside them."""
    o, lse = fwd()
    grads = bwd(o, lse)
    torch.cuda.synchronize()
    by_kernel = _device_us(lambda: bwd(o, lse))
    return {label: dict(
        fwd_sha256=[_sha(o), _sha(lse)], fwd_ms=time_ms(fwd),
        fwd_device_us=_device_us(fwd),
        bwd_sha256=[_sha(t) for t in grads],
        bwd_ms=time_ms(lambda: bwd(o, lse)),
        bwd_device_us=sum(by_kernel.values()),
        bwd_device_us_by_kernel=by_kernel, sdpa_us=sdpa_us)}


def train_cases(torch, dev, time_ms) -> dict:
    """The training pair of the checkout on the path at ``LM_TRAIN_CASES``,
    inputs as ``chip_smoke.check_causal_training`` makes them."""
    from chip_smoke import LM_TRAIN_CASES
    from repro_torch.kernels.flash_attention import ops as FA
    g = torch.Generator().manual_seed(9)
    res = {}
    for label, B, N, Hq, KV, Dh in LM_TRAIN_CASES:
        q, do = (torch.randn((B, N, Hq, Dh), generator=g).to(
            dev, torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((B, N, KV, Dh), generator=g).to(
            dev, torch.bfloat16) for _ in range(2))

        def fwd(q=q, k=k, v=v):
            return FA._causal_cuda(q, k, v, None, None, None, False,
                                   with_lse=True)

        def bwd(o, lse, q=q, k=k, v=v, do=do):
            return FA._causal_bwd_cuda(q, k, v, o, do, lse, None)
        res.update(_pair(torch, f"train {label}", fwd, bwd, time_ms,
                         _sdpa_us(torch, q, k, v, do, True)))
    return res


def mm_train_cases(torch, dev, time_ms) -> dict:
    """The non-causal training pair of the checkout on the path at
    ``MM_TRAIN_CASES``, inputs as ``chip_smoke.check_noncausal_training``
    makes them."""
    from chip_smoke import MM_TRAIN_CASES
    from repro_torch.kernels.flash_attention import ops as FA
    g = torch.Generator().manual_seed(10)
    res = {}
    for label, B, Nq, Nk, Hq, KV, Dh in MM_TRAIN_CASES:
        q, do = (torch.randn((B, Nq, Hq, Dh), generator=g).to(
            dev, torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((B, Nk, KV, Dh), generator=g).to(
            dev, torch.bfloat16) for _ in range(2))

        def fwd(q=q, k=k, v=v):
            return FA._noncausal_cuda(q, k, v, with_lse=True)

        def bwd(o, lse, q=q, k=k, v=v, do=do):
            return FA._prefill_bwd_cuda(q, k, v, o, do, lse, None,
                                        causal=False)
        res.update(_pair(torch, f"mm train {label}", fwd, bwd, time_ms,
                         _sdpa_us(torch, q, k, v, do, False)))
    return res


def bwd_sass(backend) -> dict:
    """sha256 of each kernel's SASS in the backward's library, by kernel
    and head width (``name<Dh>``; the mangled name's namespace hash
    differs between builds)."""
    out, fn, lines = {}, None, []
    for line in backend.disassemble("flash_prefill_bwd").splitlines() + [
            "Function : end"]:
        if "Function :" in line:
            m = fn and re.search(r"(flash_prefill_bwd_bf16_\w+?_kernel)ILi"
                                 r"(\d+)E", fn)
            if m:
                out[f"{m.group(1)}<{m.group(2)}>"] = hashlib.sha256(
                    "\n".join(lines).encode()).hexdigest()[:16]
            fn, lines = line.split("Function :")[1].strip(), []
        elif fn is not None:
            lines.append(line)
    return out


def noncausal_cases(torch, dev, time_ms) -> dict:
    """The non-causal bf16 form of the checkout on the path at
    ``MM_NONCAUSAL_CASES``, and SDPA on the same inputs."""
    import torch.nn.functional as F
    from chip_smoke import MM_NONCAUSAL_CASES
    from repro_torch.kernels.flash_attention import flash_attention
    g = torch.Generator().manual_seed(12)
    res = {}
    for label, q_shape, kv_shape in MM_NONCAUSAL_CASES:
        q = torch.randn(q_shape, generator=g).to(dev, torch.bfloat16)
        k, v = (torch.randn(kv_shape, generator=g).to(dev, torch.bfloat16)
                for _ in range(2))

        def call(q=q, k=k, v=v):
            return flash_attention(q, k, v)

        def sdpa(q=q, k=k, v=v):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                enable_gqa=True)
        o = call()
        torch.cuda.synchronize()
        by_kernel = _device_us(call)
        res[f"noncausal {label}"] = dict(
            sha256=[_sha(o)], ms=time_ms(call),
            device_us=sum(by_kernel.values()), device_us_by_kernel=by_kernel,
            sdpa_us=sum(_device_us(sdpa).values()))
    return res


def one(tree: str) -> dict:
    """Hash and time the bf16 attention wrappers of the checkout at
    ``tree``."""
    sys.path.insert(0, ROOT)
    from chip_smoke import time_ms  # puts ROOT/src on the path
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import flash_attention
    dev = backend.resolve_device("cuda")
    build_s = backend.build(["flash_decode", "flash_prefill",
                             "flash_prefill_bwd"])
    S = 572
    g = torch.Generator().manual_seed(8)
    res = {"tree": tree, "build_s": build_s}
    for (label, B, Nq, off, lens, starts), (Hq, KV, Dh) in serve_cases():
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
        res[label] = dict(sha256=[_sha(t) for t in out], ms=time_ms(call),
                          device_us=_device_us(call))
    res.update(train_cases(torch, dev, time_ms))
    res.update(mm_train_cases(torch, dev, time_ms))
    res.update(noncausal_cases(torch, dev, time_ms))
    res["bwd_sass_sha256"] = bwd_sass(backend)
    return res


if __name__ == "__main__":
    from ab_runner import run
    sys.exit(run(sys.argv[1:], one, os.path.abspath(__file__), __doc__))
