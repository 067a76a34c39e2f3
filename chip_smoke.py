#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port builds and serves on the card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. Device: require CUDA; print the card's name and power limit
   (``nvidia-smi``).
2. Build: compile the hand-written kernels (``kernels/csrc/*.cu``, one
   ``nvcc`` each, concurrently) and print the build seconds; from the
   SASS, the fp32 non-causal attention kernels issue no tensor-core
   instruction (no TF32) and the fp16 ones issue HMMA.
3. Every kernel entry point against its plain PyTorch version on the
   card, at the main path's shapes (DeiT-Small: M=788 rows for the SBMMs
   over fp32, fp16 and int8 blocks with per-block and per-channel scales;
   B=4 x N=197 tokens x 6 heads for attention on fp32 and fp16 operands,
   each row also computed alone and padded past its kv_len (bitwise
   equal), plus rows without a key (kv_len <= 0: uniform over all N keys,
   as in the reference) and Dh 16 at N = 17 and 65;
   k=138 for the hard TDM; the soft TDM's first application and a later
   one with package masses at per-row positions in a token-padded tile;
   causal GQA attention at full-width Minitron-4B through the kernel the
   wrapper picks: a per-slot prefill of a 512-token bucket, a batch-4
   decode and a decode row spanning all 9 key splits against a 572-slot
   bf16 cache, two launches bitwise equal), with fixed seeds: error and tolerance per output,
   kernel/plain/library times (CUDA events, median of 21 runs of 10 calls
   after warm-up) and each kernel's least possible time on an H100 SXM
   (published HBM rate, fp32 CUDA-core rate, and the fp16/bf16
   tensor-core rate for the products of two 16-bit values). Each SBMM
   entry point also recomputes every row of its 788-row call alone (M = 1)
   and must match it bitwise, and prints the host's cost of issuing one
   ``sbmm()`` call and one library call; the host's cost of reading the
   current stream is printed once.
4. Main path, one serving path after another, each driven with the launch
   counts set to 0 just before a serve and read just after: full-width
   DeiT-Small (12 layers, D=384, 224 px; random weights from a seed)
   serving 16 requests of mixed resolution and keep rate through
   ``VisionEngine`` (4 slots, planner "full"):
   a. the fp32 tier with hard TDM, at pipeline depth 1 and then 2, each
      after one warm-up serve and timed over 5 serves;
   b. the fp16 tier, the int8 tier (per-channel scales) and the int8 tier
      with per-block scales, each with every other request soft-pruned,
      after one warm-up serve and timed over 3 serves.
   Every serve runs under ``torch.cuda.set_sync_debug_mode("warn")``,
   which counts the host's waits on the card other than the pipeline's
   per-step event; any such wait fails the run (once the profile below is
   printed). Checks: every request served with finite logits; every
   kernel entry point of the path launched during each serve, and every
   request dispatched at the path's tier; logits agree with the offline
   oracle ``forward_vit_packed`` (same soft flag and tier) per request
   within 1e-4 relative at fp32 and int8 and 5e-4 at fp16
   (``ORACLE_TOL``), top-1 equal; at fp16 it also prints how far the
   oracle alone moves for a one-ulp change of its fp32 input; at fp32 the
   two depths agree and the packed forward agrees with the plain
   masked-dense reference (no kernel) with token pruning off.
   c. The dense LM: full-width Minitron-4B (32 layers, D=3072, 24 query
      over 8 KV heads, vocab 256000; random weights from seed 0 drawn on
      the card, served from a bf16 copy) answering 8 requests (prompts of
      96, 200, 384 and 500 tokens, twice; 32 new tokens each) through
      ``ServeEngine`` with 4 slots and a 572-slot cache: continuous at
      pipeline depths 1 and 2, continuous with KV pruning (keep 0.5 every
      4 steps) and static waves, each after one warm-up and timed over 2
      serves. Checks: every request gets 32 tokens; the decode kernel
      launches once per layer of every decode call and the prefill kernel
      once per layer of every prefill call, both of which run; the pruned
      serve prunes; depths 1 and 2 give identical
      tokens; the teacher-forced oracle (``forward_lm`` over prompt plus
      generated tokens, no cache) puts each engine token's logit within
      0.05 of its position's largest (continuous depth 1 and static);
      no host wait besides the step events. Prints tokens/s, steps, ms
      per step and per decode step, and one decode step timed alone.
5. Profile (``torch.profiler``): each kernel's device time per launch at
   the phase-3 shapes and its library call's device time per call (an
   ``sbmm()`` call that runs more than its one kernel on the card fails
   the run); for one depth-1 serve of each path, the device-busy
   and idle share, the device time by kernel and the engine's host spans
   (plan / stage / dispatch / complete), and the host's self time by
   operator and CUDA runtime call; the same for one continuous depth-1
   serve of the LM, with the decode and prefill kernels' device time and
   launches, each and together, against its device busy time.
6. A ``kernels`` JSON line (one entry per C entry point, with the library
   call's device time as ``library_device_ms``; ``launches``
   summed over the last timed serve of each path, the LM's continuous
   depth-1 serve for the causal kernels, whose entries list each of their
   shapes under ``cases`` and head with the first), then the last line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense): fp32 on CUDA cores,
# fp16 or bf16 operands with fp32 accumulation on tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_FP16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, samples: int = 21, calls: int = 10, warmup: int = 5) -> float:
    """Per-call time of ``fn`` on the card's clock: CUDA events around
    ``calls`` back-to-back calls, divided by ``calls``; the median of
    ``samples`` such runs after ``warmup`` calls. A call whose host-side
    dispatch outlasts its device work is timed at its dispatch rate."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(samples):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / calls)
    return statistics.median(ts)


def bound_ms(n_bytes: float, n_ops: float, n_ops_f16: float = 0.0):
    """The least time of a call on the card: the larger of its bytes over
    the HBM rate and its operations over their peak rate. ``n_ops`` need
    fp32 (CUDA cores); ``n_ops_f16`` are products of two fp16 (or two
    bf16) values, exact in fp32, so they could run on the 16-bit tensor
    cores with fp32 accumulation, alongside the CUDA cores."""
    t_bytes = n_bytes / PEAK_HBM_BYTES * 1e3
    t_ops = max(n_ops / PEAK_FP32_FLOPS, n_ops_f16 / PEAK_FP16_FLOPS) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
SBMM_SHAPE = (788, 384, 384, 16)  # M, K, N, b


def host_ms(torch, fn, calls: int = 200) -> float:
    """Host time per call of ``fn``: the host's clock around ``calls``
    calls issued back to back without waiting on the card (the card keeps
    up, so this is what issuing one call costs the host)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return dt


def check_sbmm(torch, dev):
    """The four SBMM entry points on one packed weight: fp32 blocks, fp16
    blocks, int8 blocks with per-block and per-channel scales; each
    against its plain version, and each row of the 788-row call recomputed
    alone (M = 1) bitwise equal to it."""
    import numpy as np
    from repro_torch.core import block_pruning as BP
    from repro_torch.core import quant as Q
    from repro_torch.core.packing import pack_weight
    from repro_torch.kernels import backend
    from repro_torch.kernels.sbmm import (pad_input, sbmm, sbmm_plain,
                                          sbmm_quant_plain)
    M, K, N, b = SBMM_SHAPE
    g = torch.Generator().manual_seed(1)
    w = torch.randn((K, N), generator=g) * 0.05
    mask = BP.hard_block_mask(torch.randn(BP.score_shape((K, N), b),
                                          generator=g), 0.5, (K, N), b)
    pw = pack_weight(w.numpy(), mask.numpy().astype(bool), b, device=dev)
    require(not np.array_equal(pw.col_perm, np.arange(pw.n_cols)),
            "sbmm check needs a non-identity col_perm")
    x = torch.randn((M, K), generator=g).to(dev)
    kept = int((pw.header >= 0).sum())
    stream_us = (host_ms(torch, lambda: torch.cuda.current_stream(
        dev).cuda_stream, 2000) * 1e3, host_ms(
        torch, lambda: backend.current_stream(dev), 2000) * 1e3)
    print(f"host: reading the current stream {stream_us[0]:.3f} us per call "
          f"through torch.cuda.current_stream(dev).cuda_stream, "
          f"{stream_us[1]:.3f} us through backend.current_stream", flush=True)
    variants = (("sbmm_f32", pw, "sbmm.cu"),
                ("sbmm_f16w", Q.quantize_packed(pw, "fp16"), "sbmm.cu"),
                ("sbmm_i8_block", Q.quantize_packed(pw, "int8", "block"),
                 "sbmm_quant.cu"),
                ("sbmm_i8_channel", Q.quantize_packed(pw, "int8", "channel"),
                 "sbmm_quant.cu"))
    checks = []
    for name, q, src in variants:
        quant = isinstance(q, Q.QuantizedPackedWeight)

        def plain(q=q, quant=quant):
            xp = pad_input(x, q)
            return (sbmm_quant_plain(xp, q.blocks, q.header, q.scales,
                                     q.col_map, N) if quant
                    else sbmm_plain(xp, q.blocks, q.header, q.col_map, N))

        y, ref = sbmm(x, q), plain()
        torch.cuda.synchronize()
        require(y.shape == (M, N) and y.is_contiguous(),
                f"{name}: output {tuple(y.shape)}, not [{M}, {N}] contiguous")
        err = (y - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item()
        split = [r for r in range(M) if not torch.equal(sbmm(x[r:r + 1], q)[0],
                                                         y[r])]
        require(not split, f"{name}: {len(split)} of {M} rows computed alone "
                           f"(M = 1) differ bitwise from the {M}-row call, "
                           f"first {split[:1]}")
        w_dense = q.to_dense().float()  # dequantized: the library's input

        def library(w_dense=w_dense):
            return x @ w_dense

        n_bytes = (4 * (x.numel() + pw.header.numel() + M * N)
                   + q.blocks.numel() * q.blocks.element_size()
                   + (q.scales.numel() * 4 if quant else 0)
                   + 8 * pw.n_cols)
        n_ops = 2 * M * b * b * kept + (b * b * kept if quant else 0)
        bnd, by = bound_ms(n_bytes, n_ops)
        checks.append(dict(
            name=name, source=src,
            errs=[("y", err, tol, "1e-4 x max|plain|")],
            fn=lambda q=q: sbmm(x, q),
            ms=time_ms(lambda q=q: sbmm(x, q)), plain_ms=time_ms(plain),
            library_fn=library, library_ms=time_ms(library),
            library_call="x @ W_dense (cuBLAS fp32 on the dequantized "
                         "weight)",
            host=(host_ms(torch, lambda q=q: sbmm(x, q)),
                  host_ms(torch, library)),
            bound_ms=bnd, bound_by=by,
            shapes=f"x[{M},{K}] blocks{list(q.blocks.shape)} "
                   f"{str(q.blocks.dtype)[6:]} kept={kept}; rows at M=1 "
                   f"bitwise those at M={M}"))
    return checks


# the non-causal kernels' edge cases (B, N, H, Dh, kv_len): rows without a
# key (kv_len <= 0: all N keys alike, as the reference's NEG_INF mask
# gives) beside a one-key row and a kv_len past N at the main path's
# shape, and the reduced DeiT's Dh 16 at N = 17 and 65
FLASH_EDGE_CASES = (
    (4, 197, 6, 64, (0, -2, 1, 202)),
    (4, 17, 6, 16, (17, 9, 1, 0)),
    (4, 65, 6, 16, (65, 40, 17, 0)),
)
FLASH_PAD = 13  # tokens of padding past kv_len[b] in the row-bits check


def check_flash_attention(torch, dev, half: bool):
    """One non-causal entry point (fp32 or fp16 operands) at the main
    path's shape against the plain version: o within 1e-4 (fp32) or 2e-3
    (fp16) of the largest plain element, the head-mean scores within 1e-4
    of theirs, exactly 0 at masked keys, all finite; the same gates on
    ``FLASH_EDGE_CASES``; and each row of the main call bitwise equal to
    the row computed alone (B = 1) and with ``FLASH_PAD`` tokens of
    padding past its ``kv_len``."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention)
    B, N, H, Dh = 4, 197, 6, 64
    lens = (197, 170, 140, 50)
    g = torch.Generator().manual_seed(2)
    dt = torch.float16 if half else torch.float32
    name = "flash_attention_f16" if half else "flash_attention_f32"
    q, k, v = (torch.randn((B, N, H, Dh), generator=g).to(dev, dt)
               for _ in range(3))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    # fp16 output: both sides round fp32 sums taken in another order to
    # fp16, so an element may differ by one fp16 ulp (2e-3 as the CPU
    # parity test of the fp16 tier)
    rule_o = "2e-3" if half else "1e-4"

    def gate(label, q, k, v, kv_len):
        """(o, scores) of the kernel and its errors against the plain
        version's, with their tolerances."""
        o, sc = flash_attention(q, k, v, kv_len, collect_scores=True)
        o_ref, p_ref = attention_plain(q, k, v, kv_len)
        sc_ref = p_ref.mean(dim=1)
        torch.cuda.synchronize()
        require(o.dtype == dt and sc.dtype == torch.float32,
                f"{name} ({label}): output {o.dtype}, scores {sc.dtype}")
        require(bool(torch.isfinite(o.float()).all())
                and bool(torch.isfinite(sc).all()),
                f"{name} ({label}): an output or score is not finite")
        for bi, L in enumerate(kv_len.tolist()):
            require(L <= 0 or bool((sc[bi, L:] == 0).all()),
                    f"{name} ({label}): nonzero score at a masked key "
                    f"(row {bi})")
        at = "" if label == "main" else f" ({label})"
        return o, sc, [
            ("o" + at, (o.float() - o_ref.float()).abs().max().item(),
             float(rule_o) * o_ref.float().abs().max().item(),
             f"{rule_o} x max|plain|"),
            ("scores" + at, (sc - sc_ref).abs().max().item(),
             1e-4 * sc_ref.abs().max().item(), "1e-4 x max|plain|")]

    o, sc, errs = gate("main", q, k, v, kv_len)
    for bi in range(B):
        rows = [t[bi:bi + 1] for t in (q, k, v)]
        one = flash_attention(*rows, kv_len[bi:bi + 1], collect_scores=True)
        pad = [torch.cat([t, torch.randn((1, FLASH_PAD, H, Dh), generator=g)
                          .to(dev, dt)], dim=1) for t in rows]
        padded = flash_attention(*pad, kv_len[bi:bi + 1],
                                 collect_scores=True)
        require(torch.equal(one[0][0], o[bi]) and
                torch.equal(one[1][0], sc[bi]),
                f"{name}: row {bi} computed alone (B = 1) differs bitwise "
                f"from the B = {B} call")
        require(torch.equal(padded[0][0, :N], o[bi]) and
                torch.equal(padded[1][0, :N], sc[bi]) and
                bool((padded[1][0, N:] == 0).all()),
                f"{name}: row {bi} with {FLASH_PAD} tokens of padding past "
                f"kv_len differs bitwise")
    for eb, en, eh, ed, elens in FLASH_EDGE_CASES:
        eq, ek, ev = (torch.randn((eb, en, eh, ed), generator=g).to(dev, dt)
                      for _ in range(3))
        errs += gate(f"N={en} Dh={ed} kv_len={list(elens)}", eq, ek, ev,
                     torch.tensor(elens, dtype=torch.int32, device=dev))[2]

    def plain():
        o, probs = attention_plain(q, k, v, kv_len)
        return o, probs.mean(dim=1)

    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    amask = (torch.arange(N, device=dev)[None, :]
             < kv_len[:, None])[:, None, None, :]
    sum_len = sum(lens)
    # Q K^T and P V take 2 N sum_len H Dh operations each. With fp16
    # operands both run on the fp16 tensor cores: Q K^T multiplies two fp16
    # values (exact in fp32), P V two fp16 halves of the fp32 P by V, so it
    # is counted twice; with fp32 operands both run on the CUDA cores.
    n_qk = n_pv = 2 * N * sum_len * H * Dh
    n_rest = 2 * sum_len * H * Dh
    elt = 2 if half else 4
    n_bytes = (elt * (2 * B * N * H * Dh + 2 * sum_len * H * Dh)
               + 4 * (B + B * N))
    bnd, by = (bound_ms(n_bytes, n_rest, n_qk + 2 * n_pv) if half
               else bound_ms(n_bytes, n_qk + n_pv + n_rest))

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=amask)

    return dict(
        name=name, source="flash_attention.cu", errs=errs,
        fn=lambda: flash_attention(q, k, v, kv_len, collect_scores=True),
        ms=time_ms(lambda: flash_attention(q, k, v, kv_len,
                                           collect_scores=True)),
        plain_ms=time_ms(plain),
        library_fn=library, library_ms=time_ms(library),
        library_call=(f"F.scaled_dot_product_attention on {str(dt)[6:]} "
                      f"(bool key mask)"),
        bound_ms=bnd, bound_by=by,
        shapes=f"q,k,v[{B},{N},{H},{Dh}] {str(dt)[6:]} kv_len={list(lens)}; "
               f"rows bitwise alone and padded by {FLASH_PAD}")


def check_tensor_cores(backend):
    """Which kernels of ``flash_attention.cu`` issue tensor-core
    instructions, from their SASS: the fp32 tier's none (no TF32 or other
    split product), the fp16 tier's HMMA. Prints the count per kernel."""
    counts, fn = {}, None
    for line in backend.disassemble("flash_attention").splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {}
        elif fn is not None:
            for op in ("HMMA", "HGMMA", "IMMA", "DMMA"):
                if op in line:
                    counts[fn][op] = counts[fn].get(op, 0) + 1
    tiers = {}
    for fn, ops in counts.items():
        for tier in ("f32", "f16"):
            if f"flash_attention_{tier}_kernel" in fn:
                dh = fn.split("_kernelILi")[1].split("E")[0]
                tiers[f"flash_attention_{tier}_kernel<{dh}>"] = ops
    print("sass: tensor-core instructions per kernel " + json.dumps(tiers),
          flush=True)
    require(len(tiers) == 4, f"expected 4 non-causal kernels in the SASS, "
                             f"found {sorted(tiers)}")
    for kern, ops in tiers.items():
        if "_f32_" in kern:
            require(not ops, f"{kern} issues tensor-core instructions {ops}")
        else:
            require(ops.get("HMMA", 0) > 0, f"{kern} issues no HMMA")


# the causal kernels' cases at full-width Minitron-4B (24 query heads over 8
# KV heads, Dh 128, a 572-slot cache): a per-slot prefill of a 512-token
# bucket holding a prompt of 500 or 384 tokens (``flash_prefill_bf16``), a
# batch-4 decode and a decode row whose window spans all 9 of the cache's
# 64-key splits (``flash_decode_bf16``); the first case of each kernel is
# its headline
LM_CAUSAL_CASES = (
    ("prefill kv_start=12", 1, 512, [0], [512], [12]),
    ("prefill kv_start=128", 1, 512, [0], [512], [128]),
    ("decode", 4, 1, [129, 289, 419, 570], [130, 290, 420, 571],
     [32, 56, 0, 12]),
    ("decode 9 splits", 1, 1, [571], [572], [0]),
)
LM_DECODE = LM_CAUSAL_CASES[2]  # the serve's decode shape
BF16_ULP = 2.0 ** -7  # one bf16 ulp, relative to the largest element


def check_flash_attention_causal(torch, dev):
    """The two causal kernels, each through the wrapper at the LM path's
    shapes (``LM_CAUSAL_CASES``; the wrapper picks ``flash_decode_bf16``
    for one query row, ``flash_prefill_bf16`` for more) against the plain
    version: the output within one bf16 ulp of the largest plain element
    at rows with a valid key (both round fp32 sums taken in another order
    to bf16; left-pad rows have no key, where the kernel writes 0 and the
    plain version averages V: checked 0), the decode row's head-mean
    probabilities within 1e-6 and exactly 0 at masked keys, and two calls
    bitwise equal. Returns one entry per kernel, each case's numbers under
    ``cases``, the first case's as the entry's."""
    import torch.nn.functional as F
    from repro_torch.configs import MINITRON_4B
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import (attention_causal_plain,
                                                     flash_attention)
    Hq, KV, Dh = (MINITRON_4B.num_heads, MINITRON_4B.num_kv_heads,
                  MINITRON_4B.head_dim)
    S = 572
    g = torch.Generator().manual_seed(8)
    cases = {"flash_prefill_bf16": [], "flash_decode_bf16": []}
    for label, B, Nq, off, lens, starts in LM_CAUSAL_CASES:
        q = torch.randn((B, Nq, Hq, Dh), generator=g).to(dev, torch.bfloat16)
        k, v = (torch.randn((B, S, KV, Dh), generator=g).to(
            dev, torch.bfloat16) for _ in range(2))
        off_t, len_t, st_t = (torch.tensor(x, dtype=torch.int32, device=dev)
                              for x in (off, lens, starts))
        decode = Nq == 1
        name = "flash_decode_bf16" if decode else "flash_prefill_bf16"

        def kern(q=q, k=k, v=v, b=(off_t, len_t, st_t), decode=decode):
            return flash_attention(q, k, v, causal=True, q_offset=b[0],
                                   kv_len=b[1], kv_start=b[2],
                                   collect_scores=decode)

        def plain(q=q, k=k, v=v, b=(off_t, len_t, st_t), decode=decode):
            o, p = attention_causal_plain(q, k, v, *b, collect_probs=decode)
            return (o, p.mean(dim=1)) if decode else o

        before = backend.launches()[name]
        res, again, ref = kern(), kern(), plain()
        torch.cuda.synchronize()
        require(backend.launches()[name] == before + 2,
                f"causal attention ({label}) did not launch {name}")
        o, o_ref = (res[0], ref[0]) if decode else (res, ref)
        require(all(torch.equal(x, y) for x, y in zip(
            res if decode else (res,), again if decode else (again,))),
            f"{name} ({label}): two launches on the same inputs differ")
        require(o.dtype == torch.bfloat16
                and bool(torch.isfinite(o.float()).all()),
                f"{name} ({label}): output {o.dtype} or not finite")
        # keys row i of batch row b sees: [start, min(len, off + i + 1))
        seen = [[max(0, min(lens[b], off[b] + i + 1) - starts[b])
                 for i in range(Nq)] for b in range(B)]
        real = torch.tensor(seen, device=dev) > 0
        require(bool((o[~real] == 0).all()),
                f"{name} ({label}): a row without a key is not 0")
        d = (o.float() - o_ref.float()).abs().amax(dim=(2, 3))
        err_o = d[real].max().item()
        tol_o = BF16_ULP * o_ref.float()[real].abs().max().item()
        errs = [(f"o ({label})", err_o, tol_o,
                 "one bf16 ulp at max|plain|")]
        if decode:
            errs.append((f"probs ({label})",
                         (res[1] - ref[1]).abs().max().item(), 1e-6, ""))
            keys = torch.arange(S, device=dev)
            masked = (keys < st_t[:, None]) | (keys >= len_t[:, None])
            require(bool((res[1][masked] == 0).all()),
                    f"{name}: nonzero probability at a masked key")
        # the work these inputs need: every (row, head, valid key) pair
        # takes 2 Dh operations for Q.K (bf16 x bf16, exact in fp32: the
        # bf16 tensor-core rate), 2 Dh for P.V and ~4 for the softmax. The
        # prefill kernel runs P.V on the tensor cores as two bf16 products
        # (P split into hi and lo): 4 Dh at the bf16 rate; the decode
        # kernel keeps P fp32: 2 Dh at the fp32 rate. Bytes: q and o once,
        # the K/V window [start, len) once, the decode probabilities once.
        pairs = Hq * sum(map(sum, seen))
        window = sum(lens[b] - starts[b] for b in range(B))
        n_bytes = (2 * 2 * q.numel() + 2 * 2 * window * KV * Dh + 12 * B
                   + (4 * B * Hq * S if decode else 0))
        bnd, by = (bound_ms(n_bytes, (2 * Dh + 4) * pairs, 2 * Dh * pairs)
                   if decode else
                   bound_ms(n_bytes, 4 * pairs, 6 * Dh * pairs))
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        pos = off_t[:, None] + torch.arange(Nq, device=dev)
        keys = torch.arange(S, device=dev)
        amask = ((keys >= st_t[:, None, None]) & (keys < len_t[:, None, None])
                 & (keys <= pos[:, :, None]))[:, None]

        def library(qh=qh, kh=kh, vh=vh, amask=amask):
            return F.scaled_dot_product_attention(qh, kh, vh,
                                                  attn_mask=amask,
                                                  enable_gqa=True)

        cases[name].append(dict(
            label=label, errs=errs, fn=kern, ms=time_ms(kern),
            plain_ms=time_ms(plain), library_fn=library,
            library_ms=time_ms(library),
            bound_ms=bnd, bound_by=by,
            shapes=f"q[{B},{Nq},{Hq},{Dh}] k,v[{B},{S},{KV},{Dh}] bf16 "
                   f"q_offset={off if B > 1 else off[0]} kv_len={lens} "
                   f"kv_start={starts}"))
    checks = []
    for name, cs in cases.items():
        head = cs[0]
        checks.append(dict(
            name=name, source=f"{name[:-5]}.cu",
            errs=[e for c in cs for e in c["errs"]], fn=head["fn"],
            ms=head["ms"], plain_ms=head["plain_ms"],
            library_fn=head["library_fn"], library_ms=head["library_ms"],
            library_call="F.scaled_dot_product_attention(enable_gqa=True) "
                         "on bf16 (bool causal window mask)",
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            shapes="; ".join(f"{c['label']}: {c['shapes']}" for c in cs),
            cases=cs))
    return checks


def _tdm_scores(torch, dev, g, B, N, n_valid):
    s = torch.rand((B, N), generator=g)
    for bi, nv in enumerate(n_valid):
        s[bi, nv:] = 0.0  # token-padded rows score exactly 0
    return (s / s.sum(dim=1, keepdim=True)).to(dev)


def check_token_drop(torch, dev):
    from repro_torch.kernels.token_drop import token_drop, token_drop_plain
    B, N, D, k = 4, 197, 384, 138
    n_valid = (197, 180, 160, 140)
    g = torch.Generator().manual_seed(3)
    z = torch.randn((B, N, D), generator=g).to(dev)
    scores = _tdm_scores(torch, dev, g, B, N, n_valid)

    out, ref = token_drop(z, scores, k), token_drop_plain(z, scores, k)
    torch.cuda.synchronize()
    require(torch.equal(out[:, :k + 1], ref[:, :k + 1]),
            "token_drop: CLS/kept rows differ from the plain version")
    err = (out[:, k + 1] - ref[:, k + 1]).abs().max().item()
    n_bytes = 4 * (z.numel() + scores.numel() + B * (k + 2) * D)
    bnd, by = bound_ms(n_bytes, 2 * B * (N - 1) * D)
    return dict(
        name="token_drop_f32", source="token_drop.cu",
        errs=[("fused row", err, 1e-5, "kept rows bitwise")],
        fn=lambda: token_drop(z, scores, k),
        ms=time_ms(lambda: token_drop(z, scores, k)),
        plain_ms=time_ms(lambda: token_drop_plain(z, scores, k)),
        library_fn=None, library_ms=None, library_call=None,
        bound_ms=bnd, bound_by=by,
        shapes=f"z[{B},{N},{D}] k={k} n_valid={list(n_valid)}")


def check_token_package(torch, dev):
    """The soft TDM at the main path's first soft TDM (z [4, 197, 384],
    k = 138, no package yet) and at a later one (a token-padded tile of
    rows with 140, 120, 100 and 72 real tokens, the package of each at its
    own body index n_valid - 2, carried masses, k = 70); timed at the
    later one."""
    from repro_torch.kernels.token_package import (token_package,
                                                   token_package_plain)
    g = torch.Generator().manual_seed(4)
    D = 384
    cases = []
    for B, N, k, n_valid, has_pkg in ((4, 197, 138, (197, 180, 160, 140),
                                       False),
                                      (4, 140, 70, (140, 120, 100, 72),
                                       True)):
        z = torch.randn((B, N, D), generator=g).to(dev)
        scores = _tdm_scores(torch, dev, g, B, N, n_valid)
        mass = pos = None
        if has_pkg:
            mass = torch.rand((B,), generator=g).to(dev)
            pos = torch.tensor([n - 2 for n in n_valid], device=dev)
        out, m = token_package(z, scores, k, mass, pos)
        ref, m_ref = token_package_plain(z, scores, k, mass, pos)
        torch.cuda.synchronize()
        require(torch.equal(out[:, :k + 1], ref[:, :k + 1]),
                "token_package: CLS/kept rows differ from the plain version")
        cases.append(((out[:, k + 1] - ref[:, k + 1]).abs().max().item(),
                      (m - m_ref).abs().max().item()))
    n_bytes = 4 * (z.numel() + scores.numel() + B * (k + 2) * D + 3 * B)
    bnd, by = bound_ms(n_bytes, 2 * B * (N - 1) * D + B * (N - 1))
    return dict(
        name="token_package_f32", source="token_package.cu",
        errs=[("package row", max(c[0] for c in cases), 1e-5,
               "kept rows bitwise"),
              ("new_mass", max(c[1] for c in cases), 1e-5, "")],
        fn=lambda: token_package(z, scores, k, mass, pos),
        ms=time_ms(lambda: token_package(z, scores, k, mass, pos)),
        plain_ms=time_ms(lambda: token_package_plain(z, scores, k, mass,
                                                     pos)),
        library_fn=None, library_ms=None, library_call=None,
        bound_ms=bnd, bound_by=by,
        shapes=f"z[4,197,{D}] k=138 (first); z[{B},{N},{D}] k={k} "
               f"n_valid={list(n_valid)} with package (timed)")


# ---------------------------------------------------------------------------
# Phase 4: main path
# ---------------------------------------------------------------------------
REPEATS = 5       # timed serves of the fp32 stream per pipeline depth
TIER_REPEATS = 3  # timed serves of each tier's soft stream
# the entry points each serving path must launch in every serve
PATH_KERNELS = {
    "fp32": ("sbmm_f32", "flash_attention_f32", "token_drop_f32"),
    "fp16": ("sbmm_f16w", "flash_attention_f16", "token_drop_f32",
             "token_package_f32"),
    "int8": ("sbmm_i8_channel", "flash_attention_f32", "token_drop_f32",
             "token_package_f32"),
    "int8-block": ("sbmm_i8_block", "flash_attention_f32", "token_drop_f32",
                   "token_package_f32"),
}
TIERS = (("fp16", "fp16", "channel"), ("int8", "int8", "channel"),
         ("int8-block", "int8", "block"))  # (path, precision, granularity)


def make_engine(cfg, params, scores, depth, dev, tracer=None,
                precision="fp32", granularity="channel"):
    from repro_torch.serving.vision import VisionEngine, VisionEngineConfig
    return VisionEngine.from_pruned(
        cfg, params, scores, device=dev, tracer=tracer,
        vc=VisionEngineConfig(max_batch=4, planner="full",
                              pipeline_depth=depth, precision=precision,
                              quant_granularity=granularity))


PIPE_KEYS = ("steps", "pipeline_block_s", "pipeline_dispatch_s",
             "pipeline_overlap_hits", "dispatch_fp32", "dispatch_fp16",
             "dispatch_int8", "dequant_dispatches", "plan_precision_fp32",
             "plan_precision_fp16", "plan_precision_int8")


def serve_stream(torch, backend, eng, soft=False):
    """Serve the 16-request stream once on ``eng`` (with ``soft``, every
    other request soft-pruned): launch counts set to 0 just before and
    read just after; the host's waits on the card other than the
    pipeline's events (blocking copies, ``.item()``) counted by PyTorch's
    sync debug mode. Returns (requests, {uid: logits}, wall seconds,
    launch counts, {engine steps, pipeline block / dispatch seconds and
    overlap hits, dispatches and admissions per precision, and
    ``host_syncs``, of this serve})."""
    from repro_torch.launch.serve_vision import make_requests
    reqs = make_requests(eng.cfg, 16, arrival_spread=4, seed=0)
    for r in reqs:
        r.soft_prune = soft and r.uid % 2 == 0
    before = eng.stats()
    torch.cuda.synchronize()
    backend.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = eng.serve(reqs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = backend.launches()
    after = eng.stats()
    pipe = {k: after[k] - before[k] for k in PIPE_KEYS}
    pipe["host_syncs"] = sum("synchronizing CUDA operation" in str(w.message)
                             for w in caught)
    return reqs, out, dt, counts, pipe


# engine vs offline oracle, relative to max(1, |ref|), per tier. The fp32
# and int8 tiers keep fp32 activations: the engine differs from the
# unbatched oracle only where cuBLAS picks another algorithm for another
# row count (1.0e-6 measured). At fp16 such differences can flip the fp16
# rounding of q/k/v elements and attention outputs (one fp16 ulp is up to
# ~1e-3 relative to the element) and the flips carry through the later
# layers: the engine measured 2.19e-4, so the tier is held to 5e-4.
# ``rounding_witness`` measures the same effect on the oracle alone.
ORACLE_TOL = {"fp32": 1e-4, "int8": 1e-4, "fp16": 5e-4}


def check_against_oracle(torch, cfg, eng, reqs, out, precision, label):
    """Every request against the offline forward at its soft flag and the
    path's tier: ``ORACLE_TOL`` relative to max(1, |ref|), top-1 equal.
    Returns the largest relative difference."""
    import numpy as np
    from repro_torch.core import packed_runner as PR
    tol = ORACLE_TOL[precision]
    worst = 0.0
    for r in reqs:
        require(out[r.uid].shape == (cfg.num_classes,)
                and bool(np.isfinite(out[r.uid]).all()),
                f"{label}: uid {r.uid} logits not finite/shaped")
        ref = PR.forward_vit_packed(
            cfg, eng.segments.params, eng.segments.packed, r.patches[None],
            segments=eng.segments, soft=r.soft_prune, precision=precision,
            schedule=PR.keep_schedule(cfg, r_t=r.r_t)).logits[0]
        ref = ref.cpu().numpy()
        err = float(np.abs(out[r.uid] - ref).max())
        scale = max(1.0, float(np.abs(ref).max()))
        worst = max(worst, err / scale)
        require(err <= tol * scale, f"{label}: uid {r.uid}: engine vs "
                                    f"offline oracle max|d|={err:.3g} > "
                                    f"{tol}*{scale:.3g}")
        require(int(np.argmax(out[r.uid])) == int(np.argmax(ref)),
                f"{label}: uid {r.uid}: top-1 differs from the offline "
                f"oracle")
    print(f"{label}: engine vs offline forward_vit_packed: top-1 "
          f"{len(reqs)}/{len(reqs)} equal, max|d|/max(1,max|ref|) = "
          f"{worst:.3g} (tolerance {tol})", flush=True)
    return worst


def rounding_witness(torch, cfg, eng, reqs, precision, label):
    """How far the offline oracle alone moves when a random half of its
    input elements move by one fp32 ulp, the size of a change of
    summation order: at ``precision`` and at fp32, relative to max(1,
    |ref|), each request at its soft flag. Printed, not checked."""
    import numpy as np
    from repro_torch.core import packed_runner as PR
    rng = np.random.default_rng(5)
    moved = {}
    for prec in (precision, "fp32"):
        worst = 0.0
        for r in reqs:
            x = r.patches[None]
            x_ulp = np.where(rng.random(x.shape) < 0.5,
                             np.nextafter(x, np.float32(np.inf)), x)
            ys = [PR.forward_vit_packed(
                cfg, eng.segments.params, eng.segments.packed, xi,
                segments=eng.segments, soft=r.soft_prune, precision=prec,
                schedule=PR.keep_schedule(cfg, r_t=r.r_t)).logits[0]
                for xi in (x, x_ulp)]
            err = (ys[1] - ys[0]).abs().max().item()
            worst = max(worst, err / max(1.0, ys[0].abs().max().item()))
        moved[prec] = worst
    print(f"{label}: offline oracle moved by one fp32 ulp on half its "
          f"inputs: max|d|/max(1,max|ref|) = {moved[precision]:.3g} at "
          f"{precision}, {moved['fp32']:.3g} at fp32", flush=True)
    return moved


def require_launched(counts, path, label):
    for name in PATH_KERNELS[path]:
        require(counts[name] > 0, f"{label}: kernel {name} never launched "
                                  f"on the {path} path")


def print_serve(label, out, walls, counts, syncs, pipe):
    dt = statistics.median(walls)
    steps = pipe["steps"]
    print(f"{label}: {len(out)} images, {steps} steps; wall over "
          f"{len(walls)} serves median {dt:.4f} s (min {min(walls):.4f}, "
          f"max {max(walls):.4f}): {len(out) / dt:.2f} images/s, "
          f"{dt / steps * 1e3:.3f} ms/step; launches per serve="
          f"{ {k: v for k, v in counts.items() if v} }; host syncs besides "
          f"the step events per serve (warm-up first)={syncs}; last serve: "
          f"dispatch {pipe['pipeline_dispatch_s'] * 1e3:.2f} ms, block on "
          f"events {pipe['pipeline_block_s'] * 1e3:.2f} ms, "
          f"{pipe['pipeline_overlap_hits']}/{steps} steps done before their "
          f"completion; dispatches fp32/fp16/int8 "
          f"{pipe['dispatch_fp32']}/{pipe['dispatch_fp16']}/"
          f"{pipe['dispatch_int8']}, dequant {pipe['dequant_dispatches']}",
          flush=True)
    return dt


def main_path(torch, dev):
    """Returns ({path: launch counts of its last timed serve}, {path: host
    syncs per serve}, the model, {path: median wall of its serves})."""
    import numpy as np
    from repro_torch.configs import DEIT_SMALL
    from repro_torch.core import packed_runner as PR
    from repro_torch.kernels import backend
    from repro_torch.models import model as M
    from repro_torch.models import pruning_glue as PG

    cfg = DEIT_SMALL
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    scores = PG.init_scores(cfg, params, torch.Generator().manual_seed(7))
    runs, syncs, path_counts, walls_by = {}, {}, {}, {}
    # (a) fp32, hard TDM, pipeline depths 1 and 2
    for depth in (1, 2):
        eng = make_engine(cfg, params, scores, depth, dev)
        key = f"fp32 depth {depth}"
        syncs[key] = [serve_stream(torch, backend, eng)[4]["host_syncs"]]
        walls = []  # warm-up serve above
        for _ in range(REPEATS):
            reqs, out, dt, counts, pipe = serve_stream(torch, backend, eng)
            require(sorted(out) == [r.uid for r in reqs],
                    f"{key}: not every request was served")
            require_launched(counts, "fp32", key)
            walls.append(dt)
            syncs[key].append(pipe["host_syncs"])
        walls_by[key] = print_serve(f"main path {key}", out, walls, counts,
                                    syncs[key], pipe)
        runs[depth] = (eng, reqs, out)
        if depth == 1:
            path_counts["fp32"] = counts

    eng, reqs, out = runs[1]
    check_against_oracle(torch, cfg, eng, reqs, out, "fp32", "fp32 depth 1")
    out2 = runs[2][2]
    d12 = max(float(np.abs(out[u] - out2[u]).max()) for u in out)
    require(d12 <= 1e-5, f"depth 1 vs 2: max|d|={d12:.3g} > 1e-5")
    require(all(int(np.argmax(out[u])) == int(np.argmax(out2[u]))
                for u in out), "depth 1 vs 2: top-1 differs")
    print(f"depth 1 vs depth 2: top-1 16/16 equal, max|d| = {d12:.3g} "
          f"(tolerance 1e-5)", flush=True)

    # kernels against the plain masked-dense model, token pruning off (no
    # top-k, so no near-tie can flip a selection between the two)
    n_patches = (cfg.image_size // cfg.patch_size) ** 2
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, n_patches, cfg.patch_size ** 2 * 3)),
        dtype=torch.float32).to(dev)
    y = PR.forward_vit_packed(cfg, eng.segments.params, eng.segments.packed,
                              x, use_tdm=False, device=dev).logits
    y_ref = PR.masked_dense_reference(cfg, params, scores, x,
                                      use_tdm=False).logits
    err = (y - y_ref).abs().max().item()
    scale = max(1.0, y_ref.abs().max().item())
    require(err <= 1e-4 * scale, f"packed vs masked-dense: max|d|={err:.3g}")
    require(bool((y.argmax(-1) == y_ref.argmax(-1)).all()),
            "packed vs masked-dense: top-1 differs")
    print(f"packed (kernels) vs masked-dense (plain), no TDM: max|d| = "
          f"{err:.3g} (tolerance 1e-4 x {scale:.3g})", flush=True)

    # (b) the fp16 and int8 tiers, every other request soft-pruned
    for path, precision, granularity in TIERS:
        eng = make_engine(cfg, params, scores, 1, dev, precision=precision,
                          granularity=granularity)
        key = f"{path} soft"
        syncs[key] = [serve_stream(torch, backend, eng,
                                   soft=True)[4]["host_syncs"]]
        walls = []
        for _ in range(TIER_REPEATS):
            reqs, out, dt, counts, pipe = serve_stream(torch, backend, eng,
                                                       soft=True)
            require(sorted(out) == [r.uid for r in reqs],
                    f"{key}: not every request was served")
            require_launched(counts, path, key)
            require(pipe[f"plan_precision_{precision}"] == len(reqs),
                    f"{key}: {pipe[f'plan_precision_{precision}']} of "
                    f"{len(reqs)} requests admitted at {precision}")
            require(pipe[f"dispatch_{precision}"] > 0,
                    f"{key}: no dispatch at {precision}")
            require((pipe["dequant_dispatches"] > 0) == (precision == "int8"),
                    f"{key}: dequant dispatches "
                    f"{pipe['dequant_dispatches']}")
            walls.append(dt)
            syncs[key].append(pipe["host_syncs"])
        walls_by[key] = print_serve(f"main path {key}", out, walls, counts,
                                    syncs[key], pipe)
        check_against_oracle(torch, cfg, eng, reqs, out, precision, key)
        if precision == "fp16":
            rounding_witness(torch, cfg, eng, reqs, precision, key)
        path_counts[path] = counts
    return path_counts, syncs, (cfg, params, scores, walls_by)


# ---------------------------------------------------------------------------
# Phase 4, LM: full-width Minitron-4B through ServeEngine
# ---------------------------------------------------------------------------
LM_PROMPTS = (96, 200, 384, 500)  # prompt lengths, twice over: 8 requests
LM_MAX_NEW, LM_MAX_BATCH, LM_MAX_LEN = 32, 4, 572
LM_REPEATS = 2    # timed serves of each LM path, in turns after warm-ups
# (label, continuous, EngineConfig overrides); the teacher-forced oracle
# holds the unpruned serves (pruning changes the function it computes)
LM_SERVES = (
    ("continuous depth 1", True, {}),
    ("continuous depth 2", True, dict(pipeline_depth=2)),
    ("continuous kv-prune", True, dict(kv_prune_keep=0.5,
                                       kv_prune_interval=4)),
    ("static waves", False, {}),
)
# the engine's token against the offline forward (no cache, B=1), per
# generated token: the largest logit at that position minus the logit of
# the engine's token. The engine batches 4 rows and reads a KV cache where
# the forward runs one 600-token sequence, so cuBLAS picks other bf16
# GEMMs and a rounding can flip; a wrong cache row, mask or RoPE phase
# would leave the engine's tokens near random (gaps of ~0.7 at this
# model's logit scale). 0.05 is the CPU bound of the port against the
# reference at bf16 (tests/test_torch_lm.py).
LM_ORACLE_TOL = 0.05
LM_KEYS = ("runner_prefill_calls", "runner_prefill_slot_calls",
           "runner_decode_calls", "prune_events", "pipeline_steps",
           "pipeline_block_s", "admissions")


def lm_requests(cfg):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=LM_MAX_NEW)
            for i, n in enumerate(LM_PROMPTS * 2)]


def serve_lm(torch, backend, eng, continuous):
    """Serve the 8-request stream once on ``eng``, launch counts set to 0
    just before and read just after, host waits besides the step events
    counted by PyTorch's sync debug mode. Returns (requests, outputs,
    wall seconds, launch counts, this serve's deltas of ``LM_KEYS`` plus
    ``host_syncs``)."""
    reqs = lm_requests(eng.cfg)
    before = eng.stats()
    torch.cuda.synchronize()
    backend.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = eng.serve(reqs, continuous=continuous)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = backend.launches()
    after = eng.stats()
    st = {k: after[k] - before[k] for k in LM_KEYS}
    st["host_syncs"] = sum("synchronizing CUDA operation" in str(w.message)
                           for w in caught)
    return reqs, out, dt, counts, st


def check_lm_oracle(torch, cfg, params, reqs, dev, label):
    """The teacher-forced oracle: for each request, ``forward_lm`` over the
    prompt plus the engine's tokens (no cache, B=1, ``logits_for="all"``);
    each engine token's logit within ``LM_ORACLE_TOL`` of its position's
    largest. Prints the share of exact argmax matches."""
    import numpy as np
    from repro_torch.models import model as M
    worst, exact, n = 0.0, 0, 0
    for r in reqs:
        seq = np.concatenate([r.prompt, r.generated[:-1]]).astype(np.int64)
        logits = M.forward_lm(cfg, params, torch.from_numpy(seq)[None].to(
            dev), logits_for="all").logits[0, len(r.prompt) - 1:]
        gen = torch.tensor(r.generated, device=dev)
        gap = logits.max(dim=1).values - logits.gather(1, gen[:, None])[:, 0]
        worst = max(worst, gap.max().item())
        exact += int((gap == 0).sum().item())
        n += len(r.generated)
    require(worst <= LM_ORACLE_TOL,
            f"{label}: an engine token's oracle logit lies {worst:.4g} below "
            f"its position's largest (tolerance {LM_ORACLE_TOL})")
    print(f"{label}: teacher-forced oracle: {exact}/{n} tokens the exact "
          f"argmax ({exact / n:.3f}), largest gap {worst:.4g} (tolerance "
          f"{LM_ORACLE_TOL})", flush=True)
    return worst, exact / n


def lm_engine(cfg, params, dev, tracer=None, **kw):
    from repro_torch.serving import EngineConfig, ServeEngine
    return ServeEngine(cfg, params, EngineConfig(
        max_batch=LM_MAX_BATCH, max_len=LM_MAX_LEN, **kw), tracer=tracer,
        device=dev)


def lm_path(torch, dev):
    """Full-width Minitron-4B (random weights from seed 0, drawn on the
    card; the serving copy holds its matrices in bf16) serving 8 requests
    on each of ``LM_SERVES``. Returns ({"lm": launch counts of the last
    timed depth-1 serve}, {serve: host syncs per serve}, (cfg, params,
    {serve: median wall})."""
    from repro_torch.configs import MINITRON_4B
    from repro_torch.kernels import backend
    from repro_torch.models import model as M
    from repro_torch.obs import Tracer
    from repro_torch.serving.runner import serving_params
    cfg = MINITRON_4B
    t0 = time.perf_counter()
    params = serving_params(cfg, M.init_params(
        cfg, torch.Generator(dev).manual_seed(0), device=dev))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"lm: {cfg.name} at full width and depth ({cfg.num_layers} layers, "
          f"D={cfg.d_model}, {cfg.num_heads} query / {cfg.num_kv_heads} KV "
          f"heads, Dh={cfg.head_dim}, vocab {cfg.vocab_size}), "
          f"{n_params / 1e9:.3f} B params, bf16 serving copy made in "
          f"{time.perf_counter() - t0:.2f} s; "
          f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB allocated",
          flush=True)
    # every engine warmed up first, then the timed serves in turns, so the
    # paths share the host's load alike
    engines, tracers, syncs, walls, last = {}, {}, {}, {}, {}
    for label, continuous, kw in LM_SERVES:
        tracers[label] = Tracer()
        engines[label] = lm_engine(cfg, params, dev, tracer=tracers[label],
                                   **kw)
        syncs[label] = [serve_lm(torch, backend, engines[label],
                                 continuous)[4]["host_syncs"]]
        walls[label] = []
    for _ in range(LM_REPEATS):
        for label, continuous, kw in LM_SERVES:
            n_warm = len(tracers[label].span_log)
            reqs, out, dt, counts, st = serve_lm(torch, backend,
                                                 engines[label], continuous)
            walls[label].append(dt)
            syncs[label].append(st["host_syncs"])
            require(sorted(out) == list(range(len(reqs)))
                    and all(len(t) == LM_MAX_NEW for t in out.values()),
                    f"lm {label}: not every request got {LM_MAX_NEW} tokens")
            calls = (st["runner_prefill_calls"]
                     + st["runner_prefill_slot_calls"])
            require(calls > 0 and st["runner_decode_calls"] > 0,
                    f"lm {label}: prefill or decode never ran: {st}")
            n_dec = counts["flash_decode_bf16"]
            n_pre = counts["flash_prefill_bf16"]
            require(n_dec == cfg.num_layers * st["runner_decode_calls"]
                    and n_pre == cfg.num_layers * calls,
                    f"lm {label}: flash_decode_bf16 / flash_prefill_bf16 "
                    f"launched {n_dec} / {n_pre} times, not once per layer "
                    f"of every decode / prefill call "
                    f"({cfg.num_layers * st['runner_decode_calls']} / "
                    f"{cfg.num_layers * calls})")
            if kw.get("kv_prune_keep", 1.0) < 1.0:
                require(st["prune_events"] >= 1,
                        f"lm {label}: no KV prune fired")
            last[label] = (reqs, out, counts, st, n_warm)
    walls_by, tokens = {}, {}
    for label, continuous, _ in LM_SERVES:
        reqs, out, counts, st, n_warm = last[label]
        wall = statistics.median(walls[label])
        calls = st["runner_prefill_calls"] + st["runner_prefill_slot_calls"]
        steps = (st["pipeline_steps"] if continuous
                 else calls + st["runner_decode_calls"])
        dec = [sp for sp in tracers[label].span_log[n_warm:]
               if sp["attrs"].get("label") == "lm-decode"]
        dec_ms = (sum(sp["dur_ms"] for sp in dec) / st["runner_decode_calls"]
                  if dec else float("nan"))
        n_tok = sum(len(t) for t in out.values())
        print(f"lm {label}: {len(out)} requests x {LM_MAX_NEW} tokens, "
              f"{steps} steps ({calls} prefill calls, "
              f"{st['runner_decode_calls']} decode steps); wall over "
              f"{len(walls[label])} serves "
              f"{[round(w, 4) for w in walls[label]]} median {wall:.4f} s: "
              f"{n_tok / wall:.2f} tokens/s, "
              f"{wall / steps * 1e3:.3f} ms/step; decode step dispatch + "
              f"completion {dec_ms:.3f} ms (pipeline spans; a step latency "
              f"at depth 1 only), block on step events "
              f"{st['pipeline_block_s'] * 1e3:.2f} ms in all; prune events "
              f"{st['prune_events']}; kernel launches decode / prefill "
              f"{counts['flash_decode_bf16']} / "
              f"{counts['flash_prefill_bf16']}; host syncs besides "
              f"the step events per serve (warm-up first)={syncs[label]}",
              flush=True)
        walls_by[label] = wall
        tokens[label] = (reqs, out)
    require(tokens["continuous depth 1"][1] == tokens["continuous depth 2"][1],
            "lm: depth 1 and depth 2 gave different tokens")
    print("lm: depth 1 and depth 2 tokens identical (8/8 requests)",
          flush=True)
    for label in ("continuous depth 1", "static waves"):
        check_lm_oracle(torch, cfg, params, tokens[label][0], dev,
                        f"lm {label}")
    # one batch-4 decode step on the card, timed alone: every live slot at
    # the decode check's lengths
    from repro_torch.models import steps as ST
    eng = lm_engine(cfg, params, dev)
    caches = ST.init_caches(cfg, LM_MAX_BATCH, LM_MAX_LEN, device=dev)
    lens = torch.tensor(LM_DECODE[4], dtype=torch.int32, device=dev) - 1
    caches = [c._replace(length=lens.clone()) for c in caches]
    starts = torch.tensor(LM_DECODE[5], dtype=torch.int32, device=dev)
    toks = torch.zeros((LM_MAX_BATCH,), dtype=torch.int64, device=dev)
    step_ms = time_ms(lambda: eng.runner.decode(toks, caches, starts),
                      samples=5, calls=5, warmup=2)
    print(f"lm: one decode step alone (B=4, 572-slot cache, windows of "
          f"{LM_DECODE[4]} keys): {step_ms:.3f} ms", flush=True)
    return ({"lm": last["continuous depth 1"][2]}, syncs,
            (cfg, params, walls_by))


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# Phase 5: device time by kernel, busy share, host spans (torch.profiler)
# ---------------------------------------------------------------------------
def kernel_symbol(entry_point: str) -> str:
    """The CUDA kernel an entry point launches (``csrc/*.cu``)."""
    return f"{entry_point}_kernel"


def _device_rows(prof):
    """(name, calls, device us) per profiler entry that ran on the card
    (kernels, copies). The CPU-side operators that launched them carry the
    same device time and are left out, so nothing is counted twice."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.count, float(e.self_device_time_total))
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    return sorted(rows, key=lambda r: -r[2])


def _host_rows(prof):
    """(name, calls, host us) per profiler entry that ran on the host
    (operators and CUDA runtime calls), by self time: where the host's
    share of the wall goes (inflated alike by the profiler)."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.count, float(e.self_cpu_time_total))
            for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.self_cpu_time_total]
    return sorted(rows, key=lambda r: -r[2])


def report_profile(prof, dt, wall, tracer, n_warm, label, what):
    """Print one profiled serve: device busy time and idle share against
    the profiled wall ``dt`` and the unprofiled median ``wall`` (the
    profiler slows the host, not the card), device time per kernel entry
    point, the engine's host spans after the first ``n_warm``, and the
    largest device and host entries."""
    from repro_torch.kernels import backend
    wall_us = dt * 1e6
    rows = _device_rows(prof)
    busy_us = sum(r[2] for r in rows)
    spans = {}
    for sp in tracer.span_log[n_warm:]:
        spans[sp["name"]] = spans.get(sp["name"], 0.0) + sp["dur_ms"]
    print(f"profile {label} ({what}, {sum(r[1] for r in rows)} device "
          f"launches): wall {wall_us:.0f} us profiled / {wall * 1e6:.0f} us "
          f"unprofiled median, device busy {busy_us:.0f} us, idle share "
          f"{1.0 - busy_us / wall_us:.3f} profiled / "
          f"{1.0 - busy_us / (wall * 1e6):.3f} unprofiled; host spans (ms) "
          + json.dumps({k: round(v, 3) for k, v in spans.items()}),
          flush=True)
    for name in backend.ENTRY_POINTS:
        mine = [r for r in rows if kernel_symbol(name) in r[0]]
        if mine:
            print(f"  {name}: {sum(r[1] for r in mine)} launches, "
                  f"{sum(r[2] for r in mine):.1f} us on the card", flush=True)
    for n, k, us in rows[:12]:
        print(f"  device {us:9.1f} us  {k:5d} calls  {n[:90]}", flush=True)
    for n, k, us in _host_rows(prof)[:15]:
        print(f"  host   {us:9.1f} us  {k:5d} calls  {n[:90]}", flush=True)
    return rows, busy_us


def profile_serve(torch, dev, cfg, params, scores, wall, label, soft=False,
                  precision="fp32", granularity="channel"):
    """For one depth-1 serve of a vision path: ``report_profile``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import backend
    from repro_torch.obs import Tracer
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    tracer = Tracer()
    eng = make_engine(cfg, params, scores, 1, dev, tracer=tracer,
                      precision=precision, granularity=granularity)
    serve_stream(torch, backend, eng, soft=soft)  # warm-up
    n_warm = len(tracer.span_log)
    with profile(activities=acts) as prof:
        _, _, dt, counts, pipe = serve_stream(torch, backend, eng, soft=soft)
    report_profile(prof, dt, wall, tracer, n_warm, label,
                   f"depth 1, 16 images, {pipe['steps']} steps")


def profile_lm(torch, dev, cfg, params, walls):
    """For one depth-1 continuous serve of the LM: ``report_profile``, then
    the causal kernels' device time and launches, each and together,
    against the serve's device busy time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import backend
    from repro_torch.obs import Tracer
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    tracer = Tracer()
    eng = lm_engine(cfg, params, dev, tracer=tracer)
    serve_lm(torch, backend, eng, True)  # warm-up
    n_warm = len(tracer.span_log)
    with profile(activities=acts) as prof:
        _, _, dt, _, st = serve_lm(torch, backend, eng, True)
    rows, busy_us = report_profile(
        prof, dt, walls["continuous depth 1"], tracer, n_warm,
        "lm continuous", f"depth 1, 8 requests x {LM_MAX_NEW} tokens, "
        f"{st['pipeline_steps']} steps")
    causal = {name: [(k, us) for n, k, us in rows if kernel_symbol(name) in n]
              for name in ("flash_decode_bf16", "flash_prefill_bf16")}
    parts = [f"{name} {sum(k for k, _ in r)} launches "
             f"{sum(us for _, us in r) / 1e3:.3f} ms"
             for name, r in causal.items()]
    total_us = sum(us for r in causal.values() for _, us in r)
    print(f"profile lm continuous: causal attention {total_us / 1e3:.3f} ms "
          f"of {busy_us / 1e3:.3f} ms device busy "
          f"({total_us / busy_us:.3f}): " + ", ".join(parts), flush=True)


def profile_run(torch, dev, checks, cfg, params, scores, walls) -> None:
    """Device time per launch of each kernel entry point at the phase-3
    shapes (stored as ``c["device_ms"]``) and of its library call
    (``c["library_device_ms"]``, all the call's device work); an
    ``sbmm()`` call must run one device kernel and nothing else. Then one
    serve of each path (``profile_serve``)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    n = 20
    for check in checks:
        for c in check.get("cases", [check]):
            with profile(activities=acts) as prof:
                for _ in range(n):
                    c["fn"]()
                torch.cuda.synchronize()
            rows = _device_rows(prof)
            sym = kernel_symbol(check["name"])
            mine = [r for r in rows if sym in r[0]]
            require(bool(mine), f"profiler saw no {sym} launch")
            calls = sum(r[1] for r in mine)
            us = sum(r[2] for r in mine)
            if check["name"].startswith("sbmm"):
                others = [r for r in rows if sym not in r[0]]
                require(calls <= n and not others,
                        f"{n} sbmm() calls ran {calls} {sym} launches and "
                        f"other device work {others}: more than one kernel "
                        f"per call")
            c["device_ms"] = us / calls / 1e3
            c["max_abs_err"] = c["err"]
            c["library_device_ms"] = None
            if c["library_fn"] is not None:
                with profile(activities=acts) as prof:
                    for _ in range(n):
                        c["library_fn"]()
                    torch.cuda.synchronize()
                lib_rows = _device_rows(prof)
                c["library_device_ms"] = sum(r[2] for r in lib_rows) / n / 1e3
            lib = ("" if c["library_device_ms"] is None else
                   f"; library {c['library_device_ms'] * 1e3:.2f} us/call on "
                   f"the card ({sum(r[1] for r in lib_rows) / n:g} device "
                   f"launches per call)")
            print(f"profile {check['name']}"
                  + (f" ({c['label']})" if "label" in c else "")
                  + f": device {us / calls:.2f} us/launch ({calls} "
                  f"launches); wrapper {c['ms'] * 1e3:.2f} us/call" + lib,
                  flush=True)
        head = check.get("cases", [check])[0]
        check["device_ms"] = head["device_ms"]
        check["library_device_ms"] = head["library_device_ms"]
    profile_serve(torch, dev, cfg, params, scores, walls["fp32 depth 1"],
                  "main path fp32")
    for path, precision, granularity in TIERS:
        profile_serve(torch, dev, cfg, params, scores,
                      walls[f"{path} soft"], f"main path {path} soft",
                      soft=True, precision=precision,
                      granularity=granularity)


REPLACES = {  # the reference's pallas_call each kernel stands in for
    "sbmm.cu": "src/repro/kernels/sbmm/sbmm.py:75",
    "sbmm_quant.cu": "src/repro/kernels/sbmm/quant.py:80",
    "flash_attention.cu":
        "src/repro/kernels/flash_attention/flash_attention.py:92",
    "flash_decode.cu":
        "src/repro/kernels/flash_attention/flash_attention.py:92",
    "flash_prefill.cu":
        "src/repro/kernels/flash_attention/flash_attention.py:92",
    "token_drop.cu": "src/repro/kernels/token_drop/token_drop.py:62",
    "token_package.cu":
        "src/repro/kernels/token_package/token_package.py:68",
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        from repro_torch.kernels import backend
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing next to this "
              f"script ({ROOT}/src/repro_torch): {e}", file=sys.stderr)
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = backend.resolve_device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(dev)}", flush=True)

    build_s = backend.build(verbose=True)
    print(f"build: {build_s:.2f} s", flush=True)
    check_tensor_cores(backend)

    checks = [*check_sbmm(torch, dev),
              check_flash_attention(torch, dev, half=False),
              check_flash_attention(torch, dev, half=True),
              check_token_drop(torch, dev), check_token_package(torch, dev),
              *check_flash_attention_causal(torch, dev)]
    require(sorted(c["name"] for c in checks) == sorted(backend.ENTRY_POINTS),
            "a kernel entry point has no check")
    for check in checks:
        check["err"] = max(e[1] for e in check["errs"])
        for c in check.get("cases", [check]):
            c["err"] = max(e[1] for e in c["errs"])
            errs = "; ".join(f"{out}: max_abs_err={err:.3g} <= {tol:.3g}"
                             + (f" ({rule})" if rule else "")
                             for out, err, tol, rule in c["errs"])
            host = ("" if "host" not in c else
                    f" host_ms={c['host'][0]:.4f} (library "
                    f"{c['host'][1]:.4f}; issuing a call, no wait)")
            print(f"kernel {check['name']}: {c['shapes']} {errs} "
                  f"kernel_ms={c['ms']:.4f} plain_ms={c['plain_ms']:.4f} "
                  f"library_ms={c['library_ms']} ({check['library_call']}) "
                  f"bound_ms={c['bound_ms']:.5f} ({c['bound_by']})" + host,
                  flush=True)
        require(all(err <= tol for _, err, tol, _ in check["errs"]),
                f"kernel {check['name']} disagrees with its plain version")

    path_counts, syncs, model = main_path(torch, dev)
    lm_counts, lm_syncs, lm_model = lm_path(torch, dev)
    path_counts.update(lm_counts)
    syncs.update({f"lm {k}": v for k, v in lm_syncs.items()})
    profile_run(torch, dev, checks, *model)
    profile_lm(torch, dev, *lm_model)
    for key, n in syncs.items():
        require(not any(n), f"{key}: the engine waited on the card outside "
                            f"its step events: {n}")

    launches = {name: sum(c[name] for c in path_counts.values())
                for name in backend.ENTRY_POINTS}
    print(json.dumps({"kernels": [
        {"name": c["name"], "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{c['source']}",
         "replaces": REPLACES[c["source"]],
         "launches": launches[c["name"]], "max_abs_err": c["err"],
         "ms": c["ms"], "kernel_ms": c["ms"], "device_ms": c["device_ms"],
         "plain_ms": c["plain_ms"],
         "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
         "library_ms": c["library_ms"],
         "library_device_ms": c["library_device_ms"],
         **({"cases": [{k: case[k] for k in (
             "label", "max_abs_err", "ms", "device_ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms", "library_device_ms")}
             for case in c["cases"]]}
            if "cases" in c else {})} for c in checks]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
