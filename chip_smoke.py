#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port builds and serves on the card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. Device: require CUDA; print the card's name and power limit
   (``nvidia-smi``).
2. Build: compile the hand-written kernels (``kernels/csrc/*.cu``, one
   ``nvcc`` each, concurrently) and print the build seconds.
3. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes (DeiT-Small: M=788 rows for SBMM, B=4 x N=197 tokens x 6
   heads for attention, k=138 for the TDM), with fixed seeds: error and
   tolerance, kernel/plain/library times (CUDA events, median of 21 runs
   of 10 calls after warm-up) and each kernel's least possible time on an
   H100 SXM (published fp32 CUDA-core and HBM rates).
4. Main path: full-width DeiT-Small (12 layers, D=384, 224 px; random
   weights from a seed) serving 16 requests of mixed resolution and keep
   rate through ``VisionEngine`` (4 slots, planner "full") at pipeline
   depth 1 and then 2, each after one warm-up serve and timed over 5
   serves. Every serve runs under ``torch.cuda.set_sync_debug_mode
   ("warn")``, which counts the host's waits on the card other than the
   pipeline's per-step event; any such wait fails the run (once the
   profile below is printed). Checks: every request served with finite
   logits; every kernel's launch count rose during each serve; logits
   agree with the offline oracle ``forward_vit_packed`` per request (top-1
   equal); the two depths agree; and the packed forward agrees with the
   plain masked-dense reference (no kernel) with token pruning off.
5. Profile (``torch.profiler``): each kernel's device time per launch at
   the phase-3 shapes; for one depth-1 main-path serve, the device-busy
   and idle share, the device time by kernel and the engine's host spans
   (plan / stage / dispatch / complete), and the host's self time by
   operator and CUDA runtime call.
6. A ``kernels`` JSON line, then the last line
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

# H100 SXM published peaks (NVIDIA data sheet): fp32 on CUDA cores, HBM3
PEAK_FP32_FLOPS = 67e12
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


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_HBM_BYTES * 1e3
    t_ops = n_ops / PEAK_FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_sbmm(torch, dev):
    import numpy as np
    from repro_torch.core import block_pruning as BP
    from repro_torch.core.packing import pack_weight
    from repro_torch.kernels.sbmm import (pad_input, sbmm, sbmm_plain,
                                          unpermute)
    M, K, N, b = 788, 384, 384, 16
    g = torch.Generator().manual_seed(1)
    w = torch.randn((K, N), generator=g) * 0.05
    mask = BP.hard_block_mask(torch.randn(BP.score_shape((K, N), b),
                                          generator=g), 0.5, (K, N), b)
    pw = pack_weight(w.numpy(), mask.numpy().astype(bool), b, device=dev)
    require(not np.array_equal(pw.col_perm, np.arange(pw.n_cols)),
            "sbmm check needs a non-identity col_perm")
    x = torch.randn((M, K), generator=g).to(dev)

    def plain():
        return unpermute(sbmm_plain(pad_input(x, pw), pw.blocks, pw.header),
                         pw)

    y, ref = sbmm(x, pw), plain()
    torch.cuda.synchronize()
    err = (y - ref).abs().max().item()
    tol = 1e-4 * ref.abs().max().item()
    w_dense = pw.to_dense()
    kept = int((pw.header >= 0).sum())
    n_bytes = 4 * (x.numel() + pw.blocks.numel() + pw.header.numel()
                   + M * N) + 8 * pw.n_cols
    bnd, by = bound_ms(n_bytes, 2 * M * b * b * kept)
    return dict(
        name="sbmm", err=err, tol=tol,
        tol_rule="1e-4 x max|plain|",
        fn=lambda: sbmm(x, pw),
        ms=time_ms(lambda: sbmm(x, pw)), plain_ms=time_ms(plain),
        library_ms=time_ms(lambda: x @ w_dense),
        library_call="x @ W_dense (cuBLAS fp32)",
        bound_ms=bnd, bound_by=by,
        shapes=f"x[{M},{K}] blocks{list(pw.blocks.shape)} kept={kept}")


def check_flash_attention(torch, dev):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention)
    B, N, H, Dh = 4, 197, 6, 64
    lens = (197, 170, 140, 50)
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn((B, N, H, Dh), generator=g).to(dev)
               for _ in range(3))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)

    def plain():
        o, probs = attention_plain(q, k, v, kv_len)
        return o, probs.mean(dim=1)

    o, sc = flash_attention(q, k, v, kv_len, collect_scores=True)
    o_ref, sc_ref = plain()
    torch.cuda.synchronize()
    err_o = (o - o_ref).abs().max().item()
    err_s = (sc - sc_ref).abs().max().item()
    tol_o = 1e-4 * o_ref.abs().max().item()
    tol_s = 1e-4 * sc_ref.abs().max().item()
    for bi, L in enumerate(lens):
        require(bool((sc[bi, L:] == 0).all()),
                f"flash_attention: nonzero score at a masked key (row {bi})")
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    amask = (torch.arange(N, device=dev)[None, :]
             < kv_len[:, None])[:, None, None, :]
    sum_len = sum(lens)
    n_ops = H * Dh * (4 * N * sum_len + 2 * sum_len)
    n_bytes = 4 * (B * N * H * Dh + 2 * sum_len * H * Dh + B
                   + B * N * H * Dh + B * N)
    bnd, by = bound_ms(n_bytes, n_ops)
    return dict(
        name="flash_attention", err=max(err_o, err_s),
        tol=min(tol_o, tol_s), tol_rule="1e-4 x max|plain| (o and scores)",
        ok=err_o <= tol_o and err_s <= tol_s,
        fn=lambda: flash_attention(q, k, v, kv_len, collect_scores=True),
        ms=time_ms(lambda: flash_attention(q, k, v, kv_len,
                                           collect_scores=True)),
        plain_ms=time_ms(plain),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=amask)),
        library_call="F.scaled_dot_product_attention (bool key mask)",
        bound_ms=bnd, bound_by=by,
        shapes=f"q,k,v[{B},{N},{H},{Dh}] kv_len={list(lens)}")


def check_token_drop(torch, dev):
    from repro_torch.kernels.token_drop import token_drop, token_drop_plain
    B, N, D, k = 4, 197, 384, 138
    n_valid = (197, 180, 160, 140)
    g = torch.Generator().manual_seed(3)
    z = torch.randn((B, N, D), generator=g).to(dev)
    s = torch.rand((B, N), generator=g)
    for bi, nv in enumerate(n_valid):
        s[bi, nv:] = 0.0  # token-padded rows score exactly 0
    scores = (s / s.sum(dim=1, keepdim=True)).to(dev)

    out, ref = token_drop(z, scores, k), token_drop_plain(z, scores, k)
    torch.cuda.synchronize()
    require(torch.equal(out[:, :k + 1], ref[:, :k + 1]),
            "token_drop: CLS/kept rows differ from the plain version")
    err = (out[:, k + 1] - ref[:, k + 1]).abs().max().item()
    n_bytes = 4 * (z.numel() + scores.numel() + B * (k + 2) * D)
    bnd, by = bound_ms(n_bytes, 2 * B * (N - 1) * D)
    return dict(
        name="token_drop", err=err, tol=1e-5,
        tol_rule="kept rows bitwise, fused row <= 1e-5",
        fn=lambda: token_drop(z, scores, k),
        ms=time_ms(lambda: token_drop(z, scores, k)),
        plain_ms=time_ms(lambda: token_drop_plain(z, scores, k)),
        library_ms=None, library_call=None,
        bound_ms=bnd, bound_by=by,
        shapes=f"z[{B},{N},{D}] k={k} n_valid={list(n_valid)}")


# ---------------------------------------------------------------------------
# Phase 4: main path
# ---------------------------------------------------------------------------
REPEATS = 5  # timed serves of the stream per pipeline depth


def make_engine(cfg, params, scores, depth, dev, tracer=None):
    from repro_torch.serving.vision import VisionEngine, VisionEngineConfig
    return VisionEngine.from_pruned(
        cfg, params, scores, device=dev, tracer=tracer,
        vc=VisionEngineConfig(max_batch=4, planner="full",
                              pipeline_depth=depth))


PIPE_KEYS = ("steps", "pipeline_block_s", "pipeline_dispatch_s",
             "pipeline_overlap_hits")


def serve_stream(torch, backend, eng):
    """Serve the 16-request stream once on ``eng``: launch counts set to 0
    just before and read just after; the host's waits on the card other
    than the pipeline's events (blocking copies, ``.item()``) counted by
    PyTorch's sync debug mode. Returns (requests, {uid: logits}, wall
    seconds, launch counts, {engine steps, pipeline block / dispatch
    seconds and overlap hits, and ``host_syncs``, of this serve})."""
    from repro_torch.launch.serve_vision import make_requests
    reqs = make_requests(eng.cfg, 16, arrival_spread=4, seed=0)
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


def main_path(torch, dev):
    import numpy as np
    from repro_torch.configs import DEIT_SMALL
    from repro_torch.core import packed_runner as PR
    from repro_torch.kernels import backend
    from repro_torch.models import model as M
    from repro_torch.models import pruning_glue as PG

    cfg = DEIT_SMALL
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    scores = PG.init_scores(cfg, params, torch.Generator().manual_seed(7))
    runs, syncs = {}, {}
    for depth in (1, 2):
        eng = make_engine(cfg, params, scores, depth, dev)
        syncs[depth] = [serve_stream(torch, backend, eng)[4]["host_syncs"]]
        walls = []  # warm-up serve above
        for _ in range(REPEATS):
            reqs, out, dt, counts, pipe = serve_stream(torch, backend, eng)
            require(sorted(out) == [r.uid for r in reqs],
                    f"depth {depth}: not every request was served")
            for uid, lg in out.items():
                require(lg.shape == (cfg.num_classes,)
                        and bool(np.isfinite(lg).all()),
                        f"depth {depth}: uid {uid} logits not finite/shaped")
            for name, n in counts.items():
                require(n > 0, f"depth {depth}: kernel {name} never "
                               f"launched on the main path")
            walls.append(dt)
            syncs[depth].append(pipe["host_syncs"])
        dt = statistics.median(walls)
        steps = pipe["steps"]
        print(f"main path depth={depth}: {len(out)} images, {steps} steps; "
              f"wall over {REPEATS} serves median {dt:.4f} s (min "
              f"{min(walls):.4f}, max {max(walls):.4f}): "
              f"{len(out) / dt:.2f} images/s, {dt / steps * 1e3:.3f} ms/step;"
              f" launches per serve={counts}; host syncs besides the step "
              f"events per serve (warm-up first)={syncs[depth]}; last "
              f"serve: dispatch "
              f"{pipe['pipeline_dispatch_s'] * 1e3:.2f} ms, block on events "
              f"{pipe['pipeline_block_s'] * 1e3:.2f} ms, "
              f"{pipe['pipeline_overlap_hits']}/{steps} steps done before "
              f"their completion", flush=True)
        runs[depth] = (eng, reqs, out, counts, dt)

    eng, reqs, out, counts, wall_d1 = runs[1]
    tol = 1e-4
    worst = 0.0
    for r in reqs:
        ref = PR.forward_vit_packed(
            cfg, eng.segments.params, eng.segments.packed, r.patches[None],
            segments=eng.segments,
            schedule=PR.keep_schedule(cfg, r_t=r.r_t)).logits[0]
        ref = ref.cpu().numpy()
        err = float(np.abs(out[r.uid] - ref).max())
        scale = max(1.0, float(np.abs(ref).max()))
        worst = max(worst, err / scale)
        require(err <= tol * scale, f"uid {r.uid}: engine vs offline "
                                    f"oracle max|d|={err:.3g} > {tol}*{scale:.3g}")
        require(int(np.argmax(out[r.uid])) == int(np.argmax(ref)),
                f"uid {r.uid}: top-1 differs from the offline oracle")
    print(f"engine vs offline forward_vit_packed: top-1 16/16 equal, "
          f"max|d|/max(1,max|ref|) = {worst:.3g} (tolerance {tol})",
          flush=True)

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
    return counts, syncs, (cfg, params, scores, wall_d1)


# ---------------------------------------------------------------------------
# Phase 5: device time by kernel, busy share, host spans (torch.profiler)
# ---------------------------------------------------------------------------
KERNEL_SYMBOLS = {"sbmm": "sbmm_kernel", "flash_attention": "flash_kernel",
                  "token_drop": "token_drop_kernel"}


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


def profile_run(torch, dev, checks, cfg, params, scores, wall_d1) -> None:
    """Device time per launch of each kernel at the phase-3 shapes (stored
    as ``c["device_ms"]``); for one depth-1 serve of the main-path stream,
    device busy time by kernel and the host spans. The device idle share is
    given against the profiled serve's wall time and against the
    unprofiled median (``wall_d1``) — the profiler slows the host, not the
    card."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import backend
    from repro_torch.obs import Tracer
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for c in checks:
        with profile(activities=acts) as prof:
            for _ in range(20):
                c["fn"]()
            torch.cuda.synchronize()
        sym = KERNEL_SYMBOLS[c["name"]]
        mine = [r for r in _device_rows(prof) if sym in r[0]]
        require(bool(mine), f"profiler saw no {sym} launch")
        calls = sum(r[1] for r in mine)
        us = sum(r[2] for r in mine)
        c["device_ms"] = us / calls / 1e3
        print(f"profile {c['name']}: device {us / calls:.2f} us/launch "
              f"({calls} launches); wrapper {c['ms'] * 1e3:.2f} us/call",
              flush=True)

    tracer = Tracer()
    eng = make_engine(cfg, params, scores, 1, dev, tracer=tracer)
    serve_stream(torch, backend, eng)  # warm-up
    n_warm = len(tracer.span_log)
    with profile(activities=acts) as prof:
        _, _, dt, counts, pipe = serve_stream(torch, backend, eng)
    wall_us = dt * 1e6
    rows = _device_rows(prof)
    busy_us = sum(r[2] for r in rows)
    by_kernel = {}
    for name, sym in KERNEL_SYMBOLS.items():
        mine = [r for r in rows if sym in r[0]]
        by_kernel[name] = {"launches": sum(r[1] for r in mine),
                           "device_us": sum(r[2] for r in mine)}
    spans = {}
    for sp in tracer.span_log[n_warm:]:
        spans[sp["name"]] = spans.get(sp["name"], 0.0) + sp["dur_ms"]
    print(f"profile main path (depth 1, 16 images, {pipe['steps']} steps, "
          f"{sum(r[1] for r in rows)} device launches): wall "
          f"{wall_us:.0f} us profiled / {wall_d1 * 1e6:.0f} us unprofiled "
          f"median, device busy {busy_us:.0f} us, idle share "
          f"{1.0 - busy_us / wall_us:.3f} profiled / "
          f"{1.0 - busy_us / (wall_d1 * 1e6):.3f} unprofiled; host spans (ms) "
          + json.dumps({k: round(v, 3) for k, v in spans.items()}),
          flush=True)
    for name, v in by_kernel.items():
        print(f"  {name}: {v['launches']} launches, {v['device_us']:.1f} us "
              f"on the card", flush=True)
    for n, k, us in rows[:12]:
        print(f"  device {us:9.1f} us  {k:5d} calls  {n[:90]}", flush=True)
    for n, k, us in _host_rows(prof)[:15]:
        print(f"  host   {us:9.1f} us  {k:5d} calls  {n[:90]}", flush=True)


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

    checks = [check_sbmm(torch, dev), check_flash_attention(torch, dev),
              check_token_drop(torch, dev)]
    for c in checks:
        ok = c.pop("ok", c["err"] <= c["tol"])
        print(f"kernel {c['name']}: {c['shapes']} max_abs_err={c['err']:.3g} "
              f"tolerance={c['tol']:.3g} ({c['tol_rule']}) "
              f"kernel_ms={c['ms']:.4f} plain_ms={c['plain_ms']:.4f} "
              f"library_ms={c['library_ms']} ({c['library_call']}) "
              f"bound_ms={c['bound_ms']:.5f} ({c['bound_by']})", flush=True)
        require(ok, f"kernel {c['name']} disagrees with its plain version")

    counts, syncs, model = main_path(torch, dev)
    profile_run(torch, dev, checks, *model)
    for depth, n in syncs.items():
        require(not any(n), f"depth {depth}: the engine waited on the card "
                            f"outside the pipeline's step events: {n}")

    replaces = {
        "sbmm": "src/repro/kernels/sbmm/sbmm.py:75",
        "flash_attention":
            "src/repro/kernels/flash_attention/flash_attention.py:92",
        "token_drop": "src/repro/kernels/token_drop/token_drop.py:62"}
    print(json.dumps({"kernels": [
        {"name": c["name"], "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{c['name']}.cu",
         "replaces": replaces[c["name"]],
         "launches": counts[c["name"]], "max_abs_err": c["err"],
         "ms": c["ms"], "kernel_ms": c["ms"], "device_ms": c["device_ms"],
         "plain_ms": c["plain_ms"],
         "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
         "library_ms": c["library_ms"]} for c in checks]}), flush=True)
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
