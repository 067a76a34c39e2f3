"""Vision serving launcher: image requests through the VisionEngine
(Scheduler + TilePlanner/RaggedBatcher + PackedVitSegments).

    PYTHONPATH=src python -m repro_torch.launch.serve_vision --requests 16 \\
        --slots 4 --planner full --policy prune_pressure_aware [--device cpu]

Builds the reduced DeiT config, runs the paper's simultaneous pruning
offline (init scores -> hard masks -> SBMM packing), then serves a mixed
stream of image resolutions and per-request token keep rates through the
continuous-batching engine. ``--planner`` selects the execution-planning
mode (``off`` = identity bucketing, ``merge`` = cost-model bucket
merging, ``fuse`` = express-lane trajectory fusion, ``full`` = both);
``--deadline-ms`` attaches a latency SLO to every request —
deadline-aware tiling is active in every non-``off`` planner mode.
``--mode naive`` A/Bs the classic padded batch against the
load-balanced bucketing; ``--policy`` selects the admission policy shared
with the LM path (fifo / shortest_prompt_first / prune_pressure_aware);
``--quality`` / ``--keep-floor`` turn on the QualityController (graceful
quality degradation: keep rates tighten down a quantized grid under
queue/deadline pressure — ``strict``, the default, is off).
``--precision`` makes the fp16 or int8 tier available: the planner prices
each request at fp32 and at the tier and dispatches the cheaper.
``--device`` picks the card (``cuda``, the default) or the CPU, where the
kernels' plain PyTorch versions run. Weights are random, drawn from
``--seed`` with ``torch.Generator``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import pruning_glue as PG
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serving.planner import PLANNER_MODES
from repro_torch.serving.vision import (VisionEngine, VisionEngineConfig,
                                        VisionRequest)


def make_requests(cfg, num: int, arrival_spread: int, seed: int,
                  r_ts=None, size_weights=None, deadline_ms=None,
                  unique_sizes: bool = False):
    """Synthetic mixed request stream: three image resolutions (full,
    near-full, half side), per-request token keep rates, staggered
    arrivals. The same draws as the reference launcher's (numpy, from
    ``seed``), so both packages can serve the same stream.
    ``size_weights`` skews the size mix; ``unique_sizes`` draws every patch
    count distinct so no two requests ever share a bucket."""
    rng = np.random.default_rng(seed)
    side = cfg.image_size // cfg.patch_size
    sizes = sorted({max(1, side // 2) ** 2, max(1, side - 1) ** 2,
                    side ** 2})
    if r_ts is None:
        r_ts = [0.5, cfg.pruning.r_t, None]  # None = engine default
    if size_weights is None:
        p = None  # uniform
    else:
        p = np.asarray(size_weights[:len(sizes)], np.float64)
        p = p / p.sum()
    if unique_sizes:
        lo, hi = max(1, side ** 2 // 4), side ** 2
        pool = rng.permutation(np.arange(lo, hi + 1))
        counts = [int(pool[i % len(pool)]) for i in range(num)]
    else:
        counts = [int(rng.choice(sizes, p=p)) for _ in range(num)]
    pdim = cfg.patch_size ** 2 * 3
    return [VisionRequest(
        uid=i,
        patches=rng.standard_normal((counts[i], pdim)).astype(np.float32),
        r_t=r_ts[int(rng.integers(len(r_ts)))],
        arrival_step=int(rng.integers(0, arrival_spread + 1)),
        deadline_ms=deadline_ms)
        for i in range(num)]


def plan_stats_line(stats) -> str:
    """The end-of-run planner summary: merges, fused lanes, deadline dispatches, and the modeled
    saving of the plan vs the identity plan."""
    return (f"planner={stats['plan_mode']} merges={stats['plan_merges']} "
            f"fused_lanes={stats['plan_lanes']} "
            f"(segments={stats['plan_fused_segments']}) "
            f"deadline_dispatches={stats['plan_deadline_urgent']} "
            f"splits={stats['plan_deadline_splits']} "
            f"modeled_saving={stats['plan_modeled_saving_ms']:.3f}ms "
            f"({'calibrated' if stats['plan_calibrated'] else 'uncalibrated'}"
            f" cost model)")


def serve(arch: str = "deit-small", num_requests: int = 16, slots: int = 4,
          mode: str = "balanced", token_tile: int = 1,
          policy: str = "fifo", image_size: int = 0,
          arrival_spread: int = 4, seed: int = 0,
          planner: str = "full", deadline_ms: float = 0.0,
          pipeline_depth: int = 1, quality: str = "strict",
          keep_floor: float = 0.4, precision: str = "fp32",
          trace_out: str = "", metrics_out: str = "",
          device: str = "cuda"):
    cfg = get_config(arch).reduced()
    if image_size:
        cfg = cfg.replace(image_size=image_size)
    params = M.init_params(cfg, torch.Generator().manual_seed(seed),
                           device=device)
    scores = PG.init_scores(cfg, params,
                            torch.Generator().manual_seed(seed + 7))
    if mode == "naive":
        planner = "off"  # naive padding has no buckets to plan over
    vc = VisionEngineConfig(max_batch=slots, mode=mode,
                            token_tile=token_tile, planner=planner,
                            pipeline_depth=pipeline_depth,
                            quality=quality, keep_floor=keep_floor,
                            precision=precision)
    tracer = Tracer() if trace_out else None
    engine = VisionEngine.from_pruned(cfg, params, scores, vc=vc,
                                      policy=policy, tracer=tracer,
                                      device=device)
    reqs = make_requests(cfg, num_requests, arrival_spread, seed,
                         deadline_ms=deadline_ms or None)
    t0 = time.time()
    out = engine.serve(reqs)
    dt = time.time() - t0
    if trace_out:
        tracer.write_chrome_trace(trace_out)
    if metrics_out:
        engine.export_metrics(MetricsRegistry()).write_json(metrics_out)
    return {"outputs": out, "seconds": dt,
            "images_per_s": len(out) / dt,
            "events": list(engine.events),
            "stats": engine.stats(),
            "quantization": engine.quantization_report()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deit-small")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--mode", choices=("balanced", "naive"),
                    default="balanced")
    ap.add_argument("--planner", choices=PLANNER_MODES, default="full",
                    help="execution planning: off = identity bucketing, "
                         "merge = cost-model bucket merging, fuse = "
                         "express-lane trajectory fusion, full = both")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="attach a latency SLO (ms from admission) to "
                         "every request; 0 = no deadlines (deadline-aware "
                         "tiling is active in every non-off planner mode)")
    ap.add_argument("--token-tile", type=int, default=1,
                    help="token bucket quantization (1 = exact, bit-exact)")
    ap.add_argument("--policy", default="fifo",
                    help="admission policy: fifo | shortest_prompt_first "
                         "| prune_pressure_aware")
    ap.add_argument("--image-size", type=int, default=0,
                    help="override the reduced config's image size")
    ap.add_argument("--arrival-spread", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="StepPipeline depth: 1 = synchronous stepping "
                         "(the reference path), 2 = stage/plan step N+1 "
                         "while the device executes step N (bit-exact)")
    ap.add_argument("--quality", default="strict",
                    choices=("strict", "auto", "degrade"),
                    help="QualityController mode: strict = off (bit-exact "
                         "with the fixed-keep-rate path), auto = tighten "
                         "keep rates with queue/deadline pressure, "
                         "degrade = shed-load floor for every consenting "
                         "request")
    ap.add_argument("--keep-floor", type=float, default=0.4,
                    help="controller keep-rate floor: no request is ever "
                         "tightened below this, whatever the load")
    ap.add_argument("--precision", default="fp32",
                    choices=("fp32", "fp16", "int8"),
                    help="serving precision tier: fp32 = the reference "
                         "path; fp16/int8 let the planner price each "
                         "request's trajectory at the tier and dispatch "
                         "its kernels when strictly cheaper "
                         "(quality=strict requests stay fp32)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels on the card) or cpu "
                         "(their plain PyTorch versions)")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="write a Chrome trace_event JSON (Perfetto-"
                         "loadable) of the run's plan/stage/dispatch/"
                         "complete spans to PATH at exit")
    ap.add_argument("--metrics-out", default="", metavar="PATH",
                    help="write the engine's metrics-registry snapshot "
                         "(JSON) to PATH at exit")
    ap.add_argument("--json", action="store_true",
                    help="print a machine-readable result line")
    args = ap.parse_args()
    out = serve(args.arch, args.requests, args.slots, args.mode,
                args.token_tile, args.policy, args.image_size,
                args.arrival_spread, args.seed, args.planner,
                args.deadline_ms, args.pipeline_depth, args.quality,
                args.keep_floor, precision=args.precision,
                trace_out=args.trace_out, metrics_out=args.metrics_out,
                device=args.device)
    if args.json:
        print(json.dumps({
            "top1": {str(u): int(np.argmax(lg))
                     for u, lg in out["outputs"].items()},
            "images_per_s": out["images_per_s"],
            "stats": out["stats"],
        }, default=str))
    else:
        st = out["stats"]
        print(f"served {st['images_served']} images in "
              f"{out['seconds']:.2f}s ({out['images_per_s']:.1f} img/s, "
              f"policy={args.policy}, mode={args.mode})")
        print(f"steps={st['steps']} tiles={st['batcher_tiles']} "
              f"padding_waste={st['batcher_padding_waste']:.1%} "
              f"tile_shapes={st['jit_compile_count']} <= "
              f"buckets+trajectories={st['compile_budget']}")
        print(plan_stats_line(st))
        q = out["quantization"]
        print(f"precision={st['precision']} "
              f"(granularity={q['granularity']}) "
              f"quant_error={q['quant_max_abs_error']:.5f} "
              f"packed_bytes={q['packed_bytes_fp32']} -> "
              f"{q['packed_bytes']} "
              f"dispatches=" + "/".join(
                  f"{p}:{st[f'dispatch_{p}']}"
                  for p in ("fp32", "fp16", "int8")) +
              f" dequant={st['dequant_dispatches']}")
        if st["quality_mode"] != "strict":
            print(f"quality={st['quality_mode']} "
                  f"floor={st['quality_keep_floor']} tightened="
                  f"{st['quality_tightened']}/{st['quality_decisions']} "
                  f"steps (deadline-driven: "
                  f"{st['quality_deadline_tightened']}) levels_used="
                  f"{st['quality_levels_used']}")
        for uid, logits in sorted(out["outputs"].items()):
            print(f"  uid {uid}: top-1 class {int(np.argmax(logits))}")


if __name__ == "__main__":
    main()
