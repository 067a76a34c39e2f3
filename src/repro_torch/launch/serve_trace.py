"""Trace replay launcher: drive either serving engine from a traffic trace.

    # synthesize a bursty vision trace, replay it, print the SLO report
    PYTHONPATH=src python -m repro_torch.launch.serve_trace --engine vision \\
        --process bursty --requests 16 --rate 2000 --deadline-ms 0.1 \\
        [--device cpu]

    # replay a saved trace file with admission control on
    PYTHONPATH=src python -m repro_torch.launch.serve_trace \\
        --trace examples/traces/bursty_vision.jsonl --admission-limit-ms 0.05

The launcher composes the three traffic pieces end to end: a
:class:`~repro_torch.traffic.workload.Trace` (loaded from ``--trace``
JSONL or synthesized from the arrival/mix knobs and ``--save-trace``-able
for replay elsewhere), the
:class:`~repro_torch.traffic.harness.TrafficHarness` (virtual-clock replay
with per-request lifecycle accounting), and — when
``--admission-limit-ms`` is set — the cost-model
:class:`~repro_torch.traffic.admission.AdmissionController` installed on
the engine's Scheduler (degrade-then-reject when ``--quality`` enables
the QualityController). All reported timestamps are virtual:
deterministic for a given (trace, config), identical at any
``--pipeline-depth`` and on any device.

``--reduced`` (the default) serves the architecture's reduced config;
``--no-reduced`` serves it at full width and depth. ``--device`` picks
the card (``cuda``, the default) or the CPU, where the kernels' plain
PyTorch versions run. Weights are random, drawn from ``--seed`` with
``torch.Generator``: the ViT's on the CPU (the same weights on every
device), the LM's on the device.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import get_config
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import model as M
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serving import (EngineConfig, ServeEngine, VisionEngine,
                                 VisionEngineConfig)
from repro_torch.traffic import (ARRIVAL_PROCESSES, LMDriver, TraceSpec,
                                 TrafficHarness, VisionDriver, load_trace,
                                 make_trace, save_trace, trace_fingerprint)


def build_driver(engine_kind: str, arch: str, slots: int, seed: int,
                 pipeline_depth: int, quality: str, keep_floor: float,
                 per_token_ms: float, reduced: bool = True,
                 max_len: int = 256, device: str = "cuda"):
    """Construct the engine for ``engine_kind`` and wrap it in its
    harness driver. ``max_len`` is the LM cache's length in tokens."""
    dev = resolve_device(device)
    if engine_kind == "vision":
        from repro_torch.models import pruning_glue as PG
        cfg = get_config(arch or "deit-small")
        if reduced:
            cfg = cfg.reduced()
        params = M.init_params(cfg, torch.Generator().manual_seed(seed),
                               device=dev)
        scores = PG.init_scores(cfg, params,
                                torch.Generator().manual_seed(seed + 7))
        vc = VisionEngineConfig(max_batch=slots, planner="full",
                                pipeline_depth=pipeline_depth,
                                quality=quality, keep_floor=keep_floor)
        return VisionDriver(VisionEngine.from_pruned(cfg, params, scores,
                                                     vc=vc, device=dev))
    cfg = get_config(arch or "stablelm-1.6b")
    if reduced:
        cfg = cfg.reduced()
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(seed),
                           device=dev)
    ec = EngineConfig(max_batch=slots, max_len=max_len,
                      pipeline_depth=pipeline_depth)
    return LMDriver(ServeEngine(cfg, params, ec, device=dev),
                    per_token_ms=per_token_ms)


def default_spec(engine_kind: str, args) -> TraceSpec:
    deadlines = (args.deadline_ms,) if args.deadline_ms else (None,)
    if engine_kind == "vision":
        return TraceSpec(n=args.requests, rate_rps=args.rate,
                         process=args.process, kind="vision",
                         sizes=(16, 9, 4), deadlines_ms=deadlines)
    return TraceSpec(n=args.requests, rate_rps=args.rate,
                     process=args.process, kind="lm",
                     prompt_sizes=(8, 16), max_new_tokens=args.max_new,
                     deadlines_ms=deadlines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", choices=("vision", "lm"), default="vision")
    ap.add_argument("--arch", default="",
                    help="config name (default: deit-small for vision, "
                         "stablelm-1.6b for lm)")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the reduced config (default); --no-reduced "
                         "serves full width and depth")
    ap.add_argument("--trace", default="",
                    help="replay this JSONL trace (its kind selects "
                         "nothing — pass a matching --engine)")
    ap.add_argument("--save-trace", default="",
                    help="write the (synthesized) trace to this path")
    ap.add_argument("--process", choices=ARRIVAL_PROCESSES,
                    default="bursty")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=1000.0,
                    help="offered load, requests per virtual second")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="virtual-clock SLO per request (0 = none)")
    ap.add_argument("--max-new", type=int, default=8,
                    help="lm traces: tokens generated per request")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pipeline-depth", type=int, default=1)
    ap.add_argument("--quality", default="strict",
                    choices=("strict", "auto", "degrade"),
                    help="vision QualityController mode; non-strict "
                         "enables the admission controller's degrade arm")
    ap.add_argument("--keep-floor", type=float, default=0.4)
    ap.add_argument("--admission-limit-ms", type=float, default=0.0,
                    help="modeled-backlog budget for the admission "
                         "controller (0 = unbounded admission)")
    ap.add_argument("--per-token-ms", type=float, default=1.0,
                    help="lm virtual-clock price per dispatched token")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels on the card) or cpu "
                         "(their plain PyTorch versions)")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="write a Chrome trace_event JSON (Perfetto-"
                         "loadable) of the replay's per-step and "
                         "per-request timelines — VIRTUAL-clock "
                         "timestamps, deterministic and identical at "
                         "every --pipeline-depth")
    ap.add_argument("--metrics-out", default="", metavar="PATH",
                    help="write the replay's metrics-registry snapshot "
                         "(latency/ttfd histograms, admission and "
                         "scheduler counters) to PATH")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()

    if args.trace:
        trace = load_trace(args.trace)
        if trace.kind != args.engine:
            raise SystemExit(f"trace kind {trace.kind!r} needs "
                             f"--engine {trace.kind}")
    else:
        trace = make_trace(default_spec(args.engine, args), seed=args.seed)
    if args.save_trace:
        save_trace(args.save_trace, trace)

    driver = build_driver(args.engine, args.arch, args.slots, args.seed,
                          args.pipeline_depth, args.quality,
                          args.keep_floor, args.per_token_ms,
                          reduced=args.reduced, device=args.device)
    tracer = Tracer() if args.trace_out else None
    metrics = MetricsRegistry() if args.metrics_out else None
    harness = TrafficHarness(
        driver, admission_limit_ms=args.admission_limit_ms or None,
        tracer=tracer, metrics=metrics)
    report = harness.run(trace)
    report["trace_fingerprint"] = trace_fingerprint(trace)
    if args.trace_out:
        tracer.write_chrome_trace(args.trace_out)
    if args.metrics_out:
        metrics.write_json(args.metrics_out)

    if args.json:
        print(json.dumps(report, default=str))
        return
    print(f"trace: {len(trace.requests)} {trace.kind} requests, "
          f"{trace.meta.get('spec', {}).get('process', '?')} arrivals, "
          f"offered {report['offered_rps']:.1f}/s "
          f"(fingerprint {report['trace_fingerprint'][:12]}...)")
    print(f"completed {report['completed']}/{report['offered']} "
          f"(rejected {report['rejected']}) in "
          f"{report['virtual_ms']:.3f} virtual ms -> "
          f"goodput {report['goodput_rps']:.1f}/s")
    print(f"latency p50/p95/p99 = {report['latency_p50_ms']:.3f}/"
          f"{report['latency_p95_ms']:.3f}/"
          f"{report['latency_p99_ms']:.3f} ms, "
          f"ttfd p50 = {report['ttfd_p50_ms']:.3f} ms")
    print(f"deadline miss rate {report['deadline_miss_rate']:.0%} "
          f"({report['deadline_missed']}/{report['deadline_total']}), "
          f"peak queue depth {report['peak_queue_depth']}")
    if "admission" in report:
        a = report["admission"]
        print(f"admission: limit={a['limit_ms']:.4f}ms accepts="
              f"{a['accepts']} degrades={a['degrades']} "
              f"rejects={a['rejects']}")


if __name__ == "__main__":
    main()
