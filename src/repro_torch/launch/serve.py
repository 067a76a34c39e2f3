"""LM serving launcher: batched requests through the layered serving API
(Scheduler / KVCacheManager / ModelRunner composed by ServeEngine).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b \\
        --requests 8 --max-new 16 --kv-prune 0.5 [--device cpu]

``--continuous`` serves through the slot-based continuous-batching path
(admission prefills only the admitted prompt via per-slot cache writes);
``--no-slot-prefill`` forces the whole-batch re-prefill for A/B runs.
``--reduced`` (the default) serves the architecture's reduced config;
``--no-reduced`` serves it at full width and depth. Every LM family the
package runs serves here: dense, MoE, the hybrid ``zamba2-1.2b`` and the
SSM ``rwkv6-1.6b`` (these two always through the whole-batch re-prefill:
recurrent state cannot be prefilled slot by slot). The VLM and audio
families are refused: their prefill needs vision embeddings or audio
frames, which the engine, like the reference's, does not feed (serve them
through ``models/steps.make_prefill`` / ``make_decode_step``). ``--device`` picks
the card (``cuda``, the default) or the CPU, where the kernels' plain
PyTorch versions run. Weights are random, drawn from ``seed`` (0 on the
command line) with a ``torch.Generator`` on the device. Elastic
degradation (the reference's ``--elastic-drop``) is not ported yet
(ROADMAP queue A, item 9).

Demonstrates the beyond-paper dynamic KV-cache pruning (the paper's token
scoring adapted to decode).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import model as M
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serving import EngineConfig, Request, ServeEngine
from repro_torch.serving.runner import require_tokens_only


def serve(arch: str, num_requests: int = 8, prompt_len: int = 16,
          max_new: int = 16, kv_prune: float = 1.0, reduced: bool = True,
          max_batch: int = 4, seed: int = 0, continuous: bool = False,
          per_slot_prefill: bool = True, policy: str = "fifo",
          pipeline_depth: int = 1, trace_out: str = "",
          metrics_out: str = "", device: str = "cuda"):
    cfg = get_config(arch)
    require_tokens_only(cfg)
    if reduced:
        cfg = cfg.reduced()
    dev = resolve_device(device)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(seed),
                           device=dev)
    ec = EngineConfig(
        max_batch=max_batch,
        max_len=prompt_len + 2 * max_new + 8,
        kv_prune_interval=4 if kv_prune < 1.0 else 0,
        kv_prune_keep=kv_prune,
        per_slot_prefill=per_slot_prefill,
        pipeline_depth=pipeline_depth)
    rng = np.random.default_rng(seed)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size, prompt_len,
                                        dtype=np.int32),
                    max_new_tokens=max_new)
            for i in range(num_requests)]
    tracer = Tracer() if trace_out else None
    engine = ServeEngine(cfg, params, ec, policy=policy, tracer=tracer,
                         device=dev)
    t0 = time.time()
    out = engine.serve(reqs, continuous=continuous)
    dt = time.time() - t0
    if trace_out:
        tracer.write_chrome_trace(trace_out)
    if metrics_out:
        engine.export_metrics(MetricsRegistry()).write_json(metrics_out)
    total_tokens = sum(len(v) for v in out.values())
    return {"outputs": out, "seconds": dt,
            "tokens_per_s": total_tokens / dt,
            "events": list(engine.events),
            "stats": engine.stats(), "device": str(dev)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--kv-prune", type=float, default=1.0)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the reduced config (default); --no-reduced "
                         "serves full width and depth")
    ap.add_argument("--continuous", action="store_true",
                    help="serve through the slot-based continuous path")
    ap.add_argument("--no-slot-prefill", action="store_true",
                    help="force whole-batch re-prefill on admission")
    ap.add_argument("--policy", default="fifo",
                    help="admission policy: fifo | shortest_prompt_first "
                         "| prune_pressure_aware (shared with the vision "
                         "path)")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="StepPipeline depth for the continuous path: 1 "
                         "= synchronous stepping, 2 = stage step N+1 "
                         "while the card runs step N (same tokens)")
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
    out = serve(args.arch, args.requests, args.prompt_len, args.max_new,
                args.kv_prune, args.reduced, max_batch=args.max_batch,
                continuous=args.continuous,
                per_slot_prefill=not args.no_slot_prefill,
                policy=args.policy, pipeline_depth=args.pipeline_depth,
                trace_out=args.trace_out, metrics_out=args.metrics_out,
                device=args.device)
    if args.json:
        print(json.dumps({
            "outputs": {str(k): v for k, v in out["outputs"].items()},
            "tokens_per_s": out["tokens_per_s"],
            "events": out["events"],
            "stats": out["stats"], "device": out["device"]}))
        return
    st = out["stats"]
    print(f"served {args.requests} requests on {out['device']} in "
          f"{out['seconds']:.2f}s ({out['tokens_per_s']:.1f} tok/s)")
    print(f"  admissions: {st['admissions']}, prefilled "
          f"{st['prefill_tokens_per_admission']:.1f} tok/admission, "
          f"{st['compile_count']} step shapes, "
          f"{st['prune_events']} KV prunes")
    for uid, toks in sorted(out["outputs"].items()):
        print(f"  req {uid}: {toks[:8]}{'...' if len(toks) > 8 else ''}")


if __name__ == "__main__":
    main()
