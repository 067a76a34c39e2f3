#!/usr/bin/env python3
"""The recurrent families at full width on one NVIDIA GPU: how far a
prefill carried through teacher-forced decode steps lies from one
full-sequence forward, and what moves it.

    python3 tools/ssm_probe.py [--layers N] [--arch zamba2-1.2b rwkv6-1.6b]

For each architecture (random weights from seed 0, the bf16 serving copy)
and two left-padded rows of ``--len`` tokens (pad token 0, as the
engine's whole-batch prefill pads), it prints the largest logit
difference, and the share of equal argmaxes, between ``forward_lm`` in
train mode over each row plus 8 tokens (B=1) and (a) a prefill of both
rows then 8 decode steps, (b) the same for one row alone, (c) the train
forward with a random half of the embedding moved by one bf16 ulp (the
model's own sensitivity), each with the kernels and again with the plain
scan and the plain causal attention standing in for the kernels (a probe
only: the package never routes a CUDA tensor to a plain version).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def logits_gap(a, b):
    d = (a.float() - b.float()).abs().max().item()
    same = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    return round(d, 5), round(same, 4)


def run(torch, cfg, params, dev, rows, cont):
    from repro_torch.models import model as M
    from repro_torch.models import steps as ST
    L, T = rows.shape[1], cont.shape[1]
    full = torch.cat([rows, cont], dim=1)
    with torch.no_grad():
        ref = torch.stack([M.forward_lm(cfg, params, full[i:i + 1]).logits[
            0, L - 1:L + T - 1] for i in range(rows.shape[0])])

        def served(idx):
            caches = ST.init_caches(cfg, len(idx), L + T + 8, device=dev)
            out = M.forward_lm(cfg, params, rows[idx], mode="prefill",
                               caches=caches, logits_for="last")
            got, caches = [out.logits[:, -1]], out.caches
            for t in range(T - 1):
                out = M.forward_lm(cfg, params, cont[idx, t:t + 1],
                                   mode="decode", caches=caches)
                caches = out.caches
                got.append(out.logits[:, -1])
            return torch.stack(got, dim=1)
        both, one = served([0, 1]), served([0])
        emb = params["embed"]
        up = torch.nextafter(emb, torch.full_like(emb, float("inf")))
        half = torch.rand(emb.shape, generator=torch.Generator(
            emb.device).manual_seed(2), device=emb.device) < 0.5
        moved = dict(params, embed=torch.where(half, up, emb))
        wit = torch.stack([M.forward_lm(cfg, moved, full[i:i + 1]).logits[
            0, L - 1:L + T - 1] for i in range(rows.shape[0])])
    return {"prefill+decode B=2": logits_gap(both, ref),
            "prefill+decode B=1": logits_gap(one, ref[:1]),
            "witness (one ulp of embed)": logits_gap(wit, ref),
            "max|logit|": round(ref.abs().max().item(), 4)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+",
                    default=["zamba2-1.2b", "rwkv6-1.6b"])
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth (0: the config's)")
    ap.add_argument("--len", type=int, default=300)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced configs (a rehearsal)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.ssm_scan import ops as SS
    from repro_torch.models import model as M
    from repro_torch.serving.runner import serving_params
    dev = backend.resolve_device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    kernels = (SS._mamba_scan_cuda, SS._wkv6_cuda, FA._causal_cuda)

    def plain_causal(q, k, v, q_offset, kv_len, kv_start, collect_probs,
                     with_lse=False):
        return FA.attention_causal_plain(q, k, v, q_offset, kv_len,
                                         kv_start, collect_probs)
    for arch in args.arch:
        cfg = get_config(arch)
        if args.reduced:
            cfg = cfg.reduced()
        if args.layers:
            cfg = cfg.replace(num_layers=args.layers)
        params = serving_params(cfg, M.init_params(
            cfg, torch.Generator(dev).manual_seed(0), device=dev))
        g = torch.Generator().manual_seed(1)
        L = args.len
        rows = torch.randint(0, cfg.vocab_size, (2, L), generator=g)
        rows[0, :L // 2] = 0  # left padding, as the engine pads
        cont = torch.randint(0, cfg.vocab_size, (2, 8), generator=g)
        rows, cont = rows.to(dev), cont.to(dev)
        res = {"kernels": run(torch, cfg, params, dev, rows, cont)}
        SS._mamba_scan_cuda, SS._wkv6_cuda = (SS.mamba_scan_plain,
                                              SS.wkv6_plain)
        res["plain scans"] = run(torch, cfg, params, dev, rows, cont)
        FA._causal_cuda = plain_causal
        res["plain scans and attention"] = run(torch, cfg, params, dev, rows,
                                               cont)
        SS._mamba_scan_cuda, SS._wkv6_cuda, FA._causal_cuda = kernels
        print(json.dumps({"arch": arch, "layers": cfg.num_layers,
                          "len": L, **res}), flush=True)
        del params
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
