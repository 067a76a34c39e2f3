#!/usr/bin/env python3
"""The scans' backward kernels ``mamba_scan_bwd_f32`` and ``wkv6_bwd_f32``
on one NVIDIA GPU.

    python3 tools/scan_bwd_probe.py                  # this tree
    python3 tools/scan_bwd_probe.py PARENT . . PARENT [.:min=1 ...]

With no argument: build both libraries (ptxas report: registers, shared
memory, spills), their SASS's tensor-core and atomic instructions, then
``chip_smoke.check_scan_training``'s cases (each gradient against the
plain backward, two launches bitwise, the form that ran, kernel and plain
ms, the bound) with the device µs per launch of each kernel (the
sequential form's walk and sum; the chunked form's boundary walk, chunks
and sum: its phases).

With arguments: each checkout (a directory holding ``src/repro_torch``, for
example a ``git archive`` of the parent commit unpacked under a directory
``.gitignore`` lists) in turn, each in its own process, on the same inputs
made from a seed: at the training step (B 8 x S 512, bf16, Zamba2-1.2B's
and RWKV6-1.6B's widths) and at B 8 x S of ``SWEEP``, the sha256 of every
gradient (equal hashes mean bitwise-equal outputs), the form that ran
(where the checkout has two), the wall ms per call (CUDA events) and the
device µs per launch by kernel; at the training step also each gradient's
largest error against the plain backward over max(1, max|plain|). A
checkout written ``DIR:min=N`` is DIR with the chunked form's first length
(``BWD_CHUNK_MIN`` and the kernels' ``kBwdChunkMin``) set to N, copied
under ``build/`` first: both forms at the same S. One JSON line per
checkout; the card's name and power limit come first.
"""
import json
import os
import re
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

SWEEP = (8, 16, 24, 32, 48, 64, 128)
SOURCES = ("src/repro_torch/kernels/csrc/mamba_scan_bwd.cu",
           "src/repro_torch/kernels/csrc/wkv6_bwd.cu")


def _variant(tree: str) -> str:
    """The directory to import for ``tree`` (``DIR`` or ``DIR:min=N``)."""
    if ":min=" not in tree:
        return tree
    base, n = tree.split(":min=")
    out = os.path.join(ROOT, "build", "scan_bwd_variants",
                       f"{os.path.basename(os.path.abspath(base))}-min{n}")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(base, "src"), os.path.join(out, "src"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel in SOURCES:
        p = os.path.join(out, rel)
        with open(p) as f:
            src = f.read()
        with open(p, "w") as f:
            f.write(re.sub(r"constexpr int kBwdChunkMin = \d+;",
                           f"constexpr int kBwdChunkMin = {n};", src))
    p = os.path.join(out, "src/repro_torch/kernels/ssm_scan/ops.py")
    with open(p) as f:
        src = f.read()
    with open(p, "w") as f:
        f.write(re.sub(r"BWD_CHUNK_MIN = \{[^}]*\}",
                       f'BWD_CHUNK_MIN = {{"mamba": {n}, "wkv6": {n}}}',
                       src))
    return out


def one(tree: str) -> dict:
    """Hash, check and time both backward kernels of the checkout at
    ``tree``."""
    from causal_ab import _device_us, _sha
    from chip_smoke import SCAN_BWD_KERNELS, scan_inputs, time_ms
    sys.path.insert(0, os.path.join(os.path.abspath(_variant(tree)), "src"))
    import torch
    from repro_torch import configs
    from repro_torch.kernels import backend
    from repro_torch.kernels.ssm_scan import ops as SS
    dev = backend.resolve_device("cuda")
    res = {"tree": tree,
           "build_s": backend.build(["mamba_scan_bwd", "wkv6_bwd"])}
    for kind, entry, _, cfg_name in SCAN_BWD_KERNELS:
        cfg = getattr(configs, cfg_name)
        fn, plain = ((SS._mamba_scan_bwd_cuda, SS.mamba_scan_bwd_plain)
                     if kind == "mamba" else
                     (SS._wkv6_bwd_cuda, SS.wkv6_bwd_plain))
        for S in (512, *SWEEP):
            g = torch.Generator().manual_seed(14)
            args = scan_inputs(torch, dev, kind, cfg, 8, S, g)
            args = (*args[:-1], torch.zeros_like(args[-1]))
            dy = torch.randn(args[0].shape, generator=g).to(dev)
            grads = (dy, torch.zeros_like(args[-1]))
            call = lambda a=args, d=grads: fn(*a, *d)
            got = call()
            torch.cuda.synchronize()
            row = dict(sha256=[_sha(t) for t in got], ms=time_ms(call))
            if hasattr(SS, "bwd_form"):
                row["form"] = SS.bwd_form(kind, S)
            for _ in range(3):  # a window may lose its device records
                by_kernel = _device_us(call)
                if any(entry in k for k in by_kernel):
                    break
            row["device_us"] = sum(by_kernel.values())
            row["device_us_by_kernel"] = by_kernel
            if S == 512:
                ref = plain(*args, *grads)
                row["rel_err"] = [
                    ((a - r).abs().max() / max(1.0, r.abs().max())).item()
                    for a, r in zip(got, ref)]
                del ref
            res[f"{entry} B 8 x S {S}"] = row
            del got, args, grads
        torch.cuda.empty_cache()
    return res


def main():
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from causal_ab import _device_us
    import chip_smoke as CS
    from repro_torch.kernels import backend
    if not torch.cuda.is_available():
        sys.exit("scan_bwd_probe: no CUDA device")
    dev = backend.resolve_device("cuda")
    print(CS.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True,
                            text=True).stdout.strip(), flush=True)
    libs = ("mamba_scan_bwd", "wkv6_bwd")
    print(f"build: {backend.build(libs, verbose=True):.2f} s", flush=True)
    for lib in libs:
        print(lib, json.dumps(CS._sass_ops(backend, lib, CS.TENSOR_CORE_OPS
                                           + CS.ATOMIC_OPS)), flush=True)
    for check in CS.check_scan_training(torch, dev):
        for c in check["cases"]:
            by_kernel = _device_us(c["fn"], n=5)
            errs = "; ".join(f"{o}: {e:.3g} (tol {t:.3g})"
                             for o, e, t, _ in c["errs"])
            print(f"{check['name']} [{c['label']}] {c['shapes']}\n  {errs}\n"
                  f"  ms {c['ms']:.4f} plain_ms {c['plain_ms']:.2f} bound_ms "
                  f"{c['bound_ms']:.5f} ({c['bound_by']}); device us/launch "
                  + json.dumps({k: round(v, 2) for k, v in by_kernel.items()}),
                  flush=True)
        CS.require(all(e <= t for _, e, t, _ in check["errs"]),
                   f"{check['name']} disagrees with its plain backward")
    print("scan_bwd_probe: ok", flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        from ab_runner import run
        sys.exit(run(sys.argv[1:], one, os.path.abspath(__file__), __doc__))
    main()
