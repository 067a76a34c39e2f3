#!/usr/bin/env python3
"""The scans' backward kernels alone on the card: build ``mamba_scan_bwd``
and ``wkv6_bwd`` (ptxas report: registers, shared memory, spills), their
SASS's atomics, then ``chip_smoke.check_scan_training``'s cases (each
gradient against the plain backward, two launches bitwise, kernel and
plain ms, the bound), and the device time per launch by kernel.

    python3 tools/scan_bwd_probe.py     # on the machine with the card
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as CS  # noqa: E402


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile
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
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    c["fn"]()
                torch.cuda.synchronize()
            rows = [r for r in CS._device_rows(prof)
                    if check["name"] in r[0]]
            errs = "; ".join(f"{o}: {e:.3g} (tol {t:.3g})"
                             for o, e, t, _ in c["errs"])
            print(f"{check['name']} [{c['label']}] {c['shapes']}\n  {errs}\n"
                  f"  ms {c['ms']:.4f} plain_ms {c['plain_ms']:.2f} bound_ms "
                  f"{c['bound_ms']:.5f} ({c['bound_by']}); device us/launch "
                  + ", ".join(f"{n.split('(')[0][-40:]}: {us / 5:.1f}"
                              for n, _, us in rows), flush=True)
        CS.require(all(e <= t for _, e, t, _ in check["errs"]),
                   f"{check['name']} disagrees with its plain backward")
    print("scan_bwd_probe: ok", flush=True)


if __name__ == "__main__":
    main()
