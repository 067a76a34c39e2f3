#!/usr/bin/env python3
"""What the streamed loads cost the Dh-128 bf16 attention backward, on one
NVIDIA GPU:

    python3 tools/prefill_bwd_parts.py

Builds two variants of ``kernels/csrc/flash_prefill_bwd.cu`` and times
both, in turns (base, no loads, base, no loads), at the Dh-128 training
shapes of ``chip_smoke.LM_TRAIN_CASES`` (causal) and
``chip_smoke.MM_TRAIN_CASES`` (non-causal):

* ``base``: the kernels as committed;
* ``no loads``: at Dh 128 the thread that feeds the ring of a dq or dkdv
  block fills it once and then only arrives on each stage's full barrier,
  so every later tile is the stale one (timing only; the outputs are not
  used): the difference from ``base`` is what streaming Q and dO (dK/dV)
  or K and V (dQ) costs, with whatever of it the products hid.

Times are device µs per launch by kernel (``torch.profiler`` over 40
launches after one warm-up) on bf16 inputs made from a seed. The card's
name and power limit come first. The variant is a text edit of the source
at a fixed anchor; an anchor not found where expected stops the tool.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
# each feeder's wait for a free stage (dq, dkdv at Dh 16 / 64, dkdv at Dh
# 128), followed by the skip at Dh 128 when NO_LOADS is set
ANCHOR = "      bar_wait(bars.empty(s), ((fpos / kStages) & 1) ^ 1);\n"
SKIP = ("      if (DH == 128 && NO_LOADS && fpos >= kStages) {\n"
        "        bar_arrive(bars.full(s));\n"
        "        ++fi;\n"
        "        ++fpos;\n"
        "        continue;\n"
        "      }\n")
VARIANTS = {"base": 0, "no loads": 1}


def build(work: pathlib.Path, nvcc: str, nvcc_flags) -> dict:
    """Compile both variants (one nvcc each, together); their entry
    points, by name."""
    src = (CSRC / "flash_prefill_bwd.cu").read_text()
    if src.count(ANCHOR) != 3:
        raise SystemExit(f"anchor not found three times in the source: "
                         f"{ANCHOR!r}")
    (work / "bwd.cu").write_text(src.replace(ANCHOR, ANCHOR + SKIP))
    for h in CSRC.glob("*.cuh"):
        shutil.copy(h, work / h.name)
    procs = {}
    for i, (name, flag) in enumerate(VARIANTS.items()):
        out = work / f"lib{i}.so"
        cmd = [nvcc, *nvcc_flags, f"-DNO_LOADS={flag}", "-o", str(out),
               str(work / "bwd.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    fns = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fns[name] = ctypes.CDLL(str(out)).flash_prefill_bwd_bf16
    return fns


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from chip_smoke import LM_TRAIN_CASES, MM_TRAIN_CASES  # ROOT/src too
    sys.path.insert(0, str(ROOT / "tools"))
    from causal_ab import _device_us
    import torch
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import ops as FA
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = backend.resolve_device("cuda")
    cases = ([(label, True, B, N, N, Hq, KV, Dh)
              for label, B, N, Hq, KV, Dh in LM_TRAIN_CASES if Dh == 128]
             + [(label, False, B, Nq, Nk, Hq, KV, Dh)
                for label, B, Nq, Nk, Hq, KV, Dh in MM_TRAIN_CASES
                if Dh == 128])
    with tempfile.TemporaryDirectory(dir=ROOT / "build"
                                     if (ROOT / "build").is_dir() else None
                                     ) as tmp:
        fns = build(pathlib.Path(tmp), backend._nvcc(), backend.NVCC_FLAGS)
        for fn in fns.values():
            fn.argtypes = backend._ENTRY_POINTS["flash_prefill_bwd"][
                "flash_prefill_bwd_bf16"]
            fn.restype = ctypes.c_int
        g = torch.Generator().manual_seed(9)
        for label, causal, B, Nq, Nk, Hq, KV, Dh in cases:
            q, do = (torch.randn((B, Nq, Hq, Dh), generator=g).to(
                dev, torch.bfloat16) for _ in range(2))
            k, v = (torch.randn((B, Nk, KV, Dh), generator=g).to(
                dev, torch.bfloat16) for _ in range(2))
            o, lse = (FA._causal_cuda(q, k, v, None, None, None, False,
                                      with_lse=True) if causal
                      else FA._noncausal_cuda(q, k, v, with_lse=True))
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            dsum = torch.empty(FA.bwd_scratch_shape(B, Hq, Nq),
                               dtype=torch.float32, device=dev)
            stream = backend.current_stream(dev)
            res = {}
            for name in [*VARIANTS, *VARIANTS]:
                def call(fn=fns[name], name=name):
                    backend.check(name, fn(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), do.data_ptr(), lse.data_ptr(), None,
                        dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), B, Nq, Nk, Hq, KV, Dh, int(causal),
                        Dh ** -0.5, stream))
                by_kernel = _device_us(call, 40)
                res.setdefault(name, []).append(
                    {re.search(r"(dq|dkdv)_kernel", n).group(1): round(us, 2)
                     for n, us in by_kernel.items()})
            print(json.dumps({"case": label, "shape": [B, Nq, Nk, Hq, KV,
                                                       Dh],
                              "causal": causal, "device_us": res}),
                  flush=True)
            del q, k, v, do, o, lse, dq, dk, dv, dsum
    return 0


if __name__ == "__main__":
    sys.exit(main())
