#!/usr/bin/env python3
"""Where the time of the ViT's fp32 attention backward goes, on one NVIDIA
GPU:

    python3 tools/vit_attn_bwd_parts.py

Builds variants of ``kernels/csrc/flash_attention_bwd.cu`` (timing only;
their outputs are not used) and times each at Algorithm 1's shapes
(full-width DeiT-Small, batch 64, 6 heads, Dh 64; N = 197, 140, 100, 72)
and at N = 192 (three whole 64-key tiles, six whole 32-row tiles: no
ragged tile):

* ``base``: the kernel as committed (both kernels of a launch);
* ``A x2``, ``B x2``, ``C x2``: one product phase run twice (S and dP;
  dV and dK; dQ), so that the difference from ``base`` is that phase's
  own time, with whatever of it the rest of the kernel hid;
* ``no sum``: without the second kernel, which sums the key tiles' dQ.

Times are wall µs per call on the card's clock (CUDA events around 10
back-to-back calls, median of 21 runs) on fp32 inputs made from a seed.
The card's name and power limit come first. Each variant is a text edit
of the source at a fixed anchor; a missing anchor stops the tool.
"""
from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
SHAPES = ((64, 197, 6, 64), (64, 192, 6, 64), (64, 140, 6, 64),
          (64, 100, 6, 64), (64, 72, 6, 64))
# (anchor, replacement): each phase's loop wrapped in a repeat count
EDITS = (
    ("#pragma unroll 2\n  for (int d = 0; d < DH; d += 4) {",
     "for (int rep = 0; rep < REP_A; ++rep)\n#pragma unroll 2\n"
     "  for (int d = 0; d < DH; d += 4) {"),
    ("    if (keys_live)\n      outer<kG, kG, kCh>",
     "    for (int rep = 0; rep < REP_B; ++rep) if (keys_live)\n"
     "      outer<kG, kG, kCh>"),
    ("      outer<kR, 1, 1>(tr + qr",
     "      for (int rep = 0; rep < REP_C; ++rep) outer<kR, 1, 1>(tr + qr"),
    ("  flash_attention_bwd_f32_dq_sum_kernel<<<",
     "  if (SUM) flash_attention_bwd_f32_dq_sum_kernel<<<"),
)
VARIANTS = {"base": {}, "A x2": {"REP_A": 2}, "B x2": {"REP_B": 2},
            "C x2": {"REP_C": 2}, "no sum": {"SUM": 0}}


def build(work: pathlib.Path, nvcc: str, nvcc_flags) -> dict:
    """Compile every variant (one nvcc each, together); their entry
    points, by name."""
    src = (CSRC / "flash_attention_bwd.cu").read_text()
    for anchor, new in EDITS:
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in the source: "
                             f"{anchor!r}")
        src = src.replace(anchor, new)
    (work / "bwd.cu").write_text(src)
    for h in CSRC.glob("*.cuh"):
        shutil.copy(h, work / h.name)
    procs = {}
    for i, (name, defs) in enumerate(VARIANTS.items()):
        d = {"REP_A": 1, "REP_B": 1, "REP_C": 1, "SUM": 1, **defs}
        out = work / f"lib{i}.so"
        cmd = [nvcc, *nvcc_flags,
               *(f"-D{k}={v}" for k, v in d.items()), "-o", str(out),
               str(work / "bwd.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    fns = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(out)).flash_attention_bwd_f32
        fns[name] = fn
    return fns


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from chip_smoke import time_ms  # puts ROOT/src on the path
    import torch
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import ops as FA
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = backend.resolve_device("cuda")
    with tempfile.TemporaryDirectory(dir=ROOT / "build"
                                     if (ROOT / "build").is_dir() else None
                                     ) as tmp:
        fns = build(pathlib.Path(tmp), backend._nvcc(), backend.NVCC_FLAGS)
        for fn in fns.values():
            fn.argtypes = backend._ENTRY_POINTS["flash_attention_bwd"][
                "flash_attention_bwd_f32"]
            fn.restype = ctypes.c_int
        g = torch.Generator().manual_seed(1)
        for B, N, H, Dh in SHAPES:
            q, k, v, do = (torch.randn((B, N, H, Dh), generator=g).to(dev)
                           for _ in range(4))
            o, _, lse = FA._attention_cuda(q, k, v, None, True,
                                           with_lse=True)
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            part = torch.empty((-(-N // FA.NONCAUSAL_BWD_KEYS), B, N, H, Dh),
                               device=dev)
            stream = backend.current_stream(dev)
            row = []
            for name, fn in fns.items():
                def call(fn=fn, name=name):
                    backend.check(name, fn(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), do.data_ptr(), lse.data_ptr(), None,
                        part.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), B, N, H, Dh, 0, 0, Dh ** -0.5,
                        stream))
                row.append(f"{name} {time_ms(call) * 1e3:.1f}")
            print(f"[{B}, {N}, {H}, {Dh}] us a call: " + ", ".join(row),
                  flush=True)
            del q, k, v, do, o, lse, dq, dk, dv, part
    return 0


if __name__ == "__main__":
    sys.exit(main())
