#!/usr/bin/env python3
"""Where the chunked forms of the recurrent scans spend their time, on one
NVIDIA GPU:

    python3 tools/scan_phases.py

Builds a variant of ``kernels/csrc/mamba_scan.cu`` and of ``wkv6.cu``
(timing only) in which thread 0 of block (0, 0) reads ``clock64()`` at the
top of every chunk and after every barrier of the chunked kernel, and
runs each at its model's full widths (Zamba2-1.2B, RWKV6-1.6B) at B 4 x S
512 on inputs made as ``chip_smoke.scan_inputs`` makes them. A phase is
the span from one stamp to the next, so it holds the phase's own work and
the wait for its slowest warp; the block shares its SM with another, as
on the serve path. Prints, per phase, the SM cycles a chunk (mean over the
chunks) and the share of the kernel's cycles; the card's name and power
limit come first. Each kernel also runs on a single block (``alone``: one
head of one batch row, the SM to itself), and per run the tool prints the
wall µs a launch (CUDA events, ``chip_smoke.time_ms``). The stamps are a
text edit of the source at fixed anchors; a missing anchor stops the
tool.
"""
from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
# source, its chunked kernel's name, the phases between its stamps
KERNELS = {
    "mamba_scan": ("mamba_scan_f32_chunked_kernel", (
        "wait for the chunk's copies", "x tile and decay factors",
        "the state, M, y's (a C) h^T", "y += M dt x; state to shared")),
    "wkv6": ("wkv6_f32_chunked_kernel", (
        "wait for the chunk's copies", "tiles", "A's diagonal blocks",
        "r~, kq, decays across", "A below the diagonal",
        "y and the state", "state to shared")),
}
STAMPS = 512
PRELUDE = f"""
__device__ long long g_stamps[{STAMPS}];
__device__ int g_n_stamps;
// the count stays in a register: a stamp issues no load
#define STAMP() do {{ if (blockIdx.x == 0 && blockIdx.y == 0 && \\
    blockIdx.z == 0 && threadIdx.x == 0 && n_stamps_ < {STAMPS}) \\
    g_stamps[n_stamps_++] = clock64(); }} while (0)
extern "C" int scan_stamps(long long* out, int* n) {{
  cudaMemcpyFromSymbol(n, g_n_stamps, sizeof(int));
  cudaMemcpyFromSymbol(out, g_stamps, sizeof(long long) * {STAMPS});
  return 0;
}}
"""


def variant(name: str) -> str:
    """The source of ``name`` with stamps in its chunked kernel."""
    src = (CSRC / f"{name}.cu").read_text()
    kernel = KERNELS[name][0]
    start = src.index(f"{kernel}(")
    end = src.index("cudaError_t launch(", start)
    body = src[start:end]
    top = "    const int steps = min(kC, S - t0);\n"
    if body.count(top) != 1 or "__syncthreads();" not in body:
        raise SystemExit(f"anchors not found in {name}.cu")
    head = "  using namespace scan_mma;\n"
    if body.count(head) != 1:
        raise SystemExit(f"anchors not found in {name}.cu")
    body = body.replace(head, head + "  int n_stamps_ = 0;\n")
    body = body.replace(top, top + "    STAMP();\n")
    body = body.replace("__syncthreads();", "__syncthreads();\n    STAMP();")
    # the end of the last chunk
    last = "\n#pragma unroll\n  for (int nt = 0;"
    i = body.rindex(last)
    body = body[:i] + ("\n  STAMP();\n  if (blockIdx.x == 0 && blockIdx.y == 0 && "
                       "blockIdx.z == 0 && threadIdx.x == 0) "
                       "g_n_stamps = n_stamps_;") + body[i:]
    inc = '#include "scan_mma.cuh"\n'
    out = src[:start] + body + src[end:]
    return out.replace(inc, inc + PRELUDE)


def _alone(kind, args):
    """``args`` cut to one (batch row, head): a single block, with its SM
    to itself."""
    if kind == "mamba":
        x, dt, dec, Bm, Cm, h0 = args
        return (x[:1, :, :1].contiguous(), dt[:1, :, :1].contiguous(),
                dec[:1, :, :1].contiguous(), Bm[:1].contiguous(),
                Cm[:1].contiguous(), h0[:1, :1].contiguous())
    r, k, v, w, u, s0 = args
    return (*(t[:1, :, :1].contiguous() for t in (r, k, v, w)),
            u[:1].contiguous(), s0[:1, :1].contiguous())


def report(lib, fn, entry, phases, args, dev, label) -> None:
    """Run ``fn`` on ``args`` three times and print the last run's
    phases, then time it."""
    import torch
    from chip_smoke import time_ms
    from repro_torch.kernels import backend
    B, S, H, dh = args[0].shape
    y = torch.empty((B, S, H, dh), device=dev)
    st = torch.empty_like(args[-1])
    dims = (B, S, H, dh) + ((args[3].shape[-1],) if entry ==
                            "mamba_scan_f32" else ())
    stamps = np.zeros(STAMPS, np.int64)
    n = ctypes.c_int()
    def call():
        backend.check(entry, fn(
            *(t.data_ptr() for t in args), y.data_ptr(), st.data_ptr(),
            int(args[0].dtype == torch.bfloat16), *dims,
            backend.current_stream(dev)))
    for _ in range(3):  # the last run is read
        lib.scan_stamps(stamps.ctypes.data_as(ctypes.c_void_p),
                        ctypes.byref(n))
        call()
        torch.cuda.synchronize()
    lib.scan_stamps(stamps.ctypes.data_as(ctypes.c_void_p), ctypes.byref(n))
    per = len(phases)
    t = stamps[:n.value]
    chunks = (len(t) - 1) // per
    spans = np.diff(t[:chunks * per + 1]).reshape(chunks, per)
    total = t[-1] - t[0]
    print(f"{entry} ({label}) [B {B}, S {S}, H {H}, dh {dh}]: {total} "
          f"cycles over {chunks} chunks (block 0); "
          f"{time_ms(call) * 1e3:.2f} us a launch", flush=True)
    for k, name in enumerate(phases):
        c = spans[:, k]
        print(f"  {name:28s} {c.mean():9.0f} cycles a chunk, "
              f"{c.sum() / total:.3f} of the kernel", flush=True)


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from chip_smoke import SCAN_KERNELS, scan_inputs  # puts src on the path
    import torch
    from repro_torch import configs
    from repro_torch.kernels import backend
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = backend.resolve_device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        work = pathlib.Path(tmp)
        for h in CSRC.glob("*.cuh"):
            shutil.copy(h, work / h.name)
        procs = {}
        for name in KERNELS:
            src = work / f"{name}.cu"
            src.write_text(variant(name))
            out = work / f"lib{name}.so"
            procs[name] = (subprocess.Popen(
                [backend._nvcc(), *backend.NVCC_FLAGS, "-o", str(out),
                 str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), out)
        for name, (proc, out) in procs.items():
            kind, entry, cfg_name = next(
                (k, e, c) for k, e, _, c in SCAN_KERNELS
                if (k == "mamba") == (name == "mamba_scan"))
            log, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"nvcc failed for {name}:\n{log}")
            lib = ctypes.CDLL(str(out))
            fn = getattr(lib, entry)
            fn.argtypes = backend._ENTRY_POINTS[name][entry]
            fn.restype = ctypes.c_int
            g = torch.Generator().manual_seed(12)
            full = scan_inputs(torch, dev, kind, getattr(configs, cfg_name),
                               4, 512, g)
            for label, args in (("full", full),
                                ("alone", _alone(kind, full))):
                report(lib, fn, entry, KERNELS[name][1], args, dev, label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
