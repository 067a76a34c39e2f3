#!/usr/bin/env python3
"""The rate of the two fp32 product paths the recurrent scans can take, on
one NVIDIA GPU:

    python3 tools/mma_rate.py

Builds two throughput kernels and times each over the whole card (CUDA
events, ``chip_smoke.time_ms``): ``mma.sync.m16n8k8`` on TF32 operands, the
instruction the chunked scans issue three times per 3xTF32 product, with
eight independent accumulators a warp; and fp32 FMAs on the CUDA cores,
eight independent chains a thread; and the latency of one product, a
single warp's chain of dependent ``mma.sync`` (SM cycles by ``clock64``).
Prints each rate as multiply-adds per clock
per SM (at the card's highest SM clock, ``clocks.max.sm``, so a card that
runs slower reads low) and as TFLOP/s; the card's name and power limit
come first. The kernels' results
are kept alive, never read.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
ITERS = 4096        # dependent steps of each chain
BLOCKS_PER_SM = 4   # blocks of 256 threads
SOURCE = r"""
#include <cstdint>
extern "C" __global__ void mma_loop(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f);
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  float s = 0.f;
  for (int c = 0; c < 8; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  if (s == 1234.5f) out[0] = s;
}
extern "C" __global__ void ffma_loop(float* out, int iters) {
  float x[8];
  for (int c = 0; c < 8; ++c) x[c] = threadIdx.x + c;
  const float m = 0.999f, k = 0.001f;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < 8; ++c) x[c] = fmaf(x[c], m, k);
  float s = 0.f;
  for (int c = 0; c < 8; ++c) s += x[c];
  if (s == 1234.5f) out[0] = s;
}
// one warp, one chain of dependent products: SM cycles a product, in out[1]
extern "C" __global__ void mma_chain(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f);
  float d[4] = {};
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it)
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  const float s = d[0] + d[1] + d[2] + d[3];
  const long long t1 = clock64();
  if (threadIdx.x == 0) out[1] = (float)(t1 - t0) / iters + 0.f * s;
}
extern "C" int run(const char* which, float* out, int blocks, int iters,
                   void* stream) {
  if (which[0] == 'c') {
    mma_chain<<<1, 32, 0, (cudaStream_t)stream>>>(out, iters);
    return (int)cudaGetLastError();
  }
  void (*k)(float*, int) = which[0] == 'm' ? mma_loop : ffma_loop;
  k<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from chip_smoke import time_ms  # puts ROOT/src on the path
    import torch
    from repro_torch.kernels import backend
    smi = lambda q: subprocess.run(
        ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi("name,power.limit").splitlines()[0], flush=True)
    dev = backend.resolve_device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        lib_path = pathlib.Path(tmp) / "librate.so"
        (pathlib.Path(tmp) / "rate.cu").write_text(SOURCE)
        subprocess.run([backend._nvcc(), *backend.NVCC_FLAGS, "-o",
                        str(lib_path), str(pathlib.Path(tmp) / "rate.cu")],
                       check=True)
        lib = ctypes.CDLL(str(lib_path))
        lib.run.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_int, ctypes.c_void_p]
        out = torch.zeros(2, device=dev)
        blocks = BLOCKS_PER_SM * sms
        for which, fma_per_step in (("mma", 8 * 16 * 8 * 8 / 32),
                                    ("ffma", 8)):
            call = lambda: backend.check(which, lib.run(
                which.encode(), out.data_ptr(), blocks, ITERS,
                backend.current_stream(dev)))
            ms = time_ms(call, samples=5, calls=3, warmup=2)
            clock_mhz = float(smi("clocks.max.sm").split()[0])
            fmas = blocks * 256 * ITERS * fma_per_step
            per_clk_sm = fmas / (ms * 1e-3) / (clock_mhz * 1e6) / sms
            print(f"{which}: {ms:.3f} ms, {2 * fmas / ms / 1e9:.1f} TFLOP/s, "
                  f"{per_clk_sm:.0f} multiply-adds a clock an SM at "
                  f"{clock_mhz:.0f} MHz ({sms} SMs)", flush=True)
        backend.check("mma_chain", lib.run(b"chain", out.data_ptr(), 1, ITERS,
                                           backend.current_stream(dev)))
        print(f"mma chain: {out[1].item():.1f} SM cycles a dependent "
              f"product (one warp)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
