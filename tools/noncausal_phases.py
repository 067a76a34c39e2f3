#!/usr/bin/env python3
"""Where the non-causal bf16 attention kernels spend their time, on one
NVIDIA GPU:

    python3 tools/noncausal_phases.py [TREE]

TREE is a checkout of this repository (default: this one), for example
the parent commit unpacked by ``git archive`` under ``ab/`` (which
``.gitignore`` lists). The tool builds a variant of that checkout's
``kernels/csrc/flash_prefill.cu`` and ``flash_decode.cu`` (timing only)
in which thread 0 of the stamped blocks reads ``clock64()`` at fixed
anchors of the kernel that runs the non-causal mode, loads it in place of
the library the checkout's wrapper would build, and calls the checkout's
own ``flash_attention`` on bf16 inputs made from a seed at the cases of
``chip_smoke.MM_NONCAUSAL_CASES`` (this checkout's) with Dh 64 or 128.

Two designs are known, by the kernel the source holds:

* the causal kernels' non-causal mode (their ``<Dh, false>``
  instantiation, before the non-causal forms had kernels of their own).
  The prefill stamps block (0, 0, 0) at every key tile: the wait for the
  tile's copy and the barrier, Q.K^T, the softmax, P.V, the trailing
  barrier. The decode stamps every split of (b 0, g 0): the loads (K and
  q), the scores, the softmax (with V's wait), P.V, the partial's write
  and arrival, and, in the block that combines, the combine.
* kernels of their own (``flash_prefill_bf16_noncausal_kernel``,
  ``flash_decode_bf16_noncausal_kernel``). The prefill stamps block
  (0, 0, 0) per key tile (the next tile's wait and Q.K^T issue, this
  tile's P.V issue, the wait for Q.K^T and the softmax under P.V, the
  wait for P.V, the stage's refill and the fold of the correction) and
  its epilogue (o, or the chunk's partial into shared memory, then the
  cluster barrier and its share of the combine). The decode stamps every
  split of (b 0, g 0) per key tile (the copy's wait and barrier, Q.K^T,
  the softmax, P.V) and its end (the warps' partials into shared memory,
  their merge into the split's, the cluster barrier and its share of the
  combine).

A phase is the span from one stamp to the next, as thread 0 sees it: its
own work, its waits on the others at a barrier, and the tensor cores'
latency where the next phase needs their result. Prints, per case and
phase, the SM cycles (mean over key tiles or splits) and the share of the
stamped block's cycles, and each variant's device µs a launch
(``torch.profiler``, ``causal_ab._device_us``) beside the unstamped
kernel's. The card's name and power limit come first. A missing anchor
stops the tool.
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
SLOT = 160  # stamps a block may record
SLOTS = 32  # blocks that record (a decode: its splits of (b 0, g 0))
STAMPS = SLOT * SLOTS
PRELUDE = f"""
__device__ long long g_stamps[{STAMPS}];
__device__ int g_counts[{SLOTS}];
#define STAMP_AT(slot, on) do {{ if ((on) && threadIdx.x == 0 && \\
    (slot) < {SLOTS} && n_stamps_ < {SLOT}) \\
    g_stamps[(slot) * {SLOT} + n_stamps_++] = clock64(); }} while (0)
#define STAMP_DONE(slot, on) do {{ if ((on) && threadIdx.x == 0 && \\
    (slot) < {SLOTS}) g_counts[(slot)] = n_stamps_; }} while (0)
extern "C" int phase_stamps(long long* out, int* counts) {{
  cudaMemcpyFromSymbol(counts, g_counts, sizeof(int) * {SLOTS});
  cudaMemcpyFromSymbol(out, g_stamps, sizeof(long long) * {STAMPS});
  const int zero[{SLOTS}] = {{0}};
  cudaMemcpyToSymbol(g_counts, zero, sizeof(int) * {SLOTS});
  return 0;
}}
"""


def _edit(body: str, anchor: str, before: str = "", after: str = "",
          count: int = 1) -> str:
    """``body`` with ``before`` / ``after`` placed around each of the
    ``count`` occurrences of ``anchor`` (stop when it is not found so)."""
    if body.count(anchor) != count:
        raise SystemExit(f"anchor found {body.count(anchor)} times, not "
                         f"{count}: {anchor!r}")
    return body.replace(anchor, before + anchor + after)


def _kernel_span(src: str, kernel: str, end: str):
    start = src.index(f"{kernel}(")
    return start, src.index(end, start)


# the causal kernels' non-causal mode ---------------------------------------
OLD_PREFILL = ("wait and barrier", "Q.K^T", "softmax", "P.V",
               "trailing barrier")
OLD_DECODE = ("loads (K, q)", "scores", "softmax (V's wait)", "P.V",
              "partial's write, arrival", "combine")


def old_prefill(src: str) -> str:
    start, end = _kernel_span(src, "flash_prefill_bf16_kernel",
                              "template <int DH, bool CAUSAL>\nint launch(")
    b = src[start:end]
    on = "blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0"
    st = f"STAMP_AT(0, {on});"
    b = _edit(b, "  extern __shared__ __align__(16) unsigned char smem[];\n",
              after="  int n_stamps_ = 0;\n")
    b = _edit(b, "  for (int kt = t0; kt < t1; ++kt) {\n", before=f"  {st}\n")
    b = _edit(b, "    const bf16* ks = kvs + 2 * stage", before=f"    {st}\n")
    b = _edit(b, "    // scale (to log2 units); mask only tiles",
              before=f"    {st}\n")
    b = _edit(b, "    // O += P V, P as hi + lo bf16 halves;",
              before=f"    {st}\n")
    b = _edit(b, "    __syncthreads();  // this stage is free for the load "
              "two tiles on\n", before=f"    {st}\n", after=f"    {st}\n")
    b = _edit(b, "\n#pragma unroll\n  for (int x = 0; x < 2; ++x) {\n"
              "    l[x] += __shfl_xor_sync",
              before=f"\n  STAMP_DONE(0, {on});")
    return src[:start] + b + src[end:]


def old_decode(src: str) -> str:
    start, end = _kernel_span(src, "flash_decode_bf16_kernel",
                              "template <int DH, bool CAUSAL>\nint launch(")
    b = src[start:end]
    on = "blockIdx.y == 0 && blockIdx.z == 0"
    st = f"STAMP_AT(blockIdx.x, {on});"
    b = _edit(b, "  extern __shared__ __align__(16) unsigned char smem[];\n",
              after="  int n_stamps_ = 0;\n")
    b = _edit(b, "  if (split < first || split >= first + n_live) return;\n",
              after=f"  {st}\n")
    b = _edit(b, "  cp_async_wait<1>();  // K has landed; V may still be in "
              "flight\n  __syncthreads();\n", after=f"  {st}\n")
    b = _edit(b, "    sc[h * kSplit + r] = a;\n  }\n  __syncthreads();\n",
              after=f"  {st}\n")
    b = _edit(b, "  cp_async_wait<0>();\n  __syncthreads();\n",
              after=f"  {st}\n")
    b = _edit(b, "  if (kGroups > 1) {\n    __syncthreads();",
              before=f"  {st}\n")
    b = _edit(b, "  if (!combine) return;\n",
              before=f"  {st}\n  if (!combine) STAMP_DONE(blockIdx.x, {on});\n")
    b = _edit(b, "  if (pb != nullptr) {\n    // exp(s - m_j)",
              before=f"  {st}\n  STAMP_DONE(blockIdx.x, {on});\n")
    return src[:start] + b + src[end:]


# the non-causal kernels of their own ----------------------------------------
NEW_PREFILL = ("turn, next tile's wait, Q.K^T", "P.V issue",
               "Q.K^T wait, softmax", "P.V wait", "refill, fold")
NEW_PREFILL_END = ("o, or the partial to shared", "cluster barrier, combine")
NEW_DECODE = ("copy's wait, barrier", "Q.K^T", "softmax", "P.V")
NEW_DECODE_END = ("warps' partials to shared", "merge into the split's",
                  "cluster barrier, combine")


def new_prefill(src: str) -> str:
    start, end = _kernel_span(src, "flash_prefill_bf16_noncausal_kernel",
                              "// -- end of the non-causal kernel")
    b = src[start:end]
    on = "blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0"
    st = f"STAMP_AT(0, {on});"
    done = f"STAMP_DONE(0, {on});"
    b = _edit(b, "  const Base sm(smem_raw);\n", after="  int n_stamps_ = 0;\n")
    b = _edit(b, "  turn();\n  scores(0);\n", before=f"  {st}\n")
    b = _edit(b, "    scores(i + 1);\n", after=f"    {st}\n")
    b = _edit(b, "    mma_xb<DH>(acc, ph, pl, ring(s, 1));  // O += P V, P as hi "
              "+ lo halves\n    wg_commit();\n", after=f"    {st}\n")
    b = _edit(b, "    softmax(i + 1);\n", after=f"    {st}\n")
    b = _edit(b, "    // this warpgroup is done with stage s:", before=f"    {st}\n")
    b = _edit(b, "    fold();\n  }\n", after=f"    {st}\n")
    b = _edit(b, "    return;\n  }\n\n  // A chunk:", before=f"    {st}\n    {done}\n")
    b = _edit(b, "  cg::cluster_group cluster = cg::this_cluster();\n",
              before=f"  {st}\n")
    b = b[:b.rindex("}")] + f"  {st}\n  {done}\n}}\n"
    return src[:start] + b + src[end:]


def new_decode(src: str) -> str:
    start, end = _kernel_span(src, "flash_decode_bf16_noncausal_kernel",
                              "// -- end of the non-causal kernel")
    b = src[start:end]
    on = "blockIdx.y == 0 && blockIdx.z == 0"
    st = f"STAMP_AT(blockIdx.x, {on});"
    done = f"STAMP_DONE(blockIdx.x, {on});"
    b = _edit(b, "  extern __shared__ __align__(16) unsigned char smem[];\n",
              after="  int n_stamps_ = 0;\n")
    b = _edit(b, "  for (int i = 0; i < n_t; ++i) {\n    // tile i's copy group",
              before=f"  {st}\n")
    b = _edit(b, "      default: cp_async_wait<3>(); break;\n    }\n"
              "    __syncthreads();\n", after=f"    {st}\n")
    b = _edit(b, "    // scale to log2 units; keys past Nk are -inf.",
              before=f"    {st}\n")
    b = _edit(b, "    // O += P V over the warp's 16 keys", before=f"    {st}\n")
    b = _edit(b, "    if (i + n_st < n_t) {  // a ring", before=f"    {st}\n")
    b = _edit(b, "  // the split's partial after the warps'", before=f"  {st}\n")
    b = _edit(b, "  cg::cluster_group cluster = cg::this_cluster();\n",
              before=f"  {st}\n")
    b = b[:b.rindex("}")] + f"  {st}\n  {done}\n}}\n"
    return src[:start] + b + src[end:]


def variant(csrc: pathlib.Path, name: str):
    """(source with stamps, phases per tile, phases after the last tile,
    design) for library ``name`` of the checkout whose sources are in
    ``csrc``."""
    src = (csrc / f"{name}.cu").read_text()
    new = f"{name}_bf16_noncausal_kernel" in src
    if name == "flash_prefill":
        out = new_prefill(src) if new else old_prefill(src)
        phases = (NEW_PREFILL, NEW_PREFILL_END) if new else (OLD_PREFILL, ())
    else:
        out = new_decode(src) if new else old_decode(src)
        phases = (NEW_DECODE, NEW_DECODE_END) if new else ((), OLD_DECODE)
    inc = '#include "causal_tile.cuh"\n'
    if out.count(inc) != 1:
        raise SystemExit(f"anchor {inc!r} not found in {name}.cu")
    return (out.replace(inc, inc + PRELUDE), *phases,
            "own kernels" if new else "causal kernels' mode")


def report(lib, run, label, per_tile, tail, n_slots):
    """Run ``run`` three times, read the last run's stamps and print its
    phases."""
    import torch
    stamps = np.zeros(STAMPS, np.int64)
    counts = np.zeros(SLOTS, np.int32)
    for _ in range(3):
        lib.phase_stamps(stamps.ctypes.data_as(ctypes.c_void_p),
                         counts.ctypes.data_as(ctypes.c_void_p))
        run()
        torch.cuda.synchronize()
    lib.phase_stamps(stamps.ctypes.data_as(ctypes.c_void_p),
                     counts.ctypes.data_as(ctypes.c_void_p))
    rows = [stamps[s * SLOT:s * SLOT + counts[s]] for s in range(n_slots)
            if counts[s] > 0]
    if not rows:
        raise SystemExit(f"{label}: no stamps recorded")
    tile_spans, tail_spans, totals = [], [], []
    n = len(per_tile)
    for t in rows:
        d = np.diff(t)
        totals.append(t[-1] - t[0])
        # the spans after the last tile: all of ``tail``, or all but the
        # combine in a block that did not combine
        n_tail = len(d) if n == 0 else next(
            (m for m in (len(tail), len(tail) - 1)
             if m >= 0 and (len(d) - m) % n == 0), len(tail))
        if n:
            n_tiles = (len(d) - n_tail) // n
            tile_spans.append(d[:n_tiles * n].reshape(n_tiles, n))
        tail_spans.append(d[len(d) - n_tail:])
    total = float(np.mean(totals))
    print(f"  {label}: {len(rows)} stamped block(s), {total:.0f} cycles a "
          f"block (mean)", flush=True)
    if n:
        spans = np.concatenate(tile_spans)
        for k, name in enumerate(per_tile):
            c = spans[:, k]
            print(f"    {name:28s} {c.mean():9.0f} cycles a tile, "
                  f"{c.sum() / len(rows) / total:.3f} of the block",
                  flush=True)
    for k, name in enumerate(tail):
        c = [s[k] for s in tail_spans if len(s) > k]
        if c:
            print(f"    {name:28s} {np.mean(c):9.0f} cycles "
                  f"({len(c)} block(s)), "
                  f"{np.sum(c) / len(rows) / total:.3f} of the block",
                  flush=True)


def main() -> int:
    tree = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else ROOT).resolve()
    sys.path.insert(0, str(ROOT))
    from causal_ab import _device_us
    from chip_smoke import MM_NONCAUSAL_CASES
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import ops as FA
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = backend.resolve_device("cuda")
    csrc = tree / "src" / "repro_torch" / "kernels" / "csrc"
    cases = [c for c in MM_NONCAUSAL_CASES if c[1][3] in (64, 128)]
    g = torch.Generator().manual_seed(12)
    inputs = []
    for label, q_shape, kv_shape in cases:
        q = torch.randn(q_shape, generator=g).to(dev, torch.bfloat16)
        k, v = (torch.randn(kv_shape, generator=g).to(dev, torch.bfloat16)
                for _ in range(2))
        inputs.append((label, q, k, v))

    def run_all():  # device us a launch, by case (None where it failed)
        times = {}
        for label, q, k, v in inputs:
            try:
                times[label] = sum(_device_us(
                    lambda q=q, k=k, v=v: FA.flash_attention(q, k, v))
                    .values())
            except RuntimeError as e:
                print(f"{label}: {e}", flush=True)
                times[label] = None
        return times

    plain = run_all()
    with tempfile.TemporaryDirectory() as tmp:
        work = pathlib.Path(tmp)
        for h in csrc.glob("*.cuh"):
            shutil.copy(h, work / h.name)
        procs = {}
        for name in ("flash_prefill", "flash_decode"):
            src, per_tile, tail, design = variant(csrc, name)
            (work / f"{name}.cu").write_text(src)
            out = work / f"lib{name}.so"
            procs[name] = (subprocess.Popen(
                [backend._nvcc(), *backend.NVCC_FLAGS, "-o", str(out),
                 str(work / f"{name}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), out, per_tile, tail,
                design)
        libs = {}
        for name, (proc, out, per_tile, tail, design) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"nvcc failed for {name}:\n{log}")
            lib = ctypes.CDLL(str(out))
            for fn_name, argtypes in backend._ENTRY_POINTS[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            backend._LIBS[name] = lib
            libs[name] = (lib, per_tile, tail, design)
        backend._FNS.clear()
        stamped = run_all()
        for label, q, k, v in inputs:
            decode = q.shape[1] == 1
            name = "flash_decode" if decode else "flash_prefill"
            lib, per_tile, tail, design = libs[name]
            print(f"{name} non-causal ({design}), {label}: q "
                  f"{list(q.shape)} over k, v {list(k.shape)}: "
                  f"{plain[label]} device us a launch unstamped, "
                  f"{stamped[label]} stamped", flush=True)
            if stamped[label] is None:
                continue
            report(lib, lambda q=q, k=k, v=v: FA.flash_attention(q, k, v),
                   label, per_tile, tail, SLOTS if decode else 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
