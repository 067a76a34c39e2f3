"""Device resolution, numerics, and the build/load path of the hand-written
Hopper kernels (counterpart of the reference package's
``kernels/backend.py``, which picks Pallas interpret vs compiled mode).

Rules every kernel wrapper of this package follows:

* A wrapper given a CUDA tensor launches its kernel or raises. It never
  runs the plain PyTorch version on the card, and no environment variable
  changes that.
* A wrapper given a CPU tensor runs the plain version — the CPU parity
  tests hold the port against the reference package that way.
* Each launch adds one to its C entry point's count in :data:`LAUNCHES`
  (``sbmm_f32`` and ``sbmm_f16w`` apart, though one library holds both),
  at the launch site and nowhere else, so a run can show that the main
  path went through every kernel it needs. A launch in one of the
  :data:`FORMS` (the attention entry points' non-causal kernels) also adds
  one to that form's count in :data:`FORM_LAUNCHES`.

Build: each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface under ``build/repro_torch_kernels/`` at
the repository root, at first use, and loaded with ``ctypes``. All sources
compile concurrently (one ``nvcc`` each). A library's file name carries a
hash of its source and of the shared headers (``csrc/*.cuh``), so an
edited source is rebuilt and a stale library is never loaded. Every C
entry point returns ``cudaGetLastError()`` after its launch; :func:`check`
turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
P, I = ctypes.c_void_p, ctypes.c_int
_SBMM = [P] * 5 + [I] * 5 + [P]
_SBMM_QUANT = [P] * 6 + [I] * 5 + [P]
_FLASH = [P] * 7 + [I] * 4 + [ctypes.c_float, P]
_FLASH_BWD = [P] * 11 + [I] * 4 + [ctypes.c_longlong] * 2 + \
    [ctypes.c_float, P]
_FLASH_DECODE = [P] * 10 + [I] * 7 + [ctypes.c_float, P]
_FLASH_PREFILL = [P] * 8 + [I] * 9 + [ctypes.c_float, P]
_FLASH_PREFILL_BWD = [P] * 11 + [I] * 7 + [ctypes.c_float, P]
# C entry points and their signatures, by library (csrc/<library>.cu)
_ENTRY_POINTS = {
    "sbmm": {"sbmm_f32": _SBMM, "sbmm_f16w": _SBMM},
    "sbmm_quant": {"sbmm_i8_block": _SBMM_QUANT,
                   "sbmm_i8_channel": _SBMM_QUANT},
    "flash_attention": {"flash_attention_f32": _FLASH,
                        "flash_attention_f16": _FLASH},
    "flash_attention_bwd": {"flash_attention_bwd_f32": _FLASH_BWD},
    "flash_decode": {"flash_decode_bf16": _FLASH_DECODE},
    "flash_prefill": {"flash_prefill_bf16": _FLASH_PREFILL},
    "flash_prefill_bwd": {"flash_prefill_bwd_bf16": _FLASH_PREFILL_BWD},
    "token_drop": {"token_drop_f32": [P] * 4 + [I] * 5 + [P],
                   "token_drop_bwd_f32": [P] * 7 + [I] * 5 + [P]},
    "token_package": {"token_package_f32": [P] * 6 + [I] * 6 + [P]},
    "mamba_scan": {"mamba_scan_f32": [P] * 8 + [I] * 6 + [P]},
    "wkv6": {"wkv6_f32": [P] * 8 + [I] * 5 + [P]},
    "mamba_scan_bwd": {"mamba_scan_bwd_f32": [P] * 17 + [I] * 7 + [P]},
    "wkv6_bwd": {"wkv6_bwd_f32": [P] * 16 + [I] * 6 + [P]},
}
KERNELS = tuple(_ENTRY_POINTS)  # one library each
ENTRY_POINTS = tuple(fn for lib in _ENTRY_POINTS.values() for fn in lib)
# forms of an entry point counted apart as well, by name: the entry point
# each is a mode of (``causal`` 0 launches kernels of its own)
FORMS = {"flash_prefill_bf16/noncausal": "flash_prefill_bf16",
         "flash_decode_bf16/noncausal": "flash_decode_bf16",
         "flash_prefill_bwd_bf16/noncausal": "flash_prefill_bwd_bf16"}

# launches per C entry point, and per form (see module docstring)
LAUNCHES: Dict[str, int] = {name: 0 for name in ENTRY_POINTS}
FORM_LAUNCHES: Dict[str, int] = {name: 0 for name in FORMS}

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, ctypes._CFuncPtr] = {}  # resolved C entry points


# ---------------------------------------------------------------------------
# Device and numerics
# ---------------------------------------------------------------------------
def set_numerics() -> None:
    """The fp32 tier never runs on TF32 tensor cores: cuBLAS matmuls and
    cuDNN convolutions both stay full fp32. bf16 matmuls (the LMs'
    projections) accumulate in fp32 without reduced-precision split-K
    reductions, as XLA's do."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The device an entry point runs on. The default is the card; without
    one, only an explicit ``device="cpu"`` is accepted."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on an NVIDIA GPU by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        set_numerics()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def host_to_device(arr, device: torch.device,
                   dtype: "np.dtype | type" = np.float32) -> torch.Tensor:
    """A host array as a tensor on ``device`` without waiting on the card:
    for a CUDA device it is staged in pinned memory and copied
    asynchronously on the current stream (a copy from pageable memory
    synchronizes the stream). On the CPU the array's memory is shared."""
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=dtype))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (kernels that read their
    operands 16 bytes at a time): copied only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def on_card(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on the card (launch the kernel), False
    when they lie on the CPU (run the plain version); raises on a mix or
    on any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs must all lie on the card or all on "
                     f"the CPU, got devices {sorted(kinds)}")


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------
def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the kernels are compiled on the "
                       "machine with the card (CUDA toolkit under "
                       "/usr/local/cuda)")


def build(names: Iterable[str] = KERNELS, verbose: bool = False) -> float:
    """Compile every listed kernel library that is not built yet, all
    ``nvcc`` processes started together. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n} ---\n{log}")
            continue
        if verbose and log:
            print(f"[nvcc {n}]\n{log}", flush=True)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn_name, argtypes in _ENTRY_POINTS[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def disassemble(name: str) -> str:
    """The SASS of kernel library ``name`` (built on first use), as
    ``cuobjdump -sass`` prints it: which instructions each kernel
    issues."""
    build([name])
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(_lib_path(name))],
                          capture_output=True, text=True,
                          check=True).stdout


def check(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t "
                           f"{err} ({_error_string(err)})")


def _error_string(err: int) -> str:
    try:
        cudart = ctypes.CDLL("libcudart.so")
    except OSError:
        return "unknown"
    cudart.cudaGetErrorString.restype = ctypes.c_char_p
    return cudart.cudaGetErrorString(err).decode()


def launch(lib_name: str, entry_point: str, device: torch.device,
           *args, form: Optional[str] = None) -> None:
    """Call C entry point ``entry_point`` of library ``lib_name`` (built,
    loaded and resolved on first use) with ``args`` and PyTorch's current
    stream on ``device``, read at this call (every entry point takes the
    stream last), raise if the launch failed, and count it, also under
    ``form`` (a key of :data:`FORMS` naming a mode of ``entry_point``)."""
    fn = _FNS.get(entry_point)
    if fn is None:
        fn = _FNS[entry_point] = getattr(library(lib_name), entry_point)
    check(entry_point, fn(*args, current_stream(device)))
    LAUNCHES[entry_point] += 1
    if form is not None:
        FORM_LAUNCHES[form] += 1


def current_stream(device: torch.device) -> int:
    """The ``cudaStream_t`` of PyTorch's current stream on ``device``, read
    by the getter ``torch.cuda.current_stream`` wraps: that call also
    builds a ``Stream`` object each time, many times the cost of the read
    (``chip_smoke.py`` prints both)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def reset_launches() -> None:
    for counts in (LAUNCHES, FORM_LAUNCHES):
        for name in counts:
            counts[name] = 0


def launches() -> Dict[str, int]:
    """A copy of the launch counts, by C entry point."""
    return dict(LAUNCHES)


def form_launches() -> Dict[str, int]:
    """A copy of the launch counts of the :data:`FORMS`, by form."""
    return dict(FORM_LAUNCHES)
