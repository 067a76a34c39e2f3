"""Device resolution, numerics, and the build/load path of the hand-written
Hopper kernels (counterpart of the reference package's
``kernels/backend.py``, which picks Pallas interpret vs compiled mode).

Rules every kernel wrapper of this package follows:

* A wrapper given a CUDA tensor launches its kernel or raises. It never
  runs the plain PyTorch version on the card, and no environment variable
  changes that.
* A wrapper given a CPU tensor runs the plain version — the CPU parity
  tests hold the port against the reference package that way.
* Each launch adds one to the wrapper's count in :data:`LAUNCHES`, at the
  launch site and nowhere else, so a run can show that the main path went
  through the kernels.

Build: each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface under ``build/repro_torch_kernels/`` at
the repository root, at first use, and loaded with ``ctypes``. All sources
compile concurrently (one ``nvcc`` each). A library's file name carries a
hash of its source, so an edited source is rebuilt and a stale library is
never loaded. Every C entry point returns ``cudaGetLastError()`` after its
launch; :func:`check` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Iterable

import numpy as np
import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
KERNELS = ("sbmm", "flash_attention", "token_drop")

# launches per kernel wrapper (see module docstring)
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_LIBS: Dict[str, ctypes.CDLL] = {}
P, I = ctypes.c_void_p, ctypes.c_int
# C signatures of the entry points, by library
_ARGTYPES = {
    "sbmm": ("sbmm_f32", [P, P, P, P, I, I, I, I, P]),
    "flash_attention": ("flash_attention_f32",
                        [P, P, P, P, P, P, I, I, I, I, ctypes.c_float, P]),
    "token_drop": ("token_drop_f32", [P, P, P, P, I, I, I, I, P]),
}


# ---------------------------------------------------------------------------
# Device and numerics
# ---------------------------------------------------------------------------
def set_numerics() -> None:
    """The fp32 tier never runs on TF32 tensor cores: cuBLAS matmuls and
    cuDNN convolutions both stay full fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
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
        fn_name, argtypes = _ARGTYPES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


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


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device``; kernels launch on it."""
    return torch.cuda.current_stream(device).cuda_stream


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches() -> Dict[str, int]:
    """A copy of the launch counts, by kernel."""
    return dict(LAUNCHES)
