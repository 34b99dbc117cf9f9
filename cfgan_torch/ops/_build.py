"""Build the port's CUDA sources with plain `nvcc` and load them with ctypes.

At first use in a process, one `nvcc` command compiles `csrc/conv3x3.cu`
into a shared library with a plain C interface under `build/cfgan_torch/`
at the root of the checkout, and `ctypes` loads it.  No PyTorch header is
included, so the build takes seconds.  The `-Xptxas -v` report (registers,
shared memory and spills of each kernel) is kept on the returned object.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "conv3x3.cu"
BUILD_DIR = _PKG.parent / "build" / "cfgan_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

#: C entry points: (x, kernel, out, B, H, W, Cin, Cout, stream) -> cudaError_t
CONV3X3_FUNCTIONS = {"float32": "cfgan_conv3x3_f32",
                     "bfloat16": "cfgan_conv3x3_bf16"}

_lock = threading.Lock()
_library: "KernelLibrary | None" = None


@dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # wall time of the nvcc command
    ptxas_log: str  # nvcc's -Xptxas -v report


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _build() -> KernelLibrary:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / "libcfgan_conv3x3.so"
    tmp = BUILD_DIR / f".libcfgan_conv3x3.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    # atomic, so concurrent builders never load a torn file
    os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name in CONV3X3_FUNCTIONS.values():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return KernelLibrary(lib, out, seconds, log)


def load_library() -> KernelLibrary:
    """Build (once per process) and return the kernel library.  Raises if
    `nvcc` is missing or fails: there is no fallback."""
    global _library
    with _lock:
        if _library is None:
            _library = _build()
        return _library
