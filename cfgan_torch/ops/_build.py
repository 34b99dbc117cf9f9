"""Build the port's CUDA sources with plain `nvcc` and load them with ctypes.

At first use in a process, one `nvcc -c` for each source in `SOURCES`, all
started together, compiles it to an object file under `build/cfgan_torch/`
at the root of the checkout; one more `nvcc` links them into one shared
library with a plain C interface, and `ctypes` loads it.  No PyTorch header
is included, so the build takes seconds.  The `-Xptxas -v` report
(registers, shared memory and spills of each kernel) is kept on the
returned object.
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
SOURCES = (_PKG / "csrc" / "conv3x3.cu", _PKG / "csrc" / "epilogue.cu",
           _PKG / "csrc" / "conv3x3_dkernel.cu")
BUILD_DIR = _PKG.parent / "build" / "cfgan_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry point -> its argument types; each returns a cudaError_t as int
SIGNATURES = {
    # (Cin, Cout) -> floats of the f32 conv's workspace, or 0
    "cfgan_conv3x3_f32_workspace": [_I] * 2,
    # (x, kernel, out, workspace, B, H, W, Cin, Cout, flip, workspace
    # floats, stream)
    "cfgan_conv3x3_f32": [_P] * 4 + [_I] * 7 + [_P],
    # (x, kernel, out, B, H, W, Cin, Cout, flip, stream)
    "cfgan_conv3x3_bf16": [_P] * 3 + [_I] * 6 + [_P],
    # (B, H, W, Cin, Cout, f32) -> partial-sum blocks, or -cudaError_t
    "cfgan_conv3x3_dkernel_blocks": [_I] * 6,
    # (x, g, partials, dk, B, H, W, Cin, Cout, blocks, stream)
    "cfgan_conv3x3_dkernel_bf16": [_P] * 4 + [_I] * 6 + [_P],
    "cfgan_conv3x3_dkernel_f32": [_P] * 4 + [_I] * 6 + [_P],
    # (x, raw, mask, cf, sums, B, N, lo, hi, vec, stream)
    "cfgan_epilogue_fwd_f32": [_P] * 5 + [_I] * 2 + [_F] * 2 + [_I, _P],
    # (x, raw, mask, gcf, gl1, gl2, gpen, dx, draw, B, N, lo, hi, vec,
    # stream)
    "cfgan_epilogue_bwd_f32": [_P] * 9 + [_I] * 2 + [_F] * 2 + [_I, _P],
}

_lock = threading.Lock()
_library: "KernelLibrary | None" = None


@dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # wall time of the nvcc commands
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
    out = BUILD_DIR / "libcfgan_kernels.so"
    tag = os.getpid()
    tmp = BUILD_DIR / f".libcfgan_kernels.{tag}.so"
    objs = [BUILD_DIR / f".{src.stem}.{tag}.o" for src in SOURCES]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    compiles = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))
                for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                             str(src)] for src, obj in zip(SOURCES, objs))]
    log = ""
    failed = []
    for cmd, proc in compiles:
        log += proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode})")
    link = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed.append(f"{' '.join(link)} ({proc.returncode})")
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "; ".join(failed) + "\n" + log)
    # atomic, so concurrent builders never load a torn file
    os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
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
