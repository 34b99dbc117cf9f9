"""The port's C++ data path, loaded with ctypes (mirrors `cfgan/native`):
an IDX decoder and a multithreaded uint8 -> float32 normaliser from
`idx_loader.cpp`, built with `g++` at first use into the compile cache
(`cfgan_torch.core.logging.setup_compile_cache`; by default
`build/cfgan_torch/` at the root of the checkout, never beside the
source).

A build that fails raises with the compiler's output: nothing falls back
quietly.  The JAX package's `lib()` returns None there and its callers
take their Python paths; the plain versions here are
`cfgan_torch.data.mnist._read_idx_plain` and `normalize_plain`, which the
tests hold this library against.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from cfgan_torch.core.logging import compile_cache_dir, pin_compile_cache

SOURCE = Path(__file__).resolve().parent / "idx_loader.cpp"
LIBRARY = "libcfgan_idx.so"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    # atomic, so concurrent builders never load a torn file
    tmp = out.with_name(f".{out.stem}.{os.getpid()}.so")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{' '.join(cmd)} failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def lib() -> ctypes.CDLL:
    """The loaded library, built on first use where the compile cache has
    none older than the source.  Raises RuntimeError where `g++` is
    missing or fails."""
    global _lib
    with _lock:
        if _lib is None:
            out = compile_cache_dir() / LIBRARY
            if (not out.exists()
                    or out.stat().st_mtime < SOURCE.stat().st_mtime):
                _build(out)
            pin_compile_cache(out.parent)
            L = ctypes.CDLL(str(out))
            L.idx_read.restype = ctypes.c_int
            L.idx_read.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_ubyte),
                ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_int),
            ]
            L.u8_to_f32_norm.restype = None
            L.u8_to_f32_norm.argtypes = [
                ctypes.POINTER(ctypes.c_ubyte),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_longlong,
                ctypes.c_float,
                ctypes.c_float,
            ]
            _lib = L
        return _lib


def read_idx(path: str | os.PathLike) -> np.ndarray | None:
    """The uint8 array of an uncompressed IDX file, decoded natively.
    None, as the JAX package gives, for a `.gz` path, an unreadable file,
    a header that is not uint8 IDX, more than 8 dims, or a payload the
    decoder refuses (short, or larger than its header says); the caller
    then takes the Python decoder."""
    path = os.fspath(path)
    if path.endswith(".gz"):
        return None
    L = lib()
    try:  # peek the header to allocate the exact payload size
        with open(path, "rb") as f:
            head = f.read(4)
            if len(head) != 4 or head[0] or head[1] or head[2] != 0x08:
                return None
            ndims = head[3]
            if not 1 <= ndims <= 8:  # the dims buffer below has 8 slots
                return None
            shape = tuple(int.from_bytes(f.read(4), "big")
                          for _ in range(ndims))
    except OSError:
        return None
    out = np.empty(int(np.prod(shape)), np.uint8)
    dims = (ctypes.c_longlong * 8)()
    ndim = ctypes.c_int(0)
    rc = L.idx_read(path.encode(),
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                    out.size, dims, ctypes.byref(ndim))
    if rc != 0:
        return None
    return out.reshape(shape)


def normalize_u8(x: np.ndarray, mean: float, std: float) -> np.ndarray:
    """(x / 255 - mean) / std in float32, of the same shape, bit for bit
    the numpy version's (a 256-entry table rounded in that order).  `x`
    must be uint8; arrays of 1 << 20 elements or more are split over the
    host's threads."""
    x = np.asarray(x)
    if x.dtype != np.uint8:
        raise TypeError(f"normalize_u8 takes uint8, not {x.dtype}")
    x = np.ascontiguousarray(x)
    out = np.empty(x.shape, np.float32)
    lib().u8_to_f32_norm(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        x.size, ctypes.c_float(mean), ctypes.c_float(std))
    return out
