"""Training metrics fanned out to a history, a JSONL file and stdout, and
the directory the port's compiled libraries live in (mirrors
`cfgan/core/logging.py`).

`setup_compile_cache` is the counterpart of the JAX package's persistent
XLA cache: the directory where `cfgan_torch/ops/_build.py` builds and
loads the CUDA kernel library and `cfgan_torch/native` the C++ data
library.  A process loads each library once, from one directory.
"""
from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Mapping

import numpy as np


class MetricLogger:
    """`log(step, metrics)` appends a record {"step", "time", metric:
    float} to `history`, writes it as one JSON line to
    `{out_dir}/{name}_metrics.jsonl` (appended to; none without `out_dir`)
    and prints it every `print_every` steps.  `time` is seconds since the
    logger was made.  A metric may be a number, a numpy array or a
    one-element tensor (read on the host: each `log` of a device tensor
    waits for the device)."""

    def __init__(self, out_dir: str | None = None, name: str = "train",
                 print_every: int = 1):
        self.out_dir = out_dir
        self.name = name
        self.print_every = print_every
        self.history: list[dict[str, Any]] = []
        self._t0 = time.perf_counter()
        self._fh = None
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            self._fh = open(os.path.join(out_dir, f"{name}_metrics.jsonl"),
                            "a")

    def log(self, step: int, metrics: Mapping[str, Any],
            prefix: str = "") -> None:
        rec = {"step": int(step), "time": time.perf_counter() - self._t0}
        for k, v in metrics.items():
            rec[k] = float(v.item() if hasattr(v, "item") else v)
        self.history.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.print_every and step % self.print_every == 0:
            body = ", ".join(f"{k}={v:.4f}" for k, v in rec.items()
                             if k not in ("step", "time"))
            print(f"[{prefix or self.name}] step {step} :: {body}")

    def series(self, key: str) -> np.ndarray:
        """The logged values of `key`, in order."""
        return np.array([h[key] for h in self.history if key in h])

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


#: where the libraries are built without an argument or CFGAN_TORCH_CACHE:
#: `build/cfgan_torch/` at the root of the checkout (listed in .gitignore)
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / "build" / "cfgan_torch"
CACHE_ENV = "CFGAN_TORCH_CACHE"

_cache_lock = threading.Lock()
_cache_dir: Path | None = None  # chosen by setup_compile_cache
_pinned: Path | None = None  # a library was loaded from it


def _resolve(cache_dir: str | os.PathLike | None) -> Path:
    return Path(cache_dir or os.environ.get(CACHE_ENV)
                or DEFAULT_CACHE_DIR).expanduser().absolute()


def setup_compile_cache(cache_dir: str | os.PathLike | None = None) -> str:
    """Choose the directory the port's libraries are built into and
    loaded from: `cache_dir`, else `$CFGAN_TORCH_CACHE`, else
    `DEFAULT_CACHE_DIR`.  Creates it and returns it.  Raises RuntimeError
    where a library of this process was already loaded from another
    directory: a process never loads a second copy.  Called by the
    experiment mains."""
    global _cache_dir
    path = _resolve(cache_dir)
    with _cache_lock:
        if _pinned is not None and path != _pinned:
            raise RuntimeError(
                f"the port's libraries were loaded from {_pinned}; this "
                f"process cannot switch its compile cache to {path}")
        path.mkdir(parents=True, exist_ok=True)
        _cache_dir = path
    return str(path)


def compile_cache_dir() -> Path:
    """The directory a library is built into: the one a library was loaded
    from, else the one `setup_compile_cache` chose, else where it would
    resolve without an argument."""
    with _cache_lock:
        return _pinned or _cache_dir or _resolve(None)


def pin_compile_cache(path: Path) -> None:
    """Record that a library was loaded from `path`; later calls of
    `setup_compile_cache` must name it.  Raises RuntimeError where a
    library was loaded from another directory."""
    global _pinned
    path = Path(path).absolute()
    with _cache_lock:
        if _pinned is not None and path != _pinned:
            raise RuntimeError(
                f"a library was loaded from {_pinned}; another from {path} "
                "would be a second compile cache in one process")
        _pinned = path
