"""Training metrics fanned out to a history, a JSONL file and stdout
(mirrors `cfgan/core/logging.py::MetricLogger`).

The JAX package's `setup_compile_cache` sets JAX's compile cache and has
no counterpart here.
"""
from __future__ import annotations

import json
import os
import time
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
