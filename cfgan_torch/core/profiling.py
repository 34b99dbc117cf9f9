"""Profiling hooks (mirrors `cfgan/core/profiling.py`):

- `trace(log_dir)`: a `torch.profiler` trace of the enclosed work, host
  and (where there is a card) device, written to `log_dir` as a Chrome
  trace JSON file that TensorBoard's profiler plugin and Perfetto open;
- `annotate(name)`: a named range in that trace, and an NVTX range where
  CUDA is present;
- `StepTimer`: wall-clock steps and items per second, the timing ended
  by a synchronize of the device of the value `fence` was given: CUDA
  calls return before the card has run them.
"""
from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """`with trace("/tmp/tb"): run_steps()`: the trace is written into
    `log_dir` as `<host>_<pid>.<ms>.pt.trace.json` when the block ends
    (`torch.profiler.tensorboard_trace_handler`)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str):
    """A named range of the enclosed host work in the profiler's trace
    (`record_function`), and an NVTX range where CUDA is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Throughput with the device's asynchrony fenced.

    >>> timer = StepTimer(items_per_step=batch_size)
    >>> with timer.measure():
    ...     for _ in range(n):
    ...         out = step(...)
    ...     timer.fence(out)   # the timing ends when `out` is computed
    >>> timer.items_per_sec(n)
    """

    def __init__(self, items_per_step: int = 1):
        self.items_per_step = items_per_step
        self.elapsed: float = 0.0
        self._fence_out = None

    @contextlib.contextmanager
    def measure(self):
        self._fence_out = None
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            _wait_for(self._fence_out)
            self.elapsed = time.perf_counter() - t0

    def fence(self, out):
        """Register the value (a tensor, or a dict, list or tuple of them)
        whose computation ends the timing; returns it."""
        self._fence_out = out
        return out

    def steps_per_sec(self, n_steps: int) -> float:
        return n_steps / self.elapsed if self.elapsed else float("inf")

    def items_per_sec(self, n_steps: int) -> float:
        return self.steps_per_sec(n_steps) * self.items_per_step


def _wait_for(out) -> None:
    """Synchronize the CUDA device of each tensor in `out`; a CPU tensor
    is computed when its op returns and needs no wait."""
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for o in out:
            _wait_for(o)
    elif isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)
