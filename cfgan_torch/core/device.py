"""Device resolution for the port's entry points."""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means the CUDA card.  Raises where a CUDA device is asked for
    and none is present: entry points never carry on on the CPU unless the
    caller passes `device="cpu"`."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU with the kernels' plain PyTorch versions")
    return device


def torch_dtype(name: str) -> torch.dtype:
    """'float32' / 'bfloat16' -> torch dtype."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise ValueError(f"unsupported compute dtype {name!r}")
    return dtypes[name]


@contextlib.contextmanager
def deterministic_cudnn() -> Iterator[None]:
    """cuDNN's deterministic algorithms, with its autotuner off, inside the
    block; the previous settings after it.  The default algorithms of a
    transposed conv may give other bits for the same weights and inputs
    from one call to the next."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
