"""SAME-padded stride-1 3x3 NHWC convolution (`cfgan/ops/conv.py`).

`conv3x3_same` is the wrapper of the hand-written CUDA kernel
(`cfgan_torch/csrc/conv3x3.cu`) that replaces the JAX package's Pallas kernel
`_pallas_conv3x3_kernel`.  `conv3x3_same_plain` is its plain PyTorch version,
nine shifted-tap matmuls mirroring `conv3x3_same_matmul`: the CPU path, and
the yardstick the kernel is held against on the card.  Forward only; the
backward comes with the training slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from cfgan_torch.ops import _build

_KERNEL_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def conv_flops(batch: int, hw: tuple[int, int], cin: int, cout: int,
               k: int = 3) -> int:
    """2 * MACs of one SAME conv (`cfgan.ops.conv.conv_flops`)."""
    return 2 * batch * hw[0] * hw[1] * cin * cout * k * k


def _check_kernel_shape(x: torch.Tensor, kernel: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(
            f"conv3x3: x must be NHWC, got shape {tuple(x.shape)}")
    if kernel.dim() != 4 or tuple(kernel.shape[:3]) != (3, 3, x.shape[-1]):
        raise ValueError(f"conv3x3: kernel {tuple(kernel.shape)} does not "
                         f"match input {tuple(x.shape)}")


def conv3x3_same_plain(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Nine shifted-tap (B*H*W, Cin) @ (Cin, Cout) matmuls accumulated in
    float32, cast once to `x.dtype`.  `kernel` is HWIO (3, 3, Cin, Cout)."""
    _check_kernel_shape(x, kernel)
    b, h, w, cin = x.shape
    cout = kernel.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    k = kernel.float()
    acc = None
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy:dy + h, dx:dx + w, :].reshape(b * h * w, cin)
            t = tap @ k[dy, dx]
            acc = t if acc is None else acc + t
    return acc.to(x.dtype).reshape(b, h, w, cout)


def conv3x3_same(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SAME-padded stride-1 3x3 conv, NHWC in and out, HWIO kernel.

    A CPU tensor takes the plain version.  A CUDA tensor launches the
    hand-written kernel (float32 or bfloat16, f32 accumulation, one rounding
    at the store) or raises: there is no fallback.  Each launch adds one to
    `conv3x3_same.launches`."""
    if x.device.type == "cpu":
        return conv3x3_same_plain(x, kernel)
    lib = _build.load_library().lib  # raises where the kernel cannot be built
    _check_kernel_shape(x, kernel)
    if x.device.type != "cuda" or kernel.device != x.device:
        raise ValueError(f"conv3x3: x on {x.device} and kernel on "
                         f"{kernel.device}; both must be on one CUDA device")
    if x.dtype not in _KERNEL_DTYPES or kernel.dtype != x.dtype:
        raise TypeError(f"conv3x3: x {x.dtype} / kernel {kernel.dtype}; the "
                        "kernel takes float32 or bfloat16 for both")
    if not (x.is_contiguous() and kernel.is_contiguous()):
        raise ValueError("conv3x3: x and kernel must be contiguous")
    b, h, w, cin = x.shape
    cout = kernel.shape[-1]
    if max(b, h, w, cin, cout) >= 2 ** 31:
        raise ValueError(f"conv3x3: dims of {tuple(x.shape)} -> {cout} "
                         "exceed the kernel's 32-bit sizes")
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0 or cin == 0:
        return out.zero_()
    fn = getattr(lib, _build.CONV3X3_FUNCTIONS[_KERNEL_DTYPES[x.dtype]])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), kernel.data_ptr(), out.data_ptr(),
                 b, h, w, cin, cout, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: cudaError {err}")
    conv3x3_same.launches += 1
    return out


conv3x3_same.launches = 0
