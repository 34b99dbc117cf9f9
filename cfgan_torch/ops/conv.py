"""SAME-padded stride-1 3x3 NHWC convolution (`cfgan/ops/conv.py`).

`conv3x3_same` is the wrapper of the hand-written CUDA kernel
(`cfgan_torch/csrc/conv3x3.cu`) that replaces the JAX package's Pallas kernel
`_pallas_conv3x3_kernel`.  `conv3x3_same_plain` is its plain PyTorch version,
nine shifted-tap matmuls mirroring `conv3x3_same_matmul`: the CPU path, and
the yardstick the kernel is held against on the card.
`conv3x3_same_pallas` is the differentiable conv, an `autograd.Function`
mirroring `make_conv3x3_same_pallas`: its backward runs dx through the same
kernel and dK as one matmul over the nine stacked taps.
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


def _taps(x: torch.Tensor) -> list[torch.Tensor]:
    """The nine SAME-padded shifted taps of NHWC `x` in float32, each
    (B*H*W, Cin), in (dy, dx) order."""
    b, h, w, cin = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    return [xp[:, dy:dy + h, dx:dx + w, :].reshape(b * h * w, cin)
            for dy in range(3) for dx in range(3)]


def conv3x3_same_plain(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Nine shifted-tap (B*H*W, Cin) @ (Cin, Cout) matmuls accumulated in
    float32, cast once to `x.dtype`.  `kernel` is HWIO (3, 3, Cin, Cout)."""
    _check_kernel_shape(x, kernel)
    b, h, w, cin = x.shape
    cout = kernel.shape[-1]
    acc = None
    for tap, k in zip(_taps(x), kernel.float().reshape(9, cin, cout)):
        t = tap @ k
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


def conv3x3_same_dkernel(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dK[dy, dx] = tap(x, dy, dx)^T @ g, float32 in and out, as one
    (9*Cin, B*H*W) @ (B*H*W, Cout) product over the stacked taps
    (`make_conv3x3_same_pallas`'s backward computes these outside its
    kernel too)."""
    cin, cout = x.shape[-1], g.shape[-1]
    gm = g.float().reshape(-1, cout)
    return (torch.cat(_taps(x), dim=1).T @ gm).reshape(3, 3, cin, cout)


class _Conv3x3SamePallas(torch.autograd.Function):
    """Forward: `conv3x3_same`.  Backward: dx is the SAME 3x3 conv of the
    cotangent with the kernel flipped in both spatial axes and its
    channels transposed, through `conv3x3_same` again (the kernel on the
    card, f32 accumulation and one rounding); dK is
    `conv3x3_same_dkernel`."""

    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(x, kernel)
        return conv3x3_same(x, kernel)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        g = g.contiguous()
        dx = dk = None
        if ctx.needs_input_grad[0]:
            k_t = kernel.flip(0, 1).transpose(2, 3).to(g.dtype).contiguous()
            dx = conv3x3_same(g, k_t).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dk = conv3x3_same_dkernel(x, g).to(kernel.dtype)
        return dx, dk


def conv3x3_same_pallas(x: torch.Tensor, kernel: torch.Tensor
                        ) -> torch.Tensor:
    """Differentiable SAME 3x3 conv through the hand-written kernel, NHWC in
    and out, HWIO kernel; dispatch as for `conv3x3_same`."""
    return _Conv3x3SamePallas.apply(x, kernel)
