"""SAME-padded stride-1 3x3 NHWC convolution (`cfgan/ops/conv.py`).

`conv3x3_same` is the wrapper of the hand-written CUDA kernels
(`cfgan_torch/csrc/conv3x3.cu`) that replace the JAX package's Pallas kernel
`_pallas_conv3x3_kernel`, both on the tensor cores: bf16, and float32 as
3xTF32 products (each operand split into two tf32 parts, three products),
which keep float32's accuracy.  `conv3x3_same_plain` is its plain PyTorch
version, nine shifted-tap matmuls mirroring `conv3x3_same_matmul`: the CPU
path, and the yardstick the kernels are held against on the card.
`conv3x3_same_dkernel` is the wrapper of the weight-gradient kernels
(`cfgan_torch/csrc/conv3x3_dkernel.cu`, bf16 and 3xTF32 float32 on the
tensor cores, reading the taps in place); `conv3x3_same_dkernel_plain` is
its plain version, one product over the nine stacked taps.
`conv3x3_same_pallas` is the differentiable conv, an `autograd.Function`
mirroring `make_conv3x3_same_pallas`: its backward runs dx through
`conv3x3_same` with the kernel read flipped and transposed, and dK through
`conv3x3_same_dkernel` (the JAX package computes dK outside its kernel).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from cfgan_torch.ops import _build

def conv_flops(batch: int, hw: tuple[int, int], cin: int, cout: int,
               k: int = 3) -> int:
    """2 * MACs of one SAME conv (`cfgan.ops.conv.conv_flops`)."""
    return 2 * batch * hw[0] * hw[1] * cin * cout * k * k


def _check_kernel_shape(x: torch.Tensor, kernel: torch.Tensor,
                        transposed: bool = False) -> None:
    if x.dim() != 4:
        raise ValueError(
            f"conv3x3: x must be NHWC, got shape {tuple(x.shape)}")
    cin_axis = 3 if transposed else 2
    if (kernel.dim() != 4 or tuple(kernel.shape[:2]) != (3, 3)
            or kernel.shape[cin_axis] != x.shape[-1]):
        raise ValueError(f"conv3x3: kernel {tuple(kernel.shape)} does not "
                         f"match input {tuple(x.shape)}")


def _flipped(kernel: torch.Tensor) -> torch.Tensor:
    """The kernel of a conv's dx: flipped in both spatial axes, channels
    transposed."""
    return kernel.flip(0, 1).transpose(2, 3).contiguous()


def _check_cuda_pair(name: str, x: torch.Tensor, other: torch.Tensor,
                     dtypes: tuple) -> None:
    if x.device.type != "cuda" or other.device != x.device:
        raise ValueError(f"{name}: tensors on {x.device} and {other.device}; "
                         "both must be on one CUDA device")
    if x.dtype not in dtypes or other.dtype != x.dtype:
        raise TypeError(f"{name}: {x.dtype} / {other.dtype}; the kernel "
                        f"takes {' or '.join(map(str, dtypes))} for both")
    if not (x.is_contiguous() and other.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous")
    if max(*x.shape, *other.shape) >= 2 ** 31:
        raise ValueError(f"{name}: dims of {tuple(x.shape)} and "
                         f"{tuple(other.shape)} exceed the kernel's 32-bit "
                         "sizes")


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


def conv3x3_same(x: torch.Tensor, kernel: torch.Tensor, *,
                 transposed: bool = False) -> torch.Tensor:
    """SAME-padded stride-1 3x3 conv, NHWC in and out, HWIO kernel.
    `transposed=True` convolves with `kernel` flipped in both spatial axes
    and its channels transposed (`kernel` is then (3, 3, Cout, Cin)): the
    dx of a conv with `kernel`, from its output cotangent `x`.

    A CPU tensor takes the plain version.  A CUDA tensor launches the
    hand-written kernel (on the tensor cores, float32 as 3xTF32; f32
    accumulation, one rounding at the store) or raises: there is no
    fallback.  Each launch adds one to `conv3x3_same.launches` (in float32
    a launch is a small kernel that splits K into its tf32 parts, then the
    conv)."""
    if x.device.type == "cpu":
        _check_kernel_shape(x, kernel, transposed)
        return conv3x3_same_plain(x, _flipped(kernel) if transposed
                                  else kernel)
    lib = _build.load_library().lib  # raises where the kernel cannot be built
    _check_kernel_shape(x, kernel, transposed)
    _check_cuda_pair("conv3x3", x, kernel, (torch.float32, torch.bfloat16))
    b, h, w, cin = x.shape
    cout = kernel.shape[2] if transposed else kernel.shape[3]
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0 or cin == 0:
        return out.zero_()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if x.dtype == torch.bfloat16:
            err = lib.cfgan_conv3x3_bf16(x.data_ptr(), kernel.data_ptr(),
                                         out.data_ptr(), b, h, w, cin, cout,
                                         int(transposed), stream)
        else:  # K's tf32 parts, in the kernel's layout, go to a workspace
            floats = lib.cfgan_conv3x3_f32_workspace(cin, cout)
            if floats <= 0:
                raise ValueError(f"conv3x3: {cin} -> {cout} channels exceed "
                                 "the float32 kernel's workspace")
            ws = torch.empty(floats, dtype=torch.float32, device=x.device)
            err = lib.cfgan_conv3x3_f32(x.data_ptr(), kernel.data_ptr(),
                                        out.data_ptr(), ws.data_ptr(), b, h,
                                        w, cin, cout, int(transposed),
                                        floats, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: cudaError {err}")
    conv3x3_same.launches += 1
    return out


conv3x3_same.launches = 0


def conv3x3_same_dkernel_plain(x: torch.Tensor, g: torch.Tensor
                               ) -> torch.Tensor:
    """dK[dy, dx] = tap(x, dy, dx)^T @ g, float32 out, as one
    (9*Cin, B*H*W) @ (B*H*W, Cout) product over the stacked taps
    (`make_conv3x3_same_pallas`'s backward computes these outside its
    kernel too)."""
    cin, cout = x.shape[-1], g.shape[-1]
    gm = g.float().reshape(-1, cout)
    return (torch.cat(_taps(x), dim=1).T @ gm).reshape(3, 3, cin, cout)


def conv3x3_same_dkernel(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The weight gradient dK (3, 3, Cin, Cout), float32, of a SAME 3x3 conv
    of NHWC `x` under the output cotangent `g`.

    A CPU tensor takes the plain version.  A CUDA bfloat16 or float32 pair
    launches the hand-written kernel (tensor cores, float32 as 3xTF32; f32
    accumulation, the taps read in place, per-block partials summed in a
    fixed order) or raises: there is no fallback.  Each launch adds one to
    `conv3x3_same_dkernel.launches`."""
    if x.device.type == "cpu":
        return conv3x3_same_dkernel_plain(x, g)
    lib = _build.load_library().lib
    if x.dim() != 4 or g.dim() != 4 or x.shape[:3] != g.shape[:3]:
        raise ValueError(f"conv3x3 dK: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} must be NHWC of one (B, H, W)")
    _check_cuda_pair("conv3x3 dK", x, g, (torch.float32, torch.bfloat16))
    b, h, w, cin = x.shape
    cout = g.shape[-1]
    dk = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=x.device)
    if x.numel() == 0 or g.numel() == 0:
        return dk.zero_()
    f32 = x.dtype == torch.float32
    with torch.cuda.device(x.device):
        blocks = lib.cfgan_conv3x3_dkernel_blocks(b, h, w, cin, cout,
                                                  int(f32))
        if blocks <= 0:
            raise RuntimeError(f"conv3x3 dK: no launch plan: cudaError "
                               f"{-blocks}")
        part = torch.empty((blocks, 9 * cin * cout), dtype=torch.float32,
                           device=x.device)
        launch = (lib.cfgan_conv3x3_dkernel_f32 if f32
                  else lib.cfgan_conv3x3_dkernel_bf16)
        err = launch(x.data_ptr(), g.data_ptr(), part.data_ptr(),
                     dk.data_ptr(), b, h, w, cin, cout, blocks,
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 dK kernel launch failed: cudaError "
                           f"{err}")
    conv3x3_same_dkernel.launches += 1
    return dk


conv3x3_same_dkernel.launches = 0


class _Conv3x3SamePallas(torch.autograd.Function):
    """Forward: `conv3x3_same`.  Backward: dx is the SAME 3x3 conv of the
    cotangent with the kernel flipped in both spatial axes and its
    channels transposed, through `conv3x3_same(transposed=True)` (the
    kernels on the card read K that way, so no flipped copy is made); dK
    is `conv3x3_same_dkernel`."""

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
            dx = conv3x3_same(g, kernel.to(g.dtype).contiguous(),
                              transposed=True).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dk = conv3x3_same_dkernel(x, g.to(x.dtype)).to(kernel.dtype)
        return dx, dk


def conv3x3_same_pallas(x: torch.Tensor, kernel: torch.Tensor
                        ) -> torch.Tensor:
    """Differentiable SAME 3x3 conv through the hand-written kernel, NHWC in
    and out, HWIO kernel; dispatch as for `conv3x3_same`."""
    return _Conv3x3SamePallas.apply(x, kernel)
