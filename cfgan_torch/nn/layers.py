"""Core layers of the MNIST CounteRGAN (mirrors `cfgan/nn/layers.py`).

Activations are NHWC, as in the JAX package.  Parameter names follow the
JAX package's flax trees (`cfgan_torch.convert` maps one onto the other):
`Linear.weight` is torch's (out, in); a `Conv` on cuDNN holds an OIHW
`weight`; a `Conv` routed to the 3x3 kernel holds the HWIO `kernel`
(3, 3, Cin, Cout), which is the kernel's own layout.

Each layer draws its initial weights from an explicit `torch.Generator`
(`cfgan_torch.nn.init`); serving and the parity tests load trained or
converted weights over them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cfgan_torch.nn import init as cinit
from cfgan_torch.ops import conv as conv_ops


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


class Linear(nn.Module):
    """Dense layer with torch-default init (U(+-1/sqrt(fan_in)))."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(cinit.scaled_uniform(
            (out_features, in_features), in_features, generator))
        self.bias = nn.Parameter(cinit.scaled_uniform(
            (out_features,), in_features, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class Conv(nn.Module):
    """2-D NHWC convolution with torch-default init and torch-style
    integer padding (`cfgan.nn.layers.Conv`).

    `impl` routes a 3x3/stride-1/pad-1 conv: "pallas" to the hand-written
    kernel through `conv3x3_same_pallas` (the port of the JAX package's
    Pallas kernel with its custom VJP), "matmul" to its plain version
    `conv3x3_same_plain`, which autograd differentiates.  As in the JAX
    package, "pallas" keeps a layer with Cin < 16 or Cout < 16 on cuDNN.
    Every other layer runs `F.conv2d` on a channels-last view of the NHWC
    activation, so no copy is made either way.  `use_bias=False` leaves
    the bias out (the discriminator's convs).
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0,
                 impl: str | None = None, kaiming_slope: float | None = None,
                 use_bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        if impl not in (None, "matmul", "pallas"):
            raise ValueError(f"unknown conv impl {impl!r}")
        k = kernel_size
        if impl == "pallas" and (in_ch < 16 or out_ch < 16):
            impl = None  # the JAX package's lane-starvation gate
        if impl is not None and not (k == 3 and stride == 1 and padding == 1):
            impl = None
        self.impl, self.stride, self.padding = impl, stride, padding
        fan_in = in_ch * k * k
        shape = (k, k, in_ch, out_ch)  # HWIO, the JAX layout
        if kaiming_slope is None:
            w = cinit.scaled_uniform(shape, fan_in, generator)
        else:
            w = cinit.kaiming_normal(shape, fan_in, kaiming_slope, generator)
        if impl is None:
            self.weight = nn.Parameter(w.permute(3, 2, 0, 1).contiguous())
        else:
            self.kernel = nn.Parameter(w)
        self.bias = (nn.Parameter(cinit.scaled_uniform((out_ch,), fan_in,
                                                       generator))
                     if use_bias else None)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # A state dict carries over between impls, as the JAX package's
        # params do: an OIHW `weight` loads into a kernel layer's HWIO
        # `kernel`, and back.
        mine, other, perm = (("kernel", "weight", (2, 3, 1, 0)) if self.impl
                             else ("weight", "kernel", (3, 2, 0, 1)))
        if prefix + mine not in state_dict and prefix + other in state_dict:
            state_dict[prefix + mine] = state_dict.pop(
                prefix + other).permute(*perm)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.impl is None:
            y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                         self.stride, self.padding)
            return y.permute(0, 2, 3, 1).contiguous()
        fn = (conv_ops.conv3x3_same_pallas if self.impl == "pallas"
              else conv_ops.conv3x3_same_plain)
        y = fn(x.contiguous(), self.kernel)
        return y if self.bias is None else y + self.bias


class BatchNorm(nn.Module):
    """BatchNorm over the last axis with the JAX package's semantics
    (`cfgan.nn.layers.BatchNorm`).

    Train mode normalizes by the biased batch variance, taken as
    max(E[x^2] - E[x]^2, 0) in the input's dtype, and updates the running
    statistics in place with momentum 0.9 in the JAX convention (torch's
    0.1), the running variance from the unbiased variance n/(n-1); the
    running statistics keep their own dtype (float32 under mixed
    precision).  Eval mode normalizes by the running statistics.  eps 1e-5.
    """

    epsilon = 1e-5
    momentum = 0.9

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            axes = tuple(range(x.dim() - 1))
            n = x.numel() // x.shape[-1]
            mean = x.mean(axes)
            var = torch.maximum((x * x).mean(axes) - mean * mean,
                                x.new_zeros(()))
            with torch.no_grad():
                m = self.momentum
                unbiased = var * (n / max(n - 1, 1))
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.weight + self.bias


class Embed(nn.Module):
    """Embedding table; N(0, stddev) init (`cfgan.nn.layers.Embed`)."""

    def __init__(self, num_embeddings: int, features: int,
                 stddev: float = 1.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(cinit.normal(
            (num_embeddings, features), stddev, generator))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx, self.weight)


class ConvResBlock(nn.Module):
    """Image residual block with a damped residual path, identity +
    0.1 * out (`cfgan.nn.layers.ConvResBlock`)."""

    damping = 0.1
    negative_slope = 0.2

    def __init__(self, channels: int, conv_impl: str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()

        def conv():
            return Conv(channels, channels, 3, 1, 1, impl=conv_impl,
                        kaiming_slope=self.negative_slope,
                        generator=generator)

        self.conv1, self.bn1 = conv(), BatchNorm(channels)
        self.conv2, self.bn2 = conv(), BatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = leaky_relu(self.bn1(self.conv1(x)), self.negative_slope)
        out = self.bn2(self.conv2(out))
        return x + self.damping * out


class Dropout(nn.Module):
    """Inverted dropout (`cfgan.nn.layers.Dropout`); identity in eval mode.
    `channelwise=True` drops whole channels of an NHWC tensor, as the JAX
    classifier's `broadcast_dims=(1, 2)` (torch's Dropout2d) does."""

    def __init__(self, rate: float, channelwise: bool = False):
        super().__init__()
        self.rate, self.channelwise = rate, channelwise

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        shape = ((x.shape[0], 1, 1, x.shape[-1]) if self.channelwise
                 else x.shape)
        keep = torch.rand(shape, device=x.device) >= self.rate
        return x * keep.to(x.dtype) / (1.0 - self.rate)
