"""The MNIST CounteRGAN residual generator (mirrors
`cfgan/models/generators.py::ImageResidualGenerator`).  NHWC throughout."""
from __future__ import annotations

import torch
from torch import nn

from cfgan_torch.nn.layers import Conv, ConvResBlock, Embed, leaky_relu


class ImageResidualGenerator(nn.Module):
    """Label embedding -> HxW conditioning plane; input concat[x, plane,
    mask]; conv_in -> n damped residual blocks -> conv_mid -> conv_out *
    residual_scaling.  Kaiming-normal(a=0.2) conv init, N(0, .01)
    embedding init.  Returns (raw_residual, masked_residual); the clamp
    happens outside.

    With `conv_impl="pallas"` every 3x3 conv with Cin >= 16 and Cout >= 16
    (the resblock convs and conv_mid) runs the hand-written kernel;
    conv_in (Cin = 3: image, label plane, mask) and conv_out (Cout = 1)
    stay on cuDNN, as in the JAX package.  Images have one channel.
    """

    def __init__(self, image_hw: tuple[int, int] = (28, 28),
                 num_classes: int = 10, base_ch: int = 64,
                 n_resblocks: int = 6, residual_scaling: float = 0.1,
                 conv_impl: str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        h, w = image_hw
        self.residual_scaling = residual_scaling
        self.n_resblocks = n_resblocks

        def conv(cin, cout):
            return Conv(cin, cout, 3, 1, 1, impl=conv_impl,
                        kaiming_slope=0.2, generator=generator)

        self.embed = Embed(num_classes, h * w, stddev=0.01,
                           generator=generator)
        self.conv_in = conv(3, base_ch)
        for i in range(n_resblocks):  # named as in the flax tree
            self.add_module(f"res{i}", ConvResBlock(
                base_ch, conv_impl=conv_impl, generator=generator))
        self.conv_mid = conv(base_ch, base_ch)
        self.conv_out = conv(base_ch, 1)

    def forward(self, x: torch.Tensor, target: torch.Tensor,
                mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        b, h, w, _ = x.shape
        plane = self.embed(target).reshape(b, h, w, 1)
        z = leaky_relu(self.conv_in(torch.cat([x, plane, mask], dim=-1)))
        for i in range(self.n_resblocks):
            z = getattr(self, f"res{i}")(z)
        z = leaky_relu(self.conv_mid(z))
        raw = self.conv_out(z) * self.residual_scaling
        return raw, raw * mask
