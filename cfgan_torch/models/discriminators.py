"""The MNIST CounteRGAN discriminator (mirrors
`cfgan/models/discriminators.py::CondConvDiscriminator`).  NHWC."""
from __future__ import annotations

import torch
from torch import nn

from cfgan_torch.nn.layers import Conv, Embed, Linear, leaky_relu


class CondConvDiscriminator(nn.Module):
    """Label-plane concat -> four bias-free stride-2 3x3 convs (d, 2d, 4d,
    4d channels; 64/128/256/256 at full width), each followed by
    LeakyReLU(0.2), no norm -> global mean pool -> Linear(4d -> 1) logit.
    The convs are stride 2, so they all run on cuDNN.  N(0, 1) embedding
    init, as the JAX package's `Embed` default.  Submodules are named as in
    the flax tree (`cond_embed`, `conv0`..`conv3`, `adv_head`)."""

    negative_slope = 0.2

    def __init__(self, num_classes: int = 10, d_hidden: int = 64,
                 image_hw: tuple[int, int] = (28, 28), channels: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        h, w = image_hw
        self.cond_embed = Embed(num_classes, h * w, generator=generator)
        widths = (channels + 1, d_hidden, 2 * d_hidden, 4 * d_hidden,
                  4 * d_hidden)
        for i, (cin, cout) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"conv{i}", Conv(cin, cout, 3, 2, 1,
                                             use_bias=False,
                                             generator=generator))
        self.adv_head = Linear(widths[-1], 1, generator=generator)

    def forward(self, x: torch.Tensor, cond_idx: torch.Tensor
                ) -> torch.Tensor:
        b, h, w, _ = x.shape
        plane = self.cond_embed(cond_idx).reshape(b, h, w, 1)
        z = torch.cat([x, plane], dim=-1)
        for i in range(4):
            z = leaky_relu(getattr(self, f"conv{i}")(z), self.negative_slope)
        return self.adv_head(z.mean(dim=(1, 2)))
