"""The CounteRGAN discriminators (mirrors `cfgan/models/discriminators.py`):
`CondConvDiscriminator` (MNIST, NHWC) and `SpectralMLPDiscriminator`
(tabular)."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from cfgan_torch.nn.layers import (
    Conv,
    Embed,
    Linear,
    SpectralLinear,
    leaky_relu,
)


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

    def forward(self, x: torch.Tensor, cond_idx: torch.Tensor,
                train: bool = True) -> torch.Tensor:
        """`train` is the step's D-phase flag; this network holds no state
        that it would change, so it is ignored."""
        b, h, w, _ = x.shape
        plane = self.cond_embed(cond_idx).reshape(b, h, w, 1)
        z = torch.cat([x, plane], dim=-1)
        for i in range(4):
            z = leaky_relu(getattr(self, f"conv{i}")(z), self.negative_slope)
        return self.adv_head(z.mean(dim=(1, 2)))


class SpectralMLPDiscriminator(nn.Module):
    """Spectral-norm MLP critic on concat[x, target one-hot]
    (`cfgan.models.discriminators.SpectralMLPDiscriminator`): hidden
    widths `hidden_dims` (the house's (h, 2h, 4h)), LeakyReLU(0.2), one
    score.  `train=True` advances each layer's power iteration (the D
    update); `train=False` reads `u` as it is (the G phase).  Layers are
    named as in the flax tree (`sn0`.., `sn_out`)."""

    negative_slope = 0.2

    def __init__(self, in_dim: int, hidden_dims: Sequence[int] = (32, 64, 128),
                 generator: torch.Generator | None = None):
        super().__init__()
        widths = (in_dim, *hidden_dims)
        self.n_hidden = len(hidden_dims)
        for i, (cin, cout) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"sn{i}", SpectralLinear(cin, cout,
                                                     generator=generator))
        self.sn_out = SpectralLinear(widths[-1], 1, generator=generator)

    def forward(self, x: torch.Tensor, target_onehot: torch.Tensor,
                train: bool = True) -> torch.Tensor:
        h = torch.cat([x, target_onehot], 1)
        for i in range(self.n_hidden):
            h = leaky_relu(getattr(self, f"sn{i}")(h, train),
                           self.negative_slope)
        return self.sn_out(h, train)
