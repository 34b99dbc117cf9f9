"""The discriminators (mirrors `cfgan/models/discriminators.py`): the
CounteRGAN critics `CondConvDiscriminator` (MNIST, NHWC), the legacy
MNIST stack's `ConvDiscriminator` and `SpectralMLPDiscriminator`
(tabular), and the plain-generation families'
`MLPDiscriminator`, `ConditionalMLPDiscriminator`, `DCGANDiscriminator`
and `WGANCritic`.

The plain-generation discriminators take `update_stats`: a BatchNorm
discriminator (DCGAN's) in train mode normalizes by its batch statistics
either way, and with `update_stats=False` leaves its running statistics
where they were (the G phase of the JAX step drops that update); the
others hold no state and ignore it.  Submodules are named as in the flax
trees."""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cfgan_torch.nn import init as cinit
from cfgan_torch.nn.layers import (
    BatchNorm,
    Conv,
    Embed,
    InstanceNorm,
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


class ConvDiscriminator(nn.Module):
    """The legacy unconditional conv discriminator
    (`cfgan.models.discriminators.ConvDiscriminator`,
    `mnist/modules/discriminator.py:4-23`): three stride-2, pad-1 3x3
    convs with biases (`conv0`..`conv2`; d, 2d, 4d channels), each followed
    by LeakyReLU(0.2) -> spatial mean -> `head` Linear(4d -> 1) logit.  It
    takes the condition and ignores it, so that it stands in for the
    conditional discriminator in the CounteRGAN step.  Its convs are
    strided, so they run on cuDNN, as the JAX module's are `lax.conv`."""

    negative_slope = 0.2

    def __init__(self, d_hidden: int = 64, channels: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        widths = (channels, d_hidden, 2 * d_hidden, 4 * d_hidden)
        for i, (cin, cout) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"conv{i}", Conv(cin, cout, 3, 2, 1,
                                             generator=generator))
        self.head = Linear(widths[-1], 1, generator=generator)

    def forward(self, x: torch.Tensor, cond_idx: torch.Tensor | None = None,
                train: bool = True) -> torch.Tensor:
        """`cond_idx` and the step's `train` flag are ignored: the network
        holds no state."""
        z = x
        for i in range(3):
            z = leaky_relu(getattr(self, f"conv{i}")(z), self.negative_slope)
        return self.head(z.mean(dim=(1, 2)))


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


class MLPDiscriminator(nn.Module):
    """The simple GANs' MLP discriminator: hidden widths `hidden_dims`,
    ReLU (or LeakyReLU with `negative_slope`), one sigmoid probability
    (`cfgan.models.discriminators.MLPDiscriminator`).  Moons: 2 -> 128 ->
    1; MNIST: flattened 784 -> 512 -> 256 -> 1, slope 0.2."""

    def __init__(self, in_dim: int = 2, hidden_dims: Sequence[int] = (128,),
                 negative_slope: float = 0.0, flatten: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.negative_slope, self.flatten = negative_slope, flatten
        widths = (in_dim, *hidden_dims, 1)
        self.n_layers = len(widths) - 1
        for i, (cin, cout) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"Linear_{i}", Linear(cin, cout, generator))

    def forward(self, x: torch.Tensor, update_stats: bool = True
                ) -> torch.Tensor:
        if self.flatten:
            x = x.reshape(x.shape[0], -1)
        for i in range(self.n_layers - 1):
            x = getattr(self, f"Linear_{i}")(x)
            x = (leaky_relu(x, self.negative_slope) if self.negative_slope
                 else F.relu(x))
        return torch.sigmoid(getattr(self, f"Linear_{self.n_layers - 1}")(x))


class ConditionalMLPDiscriminator(nn.Module):
    """The conditional moons discriminator: concat[x, label one-hot] ->
    hidden, ReLU -> one sigmoid probability
    (`cfgan.models.discriminators.ConditionalMLPDiscriminator`)."""

    def __init__(self, in_dim: int = 2, num_classes: int = 2,
                 hidden_dim: int = 128,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.Linear_0 = Linear(in_dim + num_classes, hidden_dim, generator)
        self.Linear_1 = Linear(hidden_dim, 1, generator)

    def forward(self, x: torch.Tensor, label_onehot: torch.Tensor,
                update_stats: bool = True) -> torch.Tensor:
        h = F.relu(self.Linear_0(torch.cat([x, label_onehot], 1)))
        return torch.sigmoid(self.Linear_1(h))


class DCGANDiscriminator(nn.Module):
    """The DCGAN discriminator on 64x64 NHWC images: bias-free k4 s2 p1
    convs to d, 2d, 4d, 8d channels (BatchNorm on all but the first),
    LeakyReLU(0.2), then a bias-free k4 s1 p0 conv to one channel at 1x1;
    the sigmoid of that (B,) score (`cfgan.models.discriminators.
    DCGANDiscriminator`).  N(0, 0.02) kernels, BatchNorm scales
    1 + 0.02 N(0, 1).  The convs are stride 2 or 4x4, so all run on
    cuDNN."""

    def __init__(self, d_hidden: int = 64, channels: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        d = d_hidden
        widths = (channels, d, 2 * d, 4 * d, 8 * d)
        for i, (cin, cout) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"conv{i}", Conv(cin, cout, 4, 2, 1,
                                             use_bias=False, normal_std=0.02,
                                             generator=generator))
            if i:
                self.add_module(f"bn{i}", BatchNorm(
                    cout, scale_init=cinit.dcgan_bn_scale,
                    generator=generator))
        self.n_convs = len(widths) - 1
        self.conv_out = Conv(widths[-1], 1, 4, 1, 0, use_bias=False,
                             normal_std=0.02, generator=generator)

    def forward(self, x: torch.Tensor, update_stats: bool = True
                ) -> torch.Tensor:
        h = x
        for i in range(self.n_convs):
            h = getattr(self, f"conv{i}")(h)
            if i:
                h = getattr(self, f"bn{i}")(h, update_stats)
            h = leaky_relu(h, 0.2)
        h = self.conv_out(h)
        return torch.sigmoid(h.reshape(h.shape[0]))


class WGANCritic(nn.Module):
    """The conditional WGAN-GP critic on 28x28 NHWC images: k3 s2 p0 convs
    to cs/4, cs/2, cs channels, each with affine InstanceNorm and
    LeakyReLU(0.2), flattened (2 x 2 x cs, in NHWC order) beside a Linear
    embedding of the label one-hot (4 cs) -> `hidden_size`, LeakyReLU(0.2)
    -> one score (`cfgan.models.discriminators.WGANCritic`)."""

    def __init__(self, critic_size: int = 1024, hidden_size: int = 1024,
                 num_classes: int = 10, image_hw: tuple[int, int] = (28, 28),
                 generator: torch.Generator | None = None):
        super().__init__()
        cs = critic_size
        self.cond_embed = Linear(num_classes, 4 * cs, generator)
        widths = (1, cs // 4, cs // 2, cs)
        hw = list(image_hw)
        for i, (cin, cout) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"conv{i}", Conv(cin, cout, 3, 2, 0,
                                             generator=generator))
            self.add_module(f"in{i}", InstanceNorm(cout))
            hw = [(n - 3) // 2 + 1 for n in hw]
        self.n_convs = len(widths) - 1
        self.fc0 = Linear(math.prod(hw) * cs + 4 * cs, hidden_size, generator)
        self.fc_out = Linear(hidden_size, 1, generator)

    def forward(self, image: torch.Tensor, condition_onehot: torch.Tensor,
                update_stats: bool = True) -> torch.Tensor:
        h = image
        for i in range(self.n_convs):
            h = leaky_relu(getattr(self, f"in{i}")(
                getattr(self, f"conv{i}")(h)), 0.2)
        h = torch.cat([h.reshape(h.shape[0], -1),
                       self.cond_embed(condition_onehot)], 1)
        return self.fc_out(leaky_relu(self.fc0(h), 0.2))
