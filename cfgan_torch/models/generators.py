"""The CounteRGAN residual generators (mirrors
`cfgan/models/generators.py`): `MoonsResidualGenerator` (2-D moons),
`ImageResidualGenerator` (MNIST, NHWC throughout) and
`TabularResidualGenerator` (King County house)."""
from __future__ import annotations

from typing import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cfgan_torch.nn.gumbel import gumbel_softmax
from cfgan_torch.nn.layers import (
    BatchNorm,
    Conv,
    ConvResBlock,
    Embed,
    FiLMResidualBlock,
    Linear,
    leaky_relu,
)


class MoonsResidualGenerator(nn.Module):
    """MLP residual generator: concat[x, target one-hot, mask] -> h -> h ->
    h/2, each Linear -> BatchNorm -> ReLU, then Linear -> `input_dim`
    (`moons/models/generator.py:4-24`).  Returns (raw_residual,
    raw_residual * mask).  Submodules are named as in the flax tree
    (`Linear_0`.., `BatchNorm_0`..); BatchNorm uses its running statistics
    in eval mode."""

    def __init__(self, input_dim: int = 2, hidden_dim: int = 32,
                 num_classes: int = 3,
                 generator: torch.Generator | None = None):
        super().__init__()
        widths = (hidden_dim, hidden_dim, hidden_dim // 2)
        self.n_hidden = len(widths)
        cin = 2 * input_dim + num_classes
        for i, width in enumerate(widths):
            self.add_module(f"Linear_{i}", Linear(cin, width, generator))
            self.add_module(f"BatchNorm_{i}", BatchNorm(width))
            cin = width
        self.add_module(f"Linear_{len(widths)}",
                        Linear(cin, input_dim, generator))

    def forward(self, x: torch.Tensor, target_onehot: torch.Tensor,
                mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        h = torch.cat([x, target_onehot, mask], 1)
        for i in range(self.n_hidden):
            h = F.relu(getattr(self, f"BatchNorm_{i}")(
                getattr(self, f"Linear_{i}")(h)))
        raw = getattr(self, f"Linear_{self.n_hidden}")(h)
        return raw, raw * mask


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


class TabularResidualGenerator(nn.Module):
    """FiLM-conditioned tabular residual generator with Gumbel-Softmax
    categorical heads (`cfgan.models.generators.TabularResidualGenerator`).

    cond = concat[target one-hot, mask]; fc_in on concat[x, cond] + ReLU
    -> `n_blocks` FiLM residual blocks -> a continuous head (`fc_cont`,
    scaled by `residual_scaling`) and one logits head per categorical
    feature (`fc_cat_{idx}`, in sorted feature order), each sampled with
    Gumbel-Softmax at temperature `tau` on the given noise.
    `cat_head_f32` runs the heads, the noise and the softmax in float32
    when the trunk computes in bf16: the heads' parameters are read at
    float32 from their bf16 casts, as JAX promotes them.
    Returns (cont_residual, cat_logits, cat_samples); the two dicts map a
    feature index to (B, n_values)."""

    def __init__(self, input_dim: int, hidden_dim: int, num_classes: int,
                 continuous_idx: Sequence[int],
                 categorical_info: Mapping[int, Sequence[float]],
                 n_blocks: int = 5, residual_scaling: float = 0.1,
                 tau: float = 0.5, cat_head_f32: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        cond_dim = num_classes + input_dim
        self.n_blocks = n_blocks
        self.residual_scaling = residual_scaling
        self.tau = tau
        self.cat_head_f32 = cat_head_f32
        self.heads = sorted(categorical_info)
        self.sizes = [len(categorical_info[i]) for i in self.heads]
        # named as in the flax tree
        self.fc_in = Linear(input_dim + cond_dim, hidden_dim, generator)
        for i in range(n_blocks):
            self.add_module(f"block{i}", FiLMResidualBlock(
                hidden_dim, cond_dim, generator))
        self.fc_cont = Linear(hidden_dim, len(continuous_idx), generator)
        for idx, n in zip(self.heads, self.sizes):
            self.add_module(f"fc_cat_{idx}", Linear(hidden_dim, n, generator))

    def forward(self, x: torch.Tensor, target_onehot: torch.Tensor,
                mask: torch.Tensor, noise, hard: bool = False,
                temperature: float | None = None):
        """`noise`: feature index -> (B, n) Gumbel noise, or one (B, sum
        n) tensor of the heads' noise side by side in sorted order."""
        if not isinstance(noise, Mapping):
            noise = dict(zip(self.heads, noise.split(self.sizes, dim=1)))
        cond = torch.cat([target_onehot, mask], 1)
        h = F.relu(self.fc_in(torch.cat([x, cond], 1)))
        for i in range(self.n_blocks):
            h = getattr(self, f"block{i}")(h, cond)
        cont = self.fc_cont(h) * self.residual_scaling
        tau = self.tau if temperature is None else float(temperature)
        head_dtype = torch.float32 if self.cat_head_f32 else h.dtype
        h_cat = h.to(head_dtype)
        logits, samples = {}, {}
        for idx in self.heads:
            head = getattr(self, f"fc_cat_{idx}")
            lg = F.linear(h_cat, head.weight.to(head_dtype),
                          head.bias.to(head_dtype))
            logits[idx] = lg
            samples[idx] = gumbel_softmax(lg, noise[idx].to(head_dtype),
                                          tau=tau, hard=hard)
        return cont, logits, samples
