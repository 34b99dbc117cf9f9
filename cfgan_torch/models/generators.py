"""The generators (mirrors `cfgan/models/generators.py`): the CounteRGAN
residual generators `MoonsResidualGenerator` (2-D moons),
`ImageResidualGenerator` (MNIST, NHWC throughout) and
`TabularResidualGenerator` (King County house), the legacy MNIST
`DeltaImageGenerator`, and the plain-generation
families' `MLPGenerator`, `ConditionalMLPGenerator`, `MLPImageGenerator`,
`DCGANGenerator` and `WGANGenerator`.

The plain-generation generators' BatchNorms use their batch statistics in
train mode and their running statistics in eval mode (the JAX modules'
`train` flag is the module's mode here); submodules are named as in the
flax trees.  The CounteRGAN generators take `update_stats`: with False a
train-mode forward normalizes by its batch statistics and leaves the
running statistics alone (the step's `g_microbatch` chunks).  The two
with residual blocks take `remat` (`CounterGANConfig.remat`): a forward
in train mode that records a graph runs each block under `remat_call`,
so the backward remakes one block's activations at a time; the moons
and legacy generators have no blocks to run again."""
from __future__ import annotations

import math
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cfgan_torch.nn import init as cinit
from cfgan_torch.nn.gumbel import gumbel_softmax
from cfgan_torch.nn.layers import (
    BatchNorm,
    Conv,
    ConvResBlock,
    ConvTranspose,
    Embed,
    FiLMResidualBlock,
    Linear,
    leaky_relu,
    remat_call,
)


def _run_block(owner: nn.Module, block: nn.Module, *args,
               update_stats: bool) -> torch.Tensor:
    """`block(*args, update_stats)`, under `remat_call` where `owner`
    has `remat` on and its forward records a graph in train mode."""
    if owner.remat and owner.training and torch.is_grad_enabled():
        return remat_call(block, *args, update_stats=update_stats)
    return block(*args, update_stats)


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
                mask: torch.Tensor, update_stats: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor]:
        h = torch.cat([x, target_onehot, mask], 1)
        for i in range(self.n_hidden):
            h = F.relu(getattr(self, f"BatchNorm_{i}")(
                getattr(self, f"Linear_{i}")(h), update_stats))
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
                 conv_impl: str | None = None, remat: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        h, w = image_hw
        self.residual_scaling = residual_scaling
        self.n_resblocks = n_resblocks
        self.remat = remat

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
                mask: torch.Tensor, update_stats: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor]:
        b, h, w, _ = x.shape
        plane = self.embed(target).reshape(b, h, w, 1)
        z = leaky_relu(self.conv_in(torch.cat([x, plane, mask], dim=-1)))
        for i in range(self.n_resblocks):
            z = _run_block(self, getattr(self, f"res{i}"), z,
                           update_stats=update_stats)
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
                 remat: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        cond_dim = num_classes + input_dim
        self.n_blocks = n_blocks
        self.remat = remat
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
                temperature: float | None = None, update_stats: bool = True):
        """`noise`: feature index -> (B, n) Gumbel noise, or one (B, sum
        n) tensor of the heads' noise side by side in sorted order."""
        if not isinstance(noise, Mapping):
            noise = dict(zip(self.heads, noise.split(self.sizes, dim=1)))
        cond = torch.cat([target_onehot, mask], 1)
        h = F.relu(self.fc_in(torch.cat([x, cond], 1)))
        for i in range(self.n_blocks):
            h = _run_block(self, getattr(self, f"block{i}"), h, cond,
                           update_stats=update_stats)
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


class DeltaImageGenerator(nn.Module):
    """The legacy mask-free delta generator
    (`cfgan.models.generators.DeltaImageGenerator`,
    `mnist/modules/generator.py:4-22`): a label plane (`embed`, N(0, .01)
    init) beside the image; conv0, LeakyReLU(0.2), `bn0`; conv1,
    LeakyReLU(0.2), `bn1` (the BatchNorm after the activation);
    `conv_out`, tanh, times `delta_scale`.  Returns (delta, delta): the
    family has no mask, and the step treats it as all ones.  Its 3x3
    stride-1 convs stay on cuDNN (`F.conv2d`), as the JAX module's are
    `lax.conv`; it takes no `conv_impl`."""

    def __init__(self, num_classes: int = 10, base_ch: int = 32,
                 delta_scale: float = 1.0,
                 image_hw: tuple[int, int] = (28, 28), channels: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        h, w = image_hw
        self.delta_scale = delta_scale
        self.embed = Embed(num_classes, h * w, stddev=0.01,
                           generator=generator)
        self.conv0 = Conv(channels + 1, base_ch, 3, 1, 1, generator=generator)
        self.bn0 = BatchNorm(base_ch)
        self.conv1 = Conv(base_ch, base_ch, 3, 1, 1, generator=generator)
        self.bn1 = BatchNorm(base_ch)
        self.conv_out = Conv(base_ch, channels, 3, 1, 1, generator=generator)

    def forward(self, x: torch.Tensor, target: torch.Tensor,
                mask: torch.Tensor | None = None, update_stats: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """`mask` is accepted for the families' common signature and
        ignored."""
        b, h, w, _ = x.shape
        plane = self.embed(target).reshape(b, h, w, 1)
        z = torch.cat([x, plane], dim=-1)
        z = self.bn0(leaky_relu(self.conv0(z)), update_stats)
        z = self.bn1(leaky_relu(self.conv1(z)), update_stats)
        delta = torch.tanh(self.conv_out(z)) * self.delta_scale
        return delta, delta


class MLPGenerator(nn.Module):
    """The simple moons generator: z -> hidden, ReLU -> `out_dim`
    (`cfgan.models.generators.MLPGenerator`).  As in the flax tree, whose
    module builds the output layer first, `Linear_0` is the output layer
    and `Linear_1` the hidden one."""

    def __init__(self, latent_dim: int = 32, out_dim: int = 2,
                 hidden_dim: int = 128,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.Linear_1 = Linear(latent_dim, hidden_dim, generator)
        self.Linear_0 = Linear(hidden_dim, out_dim, generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.Linear_0(F.relu(self.Linear_1(z)))


class ConditionalMLPGenerator(nn.Module):
    """The conditional moons generator: concat[z, label one-hot] ->
    hidden, ReLU -> `out_dim` (`cfgan.models.generators.
    ConditionalMLPGenerator`); `Linear_0` is the output layer, as in
    `MLPGenerator`."""

    def __init__(self, latent_dim: int = 32, num_classes: int = 2,
                 out_dim: int = 2, hidden_dim: int = 128,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.Linear_1 = Linear(latent_dim + num_classes, hidden_dim,
                               generator)
        self.Linear_0 = Linear(hidden_dim, out_dim, generator)

    def forward(self, z: torch.Tensor, label_onehot: torch.Tensor
                ) -> torch.Tensor:
        h = torch.cat([z, label_onehot], 1)
        return self.Linear_0(F.relu(self.Linear_1(h)))


class MLPImageGenerator(nn.Module):
    """The simple MNIST generator: z -> [Linear, BatchNorm, LeakyReLU(0.2)]
    at 128, 256, 512, 1024 (the first block without BatchNorm) -> Linear
    to H W C, tanh, NHWC (`cfgan.models.generators.MLPImageGenerator`).
    Its BatchNorms' eps is 0.8, as the reference's BatchNorm1d(out, 0.8)
    sets it."""

    widths = ((128, False), (256, True), (512, True), (1024, True))

    def __init__(self, latent_dim: int = 100,
                 img_shape: tuple[int, int, int] = (28, 28, 1),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.img_shape = tuple(img_shape)
        cin, n_bn = latent_dim, 0
        for i, (width, normalize) in enumerate(self.widths):
            self.add_module(f"Linear_{i}", Linear(cin, width, generator))
            if normalize:
                self.add_module(f"BatchNorm_{n_bn}",
                                BatchNorm(width, epsilon=0.8))
                n_bn += 1
            cin = width
        self.add_module(f"Linear_{len(self.widths)}",
                        Linear(cin, math.prod(self.img_shape), generator))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h, n_bn = z, 0
        for i, (_, normalize) in enumerate(self.widths):
            h = getattr(self, f"Linear_{i}")(h)
            if normalize:
                h = getattr(self, f"BatchNorm_{n_bn}")(h)
                n_bn += 1
            h = leaky_relu(h, 0.2)
        h = torch.tanh(getattr(self, f"Linear_{len(self.widths)}")(h))
        return h.reshape(h.shape[0], *self.img_shape)


class DCGANGenerator(nn.Module):
    """The DCGAN generator: z as a (1, 1) image -> ConvTranspose k4 to 8g
    (s1 p0), 4g, 2g, g (s2 p1), each bias-free with BatchNorm and ReLU ->
    ConvTranspose k4 s2 p1 to `channels`, tanh: 64x64 NHWC
    (`cfgan.models.generators.DCGANGenerator`).  N(0, 0.02) kernels,
    BatchNorm scales 1 + 0.02 N(0, 1)."""

    def __init__(self, latent_dim: int = 100, g_hidden: int = 64,
                 channels: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = g_hidden
        specs = ((8 * g, 1, 0), (4 * g, 2, 1), (2 * g, 2, 1), (g, 2, 1))
        cin = latent_dim
        for i, (ch, s, p) in enumerate(specs):
            self.add_module(f"tconv{i}", ConvTranspose(
                cin, ch, 4, s, p, use_bias=False, normal_std=0.02,
                generator=generator))
            self.add_module(f"bn{i}", BatchNorm(
                ch, scale_init=cinit.dcgan_bn_scale, generator=generator))
            cin = ch
        self.n_blocks = len(specs)
        self.tconv_out = ConvTranspose(cin, channels, 4, 2, 1, use_bias=False,
                                       normal_std=0.02, generator=generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = z.reshape(z.shape[0], 1, 1, z.shape[-1])
        for i in range(self.n_blocks):
            h = F.relu(getattr(self, f"bn{i}")(getattr(self, f"tconv{i}")(h)))
        return torch.tanh(self.tconv_out(h))


class WGANGenerator(nn.Module):
    """The conditional WGAN-GP generator: Linear embeddings of z and the
    label one-hot to gs/2 each, concat as a (1, 1, gs) image ->
    ConvTranspose gs (k4 s1 p0), gs/2 (k3 s2 p1), gs/4 (k4 s2 p1), each
    with BatchNorm and ReLU -> ConvTranspose k4 s2 p1 to 1, tanh: 28x28
    NHWC (`cfgan.models.generators.WGANGenerator`)."""

    def __init__(self, latent_dim: int = 32, generator_size: int = 1024,
                 num_classes: int = 10,
                 generator: torch.Generator | None = None):
        super().__init__()
        gs = generator_size
        self.latent_embed = Linear(latent_dim, gs // 2, generator)
        self.cond_embed = Linear(num_classes, gs // 2, generator)
        specs = ((gs, 4, 1, 0), (gs // 2, 3, 2, 1), (gs // 4, 4, 2, 1))
        cin = gs
        for i, (ch, k, s, p) in enumerate(specs):
            self.add_module(f"tconv{i}", ConvTranspose(
                cin, ch, k, s, p, generator=generator))
            self.add_module(f"bn_tconv{i}", BatchNorm(ch))
            cin = ch
        self.n_blocks = len(specs)
        self.tconv_out = ConvTranspose(cin, 1, 4, 2, 1, generator=generator)

    def forward(self, latent: torch.Tensor, condition_onehot: torch.Tensor
                ) -> torch.Tensor:
        h = torch.cat([self.latent_embed(latent),
                       self.cond_embed(condition_onehot)], 1)
        h = h.reshape(h.shape[0], 1, 1, h.shape[1])
        for i in range(self.n_blocks):
            h = F.relu(getattr(self, f"bn_tconv{i}")(
                getattr(self, f"tconv{i}")(h)))
        return torch.tanh(self.tconv_out(h))
