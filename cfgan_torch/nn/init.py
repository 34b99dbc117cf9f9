"""Weight initializers with the distributions of `cfgan/nn/init.py`.

Each draws from an explicit `torch.Generator` (on the CPU, so a seed gives
the same weights whatever device they are moved to).  JAX's PRNG gives other
numbers from the same seed: parity tests carry weights across with
`cfgan_torch.convert` instead.
"""
from __future__ import annotations

import math

import torch


def scaled_uniform(shape, fan_in: int,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """U(+-1/sqrt(fan_in)): torch's default Linear/Conv kernel and bias init
    (`cfgan.nn.init.scaled_uniform`, `torch_kernel_init`)."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    u = torch.rand(shape, generator=generator)
    return (2.0 * u - 1.0) * bound


def kaiming_normal(shape, fan_in: int, negative_slope: float = 0.0,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """N(0, gain^2/fan_in), gain^2 = 2/(1+a^2): torch kaiming_normal_(a)
    (`cfgan.nn.init.kaiming_normal`)."""
    std = math.sqrt(2.0 / (1.0 + negative_slope ** 2) / fan_in)
    return std * torch.randn(shape, generator=generator)


def normal(shape, stddev: float = 0.02,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """N(0, stddev^2) (`cfgan.nn.init.normal`)."""
    return stddev * torch.randn(shape, generator=generator)


def dcgan_bn_scale(shape, generator: torch.Generator | None = None
                   ) -> torch.Tensor:
    """1 + 0.02 N(0, 1): DCGAN's BatchNorm scale init
    (`cfgan.models.discriminators._dcgan_bn_scale`)."""
    return 1.0 + normal(shape, 0.02, generator)
