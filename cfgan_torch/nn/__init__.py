"""Layers: spectral norm, FiLM, residual blocks, Gumbel-softmax (mirrors
`cfgan/nn`)."""
from cfgan_torch.nn.gumbel import gumbel_softmax
from cfgan_torch.nn.layers import (
    BatchNorm,
    Conv,
    ConvResBlock,
    ConvTranspose,
    Dropout,
    Embed,
    FiLM,
    FiLMResidualBlock,
    InstanceNorm,
    Linear,
    SpectralLinear,
    leaky_relu,
)

__all__ = [
    "BatchNorm",
    "Conv",
    "ConvResBlock",
    "ConvTranspose",
    "Dropout",
    "Embed",
    "FiLM",
    "FiLMResidualBlock",
    "InstanceNorm",
    "Linear",
    "SpectralLinear",
    "leaky_relu",
    "gumbel_softmax",
]
