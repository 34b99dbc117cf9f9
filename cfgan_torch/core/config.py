"""Configuration the serving path reads (mirrors `cfgan/core/config.py`)."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class MaskConfig:
    """Patch-grid mask geometry (`cfgan.core.config.MaskConfig`)."""

    patch_size: int = 7


@dataclass(frozen=True)
class CounterGANConfig:
    """The `cfgan.core.config.CounterGANConfig` fields that serving reads.

    `conv_impl` selects how the generator's 3x3/stride-1/pad-1 convs run:
    None = cuDNN through `F.conv2d`; "matmul" = nine shifted-tap matmuls in
    PyTorch (`conv3x3_same_plain`); "pallas" = the hand-written CUDA kernel
    (`conv3x3_same`) that replaces the JAX package's Pallas kernel, on every
    such conv with Cin >= 16 and Cout >= 16.
    """

    hidden_dim: int = 32
    num_res_blocks: int = 5
    residual_scaling: float = 0.1
    compute_dtype: str = "float32"
    conv_impl: str | None = None
    mask: MaskConfig = field(default_factory=MaskConfig)


#: The shipped MNIST CounteRGAN preset's serving fields
#: (`cfgan/experiments/presets.py` MNIST_COUNTERGAN).
MNIST_COUNTERGAN = CounterGANConfig(
    hidden_dim=64,
    num_res_blocks=6,
    residual_scaling=0.1,
    compute_dtype="bfloat16",
    mask=MaskConfig(patch_size=7),
)
