"""Configuration of the MNIST CounteRGAN's serving and training (mirrors
`cfgan/core/config.py` and the MNIST presets of
`cfgan/experiments/presets.py`).

The JAX package's `remat`, `g_microbatch` and `snapshot_every` are not
ported yet, so they are not fields here: a config cannot ask for them and
be silently ignored.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class MaskConfig:
    """Mask-sampling policy (`cfgan.core.config.MaskConfig`).  The MNIST
    builder draws patch masks whatever `kind` says, as the JAX package's
    does."""

    kind: str = "feature"  # feature | patch
    patch_size: int = 7
    num_modifiable_patches: int | None = 10  # None: iid Bernoulli(0.5)
    # fraction of training samples whose mask is replaced by all-ones
    ones_fraction: float = 0.0


@dataclass(frozen=True)
class CounterGANConfig:
    """The `cfgan.core.config.CounterGANConfig` fields of the MNIST
    generator, its serving and its train step, with the same defaults.

    `conv_impl` selects how the generator's 3x3/stride-1/pad-1 convs run:
    None = cuDNN through `F.conv2d`; "matmul" = nine shifted-tap matmuls in
    PyTorch (`conv3x3_same_plain`); "pallas" = the hand-written CUDA kernel
    (`conv3x3_same_pallas`, forward and dx) that replaces the JAX package's
    Pallas kernel, on every such conv with Cin >= 16 and Cout >= 16.
    `compute_dtype` "bfloat16" runs the forwards and backwards in bf16 with
    float32 parameters, optimizer state and losses.
    """

    lr_g: float = 1e-3
    lr_d: float = 1e-3
    lambda_adv: float = 1.0
    lambda_cls: float = 2.0
    lambda_reg_l1: float = 1.0
    lambda_reg_l2: float = 0.0
    lambda_mask: float = 1.0
    adv_loss: str = "wasserstein"  # wasserstein | bce | clipped_log
    reg_reduction: str = "per_sample_norm"  # per_sample_norm | mean_abs
    clamp_cf: tuple[float, float] | None = None
    # > 0 adds lambda_range * mean(relu(x + raw*mask - hi)
    # + relu(lo - x - raw*mask)) to the G loss
    lambda_range: float = 0.0
    resample_target: bool = True  # force target != source label
    fixed_target: int | None = None  # None: per-sample random targets
    hidden_dim: int = 32
    num_res_blocks: int = 5
    residual_scaling: float = 0.1
    compute_dtype: str = "float32"
    conv_impl: str | None = None
    # > 0: per-step EMA of the generator parameters, starting at the
    # initial parameters
    ema_decay: float = 0.0
    mask: MaskConfig = field(default_factory=MaskConfig)


#: mnist/config.py:3-29, the reference recipe (presets.py
#: MNIST_COUNTERGAN_REFERENCE)
MNIST_COUNTERGAN_REFERENCE = CounterGANConfig(
    lr_g=5e-5,
    lr_d=1e-5,
    lambda_adv=1.0,
    lambda_cls=1.0,
    lambda_reg_l1=2.5,
    lambda_mask=2.0,
    adv_loss="bce",
    reg_reduction="mean_abs",
    clamp_cf=(-1.0, 1.0),
    resample_target=False,
    hidden_dim=64,
    num_res_blocks=6,
    mask=MaskConfig(kind="patch", patch_size=7, num_modifiable_patches=10),
)

#: The shipped default (presets.py MNIST_COUNTERGAN): the reference recipe
#: with lambda_cls 2, generator EMA 0.999 and bf16 compute.  Batch 128.
MNIST_COUNTERGAN = replace(
    MNIST_COUNTERGAN_REFERENCE,
    lambda_cls=2.0,
    ema_decay=0.999,
    compute_dtype="bfloat16",
)
