"""Configuration of the moons, MNIST and King County house CounteRGAN
experiments (their data, classifier pretrain, generator serving and
training, and the tabular feature schema) and of the plain-generation GAN
families (mirrors `cfgan/core/config.py`; the experiment presets are in
`cfgan_torch/experiments/presets.py`).

The JAX package's `GANConfig.sample_every` is read by neither package,
so it is not a field here: a config cannot ask for it and be silently
ignored.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping as ABCMapping
from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    """Dataset selection and loading (`cfgan.core.config.DataConfig`)."""

    name: str = "moons"  # moons | moons2 | mnist | kc_house
    batch_size: int = 64
    valid_fraction: float = 0.0  # stratified valid split (mnist: 0.1)
    test_fraction: float = 0.2  # train/test split for array datasets
    seed: int = 42
    path: str | None = None  # dataset directory (None: the search order)
    image_shape: tuple[int, int, int] = (28, 28, 1)  # NHWC
    normalize_mean: float = 0.5  # [0, 1] -> [-1, 1]
    normalize_std: float = 0.5
    resize_to: int | None = None


@dataclass(frozen=True)
class ClassifierConfig:
    """The frozen classifier's pretrain (`cfgan.core.config.
    ClassifierConfig`).  `weight_decay` > 0 trains with AdamW.  `steps`
    selects the full-batch regime (the moons experiment's) over
    `epochs`."""

    arch: str = "mlp"  # mlp | cnn | tabular
    lr: float = 1e-3
    epochs: int = 10
    batch_size: int = 128
    steps: int | None = None
    weight_decay: float = 0.0
    class_weighted: bool = False
    early_stop_patience: int | None = None
    lr_plateau: bool = False
    hidden_dim: int = 32
    dropout: tuple[float, ...] = ()


@dataclass(frozen=True)
class MaskConfig:
    """Mask-sampling policy (`cfgan.core.config.MaskConfig`).  The MNIST
    builder draws patch masks whatever `kind` says, as the JAX package's
    does.  `immutable_idx` are the features the moons masks keep at 0
    (the house builder takes them from its schema)."""

    kind: str = "feature"  # feature | patch
    patch_size: int = 7
    num_modifiable_patches: int | None = 10  # None: iid Bernoulli(0.5)
    immutable_idx: tuple[int, ...] = ()
    # fraction of training samples whose mask is replaced by all-ones
    ones_fraction: float = 0.0


@dataclass(frozen=True)
class CounterGANConfig:
    """The `cfgan.core.config.CounterGANConfig` fields of the MNIST and
    tabular generators, their serving and their train step, with the same
    defaults.

    `conv_impl` selects how the generator's 3x3/stride-1/pad-1 convs run:
    None = cuDNN through `F.conv2d`; "matmul" = nine shifted-tap matmuls in
    PyTorch (`conv3x3_same_plain`); "pallas" = the hand-written CUDA kernel
    (`conv3x3_same_pallas`, forward and dx) that replaces the JAX package's
    Pallas kernel, on every such conv with Cin >= 16 and Cout >= 16.
    `compute_dtype` "bfloat16" runs the forwards and backwards in bf16 with
    float32 parameters, optimizer state and losses.  `gumbel_tau` is the
    tabular generator's Gumbel-Softmax temperature; `cat_head_f32` runs
    its categorical heads and their softmax in float32 under a bf16 trunk.
    """

    epochs: int = 500
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
    gumbel_tau: float = 0.5
    compute_dtype: str = "float32"
    # run each of the generator's residual blocks again in the backward
    # (torch.utils.checkpoint, block by block): the step holds the blocks'
    # inputs, not their activations, and the backward remakes one block's
    # at a time (the moons and legacy generators have no blocks)
    remat: bool = False
    conv_impl: str | None = None
    cat_head_f32: bool = True
    # >= 2: the generator update in this many equal micro-batches (the
    # gradients summed, then divided by it); the D phase takes a plain
    # full-batch forward, which alone updates the BatchNorm statistics,
    # and each chunk's forward normalizes by its own batch statistics (the
    # tabular chunks on their own Gumbel noise).  0 disables
    g_microbatch: int = 0
    # > 0: the experiment scores serving candidates every K epochs on the
    # validation split and ships the best snapshot (cfgan_torch.train.
    # selection); 0: end-of-training selection only
    snapshot_every: int = 0
    # > 0: per-step EMA of the generator parameters, starting at the
    # initial parameters
    ema_decay: float = 0.0
    mask: MaskConfig = field(default_factory=MaskConfig)


@dataclass(frozen=True)
class GANConfig:
    """The plain-generation families (`cfgan.core.config.GANConfig`, every
    field and default but `sample_every`, which nothing reads: the
    generation run samples its fixed noise every tenth of its epochs).
    `family` is one of simple_mlp, mlp_image, cgan_mlp, dcgan, wgan_gp;
    `n_critic` > 1 updates the generator on the
    steps whose global index is a multiple of it (WGAN-GP: 5);
    `g_before_d` updates the generator before the discriminator (the
    simple MNIST GAN); `compute_dtype` "bfloat16" runs both networks'
    forwards and backwards in bf16 with float32 parameters, optimizer
    state and losses."""

    family: str = "simple_mlp"
    epochs: int = 500
    lr_g: float = 1e-3
    lr_d: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    latent_dim: int = 32
    hidden_dim: int = 128
    n_critic: int = 1
    gp_lambda: float = 10.0
    g_before_d: bool = False
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class TabularSchema:
    """Feature schema of a tabular CounteRGAN (`cfgan.core.config.
    TabularSchema`): the feature names in column order, the features no
    counterfactual may change, and each categorical feature's values."""

    feature_names: tuple[str, ...] = ()
    immutable_features: tuple[str, ...] = ()
    categorical_values: Mapping[str, tuple[float, ...]] = field(
        default_factory=dict)

    @property
    def input_dim(self) -> int:
        return len(self.feature_names)

    @property
    def immutable_idx(self) -> tuple[int, ...]:
        return tuple(self.feature_names.index(f)
                     for f in self.immutable_features)

    @property
    def categorical_idx(self) -> tuple[int, ...]:
        return tuple(self.feature_names.index(f)
                     for f in self.categorical_values)

    @property
    def categorical_info(self) -> dict[int, tuple[float, ...]]:
        return {self.feature_names.index(f): tuple(v)
                for f, v in self.categorical_values.items()}

    @property
    def continuous_idx(self) -> tuple[int, ...]:
        cat = set(self.categorical_idx)
        return tuple(i for i in range(self.input_dim) if i not in cat)

    @classmethod
    def from_dataframe(cls, df, immutable: tuple[str, ...] = (),
                       categorical=None, max_categorical_cardinality: int = 32,
                       exclude: tuple[str, ...] = ()) -> "TabularSchema":
        """Infer a schema from a table (`cfgan.core.config.TabularSchema.
        from_dataframe`): a pandas DataFrame, or anything else with
        `df.columns` and `df[col]`.

        Every column with at most `max_categorical_cardinality` distinct
        values becomes categorical with its observed sorted values.
        `categorical` overrides inference: a sequence of column names
        (values observed from the data) or a mapping name -> explicit value
        tuple; `categorical=()` turns inference off.  `exclude` drops
        columns (targets, ids).  Raises ValueError where an immutable
        feature or a mapped categorical one is not a column; a listed one
        that is not fails on `df[col]`."""
        names = tuple(c for c in df.columns if c not in exclude)
        for f in immutable:
            if f not in names:
                raise ValueError(f"immutable feature {f!r} not a column")

        def observed(col) -> tuple[float, ...]:
            return tuple(float(v)
                         for v in np.unique(np.asarray(df[col], np.float64)))

        if categorical is None:
            cat_values = {c: v for c, v in ((c, observed(c)) for c in names)
                          if len(v) <= max_categorical_cardinality}
        elif isinstance(categorical, ABCMapping):
            cat_values = {c: tuple(float(v) for v in vs)
                          for c, vs in categorical.items()}
        else:
            cat_values = {c: observed(c) for c in categorical}
        for c in cat_values:
            if c not in names:
                raise ValueError(f"categorical feature {c!r} not a column")
        return cls(feature_names=names, immutable_features=tuple(immutable),
                   categorical_values=cat_values)


@dataclass(frozen=True)
class ShardingConfig:
    """Device-mesh policy (`cfgan.core.config.ShardingConfig`): the data
    axis's name and the mesh's shape (None: every device of the world,
    `cfgan_torch.parallel.create_mesh`), 1-D or, as in the JAX package,
    ("data", "model") (D, M).

    `donate_state` has no effect in the port: the step and the epoch
    runner already update the state in place.  `sync_batch_norm=False`
    raises, as the JAX package has no path for per-replica statistics
    either: a sharded step always normalizes by the global batch's."""

    data_axis: str = "data"
    mesh_shape: tuple[int, ...] | None = None
    donate_state: bool = True
    sync_batch_norm: bool = True

    def __post_init__(self):
        if not self.sync_batch_norm:
            raise ValueError("sync_batch_norm=False has no path: a sharded "
                             "step normalizes by the global batch's "
                             "statistics")


@dataclass(frozen=True)
class ExperimentConfig:
    """One runnable experiment (`cfgan.core.config.ExperimentConfig`).  A
    CounteRGAN experiment sets `countergan`, a plain-generation one `gan`
    and `countergan=None`; a tabular one may carry its feature `schema`;
    `sharding` is the mesh policy of a data-parallel run."""

    name: str = "moons_countergan"
    seed: int = 42
    num_classes: int = 3
    data: DataConfig = field(default_factory=DataConfig)
    classifier: ClassifierConfig = field(default_factory=ClassifierConfig)
    countergan: CounterGANConfig | None = field(
        default_factory=CounterGANConfig)
    gan: GANConfig | None = None
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    schema: TabularSchema | None = None
    out_dir: str = "results"

    def replace(self, **kw) -> "ExperimentConfig":
        return replace(self, **kw)


def replace(cfg, **kw):
    """A copy of any config with the fields in `kw` changed."""
    return dataclasses.replace(cfg, **kw)


def to_dict(cfg) -> dict[str, Any]:
    """Any config as nested dicts of its fields."""
    return dataclasses.asdict(cfg)


#: moons/config.py:1-17, the reference recipe (presets.py
#: MOONS_COUNTERGAN_REFERENCE): hidden 32, L1 and L2 residual penalties,
#: no clamp, float32
MOONS_COUNTERGAN_REFERENCE = CounterGANConfig(
    epochs=500,
    lr_g=1e-3,
    lr_d=1e-3,
    lambda_cls=2.0,
    lambda_reg_l1=5.0,
    lambda_reg_l2=5.0,
    lambda_mask=3.0,
    adv_loss="wasserstein",
    reg_reduction="per_sample_norm",
    clamp_cf=None,
    resample_target=True,
    hidden_dim=32,
    mask=MaskConfig(kind="feature"),
)

#: The shipped default (presets.py MOONS_COUNTERGAN): lambda_cls 3,
#: lambda_reg 3/3 and snapshot selection every 50 epochs
MOONS_COUNTERGAN = replace(
    MOONS_COUNTERGAN_REFERENCE,
    lambda_cls=3.0,
    lambda_reg_l1=3.0,
    lambda_reg_l2=3.0,
    snapshot_every=50,
)

#: mnist/config.py:3-29, the reference recipe (presets.py
#: MNIST_COUNTERGAN_REFERENCE)
MNIST_COUNTERGAN_REFERENCE = CounterGANConfig(
    epochs=20,
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
#: with lambda_cls 2, generator EMA 0.999, bf16 compute and snapshot
#: selection every 2 epochs.  Batch 128.
MNIST_COUNTERGAN = replace(
    MNIST_COUNTERGAN_REFERENCE,
    lambda_cls=2.0,
    ema_decay=0.999,
    compute_dtype="bfloat16",
    snapshot_every=2,
)

#: house_sales_kc_usa/config.py:13-83, the reference recipe (presets.py
#: HOUSE_COUNTERGAN_REFERENCE): 50 epochs, no clamp, Wasserstein loss
HOUSE_COUNTERGAN_REFERENCE = CounterGANConfig(
    epochs=50,
    lr_g=1e-3,
    lr_d=1e-3,
    lambda_cls=2.0,
    lambda_reg_l1=1.0,
    lambda_mask=1.0,
    adv_loss="wasserstein",
    reg_reduction="per_sample_norm",
    clamp_cf=None,
    resample_target=True,
    hidden_dim=32,
    num_res_blocks=5,
    gumbel_tau=0.5,
)

#: The shipped default (presets.py HOUSE_COUNTERGAN): clamp to [0, 1] with
#: the out-of-range penalty, lambda_cls 5 over 350 epochs, generator EMA
#: 0.999 and snapshot selection every 10 epochs.  Batch 128.
HOUSE_COUNTERGAN = replace(
    HOUSE_COUNTERGAN_REFERENCE,
    epochs=350,
    lambda_cls=5.0,
    clamp_cf=(0.0, 1.0),
    lambda_range=10.0,
    ema_decay=0.999,
    snapshot_every=10,
)
