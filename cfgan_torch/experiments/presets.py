"""The moons, MNIST and King County house CounteRGAN experiment presets,
the legacy MNIST stack's two, and the five plain-generation presets
(mirrors
`cfgan/experiments/presets.py`, under the same names); `PRESETS` maps
each name to its preset.

`cfgan_torch.core.config.MOONS_COUNTERGAN`, `MNIST_COUNTERGAN`,
`HOUSE_COUNTERGAN` and their `..._REFERENCE`s are the `CounterGANConfig`s
of these experiments (the train step's and serving's part of them).
"""
from __future__ import annotations

from dataclasses import replace

from cfgan_torch.core import config as C

#: moons/config.py:1-17, the exact reference recipe
MOONS_COUNTERGAN_REFERENCE = C.ExperimentConfig(
    name="moons_countergan_reference",
    seed=42,
    num_classes=3,
    data=C.DataConfig(name="moons", batch_size=64),
    classifier=C.ClassifierConfig(arch="mlp", lr=1e-2, steps=1000,
                                  hidden_dim=32),
    countergan=C.MOONS_COUNTERGAN_REFERENCE,
)

#: The shipped default: lambda_cls 3 and lambda_reg 3/3, snapshot
#: selection every 50 epochs
MOONS_COUNTERGAN = MOONS_COUNTERGAN_REFERENCE.replace(
    name="moons_countergan", countergan=C.MOONS_COUNTERGAN)

#: mnist/config.py:3-29, the exact reference recipe
MNIST_COUNTERGAN_REFERENCE = C.ExperimentConfig(
    name="mnist_countergan_reference",
    seed=42,
    num_classes=10,
    data=C.DataConfig(name="mnist", batch_size=128, valid_fraction=0.1),
    classifier=C.ClassifierConfig(arch="cnn", lr=1e-3, epochs=10,
                                  batch_size=128),
    countergan=C.MNIST_COUNTERGAN_REFERENCE,
)

#: The shipped default: the reference recipe with lambda_cls 2, generator
#: EMA 0.999, bf16 compute and snapshot selection every 2 epochs
MNIST_COUNTERGAN = MNIST_COUNTERGAN_REFERENCE.replace(
    name="mnist_countergan", countergan=C.MNIST_COUNTERGAN)

#: The reference recipe in bf16 compute, the rest as it is
MNIST_COUNTERGAN_BF16 = MNIST_COUNTERGAN_REFERENCE.replace(
    name="mnist_countergan_bf16",
    countergan=replace(C.MNIST_COUNTERGAN_REFERENCE,
                       compute_dtype="bfloat16"))

#: The legacy fixed-target delta CounteRGAN (`mnist/gan_train.py:17-30`:
#: target class 5, lambda_cls 3, lambda_reg 0.05; `countergan2.py`'s
#: clipped-log losses), run with `legacy_delta=True`
MNIST_COUNTERGAN_LEGACY = C.ExperimentConfig(
    name="mnist_countergan_legacy",
    seed=42,
    num_classes=10,
    data=C.DataConfig(name="mnist", batch_size=128, valid_fraction=0.1),
    classifier=C.ClassifierConfig(arch="cnn", lr=1e-3, epochs=10,
                                  batch_size=128),
    countergan=C.CounterGANConfig(
        epochs=20, lr_g=5e-5, lr_d=1e-5, lambda_adv=1.0, lambda_cls=3.0,
        lambda_reg_l1=0.05, lambda_mask=0.0, adv_loss="clipped_log",
        reg_reduction="mean_abs", clamp_cf=(-1.0, 1.0), fixed_target=5,
        resample_target=False, hidden_dim=32),
)

#: `countergan2.py`'s self-contained variant (`mnist/countergan2.py:16-30,
#: 186-205`): 50 epochs, Adam 1e-3 for both nets, the legacy MaxPool
#: classifier; its `fixed_target` comes from the command line
#: (`cfgan_torch.experiments.mnist_countergan2 --target`)
MNIST_COUNTERGAN2 = C.ExperimentConfig(
    name="mnist_countergan2",
    seed=42,
    num_classes=10,
    data=C.DataConfig(name="mnist", batch_size=128, valid_fraction=0.1),
    classifier=C.ClassifierConfig(arch="cnn_legacy", lr=1e-3, epochs=10,
                                  batch_size=128),
    countergan=C.CounterGANConfig(
        epochs=50, lr_g=1e-3, lr_d=1e-3, lambda_adv=1.0, lambda_cls=3.0,
        lambda_reg_l1=0.05, lambda_mask=0.0, adv_loss="clipped_log",
        reg_reduction="mean_abs", clamp_cf=(-1.0, 1.0), fixed_target=None,
        resample_target=False, hidden_dim=64),
)

#: house_sales_kc_usa/config.py:13-83, the exact reference recipe: the
#: AdamW classifier with class weights, early stopping and the plateau;
#: 50 CounteRGAN epochs
HOUSE_COUNTERGAN_REFERENCE = C.ExperimentConfig(
    name="house_countergan_reference",
    seed=42,
    num_classes=4,
    data=C.DataConfig(name="kc_house", batch_size=128),
    classifier=C.ClassifierConfig(
        arch="tabular", lr=5e-4, epochs=200, batch_size=128,
        weight_decay=0.01, class_weighted=True, early_stop_patience=15,
        lr_plateau=True),
    countergan=C.HOUSE_COUNTERGAN_REFERENCE,
)

#: The shipped default: clamp-trained with the out-of-range penalty,
#: lambda_cls 5 over 350 epochs, generator EMA and snapshot selection
#: every 10 epochs
HOUSE_COUNTERGAN = HOUSE_COUNTERGAN_REFERENCE.replace(
    name="house_countergan", countergan=C.HOUSE_COUNTERGAN)

#: The round-3 clamp-trained recipe (the reference recipe with the clamp
#: to [0, 1] in training, lambda_cls 4, 150 epochs), kept for its result
#: dirs
HOUSE_COUNTERGAN_CLAMPED = HOUSE_COUNTERGAN_REFERENCE.replace(
    name="house_countergan_clamped",
    countergan=C.CounterGANConfig(
        epochs=150, lr_g=1e-3, lr_d=1e-3, lambda_cls=4.0, lambda_reg_l1=1.0,
        lambda_mask=1.0, adv_loss="wasserstein",
        reg_reduction="per_sample_norm", clamp_cf=(0.0, 1.0),
        resample_target=True, hidden_dim=32, num_res_blocks=5,
        gumbel_tau=0.5))

#: The reference's committed per-target flip rates under its own
#: un-clamped protocol (`house_sales_kc_usa/results/countergan_metrics.csv:
#: 2-5`), which the house snapshot selection scores margins against
HOUSE_REFERENCE_FLIPS = (0.9999999824692222, 0.9906153240624596,
                         0.9796906499301686, 0.995971225640353)

# ------------------------------------------------------ generation families
#: simple_gan/moons/make_moons_gan.py:15-21
SIMPLE_GAN_MOONS = C.ExperimentConfig(
    name="simple_gan_moons",
    num_classes=2,
    data=C.DataConfig(name="moons2", batch_size=50),
    countergan=None,
    gan=C.GANConfig(family="simple_mlp", epochs=500, lr_g=1e-3, lr_d=1e-3,
                    latent_dim=32, hidden_dim=128),
)

#: simple_gan/mnist/mnist_gan.py:22-32 (its argparse defaults)
SIMPLE_GAN_MNIST = C.ExperimentConfig(
    name="simple_gan_mnist",
    num_classes=10,
    data=C.DataConfig(name="mnist", batch_size=64, valid_fraction=0.0),
    countergan=None,
    gan=C.GANConfig(family="mlp_image", epochs=20, lr_g=2e-4, lr_d=2e-4,
                    beta1=0.5, beta2=0.999, latent_dim=100, g_before_d=True),
)

#: conditional_gan/moons/make_moons_cgan.py:10-21
CGAN_MOONS = C.ExperimentConfig(
    name="cgan_moons",
    num_classes=2,
    data=C.DataConfig(name="moons2", batch_size=64),
    countergan=None,
    gan=C.GANConfig(family="cgan_mlp", epochs=500, lr_g=1e-3, lr_d=1e-3,
                    latent_dim=32, hidden_dim=128),
)

#: conditional_gan/mnist/mnist_wgan_conditional.py:20-32
WGAN_GP_MNIST = C.ExperimentConfig(
    name="wgan_gp_mnist",
    num_classes=10,
    data=C.DataConfig(name="mnist", batch_size=128),
    countergan=None,
    gan=C.GANConfig(family="wgan_gp", epochs=20, lr_g=1e-4, lr_d=1e-4,
                    beta1=0.0, beta2=0.9, latent_dim=32, hidden_dim=1024,
                    n_critic=5, gp_lambda=10.0),
)

#: dconv_gan/mnist/mnist_dcgan.py:15-30
DCGAN_MNIST = C.ExperimentConfig(
    name="dcgan_mnist",
    num_classes=10,
    data=C.DataConfig(name="mnist", batch_size=128, resize_to=64),
    countergan=None,
    gan=C.GANConfig(family="dcgan", epochs=5, lr_g=2e-4, lr_d=2e-4,
                    beta1=0.5, beta2=0.999, latent_dim=100, hidden_dim=64),
)

GENERATION_PRESETS = (SIMPLE_GAN_MOONS, SIMPLE_GAN_MNIST, CGAN_MOONS,
                      WGAN_GP_MNIST, DCGAN_MNIST)

PRESETS = {p.name: p for p in (
    MOONS_COUNTERGAN, MOONS_COUNTERGAN_REFERENCE, MNIST_COUNTERGAN,
    MNIST_COUNTERGAN_REFERENCE, HOUSE_COUNTERGAN, HOUSE_COUNTERGAN_REFERENCE,
    *GENERATION_PRESETS, MNIST_COUNTERGAN_LEGACY, MNIST_COUNTERGAN2,
    HOUSE_COUNTERGAN_CLAMPED, MNIST_COUNTERGAN_BF16)}
