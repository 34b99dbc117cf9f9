"""The MNIST CounteRGAN experiment presets (mirrors the MNIST entries of
`cfgan/experiments/presets.py`, under the same names).

`cfgan_torch.core.config.MNIST_COUNTERGAN` and `..._REFERENCE` are the
`CounterGANConfig`s of these experiments (the train step's and serving's
part of them).
"""
from __future__ import annotations

from cfgan_torch.core import config as C

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
