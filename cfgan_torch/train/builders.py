"""The MNIST serving functions (mirrors the serving half of
`cfgan/train/builders.py`: `_cast_floats`, `_clf_forward_fn` and the
`cf_fn` of `build_mnist_countergan`)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping

import torch

from cfgan_torch.core.config import CounterGANConfig
from cfgan_torch.core.device import resolve_device, torch_dtype
from cfgan_torch.models.classifiers import CNNClassifier
from cfgan_torch.models.generators import ImageResidualGenerator


NUM_CLASSES = 10


@dataclass
class MNISTServing:
    # (x, target, mask, key=None) -> (x_cf, raw, masked), all float32
    cf_fn: Callable
    clf_fn: Callable  # (x,) -> float32 logits
    generator: ImageResidualGenerator
    classifier: CNNClassifier
    num_classes: int


def mnist_models(cfg: CounterGANConfig,
                 generator: torch.Generator | None = None
                 ) -> tuple[ImageResidualGenerator, CNNClassifier]:
    """The MNIST generator and classifier (28x28x1 images, ten classes)
    that `cfg` describes, float32 on the CPU, with initial weights drawn
    from `generator`."""
    g_model = ImageResidualGenerator(
        num_classes=NUM_CLASSES, base_ch=cfg.hidden_dim,
        n_resblocks=cfg.num_res_blocks,
        residual_scaling=cfg.residual_scaling, conv_impl=cfg.conv_impl,
        generator=generator)
    clf_model = CNNClassifier(num_classes=NUM_CLASSES, generator=generator)
    return g_model, clf_model


def build_mnist_serving(cfg: CounterGANConfig,
                        g_params: Mapping[str, torch.Tensor],
                        clf_params: Mapping[str, torch.Tensor],
                        device: str | torch.device | None = None
                        ) -> MNISTServing:
    """Generator and classifier at `cfg.compute_dtype` on `device` (None:
    the CUDA card; raises where there is none) from their state dicts
    (`cfgan_torch.convert` makes them from the JAX package's variables;
    a conv's weight loads whichever `conv_impl` it was saved under).

    Parameters, BatchNorm statistics and activations are cast to the
    compute dtype, as `_cast_floats` does; `raw` and `masked` come back
    float32 and the clamp to [-1, 1] runs in float32.
    """
    device = resolve_device(device)
    cd = torch_dtype(cfg.compute_dtype)
    g_model, clf_model = mnist_models(cfg)
    for model, params in ((g_model, g_params), (clf_model, clf_params)):
        model.load_state_dict(params, strict=True)
        model.to(device=device, dtype=cd).eval().requires_grad_(False)

    def cf_fn(x, target, mask, key=None):
        """`key` is accepted for the engine's signature; the MNIST
        generator draws no noise."""
        raw, masked = g_model(x.to(cd), target, mask.to(cd))
        raw, masked = raw.float(), masked.float()
        return torch.clamp(x + masked, -1.0, 1.0), raw, masked

    def clf_fn(x):
        return clf_model(x.to(cd)).float()

    return MNISTServing(cf_fn, clf_fn, g_model, clf_model, NUM_CLASSES)
