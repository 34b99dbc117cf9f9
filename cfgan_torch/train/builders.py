"""The MNIST CounteRGAN's serving and training entry points (mirrors
`cfgan/train/builders.py`: `make_mixed_precision`, `_clf_forward_fn`,
`_init_state`, `build_mnist_countergan` and its `cf_fn`)."""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Mapping

import torch
from torch import nn
from torch.func import functional_call

from cfgan_torch.core.config import CounterGANConfig
from cfgan_torch.core.device import resolve_device, torch_dtype
from cfgan_torch.masks.patch import random_patch_mask, with_ones_fraction
from cfgan_torch.models.classifiers import CNNClassifier
from cfgan_torch.models.discriminators import CondConvDiscriminator
from cfgan_torch.models.generators import ImageResidualGenerator
from cfgan_torch.train.countergan import make_countergan_step
from cfgan_torch.train.state import GANState, NetState


NUM_CLASSES = 10
IMAGE_HW = (28, 28)


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

    The generator's parameters, BatchNorm statistics and activations are
    cast to the compute dtype, as `_cast_floats` does; `raw` and `masked`
    come back float32 and the clamp to [-1, 1] runs in float32.  The
    classifier runs in float32 whatever the compute dtype, as the JAX
    serving engine's `from_bundle` applies it.
    """
    device = resolve_device(device)
    cd = torch_dtype(cfg.compute_dtype)
    g_model, clf_model = mnist_models(cfg)
    for model, params, dtype in ((g_model, g_params, cd),
                                 (clf_model, clf_params, torch.float32)):
        model.load_state_dict(params, strict=True)
        model.to(device=device, dtype=dtype).eval().requires_grad_(False)

    def cf_fn(x, target, mask, key=None):
        """`key` is accepted for the engine's signature; the MNIST
        generator draws no noise."""
        raw, masked = g_model(x.to(cd), target, mask.to(cd))
        raw, masked = raw.float(), masked.float()
        return torch.clamp(x + masked, -1.0, 1.0), raw, masked

    def clf_fn(x):
        return clf_model(x.float())

    return MNISTServing(cf_fn, clf_fn, g_model, clf_model, NUM_CLASSES)


def _cast_floats(a, dtype: torch.dtype):
    """Cast a floating tensor, or each floating tensor of a tuple."""
    if isinstance(a, tuple):
        return tuple(_cast_floats(v, dtype) for v in a)
    return a.to(dtype) if a.is_floating_point() else a


def make_mixed_precision(module: nn.Module, compute_dtype: str) -> Callable:
    """`apply(*arrays, detach=False)`: `module`'s forward in
    `compute_dtype` with its float32 master parameters
    (`make_mixed_precision`).

    The parameters are cast inside the autograd graph (through
    `torch.func.functional_call`), so their gradients arrive in float32;
    floating inputs are cast to the compute dtype and floating outputs back
    to float32.  Buffers are not cast: BatchNorm's running statistics stay
    float32 and its train path updates them in place.  `detach=True` stops
    the gradient at the parameters.  This is not `torch.autocast`, which
    chooses per op what to cast and so rounds elsewhere."""
    cd = torch_dtype(compute_dtype)

    def apply(*arrays, detach: bool = False):
        params = {name: (p.detach() if detach else p).to(cd)
                  for name, p in module.named_parameters()}
        out = functional_call(module, params, _cast_floats(arrays, cd))
        return _cast_floats(out, torch.float32)

    return apply


def clf_forward_fn(clf_model: CNNClassifier, compute_dtype: str
                   ) -> Callable:
    """The frozen classifier's forward at the compute dtype, float32 logits
    (`_clf_forward_fn`): a copy of `clf_model` cast to the compute dtype,
    in eval mode, without gradients for its parameters."""
    cd = torch_dtype(compute_dtype)
    frozen = copy.deepcopy(clf_model).to(cd).eval().requires_grad_(False)

    def clf_forward(x):
        return frozen(x.to(cd)).float()

    return clf_forward


@dataclass
class MNISTCounterGAN:
    """What `build_mnist_countergan` returns.  `step_fn(state, x, y,
    generator)` and `step_with_draws(state, x, y, t, mask)` update `state`
    in place and return the step's metrics as device tensors."""

    state: GANState
    step_fn: Callable
    step_with_draws: Callable
    num_classes: int


def build_mnist_countergan(cfg: CounterGANConfig,
                           clf_params: Mapping[str, torch.Tensor],
                           seed: int = 42,
                           device: str | torch.device | None = None,
                           diagnostics: bool = True) -> MNISTCounterGAN:
    """The MNIST CounteRGAN train step (`build_mnist_countergan`, the
    residual-generator family) on `device` (None: the CUDA card; raises
    where there is none).

    Generator and `CondConvDiscriminator` get initial weights from a
    `torch.Generator` seeded with `seed` (`cfgan_torch.convert.
    load_gan_state` loads others over them), Adam at `cfg.lr_g` /
    `cfg.lr_d`, and the generator EMA starts at the initial parameters.
    `clf_params` is the frozen classifier's state dict.  Masks are random
    patch masks (`cfg.mask`); 28x28x1 images, ten classes.
    `diagnostics=False` leaves the metrics at d_loss and g_loss, and the
    step without the extra classifier forward they take."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    g_model, clf_model = mnist_models(cfg, generator=gen)
    clf_model.load_state_dict(clf_params, strict=True)
    d_model = CondConvDiscriminator(NUM_CLASSES, cfg.hidden_dim, IMAGE_HW,
                                    generator=gen)
    g_model.to(device).train()
    d_model.to(device).train()
    state = GANState(
        g=NetState.create(g_model, cfg.lr_g),
        d=NetState.create(d_model, cfg.lr_d),
        g_ema=({name: p.detach().clone()
                for name, p in g_model.named_parameters()}
               if cfg.ema_decay else None))

    def mask_sampler(x, generator):
        mask = random_patch_mask(
            x.shape[0], IMAGE_HW, cfg.mask.patch_size,
            cfg.mask.num_modifiable_patches, channels=x.shape[-1],
            generator=generator, device=x.device)
        return with_ones_fraction(mask, cfg.mask.ones_fraction,
                                  generator=generator)

    step_fn, step_with_draws = make_countergan_step(
        cfg=cfg, num_classes=NUM_CLASSES,
        g_forward=make_mixed_precision(g_model, cfg.compute_dtype),
        d_forward=make_mixed_precision(d_model, cfg.compute_dtype),
        clf_forward=clf_forward_fn(clf_model.to(device), cfg.compute_dtype),
        mask_sampler=mask_sampler, diagnostics=diagnostics)
    return MNISTCounterGAN(state, step_fn, step_with_draws, NUM_CLASSES)
