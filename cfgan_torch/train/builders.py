"""The MNIST CounteRGAN's serving and training entry points (mirrors
`cfgan/train/builders.py`: `make_mixed_precision`, `_clf_forward_fn`,
`_init_state`, `build_mnist_countergan` with its `cf_fn`, `epoch_fn` and
`recal_fn`, `make_bn_recalibrator`, `g_serving_variables` and
`select_g_serving_variables`).

Generator variables (`g_vars`) are the generator's state dict: its float32
parameters and its BatchNorm running statistics, by the module's names
(the JAX package's `{"params", "batch_stats"}`).  EMA parameters are
never paired with the live parameters' statistics: `g_serving_variables`
recalibrates them, and `mnist_engine` raises where a state carries an
EMA and no serving variables are given, as the JAX engine's `from_bundle`
does.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Mapping

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from cfgan_torch.core.config import CounterGANConfig
from cfgan_torch.core.device import resolve_device, torch_dtype
from cfgan_torch.masks.patch import (
    patch_mask_draws,
    random_patch_mask,
    with_ones_fraction,
)
from cfgan_torch.models.classifiers import CNNClassifier
from cfgan_torch.models.discriminators import CondConvDiscriminator
from cfgan_torch.models.generators import ImageResidualGenerator
from cfgan_torch.serve.engine import CounterfactualEngine
from cfgan_torch.train.countergan import make_countergan_step, make_epoch_runner
from cfgan_torch.train.state import GANState, NetState


NUM_CLASSES = 10
IMAGE_HW = (28, 28)
# BatchNorm recalibration: train-mode forwards and their batch (the JAX
# package's `recal_fn` defaults); the running statistics forget their
# start by 0.9^200, ~7e-10
RECAL_STEPS = 200
RECAL_BATCH = 128


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
    """What `build_mnist_countergan` returns.

    - `step_fn(state, x, y, generator)`, `step_with_draws(state, x, y, t,
      mask)` and `step_from_draws(state, x, y, draws)` update `state` in
      place and return the step's metrics as device tensors
      (`make_countergan_step`);
    - `draw_fn(generator, shape)` draws the random numbers of a batch
      (`shape = (B,)`) or an epoch (`(steps, B)`);
    - `epoch_fn(state, data_x, data_y, perm, draws)` runs an epoch
      (`cfgan_torch.train.countergan.EpochRunner`: a replayed CUDA graph
      on the card);
    - `cf_fn(g_vars, x, target, mask) -> (x_cf, raw, masked)` serves
      generator variables in eval mode at the compute dtype;
    - `recal_fn(params, stats, x, generator, *, mask_mode)` recalibrates
      BatchNorm statistics under `params` (`make_bn_recalibrator`).
    """

    state: GANState
    step_fn: Callable
    step_with_draws: Callable
    step_from_draws: Callable
    draw_fn: Callable
    epoch_fn: Callable
    cf_fn: Callable
    recal_fn: Callable
    num_classes: int
    cfg: CounterGANConfig


def make_cf_fn(g_model: ImageResidualGenerator, compute_dtype: str
               ) -> Callable:
    """`cf_fn(g_vars, x, target, mask) -> (x_cf, raw, masked)`: `g_vars`
    through an eval-mode copy of `g_model` at the compute dtype (all
    floating variables cast, BatchNorm statistics included, as the JAX
    package's `cf_fn` casts them), float32 outputs, the clamp to [-1, 1]
    in float32."""
    cd = torch_dtype(compute_dtype)
    serve_g = copy.deepcopy(g_model).eval().requires_grad_(False)

    def cf_fn(g_vars, x, target, mask):
        gv = {k: v.to(cd) if v.is_floating_point() else v
              for k, v in g_vars.items()}
        with torch.no_grad():
            raw, masked = functional_call(serve_g, gv,
                                          (x.to(cd), target, mask.to(cd)))
        raw, masked = raw.float(), masked.float()
        return torch.clamp(x + masked, -1.0, 1.0), raw, masked

    return cf_fn


def make_bn_recalibrator(g_model: ImageResidualGenerator, cfg: CounterGANConfig,
                         draw_fn: Callable, mask_fn: Callable,
                         num_classes: int = NUM_CLASSES) -> Callable:
    """BatchNorm recalibration for weight-averaged generators
    (`cfgan.train.builders.make_bn_recalibrator`): the generator EMA
    averages parameters only, and its BatchNorm running statistics track
    the live parameters, so EMA parameters must be served with statistics
    recalibrated under them.

    Returns `recal_fn(params, stats, x, generator=None, *,
    mask_mode="train", draws=None) -> stats`: RECAL_STEPS train-mode
    forwards of a copy of the generator (never the live one) holding
    `params` and starting from `stats`, at the compute dtype with float32
    statistics, on batches of RECAL_BATCH rows of `x` with random targets
    and masks (`mask_mode` "train": the training masks; "ones": all-ones).
    The draws come from `generator`, or as `draws` ("idx" (steps, batch)
    rows of x, "targets", and the mask's; the parity tests hand in JAX's).
    Returns new statistics; `stats` and the live generator are left as
    they were."""
    recal_g = copy.deepcopy(g_model).requires_grad_(False)
    forward = make_mixed_precision(recal_g, cfg.compute_dtype)

    def recal_fn(params, stats, x, generator=None, *,
                 mask_mode: str = "train", draws=None):
        if mask_mode not in ("train", "ones"):
            raise ValueError(f"unknown mask_mode {mask_mode!r}")
        if draws is None:
            if generator is None:
                raise ValueError("pass the draws or a torch.Generator")
            shape = (RECAL_STEPS, RECAL_BATCH)
            draws = {"idx": torch.randint(0, x.shape[0], shape,
                                          generator=generator,
                                          device=generator.device),
                     **draw_fn(generator, shape)}
        dev = next(recal_g.parameters()).device
        draws = {k: v.to(dev) for k, v in draws.items()}
        x = x.to(dev)
        with torch.no_grad():
            recal_g.load_state_dict({**params, **stats}, strict=True)
            recal_g.train()
            for i in range(draws["idx"].shape[0]):
                xb = x.index_select(0, draws["idx"][i])
                mask = (mask_fn(xb, {k: v[i] for k, v in draws.items()})
                        if mask_mode == "train" else torch.ones_like(xb))
                forward(xb, draws["targets"][i], mask)
        buffers = dict(recal_g.named_buffers())
        return {k: buffers[k].detach().clone() for k in stats}

    return recal_fn


def live_g_variables(state: GANState) -> dict[str, torch.Tensor]:
    """The live generator's variables (parameters and statistics)."""
    return {k: v.detach() for k, v in state.g.model.state_dict().items()}


def _stats(state: GANState) -> dict[str, torch.Tensor]:
    return dict(state.g.model.named_buffers())


def g_serving_variables(bundle: MNISTCounterGAN, state: GANState, x,
                        generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Generator variables to serve or checkpoint
    (`cfgan.train.builders.g_serving_variables`): the live ones without an
    EMA; with one, the EMA parameters and BatchNorm statistics
    recalibrated under them (`recal_fn`)."""
    if state.g_ema is None:
        return live_g_variables(state)
    stats = bundle.recal_fn(state.g_ema, _stats(state), x, generator)
    return {**state.g_ema, **stats}


def serving_candidates(bundle: MNISTCounterGAN, state: GANState, x_recal,
                       generator_seed: int):
    """(name, g_vars) of each serving candidate of `state`: "live"; with an
    EMA, "ema_recal_train" and "ema_recal_ones" (EMA parameters with
    statistics recalibrated under the training masks and under all-ones
    masks, each from a generator seeded with `generator_seed`, as the JAX
    package recalibrates both from one key)."""
    yield "live", live_g_variables(state)
    if state.g_ema is None:
        return
    dev = x_recal.device
    for mode in ("train", "ones"):
        gen = torch.Generator(device=dev).manual_seed(generator_seed)
        stats = bundle.recal_fn(state.g_ema, _stats(state), x_recal, gen,
                                mask_mode=mode)
        yield f"ema_recal_{mode}", {**state.g_ema, **stats}


def select_g_serving_variables(bundle: MNISTCounterGAN, state: GANState,
                               x_recal, generator_seed: int, xva, yva,
                               clf_fn: Callable):
    """Validation-scored choice among `serving_candidates`
    (`cfgan.train.builders.select_g_serving_variables`): each candidate's
    per-target flip rates under all-ones masks on (xva, yva); the best by
    worst-target flip, then mean flip.  Returns (g_vars, info) with the
    chosen candidate and every score."""
    from cfgan_torch.eval.metrics import make_per_target_sweep, per_target_metrics

    if state.g_ema is None:
        return live_g_variables(state), {"candidate": "live", "scores": {}}
    sweep = make_per_target_sweep(bundle.cf_fn, clf_fn, bundle.num_classes)
    candidates, scores = {}, {}
    for name, gv in serving_candidates(bundle, state, x_recal,
                                       generator_seed):
        cols = per_target_metrics(
            sweep, gv, xva, yva, mask_fn=lambda b: torch.ones(
                (b, *IMAGE_HW, 1), device=x_recal.device),
            num_classes=bundle.num_classes, batch_size=1024)
        flips = cols["class_flip_rate"]
        candidates[name] = gv
        scores[name] = {"worst_flip": round(float(np.nanmin(flips)), 6),
                        "mean_flip": round(float(np.nanmean(flips)), 6)}
    best = max(scores, key=lambda n: (scores[n]["worst_flip"],
                                      scores[n]["mean_flip"]))
    return candidates[best], {"candidate": best, "scores": scores}


def mnist_engine(bundle: MNISTCounterGAN, clf_fn: Callable,
                 g_variables: Mapping[str, torch.Tensor] | None = None,
                 state: GANState | None = None,
                 device: str | torch.device | None = None
                 ) -> CounterfactualEngine:
    """A `CounterfactualEngine` on a training bundle's generator
    (`CounterfactualEngine.from_bundle` in the JAX package).  A state that
    carries an EMA must come with `g_variables` (`g_serving_variables`):
    serving its live parameters would ignore the EMA, and its EMA
    parameters against the live statistics would mis-normalize."""
    state = state if state is not None else bundle.state
    if g_variables is None:
        if state.g_ema is not None:
            raise ValueError(
                "the state carries generator EMA parameters; pass "
                "g_variables=g_serving_variables(...) so that the "
                "BatchNorm statistics are recalibrated under them")
        g_variables = live_g_variables(state)
    gv = dict(g_variables)

    def cf_fn(x, target, mask):
        return bundle.cf_fn(gv, x, target, mask)

    return CounterfactualEngine(cf_fn, clf_fn, bundle.num_classes,
                                patch_size=bundle.cfg.mask.patch_size,
                                device=device)


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
    m = cfg.mask

    def draw_fn(generator: torch.Generator, shape: tuple[int, ...]) -> dict:
        draws = {"targets": torch.randint(0, NUM_CLASSES, shape,
                                          generator=generator,
                                          device=generator.device)}
        scores = patch_mask_draws(shape, IMAGE_HW, m.patch_size,
                                  m.num_modifiable_patches, generator)
        if scores is not None:
            draws["mask"] = scores
        if m.ones_fraction:
            draws["ones"] = torch.rand(shape, generator=generator,
                                       device=generator.device)
        return draws

    def mask_fn(x, draws):
        mask = random_patch_mask(
            x.shape[0], IMAGE_HW, m.patch_size, m.num_modifiable_patches,
            channels=x.shape[-1], draws=draws.get("mask"), device=x.device)
        return with_ones_fraction(mask, m.ones_fraction,
                                  draws=draws.get("ones"))

    g_forward = make_mixed_precision(g_model, cfg.compute_dtype)
    step_fn, step_with_draws, step_from_draws = make_countergan_step(
        cfg=cfg, num_classes=NUM_CLASSES, g_forward=g_forward,
        d_forward=make_mixed_precision(d_model, cfg.compute_dtype),
        clf_forward=clf_forward_fn(clf_model.to(device), cfg.compute_dtype),
        draw_fn=draw_fn, mask_fn=mask_fn, diagnostics=diagnostics)
    return MNISTCounterGAN(
        state, step_fn, step_with_draws, step_from_draws, draw_fn,
        make_epoch_runner(step_from_draws), make_cf_fn(g_model,
                                                       cfg.compute_dtype),
        make_bn_recalibrator(g_model, cfg, draw_fn, mask_fn),
        NUM_CLASSES, cfg)
