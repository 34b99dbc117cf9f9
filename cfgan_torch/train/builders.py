"""The moons, MNIST and King County house CounteRGANs' serving and
training entry points (mirrors `cfgan/train/builders.py`:
`make_mixed_precision`, `_clf_forward_fn`, `_init_state`,
`build_moons_countergan`, `build_mnist_countergan` and
`build_tabular_countergan` with their `cf_fn`, `epoch_fn` and
`recal_fn`, `make_bn_recalibrator`, `g_serving_variables` and
`select_g_serving_variables`).

Generator variables (`g_vars`) are the generator's state dict: its float32
parameters and its BatchNorm running statistics, by the module's names
(the JAX package's `{"params", "batch_stats"}`).  Every function here
that hands generator variables on (to an engine, a selector or a
checkpoint) hands copies: the train step updates the live parameters, the
statistics and the EMA in place, and served variables must not follow
them, as the JAX package's immutable arrays do not.  EMA parameters are
never paired with the live parameters' statistics: `g_serving_variables`
recalibrates them, and the engines raise where a state carries an EMA
and no serving variables are given, as the JAX engine's `from_bundle`
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

from cfgan_torch.core.config import CounterGANConfig, TabularSchema
from cfgan_torch.core.device import resolve_device, torch_dtype
from cfgan_torch.data.transforms import NormStats
from cfgan_torch.masks.feature import (
    feature_mask_draws,
    immutable_complement_mask,
    random_feature_mask,
)
from cfgan_torch.masks.patch import (
    patch_mask_draws,
    random_patch_mask,
    with_ones_fraction,
)
from cfgan_torch.models.classifiers import (
    CNNClassifier,
    LegacyCNNClassifier,
    MLPClassifier,
    TabularClassifier,
)
from cfgan_torch.models.discriminators import (
    CondConvDiscriminator,
    ConvDiscriminator,
    SpectralMLPDiscriminator,
)
from cfgan_torch.models.generators import (
    DeltaImageGenerator,
    ImageResidualGenerator,
    MoonsResidualGenerator,
    TabularResidualGenerator,
)
from cfgan_torch.models.tabular import (
    Key,
    ResidualAssembly,
    build_cat_norm_values,
    derive_gumbel_noise,
)
from cfgan_torch.nn.layers import one_hot
from cfgan_torch.serve.engine import CounterfactualEngine
from cfgan_torch.train.countergan import make_countergan_step
from cfgan_torch.train.loop import make_epoch_runner
from cfgan_torch.train.state import GANState, NetState, g_eval_variables


# the shipped datasets' shapes, the builders' defaults (as the JAX
# builders'): MNIST's 28x28 images of ten classes, moons' 2-D points of
# three
NUM_CLASSES = 10
IMAGE_HW = (28, 28)
MOONS_CLASSES = 3
MOONS_DIM = 2
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
                 generator: torch.Generator | None = None,
                 legacy_delta: bool = False, num_classes: int = NUM_CLASSES,
                 image_hw: tuple[int, int] = IMAGE_HW
                 ) -> tuple[nn.Module, nn.Module]:
    """The image generator and classifier (one-channel `image_hw` images,
    `num_classes` classes; MNIST's 28x28 and ten by default) that `cfg`
    describes, float32 on the CPU, with initial weights drawn from
    `generator`: `ImageResidualGenerator` and `CNNClassifier`, or with
    `legacy_delta` the legacy stack's `DeltaImageGenerator` (width
    `cfg.hidden_dim`) and `LegacyCNNClassifier`."""
    if legacy_delta:
        return (DeltaImageGenerator(num_classes=num_classes,
                                    base_ch=cfg.hidden_dim,
                                    image_hw=image_hw, generator=generator),
                LegacyCNNClassifier(num_classes=num_classes,
                                    image_hw=image_hw, generator=generator))
    g_model = ImageResidualGenerator(
        image_hw=image_hw, num_classes=num_classes, base_ch=cfg.hidden_dim,
        n_resblocks=cfg.num_res_blocks,
        residual_scaling=cfg.residual_scaling, conv_impl=cfg.conv_impl,
        remat=cfg.remat, generator=generator)
    clf_model = CNNClassifier(num_classes=num_classes, image_hw=image_hw,
                              generator=generator)
    return g_model, clf_model


def build_mnist_serving(cfg: CounterGANConfig,
                        g_params: Mapping[str, torch.Tensor],
                        clf_params: Mapping[str, torch.Tensor],
                        device: str | torch.device | None = None,
                        num_classes: int = NUM_CLASSES,
                        image_hw: tuple[int, int] = IMAGE_HW
                        ) -> MNISTServing:
    """Generator and classifier at `cfg.compute_dtype` on `device` (None:
    the CUDA card; raises where there is none) from their state dicts
    (`cfgan_torch.convert` makes them from the JAX package's variables;
    a conv's weight loads whichever `conv_impl` it was saved under), for
    `image_hw` images of `num_classes` classes (`mnist_models`).

    The generator's parameters, BatchNorm statistics and activations are
    cast to the compute dtype, as `_cast_floats` does; `raw` and `masked`
    come back float32 and the clamp to [-1, 1] runs in float32.  The
    classifier runs in float32 whatever the compute dtype, as the JAX
    serving engine's `from_bundle` applies it.
    """
    device = resolve_device(device)
    cd = torch_dtype(cfg.compute_dtype)
    g_model, clf_model = mnist_models(cfg, num_classes=num_classes,
                                      image_hw=image_hw)
    for model, params, dtype in ((g_model, g_params, cd),
                                 (clf_model, clf_params, torch.float32)):
        model.load_state_dict(params, strict=True)
        model.to(device=device, dtype=dtype).eval().requires_grad_(False)

    def cf_fn(x, target, mask, key=None, row0=0):
        """`key` and `row0` are accepted for the engine's signature; the
        MNIST generator draws no noise."""
        raw, masked = g_model(x.to(cd), target, mask.to(cd))
        raw, masked = raw.float(), masked.float()
        return torch.clamp(x + masked, -1.0, 1.0), raw, masked

    def clf_fn(x):
        return clf_model(x.float())

    return MNISTServing(cf_fn, clf_fn, g_model, clf_model, num_classes)


@dataclass
class MoonsServing:
    # (x, target, mask, key=None) -> (x_cf, raw, masked), all float32
    cf_fn: Callable
    clf_fn: Callable  # (x,) -> float32 logits
    generator: MoonsResidualGenerator
    classifier: MLPClassifier
    num_classes: int


def moons_models(cfg: CounterGANConfig, clf_hidden_dim: int = 32,
                 generator: torch.Generator | None = None,
                 num_classes: int = MOONS_CLASSES, input_dim: int = MOONS_DIM
                 ) -> tuple[MoonsResidualGenerator, MLPClassifier]:
    """The moons generator (width `cfg.hidden_dim`) and classifier (width
    `clf_hidden_dim`) on `input_dim`-D points with `num_classes` classes
    (2 and 3 by default), float32 on the CPU, with initial weights drawn
    from `generator`."""
    g_model = MoonsResidualGenerator(input_dim, cfg.hidden_dim, num_classes,
                                     generator=generator)
    clf_model = MLPClassifier(num_classes, clf_hidden_dim, input_dim,
                              generator=generator)
    return g_model, clf_model


def build_moons_serving(cfg: CounterGANConfig,
                        g_params: Mapping[str, torch.Tensor],
                        clf_params: Mapping[str, torch.Tensor],
                        device: str | torch.device | None = None,
                        num_classes: int = MOONS_CLASSES,
                        input_dim: int = MOONS_DIM) -> MoonsServing:
    """The moons generator at `cfg.compute_dtype` and its float32
    classifier (as wide as `clf_params`) on `device` (None: the CUDA card;
    raises where there is none) from their state dicts, in eval mode (the
    `cf_fn` of `build_moons_countergan`): the target one-hot at the
    compute dtype, BatchNorm on its running statistics, and `x + masked`
    in float32, unclamped (the moons presets have `clamp_cf=None`);
    `input_dim`-D points of `num_classes` classes (`moons_models`)."""
    device = resolve_device(device)
    cd = torch_dtype(cfg.compute_dtype)
    g_model, clf_model = moons_models(
        cfg, clf_params["Linear_0.weight"].shape[0], num_classes=num_classes,
        input_dim=input_dim)
    for model, params, dtype in ((g_model, g_params, cd),
                                 (clf_model, clf_params, torch.float32)):
        model.load_state_dict(params, strict=True)
        model.to(device=device, dtype=dtype).eval().requires_grad_(False)

    def cf_fn(x, target, mask, key=None, row0=0):
        """`key` and `row0` are accepted for the engine's signature; the
        moons generator draws no noise."""
        raw, masked = g_model(x.to(cd), one_hot(target, num_classes, cd),
                              mask.to(cd))
        raw, masked = raw.float(), masked.float()
        return x + masked, raw, masked

    def clf_fn(x):
        return clf_model(x.float())

    return MoonsServing(cf_fn, clf_fn, g_model, clf_model, num_classes)


def moons_engine(cfg: CounterGANConfig, g_params: Mapping[str, torch.Tensor],
                 clf_params: Mapping[str, torch.Tensor],
                 device: str | torch.device | None = None
                 ) -> CounterfactualEngine:
    """A generic `CounterfactualEngine` (no patch size, no schema: the
    default mask is all-ones) on `build_moons_serving`, with replicas for
    `shard`."""

    def serving(dev):
        s = build_moons_serving(cfg, g_params, clf_params, dev)
        return s.cf_fn, s.clf_fn

    return CounterfactualEngine(*serving(device), MOONS_CLASSES,
                                device=device, replica_fn=serving)


def _cast_floats(a, dtype: torch.dtype):
    """Cast a floating tensor, or each floating tensor of a tuple or a
    dict."""
    if isinstance(a, tuple):
        return tuple(_cast_floats(v, dtype) for v in a)
    if isinstance(a, dict):
        return {k: _cast_floats(v, dtype) for k, v in a.items()}
    return a.to(dtype) if a.is_floating_point() else a


def make_mixed_precision(module: nn.Module, compute_dtype: str,
                         post: Callable | None = None) -> Callable:
    """`apply(*arrays, detach=False, **kwargs)`: `module`'s forward in
    `compute_dtype` with its float32 master parameters
    (`make_mixed_precision`).

    The parameters are cast inside the autograd graph (through
    `torch.func.functional_call`), so their gradients arrive in float32;
    floating inputs are cast to the compute dtype and floating outputs back
    to float32.  `kwargs` go to the forward as they are (flags, and the
    tabular generator's noise, whose dtype the generator chooses).
    `post(out, *arrays)`, where given, runs on the outputs and the cast
    inputs before the outputs are cast back, in the compute dtype (the
    tabular residual's assembly, which the JAX package's wrapped
    `g_forward` holds).  Buffers are not cast: BatchNorm's running
    statistics stay float32 and its train path updates them in place.
    `detach=True` stops the gradient at the parameters.  This is not
    `torch.autocast`, which chooses per op what to cast and so rounds
    elsewhere."""
    cd = torch_dtype(compute_dtype)

    def apply(*arrays, detach: bool = False, **kwargs):
        params = {name: (p.detach() if detach else p).to(cd)
                  for name, p in module.named_parameters()}
        arrays = _cast_floats(arrays, cd)
        out = functional_call(module, params, arrays, kwargs)
        if post is not None:
            out = post(out, *arrays)
        return _cast_floats(out, torch.float32)

    return apply


def clf_forward_fn(clf_model: nn.Module, compute_dtype: str) -> Callable:
    """The frozen classifier's forward at the compute dtype, float32 logits
    (`_clf_forward_fn`): a copy of `clf_model` cast to the compute dtype,
    in eval mode, without gradients for its parameters."""
    cd = torch_dtype(compute_dtype)
    frozen = copy.deepcopy(clf_model).to(cd).eval().requires_grad_(False)

    def clf_forward(x):
        return frozen(x.to(cd)).float()

    return clf_forward


@dataclass
class CounterGANBundle:
    """What `build_moons_countergan`, `build_mnist_countergan` and
    `build_tabular_countergan` return.

    - `step_fn(state, x, y, generator)`, `step_with_draws(state, x, y, t,
      mask, noise=None, chunk_noise=None)` and `step_from_draws(state, x,
      y, draws)` update `state` in
      place and return the step's metrics as device tensors
      (`make_countergan_step`);
    - `draw_fn(generator, shape)` draws the random numbers of a batch
      (`shape = (B,)`) or an epoch (`(steps, B)`);
    - `epoch_fn(state, data_x, data_y, perm, draws)` runs an epoch
      (`cfgan_torch.train.countergan.EpochRunner`: a replayed CUDA graph
      on the card);
    - `cf_fn(g_vars, x, target, mask, key=None) -> (x_cf, raw, masked)`
      serves generator variables in eval mode at the compute dtype (the
      tabular one derives its Gumbel noise from `key`, a JAX key pair);
    - `recal_fn(params, stats, x, generator, *, mask_mode)` recalibrates
      BatchNorm statistics under `params` (`make_bn_recalibrator`).

    A tabular bundle also carries its `schema` and its MinMax `stats`.
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
    schema: TabularSchema | None = None
    stats: NormStats | None = None


def make_cf_fn(g_model: nn.Module, compute_dtype: str) -> Callable:
    """`cf_fn(g_vars, x, target, mask, key=None) -> (x_cf, raw, masked)`:
    `g_vars` through an eval-mode copy of `g_model` (an
    `ImageResidualGenerator`, or the legacy `DeltaImageGenerator`, which
    ignores the mask and returns its delta twice) at the compute dtype
    (all floating variables cast, BatchNorm statistics included, as the
    JAX package's `cf_fn` casts them), float32 outputs, the clamp to
    [-1, 1] in float32.  `key` and `row0` are accepted for the families'
    common signature; the MNIST generators draw no noise."""
    cd = torch_dtype(compute_dtype)
    serve_g = copy.deepcopy(g_model).eval().requires_grad_(False)

    def cf_fn(g_vars, x, target, mask, key=None, row0=0):
        gv = {k: v.to(cd) if v.is_floating_point() else v
              for k, v in g_vars.items()}
        with torch.no_grad():
            raw, masked = functional_call(serve_g, gv,
                                          (x.to(cd), target, mask.to(cd)))
        raw, masked = raw.float(), masked.float()
        return torch.clamp(x + masked, -1.0, 1.0), raw, masked

    return cf_fn


def make_bn_recalibrator(g_model: nn.Module, cfg: CounterGANConfig,
                         draw_fn: Callable, mask_fn: Callable,
                         g_forward_of: Callable | None = None,
                         full_mask_fn: Callable | None = None) -> Callable:
    """BatchNorm recalibration for weight-averaged generators
    (`cfgan.train.builders.make_bn_recalibrator`): the generator EMA
    averages parameters only, and its BatchNorm running statistics track
    the live parameters, so EMA parameters must be served with statistics
    recalibrated under them.

    Returns `recal_fn(params, stats, x, generator=None, *,
    mask_mode="train", draws=None) -> stats`: RECAL_STEPS train-mode
    forwards of a copy of the generator (never the live one) holding
    `params` and starting from `stats`, at the compute dtype with float32
    statistics, on batches of RECAL_BATCH rows of `x` with random targets,
    masks and noise (`mask_mode` "train": the training masks; "ones": the
    family's fully modifiable mask, `full_mask_fn(x)` or all-ones).
    `g_forward_of(module)` gives the family's train-mode
    `g_forward(x, t, mask[, noise])` of a module (default: its forward at
    the compute dtype).  The draws come from `generator`, or as `draws`
    ("idx" (steps, batch) rows of x, "targets", the mask's and the noise's;
    the parity tests hand in JAX's).  Returns new statistics; `stats` and
    the live generator are left as they were."""
    recal_g = copy.deepcopy(g_model).requires_grad_(False)
    forward = (g_forward_of(recal_g) if g_forward_of is not None
               else make_mixed_precision(recal_g, cfg.compute_dtype))

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
                if mask_mode == "train":
                    mask = mask_fn(xb, {k: v[i] for k, v in draws.items()})
                elif full_mask_fn is not None:
                    mask = full_mask_fn(xb)
                else:
                    mask = torch.ones_like(xb)
                noise = (draws["gumbel"][i],) if "gumbel" in draws else ()
                forward(xb, draws["targets"][i], mask, *noise)
        buffers = dict(recal_g.named_buffers())
        return {k: buffers[k].detach().clone() for k in stats}

    return recal_fn


def _copies(variables: Mapping[str, torch.Tensor]
            ) -> dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in variables.items()}


def live_g_variables(state: GANState) -> dict[str, torch.Tensor]:
    """A copy of the live generator's variables (parameters and
    statistics)."""
    return _copies(state.g.model.state_dict())


def _stats(state: GANState) -> dict[str, torch.Tensor]:
    return dict(state.g.model.named_buffers())


def g_serving_variables(bundle: CounterGANBundle, state: GANState, x,
                        generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Generator variables to serve or checkpoint, as copies
    (`cfgan.train.builders.g_serving_variables`): the live ones without an
    EMA; with one, the EMA parameters and BatchNorm statistics
    recalibrated under them (`recal_fn`)."""
    if state.g_ema is None:
        return g_eval_variables(state)
    stats = bundle.recal_fn(state.g_ema, _stats(state), x, generator)
    return {**_copies(state.g_ema), **stats}


def serving_candidates(bundle: CounterGANBundle, state: GANState, x_recal,
                       generator_seed: int):
    """(name, g_vars) of each serving candidate of `state`, as copies:
    "live"; with an EMA, "ema_recal_train" and "ema_recal_ones" (EMA
    parameters with statistics recalibrated under the training masks and
    under the fully modifiable mask, each from a generator seeded with
    `generator_seed`, as the JAX package recalibrates both from one
    key)."""
    yield "live", live_g_variables(state)
    if state.g_ema is None:
        return
    dev = x_recal.device
    for mode in ("train", "ones"):
        gen = torch.Generator(device=dev).manual_seed(generator_seed)
        stats = bundle.recal_fn(state.g_ema, _stats(state), x_recal, gen,
                                mask_mode=mode)
        yield f"ema_recal_{mode}", {**_copies(state.g_ema), **stats}


def select_g_serving_variables(bundle: CounterGANBundle, state: GANState,
                               x_recal, generator_seed: int, xva, yva,
                               clf_fn: Callable, *,
                               serving_mask_fn: Callable | None = None,
                               key: Key | None = None):
    """Validation-scored choice among `serving_candidates`
    (`cfgan.train.builders.select_g_serving_variables`): each candidate's
    per-target flip rates on (xva, yva) under the family's serving mask
    (`serving_mask_fn(batch)`; default all-ones), the tabular family's
    noise from `key`; the best by worst-target flip, then mean flip.
    Returns (g_vars, info) with the chosen candidate and every score."""
    from cfgan_torch.eval.metrics import (
        MNIST_PROTOCOL,
        make_per_target_sweep,
        per_target_metrics,
    )

    if state.g_ema is None:
        return live_g_variables(state), {"candidate": "live", "scores": {}}
    sweep = make_per_target_sweep(bundle.cf_fn, clf_fn, bundle.num_classes,
                                  **MNIST_PROTOCOL)
    mask_fn = serving_mask_fn or (lambda b: torch.ones(
        (b, *np.shape(xva)[1:]), device=x_recal.device))
    candidates, scores = {}, {}
    for name, gv in serving_candidates(bundle, state, x_recal,
                                       generator_seed):
        cols = per_target_metrics(
            sweep, gv, xva, yva, mask_fn=mask_fn,
            num_classes=bundle.num_classes, batch_size=1024, key=key)
        flips = cols["class_flip_rate"]
        candidates[name] = gv
        scores[name] = {"worst_flip": round(float(np.nanmin(flips)), 6),
                        "mean_flip": round(float(np.nanmean(flips)), 6)}
    best = max(scores, key=lambda n: (scores[n]["worst_flip"],
                                      scores[n]["mean_flip"]))
    return candidates[best], {"candidate": best, "scores": scores}


def _engine(bundle: CounterGANBundle, clf_fn: Callable,
            g_variables: Mapping[str, torch.Tensor] | None,
            state: GANState | None, device, **kw) -> CounterfactualEngine:
    state = state if state is not None else bundle.state
    if g_variables is None:
        if state.g_ema is not None:
            raise ValueError(
                "the state carries generator EMA parameters; pass "
                "g_variables=g_serving_variables(...) so that the "
                "BatchNorm statistics are recalibrated under them")
        g_variables = state.g.model.state_dict()
    gv = _copies(g_variables)

    def cf_fn(x, target, mask, key=None, row0=0):
        return bundle.cf_fn(gv, x, target, mask, key, row0=row0)

    return CounterfactualEngine(cf_fn, clf_fn, bundle.num_classes,
                                device=device, **kw)


def mnist_engine(bundle: CounterGANBundle, clf_fn: Callable,
                 g_variables: Mapping[str, torch.Tensor] | None = None,
                 state: GANState | None = None,
                 device: str | torch.device | None = None
                 ) -> CounterfactualEngine:
    """A `CounterfactualEngine` on a training bundle's generator
    (`CounterfactualEngine.from_bundle` in the JAX package), serving a copy
    of the variables: training on does not change what it serves.  A
    state that carries an EMA must come with `g_variables`
    (`g_serving_variables`): serving its live parameters would ignore the
    EMA, and its EMA parameters against the live statistics would
    mis-normalize."""
    return _engine(bundle, clf_fn, g_variables, state, device,
                   patch_size=bundle.cfg.mask.patch_size)


def house_engine(bundle: CounterGANBundle, clf_fn: Callable,
                 g_variables: Mapping[str, torch.Tensor] | None = None,
                 state: GANState | None = None,
                 device: str | torch.device | None = None
                 ) -> CounterfactualEngine:
    """`mnist_engine` for a tabular bundle: the engine carries the
    bundle's schema, so its default mask zeroes the immutable features
    and `mask_from_feature_names` builds requests' masks, and the bundle's
    MinMax stats (`engine.stats`), which map its data space back to the
    features' units; each request's Gumbel noise comes from its key."""
    return _engine(bundle, clf_fn, g_variables, state, device,
                   schema=bundle.schema, stats=bundle.stats)


def build_mnist_countergan(cfg: CounterGANConfig,
                           clf_params: Mapping[str, torch.Tensor],
                           seed: int = 42,
                           device: str | torch.device | None = None,
                           diagnostics: bool = True,
                           legacy_delta: bool = False,
                           num_classes: int = NUM_CLASSES,
                           image_hw: tuple[int, int] = IMAGE_HW
                           ) -> CounterGANBundle:
    """The MNIST CounteRGAN train step (`build_mnist_countergan`) on
    `device` (None: the CUDA card; raises where there is none).

    The residual-generator family: `ImageResidualGenerator` and
    `CondConvDiscriminator`, random patch masks (`cfg.mask`).  With
    `legacy_delta` the legacy delta-generator family
    (`mnist/gan_train.py`, `countergan2.py`): `DeltaImageGenerator`, the
    unconditional `ConvDiscriminator` and all-ones masks, drawn from
    nothing (the step's target is usually `cfg.fixed_target`);
    `clf_params` is then a `LegacyCNNClassifier`'s.  Both get initial
    weights from a `torch.Generator` seeded with `seed`
    (`cfgan_torch.convert.load_gan_state` loads others over them), Adam
    at `cfg.lr_g` / `cfg.lr_d`, and the generator EMA starts at the
    initial parameters.  `clf_params` is the frozen classifier's state
    dict.  One-channel `image_hw` images of `num_classes` classes
    (MNIST's 28x28 and ten by default; the patch grid is `image_hw` cut
    into `cfg.mask.patch_size` squares).  `diagnostics=False` leaves the
    metrics at d_loss and g_loss, and the step without the extra
    classifier forward they take."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    g_model, clf_model = mnist_models(cfg, generator=gen,
                                      legacy_delta=legacy_delta,
                                      num_classes=num_classes,
                                      image_hw=image_hw)
    clf_model.load_state_dict(clf_params, strict=True)
    d_model = (ConvDiscriminator(cfg.hidden_dim, generator=gen)
               if legacy_delta else
               CondConvDiscriminator(num_classes, cfg.hidden_dim, image_hw,
                                     generator=gen))
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
        draws = {"targets": torch.randint(0, num_classes, shape,
                                          generator=generator,
                                          device=generator.device)}
        if legacy_delta:
            return draws
        scores = patch_mask_draws(shape, image_hw, m.patch_size,
                                  m.num_modifiable_patches, generator)
        if scores is not None:
            draws["mask"] = scores
        if m.ones_fraction:
            draws["ones"] = torch.rand(shape, generator=generator,
                                       device=generator.device)
        return draws

    def mask_fn(x, draws):
        if legacy_delta:  # the legacy family has no masks
            return torch.ones_like(x)
        mask = random_patch_mask(
            x.shape[0], image_hw, m.patch_size, m.num_modifiable_patches,
            channels=x.shape[-1], draws=draws.get("mask"), device=x.device)
        return with_ones_fraction(mask, m.ones_fraction,
                                  draws=draws.get("ones"))

    g_forward = make_mixed_precision(g_model, cfg.compute_dtype)
    step_fn, step_with_draws, step_from_draws = make_countergan_step(
        cfg=cfg, num_classes=num_classes, g_forward=g_forward,
        d_forward=make_mixed_precision(d_model, cfg.compute_dtype),
        clf_forward=clf_forward_fn(clf_model.to(device), cfg.compute_dtype),
        draw_fn=draw_fn, mask_fn=mask_fn, diagnostics=diagnostics)
    return CounterGANBundle(
        state, step_fn, step_with_draws, step_from_draws, draw_fn,
        make_epoch_runner(step_from_draws), make_cf_fn(g_model,
                                                       cfg.compute_dtype),
        make_bn_recalibrator(g_model, cfg, draw_fn, mask_fn),
        num_classes, cfg)


def _gumbel_draws(shape: tuple[int, ...], generator: torch.Generator
                  ) -> torch.Tensor:
    """Standard Gumbel draws of `shape` from `generator`, on its device:
    -log(-log(u)), u uniform with 0 moved to float32's tiny, as JAX's
    `gumbel` keeps u in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def _tabular_g_forward(g_model: TabularResidualGenerator,
                       cfg: CounterGANConfig, assembly: ResidualAssembly,
                       num_classes: int) -> Callable:
    """The tabular family's train-mode `g_forward(x, t, mask, noise) ->
    (raw, masked)` through `g_model`: soft Gumbel samples on `noise`, the
    residual assembled at the compute dtype (as the JAX package's wrapped
    `g_forward` assembles it), float32 outputs."""

    def assemble(out, x, t_oh, mask):
        cont, _, samples = out
        raw = assembly(x, cont, samples)
        return raw, raw * mask

    apply = make_mixed_precision(g_model, cfg.compute_dtype, post=assemble)

    def g_forward(x, t, mask, noise, update_stats: bool = True):
        return apply(x, one_hot(t, num_classes, x.dtype), mask,
                     noise=noise, hard=False, temperature=cfg.gumbel_tau,
                     update_stats=update_stats)

    return g_forward


def make_tabular_cf_fn(g_model: TabularResidualGenerator,
                       cfg: CounterGANConfig, schema: TabularSchema,
                       assembly: ResidualAssembly, num_classes: int
                       ) -> Callable:
    """`cf_fn(g_vars, x, target, mask, key, hard=True, row0=0) -> (x_cf,
    raw, masked)` (the tabular `cf_fn` of `build_tabular_countergan`):
    `g_vars` through an eval-mode copy of `g_model` at the compute dtype,
    hard Gumbel samples on the noise `derive_gumbel_noise(key, B, ...)`
    derives per row (so a row's counterfactual does not depend on the
    batch it is served in; x's rows are rows row0.. of the request), the
    residual assembled in float32, x_cf clamped to [0, 1] data space.
    `key` is a JAX key pair."""
    cd = torch_dtype(cfg.compute_dtype)
    noise_dtype = torch.float32 if cfg.cat_head_f32 else cd
    serve_g = copy.deepcopy(g_model).eval().requires_grad_(False)
    info = schema.categorical_info

    def cf_fn(g_vars, x, target, mask, key: Key, hard: bool = True,
              row0: int = 0):
        gv = {k: v.to(cd) if v.is_floating_point() else v
              for k, v in g_vars.items()}
        noise = derive_gumbel_noise(key, x.shape[0], info, noise_dtype,
                                    device=x.device, row0=row0)
        t_oh = one_hot(target, num_classes, cd)
        with torch.no_grad():
            cont, _, samples = functional_call(
                serve_g, gv, (x.to(cd), t_oh, mask.to(cd)),
                {"noise": noise, "hard": hard,
                 "temperature": cfg.gumbel_tau})
        raw = assembly(x, cont.float(),
                       {k: v.float() for k, v in samples.items()})
        masked = raw * mask
        return torch.clamp(x + masked, 0.0, 1.0), raw, masked

    return cf_fn


def build_tabular_countergan(cfg: CounterGANConfig,
                             clf_params: Mapping[str, torch.Tensor],
                             schema: TabularSchema, stats: NormStats,
                             num_classes: int = 4, seed: int = 42,
                             device: str | torch.device | None = None,
                             diagnostics: bool = True) -> CounterGANBundle:
    """The tabular CounteRGAN train step (`build_tabular_countergan`) on
    `device` (None: the CUDA card; raises where there is none).

    `TabularResidualGenerator` (width `cfg.hidden_dim`, `cfg.num_res_blocks`
    FiLM blocks, Gumbel heads at `cfg.gumbel_tau`) and the spectral-norm
    critic (widths h, 2h, 4h) get initial weights from a `torch.Generator`
    seeded with `seed`; Adam at `cfg.lr_g` / `cfg.lr_d`; the EMA starts at
    the initial parameters.  `clf_params` is the frozen
    `TabularClassifier`'s state dict.  Each step draws its targets, a
    per-feature Bernoulli(0.5) mask with the immutable features zeroed and
    the generator's Gumbel noise ("gumbel", (..., B, sum of the heads'
    sizes); under `cfg.g_microbatch` = K also "gumbel_chunks", (..., K,
    B/K, sum of sizes), the chunks'); recalibration's "ones" mode uses the
    immutable-complement mask.  The bundle carries `schema`."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    dim = schema.input_dim
    info = schema.categorical_info
    n_noise = sum(len(v) for v in info.values())
    assembly = ResidualAssembly(schema.continuous_idx,
                                build_cat_norm_values(info, stats))
    g_model = TabularResidualGenerator(
        dim, cfg.hidden_dim, num_classes, schema.continuous_idx, info,
        n_blocks=cfg.num_res_blocks, residual_scaling=cfg.residual_scaling,
        tau=cfg.gumbel_tau, cat_head_f32=cfg.cat_head_f32, remat=cfg.remat,
        generator=gen)
    h = cfg.hidden_dim
    d_model = SpectralMLPDiscriminator(dim + num_classes, (h, 2 * h, 4 * h),
                                       generator=gen)
    clf_model = TabularClassifier(num_classes, dim)
    clf_model.load_state_dict(clf_params, strict=True)
    g_model.to(device).train()
    d_model.to(device).train()
    state = GANState(
        g=NetState.create(g_model, cfg.lr_g),
        d=NetState.create(d_model, cfg.lr_d),
        g_ema=({name: p.detach().clone()
                for name, p in g_model.named_parameters()}
               if cfg.ema_decay else None))
    # the immutable-complement row, made here: the captured step may not
    # copy it from the host
    keep = immutable_complement_mask(1, dim, schema.immutable_idx,
                                     device=device)[0]

    def full_mask_fn(x):
        return keep.expand(x.shape[0], dim)

    k_micro = cfg.g_microbatch

    def draw_fn(generator: torch.Generator, shape: tuple[int, ...]) -> dict:
        draws = {"targets": torch.randint(0, num_classes, shape,
                                          generator=generator,
                                          device=generator.device),
                 "mask": feature_mask_draws(shape, dim, generator),
                 "gumbel": _gumbel_draws((*shape, n_noise), generator)}
        if k_micro >= 2 and shape[-1] % k_micro == 0:
            # each micro-batch chunk's own noise, as JAX draws it from
            # fold_in(k_g, chunk) and not from the D phase's (a batch K
            # does not divide gets none: the step raises on it)
            draws["gumbel_chunks"] = _gumbel_draws(
                (*shape[:-1], k_micro, shape[-1] // k_micro, n_noise),
                generator)
        if cfg.mask.ones_fraction:
            draws["ones"] = torch.rand(shape, generator=generator,
                                       device=generator.device)
        return draws

    def mask_fn(x, draws):
        mask = random_feature_mask(draws["mask"], keep=keep)
        if not cfg.mask.ones_fraction:
            return mask
        return with_ones_fraction(mask, cfg.mask.ones_fraction,
                                  draws=draws["ones"], full=full_mask_fn(x))

    def g_forward_of(module):
        return _tabular_g_forward(module, cfg, assembly, num_classes)

    d_apply = make_mixed_precision(d_model, cfg.compute_dtype)

    def d_forward(x, t, detach: bool = False, train: bool = True):
        return d_apply(x, one_hot(t, num_classes, x.dtype),
                       detach=detach, train=train)

    step_fn, step_with_draws, step_from_draws = make_countergan_step(
        cfg=cfg, num_classes=num_classes, g_forward=g_forward_of(g_model),
        d_forward=d_forward,
        clf_forward=clf_forward_fn(clf_model.to(device), cfg.compute_dtype),
        draw_fn=draw_fn, mask_fn=mask_fn, diagnostics=diagnostics)
    return CounterGANBundle(
        state, step_fn, step_with_draws, step_from_draws, draw_fn,
        make_epoch_runner(step_from_draws),
        make_tabular_cf_fn(g_model, cfg, schema, assembly, num_classes),
        make_bn_recalibrator(g_model, cfg, draw_fn, mask_fn,
                             g_forward_of=g_forward_of,
                             full_mask_fn=full_mask_fn),
        num_classes, cfg, schema=schema, stats=stats)


def make_moons_cf_fn(g_model: MoonsResidualGenerator, compute_dtype: str,
                     num_classes: int = MOONS_CLASSES) -> Callable:
    """`cf_fn(g_vars, x, target, mask, key=None) -> (x_cf, raw, masked)`
    (the `cf_fn` of `build_moons_countergan`): `g_vars` through an
    eval-mode copy of `g_model` at the compute dtype, the target one-hot at
    the compute dtype, float32 outputs and `x + masked` unclamped (the
    moons presets have `clamp_cf=None`).  `key` and `row0` are accepted
    for the families' common signature; the moons generator draws no
    noise."""
    cd = torch_dtype(compute_dtype)
    serve_g = copy.deepcopy(g_model).eval().requires_grad_(False)

    def cf_fn(g_vars, x, target, mask, key=None, row0=0):
        gv = {k: v.to(cd) if v.is_floating_point() else v
              for k, v in g_vars.items()}
        with torch.no_grad():
            raw, masked = functional_call(
                serve_g, gv, (x.to(cd), one_hot(target, num_classes, cd),
                              mask.to(cd)))
        raw, masked = raw.float(), masked.float()
        return x + masked, raw, masked

    return cf_fn


def _moons_g_forward(g_model: MoonsResidualGenerator,
                     cfg: CounterGANConfig, num_classes: int) -> Callable:
    """The moons family's train-mode `g_forward(x, t, mask) -> (raw,
    masked)` through `g_model`: the target one-hot, the forward at the
    compute dtype, float32 outputs."""
    apply = make_mixed_precision(g_model, cfg.compute_dtype)

    def g_forward(x, t, mask, update_stats: bool = True):
        return apply(x, one_hot(t, num_classes, x.dtype), mask,
                     update_stats=update_stats)

    return g_forward


def build_moons_countergan(cfg: CounterGANConfig,
                           clf_params: Mapping[str, torch.Tensor],
                           seed: int = 42,
                           device: str | torch.device | None = None,
                           diagnostics: bool = True,
                           num_classes: int = MOONS_CLASSES,
                           input_dim: int = MOONS_DIM) -> CounterGANBundle:
    """The moons CounteRGAN train step (`build_moons_countergan`) on
    `device` (None: the CUDA card; raises where there is none).

    `MoonsResidualGenerator` (width `cfg.hidden_dim`, BatchNorm on batch
    statistics in train mode) and the spectral-norm critic on concat[x,
    target one-hot] (widths h, h/2, h/2; its power iteration advances in
    the D phase only) get initial weights from a `torch.Generator` seeded
    with `seed`; Adam at `cfg.lr_g` / `cfg.lr_d`; the EMA, where
    `cfg.ema_decay` asks for one, starts at the initial parameters.
    `clf_params` is the frozen `MLPClassifier`'s state dict (its width
    follows it).  Each step draws its targets and a per-feature
    Bernoulli(0.5) mask with `cfg.mask.immutable_idx` zeroed (and, with
    `cfg.mask.ones_fraction`, the draws that swap in the fully modifiable
    mask, the immutable complement, which recalibration's "ones" mode
    uses too).  `input_dim`-D points of `num_classes` classes (2 and 3 by
    default); x_cf is clamped only where `cfg.clamp_cf` says."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    g_model, clf_model = moons_models(
        cfg, clf_params["Linear_0.weight"].shape[0], generator=gen,
        num_classes=num_classes, input_dim=input_dim)
    clf_model.load_state_dict(clf_params, strict=True)
    h = cfg.hidden_dim
    d_model = SpectralMLPDiscriminator(input_dim + num_classes,
                                       (h, h // 2, h // 2), generator=gen)
    g_model.to(device).train()
    d_model.to(device).train()
    state = GANState(
        g=NetState.create(g_model, cfg.lr_g),
        d=NetState.create(d_model, cfg.lr_d),
        g_ema=({name: p.detach().clone()
                for name, p in g_model.named_parameters()}
               if cfg.ema_decay else None))
    m = cfg.mask
    # the immutable-complement row, made here: the captured step may not
    # copy it from the host
    keep = immutable_complement_mask(1, input_dim, m.immutable_idx,
                                     device=device)[0]

    def full_mask_fn(x):
        return keep.expand(x.shape[0], input_dim)

    def draw_fn(generator: torch.Generator, shape: tuple[int, ...]) -> dict:
        draws = {"targets": torch.randint(0, num_classes, shape,
                                          generator=generator,
                                          device=generator.device),
                 "mask": feature_mask_draws(shape, input_dim, generator)}
        if m.ones_fraction:
            draws["ones"] = torch.rand(shape, generator=generator,
                                       device=generator.device)
        return draws

    def mask_fn(x, draws):
        mask = random_feature_mask(draws["mask"], keep=keep)
        if not m.ones_fraction:
            return mask
        return with_ones_fraction(mask, m.ones_fraction,
                                  draws=draws["ones"], full=full_mask_fn(x))

    def g_forward_of(module):
        return _moons_g_forward(module, cfg, num_classes)

    d_apply = make_mixed_precision(d_model, cfg.compute_dtype)

    def d_forward(x, t, detach: bool = False, train: bool = True):
        return d_apply(x, one_hot(t, num_classes, x.dtype),
                       detach=detach, train=train)

    step_fn, step_with_draws, step_from_draws = make_countergan_step(
        cfg=cfg, num_classes=num_classes, g_forward=g_forward_of(g_model),
        d_forward=d_forward,
        clf_forward=clf_forward_fn(clf_model.to(device), cfg.compute_dtype),
        draw_fn=draw_fn, mask_fn=mask_fn, diagnostics=diagnostics)
    return CounterGANBundle(
        state, step_fn, step_with_draws, step_from_draws, draw_fn,
        make_epoch_runner(step_from_draws),
        make_moons_cf_fn(g_model, cfg.compute_dtype, num_classes),
        make_bn_recalibrator(g_model, cfg, draw_fn, mask_fn,
                             g_forward_of=g_forward_of,
                             full_mask_fn=full_mask_fn),
        num_classes, cfg)
