"""The five plain-generation families wired into train steps (mirrors
`cfgan/train/gan_builders.py`: `build_gan`, `GANBundle`).

`build_gan(cfg)` builds the family `cfg.family` names, with the JAX
package's widths and optimizers: Adam at `cfg.lr_g` / `cfg.lr_d` and
`(cfg.beta1, cfg.beta2)`, AdamW with weight decay 0.01 for WGAN-GP; the
forwards and backwards at `cfg.compute_dtype` through
`make_mixed_precision` (parameters, optimizer state, the gradient
penalty's norm and the losses stay float32).

Families (generator / discriminator):

- simple_mlp: MLPGenerator(2, hidden) / MLPDiscriminator((hidden,));
- mlp_image: MLPImageGenerator / MLPDiscriminator((512, 256), slope 0.2,
  flattened);
- cgan_mlp (conditional): ConditionalMLPGenerator /
  ConditionalMLPDiscriminator;
- dcgan: DCGANGenerator(hidden) / DCGANDiscriminator(hidden), real and
  fake in separate passes;
- wgan_gp (conditional): WGANGenerator(hidden) / WGANCritic(hidden,
  hidden), the Wasserstein loss with the gradient penalty.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn
from torch.func import functional_call

from cfgan_torch.core.config import GANConfig
from cfgan_torch.core.device import deterministic_cudnn, resolve_device
from cfgan_torch.models.discriminators import (
    ConditionalMLPDiscriminator,
    DCGANDiscriminator,
    MLPDiscriminator,
    WGANCritic,
)
from cfgan_torch.models.generators import (
    ConditionalMLPGenerator,
    DCGANGenerator,
    MLPGenerator,
    MLPImageGenerator,
    WGANGenerator,
)
from cfgan_torch.train.builders import make_mixed_precision
from cfgan_torch.train.loop import make_epoch_runner
from cfgan_torch.train.gan import make_gan_step
from cfgan_torch.train.state import GANState, NetState

@dataclass
class GANBundle:
    """What `build_gan` returns.

    - `step_fn(state, x, y, generator)`, `step_with_draws(state, x, y, z,
      t=None, gp_eps=None, z2=None)` and `step_from_draws(state, x, y,
      draws)` update `state` in place and return the step's metrics as
      device tensors (`cfgan_torch.train.gan.make_gan_step`);
    - `draw_fn(generator, shape)` draws the random numbers of a batch
      (`shape = (B,)`) or an epoch (`(steps, B)`);
    - `epoch_fn(state, data_x, data_y, perm, draws)` runs an epoch
      (`cfgan_torch.train.countergan.EpochRunner`: replayed CUDA graphs on
      the card, one for each kind of step that `schedule` names);
    - `sample_fn(g_vars, z, cond_onehot=None) -> samples`: generator
      variables (a state dict) through an eval-mode copy of the generator
      in float32, as the JAX `sample_fn` runs it.
    `num_classes` is 0 for an unconditional family."""

    g_model: nn.Module
    d_model: nn.Module
    state: GANState
    step_fn: Callable
    step_with_draws: Callable
    step_from_draws: Callable
    draw_fn: Callable
    epoch_fn: Callable
    sample_fn: Callable
    schedule: Callable | None
    latent_dim: int
    num_classes: int
    cfg: GANConfig


def gan_models(cfg: GANConfig, num_classes: int = 0,
               generator: torch.Generator | None = None):
    """(generator, discriminator, conditional, loss, separate_d_passes) of
    `cfg.family`, with initial weights from `generator`."""
    ld, h, gen = cfg.latent_dim, cfg.hidden_dim, generator
    if cfg.family == "simple_mlp":
        return (MLPGenerator(ld, 2, h, generator=gen),
                MLPDiscriminator(2, (h,), generator=gen),
                False, "nonsaturating", False)
    if cfg.family == "mlp_image":
        return (MLPImageGenerator(ld, generator=gen),
                MLPDiscriminator(28 * 28, (512, 256), negative_slope=0.2,
                                 flatten=True, generator=gen),
                False, "nonsaturating", False)
    if cfg.family == "cgan_mlp":
        return (ConditionalMLPGenerator(ld, num_classes, 2, h, generator=gen),
                ConditionalMLPDiscriminator(2, num_classes, h, generator=gen),
                True, "nonsaturating", False)
    if cfg.family == "dcgan":
        return (DCGANGenerator(ld, h, generator=gen),
                DCGANDiscriminator(h, generator=gen),
                False, "nonsaturating", True)
    if cfg.family == "wgan_gp":
        return (WGANGenerator(ld, h, num_classes, generator=gen),
                WGANCritic(h, h, num_classes, generator=gen),
                True, "wgan_gp", False)
    raise ValueError(f"unknown GAN family {cfg.family!r}")


def make_sample_fn(g_model: nn.Module, conditional: bool) -> Callable:
    """`sample_fn(g_vars, z, cond_onehot=None)`: `g_vars` through an
    eval-mode float32 copy of `g_model`, without gradients, under cuDNN's
    deterministic algorithms: the same variables and noise give the same
    samples in every call, so a restored generator samples what its run
    did."""
    serve_g = copy.deepcopy(g_model).float().eval().requires_grad_(False)

    def sample_fn(g_vars, z, cond_onehot=None):
        args = (z, cond_onehot) if conditional else (z,)
        with torch.no_grad(), deterministic_cudnn():
            return functional_call(serve_g, dict(g_vars), args)

    return sample_fn


def build_gan(cfg: GANConfig, *, num_classes: int = 0, seed: int = 42,
              device: str | torch.device | None = None) -> GANBundle:
    """The family `cfg.family` (`build_gan`) on `device` (None: the CUDA
    card; raises where there is none), initial weights from a
    `torch.Generator` seeded with `seed` (`cfgan_torch.convert.
    load_gan_state` loads others over them).  `num_classes` is the data's;
    the unconditional families ignore it."""
    device = resolve_device(device)
    g_model, d_model, conditional, loss, separate = gan_models(
        cfg, num_classes, torch.Generator().manual_seed(seed))
    g_model.to(device).train()
    d_model.to(device).train()
    # the reference's optimizers: Adam, and AdamW (torch's default weight
    # decay 0.01) for WGAN-GP
    wd = 0.01 if cfg.family == "wgan_gp" else 0.0
    betas = (cfg.beta1, cfg.beta2)
    state = GANState(g=NetState.create(g_model, cfg.lr_g, wd, betas),
                     d=NetState.create(d_model, cfg.lr_d, wd, betas))
    g_apply = make_mixed_precision(g_model, cfg.compute_dtype)
    d_apply = make_mixed_precision(d_model, cfg.compute_dtype)

    def g_forward(z, cond):
        return g_apply(z) if cond is None else g_apply(z, cond)

    def d_forward(x, cond, update_stats: bool = True, detach: bool = False):
        args = (x,) if cond is None else (x, cond)
        return d_apply(*args, update_stats=update_stats, detach=detach)

    n_cond = num_classes if conditional else 0
    step_fn, step_with_draws, step_from_draws, draw_fn, schedule = (
        make_gan_step(g_forward=g_forward, d_forward=d_forward,
                      latent_dim=cfg.latent_dim, num_classes=n_cond,
                      loss=loss, g_before_d=cfg.g_before_d,
                      n_critic=cfg.n_critic, gp_lambda=cfg.gp_lambda,
                      separate_d_passes=separate))
    return GANBundle(
        g_model, d_model, state, step_fn, step_with_draws, step_from_draws,
        draw_fn, make_epoch_runner(step_from_draws, schedule=schedule),
        make_sample_fn(g_model, conditional), schedule, cfg.latent_dim,
        n_cond, cfg)
