"""The plain-generation GAN train step (mirrors `cfgan/train/gan.py`:
`make_gan_step`) for the simple, conditional, DCGAN and WGAN-GP families.

Each step keeps the JAX step's data flows:

* non-saturating families: ONE generator forward a batch in train mode
  (BatchNorm statistics advance once); the discriminator trains on its
  detached output, then the generator trains through the UPDATED
  discriminator on that same forward's graph.  The discriminator's
  parameters get no gradient from the G phase (the JAX step
  differentiates it with respect to the fake alone);
* `g_before_d` (the simple MNIST GAN): the generator first, through the
  discriminator as it was, then the discriminator on the same fake;
* `separate_d_passes` (DCGAN's BatchNorm discriminator): a real pass, then
  a fake pass, the running statistics chained in that order; the G phase
  scores the fake with batch statistics and leaves the running statistics
  alone, as the JAX step drops that update.  Other families score real
  and fake in one concatenated pass;
* WGAN-GP: the critic's fakes come from a fresh `z` conditioned on the
  REAL labels, without a gradient; the gradient penalty interpolates are
  conditioned on the real labels too.  The G phase runs when the global
  step is a multiple of `n_critic` (so does any family's but
  `g_before_d`'s), with its own train-mode forward from
  `z2` and the random labels `t` (so G's BatchNorm statistics advance
  twice on those steps and once on the others); `g_loss` is 0 on the
  others.

`d_loss_nonsaturating` sums its two terms, as the JAX step's does.  The
step's random numbers are injected (`draw_fn` draws them; the parity
tests hand in JAX's): `z` (B, latent), `t` (B,) fake labels over the full
class range (conditional families), `gp_eps` (B,) interpolation weights
and `z2` (B, latent) (WGAN-GP).  The step returns its metrics as device
tensors and reads nothing back to the host: the WGAN-GP branch is decided
by the host's step count, so the epoch runner captures one graph for each
kind of step (`schedule`).

A state replicated on a mesh (`cfgan_torch.parallel.replicate`) trains
data-parallel: the step takes the global batch and draws, trains on this
rank's rows with the BatchNorms synchronised, averages each update's
gradients over the ranks and returns the metrics' means over them; a
generator channel-sharded over a mesh axis (`cfgan_torch.parallel.
shard_leaves`) steps its slices and gathers its working copies in the
steps that update it, and WGAN-GP's critic-only steps issue none of its
collectives.
"""
from __future__ import annotations

from typing import Callable, Mapping

import torch

from cfgan_torch.losses import gan as losses
from cfgan_torch.nn.layers import one_hot
from cfgan_torch.parallel.sharding import (
    mean_metrics,
    optimizer_step,
    shard_rows,
)
from cfgan_torch.train.state import GANState

LOSSES = ("nonsaturating", "wgan_gp")


def make_gan_step(*, g_forward: Callable, d_forward: Callable,
                  latent_dim: int, num_classes: int = 0,
                  loss: str = "nonsaturating", g_before_d: bool = False,
                  n_critic: int = 1, gp_lambda: float = 10.0,
                  separate_d_passes: bool = False):
    """Returns (step, step_with_draws, step_from_draws, draw_fn, schedule).

    - `step(state, x, y, generator) -> metrics` draws the step's random
      numbers from `generator`, then runs `step_from_draws`;
    - `step_from_draws(state, x, y, draws) -> metrics` takes them as a
      dict of tensors (`draw_fn`'s);
    - `step_with_draws(state, x, y, z, t=None, gp_eps=None, z2=None)`
      takes them one by one (`t` for conditional families, `gp_eps` and
      `z2` for WGAN-GP);
    - `draw_fn(generator, shape) -> draws` draws for a batch of `shape`
      (`(B,)`, or `(steps, B)` for an epoch) on the generator's device;
    - `schedule(step) -> bool`, with `n_critic` > 1, whether global step
      `step` updates the generator (None otherwise: every step is alike).
      As in the JAX step, `g_before_d` ignores `n_critic`.

    The steps update `state` in place (both networks' parameters,
    BatchNorm statistics and optimizers, `state.step`) and return
    {"d_loss", "g_loss", "d_real", "d_fake"}, the last two the means of
    the discriminator's outputs on real and fake.  `y` is ignored by the
    unconditional families.  `g_forward(z, cond) -> fake` and
    `d_forward(x, cond, update_stats=True, detach=False) -> out` return
    float32 (`cond` None for an unconditional family; `detach=True` stops
    the gradient at D's parameters; `update_stats=False` leaves D's
    running statistics as they are)."""
    if loss not in LOSSES:
        raise ValueError(f"unknown GAN loss {loss!r}")
    conditional = num_classes > 0
    wgan = loss == "wgan_gp"
    n_labels = max(num_classes, 1)

    def d_phase(x, y_oh, fake_sg, fake_cond):
        """The discriminator's loss on real and detached fake, and its
        outputs on each."""
        if separate_d_passes:
            real_out = d_forward(x, y_oh)
            fake_out = d_forward(fake_sg, fake_cond)
        else:
            out = d_forward(torch.cat([x, fake_sg]),
                            None if y_oh is None else
                            torch.cat([y_oh, fake_cond]))
            real_out, fake_out = out.chunk(2)
        if wgan:
            dl = losses.d_loss_wasserstein(real_out, fake_out)
            return dl, real_out, fake_out
        return (losses.d_loss_nonsaturating(real_out, fake_out), real_out,
                fake_out)

    def update(ns, loss_value, mesh):
        ns.opt.zero_grad(set_to_none=True)
        loss_value.backward()
        optimizer_step(mesh, ns)

    def g_phase(state: GANState, fake, t_oh):
        """The non-saturating generator update through the discriminator
        as it stands, on the graph of `fake`."""
        out = d_forward(fake, t_oh, update_stats=False, detach=True)
        gl = losses.g_loss_nonsaturating(out)
        update(state.g, gl, state.mesh)
        return gl

    def step_with_draws(state: GANState, x, y, z, t=None, gp_eps=None,
                        z2=None) -> dict:
        mesh = state.mesh
        if mesh is not None:  # this rank's rows of the global batch
            x, y, z, t, gp_eps, z2 = (
                None if a is None else shard_rows(mesh, a)
                for a in (x, y, z, t, gp_eps, z2))
        g_turn = state.step % n_critic == 0
        if conditional:
            t_oh = one_hot(t, num_classes, x.dtype)
            y_oh = one_hot(y, num_classes, x.dtype)
        else:
            t_oh = y_oh = None
        if wgan:
            with torch.no_grad():
                fake_sg = g_forward(z, y_oh)
            fake_cond = y_oh
        else:
            fake = g_forward(z, t_oh)
            fake_sg = fake.detach()
            fake_cond = t_oh

        if g_before_d:
            g_loss = g_phase(state, fake, t_oh)
        d_loss, real_out, fake_out = d_phase(x, y_oh, fake_sg, fake_cond)
        if wgan:
            gp = losses.gradient_penalty(
                lambda xh: d_forward(xh, fake_cond, update_stats=False),
                x, fake_sg, gp_eps)
            d_loss = d_loss + gp_lambda * gp
        update(state.d, d_loss, mesh)

        if not g_before_d:
            if not g_turn:
                g_loss = torch.zeros((), device=x.device)
            elif wgan:
                fake2 = g_forward(z2, t_oh)
                g_loss = losses.g_loss_wasserstein(
                    d_forward(fake2, t_oh, update_stats=False, detach=True))
                update(state.g, g_loss, mesh)
            else:
                g_loss = g_phase(state, fake, t_oh)
        state.step += 1
        return mean_metrics(mesh, {
            "d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
            "d_real": real_out.detach().mean(),
            "d_fake": fake_out.detach().mean()})

    def draw_fn(generator: torch.Generator, shape: tuple[int, ...]) -> dict:
        dev = generator.device
        draws = {"z": torch.randn((*shape, latent_dim), generator=generator,
                                  device=dev)}
        if conditional:
            draws["t"] = torch.randint(0, n_labels, shape,
                                       generator=generator, device=dev)
        if wgan:
            draws["gp_eps"] = torch.rand(shape, generator=generator,
                                         device=dev)
            draws["z2"] = torch.randn((*shape, latent_dim),
                                      generator=generator, device=dev)
        return draws

    def step_from_draws(state: GANState, x, y,
                        draws: Mapping[str, torch.Tensor]) -> dict:
        return step_with_draws(state, x, y, draws["z"], draws.get("t"),
                               draws.get("gp_eps"), draws.get("z2"))

    def step(state: GANState, x, y, generator: torch.Generator) -> dict:
        draws = {k: v.to(x.device)
                 for k, v in draw_fn(generator, tuple(y.shape)).items()}
        return step_from_draws(state, x, y, draws)

    def schedule(step_index: int) -> bool:
        return step_index % n_critic == 0

    return (step, step_with_draws, step_from_draws, draw_fn,
            schedule if n_critic > 1 and not g_before_d else None)
