"""The CounteRGAN alternating train step (mirrors
`cfgan/train/countergan.py`: `sample_targets`, `make_countergan_step`).

Per batch:

1. targets and a random modifiable mask (drawn from a `torch.Generator`,
   or given: the parity tests hand in JAX's draws);
2. ONE generator forward in train mode (BatchNorm statistics update once)
   and ONE epilogue on its raw residual, giving the counterfactual and the
   proximity and penalty sums; their graph is kept for the generator
   update;
3. the discriminator update on (x, y) and the detached (x_cf, t) batched
   into one pass;
4. the generator loss through the UPDATED discriminator, whose parameters
   get no gradient from it, the frozen classifier, and the epilogue's
   sums;
5. the generator update, then the EMA.

The epilogue (`cfgan_torch.ops.epilogue.cf_epilogue`) runs once per step
and its backward once: on the card these are the hand-written kernels.
The JAX step computes the epilogue twice, before the D update and again
for the G loss; the D update changes none of its inputs, so the values
are the same.
The step returns its metrics as device tensors and reads nothing back to
the host.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from cfgan_torch.core.config import CounterGANConfig
from cfgan_torch.losses import countergan as cg_losses
from cfgan_torch.losses import gan as gan_losses
from cfgan_torch.ops.epilogue import cf_epilogue, epilogue_terms
from cfgan_torch.train.state import GANState

ADV_LOSSES = ("wasserstein", "bce", "clipped_log")


def sample_targets(y: torch.Tensor, num_classes: int, resample: bool,
                   draws: torch.Tensor | None = None,
                   generator: torch.Generator | None = None
                   ) -> torch.Tensor:
    """Random target class per sample; with `resample`, a target equal to
    the label moves on to the next class.  `draws` are the uniform integer
    draws in [0, num_classes); without them they come from `generator`."""
    if draws is None:
        draws = torch.randint(0, num_classes, y.shape, generator=generator,
                              device=y.device)
    t = draws.to(device=y.device, dtype=torch.long)
    if resample:
        t = torch.where(t == y, (t + 1) % num_classes, t)
    return t


def make_countergan_step(*, cfg: CounterGANConfig, num_classes: int,
                         g_forward: Callable, d_forward: Callable,
                         clf_forward: Callable, mask_sampler: Callable,
                         diagnostics: bool = True):
    """Returns (step, step_with_draws).

    - `step(state, x, y, generator) -> metrics` draws the targets and the
      mask from `generator` (on x's device), then runs `step_with_draws`;
    - `step_with_draws(state, x, y, t, mask) -> metrics` takes them.

    Both update `state` in place.  `g_forward(x, t, mask) -> (raw,
    masked)`, `d_forward(x, t, detach=False) -> scores` (`detach=True`
    stops the gradient at D's parameters) and `clf_forward(x) -> logits`
    return float32; `mask_sampler(x, generator) -> mask`.
    """
    if cfg.adv_loss not in ADV_LOSSES:
        raise ValueError(f"unknown adv_loss {cfg.adv_loss!r}")
    lo, hi = cfg.clamp_cf if cfg.clamp_cf is not None else (-1e30, 1e30)
    use_bce = cfg.adv_loss == "bce"
    clipped = cfg.adv_loss == "clipped_log"

    def d_loss_of(real, fake):
        if use_bce:
            return gan_losses.d_loss_bce(real, fake)
        if clipped:
            return gan_losses.d_loss_nonsaturating(
                torch.sigmoid(real), torch.sigmoid(fake), eps=1e-6)
        return gan_losses.d_loss_wasserstein(real, fake)

    def g_adv_of(scores):
        if use_bce:
            return gan_losses.g_loss_bce(scores)
        if clipped:
            return gan_losses.g_loss_nonsaturating(torch.sigmoid(scores),
                                                   eps=1e-6)
        return gan_losses.g_loss_wasserstein(scores)

    def step_with_draws(state: GANState, x, y, t, mask) -> dict:
        g, d = state.g, state.d
        n_features = x[0].numel()

        # ---- generator forward and the epilogue, kept for the G update;
        # the D update below touches neither ----
        raw, masked = g_forward(x, t, mask)
        cf, l1s, l2s, pens = cf_epilogue(x, raw, mask, lo, hi)

        # ---- discriminator update, real and fake in one pass ----
        scores = d_forward(torch.cat([x, cf.detach()]), torch.cat([y, t]))
        d_real, d_fake = scores.chunk(2)
        d_loss = d_loss_of(d_real, d_fake)
        d.opt.zero_grad(set_to_none=True)
        d_loss.backward()
        d.opt.step()

        # ---- generator update through the updated discriminator ----
        adv = g_adv_of(d_forward(cf, t, detach=True))
        cf_logits = clf_forward(cf)
        cls = cg_losses.classifier_ce(cf_logits, t)
        l1, l2, pen = epilogue_terms(l1s, l2s, pens, n_features,
                                     cfg.reg_reduction)
        if not cfg.lambda_reg_l2:
            l2 = torch.zeros((), device=x.device)
        total = (cfg.lambda_adv * adv + cfg.lambda_cls * cls
                 + cfg.lambda_reg_l1 * l1 + cfg.lambda_reg_l2 * l2
                 + cfg.lambda_mask * pen)
        if cfg.lambda_range:
            # keep the un-clamped counterfactual inside the clamp bounds
            un = x + raw * mask
            zero = un.new_zeros(())
            total = total + cfg.lambda_range * torch.mean(
                torch.maximum(un - hi, zero) + torch.maximum(lo - un, zero))
        g.opt.zero_grad(set_to_none=True)
        total.backward()
        g.opt.step()

        if state.g_ema is not None:
            dec = cfg.ema_decay
            with torch.no_grad():
                params = dict(g.model.named_parameters())
                ema = list(state.g_ema.values())
                live = [params[name] for name in state.g_ema]
                torch._foreach_mul_(ema, dec)
                torch._foreach_add_(ema, torch._foreach_mul(live, 1.0 - dec))
        state.step += 1

        metrics = {"d_loss": d_loss.detach(), "g_loss": total.detach()}
        if diagnostics:
            with torch.no_grad():
                probs_cf = F.softmax(cf_logits, dim=1)
                probs_x = F.softmax(clf_forward(x), dim=1)
                col = t[:, None]
                metrics.update(
                    g_adv=adv.detach(), g_cls=cls.detach(),
                    reg_l1=l1.detach(), reg_l2=l2.detach(),
                    mask_penalty=pen.detach(),
                    d_real_p=torch.sigmoid(d_real).mean(),
                    d_fake_p=torch.sigmoid(d_fake).mean(),
                    residual_mean=masked.abs().mean(),
                    flip_rate=(cf_logits.argmax(1) == t).float().mean(),
                    pred_gain=(probs_cf.gather(1, col)
                               - probs_x.gather(1, col)).mean())
        return metrics

    def step(state: GANState, x, y, generator: torch.Generator) -> dict:
        if cfg.fixed_target is not None:
            t = torch.full_like(y, cfg.fixed_target)
        else:
            t = sample_targets(y, num_classes, cfg.resample_target,
                               generator=generator)
        return step_with_draws(state, x, y, t, mask_sampler(x, generator))

    return step, step_with_draws
