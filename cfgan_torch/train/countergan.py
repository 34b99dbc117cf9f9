"""The CounteRGAN alternating train step (mirrors
`cfgan/train/countergan.py`: `sample_targets`, `make_countergan_step`;
its `make_epoch_runner` is `cfgan_torch.train.loop.make_epoch_runner`).

Per batch:

1. targets, a random modifiable mask and, for the tabular generator, its
   Gumbel noise (drawn from a `torch.Generator`, or given: the parity
   tests hand in JAX's draws);
2. ONE generator forward in train mode (BatchNorm statistics update once)
   and ONE epilogue on its raw residual, giving the counterfactual and the
   proximity and penalty sums; their graph is kept for the generator
   update;
3. the discriminator update on (x, y) and the detached (x_cf, t) batched
   into one pass, D in train mode (a spectral-norm D advances its power
   iteration here, once a step);
4. the generator loss through the UPDATED discriminator in eval mode,
   whose parameters get no gradient from it, the frozen classifier, and
   the epilogue's sums;
5. the generator update, then the EMA.

The epilogue (`cfgan_torch.ops.epilogue.cf_epilogue`) runs once per step
and its backward once: on the card these are the hand-written kernels.
The JAX step computes the epilogue twice, before the D update and again
for the G loss; the D update changes none of its inputs, so the values
are the same.
The step returns its metrics as device tensors and reads nothing back to
the host.

The JAX package's two memory options (`CounterGANConfig.remat`,
`g_microbatch`): `remat` lives in the generator, which the builders make
with it (`cfgan_torch.models.generators`: each residual block is run
again in the backward, without a second update of the BatchNorm
statistics); `g_microbatch` = K >= 2 gives the D phase its own forward
and epilogue without a graph, then runs the generator update in K
chunks, each with its forward, its epilogue and its backward: K + 1
epilogue forwards and K backwards a step.

A state replicated on a mesh (`cfgan_torch.parallel.replicate`) trains
data-parallel, as the JAX step does under a sharded batch: the step takes
the global batch and its draws (the same on every rank), trains on this
rank's rows (`shard_rows`; under `g_microbatch` = K, its share of each
global chunk), with the BatchNorms synchronised, averages the gradients
over the ranks before each optimizer step and returns the metrics'
means over the ranks.  The replicas stay equal bit for bit.  On a
("data", "model") mesh the rows are still split over the whole world
(rank (d, m) trains on block d * M + m), and a generator channel-sharded
over "model" (`cfgan_torch.parallel.shard_leaves`) takes its gradients'
slices, steps them and gathers its working copies
(`cfgan_torch.parallel.sharding.optimizer_step`), under `g_microbatch`
once, after the chunks' gradients are summed and divided by K; the EMA
then follows the gathered parameters.
"""
from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.nn.functional as F

from cfgan_torch.core.config import CounterGANConfig
from cfgan_torch.losses import countergan as cg_losses
from cfgan_torch.losses import gan as gan_losses
from cfgan_torch.ops.epilogue import cf_epilogue, epilogue_terms
from cfgan_torch.parallel.sharding import (
    mean_metrics,
    optimizer_step,
    shard_rows,
)
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
        if generator is None:
            raise ValueError("pass the target draws or a torch.Generator")
        draws = torch.randint(0, num_classes, y.shape, generator=generator,
                              device=y.device)
    t = draws.to(device=y.device, dtype=torch.long)
    if resample:
        t = torch.where(t == y, (t + 1) % num_classes, t)
    return t


def make_countergan_step(*, cfg: CounterGANConfig, num_classes: int,
                         g_forward: Callable, d_forward: Callable,
                         clf_forward: Callable, draw_fn: Callable,
                         mask_fn: Callable, diagnostics: bool = True):
    """Returns (step, step_with_draws, step_from_draws).

    - `step(state, x, y, generator) -> metrics` draws the step's random
      numbers from `generator`, then runs `step_from_draws`;
    - `step_from_draws(state, x, y, draws) -> metrics` takes them as a
      dict of tensors (`draw_fn`'s: "targets", the uniform integer draws
      of the targets, the mask's, and for the tabular family "gumbel",
      the generator's noise, and under `g_microbatch` "gumbel_chunks",
      each chunk's), makes the targets and the mask, and runs
      `step_with_draws`;
    - `step_with_draws(state, x, y, t, mask, noise=None, chunk_noise=None)
      -> metrics` takes the targets, the mask and the generator's noise
      (None for a generator that draws none); under `g_microbatch` = K a
      noisy generator's chunks take `chunk_noise[i]`, i < K.

    All update `state` in place.  `g_forward(x, t, mask[, noise],
    update_stats=True) -> (raw, masked)` (called with `noise` only where
    there is some; `update_stats=False` leaves the BatchNorm statistics
    alone), `d_forward(x, t, detach=False, train=True) -> scores`
    (`detach=True` stops the gradient at D's parameters; `train=False`
    leaves D's state as it is) and `clf_forward(x) -> logits` return
    float32; `draw_fn(generator, shape) -> draws` draws for a batch of
    `shape` (`(B,)`, or `(steps, B)` for an epoch) on the generator's
    device; `mask_fn(x, draws) -> mask`.

    `cfg.g_microbatch` = K >= 2 mirrors the JAX package's micro-batched
    generator update: the D phase takes a full-batch generator forward
    and epilogue without a graph (the BatchNorm statistics update once,
    from the full batch); then each of the K equal chunks takes its own
    generator forward (`update_stats=False`), epilogue, discriminator
    (updated, eval mode) and classifier, and its backward; the gradients
    are summed over the chunks and divided by K, the loss terms are the
    means of the chunks', and the flip rate reads the chunks' logits.  K
    must divide the batch (ValueError, raised on the host before the
    generator forward, so before any capture).
    """
    if cfg.adv_loss not in ADV_LOSSES:
        raise ValueError(f"unknown adv_loss {cfg.adv_loss!r}")
    lo, hi = cfg.clamp_cf if cfg.clamp_cf is not None else (-1e30, 1e30)
    use_bce = cfg.adv_loss == "bce"
    clipped = cfg.adv_loss == "clipped_log"
    k_micro = cfg.g_microbatch
    micro = k_micro >= 2

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

    def g_terms(cf, sums, raw, x, t, mask):
        """The generator loss of a batch through the updated
        discriminator: (total, (adv, cls, l1, l2, pen), cf_logits)."""
        adv = g_adv_of(d_forward(cf, t, detach=True, train=False))
        cf_logits = clf_forward(cf)
        cls = cg_losses.classifier_ce(cf_logits, t)
        l1, l2, pen = epilogue_terms(*sums, x[0].numel(), cfg.reg_reduction)
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
        return total, (adv, cls, l1, l2, pen), cf_logits

    def micro_g_backward(g_params, x, t, mask, chunk_noise):
        """The chunks' forwards and backwards; the summed gradients
        divided by K.  Returns (total, terms, cf_logits) as the chunks'
        means and their logits concatenated."""
        mbs = x.shape[0] // k_micro
        totals, terms, logits = [], [], []
        for i in range(k_micro):
            rows = slice(i * mbs, (i + 1) * mbs)
            xb, tb, mb = x[rows], t[rows], mask[rows]
            noise = () if chunk_noise is None else (chunk_noise[i],)
            rawb, _ = g_forward(xb, tb, mb, *noise, update_stats=False)
            cfb, *sums = cf_epilogue(xb, rawb, mb, lo, hi)
            total, tb_terms, tb_logits = g_terms(cfb, sums, rawb, xb, tb, mb)
            total.backward()
            totals.append(total.detach())
            terms.append(torch.stack([v.detach() for v in tb_terms]))
            logits.append(tb_logits.detach())
        torch._foreach_div_([p.grad for p in g_params if p.grad is not None],
                            float(k_micro))
        return (torch.stack(totals).mean(), torch.stack(terms).mean(0),
                torch.cat(logits))

    def step_with_draws(state: GANState, x, y, t, mask, noise=None,
                        chunk_noise=None) -> dict:
        mesh = state.mesh
        if mesh is not None:  # this rank's rows of the global batch
            x, y, t, mask = (shard_rows(mesh, a, k_micro if micro else 1)
                             for a in (x, y, t, mask))
            if noise is not None:
                noise = shard_rows(mesh, noise, k_micro if micro else 1)
            if chunk_noise is not None:
                chunk_noise = shard_rows(mesh, chunk_noise, dim=1)
        if micro and x.shape[0] % k_micro:
            raise ValueError(f"g_microbatch={k_micro} must divide the batch "
                             f"size {x.shape[0]}")
        if micro and noise is not None and chunk_noise is None:
            raise ValueError("a micro-batched step of a generator that "
                             "draws noise needs each chunk's noise")
        g, d = state.g, state.d
        extra = () if noise is None else (noise,)

        # ---- generator forward and the epilogue; in the one-forward step
        # their graph is kept for the G update, which the D update below
        # does not touch ----
        if micro:
            with torch.no_grad():
                raw, masked = g_forward(x, t, mask, *extra)
                cf = cf_epilogue(x, raw, mask, lo, hi)[0]
        else:
            raw, masked = g_forward(x, t, mask, *extra)
            cf, *sums = cf_epilogue(x, raw, mask, lo, hi)

        # ---- discriminator update, real and fake in one pass ----
        scores = d_forward(torch.cat([x, cf.detach()]), torch.cat([y, t]),
                           train=True)
        d_real, d_fake = scores.chunk(2)
        d_loss = d_loss_of(d_real, d_fake)
        d.opt.zero_grad(set_to_none=True)
        d_loss.backward()
        optimizer_step(mesh, d)

        # ---- generator update through the updated discriminator ----
        g.opt.zero_grad(set_to_none=True)
        if micro:
            total, terms, cf_logits = micro_g_backward(
                list(g.model.parameters()), x, t, mask, chunk_noise)
            adv, cls, l1, l2, pen = terms.unbind()
        else:
            total, (adv, cls, l1, l2, pen), cf_logits = g_terms(
                cf, sums, raw, x, t, mask)
            total.backward()
        optimizer_step(mesh, g)

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
        return mean_metrics(mesh, metrics)

    def step_from_draws(state: GANState, x, y,
                        draws: Mapping[str, torch.Tensor]) -> dict:
        if cfg.fixed_target is not None:
            t = torch.full_like(y, cfg.fixed_target)
        else:
            t = sample_targets(y, num_classes, cfg.resample_target,
                               draws=draws["targets"])
        return step_with_draws(state, x, y, t, mask_fn(x, draws),
                               draws.get("gumbel"), draws.get("gumbel_chunks"))

    def step(state: GANState, x, y, generator: torch.Generator) -> dict:
        draws = {k: v.to(x.device)
                 for k, v in draw_fn(generator, tuple(y.shape)).items()}
        return step_from_draws(state, x, y, draws)

    return step, step_with_draws, step_from_draws
