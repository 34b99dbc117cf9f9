"""The CounteRGAN alternating train step and the epoch runner (mirrors
`cfgan/train/countergan.py`: `sample_targets`, `make_countergan_step`,
`make_epoch_runner`).

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

The epoch runner (`make_epoch_runner`) is the counterpart of the JAX
package's one compiled `lax.scan` per epoch: on a CUDA card it captures
one step as a CUDA graph and replays it for every step of every epoch,
with the dataset, the epoch's permutation and random draws and the
metrics in device buffers (see `EpochRunner`).
"""
from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.nn.functional as F

from cfgan_torch.core.config import CounterGANConfig
from cfgan_torch.losses import countergan as cg_losses
from cfgan_torch.losses import gan as gan_losses
from cfgan_torch.ops.epilogue import cf_epilogue, epilogue_terms
from cfgan_torch.train.state import GANState

ADV_LOSSES = ("wasserstein", "bce", "clipped_log")
# eager steps before a capture: they create the optimizer state (a capture
# must not) and let cuDNN pick its algorithms
WARMUP_STEPS = 3


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
      the generator's noise), makes the targets and the mask, and runs
      `step_with_draws`;
    - `step_with_draws(state, x, y, t, mask, noise=None) -> metrics` takes
      the targets, the mask and the generator's noise (None for a
      generator that draws none).

    All update `state` in place.  `g_forward(x, t, mask[, noise]) -> (raw,
    masked)` (called with `noise` only where there is some),
    `d_forward(x, t, detach=False, train=True) -> scores` (`detach=True`
    stops the gradient at D's parameters; `train=False` leaves D's state
    as it is) and `clf_forward(x) -> logits` return float32;
    `draw_fn(generator, shape) -> draws` draws for a batch of `shape`
    (`(B,)`, or `(steps, B)` for an epoch) on the generator's device;
    `mask_fn(x, draws) -> mask`.
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

    def step_with_draws(state: GANState, x, y, t, mask, noise=None) -> dict:
        g, d = state.g, state.d
        n_features = x[0].numel()

        # ---- generator forward and the epilogue, kept for the G update;
        # the D update below touches neither ----
        raw, masked = g_forward(x, t, mask, *(() if noise is None
                                              else (noise,)))
        cf, l1s, l2s, pens = cf_epilogue(x, raw, mask, lo, hi)

        # ---- discriminator update, real and fake in one pass ----
        scores = d_forward(torch.cat([x, cf.detach()]), torch.cat([y, t]),
                           train=True)
        d_real, d_fake = scores.chunk(2)
        d_loss = d_loss_of(d_real, d_fake)
        d.opt.zero_grad(set_to_none=True)
        d_loss.backward()
        d.opt.step()

        # ---- generator update through the updated discriminator ----
        adv = g_adv_of(d_forward(cf, t, detach=True, train=False))
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

    def step_from_draws(state: GANState, x, y,
                        draws: Mapping[str, torch.Tensor]) -> dict:
        if cfg.fixed_target is not None:
            t = torch.full_like(y, cfg.fixed_target)
        else:
            t = sample_targets(y, num_classes, cfg.resample_target,
                               draws=draws["targets"])
        return step_with_draws(state, x, y, t, mask_fn(x, draws),
                               draws.get("gumbel"))

    def step(state: GANState, x, y, generator: torch.Generator) -> dict:
        draws = {k: v.to(x.device)
                 for k, v in draw_fn(generator, tuple(y.shape)).items()}
        return step_from_draws(state, x, y, draws)

    return step, step_with_draws, step_from_draws


class EpochRunner:
    """`runner(state, data_x, data_y, perm, draws) -> metrics`: one epoch
    of steps of `step_from_draws` (the counterpart of the JAX package's
    `make_epoch_runner`).

    `data_x` / `data_y` hold the whole training split on the state's
    device; `perm` is the epoch's (steps, batch) index matrix; `draws` the
    epoch's random draws, each (steps, batch, ...) (`draw_fn(generator,
    perm.shape)`).  Step i trains on rows `perm[i]` with draws `[i]`.
    Returns the epoch means of the step metrics, as floats, or with
    `reduce=False` each metric's (steps,) numpy trace.  `state.step`
    advances by `steps`.

    On the CPU each step runs eagerly.  On a CUDA card the first epoch
    runs `WARMUP_STEPS` steps eagerly on a side stream (real steps, which
    create Adam's state and let cuDNN pick its algorithms), then captures
    one step as a `torch.cuda.CUDAGraph` and replays it for every other
    step of this and later epochs.  The replayed step reads its batch and
    draws through a step index held on the device, from static buffers
    that each epoch's `perm` and `draws` are copied into; it writes its
    metrics into a device buffer that is read once an epoch; the replays
    run under `torch.cuda.set_sync_debug_mode("error")`, so a step that
    synchronises with the host raises.  Nothing is copied from the host
    per step.  A capture that fails raises RuntimeError: there is no
    fallback to eager steps on the card.  A new dataset tensor, state or
    epoch shape recaptures (after `WARMUP_STEPS` more eager steps).

    Restoring a checkpoint into `state` must copy in place
    (`cfgan_torch.core.checkpoint.restore_train_state` does): the graph
    holds the addresses of the parameters, buffers and optimizer state.
    `captures` and `replays` count the graphs captured and the steps
    replayed.  The kernel wrappers' launch counters count a captured
    launch once, not its replays.
    """

    def __init__(self, step_from_draws: Callable, reduce: bool = True):
        self.step_from_draws = step_from_draws
        self.reduce = reduce
        self.graph: torch.cuda.CUDAGraph | None = None
        self._key = None
        self._names: list[str] | None = None
        self.captures = 0
        self.replays = 0

    def _finish(self, trace: torch.Tensor) -> dict:
        if self.reduce:
            means = trace.mean(0).cpu().tolist()
            return dict(zip(self._names, means))
        trace = trace.cpu().numpy()
        return {k: trace[:, i] for i, k in enumerate(self._names)}

    def _row(self, metrics: Mapping[str, torch.Tensor]) -> torch.Tensor:
        if self._names is None:
            self._names = list(metrics)
        return torch.stack([metrics[k].float() for k in self._names])

    def __call__(self, state, data_x, data_y, perm, draws) -> dict:
        steps = perm.shape[0]
        if data_x.device.type == "cpu":
            rows = []
            for i in range(steps):
                idx = perm[i].to(data_x.device)
                rows.append(self._row(self.step_from_draws(
                    state, data_x.index_select(0, idx),
                    data_y.index_select(0, idx),
                    {k: v[i] for k, v in draws.items()})))
            return self._finish(torch.stack(rows))
        return self._run_cuda(state, data_x, data_y, perm, draws)

    def _run_cuda(self, state, data_x, data_y, perm, draws) -> dict:
        dev = data_x.device
        steps = perm.shape[0]
        key = (id(state), data_x.data_ptr(), data_y.data_ptr(),
               tuple(data_x.shape), tuple(perm.shape),
               tuple((k, tuple(v.shape), v.dtype)
                     for k, v in sorted(draws.items())))
        first = self.graph is None or key != self._key
        if first:
            # static buffers the graph reads and writes
            self.graph = None
            self._perm = torch.empty(perm.shape, dtype=torch.long,
                                     device=dev)
            self._draws = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                           for k, v in draws.items()}
            self._idx = torch.zeros(1, dtype=torch.long, device=dev)
            self._trace = None
        self._perm.copy_(perm)
        for k, v in draws.items():
            self._draws[k].copy_(v)
        self._idx.zero_()
        step0 = state.step

        def body():
            idx = self._idx
            rows = self._perm.index_select(0, idx).view(-1)
            batch = {k: v.index_select(0, idx)[0]
                     for k, v in self._draws.items()}
            row = self._row(self.step_from_draws(
                state, data_x.index_select(0, rows),
                data_y.index_select(0, rows), batch))
            if self._trace is None:
                self._trace = torch.zeros((steps, row.numel()),
                                          dtype=torch.float32, device=dev)
            self._trace.index_copy_(0, idx, row[None])
            idx.add_(1)

        eager = 0
        if first:
            eager = min(WARMUP_STEPS, steps)
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(eager):
                    body()
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph):
                    body()
            except Exception as e:
                raise RuntimeError(
                    "the epoch runner could not capture the train step as "
                    "a CUDA graph (a step must not synchronise with the "
                    "host or read a tensor's value on it); there is no "
                    "eager fallback on the card") from e
            self.graph, self._key = graph, key
            self.captures += 1
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(steps - eager):
                self.graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        self.replays += steps - eager
        state.step = step0 + steps
        return self._finish(self._trace)


def make_epoch_runner(step_from_draws: Callable,
                      reduce: bool = True) -> EpochRunner:
    """The epoch runner of `step_from_draws` (see `EpochRunner`);
    `reduce=False` returns the per-step metric traces instead of their
    epoch means, as the JAX package's does."""
    return EpochRunner(step_from_draws, reduce)
