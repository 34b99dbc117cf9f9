"""The GAN losses (mirrors `cfgan/losses/gan.py`).

* BCE-with-logits real/fake (MNIST CounteRGAN).
* Non-saturating log-loss on sigmoid probabilities (`clipped_log`, the
  plain-generation families).
* Wasserstein mean difference, and WGAN-GP's gradient penalty.
"""
from __future__ import annotations

import torch


def bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross entropy on logits, in the JAX package's form
    (torch's BCEWithLogitsLoss computes the same function)."""
    return torch.mean(torch.maximum(logits, logits.new_zeros(()))
                      - logits * targets
                      + torch.log1p(torch.exp(-logits.abs())))


def d_loss_bce(real_logits, fake_logits):
    return (bce_logits(real_logits, torch.ones_like(real_logits))
            + bce_logits(fake_logits, torch.zeros_like(fake_logits)))


def g_loss_bce(fake_logits):
    return bce_logits(fake_logits, torch.ones_like(fake_logits))


class _LogFloored(torch.autograd.Function):
    """value log(max(p, 1e-12)), derivative 1/max(p, 1e-12).  A plain
    log(clamp(p, 1e-12)) would hand a fully saturated discriminator's
    generator a zero gradient; torch's BCELoss floors its backward's
    denominator instead, and so does this (`cfgan.losses.gan._log_floored`).
    """

    @staticmethod
    def forward(ctx, p):
        floored = torch.clamp_min(p, 1e-12)
        ctx.save_for_backward(floored)
        return torch.log(floored)

    @staticmethod
    def backward(ctx, g):
        (floored,) = ctx.saved_tensors
        return g / floored


def log_floored(p: torch.Tensor) -> torch.Tensor:
    return _LogFloored.apply(p)


def _safe_log(p, eps: float):
    return log_floored(p + eps)


def d_loss_nonsaturating(real_probs, fake_probs, eps: float = 0.0):
    """-mean(log D(x)) - mean(log(1 - D(G(z)))) on sigmoid outputs."""
    return (-torch.mean(_safe_log(real_probs, eps))
            - torch.mean(_safe_log(1.0 - fake_probs, eps)))


def g_loss_nonsaturating(fake_probs, eps: float = 0.0):
    return -torch.mean(_safe_log(fake_probs, eps))


def d_loss_wasserstein(real_scores, fake_scores):
    """-E[D(real)] + E[D(fake)] (the critic minimizes)."""
    return -torch.mean(real_scores) + torch.mean(fake_scores)


def g_loss_wasserstein(fake_scores):
    return -torch.mean(fake_scores)


def gradient_penalty(critic_fn, real: torch.Tensor, fake: torch.Tensor,
                     eps: torch.Tensor, *cond) -> torch.Tensor:
    """WGAN-GP's penalty without its lambda, mean((|grad_x D(x_hat)| -
    1)^2) over the batch (`cfgan.losses.gan.gradient_penalty`).

    x_hat = eps real + (1 - eps) fake, `eps` one uniform draw a sample
    (any shape of B elements; it is broadcast over the sample's other
    axes); `critic_fn(x, *cond) -> scores`.  The gradient is taken with
    `create_graph=True`, so the penalty's own gradient reaches the
    critic's parameters by double backward.  The norm is
    sqrt(sum g^2 + 1e-12), in float32 for a float32 `real`."""
    b = real.shape[0]
    eps = eps.reshape(b, *([1] * (real.dim() - 1))).to(real.dtype)
    x_hat = (eps * real + (1.0 - eps) * fake).detach().requires_grad_(True)
    scores = critic_fn(x_hat, *cond)
    (grads,) = torch.autograd.grad(scores.sum(), x_hat, create_graph=True)
    norms = torch.sqrt(torch.sum(grads ** 2,
                                 dim=tuple(range(1, real.dim()))) + 1e-12)
    return torch.mean((norms - 1.0) ** 2)
