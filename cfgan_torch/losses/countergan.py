"""The CounteRGAN generator objective's terms (mirrors
`cfgan/losses/countergan.py`).

    L_G = lambda_adv * adv
        + lambda_cls * CE(classifier(x_cf), target)
        + lambda_reg_l1 * prox_l1(masked_residual)
        + lambda_reg_l2 * prox_l2(masked_residual)
        + lambda_mask * mean|raw_residual * (1 - mask)|
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class CounterGANTerms(NamedTuple):
    adv: torch.Tensor
    cls: torch.Tensor
    reg_l1: torch.Tensor
    reg_l2: torch.Tensor
    mask_penalty: torch.Tensor
    total: torch.Tensor


def mask_penalty(raw_residual, mask):
    """mean |raw_residual outside the modifiable region|."""
    return torch.mean(torch.abs(raw_residual * (1.0 - mask)))


def proximity_l1(masked_residual, reduction: str = "per_sample_norm"):
    if reduction == "mean_abs":
        return torch.mean(torch.abs(masked_residual))
    flat = masked_residual.reshape(masked_residual.shape[0], -1)
    return torch.mean(torch.sum(torch.abs(flat), dim=1))


def proximity_l2(masked_residual):
    flat = masked_residual.reshape(masked_residual.shape[0], -1)
    return torch.mean(torch.sqrt(torch.sum(flat ** 2, dim=1) + 1e-24))


def classifier_ce(logits, target):
    """Mean softmax cross entropy with integer labels."""
    return F.cross_entropy(logits, target)


def countergan_g_terms(
    adv_loss,
    clf_logits,
    target,
    masked_residual,
    raw_residual,
    mask,
    *,
    lambda_adv: float = 1.0,
    lambda_cls: float = 2.0,
    lambda_reg_l1: float = 1.0,
    lambda_reg_l2: float = 0.0,
    lambda_mask: float = 1.0,
    reg_reduction: str = "per_sample_norm",
) -> CounterGANTerms:
    """The generator objective's terms and their weighted total, from the
    adversarial loss, the classifier's logits of the counterfactuals and
    the residuals (`cfgan.losses.countergan.countergan_g_terms`); `reg_l2`
    is a 0-d zero where `lambda_reg_l2` is 0.  Differentiable by autograd.

    The train step composes the same total from the epilogue's sums
    (`cfgan_torch.ops.epilogue.epilogue_terms`) instead."""
    cls = classifier_ce(clf_logits, target)
    l1 = proximity_l1(masked_residual, reg_reduction)
    l2 = (proximity_l2(masked_residual) if lambda_reg_l2 else
          torch.zeros((), device=masked_residual.device))
    pen = mask_penalty(raw_residual, mask)
    total = (
        lambda_adv * adv_loss
        + lambda_cls * cls
        + lambda_reg_l1 * l1
        + lambda_reg_l2 * l2
        + lambda_mask * pen
    )
    return CounterGANTerms(adv_loss, cls, l1, l2, pen, total)
