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
