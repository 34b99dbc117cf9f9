"""Gumbel-Softmax with the straight-through ("hard") estimator (mirrors
`cfgan/nn/gumbel.py`; `F.gumbel_softmax(logits, tau, hard)`), on noise
given explicitly: the train step draws it from its generator, serving
derives it per row from a key (`cfgan_torch.models.tabular.
derive_gumbel_noise`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gumbel_softmax(logits: torch.Tensor, noise: torch.Tensor,
                   tau: float = 1.0, hard: bool = False,
                   dim: int = -1) -> torch.Tensor:
    """softmax((logits + noise) / tau); with `hard`, the one-hot of its
    argmax in the forward value and the soft sample's gradient
    (y_hard + y - y.detach(), summed in the JAX package's order)."""
    y = F.softmax((logits + noise) / tau, dim=dim)
    if hard:
        idx = y.argmax(dim=dim, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(dim, idx, 1.0)
        y = y_hard + y - y.detach()
    return y
