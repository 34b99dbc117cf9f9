"""Train state of the CounteRGAN step (mirrors `cfgan/train/state.py`).

The JAX package's state is an immutable pytree that each step replaces;
here each network is an `nn.Module` holding its float32 master parameters
and its batch statistics (BatchNorm running mean and variance, as
buffers) beside a `torch.optim.Adam`, and the step updates all of them in
place.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


def adam_like_torch(params, lr: float, betas=(0.9, 0.999),
                    eps: float = 1e-8) -> torch.optim.Adam:
    """Adam with optax.adam's defaults, which are torch's
    (`cfgan.train.state.adam_like_torch`: same bias correction, eps
    outside the square root)."""
    return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps)


@dataclass
class NetState:
    """One network: the module (float32 parameters and buffers) and its
    optimizer."""

    model: nn.Module
    opt: torch.optim.Optimizer

    @classmethod
    def create(cls, model: nn.Module, lr: float) -> "NetState":
        return cls(model, adam_like_torch(model.parameters(), lr))


@dataclass
class GANState:
    g: NetState
    d: NetState
    step: int = 0
    # per-step EMA of the generator parameters by name (ema_decay > 0),
    # starting at the initial parameters; None when EMA is off
    g_ema: dict[str, torch.Tensor] | None = None
