"""Train state of the CounteRGAN step (mirrors `cfgan/train/state.py`).

The JAX package's state is an immutable pytree that each step replaces;
here each network is an `nn.Module` holding its float32 master parameters
and its batch statistics (BatchNorm running mean and variance, as
buffers) beside a `torch.optim.Adam`, and the step updates all of them in
place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, Mapping

import torch
from torch import nn


def adam_like_torch(params, lr: float, betas=(0.9, 0.999),
                    eps: float = 1e-8, weight_decay: float = 0.0
                    ) -> torch.optim.Optimizer:
    """Adam with optax.adam's defaults, which are torch's
    (`cfgan.train.state.adam_like_torch`: same bias correction, eps
    outside the square root); with `weight_decay`, AdamW, optax.adamw's
    decoupled decay of every parameter (the update is lr * (adam +
    weight_decay * p) either way).

    On a CUDA card it is `capturable`: its step count lives on the device
    beside the moments, so a CUDA graph of the train step replays the
    update (`cfgan_torch.train.countergan.make_epoch_runner`)."""
    params = list(params)
    capturable = bool(params) and params[0].is_cuda
    if weight_decay:
        return torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps,
                                 weight_decay=weight_decay,
                                 capturable=capturable)
    return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps,
                            capturable=capturable)


@dataclass
class NetState:
    """One network: the module (float32 parameters and buffers) and its
    optimizer; `layout`, where the net is channel-sharded over a mesh
    axis (`cfgan_torch.parallel.shard_leaves`), holds this rank's slices
    of the sharded parameters, which the optimizer steps, while the module
    computes on whole copies gathered after each step."""

    model: nn.Module
    opt: torch.optim.Optimizer
    layout: Any = None

    def opt_params(self) -> dict[str, torch.Tensor]:
        """The optimizer's tensor of each of the module's parameters, by
        name: the parameter itself, or this rank's slice of a sharded
        one."""
        shards = {} if self.layout is None else self.layout.shards
        return {name: shards.get(name, p)
                for name, p in self.model.named_parameters()}

    @classmethod
    def create(cls, model: nn.Module, lr: float, weight_decay: float = 0.0,
               betas=(0.9, 0.999)) -> "NetState":
        """`model` already on its device (Adam's `capturable` follows
        it)."""
        return cls(model, adam_like_torch(model.parameters(), lr, betas,
                                          weight_decay=weight_decay))


@dataclass
class GANState:
    g: NetState
    d: NetState
    step: int = 0
    # per-step EMA of the generator parameters by name (ema_decay > 0),
    # starting at the initial parameters; None when EMA is off
    g_ema: dict[str, torch.Tensor] | None = None
    # the mesh the state is replicated on (`cfgan_torch.parallel.
    # replicate`): its step then trains on this rank's rows of each
    # global batch and averages gradients and metrics over the ranks
    mesh: Any = None


def g_eval_variables(state: GANState) -> dict[str, torch.Tensor]:
    """Copies of the generator's variables for eval and serving, by state
    dict name (`cfgan.train.state.g_eval_variables`): the EMA parameters
    where the state carries them (`ema_decay > 0`), the live ones
    otherwise, beside the live BatchNorm and spectral statistics.  It
    reads the module, so a channel-sharded generator gives whole tensors.

    For BatchNorm-carrying generators with EMA on, prefer
    `cfgan_torch.train.builders.g_serving_variables`, which recalibrates
    the running statistics under the EMA parameters: pairing EMA
    parameters with the live parameters' statistics mis-normalizes
    BatchNorm and can collapse eval quality (`make_bn_recalibrator`)."""
    variables = state.g.model.state_dict()
    if state.g_ema is not None:
        variables.update(state.g_ema)
    return {k: v.detach().clone() for k, v in variables.items()}


def _leaves(tree) -> Iterator[torch.Tensor]:
    if tree is None:
        return
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield torch.as_tensor(tree)


def global_grad_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf of `grads`, dicts, lists
    and tuples of tensors nested at will (None leaves are skipped, as in a
    pytree), as a 0-d tensor in the leaves' dtype
    (`cfgan.train.state.global_grad_norm`).  On a channel-sharded net
    (`cfgan_torch.parallel.shard_leaves`) a rank's gradient slices give
    that rank's own norm, as JAX's gives the norm of the leaves it is
    passed: nothing is summed over the mesh."""
    squares = [torch.sum(g ** 2) for g in _leaves(grads)]
    if not squares:
        return torch.zeros(())
    return torch.sqrt(sum(squares))
