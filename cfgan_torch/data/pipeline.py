"""Device-resident data pipeline (mirrors `cfgan/data/pipeline.py`).

The dataset lives on the device and each step gathers its batch by index
(`cfgan_torch.train.countergan.make_epoch_runner`); an epoch is a
permutation of the sample indices, truncated to full batches, as
`DataLoader(shuffle=True, drop_last=True)` gives.
"""
from __future__ import annotations

import numpy as np
import torch


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for the `stream`-th stream of `seed`,
    derived statelessly (the counterpart of `jax.random.fold_in(key,
    stream)`): a run resumed at an epoch draws what the uninterrupted run
    drew there."""
    words = np.random.SeedSequence([seed, stream]).generate_state(2,
                                                                  np.uint64)
    return int(words[0] >> np.uint64(1))


def epoch_perm(generator: torch.Generator, n: int, batch_size: int
               ) -> torch.Tensor:
    """(steps, batch_size) int64 index matrix of one shuffled epoch, on
    the generator's device.  JAX's permutation cannot be reproduced, so
    this draws its own from `generator`."""
    steps = n // batch_size
    perm = torch.randperm(n, generator=generator,
                          device=generator.device)[:steps * batch_size]
    return perm.reshape(steps, batch_size)
