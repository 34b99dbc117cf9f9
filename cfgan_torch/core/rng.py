"""Named random streams from one root seed (mirrors `cfgan/core/rng.py`).

The JAX package derives keys with `jax.random.fold_in`; the port derives
`torch.Generator` seeds with `stream_seed`, the counterpart of `fold_in`,
which the data pipeline and the train loops also draw their epochs'
streams from.  JAX's keys cannot be reproduced in torch, so
the draws differ from JAX's; the names hash alike (`_stable_hash`), and
the contract is the same: `fixed` repeats, `next` never does.
"""
from __future__ import annotations

import numpy as np
import torch

from cfgan_torch.core.device import resolve_device


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for the `stream`-th stream of `seed`,
    derived statelessly (the counterpart of `jax.random.fold_in(key,
    stream)`): a run resumed at an epoch draws what the uninterrupted run
    drew there."""
    words = np.random.SeedSequence([seed, stream]).generate_state(2,
                                                                  np.uint64)
    return int(words[0] >> np.uint64(1))


class RngStream:
    """Deterministic named generators from a root seed, on one device
    (None: the CUDA card, as the port's entry points resolve it).

    >>> rng = RngStream(42, device="cpu")
    >>> g1 = rng.next("mask")     # a new stream every call
    >>> gf = rng.fixed("init")    # the same stream every call

    `seed_or_generator` is an int, or a `torch.Generator` whose initial
    seed is the root; the generator's own device plays no part."""

    def __init__(self, seed_or_generator: int | torch.Generator,
                 device: str | torch.device | None = None):
        if isinstance(seed_or_generator, torch.Generator):
            self._root = seed_or_generator.initial_seed()
        else:
            self._root = int(seed_or_generator)
        self.device = resolve_device(device)
        self._counts: dict[str, int] = {}

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _fixed_seed(self, name: str) -> int:
        return stream_seed(self._root, _stable_hash(name))

    def fixed(self, name: str) -> torch.Generator:
        """A fresh generator of the stream `name`: the same draws on every
        call."""
        return self._generator(self._fixed_seed(name))

    def _next_seed(self, name: str) -> int:
        c = self._counts.get(name, 0)
        self._counts[name] = c + 1
        return stream_seed(self._fixed_seed(name), c)

    def next(self, name: str = "") -> torch.Generator:
        """The next unused generator of the stream `name`."""
        return self._generator(self._next_seed(name))

    def split(self, n: int) -> list[torch.Generator]:
        """`n` distinct generators from the next seed of the "split"
        stream."""
        seed = self._next_seed("split")
        return [self._generator(stream_seed(seed, i)) for i in range(n)]


def _stable_hash(name: str) -> int:
    # Python's hash() is salted per process; a stable FNV-1a, the JAX
    # package's
    h = 2166136261
    for b in name.encode():
        h = ((h ^ b) * 16777619) & 0x7FFFFFFF
    return h
