"""The data pipeline (mirrors `cfgan/data/pipeline.py`).

The training loop keeps the dataset on the device (`device_put_dataset`)
and each step gathers its batch by index
(`cfgan_torch.train.countergan.make_epoch_runner`); an epoch is a
permutation of the sample indices, truncated to full batches, as
`DataLoader(shuffle=True, drop_last=True)` gives.  A dataset that does
not fit on the device streams from the host instead: `HostIterator`
cuts host minibatches and `DevicePrefetcher` keeps their copies to the
card in flight ahead of the consumer, from pinned buffers on a stream of
its own.
"""
from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch

from cfgan_torch.core.device import resolve_device
from cfgan_torch.core.rng import stream_seed  # noqa: F401  (re-exported)


def epoch_perm(generator: torch.Generator, n: int, batch_size: int
               ) -> torch.Tensor:
    """(steps, batch_size) int64 index matrix of one shuffled epoch, on
    the generator's device.  JAX's permutation cannot be reproduced, so
    this draws its own from `generator`."""
    steps = n // batch_size
    perm = torch.randperm(n, generator=generator,
                          device=generator.device)[:steps * batch_size]
    return perm.reshape(steps, batch_size)


def num_steps(n: int, batch_size: int) -> int:
    """Full batches of `batch_size` in `n` samples."""
    return n // batch_size


def device_put_dataset(mesh, *arrays) -> tuple[torch.Tensor, ...]:
    """Each array whole on this process's device of `mesh`, a tensor of
    the array's dtype.  Every rank holds its own copy, as JAX replicates
    the dataset over the mesh (each gathers its rows of a batch by index
    on its device); in a world of processes the mesh must have one device
    a process.  Without a process group the arrays go to
    `mesh.devices[0]`."""
    from cfgan_torch.parallel.sharding import check_one_device_a_process

    if mesh.group is not None:
        check_one_device_a_process(mesh)
    dev = mesh.devices[0]
    return tuple(torch.as_tensor(np.asarray(a)).to(dev) for a in arrays)


class HostIterator:
    """Host minibatches of `arrays` (numpy, the same length), as tuples of
    numpy arrays: in order, or with `shuffle` in the order of
    `np.random.RandomState(seed).shuffle`, drawn anew each epoch from one
    state; the last short batch is dropped with `drop_last`."""

    def __init__(self, arrays, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False):
        self.arrays = [np.asarray(a) for a in arrays]
        self.n = len(self.arrays[0])
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.RandomState(seed)

    def __iter__(self):
        idx = np.arange(self.n)
        if self.shuffle:
            self._rng.shuffle(idx)
        end = ((self.n // self.batch_size) * self.batch_size
               if self.drop_last else self.n)
        for lo in range(0, end, self.batch_size):
            sel = idx[lo:lo + self.batch_size]
            yield tuple(a[sel] for a in self.arrays)

    def __len__(self):
        if self.drop_last:
            return self.n // self.batch_size
        return -(-self.n // self.batch_size)


class _PinnedRing:
    """Up to `size` pinned host buffers of one shape and dtype, each
    reused once the copy recorded behind it has completed: a buffer is
    allocated only while every one the ring holds is still in flight."""

    def __init__(self, shape, dtype: torch.dtype, size: int):
        self.shape, self.dtype, self.size = shape, dtype, size
        self.buffers: list[torch.Tensor] = []
        self.events: list[torch.cuda.Event | None] = []
        self.order = collections.deque()  # buffer indices, oldest copy first

    def _free(self) -> int:
        for i in self.order:
            if self.events[i].query():
                return i
        if len(self.buffers) < self.size:
            self.buffers.append(torch.empty(self.shape, dtype=self.dtype,
                                            pin_memory=True))
            self.events.append(None)
            return len(self.buffers) - 1
        i = self.order[0]
        self.events[i].synchronize()  # the oldest copy has left it
        return i

    def copy(self, t: torch.Tensor, device: torch.device) -> torch.Tensor:
        """`t` on `device`, copied on the current stream through a free
        buffer, with an event recorded behind the copy."""
        i = self._free()
        np.copyto(self.buffers[i].numpy(), t.numpy())
        out = self.buffers[i].to(device, non_blocking=True)
        self.events[i] = torch.cuda.Event()
        self.events[i].record()
        if i in self.order:
            self.order.remove(i)
        self.order.append(i)
        return out


class DevicePrefetcher:
    """Host batches on the device, `buffer_size` (at least 1) copies in
    flight ahead of the consumer: the same tuples, in the same order, as
    JAX's `DevicePrefetcher` yields, and `len` of the host iterator's.

    `sharding` (a `cfgan_torch.parallel.sharding.Sharding` over a mesh of
    one device a process): a sharding of the rows over a mesh axis yields
    this process's block of each batch along that axis, block
    `mesh.axis_index(axis)` of `mesh.axis_size(axis)`, as JAX's
    `NamedSharding` places it (on a ("data", "model") mesh, rank (d, m)
    gets block d of a batch split over "data"); a replicated one yields
    the whole batch; both on the mesh's device of this process.  Without
    it the batches go to `device` (None: the CUDA card).

    On the card each array of a batch is copied into one of at most
    `buffer_size + 1` pinned host buffers per shape and dtype, a free one
    reused before another is allocated, and from there to the
    device on a stream of the prefetcher's own; an event recorded behind
    the copies is what the consumer's current stream waits on before the
    batch is yielded (no host synchronisation), and each yielded tensor is
    recorded on that stream for the caching allocator.  On the CPU the
    host arrays are yielded as tensors."""

    def __init__(self, host_iter: Iterable, buffer_size: int = 2,
                 sharding=None, device: str | torch.device | None = None):
        self.host_iter = host_iter
        self.buffer_size = max(1, buffer_size)
        self.sharding = sharding
        if sharding is not None:
            from cfgan_torch.parallel.sharding import (
                check_one_device_a_process,
            )

            check_one_device_a_process(sharding.mesh)
            if any(axis is not None for axis in sharding.spec[1:]):
                raise ValueError(f"the prefetcher splits a batch along its "
                                 f"rows only, not by {sharding.spec}")
            if device is None:
                device = sharding.mesh.devices[0]
        self.device = resolve_device(device)
        #: the stream the copies run on (None on the CPU)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._rings: dict[tuple, _PinnedRing] = {}

    @property
    def pinned_buffers(self) -> int:
        """Pinned host buffers allocated so far."""
        return sum(len(r.buffers) for r in self._rings.values())

    def _rows(self, a) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
        spec = self.sharding.spec if self.sharding else ()
        axis = spec[0] if spec else None
        if axis is not None:
            mesh = self.sharding.mesh
            n = mesh.axis_size(axis)
            if len(t) % n:
                raise ValueError(f"{len(t)} rows do not split over the {n} "
                                 f"entries of the mesh axis {axis!r}")
            t = t.chunk(n)[mesh.axis_index(axis)]
        return t

    def _put(self, batch):
        rows = [self._rows(a) for a in batch]
        if self.device.type != "cuda":
            return tuple(t.to(self.device, copy=True) for t in rows), None
        out = []
        with torch.cuda.stream(self.stream):
            for t in rows:
                key = (tuple(t.shape), t.dtype)
                ring = self._rings.get(key)
                if ring is None:
                    ring = self._rings[key] = _PinnedRing(
                        t.shape, t.dtype, self.buffer_size + 1)
                out.append(ring.copy(t, self.device))
            done = torch.cuda.Event()
            done.record(self.stream)
        return tuple(out), done

    def _ready(self, item):
        out, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            for t in out:
                t.record_stream(consumer)
        return out

    def __iter__(self) -> Iterator[tuple[torch.Tensor, ...]]:
        queue = collections.deque()
        it = iter(self.host_iter)
        for batch in it:
            queue.append(self._put(batch))
            if len(queue) == self.buffer_size:
                break
        while queue:
            item = queue.popleft()
            batch = next(it, None)
            if batch is not None:
                queue.append(self._put(batch))
            yield self._ready(item)

    def __len__(self):
        return len(self.host_iter)
