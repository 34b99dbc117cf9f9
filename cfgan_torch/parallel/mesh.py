"""Device mesh and process worlds (mirrors `cfgan/parallel/mesh.py`).

The JAX package runs a sharded epoch as one SPMD program over a
`jax.sharding.Mesh`, and XLA inserts the collectives.  The port follows
PyTorch's idiom for many cards instead: one process per device in a
`torch.distributed` process group, each running the same step on its rows
of the global batch, with the collectives written out
(`cfgan_torch.parallel.sharding`).  A `Mesh` is one process's view of such
a world: the mesh's axes and shape, this process's devices along the data
axis and the process group.  `multihost_initialize` is the counterpart of
`jax.distributed.initialize`; `spawn_world` starts a world of processes on
one host.

The data axis has world size x local devices entries.  The local device
list may repeat a device, as the JAX package's virtual CPU devices stand
in for chips: `create_mesh(devices=["cpu"] * 8)` is a mesh of 8 shards in
one process (the sharded serving engine splits each request into them).
A train state is replicated onto a mesh of one device per process.
"""
from __future__ import annotations

import itertools
import math
import multiprocessing as mp
import os
import pickle
import queue as queue_mod
import socket
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from cfgan_torch.core.device import resolve_device

DATA_AXIS = "data"


@dataclass(frozen=True, eq=False)
class Mesh:
    """One process's view of a device mesh: `axis_names` (the data axis
    first), `shape` (entries per axis, world size x `len(devices)` in
    all), this process's `devices` (row-major over the mesh from its
    first entry), the world's process `group` (None without an
    initialised `torch.distributed` world: then no collective is issued),
    `coords`, the mesh coordinates of this process's first device, and
    `axis_groups`, per axis the process group of the ranks that share
    every other coordinate (None where the axis spans no other process;
    the world's group where it spans every one)."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    devices: tuple[torch.device, ...]
    group: Any = None
    coords: tuple[int, ...] | None = None
    axis_groups: tuple[Any, ...] | None = None

    @property
    def world_size(self) -> int:
        """Processes in the mesh's group (1 without one)."""
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        """This process's rank in the mesh's group (0 without one)."""
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def size(self) -> int:
        """Entries of the mesh: world size x local devices."""
        return math.prod(self.shape)

    def _axis(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"the mesh has no axis {axis!r}: its axes are "
                             f"{self.axis_names}")
        return self.axis_names.index(axis)

    def axis_size(self, axis: str) -> int:
        """Entries along `axis`."""
        return self.shape[self._axis(axis)]

    def axis_index(self, axis: str) -> int:
        """This process's (first device's) index along `axis`."""
        return 0 if self.coords is None else self.coords[self._axis(axis)]

    def axis_group(self, axis: str):
        """The process group of the ranks that differ from this one only
        along `axis` (None where no other process does)."""
        return (None if self.axis_groups is None
                else self.axis_groups[self._axis(axis)])

    def device_coords(self, j: int) -> tuple[int, ...]:
        """The mesh coordinates of this process's j-th device."""
        first = 0 if self.coords is None else ravel(self.coords, self.shape)
        return unravel(first + j, self.shape)

    def __deepcopy__(self, memo) -> "Mesh":
        # a module bound to a mesh is copied with the mesh, not a second
        # process group
        return self


def unravel(index: int, shape: Sequence[int]) -> tuple[int, ...]:
    """The row-major coordinates of entry `index` of a mesh of `shape`
    (numpy's `unravel_index`)."""
    coords = []
    for size in reversed(shape):
        index, c = divmod(index, size)
        coords.append(c)
    return tuple(reversed(coords))


def ravel(coords: Sequence[int], shape: Sequence[int]) -> int:
    """The row-major index of `coords` in a mesh of `shape` (numpy's
    `ravel_multi_index`)."""
    index = 0
    for c, size in zip(coords, shape):
        index = index * size + c
    return index


def local_device_count() -> int:
    """The CUDA cards of this host."""
    return torch.cuda.device_count()


def _local_rank() -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    n = torch.cuda.device_count()
    return dist.get_rank() % n if n else 0


def canonical_device(dev) -> torch.device:
    """`dev` with a CUDA card's index filled in."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def create_mesh(mesh_shape: tuple[int, ...] | None = None,
                axis_names: tuple[str, ...] = (DATA_AXIS,),
                devices: Sequence[str | torch.device] | None = None) -> Mesh:
    """The mesh over this process's `devices` (default: with an
    initialised process group, one device a process, `cuda:<local rank>`;
    otherwise every local card; raises where there is none).

    `mesh_shape` (default: the data axis over every device, the other axes
    of size 1) must hold world size x local devices entries, laid out
    row-major (the module docstring).  A mesh with more than one axis
    larger than 1 over several processes takes one device a process.  In
    a world of several processes every rank must call `create_mesh` with
    the same shape: it builds the axes' process groups
    (`torch.distributed.new_group`, which every rank calls for every
    group, in one order), and a group that cannot be built raises."""
    group = dist.group.WORLD if dist.is_initialized() else None
    if devices is None:
        if group is not None:
            resolve_device(None)  # raises without a card
            devices = [torch.device("cuda", _local_rank())]
        else:
            n = local_device_count()
            devices = ([torch.device("cuda", i) for i in range(n)] if n
                       else [resolve_device(None)])
    devices = tuple(canonical_device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    world = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    n = world * len(devices)
    if mesh_shape is None:
        mesh_shape = (n,) + (1,) * (len(axis_names) - 1)
    mesh_shape = tuple(int(s) for s in mesh_shape)
    if len(mesh_shape) != len(axis_names):
        raise ValueError(f"mesh_shape {mesh_shape} does not name the axes "
                         f"{axis_names}")
    if len(set(axis_names)) != len(axis_names):
        raise ValueError(f"the mesh's axis names {axis_names} repeat")
    if math.prod(mesh_shape) != n:
        raise ValueError(f"mesh_shape {mesh_shape} holds "
                         f"{math.prod(mesh_shape)} devices, not the {n} of "
                         f"{world} process(es) x {len(devices)} device(s)")
    wide = sum(s > 1 for s in mesh_shape)
    if world > 1 and len(devices) > 1 and wide > 1:
        raise ValueError(f"mesh_shape {mesh_shape} over {world} processes "
                         f"of {len(devices)} devices each: a mesh with more "
                         "than one axis larger than 1 takes one device a "
                         "process")
    coords = unravel(rank * len(devices), mesh_shape)
    return Mesh(tuple(axis_names), mesh_shape, devices, group, coords,
                _axis_groups(mesh_shape, world, rank, len(devices)))


def _axis_groups(shape: tuple[int, ...], world: int, rank: int,
                 local: int) -> tuple[Any, ...]:
    """Per axis, the process group of the ranks that share every other
    coordinate with `rank`: None for an axis that spans one process, the
    world's group for one that spans them all, else a new group.  Every
    rank builds every group, in the same order."""
    if world == 1:
        return (None,) * len(shape)
    if local > 1:  # one axis larger than 1 spans every process
        return tuple(dist.group.WORLD if s > 1 else None for s in shape)
    groups = []
    for i, size in enumerate(shape):
        if size == 1 or size == world:
            groups.append(None if size == 1 else dist.group.WORLD)
            continue
        mine = None
        rest = [range(s) for j, s in enumerate(shape) if j != i]
        for other in itertools.product(*rest):
            ranks = [ravel(other[:i] + (k,) + other[i:], shape)
                     for k in range(size)]
            made = dist.new_group(ranks)
            if rank in ranks:
                mine = made
        groups.append(mine)
    return tuple(groups)


def multihost_initialize(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None) -> None:
    """Join this process to a `torch.distributed` world of `num_processes`
    (the counterpart of `jax.distributed.initialize`); a no-op for one
    process, as in the JAX package.

    `coordinator_address` is rank 0's "host:port" (or a `tcp://` URL);
    without it the world comes from the environment `torchrun` sets
    (`MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`, `RANK`).  The backend is
    NCCL, which needs a card per process (this process takes `cuda:<local
    rank>`); pass `backend="gloo"` for CPU worlds, or for ranks that share
    one card.  A backend that cannot initialise raises: there is no switch
    to another."""
    env = coordinator_address is None and "WORLD_SIZE" in os.environ
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", 1)) if env else 1
    if num_processes <= 1:
        return
    if process_id is None:
        process_id = int(os.environ["RANK"]) if env else 0
    backend = backend or "nccl"
    kw = {}
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the NCCL backend needs a CUDA card; pass "
                               "backend='gloo' for a CPU world")
        local = (int(os.environ["LOCAL_RANK"]) if "LOCAL_RANK" in os.environ
                 else process_id % torch.cuda.device_count())
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(minutes=10), **kw)


def free_port() -> int:
    """A TCP port on the loopback that the OS has just handed out."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world_main(fn, rank, world, port, backend, args, results, threads):
    try:
        if threads:
            torch.set_num_threads(threads)
        multihost_initialize(f"127.0.0.1:{port}", world, rank, backend)
        # plain pickle copies tensors' data: the queue's own pickler
        # would share their memory, which dies with this process
        results.put((rank, True, pickle.dumps(fn(rank, *args))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))  # the parent raises
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_world(fn: Callable, nprocs: int, args: tuple = (), *,
                backend: str = "gloo", timeout: float = 300.0,
                threads: int | None = 1) -> list:
    """Run `fn(rank, *args)` in `nprocs` fresh processes (the `spawn`
    start method) joined by `multihost_initialize` on a free loopback port;
    returns each rank's return value, by rank.

    `fn` must be importable by the children (a module-level function of a
    module they can import) and its result picklable.  A rank that raises
    or exits without a result, or a world that has not finished after
    `timeout` seconds, raises RuntimeError (with the rank's traceback) or
    TimeoutError; the other ranks are then killed.  `threads` sets each
    child's torch thread count (None leaves torch's default)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_world_main,
                         args=(fn, rank, nprocs, port, backend, args,
                               results, threads), daemon=True)
             for rank in range(nprocs)]
    for p in procs:
        p.start()
    got: dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"the world of {nprocs} did not finish "
                                   f"in {timeout} s (ranks done: "
                                   f"{sorted(got)})")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no "
                                       "result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {nprocs} failed:\n"
                                   f"{value}")
            got[rank] = pickle.loads(value)
    finally:
        for p in procs:
            p.join(timeout=10 if len(got) == nprocs else 0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [got[r] for r in range(nprocs)]
