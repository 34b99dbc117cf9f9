"""Sharding helpers: batch-sharded rows, replicated state, and the
collectives of the data-parallel step (mirrors `cfgan/parallel/
sharding.py:1-37`).

The JAX package annotates shardings and lets XLA insert the collectives.
Here each process holds a replica of the train state and trains on its
rows of every global batch; the step writes out what XLA would insert:

- `mesh_mean`, a mean over the ranks through a differentiable all-reduce
  (SUM forward, SUM backward), which synchronises BatchNorm's batch
  statistics
  (`cfgan_torch.nn.layers.BatchNorm` bound to a mesh);
- `all_reduce_grads`, the mean of the gradients over the ranks before each
  optimizer step;
- `mean_metrics`, the mean of a step's metrics over the ranks, so that
  every rank reports the global batch's.

With equal shards, means over the ranks of per-row means are the global
batch's means, so the sharded step computes the single-process step up to
the order of its sums.  `shard_rows` is the one rule that decides a rank's
rows of a global batch.  Collectives are skipped on a mesh without a
process group (a world of one process that has not initialised
`torch.distributed`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping

import torch
import torch.distributed as dist
from torch import nn

from cfgan_torch.parallel.mesh import DATA_AXIS, Mesh


@dataclass(frozen=True)
class Sharding:
    """Where an array lies on a mesh (JAX's `NamedSharding(mesh,
    PartitionSpec(*spec))`): for each leading dimension, the mesh axis it
    is split over, or None; the dimensions past `spec` are whole."""

    mesh: Mesh
    spec: tuple[str | None, ...] = ()

    @property
    def is_fully_replicated(self) -> bool:
        return all(axis is None for axis in self.spec)


def batch_sharding(mesh: Mesh, axis: str = DATA_AXIS,
                   ndim: int = 2) -> Sharding:
    """The leading (batch) dimension split over `axis`, the rest whole."""
    return Sharding(mesh, (axis,) + (None,) * (ndim - 1))


def replicate_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


# ------------------------------------------------------------------ rows
def shard_rows(mesh: Mesh, a: torch.Tensor, chunks: int = 1,
               dim: int = 0) -> torch.Tensor:
    """This process's rows of the global batch `a` along `dim`, a view.

    With `chunks` = 1 the batch is cut into world-size contiguous blocks,
    in rank order, as JAX lays a batch out over the data axis.  With
    `chunks` = K > 1 (the micro-batched generator update) each of the K
    contiguous global chunks is cut so, and a rank holds its block of
    every chunk, chunk after chunk: its k-th local chunk is its share of
    the global k-th chunk, whose BatchNorm statistics JAX takes over the
    chunk's global rows.  The batch must split evenly."""
    world = mesh.world_size
    if world == 1:
        return a
    n = a.shape[dim]
    if n % (world * chunks):
        raise ValueError(f"a batch of {n} rows does not split into "
                         f"{chunks} chunk(s) over {world} ranks")
    return a.unflatten(dim, (chunks, world, -1)).select(
        dim + 1, mesh.rank).flatten(dim, dim + 1)


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, tree, axis: str = DATA_AXIS):
    """Each array of `tree` (tensors or numpy arrays; dicts, lists and
    tuples of them) as this process's rows of it, split over `axis`: one
    tensor on the device where the process has one device, else a list of
    one block per local device.  The blocks follow JAX's device shards of
    the same batch (`jax.Array.addressable_shards`), rank by rank."""
    if axis != mesh.axis_names[0]:
        raise ValueError(f"the port splits batches over the mesh's first "
                         f"axis {mesh.axis_names[0]!r}, not {axis!r}")

    def put(a):
        rows = shard_rows(mesh, torch.as_tensor(a))
        n = len(mesh.devices)
        if rows.shape[0] % n:
            raise ValueError(f"{rows.shape[0]} rows do not split over {n} "
                             "devices")
        blocks = [b.to(d) for b, d in zip(rows.chunk(n), mesh.devices)]
        return blocks[0] if n == 1 else blocks

    return _tree_map(put, tree)


# ----------------------------------------------------------- collectives
class _AllReduceSum(torch.autograd.Function):
    """SUM over the group forward and backward (the backward is the same
    function, so it differentiates again: WGAN-GP's penalty)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _AllReduceSum.apply(g, ctx.group), None


def mesh_mean(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the mesh's ranks, summed in float32 and
    returned in x's dtype, differentiable (x itself without a group)."""
    if mesh.group is None:
        return x
    return (_AllReduceSum.apply(x.float(), mesh.group)
            / mesh.world_size).to(x.dtype)


def all_reduce_grads(mesh: Mesh | None, params: Iterable[nn.Parameter]
                     ) -> None:
    """Replace each parameter's gradient by its mean over the ranks (one
    all-reduce of the gradients laid end to end)."""
    if mesh is None or mesh.group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.world_size)
    torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(
        flat.split([g.numel() for g in grads]), grads)])


def mean_metrics(mesh: Mesh | None, metrics: dict[str, torch.Tensor]
                 ) -> dict[str, torch.Tensor]:
    """Each scalar metric's mean over the ranks (one all-reduce), in its
    own dtype."""
    if mesh is None or mesh.group is None or not metrics:
        return metrics
    with torch.no_grad():
        row = torch.stack([v.float() for v in metrics.values()])
        dist.all_reduce(row, group=mesh.group)
        row.div_(mesh.world_size)
    return {k: r.to(v.dtype) for (k, v), r in zip(metrics.items(),
                                                  row.unbind())}


# ----------------------------------------------------------- replication
def _broadcast(mesh: Mesh, tensors: Iterable[torch.Tensor]) -> None:
    if mesh.group is None:
        return
    src = dist.get_global_rank(mesh.group, 0)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=src, group=mesh.group)


def _optimizer_tensors(opt: torch.optim.Optimizer) -> list[torch.Tensor]:
    return [v for s in opt.state.values() for v in s.values()
            if torch.is_tensor(v)]


def replicate(mesh: Mesh, tree):
    """Rank 0's values in every rank's copy of `tree`, in place; returns
    `tree`.

    `tree` may be a train state (the `GANState` of any family) or a
    module, whose parameters, buffers, optimizer state and EMA are
    broadcast and whose BatchNorms are bound to `mesh` (they then
    synchronise their batch statistics in train mode); a `GANState` is
    bound to the mesh too (`state.mesh`), so that its step trains
    data-parallel.  Other trees (dicts, lists, tuples of tensors) are
    broadcast leaf by leaf.  A state takes a mesh of one device a
    process, the device it lives on."""
    from cfgan_torch.nn.layers import BatchNorm
    from cfgan_torch.train.state import GANState

    if isinstance(tree, GANState):
        modules, tensors = [tree.g.model, tree.d.model], state_tensors(tree)
    elif isinstance(tree, nn.Module):
        modules = [tree]
        tensors = [*tree.parameters(), *tree.buffers()]
    else:
        tensors = []
        _tree_map(tensors.append, tree)
        _broadcast(mesh, [t for t in tensors if torch.is_tensor(t)])
        return tree
    if len(mesh.devices) != 1:
        raise ValueError(f"a train state takes a mesh of one device a "
                         f"process, not {len(mesh.devices)}: start one "
                         "process per device (spawn_world, torchrun)")
    for module in modules:
        dev = next(module.parameters()).device
        if dev != mesh.devices[0]:
            raise ValueError(f"the state lies on {dev}, the mesh's device "
                             f"is {mesh.devices[0]}")
        for m in module.modules():
            if isinstance(m, BatchNorm):
                m.mesh = mesh
    _broadcast(mesh, tensors)
    if isinstance(tree, GANState):
        tree.mesh = mesh
    return tree


def states_equal(mesh: Mesh, tensors: Iterable[torch.Tensor]) -> bool:
    """Whether every rank holds the same bits in `tensors` (rank 0's
    compared with each rank's; True on every rank or on none)."""
    tensors = [t.detach() for t in tensors]
    if mesh.group is None or not tensors:
        return True
    flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors])
    ref = flat.clone()
    _broadcast(mesh, [ref])
    same = torch.tensor([float(torch.equal(flat, ref))], device=flat.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(same.item())


def state_tensors(state) -> list[torch.Tensor]:
    """Every tensor of a train state: both networks' parameters, buffers
    and optimizer state, and the EMA."""
    out = []
    for net in (state.g, state.d):
        out += [*net.model.parameters(), *net.model.buffers(),
                *_optimizer_tensors(net.opt)]
    if getattr(state, "g_ema", None) is not None:
        out += list(state.g_ema.values())
    return out


__all__ = ["Sharding", "batch_sharding", "replicate_sharding", "shard_rows",
           "shard_batch", "mesh_mean", "all_reduce_grads", "mean_metrics",
           "replicate", "states_equal", "state_tensors"]

