"""Sharding helpers: batch-sharded rows, replicated state, the
channel-sharded layout of a net over a mesh axis, and the collectives of
the sharded step (mirrors `cfgan/parallel/sharding.py`).

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
rows of a global batch: the world's ranks in order, whatever the mesh's
shape.  Collectives are skipped on a mesh without a process group (a
world of one process that has not initialised `torch.distributed`).

On a ("data", "model") mesh, `channel_sharding_spec` and `shard_leaves`
are the JAX package's weight-sharded layout: each eligible parameter of a
net, and its Adam moments, is split over "model" along the dimension that
holds the flax leaf's last (output channels or features), and each rank
keeps its slice (`ChannelLayout`).  The module computes on whole working
copies; after the backward each sharded gradient is reduce-scattered over
"model" and its slice all-reduced over "data" (`optimizer_step`), Adam
steps the slices, and one all-gather over "model" refills the working
copies.  The rows stay split over the whole world, so no two ranks train
on the same rows.
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
    one block per local device.  The device at mesh coordinates c gets
    block c[axis] of `mesh.axis_size(axis)`, so that the blocks are JAX's
    device shards of the same batch (`jax.Array.addressable_shards`),
    rank by rank and device by device: on a ("data", "model") mesh of
    (D, M), rank (d, m) gets block d of D along "data" and block m of M
    along "model"."""
    n = mesh.axis_size(axis)
    dim = mesh.axis_names.index(axis)
    blocks = [mesh.device_coords(j)[dim] for j in range(len(mesh.devices))]

    def put(a):
        a = torch.as_tensor(a)
        if a.shape[0] % n:
            raise ValueError(f"{a.shape[0]} rows do not split over the {n} "
                             f"entries of the mesh axis {axis!r}")
        parts = a.chunk(n)
        out = [parts[i].to(d) for i, d in zip(blocks, mesh.devices)]
        return out[0] if len(out) == 1 else out

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


# ------------------------------------------------------ channel sharding
def channel_sharding_spec(mesh: Mesh, tree, axis: str = "model",
                          min_dim: int = 2) -> dict[str, Sharding]:
    """The JAX package's `channel_sharding_spec` over the parameters of
    `tree` (a module, or a `NetState`): by parameter name, the `Sharding`
    that splits over `axis` the dimension holding the flax leaf's LAST
    dimension (output channels or features), where that length divides by
    the axis size and is at least `min_dim` x the size; otherwise the
    replicated one.  The dimension is read off `cfgan_torch.convert`'s
    layouts: dim 0 of a Linear's (out, in), an OIHW conv's, a
    ConvTranspose's (in, out, k, k) (flax's last dimension is "in"), a
    norm's scale and every bias; dim 3 of the 3x3 kernel's HWIO; dim 1 of
    an Embed's (classes, dim).  Adam's moments share their parameter's
    sharding (`shard_leaves`)."""
    from cfgan_torch.convert import flax_axes
    from cfgan_torch.train.state import NetState

    module = tree.model if isinstance(tree, NetState) else tree
    size = mesh.axis_size(axis)
    spec = {}
    for name, p in module.named_parameters():
        dim = flax_axes(module, name, p.ndim)[-1] if p.ndim else None
        if dim is not None and p.shape[dim] % size == 0 and (
                p.shape[dim] >= min_dim * size):
            spec[name] = Sharding(mesh, tuple(
                axis if i == dim else None for i in range(p.ndim)))
        else:
            spec[name] = replicate_sharding(mesh)
    return spec


class ChannelLayout:
    """A net's channel-sharded layout (`shard_leaves`): for each parameter
    that its spec splits over `axis`, this rank's block `axis_index` of
    `axis_size` along the split dimension.

    The slices lie end to end in one flat buffer; `shards` holds them by
    name as parameters (views of the buffer), which the net's optimizer
    steps in place of the whole parameters, and whose Adam moments are
    slices too.  The module keeps its whole parameters as working copies
    (`cut` takes the slices from them, `gather` refills them from every
    rank's slices), so that its forward, `remat`'s recomputation and a
    captured CUDA graph read fixed addresses.  What the net holds as its
    state is the slices (`state_tensors`).  `spec` records the layout,
    parameter by parameter."""

    def __init__(self, ns, spec: Mapping[str, Sharding]):
        params = dict(ns.model.named_parameters())
        if spec.keys() != params.keys():
            raise KeyError(f"the spec names {sorted(spec.keys() ^ params)}, "
                           "which the net does not hold or the spec "
                           "misses")
        split = {name: sh for name, sh in spec.items()
                 if not sh.is_fully_replicated}
        meshes = {id(sh.mesh) for sh in spec.values()}
        axes = {a for sh in split.values() for a in sh.spec if a is not None}
        if len(meshes) != 1 or len(axes) != 1:
            raise ValueError("a channel layout splits over one axis of one "
                             "mesh")
        mesh, (axis,) = next(iter(spec.values())).mesh, axes
        if len(mesh.devices) != 1:
            raise ValueError("a train state takes a mesh of one device a "
                             "process")
        others = [a for a in mesh.axis_names
                  if a != axis and mesh.axis_size(a) > 1]
        if len(others) > 1:
            raise ValueError(f"the slices split over {axis!r} would be "
                             f"replicated over the axes {others}: the "
                             "layout takes a mesh of at most two axes "
                             "larger than 1")
        self.mesh, self.axis, self.spec = mesh, axis, dict(spec)
        self.n, self.index = mesh.axis_size(axis), mesh.axis_index(axis)
        self.group = mesh.axis_group(axis)
        self.rest_group = mesh.axis_group(others[0]) if others else None
        # (name, whole parameter, split dimension, block length)
        self.leaves = []
        for name, sh in split.items():
            p, dim = params[name], sh.spec.index(axis)
            if p.shape[dim] % self.n:
                raise ValueError(f"{name}: {p.shape[dim]} does not split "
                                 f"over the {self.n} entries of {axis!r}")
            self.leaves.append((name, p, dim, p.shape[dim] // self.n))
        self.replicated = [p for name, p in params.items()
                           if name not in split]
        self.sizes = [p.numel() // self.n for _, p, _, _ in self.leaves]
        first = self.leaves[0][1]
        self.flat = first.new_empty(sum(self.sizes))
        self.shards = {}
        for (name, p, dim, block), piece in zip(
                self.leaves, self.flat.split(self.sizes)):
            shape = list(p.shape)
            shape[dim] = block
            self.shards[name] = nn.Parameter(piece.view(shape))
        self.cut()
        # the optimizer steps the slices; moments it already holds are
        # sliced with their parameters
        of = {p: self.shards[name] for name, p, _, _ in self.leaves}
        for group in ns.opt.param_groups:
            group["params"] = [of.get(p, p) for p in group["params"]]
        for name, p, dim, block in self.leaves:
            old = ns.opt.state.pop(p, None)
            if old:
                ns.opt.state[self.shards[name]] = {
                    k: (self._slice(v, dim, block).clone()
                        if torch.is_tensor(v) and v.shape == p.shape else v)
                    for k, v in old.items()}
            p.grad = None

    def _slice(self, t: torch.Tensor, dim: int, block: int) -> torch.Tensor:
        return t.narrow(dim, self.index * block, block)

    def slice_of(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's slice of `whole`, a tensor shaped as parameter
        `name` (a view)."""
        for leaf, _, dim, block in self.leaves:
            if leaf == name:
                return self._slice(whole, dim, block)
        raise KeyError(f"{name} is not sharded")

    def cut(self) -> None:
        """Take this rank's slices from the whole working copies (after a
        restore or a broadcast wrote those)."""
        with torch.no_grad():
            torch._foreach_copy_(
                list(self.shards.values()),
                [self._slice(p, dim, block)
                 for _, p, dim, block in self.leaves])

    def _all_gather(self, flat: torch.Tensor) -> torch.Tensor:
        """Every rank's `flat` along the axis, (axis size, numel)."""
        if self.group is None:
            return flat[None]
        out = flat.new_empty(self.n * flat.numel())
        dist.all_gather_into_tensor(out, flat, group=self.group)
        return out.view(self.n, -1)

    def _assemble(self, blocks: torch.Tensor,
                  wholes: list[torch.Tensor]) -> None:
        """Copy each rank's row of `blocks` into its slices of `wholes`."""
        dst, src = [], []
        for m, row in enumerate(blocks):
            for whole, piece, (name, _, dim, block) in zip(
                    wholes, row.split(self.sizes), self.leaves):
                dst.append(whole.narrow(dim, m * block, block))
                src.append(piece.view(self.shards[name].shape))
        torch._foreach_copy_(dst, src)

    def gather(self) -> None:
        """Refill the whole working copies from every rank's slices (one
        all-gather over the axis)."""
        with torch.no_grad():
            self._assemble(self._all_gather(self.flat),
                           [p for _, p, _, _ in self.leaves])

    def gather_leaves(self, leaves: Mapping[str, torch.Tensor]) -> dict:
        """`leaves` (by parameter name; a sharded one's as its slice, such
        as an Adam moment) with every sharded leaf made whole (one
        all-gather; every rank of the mesh must call it)."""
        names = [name for name, _, _, _ in self.leaves]
        flat = torch.cat([leaves[name].reshape(-1) for name in names])
        wholes = [p.new_empty(p.shape, dtype=flat.dtype)
                  for _, p, _, _ in self.leaves]
        with torch.no_grad():
            self._assemble(self._all_gather(flat), wholes)
        return {**leaves, **dict(zip(names, wholes))}

    def reduce_grads(self) -> None:
        """The mean over the world of each gradient: the sharded ones'
        this rank's slice, into its shard's `grad` (one reduce-scatter
        over the axis, then one all-reduce over the other axis, then the
        division by the world size; the whole copies' gradients are
        dropped), the replicated ones' by `all_reduce_grads`."""
        all_reduce_grads(self.mesh, self.replicated)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for _, p, _, _ in self.leaves]
        if self.group is None:
            out = torch.cat([self._slice(g, dim, block).reshape(-1)
                             for g, (_, _, dim, block)
                             in zip(grads, self.leaves)])
        else:
            full = torch.cat([g.narrow(dim, m * block, block).reshape(-1)
                              for m in range(self.n)
                              for g, (_, _, dim, block)
                              in zip(grads, self.leaves)])
            out = full.new_empty(full.numel() // self.n)
            dist.reduce_scatter_tensor(out, full, group=self.group)
        if self.rest_group is not None:
            dist.all_reduce(out, group=self.rest_group)
        out.div_(self.mesh.world_size)
        for (name, p, _, _), piece in zip(self.leaves, out.split(self.sizes)):
            self.shards[name].grad = piece.view(self.shards[name].shape)
            p.grad = None


def shard_leaves(tree, spec: Mapping[str, Sharding]):
    """Lay the net `tree` (a `NetState`, such as `state.g`) out as `spec`
    says (`channel_sharding_spec`), in place; returns it.  Each rank keeps
    its slice of every parameter the spec splits, and of that parameter's
    Adam moments (Adam's step count stays whole); `tree.layout` records
    the layout (`ChannelLayout`).  A spec that splits nothing leaves the
    net as it is.  Call it on a state replicated on the spec's mesh
    (`replicate`), on every rank."""
    from cfgan_torch.train.state import NetState

    if not isinstance(tree, NetState):
        raise TypeError(f"shard_leaves lays out a NetState, not "
                        f"{type(tree).__name__}")
    if tree.layout is not None:
        raise ValueError("the net is channel-sharded already")
    if any(not sh.is_fully_replicated for sh in spec.values()):
        tree.layout = ChannelLayout(tree, spec)
    return tree


def optimizer_step(mesh: Mesh | None, ns) -> None:
    """The net's optimizer step on the gradients its backward left: their
    means over the mesh's ranks first (`all_reduce_grads`, or a
    channel-sharded net's `reduce_grads`), and a channel-sharded net's
    working copies refilled after it (`gather`)."""
    layout = ns.layout
    if layout is None:
        all_reduce_grads(mesh, ns.model.parameters())
        ns.opt.step()
        return
    if mesh is not layout.mesh:
        raise ValueError("the net is channel-sharded over another mesh than "
                         "the one the state is replicated on: replicate "
                         "the state on the spec's mesh")
    layout.reduce_grads()
    ns.opt.step()
    layout.gather()


# ----------------------------------------------------------- replication
def _broadcast(group, tensors: Iterable[torch.Tensor]) -> None:
    """The group's first rank's values in `tensors`, in place."""
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=src, group=group)


def _optimizer_tensors(opt: torch.optim.Optimizer, params=None
                       ) -> list[torch.Tensor]:
    """The optimizer's state tensors (of `params` alone, where given)."""
    keep = None if params is None else set(params)
    return [v for p, s in opt.state.items() for v in s.values()
            if torch.is_tensor(v) and (keep is None or p in keep)]


def _net_tensors(ns) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """(the tensors every rank holds whole: the module's parameters,
    working copies included, its buffers and the replicated parameters'
    optimizer state; the optimizer state of a channel-sharded net's
    slices)."""
    model = ns.model
    whole = [*model.parameters(), *model.buffers()]
    if ns.layout is None:
        return whole + _optimizer_tensors(ns.opt), []
    shards = list(ns.layout.shards.values())
    return (whole + _optimizer_tensors(ns.opt, ns.layout.replicated),
            _optimizer_tensors(ns.opt, shards))


def check_one_device_a_process(mesh: Mesh) -> None:
    """Raise ValueError unless `mesh` has one device in this process: the
    port trains one process a device, as `torchrun` and
    `DistributedDataParallel` do, since its synchronised BatchNorm
    all-reduces inside the forward.  JAX's one-process data parallelism
    over every local device is `spawn_world(fn, N)` here."""
    if len(mesh.devices) != 1:
        raise ValueError(f"a train state takes a mesh of one device a "
                         f"process, not {len(mesh.devices)}: start one "
                         "process per device (spawn_world, torchrun)")


def replicate(mesh: Mesh, tree):
    """Rank 0's values in every rank's copy of `tree`, in place; returns
    `tree`.

    `tree` may be a train state (the `GANState` of any family) or a
    module, whose parameters, buffers, optimizer state and EMA are
    broadcast over the whole world and whose BatchNorms are bound to
    `mesh` (they then synchronise their batch statistics in train mode);
    a `GANState` is bound to the mesh too (`state.mesh`), so that its step
    trains data-parallel.  A channel-sharded net (`shard_leaves`) keeps
    its layout: its working copies come from rank 0, each rank cuts its
    slices from them, and the slices' optimizer state comes from the
    first rank holding the same slice.  Other trees (dicts, lists, tuples
    of tensors) are broadcast leaf by leaf.  A state takes a mesh of one
    device a process, the device it lives on."""
    from cfgan_torch.nn.layers import BatchNorm
    from cfgan_torch.train.state import GANState

    if isinstance(tree, GANState):
        nets = [tree.g, tree.d]
        modules = [ns.model for ns in nets]
    elif isinstance(tree, nn.Module):
        nets, modules = [], [tree]
    else:
        tensors = []
        _tree_map(tensors.append, tree)
        _broadcast(mesh.group, [t for t in tensors if torch.is_tensor(t)])
        return tree
    check_one_device_a_process(mesh)
    for module in modules:
        dev = next(module.parameters()).device
        if dev != mesh.devices[0]:
            raise ValueError(f"the state lies on {dev}, the mesh's device "
                             f"is {mesh.devices[0]}")
        for m in module.modules():
            if isinstance(m, BatchNorm):
                m.mesh = mesh
    if not nets:
        _broadcast(mesh.group, [*tree.parameters(), *tree.buffers()])
        return tree
    for ns in nets:
        whole, sliced = _net_tensors(ns)
        _broadcast(mesh.group, whole)
        if ns.layout is not None:
            ns.layout.cut()
            _broadcast(ns.layout.rest_group, sliced)
    if tree.g_ema is not None:
        _broadcast(mesh.group, tree.g_ema.values())
    tree.mesh = mesh
    return tree


def _matches_first(group, tensors: Iterable[torch.Tensor]) -> bool:
    """Whether this rank's `tensors` hold the bits of the group's first
    rank's (True without a group)."""
    tensors = [t.detach() for t in tensors]
    if group is None or not tensors:
        return True
    flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors])
    ref = flat.clone()
    _broadcast(group, [ref])
    return torch.equal(flat, ref)


def _on_every_rank(mesh: Mesh, ok: bool, device) -> bool:
    same = torch.tensor([float(ok)], device=device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(same.item())


def states_equal(mesh: Mesh, tensors: Iterable[torch.Tensor]) -> bool:
    """Whether every rank holds the same bits in `tensors` (rank 0's
    compared with each rank's; True on every rank or on none)."""
    tensors = [t.detach() for t in tensors]
    if mesh.group is None or not tensors:
        return True
    return _on_every_rank(mesh, _matches_first(mesh.group, tensors),
                          tensors[0].device)


def replicas_equal(state) -> bool:
    """Whether the ranks of `state.mesh` hold one train state bit for bit:
    the tensors every rank holds whole equal rank 0's, and a
    channel-sharded net's slices and their optimizer state equal those
    of the first rank holding the same slice (True on every rank or on
    none; True without a process group)."""
    mesh = state.mesh
    if mesh is None or mesh.group is None:
        return True
    whole, ok = [], True
    for ns in (state.g, state.d):
        w, sliced = _net_tensors(ns)
        whole += w
        if ns.layout is not None:
            ok = ok and _matches_first(
                ns.layout.rest_group,
                [*ns.layout.shards.values(), *sliced])
    if state.g_ema is not None:
        whole += list(state.g_ema.values())
    ok = _matches_first(mesh.group, whole) and ok
    return _on_every_rank(mesh, ok, whole[0].device)


def state_tensors(state) -> list[torch.Tensor]:
    """Every tensor of a train state: both networks' parameters (of a
    channel-sharded net, this rank's slices in place of the whole
    parameters they split), buffers and optimizer state, and the EMA."""
    out = []
    for net in (state.g, state.d):
        out += [*net.opt_params().values(), *net.model.buffers(),
                *_optimizer_tensors(net.opt)]
    if getattr(state, "g_ema", None) is not None:
        out += list(state.g_ema.values())
    return out


__all__ = ["Sharding", "batch_sharding", "replicate_sharding", "shard_rows",
           "shard_batch", "mesh_mean", "all_reduce_grads", "mean_metrics",
           "channel_sharding_spec", "ChannelLayout", "shard_leaves",
           "optimizer_step", "replicate", "states_equal", "replicas_equal",
           "state_tensors"]

