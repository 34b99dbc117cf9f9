"""The ranks' side of the port's sharded tests (tests/test_torch_parallel.py,
test_torch_sharded_train.py, test_torch_sharded_serving.py,
test_torch_mesh2d.py, test_torch_sharded2d_steps.py,
test_torch_pipeline.py).

`cfgan_torch.parallel.spawn_world` runs these functions in fresh processes
joined by gloo on the loopback, one CPU device a rank.  They import
torch and the port only, never JAX: the test computes the JAX side first
and hands the arrays over in an .npz (`save_npz` / `load_npz`, nested
dicts flattened to "a/b" keys), with configs in the spawn arguments.
"""
from __future__ import annotations

import numpy as np
import torch

from cfgan_torch.parallel import create_mesh, replicate, shard_batch
from cfgan_torch.parallel.sharding import state_tensors, states_equal


def save_npz(path, tree: dict) -> None:
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(v, key + "/")
            else:
                flat[key] = np.asarray(v.detach().cpu() if torch.is_tensor(v)
                                       else v)

    walk(tree, "")
    np.savez(path, **flat)


def load_npz(path) -> dict:
    tree: dict = {}
    with np.load(path) as f:
        for key in f.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = f[key]
    return tree


def tensors(tree: dict) -> dict:
    return {k: tensors(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def cpu_mesh():
    return create_mesh(devices=["cpu"])


# ------------------------------------------------------------- the mesh
def rows_and_replicas(rank: int, x: np.ndarray, bn_cases=()) -> dict:
    """This rank's rows of x, and a tree and a small train state made
    different on each rank, after `replicate`; then `batch_norm` of each
    case (name -> .npz) under "bn"."""
    from cfgan_torch.core import config as C
    from cfgan_torch.models.classifiers import MLPClassifier
    from cfgan_torch.nn.layers import BatchNorm
    from cfgan_torch.train.builders import build_moons_countergan

    mesh = cpu_mesh()
    rows = shard_batch(mesh, {"x": x})["x"].numpy()
    tree = replicate(mesh, {"a": torch.full((3,), float(rank + 1)),
                            "b": [torch.arange(4) * (rank + 1)]})
    bundle = build_moons_countergan(C.MOONS_COUNTERGAN,
                                    MLPClassifier().state_dict(),
                                    seed=rank, device="cpu")
    replicate(mesh, bundle.state)
    bound = [m.mesh is mesh for net in (bundle.state.g, bundle.state.d)
             for m in net.model.modules() if isinstance(m, BatchNorm)]
    return {"rank": mesh.rank, "world": mesh.world_size, "size": mesh.size,
            "rows": rows, "a": tree["a"].numpy(), "b": tree["b"][0].numpy(),
            "state": [t.detach().clone() for t in state_tensors(
                bundle.state)],
            "bound": bound, "state_mesh": bundle.state.mesh is mesh,
            "equal": states_equal(mesh, state_tensors(bundle.state)),
            "bn": {name: batch_norm(rank, npz) for name, npz in bn_cases}}


def prefetched_rows(rank: int, x: np.ndarray, y: np.ndarray,
                    batch: int, shape=None) -> dict:
    """The batches a `DevicePrefetcher` yields on this rank under a batch
    sharding and a replicated one, and `device_put_dataset`'s copy of the
    dataset with `states_equal` over the ranks: on a mesh of the world's
    data axis, or with `shape` on a ("data", "model") mesh of that shape,
    where the rows are also split over "model" (`rows_model`)."""
    from cfgan_torch.data.pipeline import (
        DevicePrefetcher,
        HostIterator,
        device_put_dataset,
    )
    from cfgan_torch.parallel.sharding import (
        batch_sharding,
        replicate_sharding,
    )

    mesh = cpu_mesh() if shape is None else mesh_of(shape)
    shardings = {"rows": batch_sharding(mesh),
                 "whole": replicate_sharding(mesh)}
    if shape is not None:
        shardings["rows_model"] = batch_sharding(mesh, "model")
    out = {"rank": mesh.rank,
           "coords": tuple(mesh.axis_index(a) for a in mesh.axis_names)}
    for name, sharding in shardings.items():
        feed = DevicePrefetcher(HostIterator((x, y), batch), 2, sharding)
        out[name] = [tuple(t.numpy() for t in b) for b in feed]
        out[name + "_device"] = str(feed.device)
    placed = device_put_dataset(mesh, x, y)
    out["placed"] = [t.numpy() for t in placed]
    out["placed_equal"] = states_equal(mesh, placed)
    return out


def batch_norm(rank: int, npz: str) -> dict:
    """A bound BatchNorm in train mode on this rank's rows: the output,
    the input's gradient and the parameters' (summed over the ranks) of
    sum(y * w), and the running statistics after the update."""
    import torch.distributed as dist

    from cfgan_torch.nn.layers import BatchNorm

    d = load_npz(npz)
    mesh = cpu_mesh()
    bn = BatchNorm(d["scale"].shape[0])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(d["scale"]))
        bn.bias.copy_(torch.from_numpy(d["bias"]))
    replicate(mesh, bn)
    x = shard_batch(mesh, torch.from_numpy(d["x"])).requires_grad_(True)
    w = shard_batch(mesh, torch.from_numpy(d["w"]))
    y = bn(x, update_stats=bool(d["update_stats"]))
    (y * w).sum().backward()
    grads = torch.stack([bn.weight.grad, bn.bias.grad])
    dist.all_reduce(grads)
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dscale": grads[0].numpy(), "dbias": grads[1].numpy(),
            "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}


# ------------------------------------------------------------ training
def build(family: str, cfg, d: dict):
    """The port's bundle of `family` on the CPU with the test's initial
    state (`d["g"]`, `d["d"]`, `d["g_ema"]`) and frozen classifier
    (`d["clf"]`)."""
    from cfgan_torch.train import builders

    clf = tensors(d.get("clf", {}))
    if family == "moons":
        b = builders.build_moons_countergan(cfg, clf, device="cpu")
    elif family == "tabular":
        from cfgan_torch.data.kc_house import KC_SCHEMA, load_kc_house

        b = builders.build_tabular_countergan(
            cfg, clf, KC_SCHEMA, load_kc_house()[2], num_classes=4,
            device="cpu")
    elif family == "mnist":
        b = builders.build_mnist_countergan(cfg, clf, device="cpu")
    else:
        from cfgan_torch.train.gan_builders import build_gan

        b = build_gan(cfg, num_classes=10, device="cpu")
    b.state.g.model.load_state_dict(tensors(d["g"]))
    b.state.d.model.load_state_dict(tensors(d["d"]))
    if "g_ema" in d:
        with torch.no_grad():
            for k, v in tensors(d["g_ema"]).items():
                b.state.g_ema[k].copy_(v)
    return b


def _floats(metrics: dict) -> dict:
    return {k: np.asarray(v, np.float64) if isinstance(v, np.ndarray)
            else float(v) for k, v in metrics.items()}


def _epoch(b, d, reduce=False):
    from cfgan_torch.train.loop import make_epoch_runner

    runner = make_epoch_runner(b.step_from_draws, reduce=reduce,
                               schedule=getattr(b, "schedule", None))
    return _floats(runner(b.state, torch.from_numpy(d["x"]),
                          torch.from_numpy(d["y"]).long(),
                          torch.from_numpy(d["perm"]),
                          {k: torch.from_numpy(v)
                           for k, v in d["draws"].items()}))


def _steps(b, d):
    """`step_with_draws` on each global batch of d["steps"] in turn; the
    metrics by step, and Adam's first moments after the first step (0.1 x
    its gradients)."""
    from cfgan_torch.convert import adam_moments_to_flax

    out, moments = [], None
    for i in range(len(d["steps"])):
        s = tensors(d["steps"][str(i)])
        out.append(_floats(b.step_with_draws(
            b.state, s["x"], s["y"].long(), s["t"].long(), s["mask"])))
        if i == 0:
            moments = adam_moments_to_flax(b.state)
    return out, moments


def train(rank: int, jobs: list[dict]) -> dict:
    """Each job (name, family, cfg, npz, kind) on a state replicated over
    the world: "epoch" (the runner's per-step traces), "steps" (the
    step-level API), "loop" (`train_countergan_loop(mesh=)`), "save" (an
    epoch, `save_sharded` to job["dir"], another epoch) or "restore" (a
    fresh state, `restore_sharded` from job["dir"], that second epoch).
    Returns, by job, the metrics and whether every rank holds the same
    state bit for bit."""
    from cfgan_torch.convert import gan_state_to_flax
    from cfgan_torch.core import checkpoint as ckpt
    from cfgan_torch.train.loop import train_countergan_loop

    mesh = cpu_mesh()
    out = {}
    for job in jobs:
        d = load_npz(job["npz"])
        b = build(job["family"], job["cfg"], d)
        res: dict = {}
        if job["kind"] == "loop":
            lines = []
            _, hist = train_countergan_loop(
                b, d["x"], d["y"], epochs=2, batch_size=job["batch"],
                seed=0, mesh=mesh, log=lines.append)
            hist.pop("wall_time_s")
            res.update(history=hist, lines=lines,
                       d_params=gan_state_to_flax(b.state)["d"]["params"])
        else:
            replicate(mesh, b.state)
            if job["kind"] == "epoch":
                res["metrics"] = _epoch(b, d)
                res["d_params"] = gan_state_to_flax(b.state)["d"]["params"]
            elif job["kind"] == "steps":
                res["metrics"], res["moments"] = _steps(b, d)
            elif job["kind"] == "save":
                res["first"] = _epoch(b, d, reduce=True)
                ckpt.save_sharded(job["dir"], b.state, {"epoch": 0})
                res["saved"] = [t.detach().clone()
                                for t in state_tensors(b.state)]
            else:
                ckpt.restore_sharded(job["dir"], b.state)
                res["saved"] = [t.detach().clone()
                                for t in state_tensors(b.state)]
            if job["kind"] in ("save", "restore"):
                d2 = {**d, "perm": d["perm2"], "draws": d["draws2"]}
                res["post"] = _epoch(b, d2, reduce=True)
        res["equal"] = states_equal(mesh, state_tensors(b.state))
        res["step"] = b.state.step
        out[job["name"]] = res
    return out


# ------------------------------------------------- the ("data", "model") mesh
def mesh_of(shape):
    """The world's ("data", "model") mesh of `shape` on the CPU, or its
    1-D mesh where `shape` is None."""
    if shape is None:
        return cpu_mesh()
    return create_mesh(tuple(shape), ("data", "model"), devices=["cpu"])


def _refusal(shape, names, devices: int) -> str | None:
    """The message of the ValueError `create_mesh` raises for `shape` over
    the world's processes of `devices` CPU devices each, or None."""
    try:
        create_mesh(tuple(shape), tuple(names), devices=["cpu"] * devices)
    except ValueError as e:
        return str(e)
    return None


def mesh2d_facts(rank: int, shape, x: np.ndarray) -> dict:
    """This rank's coordinates on a ("data", "model") mesh of `shape`, the
    ranks of each axis's group, and its blocks of `x` along each axis;
    and what `create_mesh` says to meshes over processes of two devices
    each ("refusals": None where it made the mesh)."""
    import torch.distributed as dist

    world = dist.get_world_size()
    refusals = {str(s): _refusal(s, n, 2) for s, n in (
        ((world, 2), ("data", "model")), ((2, world), ("data", "model")),
        ((2 * world,), ("data",)), ((2 * world, 1), ("data", "model")))}
    mesh = mesh_of(shape)
    groups = {}
    for axis in mesh.axis_names:
        g = mesh.axis_group(axis)
        groups[axis] = None if g is None else dist.get_process_group_ranks(g)
    return {"rank": mesh.rank, "world": mesh.world_size,
            "shape": mesh.shape, "names": mesh.axis_names,
            "coords": tuple(mesh.axis_index(a) for a in mesh.axis_names),
            "groups": groups,
            "blocks": {a: shard_batch(mesh, {"x": x}, axis=a)["x"].numpy()
                       for a in mesh.axis_names},
            "refusals": refusals}


def _tensor(a: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.asarray(a))
    return t.long() if not t.is_floating_point() else t


def _step2d(b, s: dict) -> dict:
    """One step on the global batch `s`: `step_from_draws` where it holds
    the draws, else `step_with_draws` on its targets and mask."""
    x, y = _tensor(s["x"]), _tensor(s["y"])
    if "draws" in s:
        return b.step_from_draws(b.state, x, y, {k: _tensor(v) for k, v
                                                 in s["draws"].items()})
    return b.step_with_draws(b.state, x, y, _tensor(s["t"]),
                             _tensor(s["mask"]))


def _layout_facts(ns) -> dict:
    """Per generator parameter: its whole shape, and the shapes this rank
    holds of it and of its Adam moments, and whether it is split."""
    spec = {} if ns.layout is None else ns.layout.spec
    out = {}
    for name, p in ns.opt_params().items():
        st = ns.opt.state.get(p, {})
        out[name] = {
            "whole": tuple(dict(ns.model.named_parameters())[name].shape),
            "held": tuple(p.shape),
            "moments": tuple(tuple(st[k].shape) for k in ("exp_avg",
                                                          "exp_avg_sq")),
            "step": tuple(st["step"].shape),
            "split": name in spec and not spec[name].is_fully_replicated}
    return out


def train2d(rank: int, jobs: list[dict]) -> dict:
    """Each job (name, family, cfg, npz, mesh) on a state replicated over
    the world: on a ("data", "model") mesh of job["mesh"] with the
    generator channel-sharded over "model" (`channel_sharding_spec`,
    `shard_leaves`), or on the 1-D mesh (mesh None); each global batch of
    the npz's "steps" in turn (`_step2d`).  With job["save"], the state is
    written by `save_sharded` there after the first step, and a fresh
    replicated state restored from it writes its own file beside it
    ("<save>-replicated"); with job["restore"], the state is restored from
    that directory and takes the steps after the first.  Returns, by job,
    the metrics by step, Adam's first moments after the first step, the
    whole train state after the last (flax layout), whether the ranks hold
    one state, the bytes of this rank's state and of its generator's
    optimizer state, and the generator's layout (`_layout_facts`)."""
    from cfgan_torch.convert import adam_moments_to_flax, train_state_to_flax
    from cfgan_torch.core import checkpoint as ckpt
    from cfgan_torch.parallel import channel_sharding_spec, shard_leaves
    from cfgan_torch.parallel.sharding import (
        _optimizer_tensors,
        replicas_equal,
    )

    meshes, out = {}, {}
    for job in jobs:
        shape = job.get("mesh")
        key = None if shape is None else tuple(shape)
        if key not in meshes:  # every rank makes the meshes in one order
            meshes[key] = mesh_of(shape)
        mesh = meshes[key]
        d = load_npz(job["npz"])

        def fresh():
            b = build(job["family"], job["cfg"], d)
            replicate(mesh, b.state)
            if shape is not None:
                shard_leaves(b.state.g, channel_sharding_spec(mesh,
                                                              b.state.g))
            return b

        b = fresh()
        steps = [d["steps"][str(i)] for i in range(len(d["steps"]))]
        first = 0
        if job.get("restore"):
            ckpt.restore_sharded(job["restore"], b.state)
            first = 1
        metrics, moments = [], None
        for i in range(first, len(steps)):
            metrics.append(_floats(_step2d(b, steps[i])))
            if i == 0:
                moments = adam_moments_to_flax(b.state)
            if i == 0 and job.get("save"):
                ckpt.save_sharded(job["save"], b.state, {"epoch": 0})
                plain = build(job["family"], job["cfg"], d)
                replicate(mesh, plain.state)
                ckpt.restore_sharded(job["save"], plain.state)
                ckpt.save_sharded(job["save"] + "-replicated", plain.state,
                                  {"epoch": 0})
        out[job["name"]] = {
            "metrics": metrics, "moments": moments,
            "state": train_state_to_flax(b.state),
            "equal": replicas_equal(b.state), "step": b.state.step,
            "state_bytes": sum(t.numel() * t.element_size()
                               for t in state_tensors(b.state)),
            "g_opt_bytes": sum(t.numel() * t.element_size()
                               for t in _optimizer_tensors(b.state.g.opt)),
            "layout": _layout_facts(b.state.g)}
    return out
