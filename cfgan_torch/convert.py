"""Carry the JAX package's flax variables over to the port's modules.

`state_dict_from_flax(module, variables)` turns `{"params": ...,
"batch_stats": ...}` trees of numpy arrays, as the JAX package's models
hold them, into a state dict for the port's `module`, with the layouts of
`cfgan/testing/oracles.py`: a Linear kernel (in, out) is transposed to
torch's (out, in); a conv kernel (3, 3, Cin, Cout) becomes OIHW for a
layer on `F.conv2d` and stays HWIO for a layer routed to the 3x3 kernel,
which is the kernel's layout.  A flax `Conv` wraps its parameters in a
child scope `Conv_0`; the port's `Conv` holds them itself.  A
`ConvTranspose` kernel, flax's `transpose_kernel=True` (k, k, out, in)
under the child scope `ConvTranspose_0`, becomes torch's (in, out, k, k)
by `transpose(3, 2, 0, 1)`, with no spatial flip.  An `InstanceNorm`'s
`scale` is its `weight`.

A `SpectralLinear`'s power-iteration vector is the `u` buffer here and
`spectral_stats/u` there.

The state dict's tensors are contiguous, in the module's own layout.
`flax_from_state_dict` is the reverse direction, and `load_gan_state` /
`gan_state_to_flax` carry a whole CounteRGAN train state (generator and
discriminator parameters, the generator's batch statistics, a spectral
critic's `u` and the EMA) across, so that the parity tests can start both packages from the same
weights and compare them leaf by leaf after N steps;
`adam_moments_to_flax` gives the optimizers' first moments in the same
layout, to compare gradients.  `train_state_to_flax` / `load_train_state`
carry everything a mid-run checkpoint holds, Adam's count and both
moments included, in the layout of the JAX package's `GANState` state
dict (`cfgan_torch.core.checkpoint.save_train_state`).  A net
channel-sharded over a mesh (`cfgan_torch.parallel.shard_leaves`) gives
and takes whole leaves: its moments' slices are gathered over the mesh on
the way out (a collective, which every rank of the mesh calls) and each
rank's slices are cut on the way in.  `flax_axes` reads the layouts above
as a map from the flax leaf's dimensions to the port tensor's.
"""
from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np
import torch
from torch import nn

from cfgan_torch.nn.layers import (
    BatchNorm,
    Conv,
    ConvTranspose,
    Embed,
    InstanceNorm,
    Linear,
    SpectralLinear,
)
from cfgan_torch.train.state import GANState, NetState

# the child scope a flax layer wraps its parameters in, by port layer
_CHILD_SCOPES = {Conv: "Conv_0", ConvTranspose: "ConvTranspose_0"}


def _leaves(tree: Mapping, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (name,))
        else:
            yield path + (name,), value


def _convert(sub: nn.Module, collection: str, name: str,
             a: np.ndarray) -> tuple[str, np.ndarray] | None:
    """(port parameter name, array in the port's layout), or None where
    `sub` has no counterpart of the flax leaf."""
    if collection == "params":
        if isinstance(sub, (Linear, SpectralLinear)):
            return {"kernel": ("weight", a.T), "bias": ("bias", a)}.get(name)
        if isinstance(sub, Conv):
            if name == "kernel":
                return (("kernel", a) if sub.impl
                        else ("weight", a.transpose(3, 2, 0, 1)))
            return ("bias", a) if name == "bias" else None
        if isinstance(sub, ConvTranspose):
            if name == "kernel":
                return "weight", a.transpose(3, 2, 0, 1)
            return ("bias", a) if name == "bias" else None
        if isinstance(sub, (BatchNorm, InstanceNorm)):
            return {"scale": ("weight", a), "bias": ("bias", a)}.get(name)
        if isinstance(sub, Embed) and name == "embedding":
            return "weight", a
    elif collection == "batch_stats" and isinstance(sub, BatchNorm):
        return {"mean": ("running_mean", a),
                "var": ("running_var", a)}.get(name)
    elif (collection == "spectral_stats" and isinstance(sub, SpectralLinear)
          and name == "u"):
        return "u", a
    return None


def state_dict_from_flax(module: nn.Module,
                         variables: Mapping[str, Mapping],
                         params_only: bool = False
                         ) -> dict[str, torch.Tensor]:
    """A state dict for `module` from flax `variables` of numpy arrays
    (with `params_only`, of its parameters alone, from `{"params": ...}`).
    Raises KeyError on a flax leaf the module has no place for (an extra
    key) and on a module entry no leaf fills (a missing key), and
    ValueError on a shape that does not match."""
    subs = dict(module.named_modules())
    out: dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        for path, leaf in _leaves(tree):
            where = f"{collection}/{'/'.join(path)}"
            scope = path[:-1]
            if scope and scope[-1] == _CHILD_SCOPES.get(
                    type(subs.get(".".join(scope[:-1])))):
                scope = scope[:-1]
            prefix = ".".join(scope)
            sub = subs.get(prefix)
            got = (None if sub is None else
                   _convert(sub, collection, path[-1], np.asarray(leaf)))
            if got is None:
                raise KeyError(f"extra key {where}: the port's "
                               f"{type(module).__name__} has no place for it")
            key = f"{prefix}.{got[0]}" if prefix else got[0]
            # contiguous, as the module's own tensors are: cuBLAS picks its
            # kernel by layout, so a transposed kernel would round its
            # products otherwise
            out[key] = torch.tensor(np.ascontiguousarray(got[1]))
    expected = (dict(module.named_parameters()) if params_only
                else module.state_dict())
    missing = sorted(expected.keys() - out.keys())
    if missing:
        raise KeyError(f"missing keys: no flax leaf fills {missing}")
    extra = sorted(out.keys() - expected.keys())
    if extra:
        raise KeyError(f"extra keys: the port has no {extra}")
    for key, value in out.items():
        if value.shape != expected[key].shape:
            raise ValueError(f"{key}: flax gives {tuple(value.shape)}, the "
                             f"port holds {tuple(expected[key].shape)}")
    return out


def _to_flax(sub: nn.Module, name: str, t: np.ndarray
             ) -> tuple[str, tuple[str, ...], np.ndarray] | None:
    """(collection, leaf path under the module's scope, array in the flax
    layout) of the port's entry `name` of `sub`; the inverse of
    `_convert`."""
    if isinstance(sub, (Linear, SpectralLinear)):
        return {"weight": ("params", ("kernel",), t.T),
                "bias": ("params", ("bias",), t),
                "u": ("spectral_stats", ("u",), t)}.get(name)
    if isinstance(sub, Conv):
        if name == "weight":  # OIHW -> HWIO
            return "params", ("Conv_0", "kernel"), t.transpose(2, 3, 1, 0)
        return {"kernel": ("params", ("Conv_0", "kernel"), t),
                "bias": ("params", ("Conv_0", "bias"), t)}.get(name)
    if isinstance(sub, ConvTranspose):
        if name == "weight":  # (in, out, k, k) -> (k, k, out, in)
            return ("params", ("ConvTranspose_0", "kernel"),
                    t.transpose(2, 3, 1, 0))
        return (("params", ("ConvTranspose_0", "bias"), t) if name == "bias"
                else None)
    if isinstance(sub, InstanceNorm):
        return {"weight": ("params", ("scale",), t),
                "bias": ("params", ("bias",), t)}.get(name)
    if isinstance(sub, BatchNorm):
        return {"weight": ("params", ("scale",), t),
                "bias": ("params", ("bias",), t),
                "running_mean": ("batch_stats", ("mean",), t),
                "running_var": ("batch_stats", ("var",), t)}.get(name)
    if isinstance(sub, Embed) and name == "weight":
        return "params", ("embedding",), t
    return None


def flax_axes(module: nn.Module, name: str, ndim: int) -> tuple[int, ...]:
    """For each dimension of the flax leaf of `module`'s state dict entry
    `name` (a tensor of `ndim` dimensions), the dimension of the port's
    tensor it is laid out from: the transposes of `_to_flax`, read off a
    probe array whose dimensions have distinct lengths."""
    prefix, _, leaf = name.rpartition(".")
    sub = dict(module.named_modules()).get(prefix)
    probe = np.empty(tuple(range(2, ndim + 2)), np.float32)
    got = None if sub is None else _to_flax(sub, leaf, probe)
    if got is None:
        raise KeyError(f"{name}: no flax counterpart")
    return tuple(n - 2 for n in got[2].shape)


def flax_from_state_dict(module: nn.Module,
                         state_dict: Mapping[str, torch.Tensor]) -> dict:
    """Nested numpy dicts in the flax layout, `{"params": ...,
    "batch_stats": ...}`, from entries of `module`'s state dict (all of
    them, or a subset such as the parameters alone).  Raises KeyError on an
    entry the flax layout has no place for."""
    subs = dict(module.named_modules())
    out: dict = {}
    for key, value in state_dict.items():
        prefix, _, name = key.rpartition(".")
        sub = subs.get(prefix)
        got = (None if sub is None else
               _to_flax(sub, name, np.array(value.detach().float().cpu())))
        if got is None:
            raise KeyError(f"{key}: no flax counterpart")
        collection, leaf, array = got
        node = out.setdefault(collection, {})
        scope = prefix.split(".") if prefix else []
        for part in (*scope, *leaf[:-1]):
            node = node.setdefault(part, {})
        node[leaf[-1]] = array
    return out


def load_gan_state(state: GANState, variables: Mapping) -> None:
    """Load a JAX `GANState`, as numpy trees, into the port's `state` in
    place: `variables = {"g": {"params": ..., "batch_stats": ...}, "d":
    {"params": ...}, "g_ema": params or None}`.  Strict, as
    `state_dict_from_flax` is; the optimizers' moments are left as they
    are (a fresh JAX state's are zeros, a fresh torch Adam's empty)."""
    g, d = state.g.model, state.d.model
    g.load_state_dict(state_dict_from_flax(g, variables["g"]), strict=True)
    d.load_state_dict(state_dict_from_flax(d, variables["d"]), strict=True)
    for ns in (state.g, state.d):
        if ns.layout is not None:
            ns.layout.cut()
    if (variables.get("g_ema") is None) != (state.g_ema is None):
        raise ValueError("one state carries a generator EMA, the other not")
    if state.g_ema is not None:
        ema = state_dict_from_flax(g, {**variables["g"],
                                       "params": variables["g_ema"]})
        with torch.no_grad():
            for name, t in state.g_ema.items():
                t.copy_(ema[name])


def gan_state_to_flax(state: GANState) -> dict:
    """The port's train state as numpy trees in the layout `load_gan_state`
    reads."""
    g, d = state.g.model, state.d.model
    return {"g": flax_from_state_dict(g, g.state_dict()),
            "d": flax_from_state_dict(d, d.state_dict()),
            "g_ema": (None if state.g_ema is None else
                      flax_from_state_dict(g, state.g_ema)["params"])}


def _adam_leaf(opt: torch.optim.Optimizer, p: torch.Tensor, key: str):
    state = opt.state.get(p, {})
    return state[key] if key in state else torch.zeros_like(p)


def _adam_leaves(ns: NetState, key: str) -> dict[str, torch.Tensor]:
    """Adam's tensor `key` of each parameter, by name, whole (a
    channel-sharded net's slices gathered: every rank of its mesh calls
    this)."""
    leaves = {name: _adam_leaf(ns.opt, p, key)
              for name, p in ns.opt_params().items()}
    return leaves if ns.layout is None else ns.layout.gather_leaves(leaves)


def adam_moments_to_flax(state: GANState) -> dict:
    """Adam's first moments (`exp_avg`) of both networks as flax params
    trees of numpy arrays, `{"g": ..., "d": ...}`, the layout of optax's
    `mu`.  A parameter that has taken no step has none yet; its entry is
    zero, as optax's is."""
    return {net: flax_from_state_dict(
        getattr(state, net).model,
        _adam_leaves(getattr(state, net), "exp_avg"))["params"]
        for net in ("g", "d")}


def adam_state_to_flax(ns: NetState) -> dict:
    """One network's Adam state in the layout of optax.adam's state dict,
    `{"0": {"count", "mu", "nu"}, "1": {}}`: torch's per-parameter step
    is optax's one count (int32), `exp_avg` / `exp_avg_sq` its moments.
    A parameter that has taken no step has zero moments, as optax's."""
    params = ns.opt_params()
    steps = {int(ns.opt.state[p]["step"]) for p in params.values()
             if "step" in ns.opt.state.get(p, {})}
    if len(steps) > 1:
        raise ValueError(f"parameters took different step counts {steps}")
    moments = {name: flax_from_state_dict(
        ns.model, _adam_leaves(ns, key))["params"]
        for name, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}
    count = np.array(steps.pop() if steps else 0, np.int32)
    return {"0": {"count": count, **moments}, "1": {}}


def load_adam_state(ns: NetState, tree: Mapping) -> None:
    """Copy an optax.adam state dict (`adam_state_to_flax`'s layout) into
    `ns.opt` in place: existing step and moment tensors are overwritten,
    missing ones are made (on the device for a capturable optimizer, as
    torch makes them); a channel-sharded net takes this rank's slices of
    the moments."""
    count = float(np.asarray(tree["0"]["count"]))
    moments = {key: state_dict_from_flax(ns.model, {"params": tree["0"][name]},
                                         params_only=True)
               for name, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}
    if ns.layout is not None:
        for values in moments.values():
            for name in ns.layout.shards:
                values[name] = ns.layout.slice_of(name, values[name])
    capturable = ns.opt.defaults.get("capturable", False)
    with torch.no_grad():
        for name, p in ns.opt_params().items():
            state = ns.opt.state[p]
            if "step" not in state:
                state["step"] = torch.zeros(
                    (), dtype=torch.float32,
                    device=p.device if capturable else "cpu")
                for key in ("exp_avg", "exp_avg_sq"):
                    state[key] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            state["step"].fill_(count)
            for key, values in moments.items():
                state[key].copy_(values[name])


def _net_tree(net: nn.Module, state_dict) -> dict:
    """`{"params", "stats"}` of a `NetState`: the stats are the other
    collections (batch_stats, spectral_stats), none for a stateless
    net."""
    tree = flax_from_state_dict(net, state_dict)
    return {"params": tree.pop("params"), "stats": tree}


def train_state_to_flax(state: GANState) -> dict:
    """The whole train state as the JAX package's `GANState` state dict:
    `{"g": {"params", "stats", "opt_state"}, "d": {...}, "step": int32,
    "g_ema": params or None}`, numpy leaves (whole leaves of a
    channel-sharded net: every rank of its mesh calls this)."""
    out = {}
    for net in ("g", "d"):
        ns = getattr(state, net)
        out[net] = {**_net_tree(ns.model, ns.model.state_dict()),
                    "opt_state": adam_state_to_flax(ns)}
    out["step"] = np.array(state.step, np.int32)
    out["g_ema"] = (None if state.g_ema is None else
                    flax_from_state_dict(state.g.model, state.g_ema)["params"])
    return out


def load_train_state(state: GANState, tree: Mapping) -> None:
    """Copy a `train_state_to_flax` tree (either package's) into `state`
    in place: module parameters and buffers by `load_state_dict` (which
    copies), the EMA and Adam's tensors by `copy_`, so that tensors a
    captured CUDA graph reads keep their addresses."""
    load_gan_state(state, {
        "g": {"params": tree["g"]["params"], **tree["g"]["stats"]},
        "d": {"params": tree["d"]["params"], **tree["d"]["stats"]},
        "g_ema": tree["g_ema"]})
    for net in ("g", "d"):
        load_adam_state(getattr(state, net), tree[net]["opt_state"])
    state.step = int(np.asarray(tree["step"]))
