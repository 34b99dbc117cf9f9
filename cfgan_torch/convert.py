"""Carry the JAX package's flax variables over to the port's modules.

`state_dict_from_flax(module, variables)` turns `{"params": ...,
"batch_stats": ...}` trees of numpy arrays, as the JAX package's models
hold them, into a state dict for the port's `module`, with the layouts of
`cfgan/testing/oracles.py`: a Linear kernel (in, out) is transposed to
torch's (out, in); a conv kernel (3, 3, Cin, Cout) becomes OIHW for a
layer on `F.conv2d` and stays HWIO for a layer routed to the 3x3 kernel,
which is the kernel's layout.  A flax `Conv` wraps its parameters in a
child scope `Conv_0`; the port's `Conv` holds them itself.

`flax_from_state_dict` is the reverse direction, and `load_gan_state` /
`gan_state_to_flax` carry a whole CounteRGAN train state (generator and
discriminator parameters, the generator's batch statistics and its EMA)
across, so that the parity tests can start both packages from the same
weights and compare them leaf by leaf after N steps;
`adam_moments_to_flax` gives the optimizers' first moments in the same
layout, to compare gradients.
"""
from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np
import torch
from torch import nn

from cfgan_torch.nn.layers import BatchNorm, Conv, Embed, Linear
from cfgan_torch.train.state import GANState


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
        if isinstance(sub, Linear):
            return {"kernel": ("weight", a.T), "bias": ("bias", a)}.get(name)
        if isinstance(sub, Conv):
            if name == "kernel":
                return (("kernel", a) if sub.impl
                        else ("weight", a.transpose(3, 2, 0, 1)))
            return ("bias", a) if name == "bias" else None
        if isinstance(sub, BatchNorm):
            return {"scale": ("weight", a), "bias": ("bias", a)}.get(name)
        if isinstance(sub, Embed) and name == "embedding":
            return "weight", a
    elif collection == "batch_stats" and isinstance(sub, BatchNorm):
        return {"mean": ("running_mean", a),
                "var": ("running_var", a)}.get(name)
    return None


def state_dict_from_flax(module: nn.Module,
                         variables: Mapping[str, Mapping]
                         ) -> dict[str, torch.Tensor]:
    """A state dict for `module` from flax `variables` of numpy arrays.
    Raises KeyError on a flax leaf the module has no place for (an extra
    key) and on a module entry no leaf fills (a missing key), and
    ValueError on a shape that does not match."""
    subs = dict(module.named_modules())
    out: dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        for path, leaf in _leaves(tree):
            where = f"{collection}/{'/'.join(path)}"
            scope = path[:-1]
            if (scope and scope[-1] == "Conv_0"
                    and isinstance(subs.get(".".join(scope[:-1])), Conv)):
                scope = scope[:-1]
            prefix = ".".join(scope)
            sub = subs.get(prefix)
            got = (None if sub is None else
                   _convert(sub, collection, path[-1], np.asarray(leaf)))
            if got is None:
                raise KeyError(f"extra key {where}: the port's "
                               f"{type(module).__name__} has no place for it")
            key = f"{prefix}.{got[0]}" if prefix else got[0]
            out[key] = torch.tensor(np.asarray(got[1]))
    expected = module.state_dict()
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
    if isinstance(sub, Linear):
        return {"weight": ("params", ("kernel",), t.T),
                "bias": ("params", ("bias",), t)}.get(name)
    if isinstance(sub, Conv):
        if name == "weight":  # OIHW -> HWIO
            return "params", ("Conv_0", "kernel"), t.transpose(2, 3, 1, 0)
        return {"kernel": ("params", ("Conv_0", "kernel"), t),
                "bias": ("params", ("Conv_0", "bias"), t)}.get(name)
    if isinstance(sub, BatchNorm):
        return {"weight": ("params", ("scale",), t),
                "bias": ("params", ("bias",), t),
                "running_mean": ("batch_stats", ("mean",), t),
                "running_var": ("batch_stats", ("var",), t)}.get(name)
    if isinstance(sub, Embed) and name == "weight":
        return "params", ("embedding",), t
    return None


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


def adam_moments_to_flax(state: GANState) -> dict:
    """Adam's first moments (`exp_avg`) of both networks as flax params
    trees of numpy arrays, `{"g": ..., "d": ...}`, the layout of optax's
    `mu`.  A parameter that has taken no step has none yet; its entry is
    zero, as optax's is."""
    out = {}
    for net in ("g", "d"):
        ns = getattr(state, net)
        mu = {name: ns.opt.state.get(p, {}).get("exp_avg",
                                                torch.zeros_like(p))
              for name, p in ns.model.named_parameters()}
        out[net] = flax_from_state_dict(ns.model, mu)["params"]
    return out
