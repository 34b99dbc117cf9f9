"""Carry the JAX package's flax variables over to the port's modules.

`state_dict_from_flax(module, variables)` turns `{"params": ...,
"batch_stats": ...}` trees of numpy arrays, as the JAX package's models
hold them, into a state dict for the port's `module`, with the layouts of
`cfgan/testing/oracles.py`: a Linear kernel (in, out) is transposed to
torch's (out, in); a conv kernel (3, 3, Cin, Cout) becomes OIHW for a
layer on `F.conv2d` and stays HWIO for a layer routed to the 3x3 kernel,
which is the kernel's layout.  A flax `Conv` wraps its parameters in a
child scope `Conv_0`; the port's `Conv` holds them itself.
"""
from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np
import torch
from torch import nn

from cfgan_torch.nn.layers import BatchNorm, Conv, Embed, Linear


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
