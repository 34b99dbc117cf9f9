"""Promptable counterfactual serving engine (mirrors
`cfgan/serve/engine.py::CounterfactualEngine`), for image engines (NHWC
requests) and tabular ones ((B, D) requests, with a feature schema).

One request is one call of the generator, the float32 clamp and the
classifier on the engine's device, under `torch.inference_mode`.  Request
batches are padded up to a power-of-two bucket (cap 512) by repeating the
last row, and the padded rows are sliced off the results, exactly as in
the JAX engine.  Padding changes no value: the MNIST `cf_fn` is
deterministic per row, and the tabular one derives each row's Gumbel
noise from (key, head, row) alone.  A request's key is a JAX key pair
(`cfgan_torch.models.tabular.jax_key`), `jax_key(0)` when none is given;
`generate_bulk` serves chunk i with `fold_in(key, i)`, as the JAX engine
does.  Configuration is construct-then-serve: once the first request has
been served, assigning `pad_to_bucket` raises.

A constructed engine may be shared by request threads: `generate` and
`classify` read only the frozen modules and their arguments.

`shard(mesh, axis)` serves data-parallel over this process's devices of a
mesh along one of its axes (the JAX engine's `shard`): the batch padding
rises to a multiple of the shard count, each request and each bulk chunk
is cut into equal shards, one an entry of the axis, each served by a
replica of the generator and classifier on the first device of its row
(the device at that index of the axis and 0 on every other), and the
results are gathered.  Each shard's `cf_fn` call gets `row0`, the
index of its first row in the request, so that the tabular generator's
per-row noise is the unsharded request's.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from cfgan_torch.core.device import resolve_device
from cfgan_torch.masks.feature import (
    feature_names_to_mask,
    immutable_complement_mask,
)
from cfgan_torch.masks.patch import patch_indices_to_mask
from cfgan_torch.models.tabular import fold_in, jax_key
from cfgan_torch.parallel.mesh import canonical_device, ravel


@dataclass
class CFResult:
    x_cf: np.ndarray
    residual: np.ndarray
    pred: np.ndarray  # (B,) argmax class of the counterfactual
    confidence: np.ndarray  # (B,) max prob
    probs: np.ndarray  # (B, C)
    probs_orig: np.ndarray  # (B, C)
    flipped: np.ndarray  # (B,) bool, pred == target


def _pad_rows(a: torch.Tensor, n: int) -> torch.Tensor:
    """Pad the batch to `n` rows by repeating the last row."""
    if n == a.shape[0]:
        return a
    return torch.cat([a, a[-1:].expand(n - a.shape[0], *a.shape[1:])], 0)


class CounterfactualEngine:
    """Fused (x, target, mask) -> counterfactual endpoint."""

    _MAX_BUCKET = 512

    def __init__(self, cf_fn: Callable, clf_fn: Callable, num_classes: int,
                 patch_size: int | None = None, schema=None,
                 device: str | torch.device | None = None, stats=None,
                 replica_fn: Callable | None = None):
        """`cf_fn(x, target, mask, key)` -> (x_cf, raw, masked) and
        `clf_fn(x)` -> logits run on `device` (None: the CUDA card; raises
        where there is none).  A tabular engine carries its `schema`
        (`TabularSchema`) and may carry the MinMax `stats` (`NormStats`)
        that map its [0, 1] data space back to the features' units; the
        engine itself does not read them.  `replica_fn(device) -> (cf_fn,
        clf_fn)` makes the same model's functions on another device, for
        `shard` over a mesh of several devices."""
        self.cf_fn = cf_fn
        self.clf_fn = clf_fn
        self.num_classes = num_classes
        self.patch_size = patch_size
        self.schema = schema
        self.stats = stats
        self.device = resolve_device(device)
        self.replica_fn = replica_fn
        self._pad_to_bucket = True
        self._shards: list[tuple[torch.device, Callable, Callable]] = []
        self._served = threading.Event()

    # ---------------------------------------------------------- config
    @property
    def pad_to_bucket(self) -> bool:
        return self._pad_to_bucket

    @pad_to_bucket.setter
    def pad_to_bucket(self, value: bool) -> None:
        if self._served.is_set():
            raise RuntimeError(
                "cannot change pad_to_bucket: the engine has already served "
                "requests (configuration is construct-then-serve)")
        self._pad_to_bucket = bool(value)

    def shard(self, mesh, axis: str | None = None
              ) -> "CounterfactualEngine":
        """Serve data-parallel over this process's devices of `mesh`
        (`cfgan_torch.parallel.create_mesh`) along `axis` (the mesh's
        first by default): `mesh.axis_size(axis)` shards, shard i on the
        device at index i of `axis` and 0 on every other axis; returns
        self.  A device other than the engine's gets a replica from
        `replica_fn`; the engine's own device (every entry of
        `devices=["cpu"] * 8`, say) serves with its own functions.
        Raises RuntimeError after the first served request, ValueError
        for a mesh over more than one process (the engine serves the
        devices of its process) or an axis the mesh does not have."""
        if self._served.is_set():
            raise RuntimeError(
                "cannot change sharding: the engine has already served "
                "requests (configuration is construct-then-serve)")
        axis = axis or mesh.axis_names[0]
        if axis not in mesh.axis_names:
            raise ValueError(f"the mesh has no axis {axis!r}: its axes are "
                             f"{mesh.axis_names}")
        if mesh.world_size > 1:
            raise ValueError(
                f"the engine serves this process's devices; a mesh over "
                f"{mesh.world_size} processes would need every rank to "
                "serve each request")
        dim = mesh.axis_names.index(axis)
        first = [0] * len(mesh.shape)
        shards, replicas = [], {}
        for i in range(mesh.shape[dim]):
            first[dim] = i
            dev = canonical_device(mesh.devices[ravel(first, mesh.shape)])
            if dev == canonical_device(self.device):
                shards.append((dev, self.cf_fn, self.clf_fn))
                continue
            if dev not in replicas:
                if self.replica_fn is None:
                    raise ValueError(
                        f"this engine cannot place a replica on {dev}: "
                        "construct it with a replica_fn")
                replicas[dev] = self.replica_fn(dev)
            shards.append((dev, *replicas[dev]))
        self._shards = shards
        return self

    @classmethod
    def _bucket(cls, b: int) -> int:
        n = 1
        while n < b:
            n <<= 1
        if n <= cls._MAX_BUCKET:
            return n
        return -(-b // cls._MAX_BUCKET) * cls._MAX_BUCKET

    # ------------------------------------------------------- inference
    def _serve(self, x, t, mask, key):
        if not self._shards:
            return self._serve_on(self.cf_fn, self.clf_fn, x, t, mask, key)
        m = x.shape[0] // len(self._shards)
        outs = [self._serve_on(
            cf_fn, clf_fn, *(a[i * m:(i + 1) * m].to(dev)
                             for a in (x, t, mask)), key, row0=i * m)
            for i, (dev, cf_fn, clf_fn) in enumerate(self._shards)]
        return tuple(torch.cat([o[k].to(self.device) for o in outs])
                     for k in range(4))

    @staticmethod
    def _serve_on(cf_fn, clf_fn, x, t, mask, key, **row0):
        x_cf, _, masked = cf_fn(x, t, mask, key, **row0)
        probs = torch.softmax(clf_fn(x_cf), dim=1)
        probs_orig = torch.softmax(clf_fn(x), dim=1)
        return x_cf, masked, probs, probs_orig

    def _targets(self, target) -> torch.Tensor:
        """`target` as int64 on the device, its range checked on the host
        first: a target outside [0, num_classes) raises ValueError.  (The
        JAX engine serves NaN for such a target and wraps a negative one;
        on the card the embedding lookup would hit a device-side assert.)"""
        t = torch.as_tensor(target, dtype=torch.long, device="cpu")
        bad = (t < 0) | (t >= self.num_classes)
        if bad.any():
            raise ValueError(
                f"target {t[bad].flatten()[0].item()} is outside the class "
                f"range [0, {self.num_classes})")
        return t.to(self.device)

    def _batch(self, x) -> torch.Tensor:
        """x as float32 on the device, one sample ((H, W, C) or (D,))
        made a batch of one."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if x.ndim in (1, 3):
            x = x[None]
        if x.ndim not in (2, 4):
            raise ValueError(f"x must be (H, W, C), (B, H, W, C), (D,) or "
                             f"(B, D), got shape {tuple(x.shape)}")
        return x

    def _inputs(self, x, target, mask):
        """Batch the request on the device: x float32 (B, H, W, C) or
        (B, D), target broadcast to (B,), mask broadcast to x's shape."""
        x = self._batch(x)
        b = x.shape[0]
        t = torch.broadcast_to(self._targets(target), (b,))
        if mask is None:
            mask = self.default_mask(b, x.shape)
        mask = torch.as_tensor(mask, dtype=x.dtype, device=self.device)
        if mask.ndim == x.ndim - 1:
            mask = mask[None]
        # broadcast BEFORE padding: a (1, ...) mask must become (B, ...)
        return x, t, mask.expand(x.shape)

    @staticmethod
    def _result(x_cf, residual, probs, probs_orig, t) -> CFResult:
        pred = torch.argmax(probs, dim=1)
        return CFResult(
            x_cf=x_cf.cpu().numpy(), residual=residual.cpu().numpy(),
            pred=pred.cpu().numpy(),
            confidence=probs.max(dim=1).values.cpu().numpy(),
            probs=probs.cpu().numpy(), probs_orig=probs_orig.cpu().numpy(),
            flipped=(pred == t).cpu().numpy())

    @torch.inference_mode()
    def classify(self, x) -> np.ndarray:
        """Class probabilities of x."""
        self._served.set()
        return torch.softmax(self.clf_fn(self._batch(x)), dim=1).cpu().numpy()

    @torch.inference_mode()
    def generate(self, x, target, mask=None, key=None) -> CFResult:
        """Batched counterfactual generation.  `target` may be an int
        (broadcast) or a per-sample array; `mask` defaults to
        `default_mask`; `key` (default `jax_key(0)`) seeds a tabular
        generator's noise and is ignored by the MNIST one."""
        self._served.set()
        x, t, mask = self._inputs(x, target, mask)
        key = jax_key(0) if key is None else key
        b = x.shape[0]
        nb = self._bucket(b) if self._pad_to_bucket else b
        k = len(self._shards) or 1  # equal shards
        nb = -(-nb // k) * k
        outs = self._serve(_pad_rows(x, nb), _pad_rows(t, nb),
                           _pad_rows(mask, nb), key)
        return self._result(*(o[:b] for o in outs), t)

    @torch.inference_mode()
    def generate_bulk(self, x, target, mask=None, key=None,
                      chunk: int = 128) -> CFResult:
        """Offline/bulk generation: the batch is cut into fixed-size chunks
        and chunk i is one serving call with key `fold_in(key, i)`; results
        stay on the device until the last chunk.  As in the JAX engine,
        the chunk count is padded to a power of two by repeating the last
        row.  On a sharded engine the chunk must split evenly over the
        shards (ValueError)."""
        if chunk % (len(self._shards) or 1):
            raise ValueError(f"bulk chunk size {chunk} must be a multiple of "
                             f"the mesh batch-axis size {len(self._shards)}")
        self._served.set()
        x, t, mask = self._inputs(x, target, mask)
        key = jax_key(0) if key is None else key
        b = x.shape[0]
        nc = 1
        while nc < -(-b // chunk):
            nc <<= 1
        xp, tp, mp = (_pad_rows(a, nc * chunk) for a in (x, t, mask))
        outs = [self._serve(xp[i * chunk:(i + 1) * chunk],
                            tp[i * chunk:(i + 1) * chunk],
                            mp[i * chunk:(i + 1) * chunk], fold_in(key, i))
                for i in range(nc)]
        return self._result(*(torch.cat(o)[:b] for o in zip(*outs)), t)

    # ----------------------------------------------------------- masks
    def default_mask(self, batch: int, x_shape) -> torch.Tensor:
        """All-ones; a tabular engine zeroes its immutable features."""
        if self.schema is not None and len(x_shape) == 2:
            return immutable_complement_mask(batch, x_shape[1],
                                             self.schema.immutable_idx,
                                             device=self.device)
        return torch.ones((batch, *tuple(x_shape)[1:]), dtype=torch.float32,
                          device=self.device)

    def mask_from_feature_names(self, allowed: Sequence[str],
                                batch: int) -> torch.Tensor:
        """A request's mask from the features it allows (immutable ones
        stay 0)."""
        if self.schema is None:
            raise ValueError("engine has no schema (not a tabular engine)")
        return feature_names_to_mask(allowed, batch, self.schema,
                                     device=self.device)

    def mask_from_patches(self, patch_indices: Sequence[int], batch: int,
                          image_hw: tuple[int, int],
                          channels: int = 1) -> torch.Tensor:
        if self.patch_size is None:
            raise ValueError("engine has no patch_size (not an image engine)")
        return patch_indices_to_mask(patch_indices, batch, image_hw,
                                     self.patch_size, channels,
                                     device=self.device)
