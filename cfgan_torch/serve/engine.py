"""Promptable counterfactual serving engine (mirrors
`cfgan/serve/engine.py::CounterfactualEngine` for image engines).

One request is one call of the generator, the float32 clamp and the
classifier on the engine's device, under `torch.inference_mode`.  Request
batches are padded up to a power-of-two bucket (cap 512) by repeating the
last row, and the padded rows are sliced off the results, exactly as in
the JAX engine; the MNIST `cf_fn` is deterministic per row, so padding
changes no value.  Configuration is construct-then-serve: once the first
request has been served, assigning `pad_to_bucket` raises.

A constructed engine may be shared by request threads: `generate` and
`classify` read only the frozen modules and their arguments.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from cfgan_torch.core.device import resolve_device
from cfgan_torch.masks.patch import patch_indices_to_mask


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
                 patch_size: int | None = None,
                 device: str | torch.device | None = None):
        """`cf_fn(x, target, mask, key)` -> (x_cf, raw, masked) and
        `clf_fn(x)` -> logits run on `device` (None: the CUDA card; raises
        where there is none)."""
        self.cf_fn = cf_fn
        self.clf_fn = clf_fn
        self.num_classes = num_classes
        self.patch_size = patch_size
        self.device = resolve_device(device)
        self._pad_to_bucket = True
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

    @classmethod
    def _bucket(cls, b: int) -> int:
        n = 1
        while n < b:
            n <<= 1
        if n <= cls._MAX_BUCKET:
            return n
        return -(-b // cls._MAX_BUCKET) * cls._MAX_BUCKET

    # ------------------------------------------------------- inference
    def _serve(self, x, t, mask):
        x_cf, _, masked = self.cf_fn(x, t, mask)
        probs = torch.softmax(self.clf_fn(x_cf), dim=1)
        probs_orig = torch.softmax(self.clf_fn(x), dim=1)
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

    def _inputs(self, x, target, mask):
        """Batch the request on the device: x float32 (B, H, W, C), target
        broadcast to (B,), mask broadcast to x's shape."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if x.ndim == 3:
            x = x[None]
        if x.ndim != 4:
            raise ValueError(f"x must be (H, W, C) or (B, H, W, C), got "
                             f"shape {tuple(x.shape)}")
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
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if x.ndim == 3:
            x = x[None]
        return torch.softmax(self.clf_fn(x), dim=1).cpu().numpy()

    @torch.inference_mode()
    def generate(self, x, target, mask=None, key=None) -> CFResult:
        """Batched counterfactual generation.  `target` may be an int
        (broadcast) or a per-sample array; `mask` defaults to all-ones.
        `key` is accepted for the JAX engine's signature and ignored: the
        MNIST generator draws no noise."""
        self._served.set()
        x, t, mask = self._inputs(x, target, mask)
        b = x.shape[0]
        nb = self._bucket(b) if self._pad_to_bucket else b
        outs = self._serve(_pad_rows(x, nb), _pad_rows(t, nb),
                           _pad_rows(mask, nb))
        return self._result(*(o[:b] for o in outs), t)

    @torch.inference_mode()
    def generate_bulk(self, x, target, mask=None, key=None,
                      chunk: int = 128) -> CFResult:
        """Offline/bulk generation: the batch is cut into fixed-size chunks
        and each chunk is one serving call; results stay on the device
        until the last chunk.  As in the JAX engine, the chunk count is
        padded to a power of two by repeating the last row."""
        self._served.set()
        x, t, mask = self._inputs(x, target, mask)
        b = x.shape[0]
        nc = 1
        while nc < -(-b // chunk):
            nc <<= 1
        xp, tp, mp = (_pad_rows(a, nc * chunk) for a in (x, t, mask))
        outs = [self._serve(xp[i:i + chunk], tp[i:i + chunk],
                            mp[i:i + chunk])
                for i in range(0, nc * chunk, chunk)]
        return self._result(*(torch.cat(o)[:b] for o in zip(*outs)), t)

    # ----------------------------------------------------------- masks
    def default_mask(self, batch: int, x_shape) -> torch.Tensor:
        return torch.ones((batch, *tuple(x_shape)[1:]), dtype=torch.float32,
                          device=self.device)

    def mask_from_patches(self, patch_indices: Sequence[int], batch: int,
                          image_hw: tuple[int, int],
                          channels: int = 1) -> torch.Tensor:
        if self.patch_size is None:
            raise ValueError("engine has no patch_size (not an image engine)")
        return patch_indices_to_mask(patch_indices, batch, image_hw,
                                     self.patch_size, channels,
                                     device=self.device)
