"""Tabular residual assembly and the serving path's Gumbel noise (mirrors
`cfgan/models/tabular.py`).

`derive_gumbel_noise` reproduces the JAX package's per-row noise, which
JAX draws with its threefry2x32 generator: row i of head `idx` is
`gumbel(fold_in(fold_in(key, idx), i))`.  Here threefry2x32 runs in torch
integer ops (int64 tensors holding 32-bit words), on the device of the
rows, with JAX's partitionable bit layout (the word of element j is
`bits1 ^ bits2` of the counter pair (0, j)), its `uniform(tiny, 1)` and
`-log(-log(u))`.  The bits are JAX's exactly; the two logs agree to their
last ulp.  A key is JAX's raw pair of 32-bit words, `(hi, lo)`:
`jax_key(seed)` is `jax.random.key(seed)`'s.  Row i's noise depends on
(key, head, i) only, never on the batch, so padding a request cannot
change a row's counterfactual.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from cfgan_torch.core.device import resolve_device

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = {torch.float32: float(np.finfo(np.float32).tiny),
         torch.bfloat16: float(torch.finfo(torch.bfloat16).tiny)}

Key = tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """JAX's threefry2x32 block (20 rounds) on 32-bit words held in Python
    ints or int64 tensors (which broadcast); returns the two output
    words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + k0) & _M32, (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def jax_key(seed: int) -> Key:
    """The raw words of `jax.random.key(seed)` with JAX's 64-bit mode off,
    as the JAX package runs: the seed's low 32 bits."""
    return 0, seed & _M32


def fold_in(key: Key, data: int) -> Key:
    """`jax.random.fold_in(key, data)` on the host."""
    return threefry2x32(key[0], key[1], 0, data & _M32)


def _uniform_from_bits(bits: torch.Tensor, dtype: torch.dtype
                       ) -> torch.Tensor:
    """JAX's uniform draw behind `gumbel` from 32-bit words `bits`
    (int64): the mantissa bits under exponent 0 give u - 1 in [0, 1);
    then u = max(tiny, u).  bfloat16 has 7 mantissa bits, and JAX draws
    them from the low 8 bits of each word."""
    if dtype == torch.float32:
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    elif dtype == torch.bfloat16:
        f = (((bits & 0xFF) >> 1) | 0x3F80).to(torch.int16).view(
            torch.bfloat16)
    else:
        raise ValueError(f"no Gumbel noise in {dtype}")
    tiny = _TINY[dtype]
    return torch.clamp_min((f - 1.0) + tiny, tiny)


def _gumbel_from_bits(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """JAX's `gumbel` of 32-bit words `bits`: -log(-log(u))."""
    return -torch.log(-torch.log(_uniform_from_bits(bits, dtype)))


def gumbel_bits(key: Key, batch: int,
                categorical_info: Mapping[int, Sequence[float]],
                device: str | torch.device | None = None, row0: int = 0
                ) -> tuple[list[int], list[int], torch.Tensor]:
    """(heads, their sizes, the (batch, sum of sizes) 32-bit words as
    int64) that `derive_gumbel_noise` turns into noise."""
    device = resolve_device(device)
    heads = sorted(categorical_info)
    sizes = [len(categorical_info[i]) for i in heads]
    head_keys = [fold_in(key, i) for i in heads]
    hk0, hk1 = (torch.tensor([k[w] for k, n in zip(head_keys, sizes)
                              for _ in range(n)], dtype=torch.int64,
                             device=device) for w in (0, 1))
    col = torch.tensor([j for n in sizes for j in range(n)],
                       dtype=torch.int64, device=device)
    rows = torch.arange(row0, row0 + batch, dtype=torch.int64,
                        device=device)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    rk0, rk1 = threefry2x32(hk0, hk1, zero, rows)  # fold_in(head key, row)
    b0, b1 = threefry2x32(rk0, rk1, zero, col)
    return heads, sizes, b0 ^ b1


def derive_gumbel_noise(key: Key, batch: int,
                        categorical_info: Mapping[int, Sequence[float]],
                        dtype: torch.dtype = torch.float32,
                        device: str | torch.device | None = None,
                        row0: int = 0) -> dict[int, torch.Tensor]:
    """Feature index -> (batch, n_values) Gumbel noise, JAX's
    `derive_gumbel_noise(key, batch, categorical_info, dtype)`, computed
    on `device` (None: the CUDA card); with `row0`, the noise of rows
    row0 .. row0 + batch - 1 of a larger batch (a sharded request's
    shard).  All heads and rows go through threefry at once: the head
    keys on the host, the row keys and the bits as (batch, sum n)
    tensors (`gumbel_bits`)."""
    heads, sizes, bits = gumbel_bits(key, batch, categorical_info, device,
                                     row0)
    noise = _gumbel_from_bits(bits, dtype)
    return dict(zip(heads, noise.split(sizes, dim=1)))


def build_cat_norm_values(categorical_info: Mapping[int, Sequence[float]],
                          stats) -> dict[int, np.ndarray]:
    """Feature index -> the MinMax-normalized scalar of each category
    (float32), or evenly spaced in [0, 1] without `stats`."""
    out = {}
    for fidx, raw_vals in categorical_info.items():
        if stats is not None:
            out[fidx] = stats.normalize_values(fidx, raw_vals)
        else:
            n = len(raw_vals)
            out[fidx] = np.arange(n, dtype=np.float32) / max(1.0, n - 1)
    return out


class ResidualAssembly:
    """`assembly(x, cont_residual, cat_samples) -> (B, D) residual`, in x's
    dtype: the continuous residuals at `continuous_idx`; at each
    categorical feature, its sample's normalized value minus x there, so
    that x + residual lands on a category.

    Its index and value tensors are made once per device and dtype, at the
    first call: a CUDA graph's capture may not copy from the host."""

    def __init__(self, continuous_idx: Sequence[int],
                 cat_norm_values: Mapping[int, np.ndarray]):
        self.heads = sorted(cat_norm_values)
        self.cat_norm_values = cat_norm_values
        self.order = np.argsort(list(continuous_idx) + self.heads)
        self._consts: dict = {}

    def _constants(self, device, dtype):
        key = (device, dtype)
        if key not in self._consts:
            self._consts[key] = (
                [torch.as_tensor(self.cat_norm_values[f], dtype=dtype,
                                 device=device) for f in self.heads],
                torch.tensor(self.heads, dtype=torch.long, device=device),
                torch.tensor(self.order, dtype=torch.long, device=device))
        return self._consts[key]

    def __call__(self, x: torch.Tensor, cont_residual: torch.Tensor,
                 cat_samples: Mapping[int, torch.Tensor]) -> torch.Tensor:
        norm_vals, cat_idx, order = self._constants(x.device, x.dtype)
        cols = [cat_samples[f].to(x.dtype) @ v
                for f, v in zip(self.heads, norm_vals)]
        cat = torch.stack(cols, 1) - x.index_select(1, cat_idx)
        return torch.cat([cont_residual.to(x.dtype), cat], 1).index_select(
            1, order)


def assemble_residual(x: torch.Tensor, cont_residual: torch.Tensor,
                      cat_samples: Mapping[int, torch.Tensor],
                      continuous_idx: Sequence[int],
                      cat_norm_values: Mapping[int, np.ndarray]
                      ) -> torch.Tensor:
    """The full (B, D) residual in normalized feature space (JAX's
    `assemble_residual`; see `ResidualAssembly`)."""
    return ResidualAssembly(continuous_idx, cat_norm_values)(
        x, cont_residual, cat_samples)
