"""Tabular feature masks (mirrors `cfgan/masks/feature.py`).

Training: per-feature Bernoulli(0.5) with the immutable features forced
to 0.  Eval and serving: all-ones apart from the immutable features, or
a user's allowed features.  Masks are float32 (B, D) tensors.  The
random masks take their 0/1 draws as an argument (`feature_mask_draws`
makes them from an explicit `torch.Generator`): JAX's PRNG gives other
numbers from the same seed, so the parity tests hand both the same
draws.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _row(dim: int, idx: Sequence[int], at_idx: float,
         device: str | torch.device | None) -> torch.Tensor:
    """A float32 (dim,) row: `at_idx` at the features `idx`, 1 - `at_idx`
    elsewhere."""
    row = torch.full((dim,), 1.0 - at_idx, dtype=torch.float32,
                     device=device)
    if len(idx):
        row[list(idx)] = at_idx
    return row


def feature_mask_draws(shape: tuple[int, ...], dim: int,
                       generator: torch.Generator) -> torch.Tensor:
    """0/1 integer draws of `random_feature_mask` for masks of leading
    `shape` ((B,) or (steps, B)), on the generator's device."""
    return torch.randint(0, 2, (*shape, dim), generator=generator,
                         device=generator.device)


def random_feature_mask(draws: torch.Tensor,
                        immutable_idx: Sequence[int] = (),
                        keep: torch.Tensor | None = None) -> torch.Tensor:
    """The (B, D) 0/1 `draws` as a float32 mask, immutable features 0.
    `keep`, the (D,) row `immutable_complement_mask(1, D, immutable_idx)`
    made beforehand on the draws' device, saves making it here (a CUDA
    graph's capture may not copy the indices from the host)."""
    if keep is None:
        keep = _row(draws.shape[-1], immutable_idx, 0.0, draws.device)
    return draws.to(torch.float32) * keep


def immutable_complement_mask(batch: int, dim: int,
                              immutable_idx: Sequence[int] = (),
                              device: str | torch.device | None = None
                              ) -> torch.Tensor:
    """All-ones (batch, dim) mask but the immutable features (the
    deterministic eval and serving mask)."""
    return _row(dim, immutable_idx, 0.0, device).expand(batch, dim)


def feature_names_to_mask(allowed: Sequence[str], batch: int, schema,
                          device: str | torch.device | None = None
                          ) -> torch.Tensor:
    """A request's mask from its allowed-feature list: 1 for the allowed
    mutable features, 0 elsewhere (unknown names are ignored, as the JAX
    package ignores them)."""
    idx = [schema.feature_names.index(f) for f in allowed
           if f in schema.feature_names
           and f not in schema.immutable_features]
    return _row(schema.input_dim, idx, 1.0, device).expand(
        batch, schema.input_dim)
