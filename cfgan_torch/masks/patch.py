"""Image patch-grid masks (mirrors `cfgan/masks/patch.py`).

The image is divided into a grid of patch_size x patch_size cells; a
patch-level mask is upsampled nearest-neighbour to pixel resolution.
Masks are float32 NHWC tensors.  The random training masks take their
random draws as an argument, or draw them from an explicit
`torch.Generator` on the mask's device: JAX's PRNG gives other numbers
from the same seed, so the parity tests hand both the same draws.
"""
from __future__ import annotations

from typing import Sequence

import torch


def patch_grid_dims(h: int, w: int, patch_size: int) -> tuple[int, int]:
    return h // patch_size, w // patch_size


def upsample_patch_mask(patch_mask: torch.Tensor, patch_size: int,
                        channels: int = 1) -> torch.Tensor:
    """(B, ph, pw) patch mask -> (B, ph*patch_size, pw*patch_size,
    channels) pixels, by integer-factor nearest-neighbour repeat."""
    m = patch_mask.repeat_interleave(patch_size, dim=1)
    m = m.repeat_interleave(patch_size, dim=2)
    return m[..., None].expand(*m.shape, channels)


def random_patch_mask(batch: int, image_hw: tuple[int, int],
                      patch_size: int, num_modifiable: int | None = None,
                      channels: int = 1, shared: bool = False,
                      draws: torch.Tensor | None = None,
                      generator: torch.Generator | None = None,
                      device: str | torch.device | None = None
                      ) -> torch.Tensor:
    """Random patch mask (`cfgan.masks.patch.random_patch_mask`).

    num_modifiable=None: iid Bernoulli(0.5) per patch.
    num_modifiable=k < total: exactly k modifiable patches per sample, the
    top k of uniform scores (ties at the k-th score all count, as in JAX).
    num_modifiable >= total: every patch modifiable.
    shared=True: one mask broadcast across the batch.

    `draws` are the (rows, ph*pw) uniform scores of the top-k case, or the
    0/1 integers of the Bernoulli case, with rows = 1 if `shared` else
    `batch`; without them they are drawn from `generator` on `device`."""
    h, w = image_hw
    ph, pw = patch_grid_dims(h, w, patch_size)
    total = ph * pw
    rows = 1 if shared else batch
    if draws is not None:
        device = draws.device
    if num_modifiable is not None and num_modifiable >= total:
        flat = torch.ones((rows, total), dtype=torch.float32, device=device)
    elif num_modifiable is None:
        if draws is None:
            draws = torch.randint(0, 2, (rows, total), generator=generator,
                                  device=device)
        flat = draws.to(torch.float32)
    else:
        if draws is None:
            draws = torch.rand((rows, total), generator=generator,
                               device=device)
        thresh = torch.topk(draws, num_modifiable, dim=1).values[:, -1:]
        flat = (draws >= thresh).to(torch.float32)
    flat = flat.expand(batch, total)
    return upsample_patch_mask(flat.reshape(batch, ph, pw), patch_size,
                               channels)


def with_ones_fraction(mask: torch.Tensor, frac: float,
                       draws: torch.Tensor | None = None,
                       generator: torch.Generator | None = None
                       ) -> torch.Tensor:
    """Replace each sample's mask by the all-ones mask with probability
    `frac` (`cfgan/train/builders.py::_with_ones_fraction`,
    `MaskConfig.ones_fraction`): sample i is replaced where its uniform
    draw `draws[i] < frac`, as `jax.random.bernoulli` decides.  Identity at
    0.0."""
    if not frac:
        return mask
    if draws is None:
        draws = torch.rand((mask.shape[0],), generator=generator,
                           device=mask.device)
    pick = (draws < frac).reshape((-1,) + (1,) * (mask.dim() - 1))
    return torch.where(pick, torch.ones_like(mask), mask)


def patch_indices_to_mask(patch_idx: Sequence[int], batch: int,
                          image_hw: tuple[int, int], patch_size: int,
                          channels: int = 1,
                          device: str | torch.device | None = None
                          ) -> torch.Tensor:
    """User-specified patch indices (row-major patch numbering; negative
    ones count from the end) -> the same pixel mask for every row of the
    batch.  Raises ValueError on an index outside the grid, where the JAX
    package drops it silently."""
    h, w = image_hw
    ph, pw = patch_grid_dims(h, w, patch_size)
    flat = torch.zeros(ph * pw, dtype=torch.float32, device=device)
    idx = [int(i) for i in patch_idx]
    bad = [i for i in idx if not -ph * pw <= i < ph * pw]
    if bad:
        raise ValueError(f"patch indices {bad} outside the {ph}x{pw} grid")
    if idx:
        flat[torch.tensor(idx, dtype=torch.long, device=device)] = 1.0
    flat = flat.expand(batch, ph * pw)
    return upsample_patch_mask(flat.reshape(batch, ph, pw), patch_size,
                               channels)
