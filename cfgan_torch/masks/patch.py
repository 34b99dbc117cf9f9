"""Image patch-grid masks (mirrors `cfgan/masks/patch.py`).

The image is divided into a grid of patch_size x patch_size cells; a
patch-level mask is upsampled nearest-neighbour to pixel resolution.
Masks are float32 NHWC tensors.  The random training masks come with the
training slice.
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
