"""Patch-grid (image) and feature (tabular) masks (mirrors
`cfgan/masks`)."""
from cfgan_torch.masks.feature import (
    immutable_complement_mask,
    random_feature_mask,
)
from cfgan_torch.masks.patch import (
    patch_grid_dims,
    random_patch_mask,
    patch_indices_to_mask,
    upsample_patch_mask,
)

__all__ = [
    "random_feature_mask",
    "immutable_complement_mask",
    "patch_grid_dims",
    "random_patch_mask",
    "patch_indices_to_mask",
    "upsample_patch_mask",
]
