"""Datasets and their normalization (mirrors `cfgan/data`)."""
from cfgan_torch.data.transforms import (
    NormStats,
    fit_minmax,
    image_denormalize,
    image_normalize,
)
from cfgan_torch.data.registry import load_dataset

__all__ = [
    "NormStats",
    "fit_minmax",
    "image_denormalize",
    "image_normalize",
    "load_dataset",
]
