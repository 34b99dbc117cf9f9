"""MinMax normalization as checkpointable metadata, and the images'
[0, 1] <-> [-1, 1] mapping (mirrors `cfgan/data/transforms.py`:
`NormStats`, `fit_minmax`, `image_normalize`, `image_denormalize`), in
numpy.

The stats travel with the run dir's checkpoints as `{"data_min": [...],
"data_max": [...]}`, the JAX package's metadata dict, so either package
reads the other's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class NormStats(NamedTuple):
    """Feature-wise MinMax stats: x_norm = (x - min) / (max - min)."""

    data_min: np.ndarray
    data_max: np.ndarray

    @property
    def data_range(self):
        return self.data_max - self.data_min

    def transform(self, x) -> np.ndarray:
        """Rounded as the JAX package rounds it: x - min in numpy's float64,
        then rounded to float32 and divided in float32; a constant feature
        divides by 1."""
        rng = self.data_range
        shifted = (np.asarray(x) - self.data_min).astype(np.float32)
        return shifted / np.where(rng == 0, np.float32(1.0), rng)

    def inverse_transform(self, x):
        return x * self.data_range + self.data_min

    def normalize_values(self, feature_idx: int, raw_values) -> np.ndarray:
        """Raw category values of one feature, normalized to [0, 1]
        scalars (float32)."""
        raw = np.asarray(raw_values, dtype=np.float64)
        rng = self.data_range[feature_idx]
        return ((raw - self.data_min[feature_idx])
                / (rng + 1e-12)).astype(np.float32)

    def to_metadata(self) -> dict:
        return {"data_min": np.asarray(self.data_min).tolist(),
                "data_max": np.asarray(self.data_max).tolist()}

    @classmethod
    def from_metadata(cls, meta: dict) -> "NormStats":
        return cls(np.asarray(meta["data_min"], np.float32),
                   np.asarray(meta["data_max"], np.float32))


def fit_minmax(x_train: np.ndarray) -> NormStats:
    return NormStats(x_train.min(axis=0).astype(np.float32),
                     x_train.max(axis=0).astype(np.float32))


def image_normalize(x, mean: float = 0.5, std: float = 0.5) -> np.ndarray:
    """[0, 1] (or uint8, divided by 255 first) images -> (x - mean) / std in
    float32, [-1, 1] by default (torchvision's Normalize((.5), (.5)) in
    `mnist/data_utils.py:9-12`)."""
    x = np.asarray(x)
    x = (x.astype(np.float32) / np.float32(255.0) if x.dtype == np.uint8
         else x.astype(np.float32))
    return (x - np.float32(mean)) / np.float32(std)


def image_denormalize(x, mean: float = 0.5, std: float = 0.5) -> np.ndarray:
    """The inverse of `image_normalize`, float32."""
    return (np.asarray(x, np.float32) * np.float32(std)
            + np.float32(mean))
