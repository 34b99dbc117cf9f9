"""The 2-D moons datasets in numpy (mirrors `cfgan/data/moons.py`).

`load_moons3`: 800 two-moons points (noise 0.1) and 400 uniform points in
[-2, 2] x [2, 4] labelled class 2, MinMax-scaled over the whole set, an
80/20 split (`moons/data_utils.py:7-22`).  `load_moons2`: the plain
2-class moons of the generation families.

scikit-learn's `make_moons`, its shuffle and `train_test_split` are
redone here with the same `RandomState` draws in the same order, so the
arrays equal the JAX package's bit for bit: the moons' shuffle
(`RandomState.shuffle` of the row indices), then their Gaussian noise,
both from the caller's state; then the rectangle's uniform points from
the same state; then the split from a fresh `RandomState(seed)`'s
permutation, the first ceil(test_fraction * n) rows of which are the
test set.
"""
from __future__ import annotations

import math

import numpy as np

from cfgan_torch.data.transforms import NormStats, fit_minmax


def make_moons(n_samples: int, noise: float | None,
               rng: np.random.RandomState) -> tuple[np.ndarray, np.ndarray]:
    """Two interleaving half circles, shuffled, with Gaussian noise of
    standard deviation `noise` (scikit-learn's `make_moons(n_samples,
    shuffle=True, noise=noise, random_state=rng)`): (x float64 (n, 2),
    y intp (n,))."""
    n_out = n_samples // 2
    n_in = n_samples - n_out
    outer = np.linspace(0, np.pi, n_out)
    inner = np.linspace(0, np.pi, n_in)
    x = np.vstack([np.append(np.cos(outer), 1 - np.cos(inner)),
                   np.append(np.sin(outer), 1 - np.sin(inner) - 0.5)]).T
    y = np.hstack([np.zeros(n_out, dtype=np.intp),
                   np.ones(n_in, dtype=np.intp)])
    idx = np.arange(n_samples)
    rng.shuffle(idx)
    x, y = x[idx], y[idx]
    if noise is not None:
        x += rng.normal(scale=noise, size=x.shape)
    return x, y


def train_test_split(x: np.ndarray, y: np.ndarray, test_fraction: float,
                     seed: int):
    """(x_train, x_test, y_train, y_test): scikit-learn's
    `train_test_split(x, y, test_size=test_fraction, random_state=seed)`
    without stratification."""
    n = len(x)
    n_test = math.ceil(test_fraction * n)
    perm = np.random.RandomState(seed).permutation(n)
    test, train = perm[:n_test], perm[n_test:]
    return x[train], x[test], y[train], y[test]


def load_moons3(seed: int = 42, n_moons: int = 800, n_rect: int = 400,
                noise: float = 0.1, test_fraction: float = 0.2
                ) -> tuple[tuple, tuple, NormStats]:
    """((x_train, y_train), (x_test, y_test), stats): float32 points in
    [0, 1]^2, int32 labels in {0, 1, 2}."""
    rng = np.random.RandomState(seed)
    x_moons, y_moons = make_moons(n_moons, noise, rng)
    x_rect = rng.uniform(low=[-2, 2], high=[2, 4], size=(n_rect, 2))
    y_rect = np.full(n_rect, 2)

    x = np.vstack([x_moons, x_rect]).astype(np.float32)
    y = np.concatenate([y_moons, y_rect]).astype(np.int32)

    stats = fit_minmax(x)  # the reference fits the scaler on all the data
    x = np.asarray(stats.transform(x), np.float32)

    x_train, x_test, y_train, y_test = train_test_split(x, y, test_fraction,
                                                        seed)
    return (x_train, y_train), (x_test, y_test), stats


def load_moons2(seed: int = 42, n_samples: int = 2000, noise: float = 0.05
                ) -> tuple[np.ndarray, np.ndarray]:
    """Plain 2-class moons for the simple and conditional MLP GANs
    (`simple_gan/moons/make_moons_gan.py:23`,
    `conditional_gan/moons/make_moons_cgan.py:66`): float32 x, int32 y."""
    x, y = make_moons(n_samples, noise, np.random.RandomState(seed))
    return x.astype(np.float32), y.astype(np.int32)
