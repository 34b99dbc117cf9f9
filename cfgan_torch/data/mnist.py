"""MNIST loading in numpy (mirrors `cfgan/data/mnist.py`): the IDX or
keras `mnist.npz` files where a directory holds them, else a deterministic
synthetic digit corpus.

The search order is `path`, then `$CFGAN_DATA_DIR` (each also under
`MNIST/raw/`); the JAX package also looks in `/mnt/data` and its home
cache, which the port leaves alone.  The synthetic corpus warps the glyph
table `glyphs.npz` beside this file, which holds the JAX package's
`_render_glyphs()` (14 typeface variants x 10 digits, 56x56, stored as
uint8; `uint8 / 255.0` in float32 gives the rendered floats back
exactly), so the port needs no font renderer: from the same seed it gives
the JAX package's corpus bit for bit.  A generated corpus is cached as
`.npz` under `cache_dir` (default: `build/cfgan_torch/data/` at the root
of the checkout).

IDX files are decoded and uint8 images normalised by the port's C++ data
library (`cfgan_torch.native`, built with g++ at first use), as the JAX
package does through `cfgan/native`; `_read_idx_plain` and
`normalize_plain` are the numpy versions.

Splits mirror `mnist/data_utils.py:6-32`: a stratified train/valid split
of the train set (scikit-learn's `StratifiedShuffleSplit`, redone in
numpy: same indices from the same seed), and the test set; images NHWC
float32 in [-1, 1].
"""
from __future__ import annotations

import gzip
import math
import os
import struct
from pathlib import Path

import numpy as np

from cfgan_torch import native

TRAIN_N = 60000
TEST_N = 10000
GLYPHS = Path(__file__).resolve().parent / "glyphs.npz"
CACHE_DIR = Path(__file__).resolve().parents[2] / "build" / "cfgan_torch" / "data"


# ---------------------------------------------------------------- real MNIST
def _read_idx(path: str) -> np.ndarray:
    """An IDX file's uint8 array: the native decoder, or the Python one
    for what it declines (a `.gz` file)."""
    fast = native.read_idx(path)
    return fast if fast is not None else _read_idx_plain(path)


def _read_idx_plain(path: str) -> np.ndarray:
    """The Python IDX decoder (plain or gzipped)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def _find(base: str, stem: str) -> str | None:
    for suffix in ("", ".gz"):
        for name in (stem + suffix, stem.replace("-idx", ".idx") + suffix):
            p = os.path.join(base, name)
            if os.path.exists(p):
                return p
    return None


def _load_real(data_dir: str):
    npz = os.path.join(data_dir, "mnist.npz")
    if os.path.exists(npz):
        with np.load(npz) as z:
            return ((z["x_train"], z["y_train"].astype(np.int32)),
                    (z["x_test"], z["y_test"].astype(np.int32)))
    stems = {"xtr": "train-images-idx3-ubyte",
             "ytr": "train-labels-idx1-ubyte",
             "xte": "t10k-images-idx3-ubyte",
             "yte": "t10k-labels-idx1-ubyte"}
    paths = {k: _find(data_dir, s) for k, s in stems.items()}
    if all(paths.values()):
        return ((_read_idx(paths["xtr"]),
                 _read_idx(paths["ytr"]).astype(np.int32)),
                (_read_idx(paths["xte"]),
                 _read_idx(paths["yte"]).astype(np.int32)))
    return None


# ----------------------------------------------------------- synthetic MNIST
def load_glyphs() -> np.ndarray:
    """The (14, 10, 56, 56) float32 glyph table in [0, 1]."""
    with np.load(GLYPHS) as z:
        return z["glyphs"].astype(np.float32) / 255.0


def _upsample_matrix(coarse: int, out: int) -> np.ndarray:
    """(out, coarse) bilinear interpolation matrix mapping a coarse grid to
    `out` points (the per-sample elastic fields)."""
    U = np.zeros((out, coarse), np.float32)
    pos = np.linspace(0, coarse - 1, out)
    lo = np.floor(pos).astype(np.int32)
    hi = np.minimum(lo + 1, coarse - 1)
    frac = (pos - lo).astype(np.float32)
    U[np.arange(out), lo] += 1 - frac
    U[np.arange(out), hi] += frac
    return U


def _elastic_field(U: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """`np.einsum("ij,njkc,lk->nilc", U, grid, U)` bit for bit, without
    its loop over every (i, j, k, l): numpy's einsum adds the
    float32 products (U[i, j] * grid[n, j, k, c]) * U[l, k] to a sum that
    starts at 0, j then k ascending.  A row of the bilinear `U` is zero
    but at `lo` and `lo + 1`, and a zero product leaves a sum as it is,
    so only those four terms are added, in the same order."""
    out, coarse = U.shape
    lo = np.floor(np.linspace(0, coarse - 1, out)).astype(np.int64)
    rows = np.arange(out)
    # a zero column and row past the grid stand for `lo + 1` at its edge
    u = np.zeros((out, coarse + 1), np.float32)
    u[:, :coarse] = U
    g = np.zeros((grid.shape[0], coarse + 1, coarse + 1, grid.shape[-1]),
                 np.float32)
    g[:, :coarse, :coarse] = grid
    field = np.zeros((grid.shape[0], out, out, grid.shape[-1]), np.float32)
    term = np.empty_like(field)
    for j in (lo, lo + 1):
        gj = g.take(j, axis=1) * u[rows, j][None, :, None, None]
        for k in (lo, lo + 1):
            np.multiply(gj.take(k, axis=2), u[rows, k][None, None, :, None],
                        out=term)
            field += term
    return field


def _warp_sample(glyphs, variants, labels, thetas, scales, tx, ty,
                 disp=None, out: int = 28):
    """Bilinear sampling of per-sample affine (and elastic) transforms of
    the glyphs.  `disp` is an optional (n, out, out, 2) displacement field
    in output pixels."""
    n = labels.shape[0]
    gsize = glyphs.shape[-1]
    cy_out = (out - 1) / 2.0
    cy_in = (gsize - 1) / 2.0
    yy, xx = np.meshgrid(np.arange(out), np.arange(out), indexing="ij")
    base = np.stack([yy - cy_out, xx - cy_out],
                    -1).reshape(-1, 2).astype(np.float32)
    if disp is not None:
        base = base[None] + disp.reshape(n, -1, 2)
    else:
        base = np.broadcast_to(base[None], (n,) + base.shape)

    cos, sin = np.cos(thetas), np.sin(thetas)
    # inverse rotation, then inverse scale; the glyph is ~2x the output
    factor = (gsize / out) / scales
    rot = np.stack([np.stack([cos, -sin], -1), np.stack([sin, cos], -1)],
                   -2)  # (n, 2, 2)
    # np.einsum("npk,nkj->npj", base, rot) bit for bit: its sum of two
    # float32 products, k ascending, at a fifth of its cost
    rotated = np.stack([base[..., 0] * rot[:, None, 0, j]
                        + base[..., 1] * rot[:, None, 1, j]
                        for j in range(2)], -1)
    coords = rotated * factor[:, None, None]
    coords[..., 0] += cy_in + ty[:, None] * (gsize / out)
    coords[..., 1] += cy_in + tx[:, None] * (gsize / out)

    y0 = np.floor(coords[..., 0]).astype(np.int32)
    x0 = np.floor(coords[..., 1]).astype(np.int32)
    fy = coords[..., 0] - y0
    fx = coords[..., 1] - x0

    flat = glyphs.reshape(-1)
    glyph = (variants * glyphs.shape[1] + labels)[:, None] * gsize

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < gsize) & (xi >= 0) & (xi < gsize)
        yi = np.clip(yi, 0, gsize - 1)
        xi = np.clip(xi, 0, gsize - 1)
        return flat.take((glyph + yi) * gsize + xi) * valid

    v = (gather(y0, x0) * (1 - fy) * (1 - fx)
         + gather(y0, x0 + 1) * (1 - fy) * fx
         + gather(y0 + 1, x0) * fy * (1 - fx)
         + gather(y0 + 1, x0 + 1) * fy * fx)
    return v.reshape(n, out, out)


def synthesize(n: int, seed: int, glyphs: np.ndarray | None = None):
    """(uint8 images (n, 28, 28), int32 labels): a random typeface variant
    per sample, affine jitter, a smooth elastic distortion, stroke weight
    by gamma, pixel noise and intensity scaling, all from
    `RandomState(seed)` in the JAX package's order."""
    rng = np.random.RandomState(seed)
    if glyphs is None:
        glyphs = load_glyphs()
    nv = glyphs.shape[0]
    labels = rng.randint(0, 10, n).astype(np.int32)
    variants = rng.randint(0, nv, n).astype(np.int32)
    thetas = rng.uniform(-0.26, 0.26, n).astype(np.float32)  # ~15 degrees
    scales = rng.uniform(0.75, 1.05, n).astype(np.float32)
    tx = rng.uniform(-2.5, 2.5, n).astype(np.float32)
    ty = rng.uniform(-2.5, 2.5, n).astype(np.float32)
    # elastic: a per-sample 5x5 displacement grid, upsampled to 28x28
    coarse = 5
    alpha = rng.uniform(0.3, 2.0, (n, 1, 1, 1)).astype(np.float32)
    grid = rng.normal(0.0, 1.0, (n, coarse, coarse, 2)).astype(np.float32)
    U = _upsample_matrix(coarse, 28)
    disp = _elastic_field(U, grid * alpha)
    # stroke weight: gamma < 1 thickens antialiased strokes, > 1 thins
    gamma = rng.uniform(0.6, 1.7, (n, 1, 1)).astype(np.float32)

    imgs = np.zeros((n, 28, 28), np.float32)
    for lo in range(0, n, 8192):
        hi = min(n, lo + 8192)
        imgs[lo:hi] = _warp_sample(
            glyphs, variants[lo:hi], labels[lo:hi], thetas[lo:hi],
            scales[lo:hi], tx[lo:hi], ty[lo:hi], disp[lo:hi])
    imgs = np.power(np.clip(imgs, 0.0, 1.0), gamma)
    imgs += rng.normal(0.0, 0.04, imgs.shape).astype(np.float32)
    imgs *= rng.uniform(0.7, 1.0, (n, 1, 1)).astype(np.float32)
    imgs = np.clip(imgs, 0.0, 1.0)
    return (imgs * 255).astype(np.uint8), labels


def _load_synthetic(seed: int = 0, cache_dir: str | os.PathLike | None = None):
    """The synthetic train and test sets (60,000 and 10,000 images), from
    the cache where it holds them."""
    cache_dir = Path(cache_dir) if cache_dir is not None else CACHE_DIR
    cache = cache_dir / f"synthetic_mnist_v2_{seed}.npz"
    if cache.exists():
        with np.load(cache) as z:
            return (z["xtr"], z["ytr"]), (z["xte"], z["yte"])
    glyphs = load_glyphs()
    xtr, ytr = synthesize(TRAIN_N, seed, glyphs)
    xte, yte = synthesize(TEST_N, seed + 1, glyphs)
    cache_dir.mkdir(parents=True, exist_ok=True)
    tmp = cache.with_name(f".{cache.stem}.{os.getpid()}.npz")
    np.savez_compressed(tmp, xtr=xtr, ytr=ytr, xte=xte, yte=yte)
    os.replace(tmp, cache)  # atomic: a concurrent reader sees all or none
    return (xtr, ytr), (xte, yte)


# --------------------------------------------------- stratified split
def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """Draws per class that sum to `n_draws`, in proportion to
    `class_counts`, ties broken by `rng` (scikit-learn's
    `sklearn.utils.extmath._approximate_mode`)."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_split(y: np.ndarray, test_fraction: float, seed: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """(train indices, test indices) of scikit-learn's
    `train_test_split(np.arange(len(y)), test_size=test_fraction,
    stratify=y, random_state=seed)`: `StratifiedShuffleSplit`'s draws from
    `RandomState(seed)` in its order."""
    y = np.asarray(y)
    n_test = math.ceil(test_fraction * len(y))
    n_train = len(y) - n_test
    _, y_indices, class_counts = np.unique(y, return_inverse=True,
                                           return_counts=True)
    if class_counts.min() < 2:
        raise ValueError("a stratified split needs two samples of a class")
    if min(n_train, n_test) < len(class_counts):
        raise ValueError("a stratified split needs a sample of every class "
                         "on each side")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i, count in enumerate(class_counts):
        perm = class_indices[i].take(rng.permutation(count), mode="clip")
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


# ------------------------------------------------------------------ public
_LUT = ((np.arange(256, dtype=np.float32) / 255.0) - 0.5) / 0.5


def normalize(x: np.ndarray) -> np.ndarray:
    """uint8 (n, 28, 28) -> float32 (n, 28, 28, 1) in [-1, 1], rounded as
    ((x / 255) - 0.5) / 0.5 in float32, by the native normaliser."""
    return native.normalize_u8(x, 0.5, 0.5).reshape(x.shape[0], 28, 28, 1)


def normalize_plain(x: np.ndarray) -> np.ndarray:
    """`normalize` through a numpy table of the 256 values."""
    return _LUT[x].reshape(x.shape[0], 28, 28, 1)


def load_mnist(path: str | None = None, seed: int = 42,
               valid_fraction: float = 0.1, limit: int | None = None,
               cache_dir: str | os.PathLike | None = None):
    """((x_train, y_train), (x_valid, y_valid), (x_test, y_test)), images
    NHWC float32 in [-1, 1], labels int32.  `limit` keeps the first
    `limit` train images and `limit // 5` test images before the split
    (a smoke run's size).  With `valid_fraction` 0 the valid set is
    (None, None)."""
    data = None
    for candidate in (path, os.environ.get("CFGAN_DATA_DIR")):
        if candidate and os.path.isdir(candidate):
            data = _load_real(candidate)
            if data is None:
                sub = os.path.join(candidate, "MNIST", "raw")
                if os.path.isdir(sub):
                    data = _load_real(sub)
            if data is not None:
                break
    if data is None:
        data = _load_synthetic(0, cache_dir)
    (xtr, ytr), (xte, yte) = data
    if limit is not None:
        xtr, ytr = xtr[:limit], ytr[:limit]
        xte, yte = xte[:max(limit // 5, 1)], yte[:max(limit // 5, 1)]
    xtr, xte = normalize(xtr), normalize(xte)
    ytr, yte = ytr.astype(np.int32), yte.astype(np.int32)
    if valid_fraction > 0:
        idx_tr, idx_va = stratified_split(ytr, valid_fraction, seed)
        return ((xtr[idx_tr], ytr[idx_tr]), (xtr[idx_va], ytr[idx_va]),
                (xte, yte))
    return (xtr, ytr), (None, None), (xte, yte)
