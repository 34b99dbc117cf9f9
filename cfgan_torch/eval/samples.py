"""Sample grids, scatter and loss plots and the training GIF (mirrors
`cfgan/eval/samples.py`), and the PNG writer the port's figures use.

The port writes PNG files itself (`png_bytes`, `write_png`: 8-bit gray,
RGB or RGBA, zlib-compressed rows behind PNG chunks), without matplotlib
or PIL.  `save_image_grid` writes `to_uint8_grid`'s raster at its own
size, one pixel a pixel: the JAX package draws the same raster into a
6x6 in matplotlib figure at 120 dpi, whose file bytes and size the port
does not reproduce.  `save_scatter` and `save_loss_plot` draw with
`cfgan_torch.eval.figure`; `make_gif` writes its GIF with
`figure.write_gif`."""
from __future__ import annotations

import os
import struct
import zlib

from typing import Sequence

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type by channels: gray, RGB, RGBA
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}


def to_uint8_grid(images, nrow: int = 8, pad: int = 2) -> np.ndarray:
    """NHWC float images in [-1, 1] -> one uint8 grid image, `nrow`
    images a row with `pad` white pixels between and around them; (H, W)
    for one channel, else (H, W, C)."""
    imgs = np.asarray(images)
    if imgs.ndim == 3:
        imgs = imgs[..., None]
    imgs = np.clip((imgs + 1.0) / 2.0, 0, 1)
    n, h, w, c = imgs.shape
    ncol = nrow
    nrows = (n + ncol - 1) // ncol
    grid = np.ones((nrows * (h + pad) + pad, ncol * (w + pad) + pad, c),
                   np.float32)
    for i in range(n):
        r, cidx = divmod(i, ncol)
        y0 = pad + r * (h + pad)
        x0 = pad + cidx * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = imgs[i]
    grid = (grid * 255).astype(np.uint8)
    return grid[..., 0] if c == 1 else grid


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_bytes(pixels) -> bytes:
    """A PNG file of uint8 `pixels`: (H, W) gray, or (H, W, C) with C 1
    (gray), 3 (RGB) or 4 (RGBA); 8 bits a sample, no interlace, each row
    unfiltered (filter type 0)."""
    a = np.asarray(pixels)
    if a.dtype != np.uint8:
        raise ValueError(f"PNG pixels must be uint8, not {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in _COLOR_TYPES or 0 in a.shape[:2]:
        raise ValueError(f"cannot write pixels of shape {a.shape} as PNG")
    h, w, c = a.shape
    rows = np.ascontiguousarray(a).reshape(h, w * c)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw, 9)) + _chunk(b"IEND", b""))


def write_png(path: str, pixels) -> str:
    """Write `png_bytes(pixels)` to `path`, making its directory."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(pixels))
    return path


def save_image_grid(images, path: str, nrow: int = 8) -> str:
    """Write `to_uint8_grid(images, nrow)` to `path` as a PNG, at the
    grid's own size (`cfgan.eval.samples.save_image_grid` draws it in a
    matplotlib figure instead)."""
    return write_png(path, to_uint8_grid(images, nrow))


def save_scatter(real, fake, path: str, labels=None) -> str:
    """Real (C0) against generated points, one colour a class where
    `labels` are given (`make_moons_gan.py:109-138`)."""
    from cfgan_torch.eval.figure import Figure

    real, fake = np.asarray(real), np.asarray(fake)
    fig = Figure(figsize=(6, 5), dpi=120)
    ax = fig.subplots()[0, 0]
    ax.scatter(real[:, 0], real[:, 1], s=8, alpha=0.4, label="real")
    if labels is None:
        ax.scatter(fake[:, 0], fake[:, 1], s=8, alpha=0.6, label="generated")
    else:
        labels = np.asarray(labels)
        for c in np.unique(labels):
            sel = labels == c
            ax.scatter(fake[sel, 0], fake[sel, 1], s=8, alpha=0.6,
                       label=f"generated c={c}")
    ax.legend()
    ax.set_title("Real vs generated")
    return fig.save(path)


def save_loss_plot(history: dict, path: str,
                   keys: Sequence[str] = ("g_loss", "d_loss")) -> str:
    """The `keys` of `history` present, one line each, against the
    epoch."""
    from cfgan_torch.eval.figure import Figure

    fig = Figure(figsize=(8, 5), dpi=120)
    ax = fig.subplots()[0, 0]
    for k in keys:
        if k in history:
            ax.plot(history[k], label=k)
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Loss")
    ax.legend()
    return fig.save(path)


def make_gif(frames: Sequence, path: str, fps: int = 5) -> str:
    """uint8 frames (arrays, or paths of PNGs the port wrote) as a GIF
    at a fixed `fps` (`figure.write_gif`; the reference derives fps from
    the last batch size, `mnist_gan.py:155`, a bug)."""
    from cfgan_torch.eval.figure import read_png, write_gif

    imgs = [read_png(f) if isinstance(f, (str, os.PathLike)) else f
            for f in frames]
    return write_gif(path, imgs, fps=fps)
