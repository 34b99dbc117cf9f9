"""Sample grids of the plain-generation families (mirrors
`cfgan/eval/samples.py`: `to_uint8_grid`).  The JAX module's figure
writers (`save_image_grid`, `save_scatter`, `save_loss_plot`, `make_gif`)
draw with matplotlib and imageio, which the port does not use."""
from __future__ import annotations

import numpy as np


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
