"""2-D decision-boundary figures for the moons pipeline (mirrors
`cfgan/eval/boundaries.py`, `moons/eval_utils.py:109-224`): the
classifier's decision surface on a dense grid (one forward) under the
data, and counterfactual arrows for each (source, target) pair.

The surface is drawn as the class of the nearest grid point through
`viridis`, each class the colour of its band in matplotlib's
`contourf(..., levels=arange(C + 1) - 0.5)`, over white at the JAX
figure's alpha.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from cfgan_torch.core.device import resolve_device
from cfgan_torch.eval.figure import Figure

DPI = 120


def decision_surface(clf_fn, xlim=(0.0, 1.0), ylim=(0.0, 1.0),
                     res: int = 300,
                     device: str | torch.device | None = None):
    """(xs, ys, classes): the `res` x `res` grid over xlim x ylim (rows
    along y) and the classifier's argmax at each point, computed on
    `device` (None: the CUDA card)."""
    device = resolve_device(device)
    xs = np.linspace(*xlim, res)
    ys = np.linspace(*ylim, res)
    gx, gy = np.meshgrid(xs, ys)
    grid = torch.as_tensor(np.stack([gx.ravel(), gy.ravel()], axis=1),
                           dtype=torch.float32).to(device)
    with torch.no_grad():
        preds = clf_fn(grid).argmax(1).cpu().numpy().reshape(res, res)
    return xs, ys, preds


def _levels(num_classes: int) -> np.ndarray:
    return np.arange(num_classes + 1) - 0.5


def plot_decision_boundaries_and_cfs(
        clf_fn, cf_fn, g_vars, x, y, num_classes: int, out_dir: str,
        mask_row=None, n_cf_samples: int = 20, key=None,
        save_prefix: str = "decision_boundaries_cfs",
        device: str | torch.device | None = None) -> list[str]:
    """One PNG per (source, target) pair with source != target in
    `out_dir`: the surface, the data coloured by class, and arrows from up
    to `n_cf_samples` of the source's points to their counterfactuals
    (red x).  Returns the paths written."""
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    x, y = np.asarray(x), np.asarray(y)
    xs, ys, surface = decision_surface(clf_fn, device=device)
    paths = []
    for src in range(num_classes):
        for tgt in range(num_classes):
            if src == tgt:
                continue
            sel = np.where(y == src)[0][:n_cf_samples]
            if not len(sel):
                continue
            xb = torch.as_tensor(x[sel]).to(device)
            tvec = torch.full((len(sel),), tgt, dtype=torch.long,
                              device=device)
            mask = (torch.ones_like(xb) if mask_row is None else
                    torch.as_tensor(np.asarray(mask_row, np.float32)).to(
                        device).expand_as(xb))
            with torch.no_grad():
                x_cf = cf_fn(g_vars, xb, tvec, mask, key)[0].cpu().numpy()
            fig = Figure(figsize=(6, 5), dpi=DPI)
            ax = fig.subplots()[0, 0]
            ax.surface(xs, ys, surface, cmap="viridis", alpha=0.25,
                       levels=_levels(num_classes))
            ax.scatter(x[:, 0], x[:, 1], c=y, s=6, cmap="viridis",
                       alpha=0.35)
            for a, b in zip(x[sel], x_cf):
                ax.arrow(a, b, color="red", linewidth=1.2)
            ax.scatter(x_cf[:, 0], x_cf[:, 1], c="red", s=18, marker="x")
            ax.set_title(f"Counterfactuals {src} -> {tgt}")
            p = os.path.join(out_dir, f"{save_prefix}_src{src}_tgt{tgt}.png")
            paths.append(fig.save(p))
    return paths


def plot_decision_boundaries_only(clf_fn, x, y, out_path: str,
                                  num_classes: int = 3, highlight=None,
                                  device: str | torch.device | None = None
                                  ) -> str:
    """The surface and the data coloured by class at `out_path`; with
    `highlight`, that point as a red star edged in black."""
    device = resolve_device(device)
    xs, ys, surface = decision_surface(clf_fn, device=device)
    fig = Figure(figsize=(6, 5), dpi=DPI)
    ax = fig.subplots()[0, 0]
    ax.surface(xs, ys, surface, cmap="viridis", alpha=0.3,
               levels=_levels(num_classes))
    ax.scatter(np.asarray(x)[:, 0], np.asarray(x)[:, 1], c=np.asarray(y),
               s=6, cmap="viridis")
    if highlight is not None:
        h = np.asarray(highlight)
        ax.scatter([h[0]], [h[1]], marker="*", s=220, c="red",
                   edgecolors="black")
    ax.set_title("Decision boundaries")
    return fig.save(out_path)
