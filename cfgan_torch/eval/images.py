"""Image counterfactual figures (mirrors `cfgan/eval/images.py`): the
source x target grid with flipped / not-flipped borders, the per-sample
Original | Counterfactual | Residual | Mask panels with the batch
overview, the numbered patch grid, and the single-sample user
modification (`mnist/eval_utils.py:113-568`).

Each figure makes one `cf_fn(g_vars, x, target, mask, key)` call (the
grid's over all n*n cells) and one classifier call on the port's
tensors, and draws with `cfgan_torch.eval.figure` at the JAX figures'
sizes and dpi.  The functions return what the JAX ones return, as numpy.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from cfgan_torch.core.device import resolve_device
from cfgan_torch.eval.figure import Figure
from cfgan_torch.masks.patch import patch_grid_dims, patch_indices_to_mask

DPI = 120


def _img(x) -> np.ndarray:
    """NHWC/HWC [-1, 1] -> HxW [0, 1] for display."""
    a = np.asarray(x)
    if a.ndim == 3:
        a = a[..., 0]
    return (a + 1.0) / 2.0


def _np(t) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def pick_one_per_class(x, y, num_classes: int, seed: int = 0):
    """One exemplar per source class (first match, deterministic):
    (x[idx], idx)."""
    y = np.asarray(y)
    idx = []
    for c in range(num_classes):
        where = np.nonzero(y == c)[0]
        if len(where) == 0:
            raise ValueError(f"no sample of class {c} in the evaluation set")
        idx.append(int(where[seed % len(where)]))
    return np.asarray(x)[idx], np.asarray(idx)


def counterfactual_grid(cf_fn, clf_fn, g_vars, x, y, num_classes: int,
                        path: str, mask=None, key=None, seed: int = 0,
                        device: str | torch.device | None = None
                        ) -> np.ndarray:
    """num_classes x num_classes grid at `path`: rows the source class,
    columns the target; a green border where the classifier reads the
    target, red where not.  Returns the (num_classes, num_classes) flip
    matrix.  `device` None is the CUDA card."""
    device = resolve_device(device)
    sources, _ = pick_one_per_class(_np(x), _np(y), num_classes, seed)
    n = num_classes
    xs = torch.as_tensor(np.repeat(sources, n, axis=0)).to(device)
    ts = torch.arange(n, device=device).repeat(n)
    m = (torch.ones_like(xs) if mask is None else torch.as_tensor(
        np.repeat(_np(mask), n, axis=0)).to(device))
    with torch.no_grad():
        x_cf, _, _ = cf_fn(g_vars, xs, ts, m, key)
        preds = _np(clf_fn(x_cf).argmax(1))
    x_cf = _np(x_cf)
    flips = (preds == _np(ts)).reshape(n, n)

    fig = Figure(figsize=(1.1 * n, 1.1 * n), dpi=DPI)
    axes = fig.subplots(n, n)
    for s in range(n):
        for t in range(n):
            ax = axes[s, t]
            ax.imshow(_img(x_cf[s * n + t]), cmap="gray", vmin=0, vmax=1)
            ax.set_xticks([])
            ax.set_yticks([])
            ax.set_spines("green" if flips[s, t] else "red", 2)
            if s == 0:
                ax.set_title(str(t), fontsize=9)
            if t == 0:
                ax.set_ylabel(str(s), rotation=0)
    fig.suptitle("Counterfactual grid: rows=source, cols=target",
                 fontsize=11)
    fig.save(path)
    return flips


def heatmap_panels(cf_fn, clf_fn, g_vars, x, y, targets, mask, out_dir: str,
                   key=None, max_samples: int = 8,
                   device: str | torch.device | None = None) -> dict:
    """`sample_{i}.png` (Original | CF | Residual | Mask, each with a
    colorbar) for the first `max_samples` rows and `batch_overview.png`
    (originals, counterfactuals, residuals) in `out_dir`
    (`mnist/eval_utils.py:346-441`).  Returns {"preds", "confidence"}."""
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    x = torch.as_tensor(_np(x)[:max_samples]).to(device)
    t = torch.as_tensor(_np(targets)[:max_samples]).to(device, torch.long)
    m = torch.as_tensor(_np(mask)[:max_samples]).to(device)
    y = _np(y)[:max_samples]
    with torch.no_grad():
        x_cf, _, masked = cf_fn(g_vars, x, t, m, key)
        logits = clf_fn(x_cf)
        preds = _np(logits.argmax(1))
        conf = _np(F.softmax(logits, dim=1).max(1).values)
    x, x_cf, masked, m, t = (_np(v) for v in (x, x_cf, masked, m, t))

    n = x.shape[0]
    for i in range(n):
        fig = Figure(figsize=(10, 2.8), dpi=DPI)
        axes = fig.subplots(1, 4)[0]
        panels = [
            (_img(x[i]), f"Original (y={y[i]})", "gray", (0, 1)),
            (_img(x_cf[i]),
             f"CF -> {int(t[i])} | pred {preds[i]} ({conf[i]:.2f})",
             "gray", (0, 1)),
            (masked[i][..., 0], "Residual", "seismic", (-1, 1)),
            (m[i][..., 0], "Mask", "viridis", (0, 1)),
        ]
        for ax, (img, title, cmap, (vmin, vmax)) in zip(axes, panels):
            im = ax.imshow(img, cmap=cmap, vmin=vmin, vmax=vmax)
            ax.set_title(title, fontsize=9)
            ax.axis_off()
            ax.add_colorbar(im)
        fig.save(os.path.join(out_dir, f"sample_{i}.png"))

    fig = Figure(figsize=(1.2 * n, 3.8), dpi=DPI)
    axes = fig.subplots(3, n)
    for i in range(n):
        axes[0, i].imshow(_img(x[i]), cmap="gray", vmin=0, vmax=1)
        axes[1, i].imshow(_img(x_cf[i]), cmap="gray", vmin=0, vmax=1)
        axes[2, i].imshow(masked[i][..., 0], cmap="seismic", vmin=-1,
                          vmax=1)
        for r in range(3):
            axes[r, i].axis_off()
        axes[0, i].set_title(f"{y[i]}->{int(t[i])}", fontsize=8)
    fig.save(os.path.join(out_dir, "batch_overview.png"))
    return {"preds": preds, "confidence": conf}


def patch_grid_overlay(x_sample, patch_size: int, path: str,
                       highlight: Sequence[int] = ()) -> str:
    """The image at `path` under its grid of patches, numbered row-major
    in red, yellow edges, the `highlight` patches filled green
    (`mnist/eval_utils.py:443-484`)."""
    img = _img(_np(x_sample))
    h, w = img.shape
    ph, pw = patch_grid_dims(h, w, patch_size)
    fig = Figure(figsize=(4, 4), dpi=DPI)
    ax = fig.subplots()[0, 0]
    ax.imshow(img, cmap="gray", vmin=0, vmax=1)
    hl = set(int(i) for i in highlight)
    for p in range(ph * pw):
        r, c = divmod(p, pw)
        y0, x0 = r * patch_size, c * patch_size
        ax.rectangle((x0 - 0.5, y0 - 0.5), patch_size, patch_size,
                     edgecolor="yellow",
                     facecolor=(0, 1, 0, 0.25) if p in hl else None,
                     linewidth=0.8)
        ax.text(x0 + patch_size / 2 - 0.5, y0 + patch_size / 2 - 0.5,
                str(p), color="red", fontsize=8, ha="center", va="center")
    ax.axis_off()
    fig.save(path)
    return path


def user_modification_example(cf_fn, clf_fn, g_vars, x_sample, target: int,
                              patch_indices: Sequence[int], patch_size: int,
                              path: str | None = None, key=None,
                              device: str | torch.device | None = None
                              ) -> dict:
    """One image, one target, the user's patches as its mask: one
    generator and classifier call, and with `path` a 4-panel PNG
    (`mnist/eval_utils.py:498-568`).  Returns {"pred", "confidence",
    "x_cf", "mask", "residual"}."""
    device = resolve_device(device)
    x = torch.as_tensor(_np(x_sample)[None]).to(device)
    h, w = x.shape[1], x.shape[2]
    mask = patch_indices_to_mask(patch_indices, 1, (h, w), patch_size,
                                 channels=x.shape[-1], device=device)
    t = torch.tensor([target], dtype=torch.long, device=device)
    with torch.no_grad():
        x_cf, _, masked = cf_fn(g_vars, x, t, mask, key)
        probs = F.softmax(clf_fn(x_cf), dim=1)
    probs = _np(probs)
    pred = int(probs[0].argmax())
    conf = float(probs[0, pred])
    x, x_cf, masked, mask = (_np(v) for v in (x, x_cf, masked, mask))
    if path is not None:
        fig = Figure(figsize=(10, 2.8), dpi=DPI)
        axes = fig.subplots(1, 4)[0]
        panels = [
            (_img(x[0]), "Original", "gray", (0, 1)),
            (_img(x_cf[0]), f"CF -> {target} | pred {pred} ({conf:.2f})",
             "gray", (0, 1)),
            (masked[0][..., 0], "Residual", "seismic", (-1, 1)),
            (mask[0][..., 0], f"Mask (patches {list(patch_indices)})",
             "viridis", (0, 1)),
        ]
        for ax, (img, title, cmap, (vmin, vmax)) in zip(axes, panels):
            ax.imshow(img, cmap=cmap, vmin=vmin, vmax=vmax)
            ax.set_title(title, fontsize=9)
            ax.axis_off()
        fig.save(path)
    return {"pred": pred, "confidence": conf, "x_cf": x_cf[0],
            "mask": mask[0], "residual": masked[0]}
