"""Counterfactual quality metrics (mirrors `cfgan/eval/metrics.py`).

The per-target sweep takes the JAX package's three modes:

- `exclude_same_class`: drop the rows whose label is the target (the
  tabular and moons sweeps, `house eval_utils.py:185-289`,
  `moons/eval_utils.py:29-106`), or keep every row (MNIST,
  `mnist/eval_utils.py:78-110`);
- `pred_gain_mode`: `"cf_target_minus_orig_target"`, p_cf[target] -
  p_orig[target], or `"cf_target_minus_cf_true"`, p_cf[target] -
  p_cf[y_true] (both on x_cf, MNIST's);
- `actionability_mode`: `"masked_residual"`, mean |masked residual|, or
  `"x_cf_minus_x"`, mean |x_cf - x| (MNIST's).

Flip = pred(x_cf) == target.  The JAX package vmaps the sweep over the
targets; here a batch runs each target in turn.  Sums accumulate in
float64 on the host, one read a batch.  Results are dicts of numpy
columns or lists of row dicts, written by `write_csv` under the JAX
CSVs' column names.
"""
from __future__ import annotations

import csv
from typing import Callable, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def _per_sample_mean_abs(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(a.shape[0], -1).abs().mean(1)


PRED_GAIN_MODES = ("cf_target_minus_orig_target", "cf_target_minus_cf_true")
ACTIONABILITY_MODES = ("masked_residual", "x_cf_minus_x")
# the two protocols the experiments use: MNIST's (every row, the gain
# read on x_cf, |x_cf - x|), and the tabular and moons one (rows whose
# label is the target left out, the gain against the original's
# probability, |masked residual|)
MNIST_PROTOCOL = dict(exclude_same_class=False,
                      pred_gain_mode="cf_target_minus_cf_true",
                      actionability_mode="x_cf_minus_x")
TABULAR_PROTOCOL = dict(exclude_same_class=True,
                        pred_gain_mode="cf_target_minus_orig_target",
                        actionability_mode="masked_residual")


def make_per_target_sweep(cf_fn: Callable, clf_fn: Callable,
                          num_classes: int, *, exclude_same_class: bool,
                          pred_gain_mode: str, actionability_mode: str):
    """`sweep(g_vars, x, y, mask, key=None) -> (num_classes, 4)` float32
    sums per target (flip, gain, actionability, count), each row weighted
    by w (0 where `exclude_same_class` and the label is the target, else
    1); `key` goes to `cf_fn` (a tabular generator's noise);
    `per_target_metrics` is the user-facing form."""
    if pred_gain_mode not in PRED_GAIN_MODES:
        raise ValueError(f"unknown pred_gain_mode {pred_gain_mode!r}")
    if actionability_mode not in ACTIONABILITY_MODES:
        raise ValueError(f"unknown actionability_mode {actionability_mode!r}")

    def sweep(g_vars, x, y, mask, key=None):
        b = x.shape[0]
        rows = torch.arange(b, device=x.device)
        out = []
        with torch.no_grad():
            probs_orig = (F.softmax(clf_fn(x), dim=1) if pred_gain_mode
                          == "cf_target_minus_orig_target" else None)
            for target in range(num_classes):
                tvec = torch.full((b,), target, dtype=torch.long,
                                  device=x.device)
                x_cf, _, masked = cf_fn(g_vars, x, tvec, mask, key)
                logits = clf_fn(x_cf)
                probs = F.softmax(logits, dim=1)
                w = ((y != tvec).float() if exclude_same_class
                     else torch.ones((b,), device=x.device))
                flip = (logits.argmax(1) == tvec).float()
                if probs_orig is None:
                    gain = probs[rows, tvec] - probs[rows, y]
                else:
                    gain = probs[rows, tvec] - probs_orig[rows, tvec]
                act = _per_sample_mean_abs(
                    masked if actionability_mode == "masked_residual"
                    else x_cf - x)
                out.append(torch.stack([(w * flip).sum(), (w * gain).sum(),
                                        (w * act).sum(), w.sum()]))
        return torch.stack(out)

    return sweep


def per_target_metrics(sweep: Callable, g_vars, x, y,
                       mask_fn: Callable[[int], torch.Tensor],
                       num_classes: int, batch_size: int = 2048,
                       key=None) -> dict[str, np.ndarray]:
    """Stream (x, y) (numpy or tensors) through `sweep` in batches on the
    device of `mask_fn`'s masks, each batch with `key`; returns the
    columns of `countergan_metrics_per_class.csv`: target_class,
    class_flip_rate, prediction_gain, avg_actionability."""
    acc = np.zeros((num_classes, 4))
    for lo in range(0, len(y), batch_size):
        yb_host = y[lo:lo + batch_size]
        mask = mask_fn(len(yb_host))
        xb = torch.as_tensor(x[lo:lo + batch_size]).to(mask.device)
        yb = torch.as_tensor(yb_host).to(mask.device, torch.long)
        acc += sweep(g_vars, xb, yb, mask, key).double().cpu().numpy()
    denom = np.where(acc[:, 3] == 0, np.nan, acc[:, 3])
    return {"target_class": np.arange(num_classes),
            "class_flip_rate": acc[:, 0] / denom,
            "prediction_gain": acc[:, 1] / denom,
            "avg_actionability": acc[:, 2] / denom}


def evaluate_counterfactual_batch(cf_fn: Callable, clf_fn: Callable, g_vars,
                                  x, y_true, y_target, mask):
    """Single-batch metrics (the MNIST `evaluate_counterfactuals`
    contract).  Returns (metrics dict of floats, x_cf)."""
    with torch.no_grad():
        x_cf, _, _ = cf_fn(g_vars, x, y_target, mask)
        logits = clf_fn(x_cf)
        probs = F.softmax(logits, dim=1)
        rows = torch.arange(x.shape[0], device=x.device)
        metrics = {
            "class_flip_rate": float((logits.argmax(1) == y_target).float()
                                     .mean()),
            "prediction_gain": float((probs[rows, y_target]
                                      - probs[rows, y_true]).mean()),
            "actionability": float((x_cf - x).abs().mean())}
    return metrics, x_cf


def masked_metrics(clf_fn: Callable, x, x_cf, raw, masked, mask, y_true,
                   y_target) -> dict[str, float]:
    """FR_mean / FR_max, the L1 inside the mask, the prediction gain, the
    overall L1 and the residual outside the mask
    (`mnist/eval_utils.py:292-344`)."""
    with torch.no_grad():
        logits_cf = clf_fn(x_cf)
        probs_cf = F.softmax(logits_cf, dim=1)
        probs_orig = F.softmax(clf_fn(x), dim=1)
        rows = torch.arange(x.shape[0], device=x.device)
        flips = (logits_cf.argmax(1) == y_target).float()
        return {
            "Class_flip_rate_mean": float(flips.mean()),
            "Class_flip_rate_max": float(flips.max()),
            "Residual_L1_norm_in_allowed_patches": float(
                _per_sample_mean_abs(raw * mask).mean()),
            "Prediction_gain": float((probs_cf[rows, y_target]
                                      - probs_orig[rows, y_true]).mean()),
            "Actionability (overall L1 norm)": float((x_cf - x).abs()
                                                     .mean()),
            "mask_penalty_pre": float(_per_sample_mean_abs(
                raw * (1.0 - mask)).mean())}


def write_csv(path: str, table: Mapping[str, Sequence] | Sequence[Mapping]
              ) -> str:
    """Write numpy columns (a dict of equal-length columns) or row dicts
    as a CSV without an index, as pandas' `to_csv(index=False)` writes
    them (floats by `repr`, float32 values by their shortest float32
    form, NaN as an empty field)."""
    if isinstance(table, Mapping):
        names = list(table)
        rows = [dict(zip(names, vals)) for vals in zip(*table.values())]
    else:
        rows = list(table)
        names = list(rows[0]) if rows else []

    def cell(v):
        if isinstance(v, (np.integer, int)) and not isinstance(v, bool):
            return int(v)
        if isinstance(v, np.float32):
            return "" if np.isnan(v) else str(v)
        if isinstance(v, (np.floating, float)):
            return "" if np.isnan(v) else repr(float(v))
        return v

    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(names)
        for row in rows:
            w.writerow([cell(row[k]) for k in names])
    return path
