"""Tabular counterfactual evaluation (mirrors the per-target part of
`cfgan/eval/tabular.py`): the immutable-complement eval mask, the
all-target sweep, the per-target metrics of `countergan_metrics.csv`, and
the snapshot selector's flip scorer under both eval protocols.

The eval counterfactual uses hard Gumbel samples on the noise of a key
and the immutable-complement mask, and clamps to [0, 1]; the reference
protocol scores the un-clamped `x + masked` instead
(`house eval_utils.py:244-245`).  The JAX package vmaps over the targets;
here each target runs in turn over the whole set.  Results are numpy
arrays, and the metrics a dict of columns for `write_csv`.

Not ported yet: `feature_shift_importance`, `class_pair_sensitivity`,
`case_study_report` and the mask-policy analysis.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from cfgan_torch.masks.feature import immutable_complement_mask


def immutable_mask(batch: int, schema,
                   device: str | torch.device | None = None) -> torch.Tensor:
    """All-ones (batch, D) mask with the schema's immutable features 0."""
    return immutable_complement_mask(batch, schema.input_dim,
                                     schema.immutable_idx, device=device)


def make_protocol_flip_scorer(cf_fn: Callable, clf_fn: Callable,
                              num_classes: int) -> Callable:
    """`score(g_vars, x, y, mask, keys) -> (honest, ref)`, float32 numpy
    arrays of shape (len(keys), num_classes): per Gumbel key and target,
    the flip rate over the rows whose label is not the target, of the
    clamped counterfactual (honest) and of the un-clamped x + masked
    (ref).  Rates are count / rows in float32, as the JAX scorer divides
    its int32 counts."""

    def score(g_vars, x, y, mask, keys: Sequence):
        counts = []
        with torch.no_grad():
            for key in keys:
                for t in range(num_classes):
                    tvec = torch.full((x.shape[0],), t, dtype=torch.long,
                                      device=x.device)
                    x_cf, _, masked = cf_fn(g_vars, x, tvec, mask, key)
                    sel = y != t
                    hit_h = (clf_fn(x_cf).argmax(1) == t) & sel
                    hit_r = (clf_fn(x + masked).argmax(1) == t) & sel
                    counts.append(torch.stack([hit_h.sum(), hit_r.sum(),
                                               sel.sum()]))
        c = torch.stack(counts).cpu().numpy().astype(np.float32)
        c = c.reshape(len(keys), num_classes, 3)
        return c[..., 0] / c[..., 2], c[..., 1] / c[..., 2]

    return score


def sweep_all_targets(cf_fn: Callable, clf_fn: Callable, g_vars, x, mask,
                      num_classes: int, key) -> dict[str, np.ndarray]:
    """Counterfactuals and classifier outputs for every target on the whole
    of x (a tensor on the serving device), all with `key`: x_cf (C, B, D),
    preds_cf (C, B), probs_cf (C, B, C) and probs_orig (B, C)."""
    outs = {"x_cf": [], "preds_cf": [], "probs_cf": []}
    with torch.no_grad():
        for t in range(num_classes):
            tvec = torch.full((x.shape[0],), t, dtype=torch.long,
                              device=x.device)
            x_cf, _, _ = cf_fn(g_vars, x, tvec, mask, key)
            logits = clf_fn(x_cf)
            outs["x_cf"].append(x_cf)
            outs["preds_cf"].append(logits.argmax(1))
            outs["probs_cf"].append(F.softmax(logits, dim=1))
        probs_orig = F.softmax(clf_fn(x), dim=1)
    sweep = {k: torch.stack(v).cpu().numpy() for k, v in outs.items()}
    sweep["probs_orig"] = probs_orig.cpu().numpy()
    return sweep


def per_target_metrics_from_sweep(sweep: dict, x, y, num_classes: int
                                  ) -> dict[str, np.ndarray]:
    """Per target, over the rows whose label is not the target: the flip
    rate, the prediction gain p_cf[target] - p_orig[target] and the
    actionability mean |x_cf - x| (NaN where no row qualifies), as the
    columns of `countergan_metrics.csv`."""
    x, y = np.asarray(x), np.asarray(y)
    cols = {"target_class": np.arange(num_classes),
            "class_flip_rate": [], "prediction_gain": [],
            "avg_actionability": []}
    for t in range(num_classes):
        sel = y != t
        if not sel.any():
            for name in ("class_flip_rate", "prediction_gain",
                         "avg_actionability"):
                cols[name].append(np.nan)
            continue
        delta = sweep["x_cf"][t][sel] - x[sel]
        gain = sweep["probs_cf"][t][sel, t] - sweep["probs_orig"][sel, t]
        cols["class_flip_rate"].append(
            float((sweep["preds_cf"][t][sel] == t).mean()))
        cols["prediction_gain"].append(float(gain.mean()))
        cols["avg_actionability"].append(float(np.abs(delta).mean()))
    return {k: np.asarray(v) for k, v in cols.items()}
