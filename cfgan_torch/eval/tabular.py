"""Tabular counterfactual evaluation (mirrors `cfgan/eval/tabular.py`):
the immutable-complement eval mask, the all-target sweep, the per-target
metrics of `countergan_metrics.csv`, the snapshot selector's flip scorer
under both eval protocols, and the reports over one sweep: the feature
shift importance, the class-pair sensitivity and the case-study tree
(`house eval_utils.py:292-664`).

The eval counterfactual uses hard Gumbel samples on the noise of a key
and the immutable-complement mask, and clamps to [0, 1]; the reference
protocol scores the un-clamped `x + masked` instead
(`house eval_utils.py:244-245`).  The JAX package vmaps over the targets;
here each target runs in turn over the whole set.  Results are numpy
arrays, and the metrics and reports dicts of columns (or row dicts) for
`write_csv`, in the JAX package's row order and with its float32 columns
where it has them.  The reports draw the JAX package's plots:
`feature_shift_importance.png` (two bar panels, normalized and raw) and
`class_pair_sensitivity/src{s}.png` (features x targets through
`viridis`, one a source class).
"""
from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from cfgan_torch.eval.figure import Figure
from cfgan_torch.eval.metrics import write_csv
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


def descending_order(values: np.ndarray) -> np.ndarray:
    """Row order of pandas' `sort_values(ascending=False)` (its
    `nargsort`): numpy's quicksort of the reversed values, reversed back,
    so that ties fall in pandas' order."""
    idx = np.arange(len(values))[::-1]
    return idx[values[::-1].argsort(kind="quicksort")][::-1]


def largest(values: np.ndarray, k: int) -> np.ndarray:
    """Indices of the `k` largest values, largest first, ties in index
    order (pandas' `nlargest(k, keep="first")`)."""
    return np.argsort(-np.asarray(values), kind="stable")[:k]


def _float32_group_mean(rows) -> np.ndarray:
    """The column means of float32 `rows` as pandas' `groupby().mean()`
    takes them: a Kahan-compensated float32 sum, divided in float32."""
    total = np.zeros_like(rows[0])
    comp = np.zeros_like(rows[0])
    for r in rows:
        y = r - comp
        t = total + y
        comp = (t - total) - y
        total = t
    return total / np.float32(len(rows))


def _write(out_dir: str, name: str, table) -> None:
    os.makedirs(out_dir, exist_ok=True)
    write_csv(os.path.join(out_dir, name), table)


def feature_shift_importance(sweep: dict, x, y, schema, stats,
                             out_dir: str | None = None
                             ) -> dict[str, np.ndarray]:
    """Mean |x_cf - x| per feature over every (row, target != label) pair,
    normalized and in raw units (`eval_utils.py:292-348`), features from
    the most shifted down; with `out_dir`, `feature_shift_importance.csv`
    there."""
    x, y = np.asarray(x), np.asarray(y)
    d = np.concatenate([np.abs(sweep["x_cf"][t][y != t] - x[y != t])
                        for t in range(sweep["x_cf"].shape[0])], axis=0)
    mean_norm = d.mean(axis=0)
    mean_raw = mean_norm * np.asarray(stats.data_range)
    order = descending_order(mean_norm)
    cols = {"feature": np.asarray(schema.feature_names)[order],
            "mean_abs_shift_normalized": mean_norm[order],
            "mean_abs_shift_raw": mean_raw[order]}
    if out_dir:
        _write(out_dir, "feature_shift_importance.csv", cols)
        fig = Figure(figsize=(12, 6), dpi=120)
        for ax, col, title in zip(
                fig.subplots(1, 2)[0],
                ("mean_abs_shift_normalized", "mean_abs_shift_raw"),
                ("normalized", "raw units")):
            # the least shifted feature at the bottom
            ax.barh(cols["feature"][::-1], cols[col][::-1])
            ax.set_title(f"Mean |shift| ({title})")
        fig.save(os.path.join(out_dir, "feature_shift_importance.png"))
    return cols


def class_pair_sensitivity(sweep: dict, x, y, schema,
                           out_dir: str | None = None) -> list[dict]:
    """Mean |x_cf - x| per feature for each (source, target) pair over
    the source's rows (`eval_utils.py:351-434`); with `out_dir`,
    `class_pair_sensitivity/class_pair_sensitivity.csv` there."""
    x, y = np.asarray(x), np.asarray(y)
    n_classes = sweep["x_cf"].shape[0]
    records = []
    for s in range(n_classes):
        for t in range(n_classes):
            sel = y == s
            if s == t or not sel.any():
                continue
            d = np.abs(sweep["x_cf"][t][sel] - x[sel]).mean(axis=0)
            records += [{"source": s, "target": t, "feature": f,
                         "mean_abs_shift": float(v)}
                        for f, v in zip(schema.feature_names, d)]
    if out_dir and records:
        pair_dir = os.path.join(out_dir, "class_pair_sensitivity")
        _write(pair_dir, "class_pair_sensitivity.csv", records)
        for s in sorted({r["source"] for r in records}):
            targets, table = pair_table(records, s, schema.feature_names)
            fig = Figure(figsize=(6, 7), dpi=120)
            ax = fig.subplots()[0, 0]
            im = ax.imshow(table, cmap="viridis", aspect="auto")
            ax.set_yticks(range(len(schema.feature_names)),
                          schema.feature_names)
            ax.tick_size = 8.0
            ax.set_xticks(range(len(targets)), [str(t) for t in targets])
            ax.set_xlabel("target class")
            ax.set_title(f"Mean |shift| from source class {s}")
            ax.add_colorbar(im)
            fig.save(os.path.join(pair_dir, f"src{s}.png"))
    return records


def pair_table(records, source: int, feature_names
               ) -> tuple[list[int], np.ndarray]:
    """(targets, (features, targets) float64 table) of one source's mean
    |shift| records: pandas' `pivot(index="feature", columns="target")`
    reindexed to the schema's feature order (NaN where none)."""
    rows = [r for r in records if r["source"] == source]
    targets = sorted({r["target"] for r in rows})
    table = np.full((len(feature_names), len(targets)), np.nan)
    fi = {f: i for i, f in enumerate(feature_names)}
    ti = {t: j for j, t in enumerate(targets)}
    for r in rows:
        if r["feature"] in fi:
            table[fi[r["feature"]], ti[r["target"]]] = r["mean_abs_shift"]
    return targets, table


def case_study_report(sweep: dict, x, y, schema, stats, out_dir: str,
                      n_samples: int = 20, seed: int = 0,
                      change_threshold: float = 1e-3, top_k: int = 5
                      ) -> list[dict]:
    """The case-study CSV tree (`eval_utils.py:496-664`): for `n_samples`
    rows drawn by `np.random.RandomState(seed)`, each with a random target
    other than its label, `samples/src{S}_tgt{T}/sample_{i}.csv` (every
    feature's original and counterfactual value in raw units, the change,
    |delta| normalized, changed, immutable), and the sample, feature and
    aggregate summaries.  Returns the sample summary's rows."""
    x, y = np.asarray(x), np.asarray(y)
    rng = np.random.RandomState(seed)
    n_classes = sweep["x_cf"].shape[0]
    idx = rng.choice(len(y), size=min(n_samples, len(y)), replace=False)
    data_min = np.asarray(stats.data_min)
    data_rng = np.asarray(stats.data_range)
    names = list(schema.feature_names)
    immutable = np.asarray([f in schema.immutable_features for f in names])
    sample_rows, abs_deltas = [], []
    for i in idx:
        s = int(y[i])
        t = int(rng.choice([c for c in range(n_classes) if c != s]))
        orig_n, cf_n = x[i], sweep["x_cf"][t, i]
        orig_raw = orig_n * data_rng + data_min
        cf_raw = cf_n * data_rng + data_min
        delta = np.abs(cf_n - orig_n)
        changed = delta > change_threshold
        _write(os.path.join(out_dir, "samples", f"src{s}_tgt{t}"),
               f"sample_{i}.csv",
               {"feature": names, "original": orig_raw,
                "counterfactual": cf_raw, "change": cf_raw - orig_raw,
                "abs_delta_normalized": delta, "changed": changed,
                "immutable": immutable})
        sample_rows.append({
            "sample": int(i), "source": s, "target": t,
            "flipped": int(sweep["preds_cf"][t, i] == t),
            "n_changed": int(changed.sum()),
            "frac_changed": float(changed.mean()),
            "sparsity": float(1.0 - changed.mean()),
            "l1_normalized": float(delta.sum()),
            "top_changed": ";".join(names[j] for j in largest(delta, top_k))})
        abs_deltas.append(delta)
    _write(out_dir, "case_study_sample_summary.csv", sample_rows)
    feat = _float32_group_mean(abs_deltas)
    pct = np.float32(100.0) * feat
    _write(out_dir, "case_study_feature_summary.csv",
           {"feature": names, "abs_delta_normalized": feat,
            "pct_of_range": pct})

    def mean_of(key):
        return float(np.mean([r[key] for r in sample_rows]))

    _write(out_dir, "case_study_aggregate_summary.csv", [{
        "n_samples": len(sample_rows), "flip_rate": mean_of("flipped"),
        "mean_sparsity": mean_of("sparsity"),
        "mean_frac_changed": mean_of("frac_changed"),
        "top_features": ";".join(names[j] for j in largest(pct, top_k))}])
    return sample_rows
