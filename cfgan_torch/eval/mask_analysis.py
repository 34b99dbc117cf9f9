"""How counterfactual quality depends on what the mask lets change (mirrors
`cfgan/eval/mask_analysis.py`: its CSVs and its two plots).

- `analyze_mask_policies` (tabular): per-target metrics under the
  policies `all_mutable` (every mutable feature, the eval default),
  `random_half` (Bernoulli(0.5) over the mutable features, the training
  distribution, drawn by `np.random.RandomState(seed)` as the JAX package
  draws it), `single:<feature>` (one mutable feature at a time) and
  `top{k}:...` (only the k features that `all_mutable` shifted most);
- `patch_budget_curve` (images): flip rate, mean target probability and
  actionability against the number of modifiable patches.  The JAX
  package draws its patch masks from its keys, which torch cannot
  reproduce: here they come from a `torch.Generator`, or are given.

`mask_policy_analysis.png` shows each policy's mean flip rate over the
targets, in the JAX package's order: pandas' `groupby("policy")` (names
sorted, a Kahan-compensated float64 mean) then `sort_values("flip")`,
numpy's quicksort of those means (NaN last).  `patch_budget_curve.png`
draws the flip rate and the mean target probability against the budget.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from cfgan_torch.core.device import resolve_device
from cfgan_torch.eval.figure import Figure
from cfgan_torch.eval.metrics import write_csv
from cfgan_torch.eval.tabular import (
    immutable_mask,
    per_target_metrics_from_sweep,
    sweep_all_targets,
)
from cfgan_torch.masks.patch import patch_grid_dims, random_patch_mask

BUDGETS = (1, 2, 4, 6, 8, 10, 12)  # modifiable patches, with all of them


def _mask_from_idx(batch: int, dim: int, idx) -> np.ndarray:
    m = np.zeros((batch, dim), np.float32)
    if len(idx):
        m[:, list(idx)] = 1.0
    return m


def analyze_mask_policies(cf_fn, clf_fn, g_vars, x, y, schema,
                          num_classes: int, key, out_dir: str | None = None,
                          top_k: int = 5, max_samples: int = 1024,
                          seed: int = 0,
                          device: str | torch.device | None = None
                          ) -> list[dict]:
    """Per-target metrics of the first `max_samples` rows under each mask
    policy, all with the Gumbel noise of `key` (a JAX key pair); rows
    `policy, n_modifiable, target_class, class_flip_rate,
    prediction_gain, avg_actionability` in the JAX package's order.  With
    `out_dir`, `mask_policy_analysis.csv` there."""
    device = resolve_device(device)
    x = np.asarray(x)[:max_samples]
    y = np.asarray(y)[:max_samples]
    b, d = x.shape
    mutable = [i for i in range(d) if i not in schema.immutable_idx]
    rng = np.random.RandomState(seed)
    rh = (rng.uniform(0, 1, (b, d)) > 0.5).astype(np.float32)
    rh[:, list(schema.immutable_idx)] = 0.0
    policies = {"all_mutable": immutable_mask(b, schema).numpy(),
                "random_half": rh}
    for i in mutable:
        policies[f"single:{schema.feature_names[i]}"] = _mask_from_idx(
            b, d, [i])
    xd = torch.as_tensor(x).to(device)
    rows = []

    def add(name, mask, n_modifiable):
        sweep = sweep_all_targets(cf_fn, clf_fn, g_vars, xd,
                                  torch.as_tensor(mask).to(device),
                                  num_classes, key)
        cols = per_target_metrics_from_sweep(sweep, x, y, num_classes)
        rows.extend({"policy": name, "n_modifiable": n_modifiable,
                     **dict(zip(cols, vals))} for vals in zip(*cols.values()))
        return sweep

    shifts = None
    for name, mask in policies.items():
        sweep = add(name, mask, int(mask[0].sum()))
        if name == "all_mutable":
            shifts = np.concatenate(
                [np.abs(sweep["x_cf"][t] - x) for t in range(num_classes)],
                0).mean(axis=0)
    order = np.argsort(-shifts)
    top_idx = [i for i in order if i in mutable][:top_k]
    add(f"top{top_k}:" + "+".join(schema.feature_names[i] for i in top_idx),
        _mask_from_idx(b, d, top_idx), top_k)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        write_csv(os.path.join(out_dir, "mask_policy_analysis.csv"), rows)
        plot_mask_policies(rows, os.path.join(out_dir,
                                              "mask_policy_analysis.png"))
    return rows


def policy_flip_means(rows) -> tuple[list[str], np.ndarray]:
    """(policies, mean flip rates) in the bar order of the JAX plot:
    `df.groupby("policy").agg(flip=("class_flip_rate", "mean"))
    .sort_values("flip")`.  The group mean skips NaN and sums with
    pandas' Kahan compensation; the sort is numpy's quicksort of the
    name-sorted means, NaN last, as pandas' `nargsort` calls it."""
    names = sorted({r["policy"] for r in rows})
    means = []
    for name in names:
        total = comp = 0.0
        count = 0
        for r in rows:
            v = float(r["class_flip_rate"])
            if r["policy"] != name or v != v:
                continue
            y = v - comp
            t = total + y
            comp = t - total - y
            total = t
            count += 1
        means.append(total / count if count else float("nan"))
    means = np.asarray(means)
    finite = np.nonzero(~np.isnan(means))[0]
    order = np.concatenate([finite[means[finite].argsort(kind="quicksort")],
                            np.nonzero(np.isnan(means))[0]])
    return [names[i] for i in order], means[order]


def plot_mask_policies(rows, path: str) -> str:
    """Each policy's mean flip rate over the targets as horizontal bars,
    lowest at the bottom (`policy_flip_means`)."""
    names, flips = policy_flip_means(rows)
    fig = Figure(figsize=(7, max(3, 0.3 * len(names))), dpi=120)
    ax = fig.subplots()[0, 0]
    ax.barh(names, flips)
    ax.set_xlabel("mean flip rate across targets")
    ax.set_title("Counterfactual flip rate by mask policy")
    return fig.save(path)


def patch_budget_curve(cf_fn, clf_fn, g_vars, x, y, num_classes: int,
                       patch_size: int, budgets=None, key=None,
                       out_dir: str | None = None, max_samples: int = 512,
                       seed: int = 0, generator: torch.Generator | None = None,
                       masks=None, device: str | torch.device | None = None
                       ) -> list[dict]:
    """Counterfactual success against the patch budget: for each budget
    (default 1, 2, 4, 6, 8, 10, 12 and all patches) a random patch mask
    per row (from `generator`, or `masks[i]` for the i-th budget), targets
    from `np.random.RandomState(seed)`, on the first `max_samples` images
    (NHWC).  Rows `n_patches, frac_area, flip_rate, mean_target_prob,
    actionability`; with `out_dir`, `patch_budget_curve.csv` there."""
    device = resolve_device(device)
    x = np.asarray(x)[:max_samples]
    b, h, w = x.shape[:3]
    ph, pw = patch_grid_dims(h, w, patch_size)
    total = ph * pw
    budgets = budgets or sorted({*BUDGETS, total})
    t = torch.as_tensor(np.random.RandomState(seed).randint(
        0, num_classes, b)).to(device)
    xd = torch.as_tensor(x).to(device)
    if masks is None and generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    rows = []
    with torch.no_grad():
        for i, budget in enumerate(budgets):
            mask = (torch.tensor(masks[i], device=device) if masks is not None
                    else random_patch_mask(b, (h, w), patch_size, budget,
                                           channels=x.shape[-1],
                                           generator=generator,
                                           device=device))
            x_cf, _, _ = cf_fn(g_vars, xd, t, mask, key)
            logits = clf_fn(x_cf)
            probs = F.softmax(logits, dim=1)
            rows.append({
                "n_patches": int(budget), "frac_area": budget / total,
                "flip_rate": float((logits.argmax(1) == t).float().mean()),
                "mean_target_prob": float(
                    probs.gather(1, t[:, None]).mean()),
                "actionability": float((x_cf - xd).abs().mean())})
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        write_csv(os.path.join(out_dir, "patch_budget_curve.csv"), rows)
        plot_patch_budget(rows, patch_size,
                          os.path.join(out_dir, "patch_budget_curve.png"))
    return rows


def plot_patch_budget(rows, patch_size: int, path: str) -> str:
    """The flip rate (circles) and the mean target probability (squares)
    against the number of modifiable patches, y from 0 to 1.05."""
    budgets = [r["n_patches"] for r in rows]
    fig = Figure(figsize=(6, 4), dpi=120)
    ax = fig.subplots()[0, 0]
    ax.plot(budgets, [r["flip_rate"] for r in rows], marker="o",
            label="flip rate")
    ax.plot(budgets, [r["mean_target_prob"] for r in rows], marker="s",
            label="mean target prob")
    ax.set_xlabel(f"modifiable {patch_size}x{patch_size} patches")
    ax.set_ylim(0, 1.05)
    ax.legend()
    ax.set_title("Counterfactual success vs patch budget")
    return fig.save(path)
