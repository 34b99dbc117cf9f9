"""Bring your own tabular dataset to the PyTorch port (`cfgan_torch`): the
port of `examples/custom_tabular.py`.

A new dataset is a `TabularSchema` (feature names, the features no
counterfactual may change, the categorical features' values) and arrays.
This example makes a synthetic credit-risk table and runs the promptable
counterfactual stack on it:

  1. the schema and MinMax stats (fit on the training rows only), built
     by hand here to show every field; `TabularSchema.from_dataframe(df,
     immutable=..., exclude=...)` infers one from a table in one line;
  2. classifier pretraining;
  3. CounteRGAN training (FiLM generator with Gumbel-softmax categorical
     heads, spectral-norm Wasserstein critic, the four-term loss) through
     the epoch runner, as the King County house family trains;
  4. the all-target evaluation (flip rate, prediction gain,
     actionability);
  5. promptable serving with a mask by feature names ("what should I
     change, if my savings and debt are negotiable, to be low-risk?").

On the CUDA card:  python examples/torch_custom_tabular.py
(`--device cpu` runs it on the CPU.)  It imports neither JAX nor the JAX
package.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# run straight from a checkout (pip install -e . works too)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NUM_CLASSES = 3
ALLOWED = ["savings", "debt_ratio", "late_payments"]  # the negotiables


def make_credit_dataset(n: int = 4000, seed: int = 7):
    """Synthetic three-class credit-risk table with a learnable rule."""
    rng = np.random.RandomState(seed)
    income = rng.lognormal(10.6, 0.5, n)  # yearly
    age = rng.uniform(21, 75, n).round()
    debt_ratio = rng.beta(2, 5, n)
    late_payments = rng.choice([0, 1, 2, 3, 4, 5], n,
                               p=[0.5, 0.2, 0.12, 0.08, 0.06, 0.04])
    num_accounts = rng.choice(range(1, 11), n)
    has_mortgage = (rng.uniform(0, 1, n) < 0.4).astype(float)
    savings = rng.lognormal(8.5, 1.2, n)
    score = (
        0.9 * (income / 60_000)
        + 0.6 * (savings / 20_000)
        - 1.6 * debt_ratio
        - 0.45 * late_payments
        + 0.3 * has_mortgage
        + rng.normal(0, 0.35, n)
    )
    y = np.digitize(score, np.quantile(score, [1 / 3, 2 / 3]))  # 0=high risk
    x = np.stack([income, age, debt_ratio, late_payments.astype(float),
                  num_accounts.astype(float), has_mortgage, savings], 1)
    return x.astype(np.float32), y.astype(np.int32)


def main(device: str | None = None, clf_epochs: int = 30,
         epochs: int = 30) -> dict:
    """Train, evaluate and serve on `device` (None: the CUDA card; raises
    where there is none).  Returns the classifier's test accuracy, the
    per-target metrics and the features the served counterfactual
    changed; raises AssertionError where it changed a feature outside
    `ALLOWED`."""
    import torch

    from cfgan_torch.core.config import (
        ClassifierConfig,
        CounterGANConfig,
        TabularSchema,
    )
    from cfgan_torch.core.device import resolve_device
    from cfgan_torch.data.transforms import fit_minmax
    from cfgan_torch.eval.tabular import (
        immutable_mask,
        per_target_metrics_from_sweep,
        sweep_all_targets,
    )
    from cfgan_torch.models.classifiers import TabularClassifier
    from cfgan_torch.models.tabular import jax_key
    from cfgan_torch.train.builders import (
        build_tabular_countergan,
        house_engine,
        live_g_variables,
    )
    from cfgan_torch.train.classifier import make_eval_fn, train_classifier
    from cfgan_torch.train.loop import train_countergan_loop

    dev = resolve_device(device)

    # ---- 1. schema: names, what may not change, what is discrete ----
    schema = TabularSchema(
        feature_names=("income", "age", "debt_ratio", "late_payments",
                       "num_accounts", "has_mortgage", "savings"),
        immutable_features=("age",),  # counterfactuals may not change age
        categorical_values={
            "late_payments": (0.0, 1.0, 2.0, 3.0, 4.0, 5.0),
            "num_accounts": tuple(float(v) for v in range(1, 11)),
            "has_mortgage": (0.0, 1.0),
        },
    )
    x, y = make_credit_dataset()
    n_train = int(0.8 * len(y))
    xtr_raw, ytr = x[:n_train], y[:n_train]
    xte_raw, yte = x[n_train:], y[n_train:]
    stats = fit_minmax(xtr_raw)  # fit on the training rows only
    xtr = np.asarray(stats.transform(xtr_raw), np.float32)
    xte = np.asarray(stats.transform(xte_raw), np.float32)

    # ---- 2. classifier ----
    # `class_weighted` weighs the loss only where `num_classes` is given;
    # like the JAX example, this one gives none
    clf_model = TabularClassifier(NUM_CLASSES, schema.input_dim,
                                  generator=torch.Generator().manual_seed(0))
    train_classifier(
        clf_model,
        ClassifierConfig(arch="tabular", lr=1e-3, epochs=clf_epochs,
                         batch_size=128, class_weighted=True),
        (xtr, ytr), valid_set=(xte, yte), seed=0, device=dev)
    logits_fn, accuracy = make_eval_fn(clf_model)
    acc = accuracy(xte, yte)
    print(f"classifier test accuracy: {acc:.3f}")

    # ---- 3. CounteRGAN ----
    cfg = CounterGANConfig(
        epochs=epochs, lr_g=1e-3, lr_d=1e-3, lambda_cls=2.0,
        lambda_reg_l1=1.0, lambda_mask=1.0, adv_loss="wasserstein",
        reg_reduction="per_sample_norm", clamp_cf=(0.0, 1.0),
        resample_target=True, hidden_dim=32, num_res_blocks=3,
        gumbel_tau=0.5,
    )
    bundle = build_tabular_countergan(cfg, clf_model.state_dict(), schema,
                                      stats, num_classes=NUM_CLASSES, seed=0,
                                      device=dev)
    state, _ = train_countergan_loop(bundle, xtr, ytr, epochs=cfg.epochs,
                                     batch_size=128, seed=0)

    # ---- 4. evaluation: every target on the test rows ----
    g_vars = live_g_variables(state)
    sweep = sweep_all_targets(
        bundle.cf_fn, logits_fn, g_vars, torch.as_tensor(xte, device=dev),
        immutable_mask(len(yte), schema, device=dev), NUM_CLASSES,
        jax_key(1))
    table = per_target_metrics_from_sweep(sweep, xte, yte, NUM_CLASSES)
    for row in zip(*table.values()):
        print("  ".join(f"{k}={v:.4f}" if isinstance(v, float) else
                        f"{k}={v}" for k, v in zip(table, row)))

    # ---- 5. promptable serving with a mask by feature names ----
    engine = house_engine(bundle, logits_fn, state=state, device=dev)
    sample = xte[yte == 0][:1]  # one high-risk applicant
    res = engine.generate(
        sample, target=2, mask=engine.mask_from_feature_names(ALLOWED, 1))
    cf_raw = np.asarray(engine.stats.inverse_transform(res.x_cf))[0]
    orig_raw = np.asarray(engine.stats.inverse_transform(sample))[0]
    print(f"\nhigh-risk -> low-risk counterfactual "
          f"(flipped={bool(res.flipped[0])}, "
          f"confidence={float(res.confidence[0]):.2f}):")
    changed = set()
    for i, name in enumerate(schema.feature_names):
        if abs(cf_raw[i] - orig_raw[i]) > 1e-6:
            changed.add(name)
            print(f"  {name}: {orig_raw[i]:,.2f} -> {cf_raw[i]:,.2f}")
    if not changed <= set(ALLOWED):
        raise AssertionError(f"counterfactual touched non-allowed features: "
                             f"{changed - set(ALLOWED)}")
    print("(only the allowed features changed: mask respected)")
    return {"accuracy": acc,
            "class_flip_rate": [float(v) for v in table["class_flip_rate"]],
            "mean_flip_rate": float(np.nanmean(table["class_flip_rate"])),
            "changed": sorted(changed), "flipped": bool(res.flipped[0])}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    main(parser.parse_args().device)
