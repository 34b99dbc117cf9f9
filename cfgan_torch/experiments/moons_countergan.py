"""Moons CounteRGAN experiment on the port (mirrors
`cfgan/experiments/moons_countergan.py`): the 2-D three-class moons ->
train the MLP classifier (full batch) or load it -> classifier eval ->
train the CounteRGAN with the epoch runner, or load it -> pick the
serving snapshot on the training set -> per-target metrics under the
all-ones mask and under each of four mask policies -> the provenance
record.

    python -m cfgan_torch.experiments.moons_countergan [--epochs N]
        [--clf-steps N] [--seed N] [--out-dir D] [--fresh] [--reference]
        [--device cpu]

The run dir is the JAX package's: `classifier/` (with the normalization
stats in its metadata), `generator/` (the served variables, with the
`serving_selection` record), `train_state/` (mid-run checkpoints),
`classifier_eval/`, `countergan_metrics.csv`,
`countergan_metrics_per_mask.csv` (the policies both, x_only, y_only and
none, `mask` the first column) and `run_provenance.json`; its
checkpoints restore in either package.  A stage whose checkpoint exists
is loaded, not trained again, unless `fresh`.  The figures are the JAX
run dir's: `loss_curves.png` where the CounteRGAN trains, and on every
run `classifier_eval/confusion_matrix.png`, `decision_boundaries.png` and
`boundaries/decision_boundaries_cfs_src{s}_tgt{t}.png` for each pair of
classes s != t.
"""
from __future__ import annotations

import argparse
import os
import time
from dataclasses import replace

import torch

from cfgan_torch.convert import flax_from_state_dict, state_dict_from_flax
from cfgan_torch.core import checkpoint as ckpt
from cfgan_torch.core.device import resolve_device
from cfgan_torch.core.logging import setup_compile_cache
from cfgan_torch.core.provenance import (
    clear_stale,
    serving_candidate_of,
    write_run_provenance,
)
from cfgan_torch.data.moons import load_moons3
from cfgan_torch.data.pipeline import stream_seed
from cfgan_torch.eval.boundaries import (
    plot_decision_boundaries_and_cfs,
    plot_decision_boundaries_only,
)
from cfgan_torch.eval.classifier import evaluate_classifier
from cfgan_torch.eval.metrics import (
    TABULAR_PROTOCOL,
    make_per_target_sweep,
    per_target_metrics,
    write_csv,
)
from cfgan_torch.experiments import presets
from cfgan_torch.masks.feature import immutable_complement_mask
from cfgan_torch.models.classifiers import MLPClassifier
from cfgan_torch.train.builders import (
    build_moons_countergan,
    g_serving_variables,
)
from cfgan_torch.train.classifier import make_eval_fn, train_classifier
from cfgan_torch.train.loop import plot_loss_curves, train_countergan_loop
from cfgan_torch.train.selection import SnapshotSelector

# the mask policies of `countergan_metrics_per_mask.csv`: which of (x, y)
# the counterfactual may move
MASK_POLICIES = {"both": (1.0, 1.0), "x_only": (1.0, 0.0),
                 "y_only": (0.0, 1.0), "none": (0.0, 0.0)}


def _load_classifier(clf_dir: str, model: MLPClassifier, dev) -> None:
    template = flax_from_state_dict(model, model.state_dict())
    model.load_state_dict(state_dict_from_flax(
        model, ckpt.restore(clf_dir, template)))
    model.to(dev).eval()


def _policy_mask(row, dev):
    def mask_fn(b):
        return torch.tensor(row, dtype=torch.float32, device=dev).expand(b, 2)

    return mask_fn


def run(cfg=presets.MOONS_COUNTERGAN, out_dir: str | None = None,
        fresh: bool = False, device: str | torch.device | None = None,
        log=print) -> dict:
    """Run the experiment into `out_dir` (default `cfg.out_dir/cfg.name`)
    on `device` (None: the CUDA card).  Returns the classifier eval, the
    per-target metrics (all-ones mask, and by mask policy), the served
    generator variables, the training history, the selection record, the
    bundle and each stage's wall seconds (`stage_seconds`)."""
    dev = resolve_device(device)
    out_dir = out_dir or os.path.join(cfg.out_dir, cfg.name)
    os.makedirs(out_dir, exist_ok=True)
    seconds = {}
    t0 = time.perf_counter()
    (xtr, ytr), (xte, yte), stats = load_moons3(seed=cfg.data.seed)
    seconds["data"] = time.perf_counter() - t0
    n_classes = cfg.num_classes

    # ---- stage 1: the classifier (moons/main.py:19-23) ----
    t0 = time.perf_counter()
    clf_model = MLPClassifier(
        n_classes, cfg.classifier.hidden_dim,
        generator=torch.Generator().manual_seed(cfg.seed))
    clf_dir = os.path.join(out_dir, "classifier")
    if ckpt.exists(clf_dir) and not fresh:
        _load_classifier(clf_dir, clf_model, dev)
        log(f"Loaded classifier from {clf_dir}")
    else:
        train_classifier(clf_model, cfg.classifier, (xtr, ytr), seed=cfg.seed,
                         log=log, device=dev)
        log(f"[Classifier] {cfg.classifier.steps} full-batch steps")
        ckpt.save(clf_dir, flax_from_state_dict(clf_model,
                                                clf_model.state_dict()),
                  metadata={"stats": stats.to_metadata()})
    seconds["classifier"] = time.perf_counter() - t0
    logits_fn, _ = make_eval_fn(clf_model)
    clf_eval = evaluate_classifier(
        logits_fn, xte, yte, out_dir=os.path.join(out_dir, "classifier_eval"),
        device=dev)
    log(f"Classifier test accuracy: {clf_eval['accuracy']:.4f}")

    # ---- stage 2: the CounteRGAN (moons/main.py:49-52) ----
    t0 = time.perf_counter()
    bundle = build_moons_countergan(cfg.countergan, clf_model.state_dict(),
                                    seed=cfg.seed, device=dev)
    g_model = bundle.state.g.model
    sweep = make_per_target_sweep(bundle.cf_fn, logits_fn, n_classes,
                                  **TABULAR_PROTOCOL)
    gen_dir = os.path.join(out_dir, "generator")
    history, selection_s = {}, 0.0
    if ckpt.exists(gen_dir) and not fresh:
        template = flax_from_state_dict(g_model, g_model.state_dict())
        g_vars = {k: v.to(dev) for k, v in state_dict_from_flax(
            g_model, ckpt.restore(gen_dir, template)).items()}
        log(f"Loaded generator from {gen_dir}")
    else:
        xtr_d = torch.as_tensor(xtr).to(dev)
        recal_seed = stream_seed(cfg.seed, 777)
        immutable = cfg.countergan.mask.immutable_idx
        selector = None
        if cfg.countergan.snapshot_every:
            # score each rung's candidates on the training set (moons has
            # no validation split; test is never seen) under the
            # immutable-complement mask: sorted per-target flips, then
            # their mean
            def snapshot_score(g_vars):
                cols = per_target_metrics(
                    sweep, g_vars, xtr, ytr,
                    mask_fn=lambda b: immutable_complement_mask(
                        b, 2, immutable, device=dev),
                    num_classes=n_classes)
                flips = cols["class_flip_rate"]
                return tuple(sorted(flips.tolist())) + (float(flips.mean()),)

            selector = SnapshotSelector(
                bundle, score_fn=snapshot_score,
                every=cfg.countergan.snapshot_every,
                total_epochs=cfg.countergan.epochs, x_recal=xtr_d,
                recal_seed=recal_seed)

        def epoch_cb(epoch, state):
            nonlocal selection_s
            t = time.perf_counter()
            selector.epoch_cb(epoch, state)
            selection_s += time.perf_counter() - t

        state, history = train_countergan_loop(
            bundle, xtr_d, ytr, epochs=cfg.countergan.epochs,
            batch_size=cfg.data.batch_size, seed=cfg.seed, log=log,
            checkpoint_dir=os.path.join(out_dir, "train_state"),
            checkpoint_every=max(1, cfg.countergan.epochs // 4),
            resume=not fresh,
            epoch_cb=epoch_cb if selector is not None else None)
        t = time.perf_counter()
        if selector is not None:
            g_vars, sel_info = selector.best()
            log(f"Serving candidate: {sel_info['candidate']} (ladder of "
                f"{len(sel_info['ladder'])} scored snapshots)")
        else:
            # the live variables without an EMA; with one, the EMA
            # parameters and statistics recalibrated under them
            g_vars = g_serving_variables(
                bundle, state, xtr_d,
                torch.Generator(device=dev).manual_seed(recal_seed))
            sel_info = {"candidate": ("ema_recal_train"
                                      if cfg.countergan.ema_decay
                                      else "live"), "scores": {}}
        selection_s += time.perf_counter() - t
        ckpt.save(gen_dir, flax_from_state_dict(g_model, g_vars),
                  metadata={"serving_selection": sel_info})
        plot_loss_curves(history, os.path.join(out_dir, "loss_curves.png"))
    seconds["countergan"] = time.perf_counter() - t0 - selection_s
    seconds["selection"] = selection_s

    # ---- stage 3: evaluation (moons/eval_utils.py:227-268) ----
    t0 = time.perf_counter()
    per_target = per_target_metrics(
        sweep, g_vars, xte, yte, mask_fn=_policy_mask((1.0, 1.0), dev),
        num_classes=n_classes)
    write_csv(os.path.join(out_dir, "countergan_metrics.csv"), per_target)
    log(f"Per-target flips: {per_target['class_flip_rate']}")
    # the mask-policy sweep the reference sketches (commented out at
    # moons/eval_utils.py:232-251)
    rows = []
    per_mask = {}
    for name, row in MASK_POLICIES.items():
        cols = per_target_metrics(sweep, g_vars, xte, yte,
                                  mask_fn=_policy_mask(row, dev),
                                  num_classes=n_classes)
        per_mask[name] = cols
        rows += [{"mask": name, **dict(zip(cols, vals))}
                 for vals in zip(*cols.values())]
    write_csv(os.path.join(out_dir, "countergan_metrics_per_mask.csv"), rows)
    plot_decision_boundaries_only(
        logits_fn, xte, yte, os.path.join(out_dir, "decision_boundaries.png"),
        num_classes=n_classes, device=dev)
    plot_decision_boundaries_and_cfs(
        logits_fn, bundle.cf_fn, g_vars, xte, yte, n_classes,
        os.path.join(out_dir, "boundaries"), device=dev)
    clear_stale(out_dir)
    write_run_provenance(
        out_dir, preset=cfg.name, seed=cfg.seed,
        serving_candidate=serving_candidate_of(out_dir),
        per_target_csv="countergan_metrics.csv",
        extra={"classifier_test_accuracy": clf_eval["accuracy"]})
    seconds["eval"] = time.perf_counter() - t0
    return {"classifier": clf_eval, "per_target": per_target,
            "per_mask": per_mask, "g_vars": g_vars, "history": history,
            "serving_selection": (ckpt.load_metadata(gen_dir) or {}).get(
                "serving_selection", {}),
            "bundle": bundle, "stage_seconds": seconds}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--clf-steps", type=int, default=None)
    ap.add_argument("--out-dir", type=str, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--reference", action="store_true",
                    help="the reference's exact recipe "
                         "(moons_countergan_reference)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    setup_compile_cache()  # where the kernel and data libraries build
    cfg = (presets.MOONS_COUNTERGAN_REFERENCE if args.reference
           else presets.MOONS_COUNTERGAN)
    if args.seed is not None:
        cfg = cfg.replace(seed=args.seed)
    if args.epochs is not None:
        cfg = cfg.replace(countergan=replace(cfg.countergan,
                                             epochs=args.epochs))
    if args.clf_steps is not None:
        cfg = cfg.replace(classifier=replace(cfg.classifier,
                                             steps=args.clf_steps))
    run(cfg, out_dir=args.out_dir, fresh=args.fresh, device=args.device)


if __name__ == "__main__":
    main()
