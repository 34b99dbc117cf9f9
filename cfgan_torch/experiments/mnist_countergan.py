"""MNIST CounteRGAN experiment on the port (mirrors
`cfgan/experiments/mnist_countergan.py`): load MNIST or the synthetic
corpus -> pretrain or load the CNN classifier -> classifier eval -> train
the CounteRGAN with the epoch runner, or load it -> pick the serving
snapshot on validation data -> evaluation CSVs.

    python -m cfgan_torch.experiments.mnist_countergan [--epochs N]
        [--clf-epochs N] [--limit N] [--seed N] [--out-dir D] [--fresh]
        [--legacy] [--device cpu]

`--legacy` runs the legacy stack instead (preset
`mnist_countergan_legacy`): the MaxPool `LegacyCNNClassifier`, the
mask-free `DeltaImageGenerator` and the unconditional
`ConvDiscriminator`, trained toward one fixed target with all-ones
masks (`run(legacy_delta=True)`).

The run dir is the JAX package's: `classifier/`, `generator/` (the served
variables, with the `serving_selection` record in its metadata),
`train_state/` (mid-run checkpoints), `classifier_eval/`
(`confusion_matrix.csv`, `classifier_report.txt`),
`countergan_metrics.csv`, `countergan_metrics_per_class.csv`,
`masked_metrics.csv`, `patch_budget_curve.csv` (the flip rate against the
number of modifiable patches) and `run_provenance.json`; its checkpoints
restore in either package.  A stage whose checkpoint exists is loaded,
not trained again, unless `fresh`.

The figures are the JAX run dir's: `classifier_training_curves.png` and
`gan_losses.png` where their stage trains; on every run
`classifier_eval/confusion_matrix.png`, `cf_grid.png` (source x target),
`eval_visuals/sample_{0..7}.png` and `batch_overview.png` (the first 8
test images, their random targets, a random patch mask at the training
budget), `patch_budget_curve.png`, `patch_grid.png` and
`user_modification_example.png` (`xte[0]` toward 3 through patches
6-11).  Each figure's counterfactuals are one `cf_fn` call: with
`conv_impl="pallas"`, through the conv kernel.
"""
from __future__ import annotations

import argparse
import os
import time
from dataclasses import replace

import numpy as np
import torch

from cfgan_torch.convert import flax_from_state_dict, state_dict_from_flax
from cfgan_torch.core import checkpoint as ckpt
from cfgan_torch.core.device import resolve_device
from cfgan_torch.core.logging import setup_compile_cache
from cfgan_torch.core.provenance import clear_stale, write_run_provenance
from cfgan_torch.data.mnist import load_mnist
from cfgan_torch.data.pipeline import stream_seed
from cfgan_torch.eval.classifier import evaluate_classifier
from cfgan_torch.eval.images import (
    counterfactual_grid,
    heatmap_panels,
    patch_grid_overlay,
    user_modification_example,
)
from cfgan_torch.eval.mask_analysis import patch_budget_curve
from cfgan_torch.eval.metrics import (
    MNIST_PROTOCOL,
    evaluate_counterfactual_batch,
    make_per_target_sweep,
    masked_metrics,
    per_target_metrics,
    write_csv,
)
from cfgan_torch.experiments.presets import (
    MNIST_COUNTERGAN,
    MNIST_COUNTERGAN_LEGACY,
)
from cfgan_torch.masks.patch import patch_grid_dims, random_patch_mask
from cfgan_torch.models.classifiers import CNNClassifier, LegacyCNNClassifier
from cfgan_torch.train.builders import (
    build_mnist_countergan,
    select_g_serving_variables,
)
from cfgan_torch.train.classifier import (
    make_eval_fn,
    plot_classifier_curves,
    train_classifier,
)
from cfgan_torch.train.loop import plot_loss_curves, train_countergan_loop
from cfgan_torch.train.selection import SnapshotSelector

SCORE_SUBSAMPLE = 8192  # training images added to the validation scoring
VISUAL_SAMPLES = 8  # test images of the heatmap panels
USER_TARGET, USER_PATCHES = 3, range(6, 12)  # the user-modification example


def run(cfg=MNIST_COUNTERGAN, out_dir: str | None = None, fresh: bool = False,
        limit: int | None = None, device: str | torch.device | None = None,
        log=print, legacy_delta: bool = False) -> dict:
    """Run the experiment into `out_dir` (default `cfg.out_dir/cfg.name`)
    on `device` (None: the CUDA card); `legacy_delta` runs the legacy
    stack (`LegacyCNNClassifier`, `build_mnist_countergan(legacy_delta=
    True)`).  Returns the classifier eval, the batch and per-target
    metrics, the served generator variables, the training history and
    each stage's wall seconds (`stage_seconds`)."""
    dev = resolve_device(device)
    out_dir = out_dir or os.path.join(cfg.out_dir, cfg.name)
    os.makedirs(out_dir, exist_ok=True)
    seconds = {}
    t0 = time.perf_counter()
    (xtr, ytr), (xva, yva), (xte, yte) = load_mnist(
        path=cfg.data.path, seed=cfg.data.seed,
        valid_fraction=cfg.data.valid_fraction, limit=limit)
    seconds["data"] = time.perf_counter() - t0

    # ---- stage 1: the classifier (mnist/main.py:22-33) ----
    t0 = time.perf_counter()
    # the legacy stack's faithful MaxPool classifier
    # (`mnist/modules/classifier.py:4-30`)
    clf_cls = LegacyCNNClassifier if legacy_delta else CNNClassifier
    clf_model = clf_cls(
        num_classes=cfg.num_classes,
        generator=torch.Generator().manual_seed(cfg.seed))
    clf_dir = os.path.join(out_dir, "classifier")
    if ckpt.exists(clf_dir) and not fresh:
        template = flax_from_state_dict(clf_model, clf_model.state_dict())
        clf_model.load_state_dict(state_dict_from_flax(
            clf_model, ckpt.restore(clf_dir, template)))
        clf_model.to(dev).eval()
        log(f"Loaded classifier from {clf_dir}")
    else:
        _, clf_hist = train_classifier(
            clf_model, cfg.classifier, (xtr, ytr), (xva, yva),
            seed=cfg.seed, num_classes=cfg.num_classes, log=log, device=dev)
        ckpt.save(clf_dir, flax_from_state_dict(clf_model,
                                                clf_model.state_dict()))
        plot_classifier_curves(
            clf_hist, os.path.join(out_dir, "classifier_training_curves.png"))
    seconds["classifier"] = time.perf_counter() - t0
    logits_fn, _ = make_eval_fn(clf_model)
    clf_eval = evaluate_classifier(
        logits_fn, xte, yte, out_dir=os.path.join(out_dir, "classifier_eval"),
        device=dev)
    log(f"Classifier test accuracy: {clf_eval['accuracy']:.4f}")

    # ---- stage 2: the CounteRGAN (mnist/main.py:38-47) ----
    t0 = time.perf_counter()
    bundle = build_mnist_countergan(cfg.countergan, clf_model.state_dict(),
                                    seed=cfg.seed, device=dev,
                                    legacy_delta=legacy_delta)
    g_model = bundle.state.g.model
    gen_dir = os.path.join(out_dir, "generator")
    history, selection_s = {}, 0.0
    if ckpt.exists(gen_dir) and not fresh:
        # the checkpoint holds the served variables (EMA parameters and
        # recalibrated statistics when the recipe carries an EMA)
        template = flax_from_state_dict(g_model, g_model.state_dict())
        g_vars = {k: v.to(dev) for k, v in state_dict_from_flax(
            g_model, ckpt.restore(gen_dir, template)).items()}
        sel_info = (ckpt.load_metadata(gen_dir) or {}).get(
            "serving_selection", {})
        log(f"Loaded generator from {gen_dir}")
    else:
        xtr_d = torch.as_tensor(xtr).to(dev)
        recal_seed = stream_seed(cfg.seed, 777)
        selector = None
        if cfg.countergan.snapshot_every:
            # score each rung's candidates on the validation split and a
            # fixed training subsample under all-ones masks: sorted
            # per-target flips, mean flip last (test is never seen)
            sweep = make_per_target_sweep(
                bundle.cf_fn, logits_fn, cfg.num_classes, **MNIST_PROTOCOL)
            sub = np.random.RandomState(0).permutation(
                len(ytr))[:min(SCORE_SUBSAMPLE, len(ytr))]
            xsc = np.concatenate([xva, xtr[sub]])
            ysc = np.concatenate([yva, ytr[sub]])

            def snapshot_score(g_vars):
                cols = per_target_metrics(
                    sweep, g_vars, xsc, ysc, mask_fn=lambda b: torch.ones(
                        (b, *xsc.shape[1:]), device=dev),
                    num_classes=cfg.num_classes, batch_size=2048)
                flips = cols["class_flip_rate"].astype(np.float64)
                return tuple(np.sort(flips)) + (float(np.mean(flips)),)

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
            g_vars, sel_info = select_g_serving_variables(
                bundle, state, xtr_d, recal_seed, xva, yva, logits_fn)
            if sel_info["scores"]:
                log(f"Serving candidate: {sel_info['candidate']} "
                    f"(validation scores: {sel_info['scores']})")
        selection_s += time.perf_counter() - t
        ckpt.save(gen_dir, flax_from_state_dict(g_model, g_vars),
                  metadata={"serving_selection": sel_info})
        plot_loss_curves(history, os.path.join(out_dir, "gan_losses.png"))
    seconds["countergan"] = time.perf_counter() - t0 - selection_s
    seconds["selection"] = selection_s

    # ---- stage 3: evaluation (mnist/eval_utils.py:572-647) ----
    t0 = time.perf_counter()
    h, w = xte.shape[1], xte.shape[2]
    ps = cfg.countergan.mask.patch_size
    nb = min(len(yte), 1024)
    xb = torch.as_tensor(xte[:nb]).to(dev)
    yb = torch.as_tensor(yte[:nb]).to(dev, torch.long)
    t_rand = torch.randint(0, cfg.num_classes, (nb,), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               stream_seed(cfg.seed, 1)))
    batch_m, _ = evaluate_counterfactual_batch(
        bundle.cf_fn, logits_fn, g_vars, xb, yb, t_rand,
        torch.ones((nb, h, w, 1), device=dev))
    write_csv(os.path.join(out_dir, "countergan_metrics.csv"), [batch_m])
    log(f"Batch metrics (all-ones mask): {batch_m}")

    per_target = per_target_metrics(
        make_per_target_sweep(bundle.cf_fn, logits_fn, cfg.num_classes,
                              **MNIST_PROTOCOL),
        g_vars, xte, yte,
        mask_fn=lambda b: torch.ones((b, h, w, 1), device=dev),
        num_classes=cfg.num_classes, batch_size=1024)
    write_csv(os.path.join(out_dir, "countergan_metrics_per_class.csv"),
              per_target)
    counterfactual_grid(bundle.cf_fn, logits_fn, g_vars, xte, yte,
                        cfg.num_classes, os.path.join(out_dir, "cf_grid.png"),
                        device=dev)

    rows = []
    for policy, shared in (("shared", True), ("per_sample", False)):
        m = random_patch_mask(
            nb, (h, w), ps, cfg.countergan.mask.num_modifiable_patches,
            shared=shared, generator=torch.Generator(device=dev).manual_seed(
                stream_seed(cfg.seed, 7)), device=dev)
        x_cf, raw, masked = bundle.cf_fn(g_vars, xb, t_rand, m)
        rows.append({"mask_policy": policy, **masked_metrics(
            logits_fn, xb, x_cf, raw, masked, m, yb, t_rand)})
    write_csv(os.path.join(out_dir, "masked_metrics.csv"), rows)
    vis_mask = random_patch_mask(
        VISUAL_SAMPLES, (h, w), ps, cfg.countergan.mask.num_modifiable_patches,
        generator=torch.Generator(device=dev).manual_seed(
            stream_seed(cfg.seed, 8)), device=dev)
    heatmap_panels(bundle.cf_fn, logits_fn, g_vars, xte[:VISUAL_SAMPLES],
                   yte[:VISUAL_SAMPLES], t_rand[:VISUAL_SAMPLES], vis_mask,
                   os.path.join(out_dir, "eval_visuals"), device=dev)
    patch_budget_curve(
        bundle.cf_fn, logits_fn, g_vars, xte, yte, cfg.num_classes, ps,
        out_dir=out_dir, generator=torch.Generator(device=dev).manual_seed(
            stream_seed(cfg.seed, 9)), device=dev)
    patch_grid_overlay(xte[0], ps, os.path.join(out_dir, "patch_grid.png"))
    # the JAX package drops patch indices outside a smaller grid
    n_patches = np.prod(patch_grid_dims(h, w, ps))
    user_modification_example(
        bundle.cf_fn, logits_fn, g_vars, xte[0], target=USER_TARGET,
        patch_indices=[p for p in USER_PATCHES if p < n_patches],
        patch_size=ps,
        path=os.path.join(out_dir, "user_modification_example.png"),
        device=dev)

    # the provenance record, in the invocation that wrote the CSVs
    clear_stale(out_dir)
    write_run_provenance(
        out_dir, preset=cfg.name, seed=cfg.seed,
        serving_candidate=sel_info.get("candidate"),
        selection_scores=sel_info.get("scores"),
        extra={"batch_flip_rate": batch_m["class_flip_rate"],
               "classifier_test_accuracy": clf_eval["accuracy"]})
    seconds["eval"] = time.perf_counter() - t0
    return {"classifier": clf_eval, "batch_metrics": batch_m,
            "per_target": per_target, "g_vars": g_vars, "history": history,
            "serving_selection": sel_info, "bundle": bundle,
            "stage_seconds": seconds}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--clf-epochs", type=int, default=None)
    ap.add_argument("--limit", type=int, default=None,
                    help="truncate the dataset (smoke runs)")
    ap.add_argument("--out-dir", type=str, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--legacy", action="store_true",
                    help="the legacy delta-generator stack with a fixed "
                         "target (preset mnist_countergan_legacy)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    setup_compile_cache()  # where the kernel and data libraries build
    cfg = MNIST_COUNTERGAN_LEGACY if args.legacy else MNIST_COUNTERGAN
    if args.epochs is not None:
        cfg = cfg.replace(countergan=replace(cfg.countergan,
                                             epochs=args.epochs))
    if args.clf_epochs is not None:
        cfg = cfg.replace(classifier=replace(cfg.classifier,
                                             epochs=args.clf_epochs))
    if args.seed is not None:
        cfg = cfg.replace(seed=args.seed)
    run(cfg, out_dir=args.out_dir, fresh=args.fresh, limit=args.limit,
        device=args.device, legacy_delta=args.legacy)


if __name__ == "__main__":
    main()
