"""King County house CounteRGAN experiment on the port (mirrors
`cfgan/experiments/house_countergan.py`): load the house table (the CSV,
or the synthetic table) -> pretrain or load the tabular classifier
(AdamW, class-weighted cross-entropy, early stopping, the plateau) ->
classifier eval -> train the FiLM + Gumbel CounteRGAN with the epoch
runner, or load it -> pick the serving snapshot -> per-target
evaluation under both protocols.

    python -m cfgan_torch.experiments.house_countergan [--epochs N]
        [--clf-epochs N] [--limit N] [--seed N] [--out-dir D] [--fresh]
        [--preset house_countergan_reference] [--device cpu]

The run dir is the JAX package's: `classifier/` (with the normalization
stats and price bins in its metadata), `generator/` (the served
variables, with the stats and the `serving_selection` record),
`train_state/` (mid-run checkpoints), `classifier_eval/`,
`countergan_metrics.csv` (the clamped counterfactuals),
`countergan_metrics_reference_protocol.csv` (the un-clamped x + masked
the reference scores), `feature_shift_importance.csv`,
`class_pair_sensitivity/class_pair_sensitivity.csv`, the `case_studies/`
tree, `mask_policy_analysis.csv` and `run_provenance.json`; its
checkpoints restore in either package, and the evaluation's Gumbel noise
comes from the JAX package's keys.  A stage whose checkpoint exists is
loaded, not trained again, unless `fresh`.  The figures are the JAX run
dir's: `classifier_training_curves.png` and `loss_curves.png` where their
stage trains, and on every run `classifier_eval/confusion_matrix.png`
(classes Q0-Q3), `feature_shift_importance.png`,
`class_pair_sensitivity/src{s}.png` and `mask_policy_analysis.png`.
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
from cfgan_torch.core.provenance import (
    clear_stale,
    serving_candidate_of,
    write_run_provenance,
)
from cfgan_torch.data.kc_house import load_kc_house
from cfgan_torch.data.mnist import stratified_split
from cfgan_torch.data.pipeline import stream_seed
from cfgan_torch.eval.classifier import evaluate_classifier
from cfgan_torch.eval.mask_analysis import analyze_mask_policies
from cfgan_torch.eval.metrics import write_csv
from cfgan_torch.eval.tabular import (
    case_study_report,
    class_pair_sensitivity,
    feature_shift_importance,
    immutable_mask,
    make_protocol_flip_scorer,
    per_target_metrics_from_sweep,
    sweep_all_targets,
)
from cfgan_torch.experiments import presets
from cfgan_torch.models.classifiers import TabularClassifier
from cfgan_torch.models.tabular import fold_in, jax_key
from cfgan_torch.train.builders import (
    build_tabular_countergan,
    g_serving_variables,
    select_g_serving_variables,
)
from cfgan_torch.train.classifier import (
    make_eval_fn,
    plot_classifier_curves,
    train_classifier,
)
from cfgan_torch.train.loop import plot_loss_curves, train_countergan_loop
from cfgan_torch.train.selection import SnapshotSelector, lex_margins

SCORE_SUBSAMPLE = 8192  # training rows added to the validation scoring
SCORE_KEYS = 3  # Gumbel keys each snapshot is scored under
VALID_FRACTION = 0.15  # the classifier's stratified validation split
PRESETS = {p.name: p for p in (presets.HOUSE_COUNTERGAN,
                               presets.HOUSE_COUNTERGAN_REFERENCE)}


def _load_classifier(clf_dir: str, model: TabularClassifier, dev) -> None:
    template = flax_from_state_dict(model, model.state_dict())
    model.load_state_dict(state_dict_from_flax(
        model, ckpt.restore(clf_dir, template)))
    model.to(dev).eval()


def run(cfg=presets.HOUSE_COUNTERGAN, out_dir: str | None = None,
        fresh: bool = False, limit: int | None = None,
        device: str | torch.device | None = None, log=print) -> dict:
    """Run the experiment into `out_dir` (default `cfg.out_dir/cfg.name`)
    on `device` (None: the CUDA card).  Returns the classifier eval, the
    per-target metrics under both protocols, the served generator
    variables, the training history, the selection record, the bundle and
    each stage's wall seconds (`stage_seconds`)."""
    dev = resolve_device(device)
    out_dir = out_dir or os.path.join(cfg.out_dir, cfg.name)
    os.makedirs(out_dir, exist_ok=True)
    seconds = {}
    t0 = time.perf_counter()
    (xtr, ytr), (xte, yte), stats, bins, schema = load_kc_house(
        path=cfg.data.path, seed=cfg.data.seed,
        test_fraction=cfg.data.test_fraction)
    if limit:
        xtr, ytr = xtr[:limit], ytr[:limit]
        xte, yte = xte[:max(limit // 4, 64)], yte[:max(limit // 4, 64)]
    seconds["data"] = time.perf_counter() - t0
    n_classes = cfg.num_classes

    # ---- stage 1: the classifier (house trainer.py:18-176) ----
    t0 = time.perf_counter()
    clf_model = TabularClassifier(
        n_classes, schema.input_dim,
        generator=torch.Generator().manual_seed(cfg.seed))
    clf_dir = os.path.join(out_dir, "classifier")
    if ckpt.exists(clf_dir) and not fresh:
        _load_classifier(clf_dir, clf_model, dev)
        log(f"Loaded classifier from {clf_dir}")
    else:
        itr, iva = stratified_split(ytr, VALID_FRACTION, cfg.seed)
        _, clf_hist = train_classifier(
            clf_model, cfg.classifier, (xtr[itr], ytr[itr]),
            (xtr[iva], ytr[iva]), seed=cfg.seed, num_classes=n_classes,
            log=log, device=dev)
        ckpt.save(clf_dir, flax_from_state_dict(clf_model,
                                                clf_model.state_dict()),
                  metadata={"stats": stats.to_metadata(),
                            "bins": [float(b) for b in bins]})
        plot_classifier_curves(
            clf_hist, os.path.join(out_dir, "classifier_training_curves.png"))
    seconds["classifier"] = time.perf_counter() - t0
    logits_fn, _ = make_eval_fn(clf_model)
    clf_eval = evaluate_classifier(
        logits_fn, xte, yte, out_dir=os.path.join(out_dir, "classifier_eval"),
        device=dev, class_names=[f"Q{i}" for i in range(n_classes)])
    log(f"Classifier test accuracy: {clf_eval['accuracy']:.4f} | weighted "
        f"F1: {clf_eval['report']['weighted avg']['f1-score']:.4f}")

    # ---- stage 2: the CounteRGAN (house trainer.py:186-378) ----
    t0 = time.perf_counter()
    bundle = build_tabular_countergan(
        cfg.countergan, clf_model.state_dict(), schema, stats,
        num_classes=n_classes, seed=cfg.seed, device=dev)
    g_model = bundle.state.g.model
    gen_dir = os.path.join(out_dir, "generator")
    history, selection_s = {}, 0.0
    if ckpt.exists(gen_dir) and not fresh:
        template = flax_from_state_dict(g_model, g_model.state_dict())
        g_vars = {k: v.to(dev) for k, v in state_dict_from_flax(
            g_model, ckpt.restore(gen_dir, template)).items()}
        sel_info = (ckpt.load_metadata(gen_dir) or {}).get(
            "serving_selection", {})
        log(f"Loaded generator from {gen_dir}")
    else:
        xtr_d = torch.as_tensor(xtr).to(dev)
        recal_seed = stream_seed(cfg.seed, 777)
        _, iva = stratified_split(ytr, VALID_FRACTION, cfg.seed)
        selector = None
        if cfg.countergan.snapshot_every:
            # score each rung's candidates on the validation fold plus a
            # fixed training subsample (test is never seen): the sorted
            # margins of the reference-protocol flips over the
            # reference's, averaged over SCORE_KEYS Gumbel keys, then the
            # worst clamped flip
            sub = np.random.RandomState(0).permutation(
                len(ytr))[:min(SCORE_SUBSAMPLE, len(ytr))]
            idx = np.concatenate([iva, sub])
            xsc = torch.as_tensor(xtr[idx]).to(dev)
            ysc = torch.as_tensor(ytr[idx]).to(dev, torch.long)
            sc_mask = immutable_mask(len(idx), schema, dev)
            flip_scorer = make_protocol_flip_scorer(bundle.cf_fn, logits_fn,
                                                    n_classes)
            keys = [fold_in(jax_key(cfg.seed), 9000 + i)
                    for i in range(SCORE_KEYS)]

            def snapshot_score(g_vars):
                fh, fr = flip_scorer(g_vars, xsc, ysc, sc_mask, keys)
                fh, fr = np.mean(fh, axis=0), np.mean(fr, axis=0)
                return lex_margins(fr, presets.HOUSE_REFERENCE_FLIPS) + (
                    float(fh.min()),)

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
        elif cfg.countergan.ema_decay:
            g_vars, sel_info = select_g_serving_variables(
                bundle, state, xtr_d, recal_seed, xtr[iva], ytr[iva],
                logits_fn,
                serving_mask_fn=lambda b: immutable_mask(b, schema, dev),
                key=fold_in(jax_key(cfg.seed), 777))
            log(f"Serving candidate: {sel_info['candidate']} (validation "
                f"scores: {sel_info['scores']})")
        else:
            g_vars = g_serving_variables(
                bundle, state, xtr_d,
                torch.Generator(device=dev).manual_seed(recal_seed))
            sel_info = {"candidate": "live", "scores": {}}
        selection_s += time.perf_counter() - t
        ckpt.save(gen_dir, flax_from_state_dict(g_model, g_vars),
                  metadata={"stats": stats.to_metadata(),
                            "serving_selection": sel_info})
        plot_loss_curves(history, os.path.join(out_dir, "loss_curves.png"))
    seconds["countergan"] = time.perf_counter() - t0 - selection_s
    seconds["selection"] = selection_s

    # ---- stage 3: evaluation (house eval_utils.py:673-728) ----
    t0 = time.perf_counter()
    key = jax_key(cfg.seed)
    xte_d = torch.as_tensor(xte).to(dev)
    mask = immutable_mask(len(yte), schema, dev)
    sweep = sweep_all_targets(bundle.cf_fn, logits_fn, g_vars, xte_d, mask,
                              n_classes, key)
    per_target = per_target_metrics_from_sweep(sweep, xte, yte, n_classes)
    write_csv(os.path.join(out_dir, "countergan_metrics.csv"), per_target)
    log(f"Per-target flips (clamped): {per_target['class_flip_rate']}")

    # the reference's protocol: the un-clamped x + masked
    # (`house eval_utils.py:244-245`), for comparison with its CSV
    def cf_unclamped(g, x, t, m, k):
        _, raw, masked = bundle.cf_fn(g, x, t, m, k)
        return x + masked, raw, masked

    sweep_ref = sweep_all_targets(cf_unclamped, logits_fn, g_vars, xte_d,
                                  mask, n_classes, key)
    per_target_ref = per_target_metrics_from_sweep(sweep_ref, xte, yte,
                                                   n_classes)
    write_csv(os.path.join(out_dir,
                           "countergan_metrics_reference_protocol.csv"),
              per_target_ref)
    log(f"Per-target flips (reference protocol): "
        f"{per_target_ref['class_flip_rate']}")

    # the reports over the clamped sweep (house eval_utils.py:292-664) and
    # the mask-policy analysis the reference imports but never shipped
    # (house eval_utils.py:19-22)
    feature_shift_importance(sweep, xte, yte, schema, stats, out_dir=out_dir)
    class_pair_sensitivity(sweep, xte, yte, schema, out_dir=out_dir)
    cases = case_study_report(sweep, xte, yte, schema, stats,
                              os.path.join(out_dir, "case_studies"),
                              seed=cfg.seed)
    log(f"Case studies: flip rate "
        f"{np.mean([r['flipped'] for r in cases]):.3f}, mean sparsity "
        f"{np.mean([r['sparsity'] for r in cases]):.3f}")
    analyze_mask_policies(bundle.cf_fn, logits_fn, g_vars, xte, yte, schema,
                          n_classes, key, out_dir=out_dir, device=dev)

    # the provenance record, in the invocation that wrote the CSVs
    clear_stale(out_dir)
    write_run_provenance(
        out_dir, preset=cfg.name, seed=cfg.seed,
        serving_candidate=serving_candidate_of(out_dir),
        selection_scores=sel_info.get("scores"),
        per_target_csv="countergan_metrics.csv",
        extra={"classifier_test_accuracy": clf_eval["accuracy"]})
    seconds["eval"] = time.perf_counter() - t0
    return {"classifier": clf_eval, "per_target": per_target,
            "per_target_reference": per_target_ref, "g_vars": g_vars,
            "history": history, "serving_selection": sel_info,
            "bundle": bundle, "stage_seconds": seconds}


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
    ap.add_argument("--preset", default=presets.HOUSE_COUNTERGAN.name,
                    choices=sorted(PRESETS),
                    help="the shipped recipe, or the reference's exact one")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    setup_compile_cache()  # where the kernel and data libraries build
    cfg = PRESETS[args.preset]
    if args.seed is not None:
        cfg = cfg.replace(seed=args.seed)
    if args.epochs is not None:
        cfg = cfg.replace(countergan=replace(cfg.countergan,
                                             epochs=args.epochs))
    if args.clf_epochs is not None:
        cfg = cfg.replace(classifier=replace(cfg.classifier,
                                             epochs=args.clf_epochs))
    run(cfg, out_dir=args.out_dir, fresh=args.fresh, limit=args.limit,
        device=args.device)


if __name__ == "__main__":
    main()
