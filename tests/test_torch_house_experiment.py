"""The port's King County house experiment and serving
(cfgan_torch.experiments.house_countergan, cfgan_torch.train.classifier's
AdamW, cfgan_torch.train.builders.house_engine,
cfgan_torch.eval.tabular) against the JAX package's, on the CPU.

- One AdamW classifier step (class-weighted, as the house classifier
  trains) against `optax.adamw` on JAX's dropout masks: loss 1e-5, first
  moments within 5e-5 of each leaf's 2-norm plus 1e-9, parameters 2e-6
  where the gradient is not rounding noise, and where it is (a unit whose
  LeakyReLU input has one sign over the batch: the BatchNorm after it
  cancels its bias) within 2 lr, two noise moves of either sign.
- `run()` at width 8 (two FiLM blocks, 600 training rows, one classifier
  epoch, two GAN epochs with a snapshot rung each), then the rerun that
  loads every stage and writes the same CSVs.
- The JAX package restores the port's run dir with the templates its own
  `run()` uses, and its `cf_fn` on the restored variables gives the
  port's per-target CSV (flips equal, the other columns within 1e-5);
  the port's `run()` loads the JAX run dir committed in
  `results/house_countergan/` and writes the per-target CSVs that the
  JAX `cf_fn` gives on it.
- `house_engine` on the committed run dir serves, for the same key, the
  JAX `cf_fn`'s counterfactuals (x_cf within 1e-5, predictions equal);
  padded and unpadded requests give equal counterfactual rows (and
  probabilities within 1e-6: the classifier's matmuls sum in another
  order at another batch); `generate_bulk`'s
  per-chunk keys are the JAX engine's; `default_mask` and
  `mask_from_feature_names` are the JAX engine's.
"""
import csv
import shutil
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfgan.train.classifier as jcl
import cfgan_torch.experiments.house_countergan as exp
import cfgan_torch.train.classifier as pcl
from cfgan.core import checkpoint as jckpt
from cfgan.data.kc_house import KC_SCHEMA as JAX_SCHEMA
from cfgan.data.transforms import NormStats as JaxNormStats
from cfgan.eval.tabular import per_target_metrics_from_sweep as jax_metrics
from cfgan.eval.tabular import sweep_all_targets as jax_sweep
from cfgan.experiments import presets as jax_presets
from cfgan.models.classifiers import TabularClassifier as JaxClassifier
from cfgan.serve.engine import CounterfactualEngine as JaxEngine
from cfgan.train.builders import build_tabular_countergan as jax_build
from cfgan.train.state import NetState as JaxNetState
from cfgan.train.state import adam_like_torch as jax_adam
from cfgan_torch.convert import flax_from_state_dict, state_dict_from_flax
from cfgan_torch.core import checkpoint as ckpt
from cfgan_torch.data.kc_house import KC_SCHEMA, load_kc_house
from cfgan_torch.experiments import presets
from cfgan_torch.models.classifiers import TabularClassifier
from cfgan_torch.models.tabular import jax_key
from cfgan_torch.train.builders import build_tabular_countergan, house_engine
from cfgan_torch.train.classifier import make_eval_fn
from cfgan_torch.train.state import NetState

from test_torch_figure import TRAINED_ONLY, figure_set, jax_figure_set

ROOT = Path(__file__).resolve().parent.parent
COMMITTED = ROOT / "results" / "house_countergan"
LIMIT = 600
CFG = presets.HOUSE_COUNTERGAN.replace(
    classifier=replace(presets.HOUSE_COUNTERGAN.classifier, epochs=1),
    countergan=replace(presets.HOUSE_COUNTERGAN.countergan, epochs=2,
                       hidden_dim=8, num_res_blocks=2, snapshot_every=1))
COLUMNS = ("class_flip_rate", "prediction_gain", "avg_actionability")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU run shares its cores with other test workers: one torch
    thread keeps this file's many small eager ops from oversubscribing
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return load_kc_house()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def assert_csv_matches(rows, want):
    """`rows` of a per-target CSV against the JAX metrics DataFrame: the
    same targets, equal flips, the other columns within 1e-5."""
    assert [int(r["target_class"]) for r in rows] == list(
        want["target_class"])
    for r, (_, w) in zip(rows, want.iterrows()):
        assert float(r["class_flip_rate"]) == w["class_flip_rate"]
        for col in COLUMNS[1:]:
            assert abs(float(r[col]) - w[col]) <= 1e-5, col


# ----------------------------------------------------- AdamW classifier
@pytest.mark.parametrize("lr_scale", [1.0, 0.1])
def test_adamw_classifier_step_matches_optax(data, lr_scale):
    (xtr, ytr), _, _, _, _ = data
    x, y = xtr[:64], ytr[:64]
    weights = np.array([0.8, 1.1, 1.3, 0.9], np.float32)
    model = JaxClassifier(num_classes=4)
    variables = _np(dict(model.init(jax.random.key(1), jnp.asarray(x))))
    tx = jax_adam(5e-4, weight_decay=0.01)
    key = jax.random.key(5)
    _, inter = model.apply(variables, jnp.asarray(x), train=True,
                           rngs={"dropout": key}, capture_intermediates=True,
                           mutable=["intermediates", "batch_stats"])
    keep = tuple(torch.from_numpy(np.asarray(
        inter["intermediates"][f"Dropout_{i}"]["__call__"][0]) != 0)
        for i in range(3))
    state, loss = jax.jit(jcl.make_classifier_step(
        model, tx, jnp.asarray(weights)))(
        JaxNetState.create(variables, tx), jnp.asarray(x), jnp.asarray(y),
        key, lr_scale)

    port = TabularClassifier(4, 17)
    port.load_state_dict(state_dict_from_flax(port, variables))
    ns = NetState.create(port, 5e-4, weight_decay=0.01)
    assert isinstance(ns.opt, torch.optim.AdamW)
    got = pcl.make_classifier_step(ns, torch.from_numpy(weights))(
        torch.from_numpy(x), torch.from_numpy(y).long(), keep=keep,
        lr_scale=lr_scale)
    assert abs(float(got) - float(loss)) <= 1e-5
    mu = {name: ns.opt.state[p]["exp_avg"]
          for name, p in port.named_parameters()}
    got_mu = dict(_leaves(flax_from_state_dict(port, mu)["params"]))
    want_mu = dict(_leaves(state.opt_state[0].mu))
    assert got_mu.keys() == want_mu.keys()
    for k, w in want_mu.items():
        err = np.linalg.norm(got_mu[k] - w)
        assert err <= 5e-5 * np.linalg.norm(w) + 1e-9, (k, err)
    got_p = dict(_leaves(flax_from_state_dict(port, port.state_dict())))
    for k, w in _leaves({"params": state.params}):
        err = np.abs(got_p[k] - w)
        small = np.abs(want_mu[k.replace("params/", "", 1)]) <= 1e-7
        assert err[~small].max(initial=0.0) <= 2e-6, k
        assert err[small].max(initial=0.0) <= 2 * 5e-4 * lr_scale, k


# ------------------------------------------------------------- run()
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("house_countergan")
    first = exp.run(CFG, out_dir=str(out), limit=LIMIT, device="cpu",
                    log=lambda s: None)
    csvs = {name: (out / name).read_text() for name in (
        "countergan_metrics.csv", "countergan_metrics_reference_protocol.csv")}
    lines = []
    second = exp.run(CFG, out_dir=str(out), limit=LIMIT, device="cpu",
                     log=lines.append)
    return out, first, second, csvs, lines


def test_run_writes_the_jax_run_dir(runs):
    out = runs[0]
    for f in ("classifier/checkpoint.msgpack", "classifier/metadata.json",
              "generator/checkpoint.msgpack", "generator/metadata.json",
              "train_state/checkpoint.msgpack",
              "classifier_eval/confusion_matrix.csv",
              "classifier_eval/classifier_report.txt",
              "countergan_metrics.csv",
              "countergan_metrics_reference_protocol.csv"):
        assert (out / f).is_file(), f
    for name in ("countergan_metrics.csv",
                 "countergan_metrics_reference_protocol.csv"):
        rows = _rows(out / name)
        assert [r["target_class"] for r in rows] == ["0", "1", "2", "3"]
        assert all(np.isfinite(float(r[c])) for r in rows for c in COLUMNS)
    meta = ckpt.load_metadata(str(out / "classifier"))
    assert set(meta) == {"stats", "bins"} and len(meta["bins"]) == 5


def test_snapshot_ladder_scores_each_rung(runs):
    sel = runs[1]["serving_selection"]
    rungs = {(r["epoch"], r["candidate"]) for r in sel["ladder"]}
    assert rungs == {(e, c) for e in (1, 2)
                     for c in ("live", "ema_recal_train", "ema_recal_ones")}
    # four sorted margins over the reference flips, then the worst flip
    assert all(len(r["score"]) == 5 for r in sel["ladder"])
    assert sel["candidate"].startswith("snapshot_e")


def test_rerun_loads_every_stage_and_writes_the_same_csvs(runs):
    out, _, second, csvs, lines = runs
    assert not any("[Classifier]" in ln or "[CounteRGAN]" in ln
                   for ln in lines)
    assert second["history"] == {}
    for name, text in csvs.items():
        assert (out / name).read_text() == text


def _jax_bundle(cfg, clf_vars, stats):
    clf_model = JaxClassifier(num_classes=4)
    bundle = jax_build(cfg, clf_model,
                       JaxNetState.create(clf_vars, jax_adam(1e-3)),
                       JAX_SCHEMA, JaxNormStats(*stats), num_classes=4,
                       seed=42)
    return bundle, lambda x: clf_model.apply(clf_vars, x, train=False)


def _jax_restore(run_dir, cfg, stats):
    """The classifier and generator as the JAX `run()` restores them."""
    template = JaxClassifier(num_classes=4).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(0)},
        jnp.zeros((2, 17)))
    clf_vars = jckpt.restore(str(run_dir / "classifier"), dict(template))
    bundle, clf_fn = _jax_bundle(cfg, clf_vars, stats)
    g_vars = jckpt.restore(str(run_dir / "generator"),
                           dict(bundle.state.g.variables()))
    return bundle, clf_fn, g_vars


def _jax_per_target(bundle, clf_fn, g_vars, x, y, seed, clamped=True):
    mask = jnp.broadcast_to(jnp.asarray(
        np.asarray(JAX_SCHEMA.immutable_idx)[:, None] != np.arange(17)
    ).all(0).astype(jnp.float32), x.shape)

    def cf(g, xx, t, m, k):
        x_cf, raw, masked = bundle.cf_fn(g, xx, t, m, k)
        return (x_cf if clamped else xx + masked), raw, masked

    sweep = jax_sweep(cf, clf_fn, g_vars, x, mask, 4, jax.random.key(seed))
    return jax_metrics(sweep, x, y, 4)


def test_jax_restores_the_port_run_dir_and_computes_its_csvs(runs, data):
    out = runs[0]
    _, (xte, yte), stats, _, _ = data
    xte, yte = xte[:max(LIMIT // 4, 64)], yte[:max(LIMIT // 4, 64)]
    jcfg = replace(jax_presets.HOUSE_COUNTERGAN.countergan, hidden_dim=8,
                   num_res_blocks=2)
    bundle, clf_fn, g_vars = _jax_restore(out, jcfg, stats)
    assert JaxNormStats.from_metadata(ckpt.load_metadata(
        str(out / "generator"))["stats"]).data_min.shape == (17,)
    for name, clamped in (("countergan_metrics.csv", True),
                          ("countergan_metrics_reference_protocol.csv",
                           False)):
        want = _jax_per_target(bundle, clf_fn, g_vars, jnp.asarray(xte),
                               yte, CFG.seed, clamped)
        assert_csv_matches(_rows(out / name), want)


@pytest.fixture(scope="module")
def committed(data):
    """The JAX run dir committed in results/house_countergan, restored by
    both packages at the shipped preset's full width."""
    _, _, stats, _, _ = data
    bundle, clf_fn, g_vars = _jax_restore(
        COMMITTED, jax_presets.HOUSE_COUNTERGAN.countergan, stats)
    clf = TabularClassifier(4, 17)
    clf.load_state_dict(state_dict_from_flax(clf, ckpt.restore(
        str(COMMITTED / "classifier"),
        flax_from_state_dict(clf, clf.state_dict()))))
    port = build_tabular_countergan(presets.HOUSE_COUNTERGAN.countergan,
                                    clf.state_dict(), KC_SCHEMA, stats,
                                    device="cpu")
    g = port.state.g.model
    pg = state_dict_from_flax(g, ckpt.restore(
        str(COMMITTED / "generator"), flax_from_state_dict(g, g.state_dict())))
    logits_fn, _ = make_eval_fn(clf)
    return bundle, clf_fn, g_vars, port, logits_fn, pg


def test_port_run_loads_the_committed_jax_run_dir(committed, data,
                                                  tmp_path):
    bundle, clf_fn, g_vars, _, _, _ = committed
    _, (xte, yte), _, _, _ = data
    for part in ("classifier", "generator"):
        shutil.copytree(COMMITTED / part, tmp_path / part)
    lines = []
    res = exp.run(presets.HOUSE_COUNTERGAN, out_dir=str(tmp_path),
                  device="cpu", log=lines.append)
    assert res["history"] == {} and not any(
        "[Classifier]" in ln or "[CounteRGAN]" in ln for ln in lines)
    assert res["serving_selection"]["candidate"] == \
        "snapshot_e330_ema_recal_train"
    for name, clamped in (("countergan_metrics.csv", True),
                          ("countergan_metrics_reference_protocol.csv",
                           False)):
        want = _jax_per_target(bundle, clf_fn, g_vars, jnp.asarray(xte),
                               yte, 42, clamped)
        assert_csv_matches(_rows(tmp_path / name), want)


# ------------------------------------------------------------ serving
N_SERVE = 300


def _engines(committed):
    bundle, clf_fn, g_vars, port, logits_fn, pg = committed
    jeng = JaxEngine(bundle.cf_fn, clf_fn, g_vars, 4, schema=JAX_SCHEMA)
    peng = house_engine(port, logits_fn, g_variables=pg, device="cpu")
    return jeng, peng


@pytest.mark.parametrize("target", [0, 1, 2, 3])
def test_engine_serves_the_jax_counterfactuals(committed, data, target):
    bundle, clf_fn, g_vars, _, _, _ = committed
    _, (xte, _), _, _, _ = data
    jeng, peng = _engines(committed)
    x = xte[:N_SERVE]
    key = (0, 9)
    want = jeng.generate(x, target, key=jax.random.wrap_key_data(
        jnp.asarray(key, jnp.uint32)))
    got = peng.generate(x, target, key=key)
    assert np.abs(got.x_cf - want.x_cf).max() <= 1e-5
    assert np.abs(got.residual - want.residual).max() <= 1e-5
    np.testing.assert_array_equal(got.pred, want.pred)
    np.testing.assert_array_equal(got.flipped, want.flipped)
    assert np.abs(got.probs - want.probs).max() <= 1e-5


def test_padded_and_unpadded_requests_give_equal_rows(committed, data):
    _, (xte, _), _, _, _ = data
    _, padded = _engines(committed)
    _, exact = _engines(committed)
    exact.pad_to_bucket = False
    for b in (1, 5, 77):
        a = padded.generate(xte[:b], 2, key=(0, 4))
        c = exact.generate(xte[:b], 2, key=(0, 4))
        np.testing.assert_array_equal(a.x_cf, c.x_cf)
        np.testing.assert_array_equal(a.residual, c.residual)
        np.testing.assert_allclose(a.probs, c.probs, atol=1e-6, rtol=0)


def test_bulk_chunks_take_the_jax_engines_keys(committed, data):
    _, (xte, _), _, _, _ = data
    jeng, peng = _engines(committed)
    x = xte[:200]
    t = np.arange(200) % 4
    want = jeng.generate_bulk(x, t, key=jax.random.key(3), chunk=64)
    got = peng.generate_bulk(x, t, key=jax_key(3), chunk=64)
    assert np.abs(got.x_cf - want.x_cf).max() <= 1e-5
    np.testing.assert_array_equal(got.pred, want.pred)


def test_engine_masks_are_the_jax_engines(committed):
    jeng, peng = _engines(committed)
    np.testing.assert_array_equal(peng.default_mask(3, (3, 17)).numpy(),
                                  np.asarray(jeng.default_mask(3, (3, 17))))
    for allowed in (("grade", "sqft_living", "lat"), ()):
        np.testing.assert_array_equal(
            peng.mask_from_feature_names(allowed, 2).numpy(),
            np.asarray(jeng.mask_from_feature_names(allowed, 2)))
    x = np.full((17,), 0.5, np.float32)
    r = peng.generate(x, 3, mask=peng.mask_from_feature_names(("grade",), 1))
    changed = np.flatnonzero(r.x_cf[0] != x)
    assert set(changed) <= {KC_SCHEMA.feature_names.index("grade")}


# ------------------------------------------------------------ presets
@pytest.mark.parametrize("name", ["HOUSE_COUNTERGAN",
                                  "HOUSE_COUNTERGAN_REFERENCE"])
def test_presets_equal_the_jax_presets(name):
    got, want = getattr(presets, name), getattr(jax_presets, name)
    assert (got.name, got.seed, got.num_classes) == (
        want.name, want.seed, want.num_classes)
    for part in ("data", "classifier"):
        for field, value in vars(getattr(got, part)).items():
            assert getattr(getattr(want, part), field) == value, field
    for field, value in vars(got.countergan).items():
        if field != "mask":
            assert getattr(want.countergan, field) == value, field
    assert presets.HOUSE_REFERENCE_FLIPS == jax_presets.HOUSE_REFERENCE_FLIPS


def test_main_parses_the_jax_flags(monkeypatch):
    seen = {}
    monkeypatch.setattr(exp, "run", lambda cfg, **kw: seen.update(cfg=cfg,
                                                                  **kw))
    exp.main(["--epochs", "3", "--clf-epochs", "2", "--limit", "500",
              "--seed", "7", "--fresh", "--out-dir", "d", "--device", "cpu",
              "--preset", "house_countergan_reference"])
    cfg = seen["cfg"]
    assert cfg.name == "house_countergan_reference" and cfg.seed == 7
    assert cfg.countergan.epochs == 3 and cfg.classifier.epochs == 2
    assert (seen["limit"], seen["fresh"], seen["out_dir"],
            seen["device"]) == (500, True, "d", "cpu")


def test_select_g_serving_variables_scores_under_the_serving_mask(data):
    """A house bundle with an EMA: the three candidates are scored under
    the immutable-complement mask with the given key (the live
    candidate's score equals its per-target sweep computed directly), and
    the best by worst flip, then mean flip, is served."""
    from cfgan_torch.eval.metrics import make_per_target_sweep, per_target_metrics
    from cfgan_torch.eval.tabular import immutable_mask
    from cfgan_torch.train.builders import (
        live_g_variables,
        select_g_serving_variables,
    )

    (xtr, ytr), _, stats, _, _ = data
    cfg = replace(presets.HOUSE_COUNTERGAN.countergan, hidden_dim=8,
                  num_res_blocks=2)
    clf = TabularClassifier(generator=torch.Generator().manual_seed(0))
    port = build_tabular_countergan(cfg, clf.state_dict(), KC_SCHEMA, stats,
                                    device="cpu")
    with torch.no_grad():
        for v in port.state.g_ema.values():
            v.mul_(1.05)
    logits_fn, _ = make_eval_fn(clf.eval())
    mask_fn = lambda b: immutable_mask(b, KC_SCHEMA)  # noqa: E731
    x, y, key = xtr[:60], ytr[:60], jax_key(5)
    gv, info = select_g_serving_variables(
        port, port.state, torch.from_numpy(xtr[:256]), 3, x, y, logits_fn,
        serving_mask_fn=mask_fn, key=key)
    assert set(info["scores"]) == {"live", "ema_recal_train",
                                   "ema_recal_ones"}
    best = max(info["scores"], key=lambda n: (info["scores"][n]["worst_flip"],
                                              info["scores"][n]["mean_flip"]))
    assert info["candidate"] == best
    live = per_target_metrics(
        make_per_target_sweep(port.cf_fn, logits_fn, 4,
                              exclude_same_class=False,
                              pred_gain_mode="cf_target_minus_cf_true",
                              actionability_mode="x_cf_minus_x"),
        live_g_variables(port.state), x, y, mask_fn=mask_fn, num_classes=4,
        key=key)
    assert info["scores"]["live"]["worst_flip"] == round(
        float(np.nanmin(live["class_flip_rate"])), 6)
    want = (port.state.g_ema if best != "live"
            else dict(port.state.g.model.named_parameters()))
    assert all(torch.equal(gv[k], want[k]) for k in want)


def test_run_dir_holds_the_jax_run_dirs_figures(runs, tmp_path):
    """The committed JAX run dir's figures, by name and folder; a rerun
    that trains nothing draws all but the training curves again."""
    out = runs[0]
    want = jax_figure_set("house_countergan")
    assert figure_set(out) == want
    copy = tmp_path / "copy"
    shutil.copytree(out, copy, ignore=shutil.ignore_patterns("*.png"))
    exp.run(CFG, out_dir=str(copy), limit=LIMIT, device="cpu",
            log=lambda s: None)
    assert figure_set(copy) == want - TRAINED_ONLY["house_countergan"]
