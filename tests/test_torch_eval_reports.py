"""The port's evaluation records against the JAX package's, on the CPU:
the per-target sweep's three modes (`cfgan.eval.metrics.
make_per_target_sweep`), the house reports over one all-target sweep
(`feature_shift_importance`, `class_pair_sensitivity`,
`case_study_report`), the house mask-policy analysis and the MNIST
patch-budget curve (`cfgan.eval.mask_analysis`).

The house numbers come from the committed `results/house_countergan/`
weights restored by both packages, at the shipped preset's full width,
each package running its own sweep on the JAX key's Gumbel noise: their
counterfactuals agree within 1e-5 (float32 products in other orders
through five FiLM blocks; 2.1e-6 measured).  The MNIST curve runs at
width 8 on random weights with JAX's patch masks injected.  Tolerance:
1e-6 on every number of a report, in normalized units (a value in raw
units within 1e-6 of its feature's range, a percentage of the range
within 1e-4), rows in the JAX package's
order; flip rates and the files' text columns equal.  On the same sweep
the port's files are the JAX package's, byte for byte.
"""
import csv
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cfgan.core import checkpoint as jckpt
from cfgan.core.config import CounterGANConfig as JaxConfig
from cfgan.core.config import MaskConfig as JaxMaskConfig
from cfgan.data.kc_house import KC_SCHEMA as JAX_SCHEMA
from cfgan.data.transforms import NormStats as JaxNormStats
from cfgan.eval import mask_analysis as jma
from cfgan.eval import metrics as jmetrics
from cfgan.eval import tabular as jtab
from cfgan.experiments import presets as jax_presets
from cfgan.masks.patch import random_patch_mask as jax_patch_mask
from cfgan.models.classifiers import CNNClassifier as JaxCNN
from cfgan.models.classifiers import TabularClassifier as JaxClassifier
from cfgan.train.builders import build_mnist_countergan as jax_build_mnist
from cfgan.train.builders import build_tabular_countergan as jax_build
from cfgan.train.state import NetState as JaxNetState
from cfgan.train.state import adam_like_torch as jax_adam
from cfgan_torch.convert import (
    flax_from_state_dict,
    load_gan_state,
    state_dict_from_flax,
)
from cfgan_torch.core import checkpoint as ckpt
from cfgan_torch.core.config import CounterGANConfig, MaskConfig
from cfgan_torch.data.kc_house import KC_SCHEMA, load_kc_house
from cfgan_torch.eval import mask_analysis as pma
from cfgan_torch.eval import metrics as pmetrics
from cfgan_torch.eval import tabular as ptab
from cfgan_torch.experiments import presets
from cfgan_torch.models.classifiers import CNNClassifier, TabularClassifier
from cfgan_torch.models.tabular import jax_key
from cfgan_torch.train.builders import (
    build_mnist_countergan,
    build_tabular_countergan,
)
from cfgan_torch.train.classifier import make_eval_fn

ROOT = Path(__file__).resolve().parent.parent
COMMITTED = ROOT / "results" / "house_countergan"
TOL = 1e-6
SEED = 42


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def house():
    """Both packages' cf_fn, classifier and served variables on the
    committed house run dir, and the test split with its stats."""
    _, (xte, yte), stats, _, _ = load_kc_house()
    template = JaxClassifier(num_classes=4).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(0)},
        jnp.zeros((2, 17)))
    clf_vars = jckpt.restore(str(COMMITTED / "classifier"), dict(template))
    clf_model = JaxClassifier(num_classes=4)
    bundle = jax_build(jax_presets.HOUSE_COUNTERGAN.countergan, clf_model,
                       JaxNetState.create(clf_vars, jax_adam(1e-3)),
                       JAX_SCHEMA, JaxNormStats(*stats), num_classes=4)
    g_vars = jckpt.restore(str(COMMITTED / "generator"),
                           dict(bundle.state.g.variables()))

    def jclf(x):
        return clf_model.apply(clf_vars, x, train=False)

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
    return {"jax": (bundle.cf_fn, jclf, g_vars),
            "port": (port.cf_fn, logits_fn, pg),
            "x": xte, "y": yte, "stats": stats}


@pytest.fixture(scope="module")
def sweeps(house):
    """Each package's all-target sweep of the test split under the
    immutable-complement mask, with the JAX key of the experiment."""
    x, y = house["x"], house["y"]
    jcf, jclf, jg = house["jax"]
    want = jtab.sweep_all_targets(jcf, jclf, jg, x,
                                  jtab.immutable_mask(len(y), JAX_SCHEMA),
                                  4, jax.random.key(SEED))
    pcf, pclf, pg = house["port"]
    got = ptab.sweep_all_targets(pcf, pclf, pg, torch.from_numpy(x),
                                 ptab.immutable_mask(len(y), KC_SCHEMA),
                                 4, jax_key(SEED))
    return got, want


def test_the_two_sweeps_agree(sweeps):
    got, want = sweeps
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.abs(got[k].astype(np.float64) - want[k]).max() <= 1e-5, k
    assert np.array_equal(got["preds_cf"], want["preds_cf"])


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


RAW_COLUMNS = ("original", "counterfactual", "change", "mean_abs_shift_raw")


def assert_frames_match(got_path, want_path, data_range=None):
    """Two CSVs: the same header and rows in the same order; numeric
    cells within TOL (the RAW_COLUMNS within TOL times the row's feature's
    `data_range`), the others equal."""
    got, want = _csv(got_path), _csv(want_path)
    assert got[0] == want[0]
    assert len(got) == len(want)
    header = want[0]
    for g, w in zip(got[1:], want[1:]):
        tol = {name: TOL for name in header}
        if data_range is not None and "feature" in header:
            feature = w[header.index("feature")]
            scale = float(data_range[JAX_SCHEMA.feature_names.index(feature)])
            tol.update({c: TOL * scale for c in RAW_COLUMNS})
        if "pct_of_range" in tol:
            tol["pct_of_range"] = 100 * TOL
        for a, b, name in zip(g, w, header):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                assert a == b, name
                continue
            assert abs(fa - fb) <= tol[name] or (
                np.isnan(fa) and np.isnan(fb)), (name, a, b)


def test_feature_shift_importance_matches_jax(house, sweeps, tmp_path):
    got, want = sweeps
    stats = house["stats"]
    cols = ptab.feature_shift_importance(got, house["x"], house["y"],
                                         KC_SCHEMA, stats,
                                         out_dir=str(tmp_path / "port"))
    df = jtab.feature_shift_importance(want, house["x"], house["y"],
                                       JAX_SCHEMA, JaxNormStats(*stats),
                                       out_dir=str(tmp_path / "jax"))
    assert list(cols["feature"]) == list(df["feature"])
    name = "feature_shift_importance.csv"
    assert_frames_match(tmp_path / "port" / name, tmp_path / "jax" / name,
                        stats.data_range)
    # ties (the immutable features' zeros) fall in pandas' order
    same = ptab.feature_shift_importance(want, house["x"], house["y"],
                                         KC_SCHEMA, stats,
                                         out_dir=str(tmp_path / "same"))
    assert (tmp_path / "same" / name).read_text() == (
        tmp_path / "jax" / name).read_text()
    assert list(same["feature"]) == list(df["feature"])


@pytest.mark.parametrize("n", [5, 17, 40])
def test_descending_order_breaks_ties_as_pandas(n):
    rng = np.random.RandomState(n)
    values = rng.randint(0, 4, n).astype(np.float32)
    want = pd.DataFrame({"v": values}).sort_values(
        "v", ascending=False).index.to_numpy()
    assert list(ptab.descending_order(values)) == list(want)
    want_top = pd.Series(values).nlargest(5).index.to_numpy()
    assert list(ptab.largest(values, 5)) == list(want_top)


def test_class_pair_sensitivity_matches_jax(house, sweeps, tmp_path):
    got, want = sweeps
    rows = ptab.class_pair_sensitivity(got, house["x"], house["y"],
                                       KC_SCHEMA, out_dir=str(tmp_path / "p"))
    df = jtab.class_pair_sensitivity(want, house["x"], house["y"],
                                     JAX_SCHEMA, out_dir=str(tmp_path / "j"))
    assert len(rows) == len(df) == 4 * 3 * 17
    name = "class_pair_sensitivity/class_pair_sensitivity.csv"
    assert_frames_match(tmp_path / "p" / name, tmp_path / "j" / name)


def test_case_study_report_matches_jax(house, sweeps, tmp_path):
    got, want = sweeps
    stats = house["stats"]
    rows = ptab.case_study_report(got, house["x"], house["y"], KC_SCHEMA,
                                  stats, str(tmp_path / "p"), seed=SEED)
    df = jtab.case_study_report(want, house["x"], house["y"], JAX_SCHEMA,
                                JaxNormStats(*stats), str(tmp_path / "j"),
                                seed=SEED)
    assert [r["sample"] for r in rows] == list(df["sample"])
    files = sorted(p.relative_to(tmp_path / "j")
                   for p in (tmp_path / "j").rglob("*.csv"))
    assert files == sorted(p.relative_to(tmp_path / "p")
                           for p in (tmp_path / "p").rglob("*.csv"))
    assert len(files) == 20 + 3
    for f in files:
        assert_frames_match(tmp_path / "p" / f, tmp_path / "j" / f,
                            stats.data_range)
    # on the same sweep the tree is the JAX package's, byte for byte
    ptab.case_study_report(want, house["x"], house["y"], KC_SCHEMA, stats,
                           str(tmp_path / "same"), seed=SEED)
    for f in files:
        assert (tmp_path / "same" / f).read_text() == (
            tmp_path / "j" / f).read_text(), f


def test_analyze_mask_policies_matches_jax(house, tmp_path):
    jcf, jclf, jg = house["jax"]
    pcf, pclf, pg = house["port"]
    x, y = house["x"], house["y"]
    rows = pma.analyze_mask_policies(pcf, pclf, pg, x, y, KC_SCHEMA, 4,
                                     jax_key(SEED), out_dir=str(tmp_path / "p"),
                                     device="cpu")
    df = jma.analyze_mask_policies(jcf, jclf, jg, x, y, JAX_SCHEMA, 4,
                                   key=jax.random.key(SEED),
                                   out_dir=str(tmp_path / "j"))
    assert [r["policy"] for r in rows] == list(df["policy"])
    assert rows[-1]["policy"].startswith("top5:")
    assert len(rows) == 4 * (2 + 13 + 1)
    name = "mask_policy_analysis.csv"
    assert_frames_match(tmp_path / "p" / name, tmp_path / "j" / name)


@pytest.fixture(scope="module")
def mnist():
    """Both packages' MNIST cf_fn and classifier at width 8 on one random
    initial state."""
    width = dict(hidden_dim=8, num_res_blocks=1)
    mask = dict(patch_size=7, num_modifiable_patches=10)
    clf_model = JaxCNN()
    clf_vars = _np(dict(clf_model.init(jax.random.key(1),
                                       jnp.zeros((2, 28, 28, 1)))))
    bundle = jax_build_mnist(
        JaxConfig(**width, mask=JaxMaskConfig(**mask)), clf_model,
        JaxNetState.create(clf_vars, jax_adam(1e-3)), seed=7)
    port = build_mnist_countergan(
        CounterGANConfig(**width, mask=MaskConfig(**mask)),
        state_dict_from_flax(CNNClassifier(), clf_vars), device="cpu")
    load_gan_state(port.state, {"g": _np(bundle.state.g.variables()),
                                "d": _np(bundle.state.d.variables()),
                                "g_ema": None})
    clf = CNNClassifier()
    clf.load_state_dict(state_dict_from_flax(clf, clf_vars))
    logits_fn, _ = make_eval_fn(clf)
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (48, 28, 28, 1)).astype(np.float32)
    y = rng.randint(0, 10, 48).astype(np.int32)
    return {"jax": (bundle.cf_fn,
                    lambda a: clf_model.apply(clf_vars, a, train=False),
                    bundle.state.g.variables()),
            "port": (port.cf_fn, logits_fn,
                     port.state.g.model.state_dict()),
            "x": x, "y": y}


def test_patch_budget_curve_matches_jax_on_its_masks(mnist, tmp_path):
    x, y = mnist["x"], mnist["y"]
    key = jax.random.key(0)
    df = jma.patch_budget_curve(*mnist["jax"], x, y, 10, 7, key=key,
                                out_dir=str(tmp_path / "j"))
    assert list(df["n_patches"]) == [1, 2, 4, 6, 8, 10, 12, 16]
    masks = [np.asarray(jax_patch_mask(jax.random.fold_in(key, i), len(y),
                                       (28, 28), 7, int(n), channels=1))
             for i, n in enumerate(df["n_patches"])]
    rows = pma.patch_budget_curve(*mnist["port"], x, y, 10, 7, masks=masks,
                                  out_dir=str(tmp_path / "p"), device="cpu")
    assert len(rows) == 8
    name = "patch_budget_curve.csv"
    assert_frames_match(tmp_path / "p" / name, tmp_path / "j" / name)


def test_patch_budget_curve_draws_its_own_masks(mnist):
    """Without masks the port draws a mask per budget from its generator:
    `n` modifiable patches of 16, the last budget every patch."""
    x, y = mnist["x"], mnist["y"]
    seen = []

    def cf_fn(g, xx, t, m, k=None):
        seen.append(m)
        return mnist["port"][0](g, xx, t, m, k)

    rows = pma.patch_budget_curve(cf_fn, *mnist["port"][1:], x, y, 10, 7,
                                  generator=torch.Generator().manual_seed(3),
                                  device="cpu")
    patches = [int(m[0, ::7, ::7, 0].sum()) for m in seen]
    assert patches == [r["n_patches"] for r in rows] == [1, 2, 4, 6, 8, 10,
                                                         12, 16]
    assert rows[-1]["frac_area"] == 1.0


def _sweep_inputs(house, n=500):
    x, y = house["x"][:n], house["y"][:n]
    return x, y


@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("gain", ["cf_target_minus_orig_target",
                                  "cf_target_minus_cf_true"])
@pytest.mark.parametrize("act", ["masked_residual", "x_cf_minus_x"])
def test_per_target_sweep_modes_match_jax(house, exclude, gain, act):
    """Each combination of the three modes over the house weights, whose
    clamp makes x_cf - x differ from the masked residual; 500 rows in
    batches of 200 (the last one ragged)."""
    x, y = _sweep_inputs(house)
    modes = dict(exclude_same_class=exclude, pred_gain_mode=gain,
                 actionability_mode=act)
    jcf, jclf, jg = house["jax"]
    want = jmetrics.per_target_metrics(
        jmetrics.make_per_target_sweep(jcf, jclf, 4, **modes), jg, x, y,
        mask_fn=lambda b: jtab.immutable_mask(b, JAX_SCHEMA),
        key=jax.random.key(SEED), num_classes=4, batch_size=200)
    pcf, pclf, pg = house["port"]
    got = pmetrics.per_target_metrics(
        pmetrics.make_per_target_sweep(pcf, pclf, 4, **modes), pg, x, y,
        mask_fn=lambda b: ptab.immutable_mask(b, KC_SCHEMA),
        num_classes=4, batch_size=200, key=jax_key(SEED))
    assert list(got) == list(want.columns)
    np.testing.assert_array_equal(got["class_flip_rate"],
                                  want["class_flip_rate"].to_numpy())
    for col in ("prediction_gain", "avg_actionability"):
        np.testing.assert_allclose(got[col], want[col].to_numpy(), rtol=0,
                                   atol=TOL, err_msg=col)


def test_sweep_modes_are_keyword_only_and_checked(house):
    pcf, pclf, _ = house["port"]
    with pytest.raises(TypeError):
        pmetrics.make_per_target_sweep(pcf, pclf, 4)
    with pytest.raises(ValueError, match="pred_gain_mode"):
        pmetrics.make_per_target_sweep(
            pcf, pclf, 4, exclude_same_class=True, pred_gain_mode="x",
            actionability_mode="masked_residual")
