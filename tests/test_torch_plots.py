"""The port's plots against the JAX package's, on the CPU, from inputs
made with numpy seeds: the loss curves (`plot_loss_curves`), the
classifier curves, the confusion matrix, the mask-policy bars and the
patch-budget curve, the two tabular reports' plots, the decision
boundaries with and without counterfactual arrows, and the generation
family's scatter, loss plot and GIF.

The JAX figures are captured by recording `matplotlib.figure.Figure` at
`savefig`, the port's at `cfgan_torch.eval.figure.Figure.save`
(helpers in tests/test_torch_figure.py).  Compared: titles, axis labels
and legend texts; line data (within 1e-6 where they come from a model,
else exactly), styles, markers and colours; bar lengths and their order
against `ax.patches` and the tick labels; scatter colours against
`get_facecolors()`; the decision surface's band colours against the
`contourf` facecolors; arrows; image panels (data, colour map, bounds,
bytes); the confusion matrix's cell texts and colours; canvas sizes
against JAX's PNGs; each port PNG decoded by PIL equal to `render()`.

`decision_surface` equals JAX's except at grid points where JAX's two
largest logits lie within 1e-6 (counted and asserted).  The mask-policy
bars take pandas' order, ties included: `policy_flip_means` is checked
against `groupby().agg().sort_values()` on tied flip rates.
"""
import os

import jax
import jax.numpy as jnp
import matplotlib.colors as mcolors
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from cfgan.data.kc_house import KC_SCHEMA as JAX_SCHEMA
from cfgan.data.transforms import NormStats as JaxNormStats
from cfgan.eval import boundaries as jb
from cfgan.eval import classifier as jclf
from cfgan.eval import mask_analysis as jma
from cfgan.eval import samples as jsamples
from cfgan.eval import tabular as jtab
from cfgan.masks.patch import random_patch_mask as jax_patch_mask
from cfgan.models.classifiers import MLPClassifier as JaxMLP
from cfgan.models.generators import MoonsResidualGenerator as JaxMoonsG
from cfgan.train import classifier as jtrain_clf
from cfgan.train import loop as jloop
from cfgan_torch.convert import state_dict_from_flax
from cfgan_torch.data.kc_house import KC_SCHEMA
from cfgan_torch.data.transforms import NormStats
from cfgan_torch.eval import boundaries as pb
from cfgan_torch.eval import classifier as pclf
from cfgan_torch.eval import mask_analysis as pma
from cfgan_torch.eval import samples as psamples
from cfgan_torch.eval import tabular as ptab
from cfgan_torch.eval.figure import read_png, surface_colors
from cfgan_torch.models.classifiers import MLPClassifier
from cfgan_torch.models.generators import MoonsResidualGenerator
from cfgan_torch.train import classifier as ptrain_clf
from cfgan_torch.train import loop as ploop

from test_torch_figure import (
    assert_image_panel,
    assert_lines,
    assert_same_size,
    assert_saved_as_rendered,
    assert_titles,
    capture_mpl,
    capture_port,
    colorbars,
    panels,
)

MODEL_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU run shares its cores with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(monkeypatch, tmp_path, jax_draw, port_draw, name):
    """Draw with both packages into tmp_path/jax and tmp_path/port:
    (port figure, its path, JAX figure, JAX's PNG path)."""
    for side in ("jax", "port"):
        (tmp_path / side).mkdir(parents=True, exist_ok=True)
    jfigs = capture_mpl(monkeypatch)
    jax_draw(str(tmp_path / "jax"))
    pfigs = capture_port(monkeypatch)
    port_draw(str(tmp_path / "port"))
    fig, path = pfigs[name]
    return fig, path, jfigs[name], tmp_path / "jax" / name


def _check_common(fig, path, mfig, jax_png, tight=False):
    mp = panels(mfig)
    assert len(fig.axes) == len(mp)
    for ax, max_ in zip(fig.axes, mp):
        assert_titles(ax, max_)
    if not tight:
        assert_same_size(fig, jax_png)
    assert_saved_as_rendered(fig, path)
    return mp


def _history(seed, keys, n=7):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(n).tolist() for k in keys}


# ------------------------------------------------------------- curves
@pytest.mark.parametrize("keys", [("g_loss", "d_loss", "g_cls"),
                                  ("d_loss",), ("g_cls", "flip_rate")])
def test_loss_curves_match_jax(keys, monkeypatch, tmp_path):
    history = {**_history(0, keys), "wall_time_s": 3.5}
    fig, path, mfig, png = _both(
        monkeypatch, tmp_path,
        lambda d: jloop.plot_loss_curves(history, os.path.join(d, "l.png")),
        lambda d: ploop.plot_loss_curves(history, os.path.join(d, "l.png")),
        "l.png")
    mp = _check_common(fig, path, mfig, png)
    assert (fig.width, fig.height) == (800, 600)
    assert_lines(fig.axes[0], mp[0])


@pytest.mark.parametrize("val", [True, False])
def test_classifier_curves_match_jax(val, monkeypatch, tmp_path):
    history = _history(1, ("loss", "val_acc") if val else ("loss",))
    if not val:
        history["val_acc"] = []
    fig, path, mfig, png = _both(
        monkeypatch, tmp_path,
        lambda d: jtrain_clf.plot_classifier_curves(
            history, os.path.join(d, "c.png")),
        lambda d: ptrain_clf.plot_classifier_curves(
            history, os.path.join(d, "c.png")), "c.png")
    mp = _check_common(fig, path, mfig, png)
    for ax, max_ in zip(fig.axes, mp):
        assert_lines(ax, max_)


# ---------------------------------------------------- confusion matrix
@pytest.mark.parametrize("names", [None, ["Q0", "Q1", "Q2", "Q3"]])
def test_confusion_matrix_matches_jax(names, monkeypatch, tmp_path):
    cm = np.random.RandomState(2).randint(0, 60, (4, 4)).astype(np.int64)
    cm[1, 1] = 120
    fig, path, mfig, png = _both(
        monkeypatch, tmp_path,
        lambda d: jclf._plot_confusion(cm, os.path.join(d, "cm.png"), names,
                                       "Confusion Matrix"),
        lambda d: pclf.plot_confusion(cm, os.path.join(d, "cm.png"), names),
        "cm.png")
    mp = _check_common(fig, path, mfig, png)
    ax, max_ = fig.axes[0], mp[0]
    assert_image_panel(ax.images[0], max_.images[0])
    assert ax.xticks[1] == [t.get_text() for t in max_.get_xticklabels()]
    assert ax.yticks[1] == [t.get_text() for t in max_.get_yticklabels()]
    assert [(t["x"], t["y"], t["text"], t["color"]) for t in ax.texts] == [
        (*mt.get_position(), mt.get_text(), mcolors.to_rgba(mt.get_color()))
        for mt in max_.texts]
    assert colorbars(mfig) == 1 and ax.colorbar is not None


def test_evaluate_classifier_draws_the_confusion_matrix(tmp_path):
    x = np.random.RandomState(3).randn(50, 2).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int64)
    out = pclf.evaluate_classifier(lambda t: torch.stack([-t[:, 0], t[:, 0]],
                                                         1), x, y,
                                   out_dir=str(tmp_path), class_names=["a",
                                                                       "b"],
                                   device="cpu")
    assert out["accuracy"] == 1.0
    px = read_png(tmp_path / "confusion_matrix.png")
    assert px.shape == (600, 720, 3)


# ---------------------------------------------------------- mask analysis
def _policy_rows(seed, n_policies, with_nan=False):
    """Rows of `mask_policy_analysis.csv`: 4 targets a policy, flip rates
    0, 1/2 or 1, so that policies tie."""
    rng = np.random.RandomState(seed)
    rows = []
    for p in rng.permutation(n_policies):
        for t in range(4):
            flip = rng.randint(0, 3) / 2
            if with_nan and p == 0 and t == 0:
                flip = float("nan")
            rows.append({"policy": f"single:f{p:02d}", "n_modifiable": 1,
                         "target_class": t, "class_flip_rate": flip,
                         "prediction_gain": 0.0, "avg_actionability": 0.0})
    return rows


@pytest.mark.parametrize("seed,n,with_nan", [(0, 6, False), (1, 16, False),
                                             (2, 17, False), (3, 24, False),
                                             (4, 9, True)])
def test_mask_policy_bars_take_pandas_order(seed, n, with_nan, monkeypatch,
                                            tmp_path):
    rows = _policy_rows(seed, n, with_nan)
    df = pd.DataFrame(rows)
    agg = df.groupby("policy").agg(
        flip=("class_flip_rate", "mean"), n=("n_modifiable", "first")
    ).sort_values("flip")
    names, flips = pma.policy_flip_means(rows)
    assert names == list(agg.index)
    np.testing.assert_array_equal(flips, agg["flip"].to_numpy())
    assert len(set(flips.tolist())) < len(flips)  # ties to break
    fig, path, mfig, png = _both(
        monkeypatch, tmp_path,
        lambda d: jma._plot(df, os.path.join(d, "m.png")),
        lambda d: pma.plot_mask_policies(rows, os.path.join(d, "m.png")),
        "m.png")
    mp = _check_common(fig, path, mfig, png)
    _assert_bars(fig.axes[0], mp[0])


def _assert_bars(ax, max_):
    bars = ax.bars[0]
    assert bars["labels"] == [t.get_text() for t in max_.get_yticklabels()]
    np.testing.assert_array_equal(bars["values"],
                                  [p.get_width() for p in max_.patches])
    assert [p.get_y() + p.get_height() / 2 for p in max_.patches] == list(
        range(len(bars["values"])))
    assert all(bars["color"] == p.get_facecolor() for p in max_.patches)


def test_patch_budget_plot_matches_jax(monkeypatch, tmp_path):
    """The toy cf_fn of tests/test_eval_images.py at 28x28 with JAX's patch
    masks handed to the port."""
    rng = np.random.RandomState(4)
    x = rng.uniform(-1, 1, (24, 28, 28, 1)).astype(np.float32)
    y = rng.randint(0, 10, 24)
    w = rng.randn(28 * 28, 10).astype(np.float32)

    def jcf(g, xx, t, m, k=None):
        s = (2.0 * (t % 2).astype(xx.dtype) - 1.0)[:, None, None, None]
        raw = 0.1 * s * jnp.ones_like(xx)
        return jnp.clip(xx + raw * m, -1, 1), raw, raw * m

    def pcf(g, xx, t, m, k=None):
        s = (2.0 * (t % 2).to(xx.dtype) - 1.0)[:, None, None, None]
        raw = 0.1 * s * torch.ones_like(xx)
        return torch.clamp(xx + raw * m, -1, 1), raw, raw * m

    key = jax.random.key(0)
    budgets = [1, 2, 4, 6, 8, 10, 12, 16]
    masks = [np.asarray(jax_patch_mask(jax.random.fold_in(key, i), len(y),
                                       (28, 28), 7, n, channels=1))
             for i, n in enumerate(budgets)]
    fig, path, mfig, png = _both(
        monkeypatch, tmp_path,
        lambda d: jma.patch_budget_curve(
            jcf, lambda a: a.reshape(len(a), -1) @ jnp.asarray(w), {}, x, y,
            10, 7, key=key, out_dir=d),
        lambda d: pma.patch_budget_curve(
            pcf, lambda a: a.reshape(len(a), -1) @ torch.from_numpy(w), {},
            x, y, 10, 7, masks=masks, out_dir=d, device="cpu"),
        "patch_budget_curve.png")
    mp = _check_common(fig, path, mfig, png)
    ax, max_ = fig.axes[0], mp[0]
    assert_lines(ax, max_, atol=MODEL_ATOL)
    assert ax.ylim == max_.get_ylim()


# ------------------------------------------------------ tabular reports
@pytest.fixture(scope="module")
def report_inputs():
    """A sweep's counterfactuals over 60 rows of the house schema, 4
    classes, and both packages' MinMax stats."""
    rng = np.random.RandomState(5)
    d = len(KC_SCHEMA.feature_names)
    x = rng.rand(60, d).astype(np.float32)
    y = rng.randint(0, 4, 60)
    x_cf = np.clip(x[None] + rng.randn(4, 60, d).astype(np.float32) * 0.1,
                   0, 1)
    lo = rng.rand(d) * 10
    hi = lo + 1 + rng.rand(d) * 100
    return ({"x_cf": x_cf}, x, y, JaxNormStats(lo, hi), NormStats(lo, hi))


def test_feature_shift_importance_plot_matches_jax(report_inputs,
                                                   monkeypatch, tmp_path):
    sweep, x, y, jstats, pstats = report_inputs
    fig, path, mfig, png = _both(
        monkeypatch, tmp_path,
        lambda d: jtab.feature_shift_importance(sweep, x, y, JAX_SCHEMA,
                                                jstats, out_dir=d),
        lambda d: ptab.feature_shift_importance(sweep, x, y, KC_SCHEMA,
                                                pstats, out_dir=d),
        "feature_shift_importance.png")
    mp = _check_common(fig, path, mfig, png)
    for ax, max_ in zip(fig.axes, mp):
        _assert_bars(ax, max_)


@pytest.mark.parametrize("source", range(4))
def test_class_pair_sensitivity_plots_match_jax(report_inputs, source,
                                                monkeypatch, tmp_path):
    sweep, x, y, _, _ = report_inputs
    name = f"src{source}.png"
    fig, path, mfig, png = _both(
        monkeypatch, tmp_path,
        lambda d: jtab.class_pair_sensitivity(sweep, x, y, JAX_SCHEMA,
                                              out_dir=d),
        lambda d: ptab.class_pair_sensitivity(sweep, x, y, KC_SCHEMA,
                                              out_dir=d), name)
    png = tmp_path / "jax" / "class_pair_sensitivity" / name
    mp = _check_common(fig, path, mfig, png)
    ax, max_ = fig.axes[0], mp[0]
    assert ax.images[0]["aspect"] == max_.get_aspect() == "auto"
    assert_image_panel(ax.images[0], max_.images[0])
    assert ax.yticks[1] == [t.get_text() for t in max_.get_yticklabels()]
    assert ax.xticks[1] == [t.get_text() for t in max_.get_xticklabels()]
    assert colorbars(mfig) == 1 and ax.colorbar is not None


# ------------------------------------------------------------ boundaries
@pytest.fixture(scope="module", params=["toy", "generator"])
def moons(request):
    """A moons MLP classifier (hidden 8) and a cf_fn: the toy x + 0.05 (t
    + 1) inside the mask, or a moons residual generator (hidden 8) on
    random BatchNorm statistics, JAX's weights carried to the port."""
    rng = np.random.RandomState(6)
    x = rng.rand(90, 2).astype(np.float32)
    y = rng.randint(0, 3, 90)
    jc = JaxMLP(hidden_dim=8)
    cv = jax.tree_util.tree_map(np.asarray, jc.init(jax.random.key(4),
                                                    x[:2]))
    pc = MLPClassifier(3, 8)
    pc.load_state_dict(state_dict_from_flax(pc, cv))
    out = {"x": x, "y": y,
           "jax_clf": lambda a: jc.apply(cv, a, train=False),
           "port_clf": lambda a: pc(a).detach()}
    if request.param == "toy":
        out["jax_cf"] = lambda g, a, t, m, k=None: (
            a + 0.05 * (t[:, None] + 1) * m, None, None)
        out["port_cf"] = lambda g, a, t, m, k=None: (
            a + 0.05 * (t[:, None] + 1) * m, None, None)
        return out
    jg = JaxMoonsG(hidden_dim=8)
    oh = np.eye(3, dtype=np.float32)
    gv = jax.tree_util.tree_map(np.asarray, jg.init(
        jax.random.key(1), x[:2], oh[:2], np.ones((2, 2), np.float32)))
    for name, stats in gv["batch_stats"].items():
        stats["mean"] = rng.randn(*stats["mean"].shape).astype(np.float32)
        stats["var"] = (0.5 + rng.rand(*stats["var"].shape)).astype(
            np.float32)
    pg = MoonsResidualGenerator(2, 8, 3)
    pg.load_state_dict(state_dict_from_flax(pg, gv))
    pg.eval()

    def jax_cf(g, a, t, m, k=None):
        _, masked = jg.apply(gv, a, jax.nn.one_hot(t, 3), m, train=False)
        return a + masked, None, masked

    def port_cf(g, a, t, m, k=None):
        with torch.no_grad():
            _, masked = pg(a, torch.nn.functional.one_hot(t, 3).float(), m)
        return a + masked, None, masked

    out["jax_cf"], out["port_cf"] = jax_cf, port_cf
    return out


def test_decision_surface_matches_jax_but_at_near_ties(moons):
    xs, ys, got = pb.decision_surface(moons["port_clf"], device="cpu")
    jxs, jys, want = jb.decision_surface(moons["jax_clf"])
    np.testing.assert_array_equal(xs, jxs)
    np.testing.assert_array_equal(ys, jys)
    gx, gy = np.meshgrid(jxs, jys)
    grid = np.stack([gx.ravel(), gy.ravel()], 1).astype(np.float32)
    top2 = np.sort(np.asarray(moons["jax_clf"](jnp.asarray(grid))), 1)[:, -2:]
    near = (top2[:, 1] - top2[:, 0] <= 1e-6).reshape(got.shape)
    differ = got != want
    assert not (differ & ~near).any()
    assert differ.sum() <= near.sum() < 0.001 * got.size


def _assert_boundary_figure(fig, path, mfig, png, surface_alpha):
    mp = _check_common(fig, path, mfig, png)
    ax, max_ = fig.axes[0], mp[0]
    contour = max_.collections[0]
    sf = ax.surfaces[0]
    assert sf["alpha"] == surface_alpha
    np.testing.assert_array_equal(surface_colors(sf),
                                  contour.get_facecolor())
    scatters = max_.collections[1:]
    assert len(ax.scatters) == len(scatters)
    for p, sc in zip(ax.scatters, scatters):
        np.testing.assert_allclose(np.stack([p["x"], p["y"]], 1),
                                   sc.get_offsets(), atol=MODEL_ATOL,
                                   rtol=0)
        face = sc.get_facecolors()
        np.testing.assert_array_equal(
            p["facecolors"], np.broadcast_to(face, p["facecolors"].shape))
        assert p["marker"] == {"o": "o", "x": "x", "*": "*"}[p["marker"]]
        if p["edgecolor"] is not None:
            assert p["edgecolor"] == tuple(sc.get_edgecolor()[0])
    return ax, max_


def test_boundaries_only_matches_jax(moons, monkeypatch, tmp_path):
    for hl in (None, (0.3, 0.6)):
        fig, path, mfig, png = _both(
            monkeypatch, tmp_path,
            lambda d: jb.plot_decision_boundaries_only(
                moons["jax_clf"], moons["x"], moons["y"],
                os.path.join(d, "b.png"), highlight=hl),
            lambda d: pb.plot_decision_boundaries_only(
                moons["port_clf"], moons["x"], moons["y"],
                os.path.join(d, "b.png"), highlight=hl, device="cpu"),
            "b.png")
        ax, max_ = _assert_boundary_figure(fig, path, mfig, png, 0.3)
        assert len(ax.scatters) == (1 if hl is None else 2)


def test_boundaries_and_cfs_match_jax(moons, monkeypatch, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jfigs = capture_mpl(monkeypatch)
    want = jb.plot_decision_boundaries_and_cfs(
        moons["jax_clf"], moons["jax_cf"], {}, moons["x"], moons["y"], 3,
        str(tmp_path / "jax"), n_cf_samples=7)
    pfigs = capture_port(monkeypatch)
    got = pb.plot_decision_boundaries_and_cfs(
        moons["port_clf"], moons["port_cf"], {}, moons["x"], moons["y"], 3,
        str(tmp_path / "port"), n_cf_samples=7, device="cpu")
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want] == [
        f"decision_boundaries_cfs_src{s}_tgt{t}.png"
        for s in range(3) for t in range(3) if s != t]
    for name in map(os.path.basename, want):
        fig, path = pfigs[name]
        ax, max_ = _assert_boundary_figure(fig, path, jfigs[name],
                                           tmp_path / "jax" / name, 0.25)
        arrows = [t for t in max_.texts if t.arrow_patch is not None]
        assert len(ax.arrows) == len(arrows) == 7
        for a, ma in zip(ax.arrows, arrows):
            np.testing.assert_allclose(a["start"], ma.xyann, atol=0)
            np.testing.assert_allclose(a["end"], ma.xy, atol=MODEL_ATOL)
            assert a["color"] == mcolors.to_rgba(
                ma.arrow_patch.get_edgecolor())
            assert a["linewidth"] == ma.arrow_patch.get_linewidth()


# ------------------------------------------------------------ generation
@pytest.mark.parametrize("labels", [False, True])
def test_scatter_matches_jax(labels, monkeypatch, tmp_path):
    rng = np.random.RandomState(7)
    real, fake = rng.randn(50, 2), rng.randn(12, 2)
    lab = np.arange(12) % 3 if labels else None
    fig, path, mfig, png = _both(
        monkeypatch, tmp_path,
        lambda d: jsamples.save_scatter(real, fake, os.path.join(d, "s.png"),
                                        labels=lab),
        lambda d: psamples.save_scatter(real, fake, os.path.join(d, "s.png"),
                                        labels=lab), "s.png")
    mp = _check_common(fig, path, mfig, png)
    ax, max_ = fig.axes[0], mp[0]
    assert len(ax.scatters) == len(max_.collections)
    for p, sc in zip(ax.scatters, max_.collections):
        np.testing.assert_array_equal(np.stack([p["x"], p["y"]], 1),
                                      sc.get_offsets())
        np.testing.assert_array_equal(p["facecolors"][:1],
                                      sc.get_facecolors())
        assert p["label"] == sc.get_label()
    assert [e["label"] for e in ax.legend_entries()] == [
        t.get_text() for t in max_.get_legend().get_texts()]


@pytest.mark.parametrize("keys", [("g_loss", "d_loss"), ("d_loss",)])
def test_loss_plot_matches_jax(keys, monkeypatch, tmp_path):
    history = {**_history(8, keys), "wall_time_s": 1.0}
    fig, path, mfig, png = _both(
        monkeypatch, tmp_path,
        lambda d: jsamples.save_loss_plot(history, os.path.join(d, "l.png")),
        lambda d: psamples.save_loss_plot(history, os.path.join(d, "l.png")),
        "l.png")
    mp = _check_common(fig, path, mfig, png)
    assert_lines(fig.axes[0], mp[0])


def test_make_gif_matches_jax(tmp_path):
    """Frames as arrays, and as the port's PNGs: the same GIF, which PIL
    decodes to the frames with the duration and loop of JAX's."""
    rng = np.random.RandomState(9)
    frames = [psamples.to_uint8_grid(rng.uniform(-1, 1, (16, 8, 8, 1)),
                                     nrow=4) for _ in range(3)]
    pngs = [psamples.write_png(str(tmp_path / f"f{i}.png"), f)
            for i, f in enumerate(frames)]
    jsamples.make_gif(frames, str(tmp_path / "j.gif"), fps=5)
    psamples.make_gif(frames, str(tmp_path / "a.gif"), fps=5)
    psamples.make_gif(pngs, str(tmp_path / "b.gif"), fps=5)
    assert (tmp_path / "a.gif").read_bytes() == (tmp_path / "b.gif"
                                                  ).read_bytes()
    got, want = Image.open(tmp_path / "a.gif"), Image.open(tmp_path /
                                                           "j.gif")
    assert got.n_frames == want.n_frames == 3
    for i, f in enumerate(frames):
        got.seek(i)
        want.seek(i)
        np.testing.assert_array_equal(np.asarray(got.convert("L")), f)
        assert (got.info.get("duration"), got.info.get("loop")) == (
            want.info.get("duration"), want.info.get("loop"))
    Image.fromarray(frames[0]).save(tmp_path / "pil.png", optimize=True)
    with pytest.raises(ValueError):
        psamples.make_gif([str(tmp_path / "pil.png")],
                          str(tmp_path / "c.gif"))
