"""The port's image figures (`cfgan_torch.eval.images`) against the JAX
package's (`cfgan.eval.images`), on the CPU: `pick_one_per_class`,
`counterfactual_grid`, `heatmap_panels`, `patch_grid_overlay` and
`user_modification_example`.

Each runs twice on inputs from a numpy seed: with the toy cf_fn / clf_fn
of tests/test_eval_images.py (a +-0.1 residual inside the mask, a linear
classifier), and with a small real generator (hidden 8, two residual
blocks, 14x14 images, 4 classes, 7-px patches) and CNN classifier, JAX's
initial weights carried to the port by `cfgan_torch.convert`.

The JAX figures are captured by recording `matplotlib.figure.Figure`
at `savefig`; the port's at `cfgan_torch.eval.figure.Figure.save`.
Compared: the flip matrices, predictions and `pick_one_per_class`
exactly; x_cf, residuals and every image panel's data within 3e-5
(float32 products in other orders; TF32 plays no part on the CPU), with
the panel's colour map and bounds, and its mapped bytes equal to
matplotlib's `to_rgba(..., bytes=True)` wherever the two data agree;
confidences within 1e-5; titles, labels, the suptitle and the
colorbars; the grid's spine colours against the flip matrix; the
overlay's rectangles and numbers; canvas sizes against JAX's PNGs
(not the overlay's: JAX saves it with a tight box); and each port PNG
decoded by PIL equal to its `render()`.
"""
import jax
import jax.numpy as jnp
import matplotlib.colors as mcolors
import numpy as np
import pytest
import torch

from cfgan.core.config import CounterGANConfig as JaxConfig
from cfgan.core.config import MaskConfig as JaxMaskConfig
from cfgan.eval import images as jimg
from cfgan.models.classifiers import CNNClassifier as JaxCNN
from cfgan.train.builders import build_mnist_countergan as jax_build_mnist
from cfgan.train.state import NetState as JaxNetState
from cfgan.train.state import adam_like_torch as jax_adam
from cfgan_torch.convert import load_gan_state, state_dict_from_flax
from cfgan_torch.core.config import CounterGANConfig, MaskConfig
from cfgan_torch.eval import images as pimg
from cfgan_torch.models.classifiers import CNNClassifier
from cfgan_torch.train import builders

from test_torch_figure import (
    assert_blocks,
    assert_image_panel,
    assert_same_size,
    assert_saved_as_rendered,
    assert_titles,
    capture_mpl,
    capture_port,
    colorbars,
    panels,
)
from test_torch_step import RECIPE

HW, NC, PATCH = (14, 14), 4, 7
ATOL, CONF_ATOL = 3e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU run shares its cores with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------ models
_W = np.asarray(jax.random.normal(jax.random.key(0), (HW[0] * HW[1], NC)))


def jax_toy_cf(g_vars, x, target, mask, key=None):
    """tests/test_eval_images.py's residual: +-0.1 inside the mask, the
    sign keyed to the target's parity."""
    sign = (2.0 * (target % 2).astype(x.dtype) - 1.0)[:, None, None, None]
    raw = 0.1 * sign * jnp.ones_like(x)
    masked = raw * mask
    return jnp.clip(x + masked, -1, 1), raw, masked


def port_toy_cf(g_vars, x, target, mask, key=None):
    sign = (2.0 * (target % 2).to(x.dtype) - 1.0)[:, None, None, None]
    raw = 0.1 * sign * torch.ones_like(x)
    masked = raw * mask
    return torch.clamp(x + masked, -1, 1), raw, masked


def _toy():
    w = torch.from_numpy(_W.copy())
    return {"jax": (jax_toy_cf,
                    lambda x: x.reshape(x.shape[0], -1) @ jnp.asarray(_W),
                    {}),
            "port": (port_toy_cf, lambda x: x.reshape(x.shape[0], -1) @ w,
                     {})}


def _generator():
    """The residual family at hidden 8, two blocks, 14x14 / 4 classes,
    both packages from JAX's initial state."""
    mask = dict(kind="patch", patch_size=PATCH, num_modifiable_patches=2)
    fields = {**RECIPE, "num_res_blocks": 2}
    jcfg = JaxConfig(**fields, mask=JaxMaskConfig(**mask))
    pcfg = CounterGANConfig(**fields, mask=MaskConfig(**mask))
    jclf, pclf = JaxCNN(num_classes=NC), CNNClassifier(NC, image_hw=HW)
    clf_vars = _np(dict(jclf.init(jax.random.key(1),
                                  jnp.zeros((2, *HW, 1)))))
    bundle = jax_build_mnist(jcfg, jclf,
                             JaxNetState.create(clf_vars, jax_adam(1e-3)),
                             num_classes=NC, image_hw=HW, seed=7)
    port = builders.build_mnist_countergan(
        pcfg, state_dict_from_flax(pclf, clf_vars), device="cpu",
        num_classes=NC, image_hw=HW)
    state = bundle.state
    load_gan_state(port.state, _np({"g": state.g.variables(),
                                    "d": state.d.variables(),
                                    "g_ema": state.g_ema}))
    pclf.load_state_dict(state_dict_from_flax(pclf, clf_vars))
    pclf.eval()

    def port_clf(x):
        with torch.no_grad():
            return pclf(x)

    return {"jax": (bundle.cf_fn,
                    lambda x: jclf.apply(clf_vars, x, train=False),
                    state.g.variables()),
            "port": (port.cf_fn, port_clf, port.state.g.model.state_dict())}


@pytest.fixture(scope="module", params=["toy", "generator"])
def models(request):
    return _toy() if request.param == "toy" else _generator()


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (32, *HW, 1)).astype(np.float32)
    y = rng.randint(0, NC, 32)
    y[:NC] = np.arange(NC)[::-1]
    return x, y


# ------------------------------------------------------------- tests
@pytest.mark.parametrize("seed", [0, 1, 5])
def test_pick_one_per_class_matches_jax(data, seed):
    x, y = data
    got_x, got_i = pimg.pick_one_per_class(x, y, NC, seed)
    want_x, want_i = jimg.pick_one_per_class(x, y, NC, seed)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_x, want_x)
    with pytest.raises(ValueError, match="no sample of class"):
        pimg.pick_one_per_class(x, np.zeros_like(y), NC)


def _run(models, data, tmp_path, monkeypatch, jax_call, port_call):
    """Both packages' figure calls: (JAX result, JAX figures, port
    result, port figures)."""
    jfigs = capture_mpl(monkeypatch)
    jcf, jclf, jvars = models["jax"]
    want = jax_call(jcf, jclf, jvars, tmp_path / "jax")
    pfigs = capture_port(monkeypatch)
    pcf, pclf, pvars = models["port"]
    got = port_call(pcf, pclf, pvars, tmp_path / "port")
    return want, jfigs, got, pfigs


def test_counterfactual_grid_matches_jax(models, data, tmp_path,
                                         monkeypatch):
    x, y = data
    want, jfigs, got, pfigs = _run(
        models, data, tmp_path, monkeypatch,
        lambda cf, clf, v, d: jimg.counterfactual_grid(
            cf, clf, v, x, y, NC, str(d / "grid.png")),
        lambda cf, clf, v, d: pimg.counterfactual_grid(
            cf, clf, v, x, y, NC, str(d / "grid.png"), device="cpu"))
    np.testing.assert_array_equal(got, want)
    fig, path = pfigs["grid.png"]
    mfig = jfigs["grid.png"]
    assert fig.suptitle_text == mfig._suptitle.get_text()
    mpanels = panels(mfig)
    assert len(fig.axes) == len(mpanels) == NC * NC
    px = fig.render()
    for i, (ax, max_) in enumerate(zip(fig.axes, mpanels)):
        s, t = divmod(i, NC)
        assert_titles(ax, max_)
        assert_image_panel(ax.images[0], max_.images[0], ATOL)
        assert_blocks(px, ax.images[0])
        green = mcolors.to_rgba("green" if got[s, t] else "red")
        assert ax.spines["color"] == green
        assert all(sp.get_edgecolor() == green
                   for sp in max_.spines.values())
        assert ax.spines["width"] == max_.spines["left"].get_linewidth()
    assert_same_size(fig, tmp_path / "jax" / "grid.png")
    assert_saved_as_rendered(fig, path)


def test_heatmap_panels_match_jax(models, data, tmp_path, monkeypatch):
    x, y = data
    t = (y[:6] + 1) % NC
    mask = np.ones((6, *HW, 1), np.float32)
    mask[::2, :PATCH] = 0.0
    want, jfigs, got, pfigs = _run(
        models, data, tmp_path, monkeypatch,
        lambda cf, clf, v, d: jimg.heatmap_panels(
            cf, clf, v, x[:6], y[:6], t, mask, str(d), max_samples=6),
        lambda cf, clf, v, d: pimg.heatmap_panels(
            cf, clf, v, x[:6], y[:6], t, mask, str(d), max_samples=6,
            device="cpu"))
    np.testing.assert_array_equal(got["preds"], want["preds"])
    np.testing.assert_allclose(got["confidence"], want["confidence"],
                               atol=CONF_ATOL, rtol=0)
    names = [f"sample_{i}.png" for i in range(6)] + ["batch_overview.png"]
    assert sorted(pfigs) == sorted(jfigs) == sorted(names)
    for name in names:
        fig, path = pfigs[name]
        mfig = jfigs[name]
        mpanels = panels(mfig)
        assert len(fig.axes) == len(mpanels)
        px = fig.render()
        for ax, max_ in zip(fig.axes, mpanels):
            assert_titles(ax, max_)
            assert ax.axis_on == max_.axison
            if max_.images:
                assert_image_panel(ax.images[0], max_.images[0], ATOL)
                assert_blocks(px, ax.images[0])
        assert sum(ax.colorbar is not None for ax in fig.axes) == colorbars(
            mfig)
        assert_same_size(fig, tmp_path / "jax" / name)
        assert_saved_as_rendered(fig, path)


@pytest.mark.parametrize("highlight", [(), (0, 3)])
def test_patch_grid_overlay_matches_jax(data, tmp_path, monkeypatch,
                                        highlight):
    x, _ = data
    jfigs = capture_mpl(monkeypatch)
    jimg.patch_grid_overlay(x[0], PATCH, str(tmp_path / "j.png"), highlight)
    pfigs = capture_port(monkeypatch)
    assert pimg.patch_grid_overlay(x[0], PATCH, str(tmp_path / "p.png"),
                                   highlight) == str(tmp_path / "p.png")
    (fig, path), mfig = pfigs["p.png"], jfigs["j.png"]
    ax, max_ = fig.axes[0], panels(mfig)[0]
    assert_image_panel(ax.images[0], max_.images[0])
    assert not ax.axis_on and not max_.axison
    assert len(ax.rects) == len(max_.patches) == 4
    for r, mr in zip(ax.rects, max_.patches):
        assert r["xy"] == tuple(mr.get_xy())
        assert (r["width"], r["height"]) == (mr.get_width(),
                                             mr.get_height())
        assert r["edgecolor"] == tuple(mr.get_edgecolor())
        assert r["linewidth"] == mr.get_linewidth()
        assert (r["facecolor"] is not None) == mr.get_fill()
        if mr.get_fill():
            assert r["facecolor"] == tuple(mr.get_facecolor())
    assert [(t["x"], t["y"], t["text"], t["color"]) for t in ax.texts] == [
        (*mt.get_position(), mt.get_text(), mcolors.to_rgba(mt.get_color()))
        for mt in max_.texts]
    assert_saved_as_rendered(fig, path)


@pytest.mark.parametrize("target,patches", [(1, [0]), (2, [1, 2, 3])])
def test_user_modification_example_matches_jax(models, data, tmp_path,
                                               monkeypatch, target,
                                               patches):
    x, _ = data
    want, jfigs, got, pfigs = _run(
        models, data, tmp_path, monkeypatch,
        lambda cf, clf, v, d: jimg.user_modification_example(
            cf, clf, v, x[3], target, patches, PATCH,
            path=str(d / "um.png")),
        lambda cf, clf, v, d: pimg.user_modification_example(
            cf, clf, v, x[3], target, patches, PATCH,
            path=str(d / "um.png"), device="cpu"))
    assert got["pred"] == want["pred"]
    assert abs(got["confidence"] - want["confidence"]) <= CONF_ATOL
    for k in ("x_cf", "residual"):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got["mask"], want["mask"])
    (fig, path), mfig = pfigs["um.png"], jfigs["um.png"]
    px = fig.render()
    for ax, max_ in zip(fig.axes, panels(mfig)):
        assert_titles(ax, max_)
        assert_image_panel(ax.images[0], max_.images[0], ATOL)
        assert_blocks(px, ax.images[0])
    assert colorbars(mfig) == 0 and all(a.colorbar is None
                                        for a in fig.axes)
    assert_same_size(fig, tmp_path / "jax" / "um.png")
    assert_saved_as_rendered(fig, path)


def test_image_figures_take_tensors_on_the_device(data, tmp_path):
    """Inputs as tensors (the experiment's targets live on its device)
    draw the same figures as numpy inputs."""
    x, y = data
    cf, clf, _ = _toy()["port"]
    t = (y[:4] + 1) % NC
    a = pimg.heatmap_panels(cf, clf, {}, x[:4], y[:4], t,
                            np.ones((4, *HW, 1), np.float32),
                            str(tmp_path / "a"), device="cpu")
    b = pimg.heatmap_panels(cf, clf, {}, torch.from_numpy(x[:4]),
                            torch.from_numpy(y[:4]), torch.from_numpy(t),
                            torch.ones((4, *HW, 1)), str(tmp_path / "b"),
                            device="cpu")
    np.testing.assert_array_equal(a["preds"], b["preds"])
    for name in ("sample_0.png", "batch_overview.png"):
        assert ((tmp_path / "a" / name).read_bytes()
                == (tmp_path / "b" / name).read_bytes())
