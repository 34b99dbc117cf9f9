"""`cfgan_torch.serve.apps` and the launcher's app mode against
`cfgan.serve.apps` on the same inputs, on the CPU, with no gradio and no
network (every test clears the LLM providers' keys; the LLM is a
scripted callable).

- `MnistChatBackend` on a hidden-16, two-block `ImageResidualGenerator`
  and a `CNNClassifier` at 28x28, the weights carried from flax by
  `cfgan_torch.convert`: the same dialogue in both packages picks the
  same `current_idx` and replies the same text, with the same pred; the
  confidence within 3e-5 (float32 softmax in two frameworks) and x_cf,
  residual and mask of each transform (read from the figure call) within
  3e-5.  `llm=False` and a scripted `llm`, whose prompts are equal.
- `HouseBackend` on a fabricated engine over each package's King County
  schema (residual 0.1 inside the mask, clamped to [0, 1]: masked-out
  features have abs_delta exactly 0, and unclamped allowed ones exactly
  0.1, so ties are the rule): the `Table` equals the JAX DataFrame
  column for column and row for row, in order (numbers within 3e-5 of
  their units), and the texts character for character.
- `MoonsBackend` on the committed `results/moons_countergan/` through
  both packages' `setup_moons`: the PNGs, the `CFResult` (3e-5, equal
  predictions), the verdict, and the arrow plot's content against the
  JAX matplotlib figure's.
- `build_*_app` with a stub gradio (every bound callback run); their
  `ImportError` without gradio; `launch.main` without `--api` under the
  stub launching the app with `server_name` and `share`, and without
  gradio exiting non-zero in a subprocess.
"""
import ast
import os
import subprocess
import sys
import tempfile
import types
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import matplotlib.colors as mcolors
import numpy as np
import pandas as pd
import pytest
import torch

from cfgan.core.config import CounterGANConfig as JaxConfig
from cfgan.core.config import MaskConfig as JaxMaskConfig
from cfgan.data.kc_house import KC_SCHEMA as JAX_SCHEMA
from cfgan.data.transforms import NormStats as JaxNormStats
from cfgan.eval import images as jimg
from cfgan.models.classifiers import CNNClassifier as JaxClassifier
from cfgan.serve import apps as japps
from cfgan.serve import launch as jlaunch
from cfgan.serve.engine import CounterfactualEngine as JaxEngine
from cfgan.train.builders import build_mnist_countergan
from cfgan_torch.convert import state_dict_from_flax
from cfgan_torch.core.config import MNIST_COUNTERGAN
from cfgan_torch.data.kc_house import KC_SCHEMA
from cfgan_torch.data.transforms import NormStats
from cfgan_torch.eval import images as pimg
from cfgan_torch.eval.figure import read_png
from cfgan_torch.eval.tabular import descending_order
from cfgan_torch.serve import apps, launch
from cfgan_torch.serve.engine import CounterfactualEngine
from cfgan_torch.train.builders import build_mnist_serving, mnist_models

from test_torch_figure import assert_titles, capture_mpl, capture_port

ROOT = Path(__file__).resolve().parent.parent
MOONS_RUN = ROOT / "results" / "moons_countergan"
HOUSE_RUN = ROOT / "results" / "house_countergan"
ATOL = 3e-5
WIDTH, DEPTH = 16, 2


@pytest.fixture(autouse=True)
def isolated(monkeypatch, tmp_path):
    """No provider keys; both packages' temporary PNGs under tmp_path."""
    for k in ("GEMINI_API_KEY", "GOOGLE_API_KEY", "OPENAI_API_KEY"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


# ------------------------------------------------------------------- MNIST
@pytest.fixture(scope="module")
def mnist():
    """The JAX engine (lax convs) and the port's (`conv_impl="pallas"`,
    the kernel's plain version on the CPU) on the same weights, and 40
    test images holding every digit."""
    cfg = JaxConfig(hidden_dim=WIDTH, num_res_blocks=DEPTH,
                    compute_dtype="float32",
                    mask=JaxMaskConfig(patch_size=7))
    clf_model = JaxClassifier()
    clf_vars = jax.tree_util.tree_map(np.asarray, dict(clf_model.init(
        jax.random.key(1), jnp.zeros((2, 28, 28, 1)))))
    clf_state = types.SimpleNamespace(params=clf_vars["params"], stats={},
                                      variables=lambda: clf_vars)
    bundle = build_mnist_countergan(cfg, clf_model, clf_state, seed=3)
    g_vars = jax.tree_util.tree_map(np.asarray, bundle.state.g.variables())
    rng = np.random.default_rng(4)
    g_vars["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        g_vars["batch_stats"])
    jeng = JaxEngine.from_bundle(bundle, clf_model, clf_state,
                                 g_variables=g_vars, patch_size=7)
    pcfg = replace(MNIST_COUNTERGAN, hidden_dim=WIDTH, num_res_blocks=DEPTH,
                   compute_dtype="float32", conv_impl="pallas")
    g, c = mnist_models(pcfg)
    s = build_mnist_serving(pcfg, state_dict_from_flax(g, g_vars),
                            state_dict_from_flax(c, clf_vars), device="cpu")
    peng = CounterfactualEngine(s.cf_fn, s.clf_fn, s.num_classes,
                                patch_size=7, device="cpu")
    data = np.random.default_rng(5)
    x = data.uniform(-1, 1, (40, 28, 28, 1)).astype(np.float32)
    y = data.permutation(np.arange(40) % 10)
    return jeng, peng, x, y


def _spy_transforms(monkeypatch):
    """Each package's `user_modification_example` results, in order."""
    seen = {"jax": [], "port": []}
    for name, mod in (("jax", jimg), ("port", pimg)):
        orig = mod.user_modification_example

        def spy(*a, _orig=orig, _name=name, **k):
            out = _orig(*a, **k)
            seen[_name].append(out)
            return out

        monkeypatch.setattr(mod, "user_modification_example", spy)
    return seen


def _assert_same_transforms(seen):
    assert len(seen["port"]) == len(seen["jax"]) > 0
    for got, want in zip(seen["port"], seen["jax"]):
        assert got["pred"] == want["pred"]
        assert abs(got["confidence"] - want["confidence"]) <= ATOL
        for k in ("x_cf", "residual", "mask"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       atol=ATOL, rtol=0, err_msg=k)


DIALOGUES = {
    "show_then_transform": ["show me a 3",
                            "turn it into an 8 using patches 5, 6, 9, 10",
                            "what is the weather"],
    "transform_first": ["make it into a 1 with patch 0",
                        "please show 7", "change it to 2 patches 15"],
    "help_only": ["hello", "thanks"],
}


@pytest.mark.parametrize("dialogue", DIALOGUES)
@pytest.mark.parametrize("seed", [0, 11])
def test_mnist_chat_matches_jax(mnist, monkeypatch, dialogue, seed):
    jeng, peng, x, y = mnist
    seen = _spy_transforms(monkeypatch)
    jb = japps.MnistChatBackend(jeng, x, y, patch_size=7, llm=False,
                                seed=seed)
    pb = apps.MnistChatBackend(peng, x, y, patch_size=7, llm=False,
                               seed=seed)
    assert pb.llm is None and pb.n_patches == jb.n_patches == 16
    history = []
    for msg in DIALOGUES[dialogue]:
        text, img = pb.reply(msg, history)
        jtext, jimg_path = jb.reply(msg, history)
        assert text == jtext
        assert pb.current_idx == jb.current_idx
        assert (img is None) == (jimg_path is None)
        if img is not None:
            assert read_png(img).shape[2] == 3
        history.append((msg, text))
    if dialogue != "help_only":
        _assert_same_transforms(seen)


def test_mnist_chat_with_a_scripted_llm_matches_jax(mnist, monkeypatch):
    """The LLM branch: the same prompts (system prompt, transcript, the
    new message), the action read from the scripted reply and stripped
    from the text."""
    jeng, peng, x, y = mnist
    seen = _spy_transforms(monkeypatch)
    replies = ['Showing. <!-- {"action": "show_digit", "value": 2} -->',
               'Done. <!-- {"action": "transform_digit", "target": 5, '
               '"patches": [1, 2, 5]} -->',
               'Sorry. <!-- {"action": "transform_digit", "target": 5, '
               '"patches": [99]} -->']
    prompts = {"jax": [], "port": []}

    def llm(name):
        def chat(prompt):
            prompts[name].append(prompt)
            return replies[len(prompts[name]) - 1]
        return chat

    jb = japps.MnistChatBackend(jeng, x, y, llm=llm("jax"))
    pb = apps.MnistChatBackend(peng, x, y, llm=llm("port"))
    history = [("hi", "hello")]
    for msg in ("show me a two", "now a five, top rows", "patch 99"):
        text, img = pb.reply(msg, history)
        jtext, jimg_path = jb.reply(msg, history)
        assert text == jtext and (img is None) == (jimg_path is None)
        assert pb.current_idx == jb.current_idx
        assert "<!--" not in text
        history.append((msg, text))
    assert prompts["port"] == prompts["jax"]
    assert "User: hi" in prompts["port"][0]
    assert prompts["port"][0].startswith(apps.MNIST_SYSTEM_PROMPT)
    assert apps.MNIST_SYSTEM_PROMPT == japps.MNIST_SYSTEM_PROMPT
    assert y[pb.current_idx] == 2
    _assert_same_transforms(seen)
    assert len(seen["port"]) == 1  # the out-of-range patch is refused


def test_mnist_transform_runs_on_the_engines_device(mnist, monkeypatch):
    """The backend's transform hands the engine's device and its weights'
    cf_fn to the figure, not the figure's defaults."""
    _, peng, x, y = mnist
    calls = []
    orig = pimg.user_modification_example

    def spy(*a, **k):
        calls.append(k.get("device"))
        return orig(*a, **k)

    monkeypatch.setattr(pimg, "user_modification_example", spy)
    backend = apps.MnistChatBackend(peng, x, y, llm=False)
    path, ok, pred, conf = backend.transform(3, [5, 6])
    assert calls == [peng.device]
    assert isinstance(ok, bool) and 0 <= pred < 10 and 0 < conf <= 1
    assert read_png(path).shape == (int(2.8 * 120), 10 * 120, 3)


# ------------------------------------------------------------------- house
def _house(pkg: str, seed: int = 0):
    """(engine, stats) of a fabricated house engine in package `pkg`:
    residual 0.1 inside the mask, clamped to [0, 1]; a fixed linear
    classifier; MinMax stats of other ranges a feature."""
    rng = np.random.default_rng(seed)
    d = KC_SCHEMA.input_dim
    w = rng.normal(size=(d, 4)).astype(np.float32)
    lo = rng.uniform(0, 100, d).astype(np.float32)
    hi = lo + rng.uniform(1, 5000, d).astype(np.float32)
    if pkg == "jax":
        def cf_fn(g_vars, x, target, mask, key=None):
            raw = 0.1 * jnp.ones_like(x)
            return jnp.clip(x + raw * mask, 0, 1), raw, raw * mask

        stats = JaxNormStats(data_min=lo, data_max=hi)
        return JaxEngine(cf_fn, lambda x: x @ w, {}, num_classes=4,
                         schema=JAX_SCHEMA, stats=stats), stats

    def pcf_fn(x, target, mask, key=None):
        raw = 0.1 * torch.ones_like(x)
        return torch.clamp(x + raw * mask, 0, 1), raw, raw * mask

    stats = NormStats(data_min=lo, data_max=hi)
    wt = torch.from_numpy(w)
    return CounterfactualEngine(pcf_fn, lambda x: x @ wt, 4,
                                schema=KC_SCHEMA, device="cpu",
                                stats=stats), stats


def _house_data(n: int = 60, seed: int = 1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, KC_SCHEMA.input_dim)).astype(np.float32)
    x[: n // 3, 3] = 0.95  # allowed features the clamp stops short
    y = rng.integers(0, 4, n)
    y[:4] = np.arange(4)
    return x, y


def _backends(bins=None, seed=0):
    x, y = _house_data()
    jeng, jstats = _house("jax")
    peng, pstats = _house("port")
    return (japps.HouseBackend(jeng, x, y, JAX_SCHEMA, jstats, bins, seed),
            apps.HouseBackend(peng, x, y, KC_SCHEMA, pstats, bins, seed))


def _assert_table_is_frame(table, df, stats):
    """Columns, rows in order, features equal; abs_delta (data space)
    within ATOL, the columns in the features' units within ATOL of each
    feature's range (the same bar in data space)."""
    assert table.columns == list(df.columns)
    assert len(table["data"]) == len(df)
    features = table.column("feature")
    assert features.tolist() == df["feature"].tolist()
    idx = [list(KC_SCHEMA.feature_names).index(f) for f in features]
    units = ATOL * np.asarray(stats.data_range, np.float64)[idx]
    for name in df.columns[1:]:
        got, want = table.column(name), df[name].to_numpy()
        err = np.abs(got.astype(np.float64) - want.astype(np.float64))
        bar = ATOL if name == "abs_delta" else units
        assert (err <= bar).all(), (name, err.max())


@pytest.mark.parametrize("source", [0, 1, 2, 3])
def test_house_show_sample_matches_jax(source):
    jb, pb = _backends(bins=[0, 2.5e5, 4.5e5, 6.5e5, 7.7e6])
    table, probs = pb.show_sample(source)
    df, jprobs = jb.show_sample(source)
    assert pb.current_idx == jb.current_idx
    assert probs == jprobs and probs.startswith("Classifier: Q0: ")
    _assert_table_is_frame(table, df, pb.stats)
    assert table.columns == ["feature", "value"]
    assert pb.class_overview() == jb.class_overview()


INSTRUCTIONS = ["only bedrooms, bathrooms and grade", "", "change everything",
                "the lot and the view", "make it cheaper",
                "bedrooms and the basement"]


@pytest.mark.parametrize("instruction", INSTRUCTIONS)
@pytest.mark.parametrize("source,target", [(0, 3), (2, 1)])
def test_house_generate_matches_jax_row_for_row(instruction, source, target):
    """Columns, values and the pandas row order, ties included (every
    masked-out feature has abs_delta exactly 0)."""
    jb, pb = _backends()
    pb.show_sample(source)
    jb.show_sample(source)
    table, verdict = pb.generate(target, instruction)
    df, jverdict = jb.generate(target, instruction)
    assert verdict == jverdict
    _assert_table_is_frame(table, df, pb.stats)
    assert table.columns == ["feature", "original", "counterfactual",
                             "change", "abs_delta"]
    delta = table.column("abs_delta")
    assert (np.diff(delta) <= 0).all()
    assert len(delta) - len(np.unique(delta)) >= 8  # ties are there
    frozen = set(KC_SCHEMA.immutable_features)
    assert all(d == 0 for f, d in zip(table.column("feature"), delta)
               if f in frozen)


def test_house_class_overview_without_bins():
    jb, pb = _backends()
    assert pb.class_overview() == jb.class_overview()


def test_house_table_order_is_pandas_not_a_stable_sort():
    """A vector with planted ties: the `Table`'s rows come in the order of
    pandas' `sort_values(ascending=False)`, which is not the order of a
    stable descending sort."""
    rng = np.random.default_rng(7)
    v = rng.choice(np.float32([0.0, 0.1, 0.05, 0.3]), 40).astype(np.float32)
    names = [f"f{i}" for i in range(len(v))]
    table = apps.Table({"feature": names, "abs_delta": v},
                       order=descending_order(v))
    df = pd.DataFrame({"feature": names, "abs_delta": v}).sort_values(
        "abs_delta", ascending=False)
    assert table.column("feature").tolist() == df["feature"].tolist()
    stable = [names[i] for i in np.argsort(-v, kind="stable")]
    assert stable != df["feature"].tolist()


def test_table_is_what_gradio_dataframe_takes():
    t = apps.Table({"feature": ["a", "b"], "value": np.float32([1.5, 2])})
    assert dict(t) == {"headers": ["feature", "value"],
                       "data": [["a", 1.5], ["b", 2.0]]}
    assert all(type(v) in (str, float) for row in t["data"] for v in row)


@pytest.fixture(scope="module")
def house_run():
    """Both packages' `setup_house` on the committed run dir."""
    jeng, jx, jy, _, jstats, jbins = jlaunch.setup_house(str(HOUSE_RUN))
    peng, x, y, schema, stats, bins = launch.setup_house(str(HOUSE_RUN),
                                                         device="cpu")
    assert np.array_equal(x, jx) and np.array_equal(y, jy)
    return (jeng, jstats, jbins), (peng, stats, bins), x, y


@pytest.mark.parametrize("source,target,instruction", [
    (0, 3, "only bedrooms, bathrooms and grade"),
    (2, 0, "the lot and the view"),
    (1, 3, "")])
def test_house_backend_on_the_committed_run_dir_matches_jax(
        house_run, source, target, instruction):
    """The smoke's house dialogue (and two more) on the trained weights:
    the same row, table and verdict as JAX's backend.  A feature outside
    the mask moves only where the clamp to [0, 1] moves a test value
    outside the training range, in both packages alike."""
    (jeng, jstats, jbins), (peng, stats, bins), x, y = house_run
    jb = japps.HouseBackend(jeng, x, y, JAX_SCHEMA, jstats, jbins)
    pb = apps.HouseBackend(peng, x, y, KC_SCHEMA, stats, bins)
    table, probs = pb.show_sample(source)
    df, jprobs = jb.show_sample(source)
    assert probs == jprobs and pb.current_idx == jb.current_idx
    _assert_table_is_frame(table, df, pb.stats)
    table, verdict = pb.generate(target, instruction)
    df, jverdict = jb.generate(target, instruction)
    assert verdict == jverdict
    _assert_table_is_frame(table, df, pb.stats)
    allowed = verdict.split("allowed features: ")[1].split(", ")
    x0 = x[pb.current_idx]
    names = list(KC_SCHEMA.feature_names)
    for f, d in zip(table.column("feature"), table.column("abs_delta")):
        if f not in allowed:
            i = names.index(f)
            assert d == np.float32(abs(np.clip(x0[i], 0, 1) - x0[i])), f
    assert pb.class_overview() == jb.class_overview()


# ------------------------------------------------------------------- moons
@pytest.fixture(scope="module")
def moons():
    jeng, jclf, xte, yte = jlaunch.setup_moons(str(MOONS_RUN))
    peng, pclf, pxte, pyte = launch.setup_moons(str(MOONS_RUN), device="cpu")
    assert np.array_equal(xte, pxte) and np.array_equal(yte, pyte)
    return jeng, jclf, peng, pclf, pxte, pyte


@pytest.mark.parametrize("source", [0, 1, 2])
def test_moons_show_sample_matches_jax(moons, monkeypatch, source):
    jeng, jclf, peng, pclf, x, y = moons
    jb = japps.MoonsBackend(jeng, jclf, x, y)
    pb = apps.MoonsBackend(peng, pclf, x, y)
    pfigs = capture_port(monkeypatch)
    path = pb.show_sample(source)
    jb.show_sample(source)
    assert pb.current_idx == jb.current_idx and y[pb.current_idx] == source
    (fig, saved), = pfigs.values()
    assert saved == path and read_png(path).shape == (600, 720, 3)
    star = fig.axes[0].scatters[1]
    assert (star["x"][0], star["y"][0]) == tuple(x[pb.current_idx])


@pytest.mark.parametrize("mask_choice", list(apps.MoonsBackend.MASK_ROWS))
@pytest.mark.parametrize("source,target", [(0, 1), (2, 0)])
def test_moons_generate_matches_jax(moons, monkeypatch, tmp_path,
                                    mask_choice, source, target):
    jeng, jclf, peng, pclf, x, y = moons
    assert apps.MoonsBackend.MASK_ROWS == japps.MoonsBackend.MASK_ROWS
    jb = japps.MoonsBackend(jeng, jclf, x, y)
    pb = apps.MoonsBackend(peng, pclf, x, y)
    pb.show_sample(source)
    jb.show_sample(source)
    pfigs = capture_port(monkeypatch)
    mfigs = capture_mpl(monkeypatch)
    path, res, verdict = pb.generate(target, mask_choice)
    jpath, jres, jverdict = jb.generate(target, mask_choice)
    assert verdict == jverdict
    for name in ("x_cf", "residual", "probs", "probs_orig", "confidence"):
        np.testing.assert_allclose(getattr(res, name),
                                   np.asarray(getattr(jres, name)),
                                   atol=ATOL, rtol=0, err_msg=name)
    for name in ("pred", "flipped"):
        np.testing.assert_array_equal(getattr(res, name),
                                      np.asarray(getattr(jres, name)))
    x0 = x[pb.current_idx]
    keep = {"none": (0, 1), "x_only": (1,), "y_only": (0,), "both": ()}
    for i in keep[mask_choice]:
        assert res.x_cf[0, i] == x0[i]
    # the arrow plot: the JAX figure's content on the port's raster
    fig, saved = pfigs[os.path.basename(path)]
    mfig = mfigs[os.path.basename(jpath)]
    ax, max_ = fig.axes[0], mfig.axes[0]
    assert (fig.figsize, fig.dpi) == ((5.0, 4.0), 120.0)
    assert read_png(saved).shape == (480, 600, 3)
    assert_titles(ax, max_)
    assert ax.title == f"pred {res.pred[0]} ({res.confidence[0]:.2f})"
    (sc,), (msc,) = ax.scatters, max_.collections
    np.testing.assert_array_equal(np.stack([sc["x"], sc["y"]], 1),
                                  msc.get_offsets())
    np.testing.assert_array_equal(sc["facecolors"], msc.get_facecolors())
    assert sc["s"] == msc.get_sizes()[0] == 6
    (arrow,), (marrow,) = ax.arrows, max_.texts
    np.testing.assert_array_equal(arrow["start"], marrow.xyann)
    np.testing.assert_allclose(arrow["end"], marrow.xy, atol=ATOL)
    assert arrow["color"] == mcolors.to_rgba(
        marrow.arrow_patch.get_edgecolor())
    assert arrow["linewidth"] == marrow.arrow_patch.get_linewidth() == 2


# ----------------------------------------------------------- gradio builds
class _Stub:
    """A gradio component, or the Blocks context; records the callbacks
    bound to it and the app's launch."""

    blocks = []

    def __init__(self, *a, **k):
        self.bindings = []
        self.launched = None

    def __enter__(self):
        _Stub.blocks.append(self)
        return self

    def __exit__(self, *a):
        return False

    def _bind(self, fn, inputs, outputs):
        _Stub.blocks[-1].bindings.append((fn, inputs, outputs))

    click = submit = _bind

    def launch(self, **kw):
        self.launched = kw


@pytest.fixture
def stub_gradio(monkeypatch):
    gr = types.ModuleType("gradio")
    for name in ("Blocks", "Markdown", "Chatbot", "Image", "Textbox",
                 "Dropdown", "Button", "Dataframe", "Radio"):
        setattr(gr, name, _Stub)
    monkeypatch.setitem(sys.modules, "gradio", gr)
    monkeypatch.setattr(_Stub, "blocks", [])
    return gr


def test_build_apps_bind_the_backends_with_stub_gradio(stub_gradio, mnist,
                                                       moons):
    _, peng, x, y = mnist
    demo = apps.build_mnist_app(peng, x, y, patch_size=7)
    (respond, inputs, outputs), = demo.bindings
    assert len(inputs) == 2 and len(outputs) == 3
    history, image, box = respond("show me a 4", None)
    assert box == "" and image.endswith(".png") and len(history) == 1
    history, image, _ = respond("turn it into a 9 using patches 5, 6",
                                history)
    assert "classifier says" in history[-1][1] and image.endswith(".png")

    _, _, meng, mclf, mx, my = moons
    demo = apps.build_moons_app(meng, mclf, mx, my)
    (show, _, _), (gen, ins, outs) = demo.bindings
    assert show(1).endswith(".png")
    out, verdict = gen(2, "both")
    assert out.endswith(".png") and verdict in ("flip succeeded", "no flip")
    assert len(ins) == len(outs) == 2

    heng, stats = _house("port")
    hx, hy = _house_data()
    demo = apps.build_house_app(heng, hx, hy, KC_SCHEMA, stats)
    (show, _, _), (gen, _, _) = demo.bindings
    table, probs = show(0)
    assert len(table["data"]) == KC_SCHEMA.input_dim and "Q3" in probs
    table, verdict = gen(3, "change the bedrooms")
    assert "abs_delta" in table["headers"] and "bedrooms" in verdict


@pytest.mark.parametrize("builder,n_args", [("build_mnist_app", 3),
                                            ("build_house_app", 5),
                                            ("build_moons_app", 4)])
def test_build_apps_raise_a_clear_import_error_without_gradio(monkeypatch,
                                                              builder,
                                                              n_args):
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError, match="gradio is not installed"):
        getattr(apps, builder)(*[None] * n_args)


def test_gradio_and_providers_are_imported_only_inside_functions():
    """At module level the apps and the intent parser import nothing the
    card's machine may lack."""
    optional = {"gradio", "openai", "google"}
    for mod in (apps, launch, __import__("cfgan_torch.serve.intent",
                                         fromlist=["x"])):
        tree = ast.parse(Path(mod.__file__).read_text())
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else [node.module])
                assert not {n.split(".")[0] for n in names} & optional


def _fixture_env(monkeypatch):
    monkeypatch.setenv("CFGAN_DATA_DIR",
                       str(ROOT / "tests" / "fixtures" / "mnist_idx"))


@pytest.fixture
def keep_tf32(monkeypatch):
    for mod in (torch.backends.cudnn, torch.backends.cuda.matmul):
        monkeypatch.setattr(mod, "allow_tf32", mod.allow_tf32)


@pytest.mark.parametrize("app,run_dir", [
    ("moons", "results/moons_countergan"),
    ("house", "results/house_countergan"),
    ("mnist", "results/mnist_countergan_seed43")])
def test_main_without_api_launches_the_app(stub_gradio, monkeypatch,
                                           keep_tf32, app, run_dir):
    """`main` without `--api` builds the family's app on the run dir and
    launches it with the host as `server_name` and `--share`."""
    from cfgan_torch.serve import api as papi

    _fixture_env(monkeypatch)
    monkeypatch.setattr(papi, "serve", lambda *a: pytest.fail("served"))
    launch.main(["--app", app, "--results", str(ROOT / run_dir),
                 "--device", "cpu", "--host", "127.0.0.2", "--share"])
    demo, = _Stub.blocks
    assert demo.launched == {"server_name": "127.0.0.2", "share": True}
    assert len(demo.bindings) == (1 if app == "mnist" else 2)
    launch.main(["--app", app, "--results", str(ROOT / run_dir),
                 "--device", "cpu"])
    assert _Stub.blocks[1].launched == {"server_name": "127.0.0.1",
                                        "share": False}


@pytest.mark.parametrize("fn", ["launch_mnist", "launch_house",
                                "launch_moons"])
def test_launchers_raise_without_gradio_before_loading(monkeypatch, fn):
    monkeypatch.setitem(sys.modules, "gradio", None)
    for name in launch.SETUPS:
        monkeypatch.setitem(launch.SETUPS, name, None)
    with pytest.raises(ImportError, match="gradio is not installed"):
        getattr(launch, fn)("no/such/dir", device="cpu")


def test_main_without_gradio_exits_nonzero_in_a_subprocess(tmp_path):
    """As the smoke runs it: `python -m cfgan_torch.serve.launch --app
    moons` with no gradio to import exits 1 with the ImportError's
    message, and never serves the API."""
    shim = tmp_path / "shim"
    shim.mkdir()
    (shim / "gradio.py").write_text("raise ImportError('no gradio here')\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("GEMINI_API_KEY", "GOOGLE_API_KEY", "OPENAI_API_KEY")}
    env["PYTHONPATH"] = os.pathsep.join([str(shim), str(ROOT)])
    proc = subprocess.run(
        [sys.executable, "-m", "cfgan_torch.serve.launch", "--app", "moons",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 1
    assert "gradio is not installed" in proc.stderr
    assert "listening" not in proc.stdout + proc.stderr
