"""The port's raster (`cfgan_torch.eval.figure`) against matplotlib, PIL
and imageio, on the CPU: the colour tables at all 256 entries, the value
mapping (`ScalarMappable(Normalize(vmin, vmax), cmap).to_rgba(...,
bytes=True)`), the default line colours, the committed font against
`tools/make_figure_tables.py` rendering it again, the PNG reader, the
GIF writer against imageio's `mimsave` (PIL decodes the port's GIF to
its frames, with the duration and loop PIL reads from imageio's GIF of
the same frames; imageio's own GIF of frames whose colours change from
frame to frame does not decode to them), canvas sizes, and each image
panel drawn as constant blocks of its mapped colour.

The helpers at the end (`capture_mpl`, `capture_port`, `panels`,
`assert_image_panel`, ...) read a matplotlib figure and a port figure
back for the parity tests of tests/test_torch_eval_images.py and
tests/test_torch_plots.py.
"""
import importlib.util
import io
import os
from pathlib import Path

import imageio.v2 as imageio
import matplotlib
import numpy as np
import pytest
from PIL import Image

matplotlib.use("Agg")
import matplotlib.colors as mcolors  # noqa: E402
import matplotlib.figure as mfigure  # noqa: E402
from matplotlib.backends.backend_agg import FigureCanvasAgg  # noqa: E402
from matplotlib.cm import ScalarMappable  # noqa: E402

from cfgan_torch.eval import figure as F  # noqa: E402
from cfgan_torch.eval.samples import png_bytes, write_png  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CMAPS = ["gray", "seismic", "viridis", "Blues"]


# ------------------------------------------------------------ colours
@pytest.mark.parametrize("name", CMAPS)
def test_colour_table_equals_matplotlib(name):
    want = matplotlib.colormaps[name](np.arange(256))
    got = F.get_cmap(name).lut
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        F.get_cmap(name)(np.arange(256) / 256, bytes=True),
        matplotlib.colormaps[name](np.arange(256) / 256, bytes=True))


def _values(kind):
    rng = np.random.RandomState(0)
    if kind == "float32_bounds":  # under, over, on the bounds, NaN
        v = rng.uniform(-1.3, 1.3, (37, 29)).astype(np.float32)
        v.flat[:6] = [-1, 1, 0, np.nan, -1.3, 1.3]
        return v, -1, 1
    if kind == "float32_unit":
        v = rng.uniform(0, 1, (28, 28)).astype(np.float32)
        v.flat[:3] = [0, 1, 0.5]
        return v, 0, 1
    if kind == "float32_auto":
        return rng.uniform(0.1, 0.7, (17, 3)).astype(np.float32), None, None
    if kind == "float64_auto":
        return rng.uniform(0, 0.4, (17, 3)), None, None
    if kind == "int64_auto":  # a confusion matrix
        return rng.randint(0, 500, (10, 10)).astype(np.int64), None, None
    if kind == "constant":
        return np.full((4, 4), 0.3, np.float32), None, None
    raise ValueError(kind)


@pytest.mark.parametrize("cmap", CMAPS)
@pytest.mark.parametrize("kind", ["float32_bounds", "float32_unit",
                                  "float32_auto", "float64_auto",
                                  "int64_auto", "constant"])
def test_value_mapping_equals_matplotlib(kind, cmap):
    v, vmin, vmax = _values(kind)
    sm = ScalarMappable(mcolors.Normalize(vmin, vmax), cmap)
    want = sm.to_rgba(v, bytes=True)
    np.testing.assert_array_equal(F.map_colors(v, cmap, vmin, vmax), want)
    norm = F.normalize(v, vmin, vmax)
    mnorm = mcolors.Normalize(vmin, vmax)(v)
    assert norm.dtype == mnorm.dtype
    np.testing.assert_array_equal(norm, np.ma.getdata(mnorm))


@pytest.mark.parametrize("color", [f"C{i}" for i in range(10)]
                         + list(F.NAMED) + [(0, 1, 0, 0.25), (0.2, 0.4, 1)])
def test_colours_equal_matplotlib(color):
    assert F.to_rgba(color) == mcolors.to_rgba(color)
    assert F.to_rgba(color, 0.35) == mcolors.to_rgba(color, 0.35)


def test_scatter_colours_by_number_equal_matplotlib():
    """`c=labels`: normalized over the labels' min and max, then the
    alpha, as `get_facecolors()` after a draw."""
    labels = np.array([0, 2, 1, 1, 0])
    fig = mfigure.Figure()
    sc = fig.subplots().scatter(np.arange(5), np.arange(5), c=labels,
                                cmap="viridis", alpha=0.35)
    FigureCanvasAgg(fig).draw()
    ax = F.Figure().subplots()[0, 0]
    got = ax.scatter(np.arange(5), np.arange(5), c=labels, alpha=0.35)
    np.testing.assert_array_equal(got["facecolors"], sc.get_facecolors())


# --------------------------------------------------------------- font
def _tables_tool():
    spec = importlib.util.spec_from_file_location(
        "make_figure_tables", ROOT / "tools" / "make_figure_tables.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_committed_tables_equal_a_fresh_render():
    """The font (and the two colour tables) rendered again from this
    host's matplotlib equal the committed `figure_tables.npz`."""
    fresh = _tables_tool().build()
    with np.load(F.TABLES) as committed:
        assert sorted(committed.files) == sorted(fresh)
        for k in fresh:
            np.testing.assert_array_equal(committed[k], fresh[k], err_msg=k)


@pytest.mark.parametrize("px", F.FONT_SIZES)
def test_text_is_set_from_the_glyphs(px):
    cov, base = F.text_alpha("Ag", px)
    t = F._tables()
    cells = t[f"font{px}_alpha"]
    assert cov.shape[0] == cells.shape[1] and 0 < base < cov.shape[0]
    left = int(t[f"font{px}_metrics"][2])
    a = cells[ord("A") - 32].astype(np.float32) / 255
    # the first glyph lands at the pen as drawn (nothing before it)
    np.testing.assert_array_equal(cov[:, left:left + a.shape[1] - left],
                                  np.maximum(a[:, left:], cov[
                                      :, left:left + a.shape[1] - left]))
    assert cov.max() == 1.0 and F.text_alpha("", px)[0].shape[1] >= 1


# --------------------------------------------------------------- PNG
@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 3), (3, 4, 4)])
def test_read_png_reads_the_ports_png(shape, tmp_path):
    px = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    write_png(str(tmp_path / "a.png"), px)
    np.testing.assert_array_equal(F.read_png(tmp_path / "a.png"), px)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(
        png_bytes(px)))), px)


def test_read_png_refuses_other_pngs(tmp_path):
    """A PNG with filtered rows (PIL's), one with a bad CRC and a file that
    is no PNG raise with a clear message."""
    px = np.tile(np.arange(64, dtype=np.uint8), (16, 1))
    Image.fromarray(px).save(tmp_path / "pil.png", optimize=True)
    with pytest.raises(ValueError, match="unfiltered"):
        F.read_png(tmp_path / "pil.png")
    bad = bytearray(png_bytes(px))
    bad[-20] ^= 1  # a bit of IDAT
    (tmp_path / "crc.png").write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="CRC"):
        F.read_png(tmp_path / "crc.png")
    (tmp_path / "x.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        F.read_png(tmp_path / "x.png")


# --------------------------------------------------------------- GIF
def _frames(kind):
    rng = np.random.RandomState(1)
    if kind == "grids":  # what the generation presets write: uint8 grids
        base = rng.randint(0, 256, (62, 62)).astype(np.uint8)
        return [np.clip(base.astype(int) + 7 * i, 0, 255).astype(np.uint8)
                for i in range(4)]
    if kind == "noise":  # every code used: the table fills and clears
        return [rng.randint(0, 256, (120, 130)).astype(np.uint8)
                for _ in range(3)]
    if kind == "two_levels":
        return [(rng.rand(9, 11) > 0.5).astype(np.uint8) * 255
                for _ in range(2)]
    if kind == "one_colour":
        return [np.full((4, 6), 17, np.uint8)]
    raise ValueError(kind)


def _decoded(path):
    im = Image.open(path)
    frames = []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append((np.asarray(im.convert("L")), im.info.get("duration"),
                       im.info.get("loop")))
    return frames


@pytest.mark.parametrize("fps", [5, 3])
@pytest.mark.parametrize("kind", ["grids", "noise", "two_levels",
                                  "one_colour"])
def test_gif_decodes_to_its_frames_as_imageios(kind, fps, tmp_path):
    frames = _frames(kind)
    F.write_gif(str(tmp_path / "port.gif"), frames, fps=fps)
    imageio.mimsave(str(tmp_path / "imageio.gif"), frames, fps=fps)
    got, want = (_decoded(tmp_path / f"{n}.gif") for n in ("port",
                                                             "imageio"))
    assert len(got) == len(want) == len(frames)
    for (g, dur, loop), (_, wdur, wloop), f in zip(got, want, frames):
        np.testing.assert_array_equal(g, f)
        assert (dur, loop) == (wdur, wloop)


def test_gif_refuses_what_it_cannot_write(tmp_path):
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)
    with pytest.raises(ValueError, match="256"):
        F.write_gif(str(tmp_path / "a.gif"), [rgb])
    with pytest.raises(ValueError, match="one size"):
        F.write_gif(str(tmp_path / "a.gif"), [rgb[..., 0], rgb[:8, :8, 0]])


# ------------------------------------------------------------ figures
@pytest.mark.parametrize("figsize,dpi", [((11.000000000000002, 11.0), 120),
                                         ((10, 2.8), 120), ((9.6, 3.8), 120),
                                         ((8, 6), 100), ((7, 4.8), 120)])
def test_canvas_is_matplotlibs_png_size(figsize, dpi, tmp_path):
    fig = mfigure.Figure(figsize=figsize)
    fig.savefig(tmp_path / "m.png", dpi=dpi)
    ours = F.Figure(figsize, dpi)
    ours.subplots()[0, 0].plot([0, 1])
    ours.save(str(tmp_path / "p.png"))
    size = Image.open(tmp_path / "m.png").size
    assert (ours.width, ours.height) == size
    assert Image.open(tmp_path / "p.png").size == size


def test_saved_png_decodes_to_render(tmp_path):
    fig = F.Figure((6, 5), 120)
    ax = fig.subplots()[0, 0]
    ax.scatter([0, 1, 2], [1, 0, 2], c=[0, 1, 2], s=6, alpha=0.35)
    ax.arrow((0, 1), (1, 0), color="red", linewidth=1.2)
    ax.set_title("t")
    ax.legend()
    fig.save(str(tmp_path / "a.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")),
                                  fig.render())


@pytest.mark.parametrize("aspect,shape", [("equal", (28, 28)),
                                          ("equal", (14, 9)),
                                          ("auto", (17, 3))])
def test_image_panels_are_constant_blocks_of_their_colour(aspect, shape):
    data = np.random.RandomState(0).uniform(-1, 1, shape).astype(np.float32)
    fig = F.Figure((10, 2.8), 120)
    axes = fig.subplots(1, 2)[0]
    ims = [axes[0].imshow(data, "seismic", -1, 1, aspect=aspect),
           axes[1].imshow(data, "viridis", aspect=aspect)]
    axes[0].axis_off()
    axes[1].add_colorbar(ims[1])
    px = fig.render()
    for im in ims:
        assert_blocks(px, im)


def assert_blocks(px: np.ndarray, im: dict) -> None:
    """The rendered cells of image `im` are constant blocks of its mapped
    colour."""
    x0, y0, sx, sy = im["placed"]
    h, w = im["data"].shape
    assert sx >= 1 and sy >= 1
    cells = px[y0:y0 + h * sy, x0:x0 + w * sx].reshape(h, sy, w, sx, 3)
    want = F.map_colors(im["data"], im["cmap"], im["vmin"], im["vmax"])
    np.testing.assert_array_equal(
        cells, np.broadcast_to(want[:, None, :, None, :3], cells.shape))


# ------------------------------------------- reading figures back (shared)
def capture_mpl(monkeypatch) -> dict:
    """{file name: matplotlib Figure} of every figure saved while the
    patch holds (`savefig` records the figure, then saves it)."""
    saved = {}
    orig = mfigure.Figure.savefig

    def spy(self, fname, *args, **kwargs):
        out = orig(self, fname, *args, **kwargs)
        saved[os.path.basename(str(fname))] = self
        return out

    monkeypatch.setattr(mfigure.Figure, "savefig", spy)
    return saved


def capture_port(monkeypatch) -> dict:
    """{file name: port Figure} of every figure the raster saves."""
    saved = {}
    orig = F.Figure.save

    def spy(self, path):
        out = orig(self, path)
        saved[os.path.basename(str(path))] = (self, path)
        return out

    monkeypatch.setattr(F.Figure, "save", spy)
    return saved


def panels(fig: mfigure.Figure) -> list:
    """A matplotlib figure's axes, colorbars left out."""
    return [ax for ax in fig.axes if not hasattr(ax, "_colorbar")]


def colorbars(fig: mfigure.Figure) -> int:
    return sum(hasattr(ax, "_colorbar") for ax in fig.axes)


def assert_saved_as_rendered(port_fig, path) -> None:
    """The PNG decodes (PIL) to `render()`."""
    np.testing.assert_array_equal(np.asarray(Image.open(path)),
                                  port_fig.render())


def assert_same_size(port_fig, jax_png) -> None:
    assert (port_fig.width, port_fig.height) == Image.open(jax_png).size


def assert_image_panel(im: dict, mpl_im, atol: float = 0.0) -> None:
    """The port's image `im` against a matplotlib `AxesImage`: its data
    within `atol`, its colour map and bounds, and its mapped bytes equal
    `to_rgba(mpl data, bytes=True)` at every pixel where the two data
    agree (a value within `atol` may fall into the next colour)."""
    want = np.ma.getdata(mpl_im.get_array())
    got = np.asarray(im["data"])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    assert mpl_im.get_cmap().name == im["cmap"]
    lo = got.min() if im["vmin"] is None else im["vmin"]
    hi = got.max() if im["vmax"] is None else im["vmax"]
    np.testing.assert_allclose([lo, hi], [mpl_im.norm.vmin, mpl_im.norm.vmax],
                               atol=atol, rtol=0)
    mapped = F.map_colors(got, im["cmap"], im["vmin"], im["vmax"])
    ref = mpl_im.to_rgba(want, bytes=True)
    np.testing.assert_array_equal(
        F.map_colors(want, im["cmap"], im["vmin"], im["vmax"])
        if im["vmin"] is not None else F.map_colors(
            want, im["cmap"], mpl_im.norm.vmin, mpl_im.norm.vmax), ref)
    differs = (mapped != ref).any(axis=-1)
    assert not (differs & (got == want)).any()


def assert_titles(ax, mpl_ax) -> None:
    assert ax.title == mpl_ax.get_title()
    assert ax.xlabel == mpl_ax.get_xlabel()
    assert ax.ylabel == mpl_ax.get_ylabel()


def assert_lines(ax, mpl_ax, atol: float = 0.0) -> None:
    """Line data, labels, styles, markers and colours; the legend's
    texts."""
    assert len(ax.lines) == len(mpl_ax.lines)
    for ln, ml in zip(ax.lines, mpl_ax.lines):
        np.testing.assert_allclose(ln["x"], ml.get_xdata(), atol=atol,
                                   rtol=0)
        np.testing.assert_allclose(ln["y"], ml.get_ydata(), atol=atol,
                                   rtol=0)
        assert ln["linestyle"] == ml.get_linestyle()
        assert (ln["marker"] or "None") == ml.get_marker()
        assert ln["color"] == mcolors.to_rgba(ml.get_color())
        assert (ln["label"] or ml.get_label()) == ml.get_label()
    legend = mpl_ax.get_legend()
    texts = [t.get_text() for t in legend.get_texts()] if legend else []
    got = [e["label"] for e in ax.legend_entries()] if ax.legend_on else []
    assert got == texts


# ------------------------------------------------- run dirs' figure sets
def figure_set(run_dir) -> set:
    """The PNG and GIF files under `run_dir`, relative, '/'-joined."""
    run_dir = Path(run_dir)
    return {p.relative_to(run_dir).as_posix() for p in run_dir.rglob("*")
            if p.suffix in (".png", ".gif")}


def jax_figure_set(name: str) -> set:
    """The figures of the committed JAX run dir `results/<name>/`."""
    return figure_set(ROOT / "results" / name)


TRAINED_ONLY = {"mnist_countergan_seed43": {"classifier_training_curves.png",
                                            "gan_losses.png"},
                "moons_countergan": {"loss_curves.png"},
                "house_countergan": {"classifier_training_curves.png",
                                     "loss_curves.png"}}


def test_committed_run_dirs_hold_the_figure_sets():
    """The sets the port's run dirs are held to (each experiment's test
    file compares its run dir with the committed JAX one)."""
    mnist = {"cf_grid.png", "classifier_eval/confusion_matrix.png",
             "classifier_training_curves.png", "gan_losses.png",
             "patch_budget_curve.png", "patch_grid.png",
             "user_modification_example.png",
             "eval_visuals/batch_overview.png",
             *(f"eval_visuals/sample_{i}.png" for i in range(8))}
    moons = {"classifier_eval/confusion_matrix.png",
             "decision_boundaries.png", "loss_curves.png",
             *(f"boundaries/decision_boundaries_cfs_src{s}_tgt{t}.png"
               for s in range(3) for t in range(3) if s != t)}
    house = {"classifier_eval/confusion_matrix.png",
             "classifier_training_curves.png", "feature_shift_importance.png",
             "loss_curves.png", "mask_policy_analysis.png",
             *(f"class_pair_sensitivity/src{s}.png" for s in range(4))}
    assert jax_figure_set("mnist_countergan_seed43") == mnist
    assert jax_figure_set("moons_countergan") == moons
    assert jax_figure_set("house_countergan") == house
    for name in ("dcgan_mnist", "wgan_gp_mnist", "simple_gan_mnist"):
        assert jax_figure_set(name) == {"loss.png", "samples.png",
                                        "real_samples.png",
                                        "training_animation.gif"}
    for name in ("simple_gan_moons", "cgan_moons"):
        assert jax_figure_set(name) == {"loss.png", "generated.png"}
