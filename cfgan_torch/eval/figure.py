"""A small raster for the port's figures, in numpy alone: the card's host
has no matplotlib, PIL or imageio.

A `Figure` of a fixed pixel size holds `Axes` panels, and each panel keeps
what it shows as data (images, lines, bars, scatter points, arrows,
rectangles, texts, titles and labels, a legend, a colorbar, spines), so
that a test can read a figure back.  `render()` draws it into an (H, W, 3)
uint8 array and `save(path)` writes that as a PNG (`samples.png_bytes`).

The colour maps map values as matplotlib does: `normalize` is its
`Normalize(vmin, vmax)` (float64 bounds, each step rounded to the
data's float type where the data is float32), and `Colormap.__call__` takes
`int(v * 256)` clipped to [0, 255] (NaN to transparent black), with
`bytes=True` giving `(lut * 255).astype(uint8)`.  `gray` and `seismic` are
computed from their segments; `viridis`, `Blues` and the font come from
`figure_tables.npz`, which `tools/make_figure_tables.py` renders from
matplotlib once.  The font is DejaVu Sans (Bitstream Vera licence) at 12
and 15 pixels.

Layout, ticks and line drawing are the port's own; they do not reproduce
matplotlib's pixels.  Images are scaled by whole pixels (nearest
neighbour), so each value is a constant block of its colour.

`write_gif` writes a GIF89a (global palette, LZW with clear codes, the
frame delay and no loop extension) as imageio's `mimsave(path, frames,
fps=fps)` does for gray frames; `read_png` reads the port's own
unfiltered PNGs back.
"""
from __future__ import annotations

import math
import os
import struct
import zlib
from functools import lru_cache
from pathlib import Path

import numpy as np

from cfgan_torch.eval.samples import write_png

TABLES = Path(__file__).resolve().parent / "figure_tables.npz"
FONT_SIZES = (12, 15)
N = 256  # entries of a colour map

# matplotlib's default colour cycle (C0-C9, `tab10`) and the named colours
# the figures use (CSS4 values, as matplotlib's `to_rgba` gives them)
TAB10 = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b",
         "#e377c2", "#7f7f7f", "#bcbd22", "#17becf")
NAMED = {"black": "#000000", "white": "#ffffff", "red": "#ff0000",
         "green": "#008000", "yellow": "#ffff00", "gray": "#808080"}
# seismic's colours, equally spaced over [0, 1] (matplotlib `_cm.py`)
SEISMIC = ((0.0, 0.0, 0.3), (0.0, 0.0, 1.0), (1.0, 1.0, 1.0),
           (1.0, 0.0, 0.0), (0.5, 0.0, 0.0))


def to_rgba(color, alpha: float | None = None) -> tuple:
    """A colour (a name, 'C0'-'C9', '#rrggbb', or an RGB(A) tuple of
    floats) as an RGBA tuple of floats; `alpha` replaces its alpha."""
    if isinstance(color, str):
        if color[:1] == "C" and color[1:].isdigit():
            color = TAB10[int(color[1:]) % len(TAB10)]
        color = NAMED.get(color, color)
        if not (color.startswith("#") and len(color) == 7):
            raise ValueError(f"unknown colour {color!r}")
        rgba = tuple(int(color[i:i + 2], 16) / 255 for i in (1, 3, 5)) + (
            1.0,)
    else:
        rgba = tuple(float(c) for c in color)
        if len(rgba) == 3:
            rgba += (1.0,)
        if len(rgba) != 4:
            raise ValueError(f"unknown colour {color!r}")
    if alpha is not None:
        rgba = rgba[:3] + (float(alpha),)
    return rgba


def _lookup_table(points) -> np.ndarray:
    """matplotlib's `_create_lookup_table(256, points)` for (x, y0, y1)
    rows with gamma 1."""
    a = np.asarray(points, np.float64)
    x, y0, y1 = a[:, 0] * (N - 1), a[:, 1], a[:, 2]
    xind = (N - 1) * np.linspace(0, 1, N)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1])
                          + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def _segmented(colors) -> np.ndarray:
    """`LinearSegmentedColormap.from_list`'s table of equally spaced RGB
    colours."""
    vals = np.linspace(0, 1, len(colors))
    rgb = np.asarray(colors, np.float64)
    chans = [_lookup_table(np.column_stack([vals, c, c])) for c in rgb.T]
    return np.stack(chans + [np.ones(N)], axis=1)


@lru_cache(maxsize=1)
def _tables() -> dict:
    with np.load(TABLES) as t:
        return {k: t[k] for k in t.files}


class Colormap:
    """A 256-entry colour map that maps normalized values as matplotlib's
    `Colormap.__call__` does."""

    def __init__(self, lut: np.ndarray):
        self.lut = np.asarray(lut, np.float64)

    def __call__(self, values, alpha: float | None = None,
                 bytes: bool = False) -> np.ndarray:
        xa = np.array(values, copy=True)
        if xa.dtype.kind == "f":
            xa *= N
            xa[xa == N] = N - 1
        under, over, bad = xa < 0, xa >= N, np.isnan(xa)
        with np.errstate(invalid="ignore"):
            xa = xa.astype(int)
        xa[under], xa[over] = 0, N - 1
        lut = (self.lut * 255).astype(np.uint8) if bytes else self.lut
        rgba = lut.take(np.where(bad, 0, xa), axis=0)
        if alpha is not None:
            rgba[..., 3] = alpha * 255 if bytes else alpha
        rgba[bad] = 0
        return rgba


@lru_cache(maxsize=None)
def get_cmap(name: str) -> Colormap:
    """'gray', 'seismic', 'viridis' or 'Blues'."""
    if name == "gray":
        ramp = _lookup_table([(0.0, 0.0, 0.0), (1.0, 1.0, 1.0)])
        return Colormap(np.stack([ramp, ramp, ramp, np.ones(N)], 1))
    if name == "seismic":
        return Colormap(_segmented(SEISMIC))
    if name in ("viridis", "Blues"):
        return Colormap(_tables()[name])
    raise ValueError(f"unknown colour map {name!r}")


def _float_type(a: np.ndarray):
    """The float type matplotlib's `Normalize.process_value` gives `a`."""
    if a.dtype.kind == "f":
        return a.dtype
    return np.promote_types(a.dtype, np.float32)


def normalize(data, vmin=None, vmax=None) -> np.ndarray:
    """matplotlib's `Normalize(vmin, vmax)(data)`, unclipped; a missing
    bound is the data's min or max."""
    a = np.asarray(data)
    ft = _float_type(a)
    res = a.astype(ft)
    # matplotlib keeps its bounds as Python floats: float64 arithmetic,
    # rounded to float32 data's type in place
    lo = np.float64(res.min() if vmin is None else vmin)
    hi = np.float64(res.max() if vmax is None else vmax)
    if lo == hi:
        return np.zeros_like(res)
    if lo > hi:
        raise ValueError("vmin must be less than or equal to vmax")
    res = np.subtract(res, lo, out=res, casting="same_kind")
    return np.divide(res, hi - lo, out=res, casting="same_kind")


def map_colors(data, cmap: str, vmin=None, vmax=None) -> np.ndarray:
    """uint8 RGBA of `data` through `cmap` after `normalize(data, vmin,
    vmax)`: matplotlib's `ScalarMappable(norm, cmap).to_rgba(data,
    bytes=True)`."""
    return get_cmap(cmap)(normalize(data, vmin, vmax), bytes=True)


# --------------------------------------------------------------- text
def _font_px(fontsize: float, dpi: float) -> int:
    px = fontsize * dpi / 72
    return min(FONT_SIZES, key=lambda s: abs(s - px))


def text_alpha(s: str, px: int) -> tuple[np.ndarray, int]:
    """(coverage (rows, cols) float32 in [0, 1], baseline row) of `s` set
    in the committed font at `px` pixels.  Characters outside printable
    ASCII are drawn as '?'."""
    t = _tables()
    cells = t[f"font{px}_alpha"]
    adv = t[f"font{px}_advance"]
    ascent, descent, left = (int(v) for v in t[f"font{px}_metrics"])
    idx = [ord(c) - 32 if 32 <= ord(c) < 127 else ord("?") - 32 for c in s]
    pens = np.concatenate([[0], np.cumsum([adv[i] for i in idx])])
    width = max(int(pens[-1]) + cells.shape[2], 1)
    out = np.zeros((cells.shape[1], width + left), np.float32)
    for i, pen in zip(idx, pens[:-1]):  # the font blit
        region = out[:, pen:pen + cells.shape[2]]
        np.maximum(region, cells[i] / np.float32(255), out=region)
    return out[:, :max(int(pens[-1]) + left, 1)], ascent


# --------------------------------------------------------------- axes
class Axes:
    """One panel.  Its lists hold what it draws, in data coordinates
    (image panels: x is the column and y the row of the image, as
    matplotlib's `imshow` places them)."""

    def __init__(self, fig: "Figure"):
        self.fig = fig
        self.images: list[dict] = []
        self.surfaces: list[dict] = []
        self.lines: list[dict] = []
        self.bars: list[dict] = []
        self.scatters: list[dict] = []
        self.arrows: list[dict] = []
        self.rects: list[dict] = []
        self.texts: list[dict] = []
        self.title = ""
        self.title_size = 12.0
        self.xlabel = ""
        self.ylabel = ""
        self.ylabel_rotation = 90
        self.legend_on = False
        self.colorbar: dict | None = None
        self.axis_on = True
        self.spines = {"color": to_rgba("black"), "width": 0.8}
        self.ylim: tuple | None = None
        self.xticks: tuple | None = None  # (positions, labels)
        self.yticks: tuple | None = None
        self.tick_size = 10.0
        self._line_cycle = 0
        self._patch_cycle = 0

    # -- what the panel shows
    def imshow(self, data, cmap: str = "viridis", vmin=None, vmax=None,
               aspect: str = "equal") -> dict:
        """An image, row 0 on top, through `cmap` with `normalize`'s
        bounds (the data's min and max where not given).  `render()`
        records where it went: `placed` = (x, y, pixels a cell across,
        pixels a cell down)."""
        a = np.asarray(data)
        if a.ndim != 2:
            raise ValueError(f"imshow takes a 2-D array, not {a.shape}")
        im = {"data": a, "cmap": cmap, "vmin": vmin, "vmax": vmax,
              "aspect": aspect}
        self.images.append(im)
        return im

    def surface(self, xs, ys, classes, cmap: str, alpha: float,
                levels) -> dict:
        """A class image over the grid `xs` x `ys` (rows along y), each
        class c coloured as `contourf(..., levels=levels)` colours the band
        about it: `cmap` of c normalized over the levels' min and max."""
        im = {"xs": np.asarray(xs), "ys": np.asarray(ys),
              "classes": np.asarray(classes), "cmap": cmap, "alpha": alpha,
              "levels": np.asarray(levels, np.float64)}
        self.surfaces.append(im)
        return im

    def plot(self, x, y=None, label: str | None = None,
             linestyle: str = "-", color=None, marker: str | None = None,
             linewidth: float = 1.5) -> dict:
        """A line; `plot(y)` draws y against 0, 1, ...  The colour is the
        next of C0-C9 unless given."""
        if y is None:
            y = x
            x = np.arange(len(np.asarray(y)))
        if color is None:
            color = f"C{self._line_cycle % 10}"
            self._line_cycle += 1
        line = {"x": np.asarray(x, np.float64), "y": np.asarray(y,
                                                               np.float64),
                "label": label, "linestyle": linestyle,
                "color": to_rgba(color), "marker": marker,
                "linewidth": linewidth}
        self.lines.append(line)
        return line

    def barh(self, labels, values, color=None) -> dict:
        """Horizontal bars, the first at the bottom, labelled on the y
        axis."""
        if color is None:
            color = f"C{self._patch_cycle % 10}"
            self._patch_cycle += 1
        bars = {"labels": [str(v) for v in labels],
                "values": np.asarray(values, np.float64),
                "color": to_rgba(color)}
        self.bars.append(bars)
        return bars

    def scatter(self, x, y, c=None, s: float = 36.0, cmap: str = "viridis",
                alpha: float | None = None, marker: str = "o",
                label: str | None = None, edgecolors=None) -> dict:
        """Points; `c` is one colour, or numbers mapped through `cmap`
        over their min and max.  `facecolors` holds each point's RGBA
        floats (alpha applied), as matplotlib's `get_facecolors()`."""
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        if c is None:
            c = f"C{self._patch_cycle % 10}"
            self._patch_cycle += 1
        if isinstance(c, (str, tuple)):
            face = np.tile(np.asarray(to_rgba(c, alpha)), (len(x), 1))
        else:
            face = get_cmap(cmap)(normalize(np.asarray(c)), alpha=alpha)
        pts = {"x": x, "y": y, "facecolors": face, "s": float(s),
               "marker": marker, "label": label,
               "edgecolor": None if edgecolors is None else to_rgba(
                   edgecolors)}
        self.scatters.append(pts)
        return pts

    def arrow(self, start, end, color="black", linewidth: float = 1.0
              ) -> dict:
        """An open-headed arrow from `start` to `end` (matplotlib's
        `annotate` with `arrowstyle="->"`)."""
        a = {"start": tuple(float(v) for v in start),
             "end": tuple(float(v) for v in end), "color": to_rgba(color),
             "linewidth": linewidth}
        self.arrows.append(a)
        return a

    def rectangle(self, xy, width: float, height: float, edgecolor="black",
                  facecolor=None, linewidth: float = 1.0) -> dict:
        """A rectangle from corner `xy`; `facecolor` None leaves it
        unfilled."""
        r = {"xy": tuple(float(v) for v in xy), "width": float(width),
             "height": float(height), "edgecolor": to_rgba(edgecolor),
             "facecolor": None if facecolor is None else to_rgba(facecolor),
             "linewidth": linewidth}
        self.rects.append(r)
        return r

    def text(self, x, y, s: str, color="black", fontsize: float = 10.0,
             ha: str = "center", va: str = "center") -> dict:
        t = {"x": float(x), "y": float(y), "text": str(s),
             "color": to_rgba(color), "fontsize": fontsize, "ha": ha,
             "va": va}
        self.texts.append(t)
        return t

    # -- decorations
    def set_title(self, s: str, fontsize: float = 12.0) -> None:
        self.title, self.title_size = str(s), fontsize

    def set_xlabel(self, s: str) -> None:
        self.xlabel = str(s)

    def set_ylabel(self, s: str, rotation: float = 90) -> None:
        self.ylabel, self.ylabel_rotation = str(s), rotation

    def set_xticks(self, positions, labels=None) -> None:
        pos = list(positions)
        self.xticks = (pos, [str(v) for v in (pos if labels is None
                                              else labels)])

    def set_yticks(self, positions, labels=None) -> None:
        pos = list(positions)
        self.yticks = (pos, [str(v) for v in (pos if labels is None
                                              else labels)])

    def set_ylim(self, lo: float, hi: float) -> None:
        self.ylim = (float(lo), float(hi))

    def set_spines(self, color, width: float) -> None:
        self.spines = {"color": to_rgba(color), "width": width}

    def axis_off(self) -> None:
        self.axis_on = False

    def legend(self) -> None:
        self.legend_on = True

    def legend_entries(self) -> list[dict]:
        """The labelled lines and scatters, lines first, as matplotlib's
        legend lists them."""
        return ([ln for ln in self.lines if ln["label"]]
                + [p for p in self.scatters if p["label"]])

    def add_colorbar(self, im: dict) -> None:
        """A colorbar of image `im`'s map and bounds."""
        data = np.asarray(im["data"])
        vmin = data.min() if im["vmin"] is None else im["vmin"]
        vmax = data.max() if im["vmax"] is None else im["vmax"]
        self.colorbar = {"cmap": im["cmap"], "vmin": float(vmin),
                         "vmax": float(vmax)}


# ------------------------------------------------------------- drawing
def _nice_ticks(lo: float, hi: float, count: int = 5) -> np.ndarray:
    """About `count` round tick positions in [lo, hi]."""
    if not hi > lo:
        return np.asarray([lo])
    raw = (hi - lo) / count
    mag = 10.0 ** math.floor(math.log10(raw))
    step = next(m * mag for m in (1, 2, 2.5, 5, 10) if m * mag >= raw)
    first = math.ceil(lo / step - 1e-9) * step
    return np.arange(first, hi + step * 1e-6, step)


def _tick_label(v: float) -> str:
    return f"{round(v, 10):g}"


def _limits(lo: float, hi: float, margin: float = 0.05) -> tuple:
    if not np.isfinite(lo) or not np.isfinite(hi):
        return 0.0, 1.0
    if hi == lo:
        return lo - 0.5, hi + 0.5
    pad = (hi - lo) * margin
    return lo - pad, hi + pad


class _Canvas:
    """The (H, W, 3) float32 pixels being drawn, 0-255, white at first."""

    def __init__(self, h: int, w: int):
        self.px = np.full((h, w, 3), 255.0, np.float32)
        self.h, self.w = h, w

    def blend(self, rows, cols, rgba, cover=None) -> None:
        """Paint `rgba` over pixels (rows, cols) (arrays, clipped to the
        canvas) with its alpha times `cover`."""
        rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
        keep = (rows >= 0) & (rows < self.h) & (cols >= 0) & (cols < self.w)
        rows, cols = rows[keep], cols[keep]
        color = np.asarray(rgba[:3], np.float32) * 255
        a = np.float32(rgba[3])
        if cover is not None:
            a = a * np.asarray(cover, np.float32)[keep][:, None]
        if np.ndim(a) == 0 and a == 1:
            self.px[rows, cols] = color
        else:
            self.px[rows, cols] = a * color + (1 - a) * self.px[rows, cols]

    def fill(self, x0, y0, x1, y1, rgba) -> None:
        """The pixel box [x0, x1) x [y0, y1)."""
        x0, x1 = max(int(round(x0)), 0), min(int(round(x1)), self.w)
        y0, y1 = max(int(round(y0)), 0), min(int(round(y1)), self.h)
        if x1 <= x0 or y1 <= y0:
            return
        color = np.asarray(rgba[:3], np.float32) * 255
        a = np.float32(rgba[3])
        box = self.px[y0:y1, x0:x1]
        box[...] = color if a == 1 else a * color + (1 - a) * box

    def segments(self, pts, rgba, width: float, dashed: bool = False
                 ) -> None:
        """Straight segments between consecutive points (pixel (x, y)
        rows), `width` pixels wide; dashed: 6 on, 4 off along the line."""
        pts = np.asarray(pts, np.float64)
        pts = pts[np.isfinite(pts).all(axis=1)]
        if len(pts) < 2:
            return
        a, b = pts[:-1], pts[1:]
        lengths = np.hypot(*(b - a).T)
        n = np.ceil(lengths).astype(np.int64) + 1
        seg = np.repeat(np.arange(len(a)), n)
        t = (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)) / np.repeat(
            np.maximum(n - 1, 1), n)
        p = a[seg] + (b - a)[seg] * t[:, None]
        if dashed:
            arc = np.concatenate([[0], np.cumsum(lengths)])[seg] + t * lengths[
                seg]
            p = p[(arc % 10) < 6]
        self.stamp(p, rgba, _disc(max(width, 1.0)))

    def stamp(self, centers, rgba, offsets) -> None:
        """Paint the pixel `offsets` ((k, 2) of dy, dx) about each center
        (pixel (x, y) rows) once each."""
        c = np.rint(np.asarray(centers, np.float64)).astype(np.int64)
        if not len(c):
            return
        rows = (c[:, 1][:, None] + offsets[:, 0][None]).ravel()
        cols = (c[:, 0][:, None] + offsets[:, 1][None]).ravel()
        keep = (rows >= 0) & (rows < self.h) & (cols >= 0) & (cols < self.w)
        flat = np.unique(rows[keep] * self.w + cols[keep])
        self.blend(flat // self.w, flat % self.w, rgba)

    def text(self, x, y, s: str, rgba, px: int, ha="left", va="baseline",
             rotate: bool = False) -> tuple:
        """Set `s` at pixel (x, y), anchored by ha (left, center, right)
        and va (top, center, baseline, bottom); `rotate` turns it to read
        upwards.  Returns its (width, height) on the canvas."""
        if not s:
            return 0, 0
        cov, base = text_alpha(s, px)
        if rotate:
            cov = np.rot90(cov)
            base = None
        h, w = cov.shape
        x0 = {"left": x, "center": x - w / 2, "right": x - w}[ha]
        y0 = {"top": y, "center": y - h / 2, "bottom": y - h,
              "baseline": y - (base if base is not None else h)}[va]
        x0, y0 = int(round(x0)), int(round(y0))
        rr, cc = np.nonzero(cov)
        self.blend(rr + y0, cc + x0, rgba, cov[rr, cc])
        return w, h


@lru_cache(maxsize=None)
def _disc(diameter: float) -> np.ndarray:
    """(dy, dx) offsets of a filled disc `diameter` pixels across."""
    r = max(diameter, 1.0) / 2
    k = int(math.ceil(r))
    dy, dx = np.mgrid[-k:k + 1, -k:k + 1]
    inside = (dy + 0.5 * (diameter % 2 == 0)) ** 2 + (
        dx + 0.5 * (diameter % 2 == 0)) ** 2 <= r * r + 0.25
    return np.stack([dy[inside], dx[inside]], 1)


@lru_cache(maxsize=None)
def _marker(marker: str, size: float) -> np.ndarray:
    """(dy, dx) offsets of a marker `size` pixels across."""
    size = max(size, 3.0)
    k = int(math.ceil(size / 2))
    dy, dx = np.mgrid[-k:k + 1, -k:k + 1]
    if marker == "o":
        inside = dy ** 2 + dx ** 2 <= (size / 2) ** 2
    elif marker == "s":
        inside = (abs(dy) <= size / 2) & (abs(dx) <= size / 2)
    elif marker == "x":
        inside = ((abs(dy - dx) <= 1) | (abs(dy + dx) <= 1)) & (
            abs(dx) <= size / 2)
    elif marker == "*":
        # a five-pointed star: inside the polygon of ten vertices
        ang = np.pi / 2 + np.arange(10) * np.pi / 5
        rad = np.where(np.arange(10) % 2 == 0, size / 2, size / 5)
        vx, vy = rad * np.cos(ang), -rad * np.sin(ang)
        inside = _in_polygon(dx, dy, vx, vy)
    else:
        raise ValueError(f"unknown marker {marker!r}")
    return np.stack([dy[inside], dx[inside]], 1)


def _in_polygon(px, py, vx, vy) -> np.ndarray:
    """Even-odd test of points (px, py) against the polygon (vx, vy)."""
    inside = np.zeros(px.shape, bool)
    j = len(vx) - 1
    for i in range(len(vx)):
        cross = ((vy[i] > py) != (vy[j] > py)) & (
            px < (vx[j] - vx[i]) * (py - vy[i]) / (vy[j] - vy[i] + 1e-12)
            + vx[i])
        inside ^= cross
        j = i
    return inside


class Figure:
    """A figure `figsize` inches at `dpi`: int(width * dpi) x int(height *
    dpi) pixels, as matplotlib sizes a PNG saved without a tight box."""

    def __init__(self, figsize=(6.4, 4.8), dpi: float = 100):
        self.figsize = (float(figsize[0]), float(figsize[1]))
        self.dpi = float(dpi)
        self.width = int(self.figsize[0] * self.dpi)
        self.height = int(self.figsize[1] * self.dpi)
        self.grid: tuple[int, int] = (1, 1)
        self.axes: list[Axes] = []
        self.suptitle_text = ""
        self.suptitle_size = 12.0

    def subplots(self, nrows: int = 1, ncols: int = 1) -> np.ndarray:
        """An (nrows, ncols) object array of new panels, row-major."""
        self.grid = (nrows, ncols)
        self.axes = [Axes(self) for _ in range(nrows * ncols)]
        return np.asarray(self.axes, dtype=object).reshape(nrows, ncols)

    def suptitle(self, s: str, fontsize: float = 12.0) -> None:
        self.suptitle_text, self.suptitle_size = str(s), fontsize

    def px(self, fontsize: float) -> int:
        return _font_px(fontsize, self.dpi)

    def pt(self, points: float) -> float:
        """`points` in pixels at the figure's dpi."""
        return points * self.dpi / 72

    def render(self) -> np.ndarray:
        """The figure's pixels, (height, width, 3) uint8."""
        cv = _Canvas(self.height, self.width)
        top = 4
        if self.suptitle_text:
            px = self.px(self.suptitle_size)
            cv.text(self.width / 2, top, self.suptitle_text,
                    to_rgba("black"), px, ha="center", va="top")
            top += px + 8
        nrows, ncols = self.grid
        cell_w = self.width / ncols
        cell_h = (self.height - top) / nrows
        for i, ax in enumerate(self.axes):
            r, c = divmod(i, ncols)
            _draw_axes(cv, ax, (c * cell_w, top + r * cell_h, cell_w,
                                cell_h))
        return np.rint(cv.px).clip(0, 255).astype(np.uint8)

    def save(self, path: str) -> str:
        """Write `render()` to `path` as a PNG, making its directory."""
        return write_png(path, self.render())


def _box(cv: _Canvas, ax: Axes, cell) -> tuple:
    """The plotting box (x0, y0, w, h) of `ax` in its grid cell, less the
    room its title, labels, ticks and colorbar take."""
    fig = ax.fig
    x, y, w, h = cell
    pad = 6
    small = fig.px(ax.tick_size)
    top = pad + (fig.px(ax.title_size) + pad if ax.title else 0)
    bottom, left = pad, pad
    right = pad + (8 * small if ax.colorbar else 0)
    label_px = fig.px(12)
    if ax.axis_on:
        xlabels = (ax.xticks[1] if ax.xticks is not None else
                   [] if ax.images else ["0"])
        bottom += ((small + 8) if xlabels else 0) + (
            label_px + 4 if ax.xlabel else 0)
        ylabels = (ax.yticks[1] if ax.yticks is not None else
                   [b for bars in ax.bars for b in bars["labels"]]
                   or ([] if ax.images else ["-0.00"]))
        widest = max((text_alpha(s, small)[0].shape[1] + 8 for s in ylabels),
                     default=0)
        left += widest + (_label_room(ax, label_px) if ax.ylabel else 0)
    elif ax.ylabel:
        left += _label_room(ax, label_px)
    return (x + left, y + top, max(w - left - right, 4),
            max(h - top - bottom, 4))


def _label_room(ax: Axes, px: int) -> int:
    """Pixels the y label takes left of the box: its height when it reads
    upwards, else its width."""
    cov, _ = text_alpha(ax.ylabel, px)
    return (cov.shape[0] if ax.ylabel_rotation == 90 else cov.shape[1]) + 6


def _draw_axes(cv: _Canvas, ax: Axes, cell) -> None:
    fig = ax.fig
    bx, by, bw, bh = _box(cv, ax, cell)
    small = fig.px(ax.tick_size)
    black = to_rgba("black")
    if ax.images:
        im = ax.images[0]
        ih, iw = im["data"].shape
        sx, sy = max(int(bw // iw), 1), max(int(bh // ih), 1)
        if im["aspect"] == "equal":
            sx = sy = min(sx, sy)
        # center the image in the box
        bx, by = bx + (bw - sx * iw) // 2, by + (bh - sy * ih) // 2
        bw, bh = sx * iw, sy * ih
        xlim, ylim = (-0.5, iw - 0.5), (ih - 0.5, -0.5)
    else:
        xlim, ylim = _data_limits(ax)
    bx, by = int(round(bx)), int(round(by))
    bw, bh = int(round(bw)), int(round(bh))

    def to_px(x, y):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        px = bx + (x - xlim[0]) / (xlim[1] - xlim[0]) * bw
        py = by + (ylim[1] - y) / (ylim[1] - ylim[0]) * bh
        return np.stack([px, py], -1)

    for im in ax.images:
        rgba = map_colors(im["data"], im["cmap"], im["vmin"], im["vmax"])
        ih, iw = im["data"].shape
        im["placed"] = (bx, by, bw // iw, bh // ih)
        block = np.repeat(np.repeat(rgba[..., :3], bh // ih, 0), bw // iw, 1)
        cv.px[by:by + block.shape[0], bx:bx + block.shape[1]] = block[
            :cv.h - by, :cv.w - bx]
    for sf in ax.surfaces:
        _draw_surface(cv, sf, bx, by, bw, bh, xlim, ylim)
    for bars in ax.bars:
        for i, v in enumerate(bars["values"]):
            (x0, y0), (x1, y1) = to_px([0, v], [i + 0.4, i - 0.4])
            cv.fill(min(x0, x1), y0, max(x0, x1), y1, bars["color"])
    for r in ax.rects:
        (x0, y0), (x1, y1) = to_px([r["xy"][0], r["xy"][0] + r["width"]],
                                   [r["xy"][1], r["xy"][1] + r["height"]])
        if r["facecolor"] is not None:
            cv.fill(min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1),
                    r["facecolor"])
    for ln in ax.lines:
        pts = to_px(ln["x"], ln["y"])
        cv.segments(pts, ln["color"], fig.pt(ln["linewidth"]),
                    dashed=ln["linestyle"] == "--")
        if ln["marker"]:
            cv.stamp(pts, ln["color"], _marker(ln["marker"], fig.pt(6)))
    for p in ax.scatters:
        pts = to_px(p["x"], p["y"])
        size = fig.pt(math.sqrt(p["s"]))
        if p["edgecolor"] is not None:
            cv.stamp(pts, p["edgecolor"], _marker(p["marker"], size + 2))
        faces = p["facecolors"]
        if (faces == faces[:1]).all():
            cv.stamp(pts, tuple(faces[0]), _marker(p["marker"], size))
        else:
            for color in np.unique(faces, axis=0):
                sel = (faces == color).all(axis=1)
                cv.stamp(pts[sel], tuple(color), _marker(p["marker"], size))
    for a in ax.arrows:
        _draw_arrow(cv, to_px(*zip(a["start"], a["end"])), a["color"],
                    fig.pt(a["linewidth"]))
    for r in ax.rects:
        (x0, y0), (x1, y1) = to_px([r["xy"][0], r["xy"][0] + r["width"]],
                                   [r["xy"][1], r["xy"][1] + r["height"]])
        cv.segments([(x0, y0), (x1, y0), (x1, y1), (x0, y1), (x0, y0)],
                    r["edgecolor"], fig.pt(r["linewidth"]))
    for t in ax.texts:
        (x, y), = to_px([t["x"]], [t["y"]])
        cv.text(x, y, t["text"], t["color"], fig.px(t["fontsize"]),
                ha=t["ha"], va=t["va"])
    if ax.axis_on:
        _draw_frame(cv, ax, (bx, by, bw, bh), xlim, ylim, to_px)
    if ax.title:
        cv.text(bx + bw / 2, by - 6, ax.title, black, fig.px(ax.title_size),
                ha="center", va="bottom")
    if ax.ylabel and not ax.axis_on:
        cv.text(bx - 4, by + bh / 2, ax.ylabel, black, fig.px(12),
                ha="right", va="center", rotate=ax.ylabel_rotation == 90)
    if ax.legend_on:
        _draw_legend(cv, ax, (bx, by, bw, bh))
    if ax.colorbar:
        _draw_colorbar(cv, ax.colorbar, (bx + bw + small, by, small, bh),
                       small)


def _data_limits(ax: Axes) -> tuple:
    xs, ys = [], []
    for sf in ax.surfaces:
        xs += [sf["xs"].min(), sf["xs"].max()]
        ys += [sf["ys"].min(), sf["ys"].max()]
    for ln in ax.lines:
        xs += list(ln["x"])
        ys += list(ln["y"])
    for p in ax.scatters:
        xs += list(p["x"])
        ys += list(p["y"])
    for a in ax.arrows:
        xs += [a["start"][0], a["end"][0]]
        ys += [a["start"][1], a["end"][1]]
    for bars in ax.bars:
        xs += [0.0, *bars["values"]]
        ys += [-0.5, len(bars["values"]) - 0.5]
    xs = np.asarray([v for v in xs if np.isfinite(v)] or [0.0])
    ys = np.asarray([v for v in ys if np.isfinite(v)] or [0.0])
    margin = 0.0 if ax.surfaces else 0.05
    xlim = _limits(xs.min(), xs.max(), margin)
    ylim = ax.ylim or (_limits(ys.min(), ys.max(), 0.0) if ax.bars
                       else _limits(ys.min(), ys.max(), margin))
    if ax.bars:
        xlim = (min(0.0, xlim[0]), xlim[1])
    return xlim, ylim


def _draw_surface(cv: _Canvas, sf: dict, bx, by, bw, bh, xlim, ylim) -> None:
    """The class of the nearest grid point under each pixel of the box
    inside the grid, its band's colour at `alpha` over what is there."""
    xs, ys, cls = sf["xs"], sf["ys"], sf["classes"]
    levels = sf["levels"]
    lut = surface_colors(sf)
    cols = np.arange(bw) + 0.5
    rows = np.arange(bh) + 0.5
    x = xlim[0] + cols / bw * (xlim[1] - xlim[0])
    y = ylim[1] - rows / bh * (ylim[1] - ylim[0])
    ix = np.rint((x - xs[0]) / (xs[-1] - xs[0]) * (len(xs) - 1)).astype(int)
    iy = np.rint((y - ys[0]) / (ys[-1] - ys[0]) * (len(ys) - 1)).astype(int)
    okx = (ix >= 0) & (ix < len(xs))
    oky = (iy >= 0) & (iy < len(ys))
    band = np.searchsorted(levels, cls, side="right") - 1
    band = band[np.ix_(iy[oky], ix[okx])]
    rr, cc = np.meshgrid(np.nonzero(oky)[0] + by, np.nonzero(okx)[0] + bx,
                         indexing="ij")
    a = np.float32(sf["alpha"])
    color = lut[band.clip(0, len(lut) - 1), :3].astype(np.float32) * 255
    cv.px[rr, cc] = a * color + (1 - a) * cv.px[rr, cc]


def surface_colors(sf: dict) -> np.ndarray:
    """(bands, 4) RGBA floats of a surface's bands: the colour map at each
    band's middle normalized over the levels' min and max, at the
    surface's alpha (matplotlib's `contourf` facecolors)."""
    levels = sf["levels"]
    rgba = get_cmap(sf["cmap"])(normalize(
        0.5 * (levels[:-1] + levels[1:]), levels.min(), levels.max()))
    rgba[:, 3] = sf["alpha"]
    return rgba


def _draw_arrow(cv: _Canvas, pts: np.ndarray, rgba, width: float) -> None:
    (x0, y0), (x1, y1) = pts
    cv.segments(pts, rgba, width)
    length = math.hypot(x1 - x0, y1 - y0)
    if length == 0:
        return
    ux, uy = (x1 - x0) / length, (y1 - y0) / length
    head = min(8.0, length)
    for sign in (1, -1):
        ang = sign * math.radians(25)
        hx = ux * math.cos(ang) - uy * math.sin(ang)
        hy = ux * math.sin(ang) + uy * math.cos(ang)
        cv.segments([(x1, y1), (x1 - head * hx, y1 - head * hy)], rgba,
                    width)


def _draw_frame(cv: _Canvas, ax: Axes, box, xlim, ylim, to_px) -> None:
    """Spines, ticks, tick labels and axis labels."""
    fig = ax.fig
    bx, by, bw, bh = box
    black = to_rgba("black")
    small = fig.px(ax.tick_size)
    width = max(int(round(fig.pt(ax.spines["width"]))), 1)
    color = ax.spines["color"]
    # the spines just outside the box, so they cover no image cell
    cv.fill(bx - width, by - width, bx + bw + width, by, color)
    cv.fill(bx - width, by + bh, bx + bw + width, by + bh + width, color)
    cv.fill(bx - width, by, bx, by + bh, color)
    cv.fill(bx + bw, by, bx + bw + width, by + bh, color)
    if ax.xticks is not None:
        xpos, xlab = ax.xticks
    elif ax.images:
        xpos, xlab = [], []
    else:
        xpos = _nice_ticks(*sorted(xlim))
        xlab = [_tick_label(v) for v in xpos]
    if ax.yticks is not None:
        ypos, ylab = ax.yticks
    elif ax.bars:
        ypos = list(range(len(ax.bars[0]["labels"])))
        ylab = ax.bars[0]["labels"]
    elif ax.images:
        ypos, ylab = [], []
    else:
        ypos = _nice_ticks(*sorted(ylim))
        ylab = [_tick_label(v) for v in ypos]
    for v, s in zip(xpos, xlab):
        (x, _), = to_px([v], [ylim[0]])
        if bx - 1 <= x <= bx + bw + 1:
            cv.fill(x - 0.5, by + bh, x + 0.5, by + bh + 4, black)
            cv.text(x, by + bh + 6, s, black, small, ha="center", va="top")
    for v, s in zip(ypos, ylab):
        (_, y), = to_px([xlim[0]], [v])
        if by - 1 <= y <= by + bh + 1:
            cv.fill(bx - 4, y - 0.5, bx, y + 0.5, black)
            cv.text(bx - 6, y, s, black, small, ha="right", va="center")
    label_px = fig.px(12)
    if ax.xlabel:
        cv.text(bx + bw / 2, by + bh + small + 12, ax.xlabel, black,
                label_px, ha="center", va="top")
    if ax.ylabel:
        widest = max((text_alpha(s, small)[0].shape[1] for s in ylab),
                     default=0)
        cv.text(bx - widest - 12, by + bh / 2, ax.ylabel, black, label_px,
                ha="right", va="center", rotate=ax.ylabel_rotation == 90)


def _draw_legend(cv: _Canvas, ax: Axes, box) -> None:
    fig = ax.fig
    entries = ax.legend_entries()
    if not entries:
        return
    bx, by, bw, bh = box
    px = fig.px(10)
    sample = 2 * px
    widths = [text_alpha(e["label"], px)[0].shape[1] for e in entries]
    w = sample + 12 + max(widths) + 8
    h = len(entries) * (px + 6) + 6
    x0, y0 = bx + bw - w - 8, by + 8
    cv.fill(x0, y0, x0 + w, y0 + h, to_rgba("white", 0.8))
    cv.segments([(x0, y0), (x0 + w, y0), (x0 + w, y0 + h), (x0, y0 + h),
                 (x0, y0)], to_rgba("gray"), 1)
    for i, e in enumerate(entries):
        cy = y0 + 6 + i * (px + 6) + px / 2
        if "linestyle" in e:
            cv.segments([(x0 + 6, cy), (x0 + 6 + sample, cy)], e["color"],
                        fig.pt(e["linewidth"]),
                        dashed=e["linestyle"] == "--")
            if e["marker"]:
                cv.stamp([(x0 + 6 + sample / 2, cy)], e["color"],
                         _marker(e["marker"], fig.pt(6)))
        else:
            cv.stamp([(x0 + 6 + sample / 2, cy)],
                     tuple(e["facecolors"][0]),
                     _marker(e["marker"], fig.pt(math.sqrt(e["s"])) + 2))
        cv.text(x0 + 12 + sample, cy, e["label"], to_rgba("black"), px,
                ha="left", va="center")


def _draw_colorbar(cv: _Canvas, cb: dict, box, px: int) -> None:
    x0, y0, w, h = (int(round(v)) for v in box)
    ramp = np.linspace(cb["vmax"], cb["vmin"], max(h, 2))
    rgb = map_colors(ramp, cb["cmap"], cb["vmin"], cb["vmax"])[:, :3]
    cv.px[y0:y0 + h, x0:x0 + w] = np.repeat(rgb[:, None], w, 1)[
        :cv.h - y0, :cv.w - x0]
    black = to_rgba("black")
    for v in _nice_ticks(cb["vmin"], cb["vmax"], 4):
        y = y0 + (cb["vmax"] - v) / (cb["vmax"] - cb["vmin"] or 1) * (h - 1)
        cv.fill(x0 + w, y - 0.5, x0 + w + 3, y + 0.5, black)
        cv.text(x0 + w + 5, y, _tick_label(v), black, px, ha="left",
                va="center")


# ----------------------------------------------------------- PNG, GIF
def read_png(path) -> np.ndarray:
    """The pixels of a PNG the port wrote (`png_bytes`: 8-bit gray, RGB
    or RGBA, not interlaced, every row unfiltered): (H, W) or (H, W, C)
    uint8.  Raises ValueError on any other PNG, or a chunk whose CRC
    does not match."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if struct.unpack(">I", data[pos + 8 + length:pos + 12 + length]) != (
                zlib.crc32(tag + body),):
            raise ValueError(f"{path}: bad CRC in its {tag!r} chunk")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + length
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    channels = {0: 1, 2: 3, 6: 4}.get(ctype)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: only 8-bit gray, RGB or RGBA PNGs without "
                         f"interlace are read (bit depth {depth}, colour "
                         f"type {ctype}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(h, 1 + w * channels)
    filters = set(np.unique(rows[:, 0]).tolist())
    if filters != {0}:
        raise ValueError(f"{path}: rows filtered with types "
                         f"{sorted(filters)}; only unfiltered PNGs (the "
                         f"port's own) are read")
    px = rows[:, 1:].reshape(h, w, channels)
    return px[..., 0] if channels == 1 else px


def _lzw(indices: bytes, min_size: int) -> bytes:
    """GIF's variable-width LZW of `indices`, from a clear code, with a
    clear code and a new table whenever the 4,096 codes are used up."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nbits = 0

    def emit(code: int, width: int) -> None:
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    width = min_size + 1
    emit(clear, width)
    table: dict[int, int] = {}
    next_code = end + 1
    prefix = indices[0]
    for byte in indices[1:]:  # the encoder's loop, a pixel a turn
        key = (prefix << 8) | byte
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix, width)
        if next_code == 4096:
            emit(clear, width)
            table.clear()
            next_code, width = end + 1, min_size + 1
        else:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << width) and width < 12:
                width += 1
        prefix = byte
    emit(prefix, width)
    emit(end, width)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def gif_bytes(frames, fps: float = 5) -> bytes:
    """A GIF89a of uint8 frames ((H, W) gray or (H, W, 3) RGB, all one
    size) with one global palette of the colours they use, each frame
    shown `round(100 / fps)` centiseconds, and no loop extension: what
    imageio's `mimsave(path, frames, fps=fps)` writes (through Pillow),
    which viewers play once.  Raises ValueError on frames of other sizes
    or more than 256 colours in all."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("no frames")
    shape = frames[0].shape
    for f in frames:
        if f.dtype != np.uint8 or f.shape != shape or f.ndim not in (2, 3):
            raise ValueError(f"GIF frames must be uint8 (H, W) or (H, W, 3) "
                             f"of one size; got {f.dtype} {f.shape}")
    rgb = [np.repeat(f[..., None], 3, 2) if f.ndim == 2 else f[..., :3]
           for f in frames]
    keys = [(f[..., 0].astype(np.int64) << 16) | (f[..., 1].astype(np.int64)
                                                  << 8) | f[..., 2]
            for f in rgb]
    palette = np.unique(np.concatenate([k.ravel() for k in keys]))
    if len(palette) > 256:
        raise ValueError(f"the frames hold {len(palette)} colours; a GIF "
                         f"palette holds 256")
    bits = max(1, int(math.ceil(math.log2(max(len(palette), 2)))))
    table = np.zeros((1 << bits, 3), np.uint8)
    table[:len(palette)] = np.stack([(palette >> 16) & 255,
                                     (palette >> 8) & 255, palette & 255], 1)
    h, w = shape[:2]
    delay = int(round(100 / fps))
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF0 | (bits - 1), 0, 0),
           table.tobytes()]
    min_size = max(bits, 2)
    for k in keys:
        idx = np.searchsorted(palette, k).astype(np.uint8).tobytes()
        data = _lzw(idx, min_size)
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay)
                   + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        out.append(bytes([min_size]))
        out += [bytes([len(data[i:i + 255])]) + data[i:i + 255]
                for i in range(0, len(data), 255)]
        out.append(b"\x00")
    out.append(b"\x3b")
    return b"".join(out)


def write_gif(path: str, frames, fps: float = 5) -> str:
    """Write `gif_bytes(frames, fps)` to `path`, making its directory."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(gif_bytes(frames, fps))
    return path
