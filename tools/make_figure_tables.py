"""Build `cfgan_torch/eval/figure_tables.npz`, the data the port's raster
(`cfgan_torch/eval/figure.py`) draws with and cannot compute itself:

- `viridis` and `Blues`: matplotlib's 256-entry colour tables (RGBA
  floats), as `matplotlib.colormaps[name]` holds them;
- a bitmap font of printable ASCII (32-126) at the pixel sizes
  `FONT_SIZES`, rendered with matplotlib's Agg backend from the DejaVu
  Sans it bundles (Bitstream Vera licence): per size, `font{px}_alpha`
  (95, rows, cols) uint8 coverage cells whose row `ascent` is the
  baseline and whose column `left` is the pen position,
  `font{px}_advance` (95,) pen advances in pixels and `font{px}_metrics`
  (ascent, descent, left).

    python tools/make_figure_tables.py [--out PATH]

`tests/test_torch_figure.py` renders the tables again with `build()` and
holds the committed file equal to them.  Needs matplotlib (not the port).
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "cfgan_torch" / "eval" / "figure_tables.npz"
FONT_SIZES = (12, 15)
CHARS = [chr(c) for c in range(32, 127)]


def _glyph_coverage(ch: str, px: int, pad: int) -> np.ndarray:
    """Agg's coverage of `ch` drawn black on white at `px` pixels (72 dpi,
    so points are pixels), its baseline on row `2 * pad` and its pen at
    column `pad` of a (4 pad, 3 pad) canvas."""
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    h, w = 4 * pad, 3 * pad
    fig = Figure(figsize=(w / 72, h / 72), dpi=72)
    FigureCanvasAgg(fig)
    fig.text(pad / w, 1 - 2 * pad / h, ch, fontsize=px, family="DejaVu Sans",
             va="baseline", ha="left", color="black")
    fig.canvas.draw()
    rgb = np.asarray(fig.canvas.buffer_rgba())[..., 0]
    return (255 - rgb).astype(np.uint8)


def _advance(ch: str, px: int) -> int:
    from matplotlib import font_manager
    from matplotlib.ft2font import FT2Font

    font = FT2Font(font_manager.findfont("DejaVu Sans"))
    font.set_size(px, 72)
    return int(round(font.load_char(ord(ch)).linearHoriAdvance / 65536))


def build() -> dict[str, np.ndarray]:
    """The tables, from this host's matplotlib."""
    import matplotlib

    tables = {name: np.asarray(matplotlib.colormaps[name](np.arange(256)),
                               np.float64)
              for name in ("viridis", "Blues")}
    for px in FONT_SIZES:
        pad = 2 * px
        cells = np.stack([_glyph_coverage(ch, px, pad) for ch in CHARS])
        ink_rows = np.nonzero(cells.max(axis=(0, 2)))[0]
        ink_cols = np.nonzero(cells.max(axis=(0, 1)))[0]
        top, bottom = int(ink_rows.min()), int(ink_rows.max()) + 1
        left, right = int(ink_cols.min()), int(ink_cols.max()) + 1
        tables[f"font{px}_alpha"] = cells[:, top:bottom, left:right]
        tables[f"font{px}_advance"] = np.asarray(
            [_advance(ch, px) for ch in CHARS], np.int64)
        tables[f"font{px}_metrics"] = np.asarray(
            [2 * pad - top, bottom - 2 * pad, pad - left], np.int64)
    return tables


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    np.savez_compressed(args.out, **build())
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
