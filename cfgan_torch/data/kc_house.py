"""King County house sales, the tabular CounteRGAN's data (mirrors
`cfgan/data/kc_house.py`), in numpy.

Drop id/date/zipcode, clip the 33-bedroom outlier to 8, four price
classes at the price quartiles (the bin edges are kept), an 80/20
train/test split, MinMax scaling fitted on the train split.

The CSV is looked for at `path`, then `$CFGAN_KC_HOUSE_CSV`, then
`kc_house_data.csv` at the root of the checkout (the JAX package also
looks in its reference checkout and home cache, which the port leaves
alone).  Where none exists, a schema-faithful synthetic table of 21,613
rows stands in: `_synthesize` makes the JAX package's `RandomState`
calls in its order, so the two packages load the same table, split,
stats and bins bit for bit.
"""
from __future__ import annotations

import csv
import math
import os
from pathlib import Path

import numpy as np

from cfgan_torch.core.config import TabularSchema
from cfgan_torch.data.transforms import fit_minmax

KC_SCHEMA = TabularSchema(
    feature_names=(
        "bedrooms", "bathrooms", "sqft_living", "sqft_lot",
        "floors", "waterfront", "view", "condition", "grade",
        "sqft_above", "sqft_basement", "yr_built", "yr_renovated",
        "lat", "long", "sqft_living15", "sqft_lot15",
    ),
    immutable_features=("lat", "long", "yr_built", "yr_renovated"),
    categorical_values={
        "bedrooms": tuple(float(v) for v in range(9)),
        "bathrooms": tuple(sorted([
            0.00, 0.50, 0.75, 1.00, 1.25, 1.50, 1.75, 2.00, 2.25, 2.50,
            2.75, 3.00, 3.25, 3.50, 3.75, 4.00, 4.25, 4.50, 4.75, 5.00,
            5.25, 5.50, 5.75, 6.00, 6.25, 6.50, 6.75, 7.50, 7.75, 8.00,
        ])),
        "floors": (1.0, 1.5, 2.0, 2.5, 3.0, 3.5),
        "waterfront": (0.0, 1.0),
        "view": (0.0, 1.0, 2.0, 3.0, 4.0),
        "condition": (1.0, 2.0, 3.0, 4.0, 5.0),
        "grade": tuple(float(v) for v in range(1, 14)),
    },
)

DROPPED = ("id", "date", "zipcode")
REPO_CSV = Path(__file__).resolve().parents[2] / "kc_house_data.csv"
SYNTHETIC_ROWS = 21613


def resolve_csv(path: str | None = None) -> str | None:
    for c in (path, os.environ.get("CFGAN_KC_HOUSE_CSV"), str(REPO_CSV)):
        if c and os.path.exists(c):
            return c
    return None


def read_csv(path: str) -> dict[str, np.ndarray]:
    """Column name -> float64 column of the King County CSV, without
    id/date/zipcode.  Values parse as Python floats (correctly rounded, as
    pandas' default parser rounds them)."""
    with open(path, newline="") as f:
        rows = csv.reader(f)
        header = next(rows)
        keep = [i for i, name in enumerate(header) if name not in DROPPED]
        values = [[float(r[i]) for i in keep] for r in rows if r]
    table = np.asarray(values, np.float64).reshape(len(values), len(keep))
    return {header[i]: table[:, j] for j, i in enumerate(keep)}


def _geo(n, mean):
    p = np.exp(-0.5 * ((np.arange(n) - mean) / 1.2) ** 2)
    return p / p.sum()


def _synthesize(n: int = SYNTHETIC_ROWS, seed: int = 0
                ) -> dict[str, np.ndarray]:
    """The JAX package's synthetic table with a learnable price signal:
    the same draws in the same order, the same float64 arithmetic."""
    rng = np.random.RandomState(seed)
    cat = KC_SCHEMA.categorical_values
    d: dict[str, np.ndarray] = {}
    d["bedrooms"] = rng.choice(range(9), n, p=_geo(9, 3))
    d["bathrooms"] = rng.choice(cat["bathrooms"], n)
    d["sqft_living"] = np.exp(rng.normal(7.55, 0.42, n)).round().clip(
        290, 13540)
    d["sqft_lot"] = np.exp(rng.normal(8.99, 0.9, n)).round().clip(
        520, 1651359)
    d["floors"] = rng.choice(cat["floors"], n)
    d["waterfront"] = (rng.uniform(0, 1, n) < 0.0075).astype(float)
    d["view"] = rng.choice(range(5), n, p=_geo(5, 0.35))
    d["condition"] = rng.choice(range(1, 6), n,
                                p=[0.01, 0.01, 0.65, 0.26, 0.07])
    d["grade"] = np.clip(rng.normal(7.65, 1.17, n).round(), 1, 13)
    d["sqft_above"] = (d["sqft_living"] * rng.uniform(0.6, 1.0, n)).round()
    d["sqft_basement"] = d["sqft_living"] - d["sqft_above"]
    d["yr_built"] = rng.randint(1900, 2016, n)
    renovated = rng.uniform(0, 1, n) < 0.04
    d["yr_renovated"] = np.where(renovated, rng.randint(1950, 2016, n), 0)
    d["lat"] = rng.uniform(47.156, 47.778, n)
    d["long"] = rng.uniform(-122.52, -121.31, n)
    d["sqft_living15"] = (d["sqft_living"]
                          * rng.uniform(0.7, 1.3, n)).round()
    d["sqft_lot15"] = (d["sqft_lot"] * rng.uniform(0.7, 1.3, n)).round()
    log_price = (9.0 + 0.00035 * d["sqft_living"] + 0.11 * d["grade"]
                 + 0.9 * d["waterfront"] + 0.06 * d["view"]
                 + 0.04 * d["condition"] + 1.1 * (d["lat"] - 47.15)
                 + rng.normal(0, 0.25, n))
    d["price"] = np.exp(log_price.clip(10.5, 14.8))
    return d


def quartile_classes(price: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(class, bin edges) of `pd.qcut(price, q=4, labels=[0, 1, 2, 3],
    retbins=True, duplicates="drop")`: edges at the linearly interpolated
    quartiles, bins closed on the right, the lowest edge included."""
    bins = np.quantile(price, np.linspace(0, 1, 5))
    if len(np.unique(bins)) != len(bins):
        raise ValueError(f"price quartiles {bins} are not distinct: four "
                         "classes need four bins")
    cls = np.searchsorted(bins, price, side="left") - 1
    cls[price == bins[0]] = 0
    return cls.astype(np.int64), bins


def shuffle_split(n: int, test_fraction: float, seed: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(train, test) indices of scikit-learn's unstratified
    `train_test_split(..., test_size=test_fraction, random_state=seed)`:
    test = the first ceil(fraction * n) of `RandomState(seed)`'s
    permutation."""
    n_test = math.ceil(test_fraction * n)
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:], perm[:n_test]


def load_kc_house(path: str | None = None, seed: int = 42,
                  test_fraction: float = 0.2):
    """Returns ((x_train, y_train), (x_test, y_test), stats, bins, schema):
    float32 features in [0, 1] in the schema's order, int32 price
    classes, the train split's `NormStats` and the float64 bin edges."""
    found = resolve_csv(path)
    table = read_csv(found) if found is not None else _synthesize()
    bedrooms = table["bedrooms"].copy()
    bedrooms[bedrooms > 8] = 8
    table = {**table, "bedrooms": bedrooms}
    y, bins = quartile_classes(table["price"])
    x = np.stack([np.asarray(table[f], np.float64)
                  for f in KC_SCHEMA.feature_names], axis=1)
    itr, ite = shuffle_split(len(y), test_fraction, seed)
    stats = fit_minmax(x[itr])
    return ((stats.transform(x[itr]), y[itr].astype(np.int32)),
            (stats.transform(x[ite]), y[ite].astype(np.int32)),
            stats, bins, KC_SCHEMA)
