"""The port's King County house data (cfgan_torch.data.kc_house,
.transforms; numpy only) against the JAX package's
(`cfgan.data.kc_house.load_kc_house`, pandas and scikit-learn), on the
CPU:

- the synthetic table (no CSV is on this machine, so both fall back to
  it), its quartile classes and bin edges, the 80/20 split and the MinMax
  stats: equal bit for bit;
- the CSV path on a 200-row fixture in the King County layout written by
  the test (ids, dates and zipcodes to drop, a 33-bedroom row to clip):
  equal bit for bit;
- the qcut and unstratified-split rewrites against pandas and
  scikit-learn on other data, the schema's index views, and the
  NormStats metadata round trip through both packages.
"""
import csv

import numpy as np
import pandas as pd
import pytest
from sklearn.model_selection import train_test_split

from cfgan.data import kc_house as jkc
from cfgan.data.transforms import NormStats as JaxNormStats
from cfgan_torch.data import kc_house as pkc
from cfgan_torch.data.transforms import NormStats, fit_minmax

PARTS = ("x_train", "y_train", "x_test", "y_test", "data_min", "data_max",
         "bins")


def _parts(loaded):
    (xtr, ytr), (xte, yte), stats, bins, _ = loaded
    return dict(zip(PARTS, (xtr, ytr, xte, yte, np.asarray(stats.data_min),
                            np.asarray(stats.data_max), np.asarray(bins))))


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory, monkeypatch_module):
    monkeypatch_module.chdir(tmp_path_factory.mktemp("no_csv"))
    monkeypatch_module.delenv("CFGAN_KC_HOUSE_CSV", raising=False)
    assert jkc._resolve_csv(None) is None and pkc.resolve_csv(None) is None
    return _parts(jkc.load_kc_house()), _parts(pkc.load_kc_house())


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.mark.parametrize("part", PARTS)
def test_synthetic_table_equals_jax_bit_for_bit(synthetic, part):
    want, got = synthetic
    assert got[part].dtype == want[part].dtype, part
    np.testing.assert_array_equal(got[part], want[part])


def test_synthetic_split_sizes_and_classes(synthetic):
    _, got = synthetic
    assert got["x_train"].shape == (17290, 17)
    assert got["x_test"].shape == (4323, 17)
    assert set(np.unique(got["y_train"])) == {0, 1, 2, 3}
    # min subtracted in float64 from float32 stats: a few ulps either side
    assert -1e-5 < got["x_train"].min() <= 0.0
    assert 1.0 <= got["x_train"].max() < 1 + 1e-5


def _write_fixture(path, n=200, seed=0):
    """A King County-layout CSV: id, date, price, the 17 features with a
    zipcode among them, in the real file's column order."""
    rng = np.random.RandomState(seed)
    table = pkc._synthesize(n, seed)
    table["bedrooms"][3] = 33
    cols = ["id", "date", "price", "bedrooms", "bathrooms", "sqft_living",
            "sqft_lot", "floors", "waterfront", "view", "condition", "grade",
            "sqft_above", "sqft_basement", "yr_built", "yr_renovated",
            "zipcode", "lat", "long", "sqft_living15", "sqft_lot15"]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for i in range(n):
            row = []
            for c in cols:
                if c == "id":
                    row.append(7129300520 + i)
                elif c == "date":
                    row.append(f"2014{1 + i % 12:02d}13T000000")
                elif c == "zipcode":
                    row.append(98000 + rng.randint(200))
                elif c in ("lat", "long"):
                    row.append(f"{table[c][i]:.4f}")
                elif c == "price":
                    row.append(f"{round(table[c][i], -2):.1f}")
                else:
                    row.append(repr(table[c][i].item()))
            w.writerow(row)


@pytest.mark.parametrize("part", PARTS)
def test_csv_path_equals_jax_bit_for_bit(tmp_path, part):
    path = tmp_path / "kc_house_data.csv"
    _write_fixture(path)
    want = _parts(jkc.load_kc_house(str(path), seed=3))
    got = _parts(pkc.load_kc_house(str(path), seed=3))
    np.testing.assert_array_equal(got[part], want[part])
    assert got[part].dtype == want[part].dtype


def test_csv_reader_drops_id_date_zipcode_and_clips_bedrooms(tmp_path):
    path = tmp_path / "kc.csv"
    _write_fixture(path)
    table = pkc.read_csv(str(path))
    assert not {"id", "date", "zipcode"} & set(table)
    assert table["bedrooms"].max() == 33
    _, _, stats, _, _ = pkc.load_kc_house(str(path))
    assert stats.data_max[0] <= 8


def test_environment_variable_names_the_csv(tmp_path, monkeypatch):
    path = tmp_path / "elsewhere.csv"
    _write_fixture(path)
    monkeypatch.setenv("CFGAN_KC_HOUSE_CSV", str(path))
    assert pkc.resolve_csv(None) == str(path)
    assert pkc.resolve_csv(str(tmp_path / "missing.csv")) == str(path)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quartile_classes_equal_pandas_qcut(seed):
    rng = np.random.RandomState(seed)
    price = np.exp(rng.normal(13, 0.5, 1001)).round(-2)
    price[:7] = price.min()  # ties at the lowest edge
    cls, bins = pkc.quartile_classes(price)
    want, want_bins = pd.qcut(price, q=4, labels=[0, 1, 2, 3], retbins=True,
                              duplicates="drop")
    np.testing.assert_array_equal(bins, want_bins)
    np.testing.assert_array_equal(cls, np.asarray(want).astype(int))


@pytest.mark.parametrize("n,fraction,seed", [(21613, 0.2, 42), (101, 0.3, 7)])
def test_shuffle_split_equals_train_test_split(n, fraction, seed):
    itr, ite = pkc.shuffle_split(n, fraction, seed)
    want_tr, want_te = train_test_split(np.arange(n), test_size=fraction,
                                        random_state=seed)
    np.testing.assert_array_equal(itr, want_tr)
    np.testing.assert_array_equal(ite, want_te)


@pytest.mark.parametrize("prop", ["input_dim", "immutable_idx",
                                  "categorical_idx", "categorical_info",
                                  "continuous_idx"])
def test_schema_matches_jax(prop):
    assert getattr(pkc.KC_SCHEMA, prop) == getattr(jkc.KC_SCHEMA, prop)


def test_norm_stats_metadata_round_trip():
    rng = np.random.RandomState(0)
    x = rng.uniform(-5, 50, (40, 6))
    x[:, 2] = 3.0  # a constant feature divides by 1
    ours = fit_minmax(x)
    theirs = JaxNormStats.from_metadata(ours.to_metadata())
    back = NormStats.from_metadata(theirs.to_metadata())
    for a, b in zip(ours, back):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(ours.transform(x),
                                  np.asarray(theirs.transform(x)))
    for fidx in range(6):
        vals = np.linspace(-1, 9, 5)
        np.testing.assert_array_equal(ours.normalize_values(fidx, vals),
                                      theirs.normalize_values(fidx, vals))
