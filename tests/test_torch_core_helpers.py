"""The port's small core helpers against the JAX package's, on the CPU:
`TabularSchema.from_dataframe` (on one pandas DataFrame), the
module-level `replace` and `to_dict`,
`ExperimentConfig.schema`, the serving engine's `stats`, `MetricLogger`
(its history, JSONL records and printed lines, `time` left out),
`image_normalize` / `image_denormalize` (uint8 and float inputs, bit for
bit), and the profiling hooks `trace`, `annotate` and `StepTimer`.
"""
import json
import math
import time

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cfgan.core import config as jconfig
from cfgan.core.logging import MetricLogger as JaxMetricLogger
from cfgan.data.transforms import image_denormalize as jax_denormalize
from cfgan.data.transforms import image_normalize as jax_normalize
from cfgan.experiments import presets as jax_presets
from cfgan_torch.core import config as C
from cfgan_torch.core.logging import MetricLogger
from cfgan_torch.core.profiling import StepTimer, annotate, trace
from cfgan_torch.data.transforms import (
    NormStats,
    fit_minmax,
    image_denormalize,
    image_normalize,
)
from cfgan_torch.serve.engine import CounterfactualEngine


def _table():
    rng = np.random.RandomState(0)
    return pd.DataFrame({
        "income": rng.lognormal(10, 0.5, 200),
        "age": rng.randint(21, 75, 200).astype(float),
        "grade": rng.randint(1, 6, 200),
        "flag": (rng.uniform(size=200) < 0.3).astype(float),
        "id": np.arange(200),
        "label": rng.randint(0, 3, 200)})


FROM_DATAFRAME_CASES = {
    "inferred": dict(immutable=("age",), exclude=("id", "label")),
    "cardinality": dict(max_categorical_cardinality=2, exclude=("label",)),
    "names": dict(categorical=["grade", "flag"], exclude=("id",)),
    "mapping": dict(categorical={"grade": (1, 2, 3, 4, 5)},
                    immutable=("age", "flag")),
    "none": dict(categorical=(), exclude=("id", "label")),
    "all": dict(),
}


@pytest.mark.parametrize("case", sorted(FROM_DATAFRAME_CASES))
def test_from_dataframe_matches_jax(case):
    kw = FROM_DATAFRAME_CASES[case]
    df = _table()
    want = jconfig.TabularSchema.from_dataframe(df, **kw)
    got = C.TabularSchema.from_dataframe(df, **kw)
    assert got.feature_names == want.feature_names
    assert got.immutable_features == want.immutable_features
    assert dict(got.categorical_values) == dict(want.categorical_values)
    assert all(type(v) is float for vs in got.categorical_values.values()
               for v in vs)
    assert got.categorical_idx == want.categorical_idx
    assert got.continuous_idx == want.continuous_idx


@pytest.mark.parametrize("kw,error,what", [
    (dict(immutable=("height",)), ValueError, "immutable feature 'height'"),
    (dict(immutable=("id",), exclude=("id",)), ValueError,
     "immutable feature 'id'"),
    (dict(categorical={"label": (0, 1)}, exclude=("label",)), ValueError,
     "categorical feature 'label'"),
    # a listed column the table lacks fails on reading it, in both
    (dict(categorical=["height"]), KeyError, "height")])
def test_from_dataframe_rejects_what_jax_rejects(kw, error, what):
    df = _table()
    with pytest.raises(error, match=what):
        jconfig.TabularSchema.from_dataframe(df, **kw)
    with pytest.raises(error, match=what):
        C.TabularSchema.from_dataframe(df, **kw)


def test_replace_and_to_dict_match_jax():
    got = C.to_dict(C.replace(C.MNIST_COUNTERGAN, hidden_dim=12))
    want = jconfig.to_dict(jconfig.replace(
        jax_presets.MNIST_COUNTERGAN.countergan, hidden_dim=12))
    assert got == want
    assert got["hidden_dim"] == 12 and C.MNIST_COUNTERGAN.hidden_dim == 64
    assert isinstance(got["mask"], dict)


def test_experiment_config_carries_a_schema():
    schema = C.TabularSchema.from_dataframe(_table(), exclude=("id",))
    cfg = C.ExperimentConfig()
    assert cfg.schema is None and jconfig.ExperimentConfig().schema is None
    with_schema = C.replace(cfg, schema=schema)
    assert with_schema.schema is schema
    assert cfg.replace(schema=schema) == with_schema
    assert C.to_dict(with_schema)["schema"]["feature_names"] == \
        schema.feature_names


def test_engine_carries_its_stats():
    """The engine keeps `stats` for its callers (the JAX house app maps
    counterfactuals back to the features' units through
    `engine.stats.inverse_transform`), as JAX's engine does."""
    stats = fit_minmax(np.random.RandomState(0).rand(20, 3).astype(
        np.float32) * 10)

    def cf_fn(x, target, mask, key=None):
        return x, x * 0, x * 0

    def clf_fn(x):
        return torch.zeros((x.shape[0], 2))

    engine = CounterfactualEngine(cf_fn, clf_fn, 2, device="cpu",
                                  stats=stats)
    assert engine.stats is stats
    assert CounterfactualEngine(cf_fn, clf_fn, 2, device="cpu").stats is None
    x = np.array([[0.5, 0.25, 1.0]], np.float32)
    np.testing.assert_allclose(engine.stats.inverse_transform(x),
                               x * stats.data_range + stats.data_min)


def test_house_engine_carries_the_bundles_stats():
    from cfgan_torch.models.classifiers import TabularClassifier
    from cfgan_torch.train.builders import (
        build_tabular_countergan,
        house_engine,
    )

    schema = C.TabularSchema(feature_names=("a", "b", "c"),
                             immutable_features=("a",),
                             categorical_values={"c": (0.0, 1.0)})
    stats = NormStats(np.zeros(3, np.float32), np.full(3, 2.0, np.float32))
    cfg = C.replace(C.HOUSE_COUNTERGAN_REFERENCE, hidden_dim=8,
                    num_res_blocks=1)
    bundle = build_tabular_countergan(
        cfg, TabularClassifier(2, 3).state_dict(), schema, stats,
        num_classes=2, device="cpu")
    assert bundle.stats is stats and bundle.schema is schema
    engine = house_engine(bundle, lambda x: torch.zeros((x.shape[0], 2)),
                          device="cpu")
    assert engine.stats is stats and engine.schema is schema


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_metric_logger_writes_jax_records(tmp_path, capsys):
    steps = [(0, {"d_loss": 1.25, "g_loss": np.float32(0.5)}),
             (1, {"d_loss": 0.75, "flip": np.array(0.125)}),
             (2, {"d_loss": 0.5, "g_loss": 1.0})]
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jlog = JaxMetricLogger(str(jax_dir), name="gan", print_every=2)
    plog = MetricLogger(str(port_dir), name="gan", print_every=2)
    for step, metrics in steps:
        jlog.log(step, {k: jnp.asarray(v) for k, v in metrics.items()},
                 prefix="p" if step == 2 else "")
        jax_printed = capsys.readouterr().out
        plog.log(step, {k: torch.tensor(float(v)) if k == "d_loss" else v
                        for k, v in metrics.items()},
                 prefix="p" if step == 2 else "")
        assert capsys.readouterr().out == jax_printed
    jlog.close()
    plog.close()
    plog.close()  # a second close is harmless
    want, got = (_records(d / "gan_metrics.jsonl")
                 for d in (jax_dir, port_dir))
    assert [list(r) for r in got] == [list(r) for r in want]
    assert all(r["time"] >= 0 for r in got)
    strip = [[{k: v for k, v in r.items() if k != "time"} for r in recs]
             for recs in (got, want)]
    assert strip[0] == strip[1]
    assert [{k: v for k, v in r.items() if k != "time"}
            for r in plog.history] == strip[0]
    np.testing.assert_array_equal(plog.series("g_loss"), jlog.series("g_loss"))
    np.testing.assert_array_equal(plog.series("flip"), [0.125])


def test_metric_logger_without_a_directory_keeps_the_history(capsys):
    log = MetricLogger(print_every=0)
    log.log(3, {"loss": 2.0})
    assert capsys.readouterr().out == ""
    assert log.history[0]["step"] == 3 and log.history[0]["loss"] == 2.0


@pytest.mark.parametrize("dtype", ["uint8", "float32", "float64"])
def test_image_normalize_matches_jax(dtype):
    rng = np.random.RandomState(1)
    if dtype == "uint8":
        x = rng.randint(0, 256, (4, 5, 5, 1)).astype(np.uint8)
    else:
        x = rng.uniform(0, 1, (4, 5, 5, 1)).astype(dtype)
    for kw in ({}, {"mean": 0.1307, "std": 0.3081}):
        got, want = image_normalize(x, **kw), np.asarray(jax_normalize(x,
                                                                       **kw))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        back, want_back = (image_denormalize(got, **kw),
                           np.asarray(jax_denormalize(want, **kw)))
        assert back.dtype == np.float32
        np.testing.assert_array_equal(back, want_back)
    assert image_normalize(np.array([0, 255], np.uint8)).tolist() == [-1, 1]


def test_step_timer_on_the_cpu():
    timer = StepTimer(items_per_step=8)
    with timer.measure():
        out = None
        for _ in range(3):
            out = torch.ones(16) * 2
        assert timer.fence({"out": out, "more": [out]})["out"] is out
        time.sleep(0.01)
    assert timer.elapsed >= 0.01
    assert math.isclose(timer.items_per_sec(3), 8 * timer.steps_per_sec(3))
    assert StepTimer().steps_per_sec(1) == math.inf


def test_trace_writes_the_annotated_ranges(tmp_path):
    with trace(str(tmp_path / "tb")):
        with annotate("cfgan_step"):
            (torch.randn(8, 8) @ torch.randn(8, 8)).sum()
    files = list((tmp_path / "tb").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "cfgan_step" for e in events)
