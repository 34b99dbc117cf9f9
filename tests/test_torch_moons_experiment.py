"""The port's moons CounteRGAN experiment (`cfgan_torch.experiments.
moons_countergan`) end to end on the CPU at the shipped preset's full
width: `main()` with `--device cpu --epochs 2 --clf-steps 20` writes the
JAX package's run dir, which the JAX package's provenance check accepts
and which a rerun loads without training; `run()` on a copy of the
committed `results/moons_countergan/` (its classifier and generator)
trains nothing and writes the CSVs that the JAX package's
`per_target_metrics` computes on the same weights (flip rates equal, the
other numbers within 1e-6); the snapshot ladder; and the reference
preset, which serves the live generator.
"""
import csv
import shutil
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfgan_torch.experiments.moons_countergan as exp
from cfgan.core import checkpoint as jckpt
from cfgan.core import provenance as jprov
from cfgan.data.moons import load_moons3 as jax_load_moons3
from cfgan.eval.metrics import make_per_target_sweep as jax_sweep
from cfgan.eval.metrics import per_target_metrics as jax_metrics
from cfgan.experiments import presets as jax_presets
from cfgan.models.classifiers import MLPClassifier as JaxMLP
from cfgan.train.builders import build_moons_countergan as jax_build
from cfgan.train.state import NetState as JaxNetState
from cfgan.train.state import adam_like_torch as jax_adam
from cfgan_torch.core import checkpoint as ckpt
from cfgan_torch.eval.metrics import TABULAR_PROTOCOL
from cfgan_torch.experiments import presets

from test_torch_figure import TRAINED_ONLY, figure_set, jax_figure_set

ROOT = Path(__file__).resolve().parent.parent
COMMITTED = ROOT / "results" / "moons_countergan"
COLUMNS = ("class_flip_rate", "prediction_gain", "avg_actionability")
FILES = ("classifier/checkpoint.msgpack", "classifier/metadata.json",
         "classifier_eval/confusion_matrix.csv",
         "classifier_eval/classifier_report.txt",
         "generator/checkpoint.msgpack", "generator/metadata.json",
         "train_state/checkpoint.msgpack", "train_state/metadata.json",
         "countergan_metrics.csv", "countergan_metrics_per_mask.csv",
         "run_provenance.json")
TRAINED = ("[Classifier]", "[CounteRGAN]")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """`main()` as the acceptance command runs it, then `run()` again on
    the same directory."""
    out = tmp_path_factory.mktemp("moons")
    exp.main(["--device", "cpu", "--epochs", "2", "--clf-steps", "20",
              "--out-dir", str(out)])
    texts = {n: (out / n).read_text() for n in (
        "countergan_metrics.csv", "countergan_metrics_per_mask.csv")}
    gen = (out / "generator" / "checkpoint.msgpack").read_bytes()
    lines = []
    cfg = presets.MOONS_COUNTERGAN
    cfg = cfg.replace(classifier=replace(cfg.classifier, steps=20),
                      countergan=replace(cfg.countergan, epochs=2))
    second = exp.run(cfg, out_dir=str(out), device="cpu", log=lines.append)
    return out, texts, gen, second, lines


def test_main_writes_the_jax_run_dir(cli_run):
    out = cli_run[0]
    for name in FILES:
        assert (out / name).is_file(), name
    rec = jprov.check_run_provenance(str(out))
    assert rec["preset"] == "moons_countergan" and rec["seed"] == 42
    assert rec["serving_candidate"] == "snapshot_e2_live"
    assert set(ckpt.load_metadata(str(out / "classifier"))) == {"stats"}
    rows = _rows(out / "countergan_metrics.csv")
    assert [r["target_class"] for r in rows] == ["0", "1", "2"]
    per_mask = _rows(out / "countergan_metrics_per_mask.csv")
    assert list(per_mask[0]) == ["mask", "target_class", *COLUMNS]
    assert [r["mask"] for r in per_mask] == [
        m for m in ("both", "x_only", "y_only", "none") for _ in range(3)]
    assert per_mask[:3] == [{"mask": "both", **r} for r in rows]
    # with nothing modifiable the residual is 0 and x_cf is x
    assert all(float(r["avg_actionability"]) == 0.0 for r in per_mask[-3:])


def test_rerun_trains_nothing_and_writes_the_same_csvs(cli_run):
    out, texts, gen, second, lines = cli_run
    assert second["history"] == {}
    assert not any(t in ln for ln in lines for t in TRAINED)
    for name, text in texts.items():
        assert (out / name).read_text() == text
    assert (out / "generator" / "checkpoint.msgpack").read_bytes() == gen
    jprov.check_run_provenance(str(out))


def test_snapshot_ladder_scores_the_live_generator(tmp_path):
    cfg = presets.MOONS_COUNTERGAN
    cfg = cfg.replace(classifier=replace(cfg.classifier, steps=10),
                      countergan=replace(cfg.countergan, epochs=4,
                                         snapshot_every=2))
    res = exp.run(cfg, out_dir=str(tmp_path), device="cpu",
                  log=lambda s: None)
    ladder = res["serving_selection"]["ladder"]
    assert [(r["epoch"], r["candidate"]) for r in ladder] == [
        (2, "live"), (4, "live")]
    # three sorted per-target flips, then their mean
    assert all(len(r["score"]) == 4 and r["score"][:3] == sorted(
        r["score"][:3]) for r in ladder)
    assert res["bundle"].state.step == 4 * 15
    assert len(res["history"]["d_loss"]) == 4


def test_reference_preset_serves_the_live_generator(tmp_path):
    exp.main(["--device", "cpu", "--epochs", "1", "--clf-steps", "5",
              "--reference", "--out-dir", str(tmp_path)])
    meta = ckpt.load_metadata(str(tmp_path / "generator"))
    assert meta["serving_selection"] == {"candidate": "live", "scores": {}}
    assert jprov.check_run_provenance(str(tmp_path))["preset"] == \
        "moons_countergan_reference"


def _jax_metrics(run_dir):
    """The JAX package's per-target metrics of a run dir's weights on the
    test split: all-ones, then each mask policy."""
    (_, _), (xte, yte), _ = jax_load_moons3()
    template = JaxMLP().init(jax.random.key(0), jnp.zeros((2, 2)))
    clf_vars = jckpt.restore(str(run_dir / "classifier"), dict(template))
    bundle = jax_build(jax_presets.MOONS_COUNTERGAN.countergan, JaxMLP(),
                       JaxNetState.create(clf_vars, jax_adam(1e-2)))
    g_vars = jckpt.restore(str(run_dir / "generator"),
                           dict(bundle.state.g.variables()))
    sweep = jax_sweep(bundle.cf_fn,
                      lambda x: JaxMLP().apply(clf_vars, x), 3,
                      **TABULAR_PROTOCOL)
    out = {}
    for name, row in exp.MASK_POLICIES.items():
        out[name] = jax_metrics(
            sweep, g_vars, xte, yte,
            mask_fn=lambda b, r=row: jnp.broadcast_to(
                jnp.asarray(r, jnp.float32), (b, 2)),
            key=jax.random.key(42), num_classes=3)
    return out


def assert_rows_match(rows, want):
    assert [int(r["target_class"]) for r in rows] == list(
        want["target_class"])
    for r, (_, w) in zip(rows, want.iterrows()):
        assert float(r["class_flip_rate"]) == w["class_flip_rate"]
        for col in COLUMNS[1:]:
            assert abs(float(r[col]) - w[col]) <= 1e-6, col


@pytest.fixture(scope="module")
def committed_copy(tmp_path_factory):
    out = tmp_path_factory.mktemp("moons_committed")
    for part in ("classifier", "generator"):
        shutil.copytree(COMMITTED / part, out / part)
    lines = []
    res = exp.run(presets.MOONS_COUNTERGAN, out_dir=str(out), device="cpu",
                  log=lines.append)
    return out, res, lines


def test_committed_run_dir_loads_and_trains_nothing(committed_copy):
    out, res, lines = committed_copy
    assert res["history"] == {}
    assert not any(t in ln for ln in lines for t in TRAINED)
    assert res["serving_selection"]["candidate"] == "snapshot_e50_live"
    assert not (out / "train_state").exists()
    rec = jprov.check_run_provenance(str(out))
    assert rec["serving_candidate"] == "snapshot_e50_live"
    # the committed classifier's test accuracy, as the JAX run recorded it
    assert rec["classifier_test_accuracy"] == jprov.check_run_provenance(
        str(COMMITTED))["classifier_test_accuracy"]


def test_committed_run_dir_csvs_equal_jax_per_target_metrics(committed_copy):
    out, _, _ = committed_copy
    want = _jax_metrics(COMMITTED)
    assert_rows_match(_rows(out / "countergan_metrics.csv"), want["both"])
    per_mask = _rows(out / "countergan_metrics_per_mask.csv")
    for i, name in enumerate(exp.MASK_POLICIES):
        rows = per_mask[3 * i:3 * i + 3]
        assert {r.pop("mask") for r in rows} == {name}
        assert_rows_match(rows, want[name])


def test_jax_restores_the_port_run_dir(cli_run):
    """The port's classifier and generator restore in the JAX package,
    and its metrics there are the port's CSV."""
    out = cli_run[0]
    want = _jax_metrics(out)
    assert_rows_match(_rows(out / "countergan_metrics.csv"), want["both"])


def test_restored_variables_keep_the_module_layout(committed_copy):
    """The served variables restored from the run dir lie as the module's
    own tensors do (contiguous): cuBLAS picks its kernel by layout, and
    on the card a transposed kernel rounded a rerun's counterfactuals
    1.2e-7 away from the first run's, so its CSVs changed."""
    _, res, _ = committed_copy
    own = res["bundle"].state.g.model.state_dict()
    assert res["g_vars"].keys() == own.keys()
    for k, v in res["g_vars"].items():
        assert v.is_contiguous() and v.stride() == own[k].stride(), k


def test_run_dir_holds_the_jax_run_dirs_figures(cli_run, committed_copy):
    """The committed JAX run dir's figures, by name and folder; `run()` on
    a copy of the committed run dir (nothing trained) draws all but the
    loss curves."""
    want = jax_figure_set("moons_countergan")
    assert figure_set(cli_run[0]) == want
    assert figure_set(committed_copy[0]) == (
        want - TRAINED_ONLY["moons_countergan"])
