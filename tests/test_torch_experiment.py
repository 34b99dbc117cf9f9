"""The port's MNIST CounteRGAN experiment (cfgan_torch.experiments.
mnist_countergan.run) end to end on the CPU, torch only: the 120-image
IDX fixture, the shipped preset at width 8 with one residual block,
batch 16, one classifier epoch and two GAN epochs (snapshot rungs at
epoch 2), float32.

It checks the run dir the JAX package writes (classifier, generator with
its serving-selection record, train_state, classifier_eval and the three
metrics CSVs), and that a second run on the same directory loads every
stage instead of training it: the generator checkpoint keeps its bytes
and the per-target CSV comes out the same.
"""
import csv
import json
import shutil
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import cfgan_torch.experiments.mnist_countergan as exp
from cfgan_torch.experiments.presets import MNIST_COUNTERGAN

from test_torch_figure import TRAINED_ONLY, figure_set, jax_figure_set


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU run shares its cores with other test workers: one torch
    thread keeps this file's many small eager ops from oversubscribing
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIXTURE = str(Path(__file__).resolve().parent / "fixtures" / "mnist_idx")
CFG = MNIST_COUNTERGAN.replace(
    data=replace(MNIST_COUNTERGAN.data, path=FIXTURE, batch_size=16),
    classifier=replace(MNIST_COUNTERGAN.classifier, epochs=1, batch_size=32),
    countergan=replace(MNIST_COUNTERGAN.countergan, epochs=2, hidden_dim=8,
                       num_res_blocks=1, compute_dtype="float32"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mnist_countergan")
    first = exp.run(CFG, out_dir=str(out), device="cpu", log=lambda s: None)
    gen_bytes = (out / "generator" / "checkpoint.msgpack").read_bytes()
    per_target = (out / "countergan_metrics_per_class.csv").read_text()
    lines = []
    second = exp.run(CFG, out_dir=str(out), device="cpu", log=lines.append)
    return out, first, second, gen_bytes, per_target, lines


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_run_writes_the_jax_run_dir(runs):
    out, first, _, _, _, _ = runs
    for d in ("classifier", "generator", "train_state"):
        assert (out / d / "checkpoint.msgpack").is_file(), d
    for f in ("classifier_eval/confusion_matrix.csv",
              "classifier_eval/classifier_report.txt",
              "countergan_metrics.csv", "countergan_metrics_per_class.csv",
              "masked_metrics.csv", "train_state/metadata.json"):
        assert (out / f).is_file(), f
    per_target = _rows(out / "countergan_metrics_per_class.csv")
    assert [r["target_class"] for r in per_target] == [str(i)
                                                       for i in range(10)]
    assert list(per_target[0]) == ["target_class", "class_flip_rate",
                                   "prediction_gain", "avg_actionability"]
    assert all(np.isfinite(float(r[k])) for r in per_target for k in r)
    batch = _rows(out / "countergan_metrics.csv")
    assert list(batch[0]) == ["class_flip_rate", "prediction_gain",
                              "actionability"]
    masked = _rows(out / "masked_metrics.csv")
    assert [r["mask_policy"] for r in masked] == ["shared", "per_sample"]
    meta = json.loads((out / "train_state" / "metadata.json").read_text())
    assert meta["epoch"] == 1 and len(meta["history"]["d_loss"]) == 2
    assert set(first["stage_seconds"]) == {"data", "classifier", "countergan",
                                           "selection", "eval"}


def test_serving_selection_record(runs):
    out, first, _, _, _, _ = runs
    sel = json.loads((out / "generator" / "metadata.json").read_text())[
        "serving_selection"]
    assert sel == json.loads(json.dumps(first["serving_selection"]))
    ladder = sel["ladder"]
    assert [(r["epoch"], r["candidate"]) for r in ladder] == [
        (2, "live"), (2, "ema_recal_train"), (2, "ema_recal_ones")]
    assert all(len(r["score"]) == 11 for r in ladder)  # 10 flips + mean
    best = max(ladder, key=lambda r: r["score"])
    assert sel["candidate"] == f"snapshot_e{best['epoch']}_{best['candidate']}"


def test_rerun_loads_every_stage_and_gives_the_same_csv(runs):
    out, _, second, gen_bytes, per_target, lines = runs
    assert (out / "generator" / "checkpoint.msgpack").read_bytes() == \
        gen_bytes
    assert (out / "countergan_metrics_per_class.csv").read_text() == \
        per_target
    assert any(ln.startswith("Loaded classifier") for ln in lines)
    assert any(ln.startswith("Loaded generator") for ln in lines)
    assert not any("[CounteRGAN] epoch" in ln for ln in lines)
    assert second["history"] == {}


def test_main_parses_the_jax_flags(monkeypatch):
    seen = {}
    monkeypatch.setattr(exp, "run", lambda cfg, **kw: seen.update(cfg=cfg,
                                                                  **kw))
    exp.main(["--epochs", "3", "--clf-epochs", "2", "--limit", "320",
              "--seed", "5", "--out-dir", "d", "--fresh", "--device", "cpu"])
    cfg = seen["cfg"]
    assert (cfg.countergan.epochs, cfg.classifier.epochs, cfg.seed) == (3, 2,
                                                                        5)
    assert seen["limit"] == 320 and seen["out_dir"] == "d"
    assert seen["fresh"] and seen["device"] == "cpu"
    assert cfg.countergan.hidden_dim == 64  # the shipped preset


def _fields(obj, prefix=""):
    from dataclasses import fields, is_dataclass

    out = {}
    for f in fields(obj):
        v = getattr(obj, f.name)
        out.update(_fields(v, f"{prefix}{f.name}.") if is_dataclass(v)
                   else {f"{prefix}{f.name}": v})
    return out


@pytest.mark.parametrize("name", ["MNIST_COUNTERGAN",
                                  "MNIST_COUNTERGAN_REFERENCE"])
def test_presets_equal_the_jax_presets(name):
    """Every field of the port's experiment preset equals the JAX preset's;
    the JAX fields the port has no counterpart for are at their defaults
    there, so the port drops no setting."""
    import cfgan.experiments.presets as jax_presets
    from cfgan.core.config import ExperimentConfig as JaxExperiment

    import cfgan_torch.core.config as pconfig
    import cfgan_torch.experiments.presets as presets

    got, want = (_fields(getattr(m, name)) for m in (presets, jax_presets))
    defaults = _fields(JaxExperiment(gan=None))
    assert got.keys() <= want.keys()
    for key, value in want.items():
        if key in got:
            assert got[key] == value, key
        else:
            assert value == defaults.get(key), key
    assert getattr(pconfig, name) == getattr(presets, name).countergan


def test_run_dir_holds_the_jax_run_dirs_figures(runs, tmp_path):
    """The committed JAX run dir's figures, by name and folder; a rerun
    that trains nothing draws all but the training curves again."""
    out = runs[0]
    want = jax_figure_set("mnist_countergan_seed43")
    assert figure_set(out) == want
    copy = tmp_path / "copy"
    shutil.copytree(out, copy, ignore=shutil.ignore_patterns("*.png"))
    exp.run(CFG, out_dir=str(copy), device="cpu", log=lambda s: None)
    assert figure_set(copy) == want - TRAINED_ONLY["mnist_countergan_seed43"]
