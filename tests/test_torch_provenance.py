"""The port's run-dir provenance (`cfgan_torch.core.provenance`) against
the JAX package's (`cfgan.core.provenance`): each accepts the other's
records, both reject a tampered CSV and an invalidated dir, and the run
dirs the port's three experiments write (moons, MNIST at width 8 on the
IDX fixture, house at width 8 on 600 rows) pass the JAX package's check
and `tools/check_provenance.py`.
"""
import json
import shutil
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import pytest
import torch

from cfgan.core import provenance as jprov
from cfgan_torch.core import provenance as pprov

ROOT = Path(__file__).resolve().parent.parent
COMMITTED = ["moons_countergan", "house_countergan", "mnist_countergan_seed43"]
FIXTURE = str(ROOT / "tests" / "fixtures" / "mnist_idx")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", COMMITTED)
def test_port_accepts_the_committed_run_dirs(name):
    run = str(ROOT / "results" / name)
    assert pprov.check_run_provenance(run) == jprov.check_run_provenance(run)
    assert pprov.serving_candidate_of(run) == jprov.serving_candidate_of(run)


def _copy(name, dst):
    """A committed run dir's generator metadata, per-target CSV and
    provenance record under `dst`."""
    src = ROOT / "results" / name
    rec = json.loads((src / pprov.PROVENANCE_FILE).read_text())
    (dst / "generator").mkdir(parents=True)
    shutil.copy(src / "generator" / "metadata.json", dst / "generator")
    shutil.copy(src / rec["per_target_csv"], dst)
    shutil.copy(src / pprov.PROVENANCE_FILE, dst)
    return rec


@pytest.mark.parametrize("name", COMMITTED)
def test_port_record_is_the_jax_record(name, tmp_path):
    """The same arguments write the same record in either package, in the
    same layout.  The JAX package reads the CSV with pandas, whose default
    parser rounds some 17-digit decimals one ulp away from the nearest
    float (the house CSV's 0.9935424354243543); Python's `float` rounds
    them correctly, so the flip floor and mean are held within 1e-15."""
    rec = _copy(name, tmp_path / "p")
    _copy(name, tmp_path / "j")
    extra = {k: v for k, v in rec.items() if k not in (
        "preset", "seed", "serving_candidate", "selection_scores",
        "per_target_csv", "flip_column", "per_target_flip_min",
        "per_target_flip_mean")}
    for mod, d in ((pprov, tmp_path / "p"), (jprov, tmp_path / "j")):
        mod.write_run_provenance(str(d), rec["preset"], rec["seed"],
                                 rec["serving_candidate"],
                                 rec["selection_scores"],
                                 per_target_csv=rec["per_target_csv"],
                                 extra=extra)
    got, want = ((d / pprov.PROVENANCE_FILE).read_text()
                 for d in (tmp_path / "p", tmp_path / "j"))
    assert got.splitlines()[:5] == want.splitlines()[:5]
    got, want = json.loads(got), json.loads(want)
    assert list(got) == list(want)
    for k, v in want.items():
        if k in ("per_target_flip_min", "per_target_flip_mean"):
            assert abs(got[k] - v) <= 1e-15, k
        else:
            assert got[k] == v, k
    assert jprov.check_run_provenance(str(tmp_path / "p"))


@pytest.mark.parametrize("check", [pprov.check_run_provenance,
                                   jprov.check_run_provenance],
                         ids=["port", "jax"])
def test_a_tampered_csv_is_rejected(check, tmp_path):
    rec = _copy("moons_countergan", tmp_path)
    check(str(tmp_path))
    path = tmp_path / rec["per_target_csv"]
    lines = path.read_text().splitlines()
    lines[1] = lines[1].replace(",1.0,", ",0.99,", 1)
    path.write_text("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match="changed after"):
        check(str(tmp_path))


@pytest.mark.parametrize("check", [pprov.check_run_provenance,
                                   jprov.check_run_provenance],
                         ids=["port", "jax"])
def test_an_invalidated_dir_is_rejected(check, tmp_path):
    _copy("house_countergan", tmp_path)
    pprov.invalidate_run_provenance(str(tmp_path), "reselected")
    assert (tmp_path / "STALE.txt").read_text() == "reselected\n"
    with pytest.raises(ValueError, match="no run_provenance.json"):
        check(str(tmp_path))


@pytest.mark.parametrize("check", [pprov.check_run_provenance,
                                   jprov.check_run_provenance],
                         ids=["port", "jax"])
def test_another_served_candidate_is_rejected(check, tmp_path):
    _copy("mnist_countergan_seed43", tmp_path)
    meta_path = tmp_path / "generator" / "metadata.json"
    meta = json.loads(meta_path.read_text())
    meta["serving_selection"]["candidate"] = "live"
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="stale artifacts"):
        check(str(tmp_path))


def test_empty_and_nan_entries_are_missing_as_for_pandas(tmp_path):
    """A target without rows writes an empty flip rate (and a hand-edited
    CSV may say nan): both packages leave it out of the floor and mean."""
    (tmp_path / "m.csv").write_text(
        "target_class,class_flip_rate\n0,0.5\n1,\n2,nan\n3,0.75\n")
    recs = [mod.write_run_provenance(str(tmp_path), "p", 0, None,
                                     per_target_csv="m.csv")
            for mod in (pprov, jprov)]
    assert recs[0] == recs[1]
    assert recs[0]["per_target_flip_min"] == 0.5
    assert recs[0]["per_target_flip_mean"] == 0.625
    assert pprov.check_run_provenance(str(tmp_path))["serving_candidate"] \
        is None


# ----------------------------------------------- the port's run dirs
@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Run dirs of the port's three experiments, small."""
    import cfgan_torch.experiments.house_countergan as house
    import cfgan_torch.experiments.mnist_countergan as mnist
    import cfgan_torch.experiments.moons_countergan as moons
    from cfgan_torch.experiments import presets

    quiet = dict(device="cpu", log=lambda s: None)
    out = {}
    m = presets.MOONS_COUNTERGAN
    out["moons"] = tmp_path_factory.mktemp("moons")
    moons.run(m.replace(classifier=replace(m.classifier, steps=20),
                        countergan=replace(m.countergan, epochs=2)),
              out_dir=str(out["moons"]), **quiet)
    m = presets.MNIST_COUNTERGAN
    out["mnist"] = tmp_path_factory.mktemp("mnist")
    mnist.run(m.replace(
        data=replace(m.data, path=FIXTURE, batch_size=16),
        classifier=replace(m.classifier, epochs=1, batch_size=32),
        countergan=replace(m.countergan, epochs=2, hidden_dim=8,
                           num_res_blocks=1, compute_dtype="float32")),
        out_dir=str(out["mnist"]), **quiet)
    m = presets.HOUSE_COUNTERGAN
    out["house"] = tmp_path_factory.mktemp("house")
    house.run(m.replace(
        classifier=replace(m.classifier, epochs=1),
        countergan=replace(m.countergan, epochs=2, hidden_dim=8,
                           num_res_blocks=2, snapshot_every=1)),
        out_dir=str(out["house"]), limit=600, **quiet)
    return out


@pytest.mark.parametrize("family", ["moons", "mnist", "house"])
def test_jax_accepts_the_port_run_dirs(port_runs, family):
    run = str(port_runs[family])
    rec = jprov.check_run_provenance(run)
    assert rec == pprov.check_run_provenance(run)
    assert rec["serving_candidate"] == jprov.serving_candidate_of(run)
    assert rec["serving_candidate"].startswith("snapshot_e")
    assert rec["flip_column"] == "class_flip_rate"
    assert rec["per_target_csv"] == {
        "mnist": "countergan_metrics_per_class.csv"}.get(
        family, "countergan_metrics.csv")
    want_extra = {"classifier_test_accuracy"} | (
        {"batch_flip_rate"} if family == "mnist" else set())
    assert want_extra <= set(rec)
    assert not (port_runs[family] / "STALE.txt").exists()


def test_check_provenance_tool_passes_the_port_run_dirs(port_runs, tmp_path):
    root = tmp_path / "results"
    for family, run in port_runs.items():
        shutil.copytree(run, root / family)
    proc = subprocess.run([sys.executable, str(ROOT / "tools" /
                                                "check_provenance.py"),
                           "--results", str(root), "--strict"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("  ok ") == 3


def test_a_rerun_clears_the_stale_mark(port_runs):
    """An evaluation after an invalidation writes the record again and
    removes STALE.txt, as the JAX mains do."""
    import cfgan_torch.experiments.moons_countergan as moons
    from cfgan_torch.experiments import presets

    run = port_runs["moons"]
    pprov.invalidate_run_provenance(str(run), "reselected")
    with pytest.raises(ValueError):
        jprov.check_run_provenance(str(run))
    m = presets.MOONS_COUNTERGAN
    moons.run(m.replace(classifier=replace(m.classifier, steps=20),
                        countergan=replace(m.countergan, epochs=2)),
              out_dir=str(run), device="cpu", log=lambda s: None)
    assert not (run / "STALE.txt").exists()
    jprov.check_run_provenance(str(run))


RECORDS = {
    "moons": ["countergan_metrics.csv", "countergan_metrics_per_mask.csv",
              "classifier_eval/confusion_matrix.csv"],
    "mnist": ["countergan_metrics.csv", "countergan_metrics_per_class.csv",
              "masked_metrics.csv", "patch_budget_curve.csv"],
    "house": ["countergan_metrics.csv",
              "countergan_metrics_reference_protocol.csv",
              "feature_shift_importance.csv",
              "class_pair_sensitivity/class_pair_sensitivity.csv",
              "case_studies/case_study_sample_summary.csv",
              "case_studies/case_study_feature_summary.csv",
              "case_studies/case_study_aggregate_summary.csv",
              "mask_policy_analysis.csv"]}


@pytest.mark.parametrize("family", sorted(RECORDS))
def test_port_run_dirs_hold_every_record(port_runs, family):
    """Each run dir holds the CSVs the JAX package's experiment writes
    (its figures aside) and the provenance record."""
    run = port_runs[family]
    for name in RECORDS[family] + [pprov.PROVENANCE_FILE,
                                   "generator/metadata.json",
                                   "train_state/checkpoint.msgpack"]:
        assert (run / name).is_file(), name
    if family == "mnist":
        lines = (run / "patch_budget_curve.csv").read_text().splitlines()
        assert lines[0] == ("n_patches,frac_area,flip_rate,mean_target_prob,"
                            "actionability")
        assert [int(r.split(",")[0]) for r in lines[1:]] == [
            1, 2, 4, 6, 8, 10, 12, 16]
    if family == "house":
        cases = run / "case_studies" / "samples"
        assert len(list(cases.rglob("sample_*.csv"))) == 20
