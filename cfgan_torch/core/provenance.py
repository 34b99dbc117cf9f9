"""Run-dir provenance (mirrors `cfgan/core/provenance.py`): the eval CSVs
of a run dir and the serving candidate they were made with must agree.

Every experiment writes `run_provenance.json` in the same invocation that
writes its eval CSVs: the candidate it evaluated and the per-target flip
floor and mean its CSV holds.  `check_run_provenance` then holds three
records to each other:

    generator/metadata.json   (the candidate the checkpoint serves)
    == run_provenance.json    (the candidate the eval run evaluated)
    == the per-target CSV     (its flip floor and mean, recomputed)

The record's keys and its layout (`json.dump(indent=1)`) are the JAX
package's, so `tools/check_provenance.py` checks the port's run dirs as
its own, and this check the JAX package's.  The CSV is read with the csv
module; an empty or `nan` entry is missing, as pandas' `dropna` drops it.
"""
from __future__ import annotations

import csv
import json
import math
import os
from typing import Any

import numpy as np

from cfgan_torch.core.checkpoint import load_metadata

PROVENANCE_FILE = "run_provenance.json"
STALE_FILE = "STALE.txt"
TOLERANCE = 1e-9  # recorded against recomputed flip floor and mean


def serving_candidate_of(out_dir: str) -> str | None:
    """The candidate the generator checkpoint's metadata records
    (`serving_selection.candidate`), or None."""
    meta = load_metadata(os.path.join(out_dir, "generator")) or {}
    return (meta.get("serving_selection") or {}).get("candidate")


def _flip_column(path: str, column: str) -> list[float] | None:
    """The non-missing floats of `column` in the CSV at `path`; None where
    the CSV has no such column."""
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        if column not in (reader.fieldnames or ()):
            return None
        values = []
        for row in reader:
            cell = (row[column] or "").strip()
            if cell and not math.isnan(float(cell)):
                values.append(float(cell))
    return values


def _floor_and_mean(values: list[float]) -> tuple[float, float]:
    """min and mean, the mean as numpy (and pandas) sum in float64."""
    a = np.asarray(values, dtype=np.float64)
    return float(a.min()), float(a.mean())


def write_run_provenance(out_dir: str, preset: str, seed: int,
                         serving_candidate: str | None,
                         selection_scores: dict | None = None,
                         per_target_csv: str =
                         "countergan_metrics_per_class.csv",
                         flip_column: str = "class_flip_rate",
                         extra: dict[str, Any] | None = None
                         ) -> dict[str, Any]:
    """Write `run_provenance.json`: what this eval run served and the flip
    floor and mean of its per-target CSV.  Call it in the invocation that
    wrote the CSVs.  Returns the record."""
    rec: dict[str, Any] = {
        "preset": preset,
        "seed": int(seed),
        "serving_candidate": serving_candidate,
        "selection_scores": selection_scores or {},
    }
    csv_path = os.path.join(out_dir, per_target_csv)
    if os.path.exists(csv_path):
        values = _flip_column(csv_path, flip_column)
        if values is not None:
            floor, mean = _floor_and_mean(values)
            rec.update(per_target_csv=per_target_csv, flip_column=flip_column,
                       per_target_flip_min=floor, per_target_flip_mean=mean)
    if extra:
        rec.update(extra)
    with open(os.path.join(out_dir, PROVENANCE_FILE), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def check_run_provenance(out_dir: str) -> dict[str, Any]:
    """Validate a run dir's provenance; raise ValueError on any mismatch,
    else return the record.  Checks that `run_provenance.json` exists (a
    reselection deletes it), that its candidate is the generator
    checkpoint's, and that its flip floor and mean are the CSV's within
    1e-9."""
    p = os.path.join(out_dir, PROVENANCE_FILE)
    if not os.path.exists(p):
        raise ValueError(
            f"{out_dir}: no {PROVENANCE_FILE}: the eval artifacts predate "
            "the provenance record or are stale after a serving "
            "reselection; rerun the experiment (same seed and out dir)")
    with open(p) as f:
        rec = json.load(f)
    served = serving_candidate_of(out_dir)
    if served != rec.get("serving_candidate"):
        raise ValueError(
            f"{out_dir}: the generator checkpoint serves {served!r} but the "
            f"eval CSVs were made under {rec.get('serving_candidate')!r}: "
            "stale artifacts; rerun the evaluation")
    if "per_target_flip_min" in rec:
        csv_path = os.path.join(out_dir, rec["per_target_csv"])
        if not os.path.exists(csv_path):
            raise ValueError(f"{out_dir}: the provenance record names the "
                             f"missing {rec['per_target_csv']}")
        values = _flip_column(csv_path, rec["flip_column"])
        if not values:
            raise ValueError(f"{out_dir}: {rec['per_target_csv']} holds no "
                             f"{rec['flip_column']} values")
        floor, mean = _floor_and_mean(values)
        if (abs(floor - rec["per_target_flip_min"]) > TOLERANCE
                or abs(mean - rec["per_target_flip_mean"]) > TOLERANCE):
            raise ValueError(
                f"{out_dir}: the CSV's flip floor/mean ({floor:.6f}/"
                f"{mean:.6f}) differ from the provenance record's "
                f"({rec['per_target_flip_min']:.6f}/"
                f"{rec['per_target_flip_mean']:.6f}): the CSV changed after "
                "the record was written")
    return rec


def invalidate_run_provenance(out_dir: str, reason: str) -> None:
    """Mark a run dir's eval artifacts stale (after a serving
    reselection): remove `run_provenance.json`, so that the check fails
    until the experiment writes them again, and write the reason to
    `STALE.txt`."""
    p = os.path.join(out_dir, PROVENANCE_FILE)
    if os.path.exists(p):
        os.remove(p)
    with open(os.path.join(out_dir, STALE_FILE), "w") as f:
        f.write(reason + "\n")


def clear_stale(out_dir: str) -> None:
    """Remove `STALE.txt` (before a fresh evaluation writes its record)."""
    p = os.path.join(out_dir, STALE_FILE)
    if os.path.exists(p):
        os.remove(p)
