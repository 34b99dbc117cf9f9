"""Classifier evaluation: accuracy, confusion matrix and the per-class
report (mirrors `cfgan/eval/classifier.py`).

The confusion matrix and the per-class precision, recall, f1 and support
are computed in numpy with scikit-learn's definitions (`confusion_matrix`,
`classification_report(..., zero_division=0)`): the labels are those
present in y or the predictions, sorted; f1 = 2 tp / (true + predicted);
"accuracy" is the micro average.  The text report has scikit-learn's
layout.  `confusion_matrix.png` is the counts through `Blues` with each
cell's count in white above half the largest count, black below.
"""
from __future__ import annotations

import csv
import os
from typing import Callable

import numpy as np
import torch

from cfgan_torch.core.device import resolve_device
from cfgan_torch.eval.figure import Figure

HEADERS = ("precision", "recall", "f1-score", "support")


def predict_all(logits_fn: Callable, x, batch: int = 4096,
                device: str | torch.device | None = None) -> np.ndarray:
    """Argmax class of `logits_fn` over `x` (numpy or tensor), by
    batches on `device` (None: the CUDA card)."""
    device = resolve_device(device)
    preds = []
    with torch.no_grad():
        for lo in range(0, len(x), batch):
            xb = torch.as_tensor(x[lo:lo + batch]).to(device)
            preds.append(logits_fn(xb).argmax(1).cpu().numpy())
    return np.concatenate(preds)


def confusion_matrix(y, preds) -> np.ndarray:
    """(labels x labels) counts, rows true, columns predicted."""
    labels = np.unique(np.concatenate([y, preds]))
    index = {v: i for i, v in enumerate(labels.tolist())}
    cm = np.zeros((len(labels), len(labels)), np.int64)
    np.add.at(cm, ([index[v] for v in np.asarray(y).tolist()],
                   [index[v] for v in np.asarray(preds).tolist()]), 1)
    return cm


def _divide(num, den):
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    out = np.zeros_like(num)
    np.divide(num, den, out=out, where=den != 0)
    return out


def classification_report(y, preds) -> dict:
    """scikit-learn's `classification_report(y, preds, output_dict=True,
    zero_division=0)`."""
    labels = np.unique(np.concatenate([y, preds]))
    y, preds = np.asarray(y), np.asarray(preds)
    tp = np.array([np.sum((y == v) & (preds == v)) for v in labels])
    true = np.array([np.sum(y == v) for v in labels])
    pred = np.array([np.sum(preds == v) for v in labels])
    p, r, f1 = _divide(tp, pred), _divide(tp, true), _divide(2 * tp,
                                                             true + pred)
    report = {str(v): dict(zip(HEADERS, (float(p[i]), float(r[i]),
                                         float(f1[i]), float(true[i]))))
              for i, v in enumerate(labels.tolist())}
    total = float(true.sum())
    report["accuracy"] = float(_divide(tp.sum(), pred.sum()))
    report["macro avg"] = dict(zip(HEADERS, (
        float(np.average(p)), float(np.average(r)), float(np.average(f1)),
        total)))
    report["weighted avg"] = dict(zip(HEADERS, (
        float(np.average(p, weights=true)),
        float(np.average(r, weights=true)),
        float(np.average(f1, weights=true)), total)))
    return report


def report_text(report: dict, digits: int = 2) -> str:
    """`report` in the layout of scikit-learn's text report."""
    names = [k for k in report
             if k not in ("accuracy", "macro avg", "weighted avg")]
    width = max(max(len(n) for n in names), len("weighted avg"), digits)
    out = ("{:>{width}s} " + " {:>9}" * 4).format("", *HEADERS,
                                                   width=width) + "\n\n"
    row = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    for name in names:
        r = report[name]
        out += row.format(name, r["precision"], r["recall"], r["f1-score"],
                          int(r["support"]), width=width, digits=digits)
    out += "\n"
    total = int(report["macro avg"]["support"])
    out += ("{:>{width}s} " + " {:>9.{digits}}" * 2 + " {:>9.{digits}f}"
            + " {:>9}\n").format("accuracy", "", "", report["accuracy"],
                                 total, width=width, digits=digits)
    for name in ("macro avg", "weighted avg"):
        r = report[name]
        out += row.format(name, r["precision"], r["recall"], r["f1-score"],
                          total, width=width, digits=digits)
    return out


def evaluate_classifier(logits_fn: Callable, x, y,
                        out_dir: str | None = None,
                        device: str | torch.device | None = None,
                        class_names=None) -> dict:
    """dict(accuracy, report, confusion); with `out_dir`, writes
    `confusion_matrix.csv` (pandas' layout: an index column),
    `classifier_report.txt` and `confusion_matrix.png` (ticks
    `class_names`, default the class indices), as the JAX package
    does."""
    device = resolve_device(device)
    y = np.asarray(y)
    preds = predict_all(logits_fn, x, device=device)
    acc = float((preds == y).mean())
    cm = confusion_matrix(y, preds)
    report = classification_report(y, preds)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "confusion_matrix.csv"), "w",
                  newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow([""] + list(range(cm.shape[1])))
            for i, row in enumerate(cm.tolist()):
                w.writerow([i] + row)
        with open(os.path.join(out_dir, "classifier_report.txt"), "w") as f:
            f.write(f"accuracy: {acc:.4f}\n")
            f.write(f"weighted_f1: {report['weighted avg']['f1-score']:.4f}"
                    "\n\n")
            f.write(report_text(report))
        plot_confusion(cm, os.path.join(out_dir, "confusion_matrix.png"),
                       class_names)
    return {"accuracy": acc, "report": report, "confusion": cm}


def plot_confusion(cm: np.ndarray, path: str, class_names=None) -> str:
    """The confusion matrix at `path`: counts through `Blues` over their
    min and max, each cell's count in white above cm.max() / 2, black
    below, and a colorbar."""
    fig = Figure(figsize=(6, 5), dpi=120)
    ax = fig.subplots()[0, 0]
    im = ax.imshow(cm, cmap="Blues")
    n = cm.shape[0]
    names = class_names or list(range(n))
    ax.set_xticks(range(n), names)
    ax.set_yticks(range(n), names)
    for i in range(n):
        for j in range(n):
            ax.text(j, i, str(cm[i, j]), ha="center", va="center",
                    color="white" if cm[i, j] > cm.max() / 2 else "black",
                    fontsize=8)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ax.set_title("Confusion Matrix")
    ax.add_colorbar(im)
    return fig.save(path)
