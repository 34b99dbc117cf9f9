"""Epoch-snapshot serving selection (mirrors `cfgan/train/selection.py`):
ship the best generator the training trajectory produced, scored on
validation data, not whichever one the final epoch lands on.

Every `every` epochs (and at the last) `SnapshotSelector.epoch_cb` scores
each serving candidate of the state (live; with an EMA, the EMA
parameters with BatchNorm statistics recalibrated under the training
masks and under all-ones masks, `builders.serving_candidates`) and keeps
the best as a copy: the epoch runner updates the state in place.
"""
from __future__ import annotations

import itertools
from typing import Callable

import numpy as np
import torch

from cfgan_torch.train.builders import serving_candidates


def lex_margins(flips, reference) -> tuple:
    """Per-target flip margins over a reference vector, sorted ascending,
    as a tuple: compared lexicographically, the worst margin first."""
    f = np.asarray(flips, dtype=np.float64)
    r = np.asarray(reference, dtype=np.float64)
    return tuple(np.sort(f - r))


class SnapshotSelector:
    """Validation-scored serving selection over the training trajectory.

    `score_fn(g_vars) -> tuple`, higher is better, sees validation data
    only; `x_recal` (a tensor on the state's device) feeds the BatchNorm
    recalibration of EMA candidates, from generators seeded with
    `recal_seed`; without it only the live generator is scored."""

    def __init__(self, bundle, *, score_fn: Callable, every: int,
                 total_epochs: int, x_recal: torch.Tensor | None = None,
                 recal_seed: int = 0):
        self.bundle = bundle
        self.score_fn = score_fn
        self.every = max(1, every)
        self.total_epochs = total_epochs
        self.x_recal = x_recal
        self.recal_seed = recal_seed
        self.ladder: list[dict] = []
        self._best = None  # (score, name, copied g_vars)

    def _candidates(self, state):
        candidates = serving_candidates(self.bundle, state, self.x_recal,
                                        self.recal_seed)
        if self.x_recal is None:
            return itertools.islice(candidates, 1)  # "live" only
        return candidates

    def epoch_cb(self, epoch: int, state) -> None:
        """Pass to `train_countergan_loop(epoch_cb=...)`; `epoch` is
        1-based."""
        if epoch % self.every and epoch != self.total_epochs:
            return
        for cname, gv in self._candidates(state):
            score = self.score_fn(gv)
            name = f"snapshot_e{epoch}_{cname}"
            self.ladder.append({"epoch": epoch, "candidate": cname,
                                "score": [float(s) for s in score]})
            if self._best is None or score > self._best[0]:
                self._best = (score, name,
                              {k: v.detach().clone() for k, v in gv.items()})

    def best(self):
        """(g_vars, info) of the best-scoring snapshot; `info` carries the
        whole ladder for the run's metadata."""
        if self._best is None:
            raise ValueError("SnapshotSelector.best() before any epoch was "
                             "scored: was epoch_cb passed to the loop?")
        score, name, gv = self._best
        return gv, {"candidate": name,
                    "scores": {name: [float(s) for s in score]},
                    "ladder": self.ladder}
