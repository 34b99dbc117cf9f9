"""The host loop around the epoch runner (mirrors
`cfgan/train/loop.py::train_countergan_loop`)."""
from __future__ import annotations

import time
from typing import Any, Callable

import torch

from cfgan_torch.core import checkpoint as ckpt
from cfgan_torch.data.pipeline import epoch_perm, stream_seed


def epoch_generators(seed: int, epoch: int, device: torch.device
                     ) -> tuple[torch.Generator, torch.Generator]:
    """(permutation generator, draws generator) of `epoch`, seeded
    statelessly from (seed, 2 epoch) and (seed, 2 epoch + 1), as the JAX
    loop folds `2 * epoch` and `2 * epoch + 1` into its key."""
    return tuple(torch.Generator(device=device).manual_seed(
        stream_seed(seed, 2 * epoch + k)) for k in (0, 1))


def train_countergan_loop(bundle, x_train, y_train, *, epochs: int,
                          batch_size: int, seed: int = 42,
                          log: Callable[[str], None] = print,
                          checkpoint_dir: str | None = None,
                          checkpoint_every: int = 0, resume: bool = True,
                          epoch_cb: Callable[[int, Any], None] | None = None):
    """Run `epochs` epochs of `bundle.epoch_fn` on (x_train, y_train)
    (numpy or tensors; moved once to the state's device); returns (state,
    history).

    One host read per epoch (the metric means), and one log line.  With
    `checkpoint_dir` and `checkpoint_every > 0` the whole train state is
    saved every K epochs; with `resume`, a run restarted with the same
    arguments restores it in place and continues: each epoch's
    permutation and draws come from generators seeded statelessly from
    (seed, epoch), so the continuation equals the uninterrupted run.
    `epoch_cb(epoch_1based, state)` runs after every epoch (the snapshot
    selection hook); the runner updates the state in place, so the
    callback copies what it keeps."""
    state = bundle.state
    start_epoch = 0
    history: dict = {}
    if resume and checkpoint_dir and ckpt.exists(checkpoint_dir):
        start_epoch, saved = ckpt.restore_train_state(checkpoint_dir, state)
        for k, vs in saved.items():
            history.setdefault(k, vs)
        log(f"[CounteRGAN] resuming from {checkpoint_dir} at epoch "
            f"{start_epoch + 1}/{epochs}")
    dev = next(state.g.model.parameters()).device
    x = torch.as_tensor(x_train).to(dev)
    y = torch.as_tensor(y_train).to(dev, torch.long)
    n = len(y)
    t0 = time.perf_counter()
    for epoch in range(start_epoch, epochs):
        g_perm, g_draws = epoch_generators(seed, epoch, dev)
        perm = epoch_perm(g_perm, n, batch_size)
        draws = bundle.draw_fn(g_draws, tuple(perm.shape))
        metrics = bundle.epoch_fn(state, x, y, perm, draws)
        for k, v in metrics.items():
            history.setdefault(k, []).append(float(v))
        shown = {k: history[k][-1]
                 for k in ("d_loss", "g_loss", "flip_rate", "g_cls",
                           "d_real_p", "d_fake_p") if k in history}
        line = ", ".join(f"{k}={v:.4f}" for k, v in shown.items())
        log(f"[CounteRGAN] epoch {epoch+1}/{epochs} :: {line}")
        if (checkpoint_dir and checkpoint_every
                and (epoch + 1) % checkpoint_every == 0):
            ckpt.save_train_state(checkpoint_dir, state, epoch,
                                  history=history)
        if epoch_cb is not None:
            epoch_cb(epoch + 1, state)
    history["wall_time_s"] = time.perf_counter() - t0
    return state, history
