"""The epoch runner and the host loop around it (mirrors
`cfgan/train/countergan.py::make_epoch_runner` and
`cfgan/train/loop.py::train_countergan_loop`).

The epoch runner (`make_epoch_runner`) is the counterpart of the JAX
package's one compiled `lax.scan` per epoch, for a step of any family
(CounteRGAN or plain generation): on a CUDA card it captures the step as
a CUDA graph and replays it for every step of every epoch, with the
dataset, the epoch's permutation and random draws and the metrics in
device buffers (see `EpochRunner`).  `plot_loss_curves` draws the
history's loss curves (`cfgan/train/loop.py::plot_loss_curves`).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Mapping

import torch
import torch.distributed as dist

from cfgan_torch.core import checkpoint as ckpt
from cfgan_torch.data.pipeline import epoch_perm, stream_seed
from cfgan_torch.eval.figure import Figure


# eager steps before a capture: they create the optimizer state (a capture
# must not) and let cuDNN pick its algorithms
WARMUP_STEPS = 3


class EpochRunner:
    """`runner(state, data_x, data_y, perm, draws) -> metrics`: one epoch
    of steps of `step_from_draws` (the counterpart of the JAX package's
    `make_epoch_runner`).

    `data_x` / `data_y` hold the whole training split on the state's
    device; `perm` is the epoch's (steps, batch) index matrix; `draws` the
    epoch's random draws, each (steps, batch, ...) (`draw_fn(generator,
    perm.shape)`).  Step i trains on rows `perm[i]` with draws `[i]`.
    Returns the epoch means of the step metrics, as floats, or with
    `reduce=False` each metric's (steps,) numpy trace.  `state.step`
    advances by `steps`.

    On the CPU each step runs eagerly.  On a CUDA card the first epoch
    runs `WARMUP_STEPS` steps eagerly on a side stream (real steps, which
    create Adam's state and let cuDNN pick its algorithms), then captures
    one step as a `torch.cuda.CUDAGraph` and replays it for every other
    step of this and later epochs.  The replayed step reads its batch and
    draws through a step index held on the device, from static buffers
    that each epoch's `perm` and `draws` are copied into; it writes its
    metrics into a device buffer that is read once an epoch; the replays
    run under `torch.cuda.set_sync_debug_mode("error")`, so a step that
    synchronises with the host raises.  Nothing is copied from the host
    per step.  A capture that fails raises RuntimeError: there is no
    fallback to eager steps on the card.  A new dataset tensor, state or
    epoch shape recaptures (after `WARMUP_STEPS` more eager steps).

    A step whose graph depends on the host's step count (WGAN-GP's
    critic-only step and its critic + generator step) comes with a
    `schedule(step) -> kind`: the runner captures one graph of each kind,
    with `state.step` set to a step of that kind, and replays them in the
    order of the global step; all of them read the one step index on the
    device.  Before the first capture of a kind, steps run eagerly until
    one of that kind has (the optimizer state a kind alone updates, such
    as the generator's Adam on WGAN-GP's G steps, is made then).

    A state replicated on a mesh (`cfgan_torch.parallel.replicate`) runs
    the same epoch on every rank, each step on the rank's rows of the
    global batch; on the card its group must be NCCL, whose collectives
    the graphs capture with the step (a gloo group raises RuntimeError),
    those of a ("data", "model") mesh's subgroups and a channel-sharded
    generator's included: the eager warm-up steps issue each subgroup's
    first collective, which creates its communicator, before a capture.
    Every rank makes the same capture decisions: they depend only on the
    step count, the shapes and the schedule.

    Restoring a checkpoint into `state` must copy in place
    (`cfgan_torch.core.checkpoint.restore_train_state` does): the graphs
    hold the addresses of the parameters, buffers and optimizer state.
    `captures` and `replays` count the graphs captured and the steps
    replayed.  The kernel wrappers' launch counters count a captured
    launch once, not its replays.
    """

    def __init__(self, step_from_draws: Callable, reduce: bool = True,
                 schedule: Callable[[int], object] | None = None):
        self.step_from_draws = step_from_draws
        self.reduce = reduce
        self.schedule = schedule
        self.graphs: dict[object, torch.cuda.CUDAGraph] = {}
        self._key = None
        self._names: list[str] | None = None
        self.captures = 0
        self.replays = 0

    def _finish(self, trace: torch.Tensor) -> dict:
        if self.reduce:
            means = trace.mean(0).cpu().tolist()
            return dict(zip(self._names, means))
        trace = trace.cpu().numpy()
        return {k: trace[:, i] for i, k in enumerate(self._names)}

    def _row(self, metrics: Mapping[str, torch.Tensor]) -> torch.Tensor:
        if self._names is None:
            self._names = list(metrics)
        return torch.stack([metrics[k].float() for k in self._names])

    def __call__(self, state, data_x, data_y, perm, draws) -> dict:
        steps = perm.shape[0]
        if data_x.device.type == "cpu":
            rows = []
            for i in range(steps):
                idx = perm[i].to(data_x.device)
                rows.append(self._row(self.step_from_draws(
                    state, data_x.index_select(0, idx),
                    data_y.index_select(0, idx),
                    {k: v[i] for k, v in draws.items()})))
            return self._finish(torch.stack(rows))
        return self._run_cuda(state, data_x, data_y, perm, draws)

    def _run_cuda(self, state, data_x, data_y, perm, draws) -> dict:
        mesh = getattr(state, "mesh", None)
        if mesh is not None and mesh.group is not None and (
                dist.get_backend(mesh.group) != "nccl"):
            raise RuntimeError(
                f"the epoch runner captures the step as a CUDA graph, and "
                f"the collectives of a {dist.get_backend(mesh.group)} "
                "process group cannot be captured: replicate a CUDA state "
                "on an NCCL group (there is no eager fallback on the card)")
        dev = data_x.device
        steps = perm.shape[0]
        key = (id(state), data_x.data_ptr(), data_y.data_ptr(),
               tuple(data_x.shape), tuple(perm.shape),
               tuple((k, tuple(v.shape), v.dtype)
                     for k, v in sorted(draws.items())))
        first = not self.graphs or key != self._key
        if first:
            # static buffers the graphs read and write
            self.graphs = {}
            self._perm = torch.empty(perm.shape, dtype=torch.long,
                                     device=dev)
            self._draws = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                           for k, v in draws.items()}
            self._idx = torch.zeros(1, dtype=torch.long, device=dev)
            self._trace = None
        self._perm.copy_(perm)
        for k, v in draws.items():
            self._draws[k].copy_(v)
        self._idx.zero_()
        step0 = state.step

        def body():
            idx = self._idx
            rows = self._perm.index_select(0, idx).view(-1)
            batch = {k: v.index_select(0, idx)[0]
                     for k, v in self._draws.items()}
            row = self._row(self.step_from_draws(
                state, data_x.index_select(0, rows),
                data_y.index_select(0, rows), batch))
            if self._trace is None:
                self._trace = torch.zeros((steps, row.numel()),
                                          dtype=torch.float32, device=dev)
            self._trace.index_copy_(0, idx, row[None])
            idx.add_(1)

        kinds = [None if self.schedule is None else self.schedule(step0 + i)
                 for i in range(steps)]
        missing = set(kinds) - self.graphs.keys()
        eager = 0
        if missing:
            # eager steps from the epoch's start: WARMUP_STEPS before a
            # first capture, and on until each kind still without a graph
            # has run once
            warmup = WARMUP_STEPS if first else 0
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                while eager < steps and (eager < warmup or not missing
                                         <= set(kinds[:eager])):
                    state.step = step0 + eager
                    body()
                    eager += 1
            torch.cuda.current_stream(dev).wait_stream(side)
            for kind in dict.fromkeys(kinds[:eager]):
                if kind not in missing:
                    continue
                state.step = step0 + kinds.index(kind)
                graph = torch.cuda.CUDAGraph()
                try:
                    with torch.cuda.graph(graph):
                        body()
                except Exception as e:
                    raise RuntimeError(
                        "the epoch runner could not capture the train step "
                        "as a CUDA graph (a step must not synchronise with "
                        "the host or read a tensor's value on it); there is "
                        "no eager fallback on the card") from e
                self.graphs[kind] = graph
                self.captures += 1
            self._key = key
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for kind in kinds[eager:]:
                self.graphs[kind].replay()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        self.replays += steps - eager
        state.step = step0 + steps
        return self._finish(self._trace)


def make_epoch_runner(step_from_draws: Callable, reduce: bool = True,
                      schedule: Callable[[int], object] | None = None
                      ) -> EpochRunner:
    """The epoch runner of `step_from_draws` (see `EpochRunner`);
    `reduce=False` returns the per-step metric traces instead of their
    epoch means, as the JAX package's does; `schedule` names the kind of
    each global step where kinds differ in their graph."""
    return EpochRunner(step_from_draws, reduce, schedule)


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
                          mesh=None,
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
    callback copies what it keeps.

    With a `mesh` (`cfgan_torch.parallel.create_mesh`, one device a
    process, 1-D or ("data", "model")) every rank of the mesh's world
    calls the loop with the same arguments and trains data-parallel: the
    state is replicated from rank 0 over the whole mesh (`replicate`; a
    generator channel-sharded beforehand, `shard_leaves`, keeps its
    layout), every rank keeps the whole dataset and draws the same global
    permutation and draws, and each step trains on the rank's rows of its
    batch.  Every rank's history holds the global means; rank
    0 alone logs and writes the checkpoints (`save_sharded`).  A mesh of
    several devices in one process raises ValueError before anything
    runs: start one process a device (`spawn_world`, `torchrun`)."""
    if mesh is not None:
        from cfgan_torch.parallel.sharding import (
            check_one_device_a_process,
            replicate,
        )

        check_one_device_a_process(mesh)
    state = bundle.state
    start_epoch = 0
    history: dict = {}
    if mesh is not None and mesh.rank != 0:
        log = _silent
    if resume and checkpoint_dir and ckpt.exists(checkpoint_dir):
        start_epoch, saved = ckpt.restore_train_state(checkpoint_dir, state)
        for k, vs in saved.items():
            history.setdefault(k, vs)
        log(f"[CounteRGAN] resuming from {checkpoint_dir} at epoch "
            f"{start_epoch + 1}/{epochs}")
    if mesh is not None:
        replicate(mesh, state)
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
            if mesh is None:
                ckpt.save_train_state(checkpoint_dir, state, epoch,
                                      history=history)
            else:
                ckpt.save_sharded(checkpoint_dir, state,
                                  ckpt.train_state_metadata(epoch, history))
        if epoch_cb is not None:
            epoch_cb(epoch + 1, state)
    history["wall_time_s"] = time.perf_counter() - t0
    return state, history


def _silent(line: str) -> None:
    """The log of a rank other than 0."""


LOSS_LABELS = {"g_loss": "Generator Loss", "d_loss": "Discriminator Loss",
               "g_cls": "Classifier Loss (g_cls)"}


def plot_loss_curves(history: dict, path: str,
                     keys=("g_loss", "d_loss", "g_cls")) -> str:
    """The loss curves of `history` at `path`, an 8x6 in figure at 100
    dpi (the reference's gan_losses.png, `mnist/trainer.py:149-160`);
    g_cls dashed."""
    fig = Figure(figsize=(8, 6), dpi=100)
    ax = fig.subplots()[0, 0]
    for k in keys:
        if k in history and isinstance(history[k], list):
            ax.plot(history[k], label=LOSS_LABELS.get(k, k),
                    linestyle="--" if k == "g_cls" else "-")
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Loss")
    ax.legend()
    ax.set_title("CounterGAN Losses")
    return fig.save(path)
