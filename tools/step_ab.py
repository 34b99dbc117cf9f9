#!/usr/bin/env python3
"""Time the replayed train step (`conv_impl="pallas"`, the main path; bf16
or float32) of two checkouts in turns on one CUDA card.

    python3 tools/step_ab.py --parent DIR [--dtype bfloat16|float32]
                             [--turns 1] [--out FILE]

DIR is another checkout of this repository, for example the parent commit
unpacked with `git archive` into a directory that `.gitignore` lists.  Each
tree's kernel library is built once (its own `cfgan_torch.ops._build`,
both `nvcc` runs started together); then each turn is a process of its own
that imports that tree's package and `chip_smoke`, in the order parent,
change, change, parent (`--turns` times).

A turn builds the MNIST CounteRGAN preset at full width in `--dtype` with random
weights and a random dataset of the corpus's size on the card (both from
`chip_smoke.SEED`), captures the epoch runner's step (one epoch of
`chip_smoke.RUNNER_STEPS` steps), then reads, over epochs that replay every
step:
- the wall ms a step (five epochs, each ending in a synchronize);
- from one traced epoch (torch.profiler, device-side kernel records): the
  device's busy ms a step and its idle share, the conv kernels' ms (in
  float32 K's split included) and launches a step (the convs themselves,
  not the splits), and the gaps between kernels a step, split into the
  gaps before a conv kernel and before any other kernel.

One JSON line a turn and a summary line, each with the card's `nvidia-smi`
name and power limit; the last line is {"ok": true}.  Needs one card and
nvcc; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# what the conv kernels' names hold, by dtype (float32: K's split too)
CONV = {"bfloat16": "conv3x3_wgmma", "float32": "conv3x3_tf32"}
EPOCHS = 5


def worker(tree: Path, library: str, dtype: str) -> None:
    """One turn in `tree`'s package: one JSON line on stdout."""
    sys.path.insert(0, str(tree))
    from dataclasses import replace

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from cfgan_torch.core.config import MNIST_COUNTERGAN
    from cfgan_torch.data.pipeline import epoch_perm
    from cfgan_torch.ops import _build
    from cfgan_torch.train.builders import build_mnist_countergan, mnist_models
    from cfgan_torch.train.loop import make_epoch_runner

    _build.load_library(library)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = replace(MNIST_COUNTERGAN, conv_impl="pallas", compute_dtype=dtype)
    gen = torch.Generator().manual_seed(cs.SEED)
    clf_sd = mnist_models(cfg, generator=gen)[1].state_dict()
    bundle = build_mnist_countergan(cfg, clf_sd, seed=cs.SEED)
    n = 54000  # the corpus's training split
    x = (torch.rand((n, 28, 28, 1), generator=gen) * 2 - 1).to(dev)
    y = torch.randint(0, 10, (n,), generator=gen).to(dev)
    draws_gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    perm = epoch_perm(draws_gen, n, cs.TRAIN_BATCH)[:cs.RUNNER_STEPS]
    draws = bundle.draw_fn(draws_gen, tuple(perm.shape))
    runner = make_epoch_runner(bundle.step_from_draws, reduce=False)

    def epoch():
        runner(bundle.state, x, y, perm, draws)
        torch.cuda.synchronize()

    epoch()  # the capture
    epoch()
    walls = []
    for _ in range(EPOCHS):
        t0 = time.perf_counter()
        epoch()
        walls.append((time.perf_counter() - t0) * 1e3 / cs.RUNNER_STEPS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        epoch()
    kernels = sorted({(ev.time_range.start, ev.time_range.end, ev.name)
                      for ev in prof.events()
                      if ev.device_type == DeviceType.CUDA
                      and ev.time_range.end > ev.time_range.start
                      and not getattr(ev, "is_user_annotation", False)})
    steps = cs.RUNNER_STEPS
    busy = sum(e - s for s, e, _ in kernels) / 1e3 / steps
    conv = [(s, e, name) for s, e, name in kernels if CONV[dtype] in name]
    gaps = {"before_conv": 0.0, "before_other": 0.0}
    for (_, end, _), (start, _, name) in zip(kernels, kernels[1:]):
        key = "before_conv" if CONV[dtype] in name else "before_other"
        gaps[key] += max(0.0, start - end) / 1e3 / steps
    wall = statistics.median(walls)
    print(json.dumps({
        "wall_ms_per_step": walls, "median_ms": wall,
        "device_busy_ms": busy, "device_idle_share": 1 - busy / wall,
        "conv_ms_per_step": sum(e - s for s, e, _ in conv) / 1e3 / steps,
        "conv_launches_per_step": sum("split" not in name
                                      for _, _, name in conv) / steps,
        "kernels_per_step": len(kernels) / steps,
        "gap_ms_per_step": gaps,
        "conv_plan": bundle_plan(cs, dtype)}))


def bundle_plan(cs, dtype: str) -> dict | None:
    """The conv's plan at the step's shape, where the tree has one."""
    import inspect

    import torch

    from cfgan_torch.ops import conv

    if not hasattr(conv, "conv_plan"):
        return None
    if "dtype" in inspect.signature(conv.conv_plan).parameters:
        return conv.conv_plan(cs.TRAIN_BATCH, 28, 28, 64, 64,
                              dtype=getattr(torch, dtype))
    return None if dtype == "float32" else conv.conv_plan(
        cs.TRAIN_BATCH, 28, 28, 64, 64)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="another checkout")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the lines to this file")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--library", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.library, args.dtype)
        return
    if args.parent is None:
        ap.error("--parent is required")

    sys.path.insert(0, str(ROOT))
    import torch

    from tools import ab_common as ab

    if not torch.cuda.is_available():
        sys.exit("step_ab: needs a CUDA card")
    emit = ab.Lines(ab.card_name(), args.out)
    trees = {"parent": args.parent.resolve(), "change": ROOT}
    builds = {name: subprocess.Popen(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv[1]); "
         "from cfgan_torch.ops import _build; "
         "print(_build.load_library().path)", str(tree)],
        cwd=tree, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, tree in trees.items()}
    libs = {}
    for name, proc in builds.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"step_ab: the {name} build failed:\n{err}")
        libs[name] = out.strip().splitlines()[-1]
    readings = {name: [] for name in trees}
    for who in ["parent", "change", "change", "parent"] * args.turns:
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", str(trees[who]),
             "--library", libs[who], "--dtype", args.dtype], cwd=trees[who],
            capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"step_ab: a {who} turn failed:\n{proc.stderr}")
        turn = json.loads(proc.stdout.strip().splitlines()[-1])
        readings[who].append(turn)
        emit({"turn": who, **turn})
    keys = ("median_ms", "device_busy_ms", "device_idle_share",
            "conv_ms_per_step", "conv_launches_per_step")
    emit({"summary": f"replayed {args.dtype} pallas step",
          "median_of_turns": {name: {k: statistics.median(t[k] for t in ts)
                                     for k in keys}
                              for name, ts in readings.items()},
          "gap_ms_per_step": {name: [t["gap_ms_per_step"] for t in ts]
                              for name, ts in readings.items()}})
    emit({"ok": True})


if __name__ == "__main__":
    main()
