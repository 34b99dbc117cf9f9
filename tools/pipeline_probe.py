#!/usr/bin/env python3
"""Where a prefetched eager train step's host time goes, on one CUDA card.

    python3 tools/pipeline_probe.py [--steps 40] [--out FILE]

The MNIST CounteRGAN preset at full width (bf16, `conv_impl="pallas"`,
batch 128, random weights and draws from `chip_smoke.SEED`) takes its
batches from a random dataset of the train split's size
(54,000 x 28 x 28 x 1 float32, int64 labels) fed four ways:

- `resident`: the split on the card, each batch gathered by
  `index_select` (what the epoch runner does);
- `prefetched`: `DevicePrefetcher(HostIterator(...), buffer_size=2)`;
- `side`: the resident batch copied on a side stream into memory of that
  stream, the consumer waiting on an event and the tensors recorded on
  its stream (the prefetcher's stream handling without its host work);
- `pageable`: the host batch copied with `.to(device)` from pageable
  memory on the consumer's stream (the feed the prefetcher replaces).

One step of each arm a round, the order reversed every other round
(ABCD, DCBA), `--steps` rounds; every step ends in a synchronize.  A
step's wall ms is split into the fetch (the batch in hand) and the
step.  Then one profiler trace an arm (one warm-up step, then three
steps traced) gives the host ops' self CPU ms a step, the largest first,
and the device busy ms; a trace without device records is taken again,
up to three times.  One JSON line an arm and a summary line, each with
the card's `nvidia-smi` name and power limit; the last line is
{"ok": true}, or the probe exits non-zero where an arm's traces all came
back empty.  Needs one card and nvcc; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ARMS = ("resident", "prefetched", "side", "pageable")
TRACED = 3
ROWS, BATCH = 54000, 128


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    import chip_smoke as cs
    from cfgan_torch.core.config import MNIST_COUNTERGAN
    from cfgan_torch.data.pipeline import (
        DevicePrefetcher,
        HostIterator,
        device_put_dataset,
    )
    from cfgan_torch.ops import _build
    from cfgan_torch.parallel import create_mesh
    from cfgan_torch.train.builders import build_mnist_countergan, mnist_models

    if not torch.cuda.is_available():
        sys.exit("pipeline_probe: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps({**obj, "card": card})
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    _build.load_library()
    dev = torch.device("cuda")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    gen = torch.Generator().manual_seed(cs.SEED)
    clf_sd = mnist_models(MNIST_COUNTERGAN, generator=gen)[1].state_dict()
    x_host = (torch.rand((ROWS, 28, 28, 1), generator=gen) * 2 - 1).numpy()
    y_host = torch.randint(0, 10, (ROWS,), generator=gen).numpy()
    bundle = build_mnist_countergan(
        replace(MNIST_COUNTERGAN, conv_impl="pallas"), clf_sd, seed=cs.SEED,
        device=dev)
    x_dev, y_dev = device_put_dataset(create_mesh(devices=[dev]), x_host,
                                      y_host)
    perm = torch.randperm(ROWS, generator=gen)[:BATCH * 256].reshape(
        256, BATCH).to(dev)
    host_perm = perm.cpu().numpy()
    draws = bundle.draw_fn(torch.Generator(device=dev).manual_seed(cs.SEED),
                           (16, BATCH))
    side = torch.cuda.Stream()
    fed = iter(DevicePrefetcher(HostIterator((x_host, y_host), BATCH,
                                             shuffle=True, seed=1,
                                             drop_last=True)))
    count = {arm: 0 for arm in ARMS}

    def fetch(arm):
        i = count[arm] % len(perm)
        count[arm] += 1
        if arm == "prefetched":
            return next(fed)
        if arm == "pageable":
            rows = host_perm[i]
            return (torch.from_numpy(x_host[rows]).to(dev),
                    torch.from_numpy(y_host[rows]).to(dev))
        x, y = x_dev.index_select(0, perm[i]), y_dev.index_select(0, perm[i])
        if arm == "resident":
            return x, y
        consumer = torch.cuda.current_stream()
        side.wait_stream(consumer)
        with torch.cuda.stream(side):
            xs, ys = x.clone(), y.clone()
            done = torch.cuda.Event()
            done.record(side)
        consumer.wait_event(done)
        for t in (xs, ys):
            t.record_stream(consumer)
        return xs, ys

    def step(arm):
        t0 = time.perf_counter()
        x, y = fetch(arm)
        t1 = time.perf_counter()
        j = count[arm] % 16
        bundle.step_from_draws(bundle.state, x, y,
                               {k: v[j] for k, v in draws.items()})
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return (t1 - t0) * 1e3, (t2 - t0) * 1e3

    for arm in ARMS:  # warm-up
        step(arm)
    times = {arm: {"fetch": [], "step": []} for arm in ARMS}
    for r in range(args.steps):
        for arm in (ARMS if r % 2 == 0 else ARMS[::-1]):
            f, s = step(arm)
            times[arm]["fetch"].append(f)
            times[arm]["step"].append(s)

    summary, empty = {}, []
    for arm in ARMS:
        # a trace may come back without device records: take it again,
        # up to the smoke's PROFILE_TRIES, and fail rather than report it
        for tries in range(1, cs.PROFILE_TRIES + 1):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=1)) as prof:
                step(arm)
                prof.step()
                for _ in range(TRACED):
                    step(arm)
                prof.step()
            busy = sum(cs._dev_us(ev) for ev in cs.device_events(prof)) / 1e3
            if busy > 0:
                break
        else:
            empty.append(arm)
        averages = prof.key_averages()
        host_ops = sorted(((ev.key[:60], ev.self_cpu_time_total / 1e3
                            / TRACED, ev.count / TRACED)
                           for ev in averages
                           if ev.self_cpu_time_total > 0),
                          key=lambda t: -t[1])
        med = {k: statistics.median(v) for k, v in times[arm].items()}
        summary[arm] = med["step"]
        emit({"arm": arm, "steps": args.steps,
              "step_ms_median": med["step"],
              "step_ms_quartiles": statistics.quantiles(
                  times[arm]["step"], n=4),
              "fetch_ms_median": med["fetch"],
              "trace_tries": tries,
              "device_busy_ms": busy / TRACED if busy > 0 else None,
              "host_self_cpu_ms_per_step": sum(t[1] for t in host_ops),
              "host_ops_top": host_ops[:15]})
    emit({"summary": "step ms medians", **summary,
          "prefetched_minus_resident_ms":
              summary["prefetched"] - summary["resident"]})
    print(json.dumps({"ok": not empty, "empty_traces": empty}))
    if empty:
        sys.exit(f"pipeline_probe: no device records in {cs.PROFILE_TRIES} "
                 f"traces of {empty}")

if __name__ == "__main__":
    main()
