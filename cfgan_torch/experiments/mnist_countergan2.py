"""The countergan2-style command line on the port (mirrors
`cfgan/experiments/mnist_countergan2.py`): one REQUIRED target class for
the whole run.

    python -m cfgan_torch.experiments.mnist_countergan2 --target C
        [--epochs N] [--clf-epochs N] [--limit N] [--out-dir D] [--fresh]
        [--device cpu]

It runs the MNIST experiment (`cfgan_torch.experiments.mnist_countergan.
run`) on the legacy stack (`legacy_delta=True`: the MaxPool classifier,
the delta generator, the unconditional discriminator, clipped-log losses)
with the preset `mnist_countergan2` and `fixed_target` C, into
`results/mnist_countergan2_target{C}` by default, then writes three PNG
grids (4 a row) over the first 16 test images: `original.png`,
`counterfactual.png` and `delta.png` (the delta times 0.5, so that it
sits centred), from the served generator (`countergan2.py:211-224`).
The grids are `to_uint8_grid`'s raster at its own size
(`cfgan_torch.eval.samples.save_image_grid`).
"""
from __future__ import annotations

import argparse
import os
from dataclasses import replace

import numpy as np
import torch

from cfgan_torch.core.device import resolve_device
from cfgan_torch.core.logging import setup_compile_cache
from cfgan_torch.data.mnist import load_mnist
from cfgan_torch.eval.samples import save_image_grid
from cfgan_torch.experiments.mnist_countergan import run
from cfgan_torch.experiments.presets import MNIST_COUNTERGAN2

GRID_IMAGES = 16
GRIDS = ("original.png", "counterfactual.png", "delta.png")


def main(argv=None, log=print) -> dict:
    """Parse `argv`, run, write the grids; returns `run`'s result with
    the run dir (`out_dir`).  `log` takes the progress lines."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--target", type=int, required=True,
                    help="target class of every counterfactual (0-9)")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--clf-epochs", type=int, default=None)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--out-dir", type=str, default=None)
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    setup_compile_cache()  # where the kernel and data libraries build
    if not 0 <= args.target <= 9:
        ap.error("--target must be in 0..9")
    dev = resolve_device(args.device)

    cfg = MNIST_COUNTERGAN2
    overrides = {"fixed_target": args.target}
    if args.epochs is not None:
        overrides["epochs"] = args.epochs
    cfg = cfg.replace(countergan=replace(cfg.countergan, **overrides))
    if args.clf_epochs is not None:
        cfg = cfg.replace(classifier=replace(cfg.classifier,
                                             epochs=args.clf_epochs))
    out_dir = args.out_dir or os.path.join(cfg.out_dir,
                                           f"{cfg.name}_target{args.target}")
    res = run(cfg, out_dir=out_dir, fresh=args.fresh, limit=args.limit,
              device=dev, log=log, legacy_delta=True)

    # original / counterfactual / delta grids over one 16-image test batch
    _, _, (xte, _) = load_mnist(limit=args.limit)
    x = torch.as_tensor(xte[:GRID_IMAGES]).to(dev)
    t = torch.full((len(x),), args.target, dtype=torch.long, device=dev)
    x_cf, delta, _ = res["bundle"].cf_fn(res["g_vars"], x, t,
                                         torch.ones_like(x))
    for name, images in zip(GRIDS, (x, x_cf, delta * 0.5)):
        save_image_grid(np.asarray(images.cpu()), os.path.join(out_dir, name),
                        nrow=4)
    log(f"countergan2 artifacts written to {out_dir}")
    return {**res, "out_dir": out_dir}


if __name__ == "__main__":
    main()
