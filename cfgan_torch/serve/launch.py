"""Launch a trained CounteRGAN's run dir as a gradio app or over the
HTTP API on the card (mirrors `cfgan/serve/launch.py`).

    python -m cfgan_torch.serve.launch --app mnist|house|moons
        [--results DIR] [--host H] [--share] [--device cpu]
    python -m cfgan_torch.serve.launch --app mnist|house|moons --api
        [--results DIR] [--host H] [--port P] [--device cpu] [--shard]

The default run dir is `results/<app>_countergan`.

`setup_mnist`, `setup_house` and `setup_moons` restore a run dir's
`classifier/` and `generator/` checkpoints (the served generator
variables), written by either package's experiment, into an engine on
the device (default: the CUDA card).  `launch_mnist`, `launch_house` and
`launch_moons` serve that engine as the family's gradio app
(`cfgan_torch.serve.apps`), which needs gradio: without it they raise
its `ImportError` before loading anything, and `main` exits non-zero
with that message (it never serves the API in the app's place).  With
`--api`, `main` serves the engine with `cfgan_torch.serve.api.serve`
until interrupted, after one warm-up request.  Either way `main`
switches TF32 off, so that the float32 classifier's convs and matmuls
compute in float32 as the JAX package's do.  `--shard` (with `--api`
only) serves data-parallel over every local card (`engine.shard(
create_mesh())`), or over the `--device` named.
"""
from __future__ import annotations

import argparse
import os
import sys
from dataclasses import replace

import torch

from cfgan_torch.convert import flax_from_state_dict, state_dict_from_flax
from cfgan_torch.core import checkpoint as ckpt
from cfgan_torch.core.device import resolve_device
from cfgan_torch.experiments import presets
from cfgan_torch.serve.engine import CounterfactualEngine

DEFAULT_RESULTS = {"mnist": "results/mnist_countergan",
                   "house": "results/house_countergan",
                   "moons": "results/moons_countergan"}


def restore_state_dict(module: torch.nn.Module, path: str
                       ) -> dict[str, torch.Tensor]:
    """`module`'s state dict from the flax checkpoint at `path`."""
    template = flax_from_state_dict(module, module.state_dict())
    return state_dict_from_flax(module, ckpt.restore(path, template))


def setup_mnist(results_dir: str, device: str | torch.device | None = None,
                conv_impl: str | None = None):
    """(engine, x_test, y_test, patch_size) of the `MNIST_COUNTERGAN`
    preset's run dir; `conv_impl` routes the generator's 3x3 convs
    (None: cuDNN; "pallas": the hand-written kernel)."""
    from cfgan_torch.data.mnist import load_mnist
    from cfgan_torch.train.builders import (
        NUM_CLASSES,
        build_mnist_serving,
        mnist_models,
    )

    exp = presets.MNIST_COUNTERGAN
    cfg = replace(exp.countergan, conv_impl=conv_impl)
    _, _, (xte, yte) = load_mnist(valid_fraction=exp.data.valid_fraction)
    g_model, clf_model = mnist_models(cfg)
    g_sd = restore_state_dict(g_model, os.path.join(results_dir,
                                                    "generator"))
    clf_sd = restore_state_dict(clf_model, os.path.join(results_dir,
                                                        "classifier"))

    def serving(dev):
        s = build_mnist_serving(cfg, g_sd, clf_sd, device=dev)
        return s.cf_fn, s.clf_fn

    engine = CounterfactualEngine(*serving(device), NUM_CLASSES,
                                  patch_size=cfg.mask.patch_size,
                                  device=device, replica_fn=serving)
    return engine, xte, yte, cfg.mask.patch_size


def setup_house(results_dir: str, device: str | torch.device | None = None):
    """(engine, x_test, y_test, schema, stats, bins) of the
    `HOUSE_COUNTERGAN` preset's run dir, on the house table."""
    from cfgan_torch.data.kc_house import load_kc_house
    from cfgan_torch.models.classifiers import TabularClassifier
    from cfgan_torch.train.builders import (
        build_tabular_countergan,
        house_engine,
    )
    from cfgan_torch.train.classifier import make_eval_fn

    _, (xte, yte), stats, bins, schema = load_kc_house()
    clf_sd = restore_state_dict(TabularClassifier(),
                                os.path.join(results_dir, "classifier"))
    g_vars = None

    def on(dev):
        nonlocal g_vars
        clf = TabularClassifier()
        clf.load_state_dict(clf_sd)
        clf.to(dev).eval().requires_grad_(False)
        bundle = build_tabular_countergan(
            presets.HOUSE_COUNTERGAN.countergan, clf.state_dict(), schema,
            stats, device=dev)
        if g_vars is None:
            g_vars = restore_state_dict(
                bundle.state.g.model, os.path.join(results_dir, "generator"))
        return house_engine(bundle, make_eval_fn(clf)[0],
                            g_variables={k: v.to(dev)
                                         for k, v in g_vars.items()},
                            device=dev)

    def serving(dev):
        e = on(dev)
        return e.cf_fn, e.clf_fn

    engine = on(resolve_device(device))
    engine.replica_fn = serving
    return engine, xte, yte, schema, stats, bins


def setup_moons(results_dir: str, device: str | torch.device | None = None):
    """(engine, clf_fn, x_test, y_test) of the `MOONS_COUNTERGAN`
    preset's run dir; `clf_fn` gives the classifier's logits."""
    from cfgan_torch.data.moons import load_moons3
    from cfgan_torch.train.builders import moons_engine, moons_models

    exp = presets.MOONS_COUNTERGAN
    _, (xte, yte), _ = load_moons3()
    g_model, clf_model = moons_models(exp.countergan,
                                      exp.classifier.hidden_dim)
    engine = moons_engine(
        exp.countergan,
        restore_state_dict(g_model, os.path.join(results_dir, "generator")),
        restore_state_dict(clf_model, os.path.join(results_dir,
                                                   "classifier")),
        device=device)
    return engine, engine.clf_fn, xte, yte


def launch_mnist(results_dir: str, share: bool = False,
                 host: str = "127.0.0.1",
                 device: str | torch.device | None = None,
                 conv_impl: str | None = None) -> None:
    """The MNIST chat app of the run dir (`setup_mnist`)."""
    from cfgan_torch.serve.apps import _require_gradio, build_mnist_app

    _require_gradio()
    engine, xte, yte, patch_size = setup_mnist(results_dir, device=device,
                                               conv_impl=conv_impl)
    app = build_mnist_app(engine, xte, yte, patch_size)
    app.launch(server_name=host, share=share)


def launch_house(results_dir: str, share: bool = False,
                 host: str = "127.0.0.1",
                 device: str | torch.device | None = None) -> None:
    """The house app of the run dir (`setup_house`)."""
    from cfgan_torch.serve.apps import _require_gradio, build_house_app

    _require_gradio()
    engine, xte, yte, schema, stats, bins = setup_house(results_dir,
                                                        device=device)
    app = build_house_app(engine, xte, yte, schema, stats, bins)
    app.launch(server_name=host, share=share)


def launch_moons(results_dir: str, share: bool = False,
                 host: str = "127.0.0.1",
                 device: str | torch.device | None = None) -> None:
    """The moons app of the run dir (`setup_moons`)."""
    from cfgan_torch.serve.apps import _require_gradio, build_moons_app

    _require_gradio()
    engine, clf_fn, xte, yte = setup_moons(results_dir, device=device)
    app = build_moons_app(engine, clf_fn, xte, yte)
    app.launch(server_name=host, share=share)


SETUPS = {"mnist": setup_mnist, "house": setup_house, "moons": setup_moons}
LAUNCHERS = {"mnist": launch_mnist, "house": launch_house,
             "moons": launch_moons}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--app", required=True, choices=sorted(SETUPS))
    ap.add_argument("--results", default=None,
                    help="run dir (default: results/<app>_countergan)")
    ap.add_argument(
        "--host", default=os.environ.get("CFGAN_SERVE_HOST", "127.0.0.1"),
        help="bind address; loopback by default (serving on every "
        "interface is an explicit opt-in: --host 0.0.0.0)")
    ap.add_argument("--share", action="store_true",
                    help="a public gradio link (the app only)")
    ap.add_argument("--api", action="store_true",
                    help="serve the HTTP API (cfgan_torch.serve.api, no "
                    "gradio needed) instead of the gradio app")
    ap.add_argument("--port", type=int, default=8000,
                    help="API port (0: a free one, printed on start; only "
                    "with --api)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--shard", action="store_true",
                    help="data-parallel serving over all local cards "
                    "(engine.shard on a 1-D mesh; only with --api)")
    args = ap.parse_args(argv)
    if args.shard and not args.api:
        ap.error("--shard serves the HTTP API: pass --api too")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = args.results or DEFAULT_RESULTS[args.app]
    if not args.api:
        from cfgan_torch.serve.apps import _require_gradio

        try:
            _require_gradio()
        except ImportError as e:
            sys.exit(f"cfgan_torch.serve.launch: {e}")
        LAUNCHERS[args.app](results, args.share, args.host,
                            device=args.device)
        return
    from cfgan_torch.serve.api import serve

    out = SETUPS[args.app](results, device=args.device)
    engine = out[0]
    if args.shard:
        from cfgan_torch.parallel.mesh import create_mesh

        engine.shard(create_mesh(devices=None if args.device is None
                                 else [args.device]))
    x_test = out[2] if args.app == "moons" else out[1]
    # one request before the first client's: builds and first calls
    # happen here
    engine.generate(x_test[:1], 0)
    engine.classify(x_test[:1])
    serve(engine, args.host, args.port)


if __name__ == "__main__":
    main()
