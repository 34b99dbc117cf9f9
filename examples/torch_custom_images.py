"""Bring your own image dataset to the PyTorch port (`cfgan_torch`): the
port of `examples/custom_images.py`.

The image CounteRGAN takes any image size and class count:
`ImageResidualGenerator`, the classifier and the conditional
discriminator take `image_hw` and `num_classes`, and patch masks are cut
from any (H, W, patch_size) grid.  This example makes a synthetic 20x20
three-class shape dataset (horizontal bar, vertical bar, cross) and runs
the promptable counterfactual stack on it:

  1. data in [-1, 1] NHWC (the framework's image convention);
  2. CNN classifier pretraining;
  3. CounteRGAN training (residual generator, conditional conv
     discriminator, the four-term loss) through the epoch runner, as the
     MNIST flagship trains, at 20x20 with a 4x4 grid of 5-px patches;
  4. the all-target evaluation (flip rate per target);
  5. promptable serving: "only these patches may change", through
     `CounterfactualEngine.mask_from_patches`.

On the CUDA card:  python examples/torch_custom_images.py
(`--device cpu` runs it on the CPU.)  It imports neither JAX nor the JAX
package.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

# run straight from a checkout (pip install -e . works too)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HW = (20, 20)
NUM_CLASSES = 3
ALLOWED_PATCHES = [1, 2, 5, 6, 9, 10, 13, 14]  # a vertical strip of the grid


def make_shape_dataset(n: int = 1800, seed: int = 3):
    """Three classes of 20x20 images: horizontal bar, vertical bar, cross.
    Position and thickness jitter and noise make it a real (but easy)
    task."""
    rng = np.random.RandomState(seed)
    h, w = HW
    x = np.full((n, h, w, 1), -1.0, np.float32)
    y = rng.randint(0, 3, n).astype(np.int32)
    for i in range(n):
        r = rng.randint(5, h - 5)
        c = rng.randint(5, w - 5)
        t = rng.randint(1, 3)
        if y[i] in (0, 2):  # horizontal stroke
            x[i, r - t:r + t, 2:w - 2, 0] = 1.0
        if y[i] in (1, 2):  # vertical stroke
            x[i, 2:h - 2, c - t:c + t, 0] = 1.0
    x += rng.normal(0, 0.08, x.shape).astype(np.float32)
    return np.clip(x, -1, 1), y


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def main(device: str | None = None, clf_epochs: int = 3,
         epochs: int = 8) -> dict:
    """Train, evaluate and serve on `device` (None: the CUDA card; raises
    where there is none).  Returns the classifier's test accuracy, the
    per-target flip rates and their mean, and the largest edit outside
    the allowed patches; raises AssertionError where the classifier
    reads 0.9 or less, the mean flip rate is 0.7 or less, or an edit
    leaks outside the mask."""
    import torch

    from cfgan_torch.core.config import (
        ClassifierConfig,
        CounterGANConfig,
        MaskConfig,
    )
    from cfgan_torch.core.device import resolve_device
    from cfgan_torch.eval.metrics import (
        MNIST_PROTOCOL,
        make_per_target_sweep,
        per_target_metrics,
    )
    from cfgan_torch.models.classifiers import CNNClassifier
    from cfgan_torch.train.builders import (
        build_mnist_countergan,
        live_g_variables,
        mnist_engine,
    )
    from cfgan_torch.train.classifier import make_eval_fn, train_classifier
    from cfgan_torch.train.loop import train_countergan_loop

    dev = resolve_device(device)
    x, y = make_shape_dataset()
    n_train = int(0.8 * len(y))
    xtr, ytr, xte, yte = x[:n_train], y[:n_train], x[n_train:], y[n_train:]

    # ---- classifier (its flatten width follows the 20x20 images) ----
    clf_model = CNNClassifier(num_classes=NUM_CLASSES, image_hw=HW,
                              generator=torch.Generator().manual_seed(0))
    train_classifier(
        clf_model,
        ClassifierConfig(arch="cnn", lr=1e-3, epochs=clf_epochs,
                         batch_size=64),
        (xtr, ytr), seed=0, num_classes=NUM_CLASSES, device=dev)
    logits_fn, accuracy = make_eval_fn(clf_model)
    acc = accuracy(xte, yte)
    print(f"classifier test accuracy: {acc:.3f}")
    _check(acc > 0.9, "classifier failed to learn the toy task")

    # ---- CounteRGAN at a custom resolution: 4x4 grid of 5-px patches ----
    cfg = CounterGANConfig(
        epochs=epochs, lr_g=1e-3, lr_d=1e-3, adv_loss="bce",
        reg_reduction="mean_abs", clamp_cf=(-1.0, 1.0),
        resample_target=False, lambda_cls=2.0, lambda_reg_l1=2.5,
        lambda_mask=2.0, hidden_dim=12, num_res_blocks=2,
        mask=MaskConfig(kind="patch", patch_size=5,
                        num_modifiable_patches=8),
    )
    bundle = build_mnist_countergan(cfg, clf_model.state_dict(), seed=0,
                                    device=dev, num_classes=NUM_CLASSES,
                                    image_hw=HW)
    state, _ = train_countergan_loop(bundle, xtr, ytr, epochs=cfg.epochs,
                                     batch_size=64, seed=0)

    # ---- all-target evaluation, all-ones mask ----
    g_vars = live_g_variables(state)
    sweep = make_per_target_sweep(bundle.cf_fn, logits_fn, NUM_CLASSES,
                                  **MNIST_PROTOCOL)
    table = per_target_metrics(
        sweep, g_vars, xte, yte,
        mask_fn=lambda b: torch.ones((b, *HW, 1), device=dev),
        num_classes=NUM_CLASSES, batch_size=512)
    for row in zip(*table.values()):
        print("  ".join(f"{k}={v:.4f}" if isinstance(v, float) else
                        f"{k}={v}" for k, v in zip(table, row)))
    mean_flip = float(np.mean(table["class_flip_rate"]))
    _check(mean_flip > 0.7, "counterfactuals too weak")

    # ---- promptable serving: edits only in the chosen patches ----
    engine = mnist_engine(bundle, logits_fn, state=state, device=dev)
    sample = xte[yte == 0][:1]  # one horizontal bar
    mask = engine.mask_from_patches(ALLOWED_PATCHES, 1, HW)
    res = engine.generate(sample, target=1, mask=mask)
    outside = np.abs(res.x_cf - sample) * (1 - mask.cpu().numpy())
    print(f"target 1 via vertical-strip patches: pred={res.pred[0]} "
          f"confidence={res.confidence[0]:.2f} "
          f"max |edit| outside mask = {outside.max():.1e}")
    _check(outside.max() == 0.0, "edit leaked outside the allowed patches")
    print("custom-images example OK")
    return {"accuracy": acc, "class_flip_rate":
            [float(v) for v in table["class_flip_rate"]],
            "mean_flip_rate": mean_flip,
            "max_edit_outside_mask": float(outside.max())}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    main(parser.parse_args().device)
