"""The plain-generation GAN experiments on the port (mirrors
`cfgan/experiments/generation.py`), the four non-CounteRGAN reference
families behind one entry point:

    python -m cfgan_torch.experiments.generation --preset NAME
        [--epochs N] [--limit N] [--out-dir D] [--seed N] [--device cpu]

NAME is simple_gan_moons, simple_gan_mnist, cgan_moons, wgan_gp_mnist or
dcgan_mnist.  A run loads the preset's data (DCGAN's MNIST resized to
64x64 on the device), trains through the epoch runner, prints the JAX
run's line every `max(1, epochs // 10)` epochs, samples the fixed noise
there (image presets: a uint8 grid a frame), and writes `generator/`, the
generator's variables in the flax-msgpack layout that the JAX package's
`cfgan.core.checkpoint` restores, and the JAX run's figures: `loss.png`,
and for the image presets `samples.png` (the fixed noise's samples),
`real_samples.png` (the first 64 training images) and, with more than one
frame, `training_animation.gif` (5 frames a second); for the moons
presets `generated.png` (the training points against the samples).
"""
from __future__ import annotations

import argparse
import os
import time
from dataclasses import replace

import torch
import torch.nn.functional as F

from cfgan_torch.convert import flax_from_state_dict, state_dict_from_flax
from cfgan_torch.core import checkpoint as ckpt
from cfgan_torch.core.config import ExperimentConfig
from cfgan_torch.core.device import resolve_device
from cfgan_torch.core.logging import setup_compile_cache
from cfgan_torch.data.pipeline import epoch_perm
from cfgan_torch.data.registry import load_dataset
from cfgan_torch.eval.samples import (
    make_gif,
    save_image_grid,
    save_loss_plot,
    save_scatter,
    to_uint8_grid,
)
from cfgan_torch.experiments import presets
from cfgan_torch.nn.layers import one_hot
from cfgan_torch.train.builders import live_g_variables
from cfgan_torch.train.gan_builders import GANBundle, build_gan
from cfgan_torch.train.loop import epoch_generators

GENERATION_PRESETS = tuple(p.name for p in presets.GENERATION_PRESETS)
FIXED_NOISE_SEED = 7


def resize_images(x: torch.Tensor, size: int) -> torch.Tensor:
    """NHWC images resized to `size` x `size`, bilinear with half-pixel
    centres and no antialiasing (`F.interpolate(align_corners=False)`),
    on their device: the JAX run's `jax.image.resize(..., "bilinear")`
    for an upsampling (`mnist_dcgan.py:42-46`)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).contiguous()


def fixed_noise(bundle: GANBundle, device, seed: int = FIXED_NOISE_SEED,
                per_class: int = 8, total: int = 64):
    """(z, label one-hot or None, labels or None) of the progress samples:
    `per_class` rows of each class for a conditional family (classes
    cycling), else `total` rows; drawn on the CPU from `seed`, so the card
    and the CPU sample the same noise."""
    gen = torch.Generator().manual_seed(seed)
    if not bundle.num_classes:
        z = torch.randn((total, bundle.latent_dim), generator=gen)
        return z.to(device), None, None
    n = per_class * bundle.num_classes
    z = torch.randn((n, bundle.latent_dim), generator=gen).to(device)
    labels = torch.arange(bundle.num_classes, device=device).repeat(
        per_class)
    return z, one_hot(labels, bundle.num_classes, torch.float32), labels


def load_generator(path: str, bundle: GANBundle) -> dict[str, torch.Tensor]:
    """The generator variables of a `generator/` checkpoint (either
    package's), on the bundle's device."""
    g_model = bundle.g_model
    dev = next(g_model.parameters()).device
    template = flax_from_state_dict(g_model, g_model.state_dict())
    return {k: v.to(dev) for k, v in state_dict_from_flax(
        g_model, ckpt.restore(path, template)).items()}


def run(preset: str | ExperimentConfig, epochs: int | None = None,
        limit: int | None = None, out_dir: str | None = None,
        seed: int | None = None, device: str | torch.device | None = None,
        log=print) -> dict:
    """Train the preset (a name of GENERATION_PRESETS, or an
    `ExperimentConfig` with a `gan`) into `out_dir` (default
    `cfg.out_dir/cfg.name`) on `device` (None: the CUDA card).  Returns
    the bundle, the history (the JAX run's keys: each metric's epoch
    means, and `wall_time_s`), the fixed noise, the final fixed-noise
    samples as numpy and, for image presets, the uint8 frames."""
    cfg = presets.PRESETS[preset] if isinstance(preset, str) else preset
    if epochs is not None:
        cfg = cfg.replace(gan=replace(cfg.gan, epochs=epochs))
    seed = cfg.seed if seed is None else seed
    dev = resolve_device(device)
    out_dir = out_dir or os.path.join(cfg.out_dir, cfg.name)
    os.makedirs(out_dir, exist_ok=True)

    data = load_dataset(cfg.data, limit=limit)
    x, y = data["train"]
    is_image = x.ndim == 4
    x = torch.as_tensor(x).to(dev)
    y = torch.as_tensor(y).to(dev, torch.long)
    if cfg.data.resize_to:
        x = resize_images(x, cfg.data.resize_to)
    bundle = build_gan(cfg.gan, num_classes=data["num_classes"], seed=seed,
                       device=dev)
    state = bundle.state
    z_fix, oh_fix, labels = fixed_noise(bundle, dev)
    history: dict[str, list] = {}
    frames = []
    total = cfg.gan.epochs
    sample_epochs = max(1, total // 10)
    t0 = time.perf_counter()
    for epoch in range(total):
        g_perm, g_draws = epoch_generators(seed, epoch, dev)
        perm = epoch_perm(g_perm, len(y), cfg.data.batch_size)
        draws = bundle.draw_fn(g_draws, tuple(perm.shape))
        metrics = bundle.epoch_fn(state, x, y, perm, draws)
        for k, v in metrics.items():
            history.setdefault(k, []).append(float(v))
        if (epoch + 1) % sample_epochs == 0 or epoch == total - 1:
            line = ", ".join(f"{k}={history[k][-1]:.4f}"
                             for k in ("d_loss", "g_loss", "d_real",
                                       "d_fake"))
            log(f"[{cfg.name}] epoch {epoch+1}/{total} :: {line}")
            if is_image:
                fake = bundle.sample_fn(state.g.model.state_dict(), z_fix,
                                        oh_fix)
                frames.append(to_uint8_grid(fake.cpu().numpy(), nrow=8))
    history["wall_time_s"] = time.perf_counter() - t0

    g_vars = live_g_variables(state)
    ckpt.save(os.path.join(out_dir, "generator"),
              flax_from_state_dict(bundle.g_model, g_vars))
    samples = bundle.sample_fn(g_vars, z_fix, oh_fix).cpu().numpy()
    save_loss_plot(history, os.path.join(out_dir, "loss.png"))
    if is_image:
        save_image_grid(samples, os.path.join(out_dir, "samples.png"),
                        nrow=bundle.num_classes or 8)
        if len(frames) > 1:
            make_gif(frames, os.path.join(out_dir, "training_animation.gif"),
                     fps=5)
        save_image_grid(x[:64].cpu().numpy(),
                        os.path.join(out_dir, "real_samples.png"), nrow=8)
    else:
        save_scatter(x.cpu().numpy(), samples,
                     os.path.join(out_dir, "generated.png"),
                     labels=None if labels is None else labels.cpu().numpy())
    log(f"[{cfg.name}] done in {history['wall_time_s']:.1f}s -> {out_dir}")
    return {"bundle": bundle, "history": history,
            "fixed_noise": (z_fix, oh_fix, labels), "samples": samples,
            "frames": frames}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--preset", required=True, choices=GENERATION_PRESETS)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--out-dir", type=str, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    setup_compile_cache()  # where the kernel and data libraries build
    run(args.preset, epochs=args.epochs, limit=args.limit,
        out_dir=args.out_dir, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
