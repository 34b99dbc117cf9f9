"""`python -m cfgan_torch`: what the port runs, and its presets."""
from __future__ import annotations


def main() -> None:
    from cfgan_torch.experiments.presets import PRESETS

    print(__doc__.strip())
    print("""
Experiments (classifier pretrain -> CounteRGAN train -> selection -> eval):
  python -m cfgan_torch.experiments.moons_countergan  [--seed N] [--epochs N] [--clf-steps N] [--reference] [--device cpu]
  python -m cfgan_torch.experiments.mnist_countergan  [--seed N] [--epochs N] [--clf-epochs N] [--limit N] [--fresh] [--legacy] [--device cpu]
  python -m cfgan_torch.experiments.mnist_countergan2 --target C [--epochs N] [--clf-epochs N] [--limit N] [--out-dir D] [--fresh] [--device cpu]
  python -m cfgan_torch.experiments.house_countergan  [--seed N] [--epochs N] [--clf-epochs N] [--limit N] [--preset NAME] [--device cpu]

The CounteRGAN step's memory options (CounterGANConfig fields):
  remat=True        run the generator's residual blocks again in the backward
  g_microbatch=K    the generator update in K equal micro-batches

Plain generation (the simple, conditional, DCGAN and WGAN-GP families):
  python -m cfgan_torch.experiments.generation --preset simple_gan_moons|simple_gan_mnist|cgan_moons|wgan_gp_mnist|dcgan_mnist [--epochs N] [--limit N] [--out-dir D] [--seed N] [--device cpu]

Data-parallel training over a torch.distributed world (one process a card):
  torchrun --nproc-per-node N your_script.py   # multihost_initialize(); train_countergan_loop(..., mesh=create_mesh())
  cfgan_torch.parallel.spawn_world(fn, N)      # the same on one host without torchrun

Serving (the HTTP API; cfgan_torch.serve.CFClient speaks to it):
  python -m cfgan_torch.serve.launch --app mnist|house|moons --api [--results DIR] [--port P] [--host H] [--device cpu] [--shard]
The promptable gradio apps (need gradio):
  python -m cfgan_torch.serve.launch --app mnist|house|moons [--results DIR] [--host H] [--share] [--device cpu]

Import the PyTorch reference's checkpoints: cfgan_torch.migrate.import_*

Smoke run on one CUDA card (repo checkout):
  python3 chip_smoke.py

Presets:""")
    for name in sorted(PRESETS):
        print(f"  {name}")


if __name__ == "__main__":
    main()
