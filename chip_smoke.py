#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`cfgan_torch`) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one
                                 # CUDA card and nvcc (CUDA_HOME or PATH)

It builds the port's CUDA kernels (`cfgan_torch/csrc/*.cu`, one `nvcc` a
source, all started together) from the sources in the checkout and holds
each against its plain PyTorch version on the card: the 3x3 conv (bf16,
and f32 as 3xTF32, on the tensor cores; forward and its dx), the conv's
weight gradient dK (bf16 and 3xTF32 f32 on the tensor cores), and the
fused counterfactual epilogue's forward and backward (its 16-byte and
4-byte variants, the latter for rows that are not 16-byte aligned).  Then
it drives the port's two paths at the full width of the shipped MNIST
CounteRGAN preset (64 channels, 6 residual blocks, bf16 compute), on
random weights made from a seed:

- serving (`build_mnist_serving`, `CounterfactualEngine`) with
  `conv_impl="pallas"`: every generator forward launches the conv kernel
  13 times, the served results equal the same requests served with the
  plain conv, and an all-zero mask returns x bit for bit;
- training (`build_mnist_countergan`, `step_fn`) at batch 128: ten steps
  launch the epilogue kernels once (forward) and once (backward) per step,
  and give the losses of the same steps with the plain epilogue, in bf16
  and (three steps) in f32; three steps with `conv_impl="pallas"` launch
  the conv kernel 13 times forward and 13 times for dx per step, and the
  dK kernel 13 times per step, and take the gradients (Adam's first
  moments after the first step) of the same steps with the plain conv;
  its `exports` part imports the twelve subpackages and resolves every
  exported name, then on the bf16 bundle: one generator forward and one
  epilogue forward, `countergan_g_terms` against the kernel's
  `epilogue_terms`, the backward (one epilogue backward, 13 dx and 13 dK
  launches), `global_grad_norm` against `vector_norm`, and engines
  served from `g_eval_variables` with and without the EMA, bit for bit
  those served from the same variables assembled by hand.

Then it trains end to end:

- `data`: the port's synthetic MNIST corpus at its real size (60,000
  train and 10,000 test images, `load_mnist` before any `limit`);
- `epoch runner`: the preset at batch 128 on that dataset, held on the
  card, with cuDNN's convs and with `conv_impl="pallas"`: 24 steps
  through the epoch runner (3 eager, then a captured CUDA graph
  replayed) equal the same 24 steps run eagerly, bit for bit; the
  profiler counts the kernels of each replayed step (one epilogue
  forward and one backward; with the conv kernel 26 conv and 13 dK
  launches); the replays run with `torch.cuda.set_sync_debug_mode
  ("error")`; replayed and eager steps are timed in turns, the eager
  step's device time read from a trace of 3;
- `pipeline`: the same preset with `conv_impl="pallas"` at batch 128, 24
  eager steps fed by `DevicePrefetcher` (two copies in flight, pinned
  host buffers, a copy stream of its own) from a shuffled `HostIterator`
  over the train split, equal bit for bit (batches, metrics, parameters,
  statistics, Adam) to the same steps on the split held on the card
  (`device_put_dataset`) and gathered by index; the wrappers' launches
  (26 conv, 13 dK, 1 + 1 epilogue a step) and a profiler trace's (13 dK
  reductions too); the trace's batch copies all pinned, on one stream no
  kernel runs on; at most buffer_size + 1 pinned buffers an array, none
  a batch; both feeds' steps timed in turns with their device idle
  share; the native normaliser on
  the 60,000 train images and the native IDX reader on
  `tests/fixtures/mnist_idx` against their plain versions, host ms;
- `experiment`: `cfgan_torch.experiments.mnist_countergan.run` at full
  width (12,800 images, 2 classifier epochs, 4 GAN epochs, snapshot
  selection every 2) into a scratch directory under `build/`, then again
  on the same directory, which must train nothing and write the same
  per-target and patch-budget CSVs; the port's provenance check must
  accept the run dir.

Then the legacy delta-generator stack (`MNIST_COUNTERGAN_LEGACY`: the
delta generator at hidden 32, the unconditional conv discriminator, the
MaxPool classifier, float32, clipped-log losses, a fixed target, all-ones
masks) and the step's memory options:

- `legacy train`: 10 eager steps at batch 128 on the corpus launch the
  epilogue kernels once forward and once backward a step at (128, 784),
  and give the losses of the same steps on the plain epilogue;
- `legacy epoch runner`: 27 steps through the epoch runner (3 eager, 24
  replayed under sync debug mode "error") equal to the same steps eager,
  bit for bit; the profiler's launches a replayed step (1 + 1);
  replayed and eager steps timed in turns;
- `legacy experiment`: `python -m cfgan_torch.experiments.
  mnist_countergan2 --target 5` (the preset's hidden 64) on 12,800
  images, one classifier and one GAN epoch: the run dir and its three
  PNG grids, read back (`read_png`, CRCs checked) and equal to
  `to_uint8_grid` of the same arrays; the rerun loads the checkpoints
  and writes the same bytes;
- `memory options`: the shipped MNIST preset (bf16) at batch 128 with
  `remat` off and on x `g_microbatch` 0, 2 and 4, with cuDNN's convs and
  with the conv kernel: an eager step's launches against
  `memory_launches` (K + 1 epilogue forwards and K backwards; on the
  kernel route 13 conv launches a generator forward and 13 a dx, 13 dK a
  backward, and with `remat` the residual blocks' 12 again) and its peak
  memory, 5 steps through the epoch runner (3 eager, 2 replayed) equal
  to eager bit for bit, the plain epilogue's losses, and the replayed
  step timed in turns against the arm without options; then float32 at
  batch 1024 (remat x K in {0, 4}): peak memory and the eager step.

Then images of another size and class count, and a table of another
schema:

- `custom shapes`: the shipped MNIST preset (64 channels, 6 blocks,
  bf16, EMA 0.999) built with `num_classes=3, image_hw=(20, 20)`, the
  image example's 4x4 grid of 5-px patches and the conv kernel, on that
  example's shape data: the conv (forward and dx) and dK, bf16 and f32,
  at (128 and 64, 20, 20, 64, 64), and the epilogue at (128, 400), (64,
  400) and the credit rows' (128, 7) (the 4-byte variant), against their
  plain versions at the bars of the 28x28 shapes; 3 eager steps at batch
  128 and 64, bf16 and f32 (26 conv, 13 dK, 1 + 1 epilogue launches a
  step), against the same steps on the plain conv; one epoch replayed by
  the epoch runner equal to eager, bit for bit; the served preset at
  20x20 equal to cuDNN's route on the same weights (13 conv launches a
  forward, b=64 among them), no edit outside a patch mask; the device
  times of those shapes, their bounds and cuDNN's times;
- `examples`: `examples/torch_custom_images.py` and
  `examples/torch_custom_tabular.py` whole, at their shipped sizes, with
  their own checks (classifier accuracy over 0.9, mean flip rate over
  0.7, no edit outside the allowed patches; only the allowed features
  changed).

Then the figures, drawn by the port's own raster (`cfgan_torch/eval/
figure.py`; the card's machine has no matplotlib):

- `figures`: the committed `results/mnist_countergan_seed43/` generator
  and classifier (the shipped preset: 64 channels, 6 blocks, bf16) with
  `conv_impl="pallas"` draw the counterfactual grid (one forward at
  B = 100), the heatmap panels (B = 8), the patch-budget curve (8
  forwards at B = 512), the patch grid and the user-modification example
  (B = 1) into `build/smoke_figures/`: 13 conv kernel launches a
  generator forward, counted per figure; the kernel against its plain
  version at (100 | 8 | 512, 28, 28, 64, 64), bf16 and f32; the grid's
  x_cf against a float32 route (no farther than the bf16 cuDNN route's,
  within API_KERNEL_SLACK) and its flips against cuDNN's route (equal
  but where a target's logit margin is under 2**-7, counted); every PNG
  read back with zlib, its size and pixels equal to `render()`; each
  figure's host ms; the kernel's device ms at B = 100, 8 and 512 beside
  `F.conv2d` and the bound.  The experiment phases' run dirs must hold
  the committed JAX run dirs' figure files, no more and no fewer.

Then the King County house CounteRGAN (the shipped `HOUSE_COUNTERGAN`
preset at full width: 32 wide, 5 FiLM blocks, batch 128, float32):

- `house data`: the synthetic table (21,613 rows: 17,290 train, 4,323
  test), its class counts and price-quartile edges;
- `house train`: 10 eager steps on the card launch the epilogue kernels
  once forward and once backward a step, in the 4-byte variant ((128,
  17) rows), give the losses of the same steps on the plain epilogue,
  and advance each critic layer's power-iteration `u` exactly once a
  step (held against a plain power iteration on the weights);
- `house epoch runner`: one epoch (135 steps) replayed as a CUDA graph
  equals the same steps eager, bit for bit (metrics, parameters,
  BatchNorm statistics, `u`, EMA, Adam); replayed epochs and the first
  24 eager steps are timed in turns; then an epoch of those 24 steps is
  captured and replayed, and the profiler counts one epilogue forward and
  one backward launch a replayed step in its trace;
- `house experiment`: `cfgan_torch.experiments.house_countergan.run` at
  full width on the synthetic table (5 classifier epochs, 20 GAN
  epochs, snapshot selection every 10), then the rerun that loads it and
  writes every CSV (per-target, feature shifts, class pairs, case
  studies, mask policies) again byte for byte; the provenance check must
  accept the run dir;
- `house serve`: `house_engine` on the committed
  `results/house_countergan/{classifier,generator}` (the experiment's
  run dir where a checkout lacks them): `generate` at b=1 and b=128 and
  `generate_bulk` on the test rows, padded and unpadded requests equal,
  the card's counterfactuals against the same engine's on the CPU.

Then the moons CounteRGAN (the shipped `MOONS_COUNTERGAN` preset at full
width: hidden 32, critic 32/16/16, batch 64, float32, no clamp):

- `moons data`: `load_moons3`'s 960 train and 240 test points and their
  class counts;
- `moons train`: 10 eager steps launch the epilogue kernels once forward
  and once backward a step, in the 4-byte variant ((64, 2) rows, bounds
  -1e30 and 1e30), give the losses of the same steps on the plain
  epilogue, and advance each critic layer's `u` exactly once a step;
- `moons epoch runner`: one epoch (15 steps) replayed as a CUDA graph
  equals the same steps eager, bit for bit (metrics, parameters,
  BatchNorm statistics, `u`, Adam); the profiler counts one epilogue
  forward and one backward a replayed step; replayed (10 epochs a turn)
  and eager steps are timed in turns;
- `moons experiment`: `cfgan_torch.experiments.moons_countergan.run` of
  the full shipped preset (1,000 full-batch classifier steps, 500 GAN
  epochs, a snapshot every 50) into `build/`, then the rerun, which must
  train nothing and write the same two CSVs; the provenance check must
  accept the run dir; its per-target flips beside the committed
  `results/moons_countergan/`'s; then `run()` on copies of that committed
  run dir, on the card and on the CPU: neither trains, and their CSVs
  agree within 1e-5.

Then the four plain-generation families at their presets' shipped
widths (float32; the simple MNIST GAN's 1.5M + 0.5M parameters, DCGAN
at 64x64 with 64 hidden, WGAN-GP at size 1024, 23.6M + 14.3M):

- `gan train`: for each of the five generation presets, 11 eager steps
  (finite losses, both networks' parameters moved; WGAN-GP: G's
  parameters and its AdamW count move on global steps 0, 5 and 10 only,
  and G's BatchNorms run two train-mode forwards on those steps, one on
  the others), then one epoch (moons2's 2,000 points, or 6,400 of the
  corpus's training images) through the epoch runner equal to the same
  steps eager, bit for bit (metrics, parameters, BatchNorm statistics,
  Adam/AdamW; WGAN-GP's two graphs); none of the port's kernels
  launches on these paths;
- `gan epoch runner`: DCGAN and WGAN-GP at batch 128, an epoch of 10
  replayed steps against eager steps in turns, device busy ms and idle
  share, the longest device entries and the device records a replayed
  step in up to three profiler traces (the largest count; the tracing
  stops once two agree); WGAN-GP's
  critic-only step, its critic + G step and its five-step cycle timed
  apart, and the gradient penalty's share of the critic-only step;
- `generation`: `cfgan_torch.experiments.generation.run` of each preset
  (the moons presets whole, the MNIST ones 2 epochs on 12,800 images),
  each `generator/` restored by the port to the same samples bit for
  bit; the committed `results/simple_gan_moons/` and
  `results/cgan_moons/` generators sampled on the card and on the CPU
  within 1e-6 of the samples' scale.

Then the serving front door, `api`: the three launchers (`python -m
cfgan_torch.serve.launch --app mnist|house|moons --api --port 0`, on the
committed run dirs `results/mnist_countergan_seed43/`,
`results/house_countergan/` and `results/moons_countergan/`) as
subprocesses, each driven with `CFClient` over both wire formats
(classify, counterfactuals at b=1 and b=128, patch and feature masks,
two seeds, bulk over the whole test split, `/stats`) and equal bit for
bit to an in-process engine of the same `setup_*`; the MNIST weights
behind `make_server` with `conv_impl="pallas"` (13 conv kernel launches
a generator forward from serial requests, as close to the float32
result as the bf16 cuDNN route); 8 client threads x 25 mixed requests
against one server, each equal to its serial answer; and the wire's b=1
latency and bulk rate against the engine's own, in turns.  The launchers
exit 0 on SIGINT at the end.

Then the promptable front ends, `apps` (`cfgan_torch.serve.apps`; no
gradio, no LLM provider, no network): the MNIST chat backend on
`setup_mnist("results/mnist_countergan_seed43", conv_impl="pallas")`
(show a 3, turn it into an 8 using patches 5, 6, 9, 10, an unparseable
message, then one reply through a scripted LLM): 13 conv kernel
launches a transform, the same replies and picks as the same dialogue on
cuDNN's route, pred and confidence equal within 1e-2 and x_cf within
0.0234 (the two bf16 routes' gap on these weights at b=128); the house
backend on
`results/house_countergan/` (only bedrooms, bathrooms and grade
allowed, every other feature unmoved but where the clamp moves a value
outside [0, 1], rows in pandas' order); the moons backend on
`results/moons_countergan/` under each mask row ("none" returns x,
"x_only" / "y_only" keep the other coordinate); every PNG read back
equal to its `render()`; a synthetic reference-layout MNIST generator
imported by `cfgan_torch.migrate` and served in float32 on the kernel
route against cuDNN's (13 launches a forward); `python -m
cfgan_torch.serve.launch --app moons` exiting non-zero with the
ImportError's message where gradio is missing; the conv at b=1 timed.

Then the mesh and sharding layer, `sharded` (`cfgan_torch.parallel`):
the shipped preset with the conv kernel trained through
`train_countergan_loop(mesh=create_mesh())` on an NCCL world of one, its
step captured with the all-reduces inside and replayed, equal bit for
bit to the loop without a mesh; a world of two processes on the card
(gloo over CUDA tensors; with several cards one NCCL rank a card), each
rank three steps on its 64 rows of the global batch of 128, in f32 and
bf16, against the single-process steps and bit for bit against each
other; the f32 kernel engine sharded over the card twice against the
engine unsharded (a bulk chunk that does not split refused), and on a
("data", "model") mesh along each axis; the same two ranks on a (1, 2)
("data", "model") mesh with the generator's weights and Adam moments
channel-sharded over "model", three steps in f32 and bf16 against their
1-D steps, their launches, state bytes and eager step times in turns;
with four cards, a (2, 2) NCCL world's loop captured and replayed, bit
for bit against its eager steps, timed against the 1-D world of 4.

Then it times the kernels, their plain versions, cuDNN for the conv and
its weight gradient, the serving requests and the train step (bf16 with
cuDNN's convs and with the kernels, f32 with the kernels), and the
epilogue kernels at the house step's (128, 17) rows, the moons step's
(64, 2) rows and the micro-batched step's (64, 784) and (32, 784).

    python3 chip_smoke.py --phases "pipeline,custom shapes,examples,figures,apps,sharded"

builds the kernels and runs only the named phases (those that need
nothing of the others'; `pipeline` alone loads the corpus and makes a
random classifier itself), for iterating by hand; its last line says
which ran.

    python3 chip_smoke.py --train-timing-only

builds the kernels and runs only the `timing train` phase (the train
steps, and the epilogue kernels' device and host time per call): copied
to the root of another checkout (an earlier commit), it times that
checkout's train steps and epilogue kernels the same way.

Each phase prints one JSON line and its wall time.  The line before the
last is the card's `nvidia-smi` name and power limit; the last line is
`{"ok": true, "device": {...}}`.  Any failure exits non-zero before that
line is printed, as does a host with no CUDA card or a directory without
the `cfgan_torch` package beside this script.
"""
from __future__ import annotations

import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

HERE = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12,  # dense tensor cores
                  "tf32": 494.7e12,  # dense tensor cores
                  "float32": 67e12}  # outside the tensor cores
# the f32 conv kernels make three tf32 products of each product (3xTF32)
TF32_PRODUCTS = 3
# kernel vs plain version: f32 abs <= F32_ATOL (the two sum in other
# orders); bf16 within one bf16 ulp of the plain result rounded to bf16,
# plus F32_ATOL for the float32 sums' own difference, which decides the
# rounding where a sum nearly cancels
F32_ATOL = 1e-4
# f32 kernel vs plain (full float32, TF32 off), besides F32_ATOL: each
# output pixel's row of channels within F32_ROW_RTOL of its 2-norm.  One
# tf32 product (the plain version's matmuls with TF32 on) misses it.
F32_ROW_RTOL = 1e-5
# bf16 serving, kernel vs plain: the two round the same float32 sums to bf16
# and may differ by one ulp where a sum lies near a rounding boundary; that
# spreads through the later layers.  Allowed: one bf16 ulp at |x_cf| = 1,
# the edge of the clamp.
BF16_CF_ATOL = 2.0 ** -7
PROBS_ATOL = {"float32": 1e-4, "bfloat16": 1e-2}
KERNEL_LAYERS_PER_FORWARD = 13  # 12 resblock convs + conv_mid
RESBLOCK_KERNEL_LAYERS = 12  # what `remat` runs again in the backward
OUR_KERNELS = ("conv3x3_wgmma_ws_kernel", "conv3x3_wgmma_kernel",
               "conv3x3_tf32_ws_kernel", "conv3x3_tf32_ksplit_kernel",
               "conv3x3_tf32_kernel",
               "conv3x3_tf32_split_kernel", "conv3x3_dkernel_wgmma_kernel",
               "conv3x3_dkernel_tf32_ws_kernel",
               "conv3x3_dkernel_tf32_kernel", "dkernel_reduce_kernel",
               "epilogue_fwd_kernel", "epilogue_bwd_kernel")
# (B, H, W, Cin, Cout) the conv kernels are held at: the serving layer at
# batch 128 and 1 (the tensor-core kernel's narrow tiles); Cin not a
# multiple of 8 or 16 and W odd; Cin and Cout of the narrow test presets;
# a batch that is not a multiple of anything; the micro-batched step's
# chunks at g_microbatch 2 and 4 (dK sums over B*H*W, so its partial
# blocks change with the batch)
SERVING_SHAPE = (128, 28, 28, 64, 64)
CHUNK_SHAPES = ((64, 28, 28, 64, 64), (32, 28, 28, 64, 64))
CONV_SHAPES = (SERVING_SHAPE, (1, 28, 28, 64, 64), (2, 13, 11, 20, 40),
               (3, 28, 28, 16, 24), (9, 7, 5, 32, 64)) + CHUNK_SHAPES
# the dK kernel's cluster plan at its edges (held against its plain version
# beside CONV_SHAPES): a block count that is not a multiple of the cluster
# size, a grid of one cluster, a cluster with fewer pixel ranges than
# blocks, twice the preset's batch
DK_EDGE_SHAPES = ((5, 28, 28, 64, 64), (1, 5, 5, 64, 64), (1, 3, 5, 64, 64),
                  (256, 28, 28, 64, 64))
# the float32 dK's plan at its edges (held against its plain version beside
# CONV_SHAPES and DK_EDGE_SHAPES, float32): the 20x20 preset's layer at
# B=64, 13 rows in stages of several rows, Cin 132 (a third slice of one
# 32-channel box), Cout 132 (a fifth 32-wide tile of 4 channels), Cin 20 /
# Cout 44 (multiples of 4, not of 8), and the cp.async body's shapes: Cin
# 130, Cout 130 (not multiples of 4) and W 130 (a padded row wider than a
# stage)
DK_F32_EDGE_SHAPES = ((64, 20, 20, 64, 64), (128, 13, 11, 64, 64),
                      (8, 28, 28, 132, 64), (8, 28, 28, 64, 132),
                      (40, 28, 28, 20, 44), (2, 6, 6, 130, 70),
                      (4, 13, 11, 20, 130), (2, 4, 130, 64, 64))
# the bf16 conv's plan at its edges (held against the plain version beside
# CONV_SHAPES, bf16, forward and dx): the figures' heatmaps (B=8: one tile
# a block, taps split over the consumers), 2,352 pixels (not a multiple of
# 64), 126 tiles (a cluster holds a block without a tile), Cin over two
# TMA slices at a batch too small for the TMA body and at one that takes
# it (K reloaded through the cluster every round), and TMA bodies whose
# stored box overhangs y: 13 rows in tiles of 7 and of 4 rows, Cout 72 and
# 96 (a second, part-filled 64-channel tile)
CONV_EDGE_SHAPES = ((8, 28, 28, 64, 64), (3, 28, 28, 64, 64),
                    (9, 28, 28, 64, 64), (2, 28, 28, 128, 64),
                    (32, 28, 28, 128, 64), (128, 13, 11, 64, 64),
                    (20, 13, 11, 64, 64), (128, 28, 28, 64, 72),
                    (128, 28, 28, 64, 96))
# the float32 conv's plan at its edges (held against the plain version
# beside CONV_SHAPES, float32, forward and dx): Cin 96 (the TMA body's
# third 32-channel slice), 259 tiles (not a multiple of any cluster
# size), Cout 36 (the second 32-channel half of a Cout tile part-filled),
# Cin 20 / Cout 44 (multiples of 4, not of 8), 13 rows in tiles of 7 rows
# (the last tile's rows overhang y), the 20x20 preset's layer
F32_EDGE_SHAPES = ((64, 28, 28, 96, 64), (37, 28, 28, 64, 64),
                   (128, 28, 28, 64, 36), (40, 28, 28, 20, 44),
                   (128, 13, 11, 64, 64), (128, 20, 20, 64, 64))
# dK kernel vs plain, both float32 before the cast: each tap's (Cin, Cout)
# block within DK_RTOL of its 2-norm.  The two sum up to B*H*W = 100,352
# products per entry in other orders (the kernel per block of pixels, then
# the blocks' partials; in f32 of 3xTF32 products).
DK_RTOL = 1e-5
# epilogue kernels vs plain: the elementwise outputs (x_cf, dx, draw) are the
# same float32 operations rounded at the same places (the kernels do not
# contract them into FMAs): abs <= EPI_ATOL; the row sums are taken in
# another order: rel <= EPI_SUM_RTOL
EPI_ATOL = 1e-6
EPI_SUM_RTOL = 1e-5
# (B, N, misaligned): the step's rows (the 16-byte variant), more rows than
# SMs, N % 4 != 0 and N < 4 (the 4-byte variant), rows longer than one
# block's quads, and the step's rows one element into their storage (the
# 4-byte variant)
# the house step's rows, (128, 17), and the moons step's, (64, 2), take
# the 4-byte variant too
# the micro-batched step's chunks, (64, 784) and (32, 784), the 16-byte
# variant
EPI_CASES = ((128, 784, False), (257, 784, False), (3, 17, False),
             (5, 2, False), (64, 4096, False), (128, 784, True),
             (128, 17, False), (64, 2, False), (64, 784, False),
             (32, 784, False))
EPI_BOUNDS = ((-1.0, 1.0), (-1e30, 1e30))  # clamp, no clamp
# the smoke's train step: the preset's batch, and 10 steps (3 in f32 and
# with the conv kernel)
TRAIN_BATCH = 128
TRAIN_STEPS = 10
SHORT_STEPS = 3
# the same steps with the kernel and the plain epilogue (cuDNN set
# deterministic): the kernels give the plain versions' x_cf, dx and draw,
# so both runs take the same gradients; their losses differ by the order
# of the row sums (~1e-6), and in bf16 such a difference may flip a later
# rounding.  Per-step d_loss and g_loss abs <= TRAIN_ATOL[dtype].
TRAIN_ATOL = {"bfloat16": 1e-3, "float32": 1e-4}
# conv kernel vs plain conv over SHORT_STEPS steps, in bf16 and f32, from
# one initial state and the same draws: per-step d_loss and g_loss abs <=
# TRAIN_ATOL[dtype].  The gradients are held against each other through
# Adam's first moments after the first step (0.1 * grad): every weight leaf
# (conv and linear kernels, embeddings, BatchNorm scales) within
# PALLAS_MU_RTOL[dtype] of its 2-norm.  Bias leaves are left out: the conv
# biases that a BatchNorm follows have a true gradient of zero, so theirs
# is rounding noise.  In f32 the parameters after the steps are compared
# too: Adam's first steps move a parameter by about lr whatever its
# gradient, so a component whose gradient is near zero may take another
# sign and end up to 2 * lr apart, but at most PALLAS_F32_OUTLIER_SHARE of
# the parameters differ by more than lr / 10.  In bf16 a larger share
# does, and the moments carry the check.  Measured on an H100 (worst leaf,
# G and D): f32 8.6e-5 and 1.3e-6, bf16 0.031 and 0.040.
PALLAS_MU_RTOL = {"float32": 1e-3, "bfloat16": 0.2}
PALLAS_F32_OUTLIER_SHARE = 1e-2
# the epoch runner's compared epoch: RUNNER_STEPS steps at batch 128 of
# which the first WARMUP_STEPS run eagerly and the rest replay the
# captured graph; the eager run of the same steps takes the same kernels on the
# same inputs (cuDNN deterministic), so the bar is bit for bit: every
# step's d_loss and g_loss, and every parameter, statistic, EMA leaf and
# Adam tensor after the steps
RUNNER_STEPS = 24
# the eager steps a profiler trace reads the eager step's device time
# from: each holds ~1,000 kernels and their host ops, and a trace is read
# back slowly
EAGER_PROFILE_STEPS = 3
# the eager steps a profiler trace of `timing train` holds
TIMING_PROFILE_STEPS = 3
# each replayed step's launches of our kernels, by the profiler: the
# epilogue forward and backward once; with conv_impl="pallas" 13 conv
# launches forward and 13 for dx (the bf16 conv's TMA body), and 13 dK
# launches (each with its reduction kernel)
REPLAY_LAUNCHES = {
    None: {"epilogue_fwd_kernel": 1, "epilogue_bwd_kernel": 1},
    "pallas": {"epilogue_fwd_kernel": 1, "epilogue_bwd_kernel": 1,
               "conv3x3_wgmma_ws_kernel": 2 * 13,
               "conv3x3_dkernel_wgmma_kernel": 13,
               "dkernel_reduce_kernel": 13}}
PROFILE_TRIES = 3
# the `pipeline` phase: PIPELINE_STEPS eager steps of the preset with the
# conv kernel at batch 128 fed by `DevicePrefetcher` (buffer 2) from a
# `HostIterator` over the train split (shuffled from PIPELINE_SEED,
# drop_last), bit for bit the same steps on the device-resident split
# gathered by index; PIPELINE_TIMED steps of each feed a turn, in
# PIPELINE_TURNS turns; a profiler trace of PIPELINE_TRACED steps of each
PIPELINE_STEPS = 24
PIPELINE_TIMED = 8
PIPELINE_TURNS = 3
PIPELINE_TRACED = 3
PIPELINE_SEED = 1
PIPELINE_BUFFER = 2
IDX_FIXTURE = HERE / "tests" / "fixtures" / "mnist_idx"
# the experiment phase: the shipped preset at full width on the first
# EXPERIMENT_LIMIT synthetic images (11,520 train, 90 steps an epoch)
EXPERIMENT_LIMIT = 12800
EXPERIMENT_EPOCHS = 4
EXPERIMENT_CLF_EPOCHS = 2
# the figures of each family's run dir: those of the committed JAX run dirs
# (results/mnist_countergan_seed43/, moons_countergan/, house_countergan/,
# the generation presets'), by name and folder
MNIST_FIGURES = (
    "cf_grid.png", "classifier_eval/confusion_matrix.png",
    "classifier_training_curves.png",
    *(f"eval_visuals/sample_{i}.png" for i in range(8)),
    "eval_visuals/batch_overview.png", "gan_losses.png",
    "patch_budget_curve.png", "patch_grid.png",
    "user_modification_example.png")
MOONS_FIGURES = (
    *(f"boundaries/decision_boundaries_cfs_src{s}_tgt{t}.png"
      for s in range(3) for t in range(3) if s != t),
    "classifier_eval/confusion_matrix.png", "decision_boundaries.png",
    "loss_curves.png")
HOUSE_FIGURES = (
    *(f"class_pair_sensitivity/src{s}.png" for s in range(4)),
    "classifier_eval/confusion_matrix.png", "classifier_training_curves.png",
    "feature_shift_importance.png", "loss_curves.png",
    "mask_policy_analysis.png")
GENERATION_FIGURES = {
    "image": ("loss.png", "real_samples.png", "samples.png",
              "training_animation.gif"),
    "points": ("generated.png", "loss.png")}
EXPERIMENT_FILES = (
    "classifier/checkpoint.msgpack", "generator/checkpoint.msgpack",
    "generator/metadata.json", "train_state/checkpoint.msgpack",
    "train_state/metadata.json", "classifier_eval/confusion_matrix.csv",
    "classifier_eval/classifier_report.txt", "countergan_metrics.csv",
    "countergan_metrics_per_class.csv", "masked_metrics.csv",
    "patch_budget_curve.csv", "run_provenance.json") + MNIST_FIGURES
# the experiment's CSVs that its rerun must write again byte for byte
EXPERIMENT_CSVS = ("countergan_metrics_per_class.csv",
                   "patch_budget_curve.csv")


# the legacy phases: LEGACY_STEPS eager steps of the legacy preset (f32,
# hidden 32) with the kernels and with the plain epilogue; an epoch of
# LEGACY_RUNNER_STEPS steps (WARMUP_STEPS eager, the rest replayed)
# against eager; `mnist_countergan2 --target LEGACY_TARGET` on
# EXPERIMENT_LIMIT images, one epoch each
LEGACY_STEPS = 10
LEGACY_RUNNER_STEPS = 27
LEGACY_TARGET = 5
# the memory options: MEMORY_STEPS steps an arm at batch 128 (bf16: 3
# eager, 2 replayed), and
# float32 at MEMORY_F32_BATCH, where the activations dominate the memory
MEMORY_STEPS = 5
MEMORY_F32_BATCH = 1024
# the custom-shapes phase: the shipped preset at the image example's
# shape (20x20, three classes, a 4x4 grid of 5-px patches, 8 modifiable);
# the conv and dK at its steps' and requests' batches, the epilogue at its
# rows (128 and 64 images of 400 pixels) and at the credit example's (128
# rows of 7 features, the 4-byte variant); CUSTOM_STEPS eager steps a
# dtype and batch
CUSTOM_HW = (20, 20)
CUSTOM_CLASSES = 3
CUSTOM_PATCH, CUSTOM_MODIFIABLE = 5, 8
CUSTOM_PATCHES = [1, 2, 5, 6, 9, 10, 13, 14]  # a vertical strip
CUSTOM_CONV_SHAPES = ((128, 20, 20, 64, 64), (64, 20, 20, 64, 64))
CUSTOM_EPI_ROWS = ((128, 400), (64, 400), (128, 7))
CUSTOM_STEPS = 3

# the house phases: the shipped preset's (128, 17) step; HOUSE_STEPS
# eager steps; one whole epoch through the runner, of which the eager
# device time is profiled over MLP_PROFILE_STEPS steps; the experiment cut to
# HOUSE_CLF_EPOCHS classifier and HOUSE_EPOCHS GAN epochs with a snapshot
# rung every HOUSE_EVERY
HOUSE_FEATURES = 17
HOUSE_STEPS = 10
HOUSE_CLF_EPOCHS = 5
HOUSE_EPOCHS = 20
HOUSE_EVERY = 10
HOUSE_FILES = (
    "classifier/checkpoint.msgpack", "classifier/metadata.json",
    "generator/checkpoint.msgpack", "generator/metadata.json",
    "train_state/checkpoint.msgpack", "classifier_eval/confusion_matrix.csv",
    "countergan_metrics.csv", "countergan_metrics_reference_protocol.csv",
    "feature_shift_importance.csv",
    "class_pair_sensitivity/class_pair_sensitivity.csv",
    "case_studies/case_study_aggregate_summary.csv",
    "mask_policy_analysis.csv", "run_provenance.json") + HOUSE_FIGURES
# the house CSVs that its rerun must write again byte for byte
HOUSE_CSVS = ("countergan_metrics.csv",
              "countergan_metrics_reference_protocol.csv",
              "feature_shift_importance.csv",
              "class_pair_sensitivity/class_pair_sensitivity.csv",
              "case_studies/case_study_aggregate_summary.csv",
              "case_studies/case_study_feature_summary.csv",
              "case_studies/case_study_sample_summary.csv",
              "mask_policy_analysis.csv")
HOUSE_RUN_DIR = HERE / "results" / "house_countergan"
# the card's served counterfactuals against the CPU's: float32 matmuls in
# other orders (TF32 off); a hard Gumbel argmax may flip on a near tie, so
# HOUSE_PRED_AGREE of the predictions must agree and the rows whose
# predictions agree are reported with their largest x_cf difference
HOUSE_PRED_AGREE = 0.99

# the moons phases: the shipped preset's (64, 2) step, unclamped (the
# epilogue's bounds -1e30 and 1e30); MOONS_STEPS eager steps; one epoch
# (15 steps) through the runner against eager, then MOONS_TIMED_EPOCHS
# replayed epochs a turn; the experiment at the full shipped preset
# (1,000 classifier steps, 500 epochs, a snapshot every 50); the committed
# run dir's weights on the card against the CPU within MOONS_CPU_ATOL
# (float32 matmuls in other orders, TF32 off)
MOONS_BATCH = 64
MOONS_SIZES = {"train": 960, "test": 240}
MOONS_STEPS = 10
MOONS_TIMED_EPOCHS = 10
MOONS_CPU_ATOL = 1e-5
MOONS_FILES = (
    "classifier/checkpoint.msgpack", "classifier/metadata.json",
    "classifier_eval/confusion_matrix.csv", "generator/checkpoint.msgpack",
    "generator/metadata.json", "train_state/checkpoint.msgpack",
    "countergan_metrics.csv", "countergan_metrics_per_mask.csv",
    "run_provenance.json") + MOONS_FIGURES
MOONS_RUN_DIR = HERE / "results" / "moons_countergan"
# each replayed step's launches of our kernels in the two MLP families,
# and the steps of the epochs whose replays the profiler counts and of
# the eager steps timed a turn (a trace of a whole replayed house epoch
# holds ~10^5 records)
MLP_REPLAY_LAUNCHES = {"epilogue_fwd_kernel": 1, "epilogue_bwd_kernel": 1}
MLP_PROFILE_STEPS = 24

# the plain-generation phases: eager steps a family (WGAN-GP updates G on
# the global steps 0, 5 and 10 of 11); the data phase's MNIST training
# images an epoch of the replay check, and of the timed epoch (10 steps:
# two WGAN-GP cycles; a profiler trace of 50 took ~20 s to read); the
# images and epochs of the MNIST presets' `run()` (the moons presets run
# whole); the bar of the committed moons generators on the card against
# the CPU, a share of the samples' scale (max |x|, at least 1): the
# simple moons generator's float32 samples on the CPU lie 1.03e-6 from
# its float64 ones at a scale of 2.03
GAN_EAGER_STEPS = 11
GAN_EPOCH_ROWS = 6400
GAN_TIMED = ("dcgan_mnist", "wgan_gp_mnist")
GAN_TIMED_ROWS = 1280
GENERATION_LIMIT = 12800
GENERATION_EPOCHS = 2
GENERATION_CPU_RTOL = 1e-6

# the figures phase: the MNIST figures of the shipped generator and
# classifier (results/mnist_countergan_seed43/: 64 channels, 6 blocks,
# bf16) through the conv kernel; the kernel held at the batches they give
# it (the grid's 10 x 10 cells, the heatmaps' 8 images, the patch-budget
# curve's 512 rows a budget; the user example's b=1 is in CONV_SHAPES)
FIGURES_RUN_DIR = HERE / "results" / "mnist_countergan_seed43"
FIGURE_CONV_SHAPES = ((100, 28, 28, 64, 64), (8, 28, 28, 64, 64))
FIGURE_BUDGET_SHAPE = (512, 28, 28, 64, 64)
FIGURE_SAMPLES = 8

# the apps phase: the promptable front ends' backends on the committed
# run dirs (the MNIST chat through the conv kernel, held against the same
# dialogue on cuDNN's route within the two bf16 routes' gap on these
# trained weights), and a synthetic reference-layout MNIST generator
# imported by cfgan_torch.migrate and served in float32 on the kernel
# route against cuDNN's (F32_ATOL)
APPS_CHAT = ("show me a 3", "turn it into an 8 using patches 5, 6, 9, 10",
             "what is the weather")
APPS_LLM_REPLY = ('Sure. <!-- {"action": "transform_digit", "target": 1, '
                  '"patches": [4, 5, 6, 7]} -->')
# the kernel and cuDNN bf16 routes' largest x_cf gap on these weights,
# served at b=128 on an H100
APPS_CUDNN_CF_ATOL = 0.0234
APPS_HOUSE_INSTRUCTION = "only bedrooms, bathrooms and grade"
APPS_HOUSE_FEATURES = ["bedrooms", "bathrooms", "grade"]
APPS_SHAPE = (1, 28, 28, 64, 64)  # every app and migrate request is b=1

# the api phase: the launcher's run dirs (results/mnist_countergan/ holds
# no classifier checkpoint; the seed-43 run dir holds both)
API_RUNS = (("mnist", "results/mnist_countergan_seed43"),
            ("house", "results/house_countergan"),
            ("moons", "results/moons_countergan"))
API_START_S = 300  # a launcher's start (torch, the corpus cache, a warm-up)
API_PATCHES = [0, 5, 10, 15]
API_FEATURES = ["grade", "sqft_living", "lat"]
API_SEEDS = (0, 42)
API_JSON_BULK = 1000  # MNIST rows of the JSON bulk request
API_TIMED = 100  # b=1 requests timed per wire format, in API_TURNS turns
API_TURNS = 4
API_BULK_TURNS = 1  # timed bulk calls per wire format (a JSON one ~5 s)
API_THREADS, API_PER_THREAD = 8, 25
# the conv kernel's server against the float32 result: within this
# factor of the bf16 cuDNN route's own error (trained weights: residuals
# up to ~5, where a bf16 ulp is 2**-5 to 2**-6)
API_KERNEL_SLACK = 1.25

# the sharded phase: (a) the preset through `train_countergan_loop(mesh=)`
# on a world of one (NCCL), SHARDED_EPOCHS epochs of SHARDED_ROWS rows at
# batch 128, bit for bit against the loop without a mesh; (b) SHARDED_STEPS
# steps of a world of 2 (4 with four cards) on the global batch of 128,
# f32 metrics at the JAX package's sharded bar (tests/test_sharding.py:
# 63-67), bf16 ones at TRAIN_ATOL (the flip rate, a count of rows whose
# resolution 1 / 128 is coarser than that, within one row: a row at the
# classifier's boundary may flip on a bf16 rounding of other sums), the
# gradients and parameters at the
# `train pallas` bars (moment_report: the same functions summed in
# another order, and Adam's first steps move a parameter whose gradient
# is near zero by up to lr whatever its sign); (c) the f32 kernel engine
# sharded over the card twice (or the cards) against the engine unsharded,
# and on a ("data", "model") mesh along each axis; (d) (b)'s ranks on their
# ("data", "model") mesh, the generator channel-sharded, against their 1-D
# steps at (b)'s bars
SHARDED_ROWS = 1280
SHARDED_EPOCHS = 2
SHARDED_STEPS = 3
SHARDED_RTOL, SHARDED_ATOL = 2e-4, 1e-5
SHARDED_SERVE_ATOL = 1e-6  # tests/test_sharding.py:193-209
SHARDED_SIZES = (1, 5, 100)
SHARDED_CHUNK, SHARDED_BAD_CHUNK = 16, 15
SHARDED_TIMEOUT = 300  # seconds the ranks of (b) may take
SHARDED_WAIT = 1200  # seconds the ranks of (b) may wait for the phase
SHARDED_TURNS = 4  # eager steps of each layout timed in turns


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            print(f"phase {self.name}: {time.perf_counter() - self.t0:.3f} s",
                  flush=True)
        return False


class Laps:
    """Wall seconds of a phase's parts: `laps(name)` ends the part
    `name`; `laps.s` maps each part to its seconds."""

    def __init__(self):
        self.t = time.perf_counter()
        self.s = {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.s[name] = now - self.t
        self.t = now


def bf16_ulp(t):
    """One bf16 ulp at the magnitude of each element of `t`."""
    import torch

    return torch.exp2(torch.floor(torch.log2(
        t.abs().clamp_min(2.0 ** -126))) - 7)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of `fn`, by CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device ms per call of `fn`, by CUDA events around replays of a
    CUDA graph that holds `iters` calls: no host work between the kernels,
    only the graph's own gaps (about a microsecond a kernel)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capturing stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def kernel_ms(fn, iters: int = 20, floor_ms: float = 0.0,
              parts: dict | None = None, split: tuple = ()
              ) -> tuple[float, str]:
    """(ms per call, how it was timed): profiler device time, which counts
    kernel time only.  A trace can lose kernel records and then reads
    short, so a reading is kept only where two traces hold the same whole
    number of kernel records a call and both read at least `floor_ms`
    (the call's operations at the card's peak for its dtype, which no
    cache beats); the later one's time is kept, and `parts` takes its
    (ms, launches) a call of the kernels whose names hold a string of
    `split`.  Up to PROFILE_TRIES + 1 traces; where none agree, the
    replays of a CUDA graph of the calls (and `parts` stays empty)."""
    seen = {}  # kernel records a call -> ms
    for _ in range(PROFILE_TRIES + 1):
        ms, _, every = device_time(fn, iters, match=("",) + split)
        if ms is None:
            break
        records = every[""][1]
        if ms < floor_ms or records != int(records):
            continue
        if records in seen:
            if parts is not None:
                parts.update({k: every[k] for k in split})
            return ms, f"profiler ({int(records)} kernels a call, two traces)"
        seen[records] = ms
    return graph_ms(fn, iters), "cuda graph"


def host_ms(fn, iters: int, warmup: int = 3) -> list[float]:
    """Wall ms of each of `iters` calls of `fn`, each ending on the host
    (the engine returns numpy arrays, so every call synchronises)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _dev_us(ev) -> float:
    return getattr(ev, "self_device_time_total",
                   getattr(ev, "self_cuda_time_total", 0.0))


def device_events(prof) -> list:
    """A profiler's averaged device-side events: a CPU op's entry repeats
    its kernels' time, and so does a user annotation's range on the
    device (the optimizer's, a scheduled trace's step)."""
    from torch.autograd import DeviceType

    return [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and _dev_us(ev) > 0
            and not getattr(ev, "is_user_annotation", False)
            and not ev.key.startswith("ProfilerStep")]


def device_time(fn, iters: int, top: int = 5, match: tuple = ()):
    """(device ms per call, [(kernel, ms per call, launches per call)] of
    the `top` longest kernels, {name: (ms per call, launches per call)} of
    the kernels whose name holds a string of `match`) from a torch.profiler
    trace of `iters` calls of `fn`, counting device-side kernel events
    only; (None, [], {}) where the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without the card
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        if events:
            break
    if not events:
        return None, [], {}
    events.sort(key=_dev_us, reverse=True)
    longest = [(ev.key[:80], _dev_us(ev) / 1e3 / iters, ev.count / iters)
               for ev in events[:top]]
    matched = {m: (sum(_dev_us(ev) for ev in events if m in ev.key)
                   / 1e3 / iters,
                   sum(ev.count for ev in events if m in ev.key) / iters)
               for m in match}
    return sum(_dev_us(ev) for ev in events) / 1e3 / iters, longest, matched


def conv_bound(b, h, w, cin, cout, dtype: str):
    """(bound_ms, bound_by, bytes, operations) of one 3x3 SAME conv on an
    H100 SXM: input, kernel and output each moved once; 2 * MACs at the
    bf16 tensor-core peak, or in f32 three times over at the TF32 peak
    (3xTF32)."""
    from cfgan_torch.ops.conv import conv_flops

    elt = 2 if dtype == "bfloat16" else 4
    nbytes = (b * h * w * (cin + cout) + 9 * cin * cout) * elt
    ops = conv_flops(b, (h, w), cin, cout)
    return _bound(nbytes, ops, dtype) + (nbytes, ops)


def _bound(nbytes: int, ops: int, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (ops / PEAK_OPS_PER_S["bfloat16"] if dtype == "bfloat16"
             else TF32_PRODUCTS * ops / PEAK_OPS_PER_S["tf32"])
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def dkernel_bound(b, h, w, cin, cout, dtype: str):
    """(bound_ms, bound_by) of one dK on an H100 SXM: x and the cotangent
    read once, the float32 dK written once; 2 * MACs at the bf16
    tensor-core peak, or in f32 three times over at the TF32 peak."""
    from cfgan_torch.ops.conv import conv_flops

    elt = 2 if dtype == "bfloat16" else 4
    nbytes = b * h * w * (cin + cout) * elt + 9 * cin * cout * 4
    return _bound(nbytes, conv_flops(b, (h, w), cin, cout), dtype)


def kernel_ptxas(log: str, names: str) -> list[dict]:
    """The entries of an `nvcc -Xptxas -v` report whose kernel name
    matches the regular expression `names`: each entry's name with its
    template arguments, its registers and its spill stores and loads in
    bytes."""
    out, entry = [], None
    for ln in log.splitlines():
        m = re.search(rf"Compiling entry function '[^']*?({names})"
                      r"(?:I(.*?)EE)?", ln)
        if m:  # the name and its template arguments, from the mangling
            args = re.findall(r"L[ib](\d+)", m.group(2) or "")
            entry = m.group(1) + (f"<{', '.join(args)}>" if args else "")
            continue
        if "Compiling entry" in ln:
            entry = None
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out.append({"entry": entry, "spill_stores": int(m.group(1)),
                        "spill_loads": int(m.group(2))})
        m = re.search(r"Used (\d+) registers", ln)
        if m and out and out[-1]["entry"] == entry:
            out[-1]["registers"] = int(m.group(1))
            entry = None
    return out


def _flat(tree: dict, path: str = "") -> dict:
    """The leaves of nested dicts by their '/'-joined path."""
    out = {}
    for key, value in tree.items():
        name = f"{path}/{key}" if path else key
        out.update(_flat(value, name) if isinstance(value, dict)
                   else {name: value})
    return out


def epilogue_bound(b: int, n: int, backward: bool):
    """(bound_ms, bound_by) of one epilogue kernel launch on (b, n) float32
    rows on an H100 SXM: each input read once, each output written once;
    ~10 (forward) or ~15 (backward) float32 operations an element."""
    rows_in, rows_out, cols = (4, 2, 3) if backward else (3, 1, 3)
    nbytes = ((rows_in + rows_out) * b * n + cols * b) * 4
    ops = (15 if backward else 10) * b * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["float32"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def host_call_ms(fn, windows: int = 5, iters: int = 200) -> float:
    """Median over `windows` of the ms per call of `fn` by CUDA events
    around `iters` back-to-back calls: where the host's work per call
    exceeds the kernel's, its host time per call.  The host is shared, so
    one window may move by half."""
    return statistics.median(cuda_ms(fn, iters) for _ in range(windows))


def time_epilogue(card: str, dev, n: int = 28 * 28, b: int = TRAIN_BATCH,
                  bounds: tuple[float, float] = (-1.0, 1.0)) -> dict:
    """Device ms per call (profiler) of the epilogue kernels and of their
    plain versions, and the wrappers' host-bound ms per call
    (`host_call_ms`), at a step's (b, n) float32 rows (the MNIST step's
    (128, 784), the house step's (128, 17), the moons step's (64, 2)
    between the bounds -1e30 and 1e30): one line each.  Uses only what
    every checkout's `cfgan_torch.ops.epilogue` has, so
    `--train-timing-only` runs it on earlier commits too."""
    import torch

    from cfgan_torch.ops import epilogue as tep

    lo, hi = bounds
    x, raw = (torch.rand((b, n), device=dev) * 2 - 1 for _ in range(2))
    mask = (torch.rand((b, n), device=dev) > 0.5).float()
    gcf = torch.randn((b, n), device=dev)
    cols = [torch.randn((b,), device=dev) for _ in range(3)]
    epi = {}
    for name, kernel, plain, args, backward in (
            ("cf_epilogue_fwd", tep.cf_epilogue_fwd,
             tep.cf_epilogue_fwd_plain, (x, raw, mask, lo, hi), False),
            ("cf_epilogue_bwd", tep.cf_epilogue_bwd,
             tep.cf_epilogue_bwd_plain,
             (x, raw, mask, gcf, *cols, lo, hi), True)):
        bound_ms, bound_by = epilogue_bound(b, n, backward)
        # device time per call (kernel_ms): a few microseconds of kernel,
        # shorter than the wrapper's host-side work, so CUDA events around
        # back-to-back calls time the host.  20 calls a trace: traces of
        # 200 lost records nearly every time (the plain version's ~2,000)
        (ms, how), (plain_ms, plain_how) = (
            kernel_ms(lambda: kernel(*args)),
            kernel_ms(lambda: plain(*args)))
        epi[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None)
        emit({"phase": "timing", "what": name, "card": card,
              "shape": (b, n), "bounds": bounds, "dtype": "float32",
              **epi[name],
              "timed_by": sorted({how, plain_how}),
              "share_of_bound": bound_ms / ms,
              "host_bound_call_ms": host_call_ms(lambda: kernel(*args)),
              "plain_host_bound_call_ms": host_call_ms(lambda: plain(*args))})
    return epi


# ------------------------------------------- kernels against their plain
# versions, at a shape (the `kernel ...` phases and `custom shapes`)
def make_conv_inputs(gen, dev, b, h, w, cin, cout, dtype):
    """An NHWC input and a 3x3 kernel at the generator's kaiming init,
    drawn from `gen`, on `dev` at `dtype`."""
    import torch

    x = torch.randn((b, h, w, cin), generator=gen)
    k = torch.randn((3, 3, cin, cout), generator=gen) * math.sqrt(
        2 / 1.04 / (9 * cin))  # the generator's kaiming init
    return x.to(dev, dtype), k.to(dev, dtype)


def row_rel_err(got, ref) -> float:
    """The largest over output pixels of |got - ref| / |ref| in the
    2-norm of the pixel's channels."""
    d = (got - ref).reshape(-1, ref.shape[-1]).norm(dim=1)
    n = ref.reshape(-1, ref.shape[-1]).norm(dim=1)
    return (d / n.clamp_min(1e-30)).max().item()


def conv_ok(got, ref, dtype):
    """(ok, tolerance): f32 abs <= F32_ATOL and row rel <=
    F32_ROW_RTOL; bf16 within one bf16 ulp of the plain f32 result
    rounded to bf16, + F32_ATOL."""
    if dtype == "bfloat16":
        ref = ref.bfloat16().float()
        return (bool(((got - ref).abs() <= bf16_ulp(ref) + F32_ATOL)
                     .all()),
                f"1 bf16 ulp of the plain f32 result rounded to bf16, "
                f"+ {F32_ATOL}")
    return ((got - ref).abs().max().item() <= F32_ATOL
            and row_rel_err(got, ref) <= F32_ROW_RTOL,
            f"abs <= {F32_ATOL} and each output pixel's channels within "
            f"{F32_ROW_RTOL} of their 2-norm")


def check_conv(gen, dev, shape, dtype: str, phase: str,
               tf32_witness: bool = False) -> float:
    """The conv kernel (forward, and dx: the cotangent through K read
    flipped and transposed) against its plain version at `shape` (B, H,
    W, Cin, Cout) and `dtype`; one line.  In f32 also the TF32 matmul's
    error beside it, and with `tf32_witness` a check that the row bar
    still tells 3xTF32 from one tf32 product.  Fails where they
    disagree; returns the largest abs error of the two."""
    import torch

    from cfgan_torch.ops.conv import conv3x3_same, conv3x3_same_plain

    x, k = make_conv_inputs(gen, dev, *shape, getattr(torch, dtype))
    g, _ = make_conv_inputs(gen, dev, *shape[:3], shape[4], shape[4],
                            getattr(torch, dtype))
    got = conv3x3_same(x, k).float()
    got_t = conv3x3_same(g, k, transposed=True).float()
    ref = conv3x3_same_plain(x.float(), k.float())
    ref_t = conv3x3_same_plain(
        g.float(), k.float().flip(0, 1).transpose(2, 3).contiguous())
    torch.cuda.synchronize()
    ok, tol = conv_ok(got, ref, dtype)
    ok_t, _ = conv_ok(got_t, ref_t, dtype)
    if dtype == "bfloat16":
        ref, ref_t = ref.bfloat16().float(), ref_t.bfloat16().float()
    err = (got - ref).abs().max().item()
    err_t = (got_t - ref_t).abs().max().item()
    rel = ((got - ref).abs() / ref.abs().clamp_min(1e-3)).max()
    report = {"phase": phase, "shape": shape, "dtype": dtype,
              "max_abs_err": err, "max_rel_err": rel.item(),
              "dx_max_abs_err": err_t, "tolerance": tol}
    if dtype == "float32":
        # one tf32 product: the plain version's matmuls, TF32 on
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = conv3x3_same_plain(x, k)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        report.update(
            max_row_rel_err=row_rel_err(got, ref),
            dx_max_row_rel_err=row_rel_err(got_t, ref_t),
            tf32_matmul_max_row_rel_err=row_rel_err(tf32, ref),
            tf32_matmul_max_abs_err=(tf32 - ref).abs().max().item())
        if (tf32_witness
                and report["tf32_matmul_max_row_rel_err"] <= F32_ROW_RTOL):
            fail("the TF32 matmul meets the f32 row bar: the bar no longer "
                 "tells 3xTF32 from one tf32 product")
    report["ok"] = ok and ok_t
    emit(report)
    if not (ok and ok_t) or not (torch.isfinite(got).all()
                                 and torch.isfinite(got_t).all()):
        fail(f"conv3x3 kernel disagrees with its plain version at {shape} "
             f"{dtype}: max abs err {err}, dx {err_t}")
    return max(err, err_t)


def check_dkernel(gen, dev, shape, dtype: str, phase: str) -> float:
    """The dK kernel against its plain version at `shape` and `dtype`
    (each tap within DK_RTOL of its 2-norm, the same bits over two
    calls); one line.  Fails where they disagree; returns the largest
    abs error."""
    import torch

    from cfgan_torch.ops.conv import (
        conv3x3_same_dkernel,
        conv3x3_same_dkernel_plain,
        dkernel_plan,
    )

    x, _ = make_conv_inputs(gen, dev, *shape, getattr(torch, dtype))
    g, _ = make_conv_inputs(gen, dev, *shape[:3], shape[4], shape[4],
                            getattr(torch, dtype))
    got = conv3x3_same_dkernel(x, g)
    again = conv3x3_same_dkernel(x, g)
    ref = conv3x3_same_dkernel_plain(x, g)
    torch.cuda.synchronize()
    norm = ref.reshape(9, -1).norm(dim=1)
    rel = (got - ref).reshape(9, -1).norm(dim=1) / norm.clamp_min(1e-30)
    same_bits = torch.equal(got, again)
    ok = (bool((rel <= DK_RTOL).all()) and same_bits
          and got.dtype == torch.float32
          and bool(torch.isfinite(got).all()))
    err = (got - ref).abs().max().item()
    emit({"phase": phase, "shape": shape, "dtype": dtype,
          "plan": dkernel_plan(*shape, getattr(torch, dtype)),
          "max_abs_err": err, "max_tap_rel_err": rel.max().item(),
          "two_calls_equal_bits": same_bits,
          "tolerance": f"per tap: 2-norm of the error <= {DK_RTOL} of the "
                       f"plain dK's (float32 sums of up to B*H*W products "
                       f"in another order)",
          "ok": ok})
    if not ok:
        fail(f"conv3x3 dK kernel disagrees with its plain version at "
             f"{shape} {dtype}: per-tap rel err {rel.max().item()}, equal "
             f"bits over two calls {same_bits}")
    return err


def check_epilogue(gen, dev, b: int, n: int, misaligned: bool, lo: float,
                   hi: float, phase: str) -> dict:
    """The epilogue kernels, forward and backward, against their plain
    versions on (b, n) float32 rows (x on and about the bounds, zeros in
    raw for sign(0); with `misaligned` each row array one element into
    its storage); one line naming the variant each wrapper launched.
    Fails where they disagree; returns {"variant": {"fwd": .., "bwd":
    ..}, "fwd": the forward's largest abs error (x_cf, sums), "bwd": the
    backward's (dx, d_raw)}."""
    import torch

    from cfgan_torch.ops import epilogue as tep

    def shifted(t):
        """A contiguous copy of `t` one element into its storage."""
        view = torch.empty(t.numel() + 1, device=t.device)[1:].view(t.shape)
        return view.copy_(t)

    x = torch.rand((b, n), generator=gen) * 2.4 - 1.2
    raw = torch.randn((b, n), generator=gen) * 0.4
    mask = (torch.rand((b, n), generator=gen) > 0.5).float()
    raw[:, ::5] = 0.0  # sign(0) in the backward
    x[:, 1::5], mask[:, 1::5] = 1.0, 0.0  # u exactly on hi ...
    x[:, 2::5], raw[:, 2::5] = -1.0, 0.0  # ... and on lo
    gcf = torch.randn((b, n), generator=gen)
    cols = [torch.randn((b,), generator=gen) for _ in range(3)]
    x, raw, mask, gcf, *cols = (t.to(dev) for t in (x, raw, mask, gcf, *cols))
    if misaligned:
        x, raw, mask, gcf = map(shifted, (x, raw, mask, gcf))
    got = tep.cf_epilogue_fwd(x, raw, mask, lo, hi)
    ref = tep.cf_epilogue_fwd_plain(x, raw, mask, lo, hi)
    got_b = tep.cf_epilogue_bwd(x, raw, mask, gcf, *cols, lo, hi)
    # the variant each wrapper passed to its kernel
    variant = {k: "16-byte" if f.last_float4 else "4-byte"
               for k, f in (("fwd", tep.cf_epilogue_fwd),
                            ("bwd", tep.cf_epilogue_bwd))}
    ref_b = tep.cf_epilogue_bwd_plain(x, raw, mask, gcf, *cols, lo, hi)
    torch.cuda.synchronize()
    cf_err = (got[0] - ref[0]).abs().max().item()
    sum_err = max(((g - r).abs() / r.abs().clamp_min(1e-30)).max().item()
                  for g, r in zip(got[1:], ref[1:]))
    sum_abs = max((g - r).abs().max().item() for g, r in zip(got[1:], ref[1:]))
    dx_err, draw_err = ((g - r).abs().max().item()
                        for g, r in zip(got_b, ref_b))
    ok = (max(cf_err, dx_err, draw_err) <= EPI_ATOL
          and sum_err <= EPI_SUM_RTOL
          and all(torch.isfinite(t).all() for t in (*got, *got_b)))
    emit({"phase": phase, "shape": (b, n), "misaligned": misaligned,
          "variant": variant, "lo": lo, "hi": hi, "x_cf_max_abs_err": cf_err,
          "sums_max_rel_err": sum_err, "sums_max_abs_err": sum_abs,
          "dx_max_abs_err": dx_err, "draw_max_abs_err": draw_err,
          "tolerance": f"x_cf, dx, draw abs <= {EPI_ATOL}; sums rel <= "
                       f"{EPI_SUM_RTOL}", "ok": ok})
    if not ok:
        fail(f"cf_epilogue kernels disagree with their plain versions at "
             f"{(b, n)} {variant}, bounds {(lo, hi)}")
    return {"variant": variant, "fwd": max(cf_err, sum_abs),
            "bwd": max(dx_err, draw_err)}


# --------------------------------------- device time of a kernel and of
# its plain and library counterparts (`timing`, `custom shapes`)
def _dev_ms(fn, ops: int, dtype: str, timed_by: dict, key: str,
            **kw) -> float:
    """`kernel_ms` (its `parts` and `split` in `kw`) with the dtype's bound
    on operations for a floor (f32: three tf32 products each, the fastest
    any of the three computes it): a trace that lost the conv's records
    read the f32 kernel under its bound against a bf16-peak floor."""
    ms, timed_by[key] = kernel_ms(fn, floor_ms=_bound(0, ops, dtype)[0],
                                  **kw)
    return ms


def time_conv(card: str, gen, dev, shape, dtype: str, phase: str) -> dict:
    """Device ms per call of the conv kernel, its plain version and
    cuDNN's `F.conv2d` at `shape` and `dtype`, with the bound and the
    kernel's launch plan; one line.  Returns {ms, plain_ms, library_ms,
    bound_ms, bound_by}."""
    import torch
    import torch.nn.functional as F

    from cfgan_torch.ops.conv import (
        conv3x3_same,
        conv3x3_same_plain,
        conv_plan,
    )

    x, k = make_conv_inputs(gen, dev, *shape, getattr(torch, dtype))
    x_nchw = x.permute(0, 3, 1, 2)  # channels-last view, no copy
    w_oihw = k.permute(3, 2, 0, 1).contiguous()
    bound_ms, bound_by, nbytes, ops = conv_bound(*shape, dtype)
    timed_by = {}
    ms = _dev_ms(lambda: conv3x3_same(x, k), ops, dtype, timed_by, "ms")
    plain_ms = _dev_ms(lambda: conv3x3_same_plain(x, k), ops, dtype,
                       timed_by, "plain_ms")
    lib_ms = _dev_ms(lambda: F.conv2d(x_nchw, w_oihw, padding=1), ops,
                     dtype, timed_by, "library_ms")
    emit({"phase": phase, "what": "conv3x3", "card": card, "shape": shape,
          "dtype": dtype, "ms": ms, "plain_ms": plain_ms,
          "library_ms": lib_ms,
          "library": "F.conv2d (cuDNN, TF32 off; its weight re-layout "
                     "kernel included; in f32 `ms` includes K's split)",
          "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
          "operations": ops, "share_of_bound": bound_ms / ms,
          "tflops": ops / ms / 1e9, "timed_by": timed_by,
          "events_call_ms": cuda_ms(lambda: conv3x3_same(x, k), 50),
          "graph_call_ms": graph_ms(lambda: conv3x3_same(x, k)),
          "plan": conv_plan(*shape, dtype=getattr(torch, dtype)),
          "faster_than_library": ms < lib_ms})
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def time_dkernel(card: str, gen, dev, shape, dtype: str, phase: str) -> dict:
    """Device ms per call of the dK kernel (with its reduction), its plain
    version and cuDNN's wgrad at `shape` and `dtype`, with the bound, the
    reduction's share of the kernel's time, the launch plan, and a CUDA
    graph's reading beside the profiler's; one line.  Returns {ms,
    plain_ms, library_ms, bound_ms, bound_by}."""
    import torch

    from cfgan_torch.ops.conv import (
        conv3x3_same_dkernel,
        conv3x3_same_dkernel_plain,
        conv_flops,
        dkernel_plan,
    )

    x, _ = make_conv_inputs(gen, dev, *shape, getattr(torch, dtype))
    g, _ = make_conv_inputs(gen, dev, *shape[:3], shape[4], shape[4],
                            getattr(torch, dtype))
    x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    w_shape = (shape[4], shape[3], 3, 3)
    bound_ms, bound_by = dkernel_bound(*shape, dtype)
    ops = conv_flops(shape[0], shape[1:3], shape[3], shape[4])
    timed_by = {}
    split = ("conv3x3_dkernel", "dkernel_reduce")
    parts = {}  # the kernel and its reduction apart, from the kept trace
    dk = dict(
        ms=_dev_ms(lambda: conv3x3_same_dkernel(x, g), ops, dtype, timed_by,
                   "ms", parts=parts, split=split),
        plain_ms=_dev_ms(lambda: conv3x3_same_dkernel_plain(x, g), ops,
                         dtype, timed_by, "plain_ms"),
        library_ms=_dev_ms(lambda: torch.nn.grad.conv2d_weight(
            x_nchw, w_shape, g_nchw, padding=1), ops, dtype, timed_by,
            "library_ms"),
        bound_ms=bound_ms, bound_by=bound_by)
    # the profiler's reading against a clock it does not touch: CUDA
    # events around replays of a graph of 20 calls (the kernel and its
    # reduction, with the graph's gaps)
    graph_call = graph_ms(lambda: conv3x3_same_dkernel(x, g))
    if not parts:  # timed by the graph: one more trace for the split, each
        # kernel's mean a launch (a trace that drops records keeps it)
        _, _, parts = device_time(lambda: conv3x3_same_dkernel(x, g), 20,
                                  match=split)
    per_launch = {k: ms / n if n else None for k, (ms, n) in parts.items()}
    launch_ms, reduce_ms = (per_launch.get("conv3x3_dkernel"),
                            per_launch.get("dkernel_reduce"))
    plan = dkernel_plan(*shape, getattr(torch, dtype))
    emit({"phase": phase, "what": "conv3x3 dK", "card": card,
          "shape": shape, "dtype": dtype, **dk,
          "library": "torch.nn.grad.conv2d_weight (cuDNN wgrad, "
                     "channels-last, TF32 off)",
          "timed_by": timed_by, "graph_call_ms": graph_call,
          "events_call_ms": cuda_ms(lambda: conv3x3_same_dkernel(x, g), 200),
          "kernel_ms": launch_ms, "reduce_ms": reduce_ms,
          "reduce_share": (None if None in (launch_ms, reduce_ms)
                           else reduce_ms / (launch_ms + reduce_ms)),
          "plan": plan,
          "workspace_bytes": plan["partials"] * 9 * shape[3] * shape[4] * 4,
          "faster_than_library": dk["ms"] < dk["library_ms"],
          "share_of_bound": bound_ms / dk["ms"]})
    return dk


# the train steps `timing train` times: (compute dtype, conv_impl); None is
# the preset's cuDNN conv
TIMED_STEPS = (("bfloat16", None), ("bfloat16", "pallas"),
               ("float32", "pallas"))


def time_train_steps(card: str, dev, clf_sd: dict, train_x, train_y) -> None:
    """Wall time (20 steps after 3 of warm-up, each ending in a
    synchronize) and profiler device time (TIMING_PROFILE_STEPS steps) of
    the preset's train
    step at each of TIMED_STEPS, on the batches train_x[j], train_y[j]:
    one line each, with our kernels' device ms and launches per step."""
    import torch

    from cfgan_torch.core.config import MNIST_COUNTERGAN
    from cfgan_torch.train.builders import build_mnist_countergan

    for dtype, impl in TIMED_STEPS:
        cfg = replace(MNIST_COUNTERGAN, conv_impl=impl, compute_dtype=dtype)
        bundle = build_mnist_countergan(cfg, clf_sd, seed=SEED)
        draws = torch.Generator(device=dev).manual_seed(SEED)
        i = iter(range(10 ** 9))

        def step():
            j = next(i) % len(train_x)
            bundle.step_fn(bundle.state, train_x[j], train_y[j], draws)
            torch.cuda.synchronize()

        lat = host_ms(step, 20)
        median = statistics.median(lat)
        busy_ms, top, ours = device_time(step, TIMING_PROFILE_STEPS, top=8,
                                         match=OUR_KERNELS)
        emit({"phase": "timing", "what": "train step", "card": card,
              "conv_impl": impl, "dtype": dtype,
              "batch": TRAIN_BATCH, "median_ms": median,
              "p90_ms": sorted(lat)[int(0.9 * len(lat))],
              "min_ms": min(lat),
              "images_per_s": TRAIN_BATCH / median * 1e3,
              "device_busy_ms": busy_ms,
              "device_idle_share": (None if busy_ms is None
                                    else 1 - busy_ms / median),
              "device_time_by_kernel_ms": top,
              "our_kernels_ms_and_launches_per_step": ours})


def _states_equal(a, b) -> bool:
    """Whether two train states hold equal parameters, statistics, EMA
    and Adam tensors, bit for bit."""
    import torch

    for net in ("g", "d"):
        sa, sb = getattr(a, net), getattr(b, net)
        for t, u in zip(sa.model.state_dict().values(),
                        sb.model.state_dict().values()):
            if not torch.equal(t, u):
                return False
        for p, q in zip(sa.model.parameters(), sb.model.parameters()):
            if any(not torch.equal(sa.opt.state[p][k], sb.opt.state[q][k])
                   for k in ("exp_avg", "exp_avg_sq", "step")):
                return False
    if a.g_ema is None or b.g_ema is None:
        return a.g_ema is None and b.g_ema is None
    return all(torch.equal(v, b.g_ema[k]) for k, v in a.g_ema.items())


def data_phase(card: str) -> tuple:
    """Load the synthetic corpus at its real size through `load_mnist`
    (generated at first use, then from its cache under build/); one
    line.  Returns the splits."""
    import os

    import numpy as np

    from cfgan_torch.data import mnist

    if os.environ.get("CFGAN_DATA_DIR"):
        fail("CFGAN_DATA_DIR is set: the data phase loads the synthetic "
             "corpus")
    t0 = time.perf_counter()
    splits = mnist.load_mnist(valid_fraction=0.1)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = mnist.load_mnist(valid_fraction=0.1)
    reload_s = time.perf_counter() - t0
    (xtr, ytr), (xva, yva), (xte, yte) = splits
    sizes = {"train": len(ytr), "valid": len(yva), "test": len(yte)}
    counts = {name: np.bincount(y, minlength=10).tolist()
              for name, y in (("train", ytr), ("valid", yva), ("test", yte))}
    ok = (sizes == {"train": 54000, "valid": 6000, "test": 10000}
          and all(min(c) > 0 for c in counts.values())
          and all(x.dtype == np.float32 and x.shape[1:] == (28, 28, 1)
                  and np.isfinite(x).all() and x.min() >= -1.0
                  and x.max() <= 1.0 for x in (xtr, xva, xte))
          and all(np.array_equal(u, v) for a, b in zip(splits, again)
                  for u, v in zip(a, b)))
    emit({"phase": "data", "card": card, "source": "synthetic",
          "corpus": {"train": mnist.TRAIN_N, "test": mnist.TEST_N},
          "load_s": load_s, "cached_reload_s": reload_s, "sizes": sizes,
          "per_class": counts, "ok": ok})
    if not ok:
        fail(f"the synthetic corpus came out wrong: {sizes}")
    return splits


def runner_phase(card: str, dev, clf_sd: dict, x, y, counts,
                 zero_counts) -> None:
    """The epoch runner against eager steps, its launches per replayed
    step by the profiler (the wrappers' counters, zeroed before the
    epoch, count a captured launch once), and replayed and eager steps
    timed in turns, for cuDNN's convs and the conv kernel; one line
    each."""
    import torch

    from cfgan_torch.core.config import MNIST_COUNTERGAN
    from cfgan_torch.data.pipeline import epoch_perm
    from cfgan_torch.train.builders import build_mnist_countergan
    from cfgan_torch.train.loop import WARMUP_STEPS, make_epoch_runner

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    for impl in (None, "pallas"):
        laps = Laps()
        cfg = replace(MNIST_COUNTERGAN, conv_impl=impl)
        ours, ref = (build_mnist_countergan(cfg, clf_sd, seed=SEED)
                     for _ in range(2))
        gen = torch.Generator(device=dev).manual_seed(SEED)
        perm = epoch_perm(gen, len(y), TRAIN_BATCH)[:RUNNER_STEPS]
        draws = ours.draw_fn(gen, tuple(perm.shape))
        runner = make_epoch_runner(ours.step_from_draws, reduce=False)
        zero_counts()
        got = runner(ours.state, x, y, perm, draws)
        torch.cuda.synchronize()
        wrapper = counts()
        if (runner.captures, runner.replays) != (
                1, RUNNER_STEPS - WARMUP_STEPS):
            fail(f"runner: {runner.captures} captures and {runner.replays} "
                 f"replays, not 1 and {RUNNER_STEPS - WARMUP_STEPS}")
        eager = [ref.step_from_draws(ref.state, x[perm[i]], y[perm[i]],
                                     {k: v[i] for k, v in draws.items()})
                 for i in range(RUNNER_STEPS)]
        eager = [(m["d_loss"].item(), m["g_loss"].item()) for m in eager]
        replayed = list(zip(got["d_loss"].tolist(), got["g_loss"].tolist()))
        loss_err = max(abs(a - b) for r, e in zip(replayed, eager)
                       for a, b in zip(r, e))
        same_state = _states_equal(ours.state, ref.state)
        ok = loss_err == 0.0 and same_state and all(
            math.isfinite(v) for pair in replayed for v in pair)
        report = {"phase": "epoch runner", "card": card, "conv_impl": impl,
                  "dtype": cfg.compute_dtype, "batch": TRAIN_BATCH,
                  "steps": RUNNER_STEPS, "eager_steps": WARMUP_STEPS,
                  "replayed_steps": RUNNER_STEPS - WARMUP_STEPS,
                  "dataset_on_device": list(x.shape),
                  "wrapper_counts_fwd_bwd_conv_dk": wrapper,
                  "d_g_loss_per_step": replayed,
                  "loss_max_abs_err_vs_eager": loss_err,
                  "state_equal_to_eager": same_state,
                  "tolerance": "bit for bit: losses and state"}
        if not ok:
            emit({**report, "eager_d_g_loss_per_step": eager, "ok": False})
            fail(f"conv_impl={impl}: replayed steps differ from eager "
                 f"steps (loss err {loss_err}, state equal {same_state})")

        laps("compare_s")

        # a second epoch of the same shape replays every step
        def epoch():
            runner(ours.state, x, y, perm, draws)

        # a trace of an epoch holds ~26k kernel records, and the profiler
        # now and then drops a few of them (6 of 624 conv records in one
        # run on an H100): up to PROFILE_TRIES traces, every one reported;
        # a graph that really skipped a kernel would miss it in each
        attempts = []
        for _ in range(PROFILE_TRIES):
            busy, top, ours_ms = device_time(
                epoch, 1, top=8, match=tuple(REPLAY_LAUNCHES[impl]))
            per_step = {k: (ms / RUNNER_STEPS, n / RUNNER_STEPS)
                        for k, (ms, n) in ours_ms.items()}
            attempts.append({k: v[1] for k, v in per_step.items()})
            exact = busy is not None and all(
                v[1] == REPLAY_LAUNCHES[impl][k] for k, v in per_step.items())
            if exact:
                break
        report["profiler_launch_counts_per_trace"] = attempts
        if not exact:
            fail(f"conv_impl={impl}: launches per replayed step {attempts} "
                 f"in {len(attempts)} traces, not {REPLAY_LAUNCHES[impl]}")
        laps("replay_traces_s")

        def eager_steps(n=RUNNER_STEPS):
            for i in range(n):
                ref.step_from_draws(ref.state, x[perm[i]], y[perm[i]],
                                    {k: v[i] for k, v in draws.items()})
            torch.cuda.synchronize()

        eager_busy = device_time(lambda: eager_steps(EAGER_PROFILE_STEPS),
                                 1)[0]
        laps("eager_trace_s")
        times = {"replayed": [], "eager": []}
        for _ in range(3):  # in turns
            for name, fn in (("replayed", epoch), ("eager", eager_steps)):
                t0 = time.perf_counter()
                fn()
                times[name].append((time.perf_counter() - t0) * 1e3
                                   / RUNNER_STEPS)
        med = {k: statistics.median(v) for k, v in times.items()}
        laps("turns_s")
        report.update({
            "part_seconds": laps.s,
            "launches_per_replayed_step": {k: v[1]
                                           for k, v in per_step.items()},
            "our_kernels_ms_per_replayed_step": {k: v[0]
                                                 for k, v in per_step.items()},
            "sync_debug_mode_during_replays": "error",
            "replayed_ms_per_step_in_turns": times["replayed"],
            "eager_ms_per_step_in_turns": times["eager"],
            "replayed_median_ms": med["replayed"],
            "eager_median_ms": med["eager"],
            "replayed_images_per_s": TRAIN_BATCH / med["replayed"] * 1e3,
            "eager_images_per_s": TRAIN_BATCH / med["eager"] * 1e3,
            "replayed_device_busy_ms": busy / RUNNER_STEPS,
            "replayed_device_idle_share": 1 - busy / RUNNER_STEPS
            / med["replayed"],
            "eager_device_busy_ms": (None if eager_busy is None
                                     else eager_busy / EAGER_PROFILE_STEPS),
            "eager_device_idle_share": (
                None if eager_busy is None
                else 1 - eager_busy / EAGER_PROFILE_STEPS / med["eager"]),
            "eager_busy_profiled_steps": EAGER_PROFILE_STEPS,
            "device_time_by_kernel_ms_per_epoch": top, "ok": True})
        emit(report)
    torch.backends.cudnn.deterministic = False


def _trace_copies(prof, sizes: set) -> dict:
    """From a profiler's chrome trace: the host-to-device copies of
    `sizes` bytes (their names and CUDA streams), the streams the kernels
    ran on, and the runtime's cudaHostAlloc calls."""
    import os
    import tempfile

    (HERE / "build").mkdir(exist_ok=True)
    fd, path = tempfile.mkstemp(suffix=".json", dir=HERE / "build")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and e.get("args", {}).get("bytes") in sizes]
    return {"copies": len(copies),
            "copy_names": sorted({e["name"] for e in copies}),
            "copy_streams": sorted({e["args"]["stream"] for e in copies}),
            "kernel_streams": sorted({e["args"]["stream"] for e in events
                                      if e.get("cat") == "kernel"}),
            "cudaHostAlloc_calls": sum(e.get("name", "").startswith(
                "cudaHostAlloc") for e in events)}


def pipeline_phase(card: str, dev, counts, zero_counts, clf_sd=None,
                   data=None) -> None:
    """The MNIST preset's pallas step (bf16, batch 128, 64 channels) fed by
    `DevicePrefetcher` from a `HostIterator` over the train split, against
    the same steps on the split held on the card (`device_put_dataset`,
    batches by `index_select` as the epoch runner gathers them): metrics,
    parameters, statistics and Adam bit for bit; the wrappers' launches;
    a profiler trace's launches a step, its batch copies (pinned, on the
    prefetcher's stream, no kernel's) and busy time; both feeds' steps
    timed in turns; and the native normaliser and IDX reader against
    their plain versions on the host.  `clf_sd` and `data` (the train
    split) default to a random classifier and `load_mnist`'s corpus, so
    that `--phases pipeline` stands alone."""
    import gc
    import os

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from cfgan_torch import native
    from cfgan_torch.core.config import MNIST_COUNTERGAN
    from cfgan_torch.data import mnist
    from cfgan_torch.data.pipeline import (
        DevicePrefetcher,
        HostIterator,
        device_put_dataset,
    )
    from cfgan_torch.parallel import create_mesh
    from cfgan_torch.train.builders import build_mnist_countergan, mnist_models

    laps = Laps()
    if clf_sd is None:
        clf_sd = mnist_models(MNIST_COUNTERGAN, generator=torch.Generator(
        ).manual_seed(SEED))[1].state_dict()
    if data is None:
        data = mnist.load_mnist(valid_fraction=0.1)[0]
    xtr, ytr = data[0], np.asarray(data[1], np.int64)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = replace(MNIST_COUNTERGAN, conv_impl="pallas")
    fed, resident = (build_mnist_countergan(cfg, clf_sd, seed=SEED,
                                            device=dev) for _ in range(2))
    x_dev, y_dev = device_put_dataset(create_mesh(devices=[dev]), xtr, ytr)
    host = HostIterator((xtr, ytr), TRAIN_BATCH, shuffle=True,
                        seed=PIPELINE_SEED, drop_last=True)
    feed = DevicePrefetcher(host, buffer_size=PIPELINE_BUFFER, device=dev)
    # the host iterator's first epoch is RandomState(seed)'s permutation
    order = np.random.RandomState(PIPELINE_SEED).permutation(len(ytr))
    steps = PIPELINE_STEPS
    perm = torch.as_tensor(order[:steps * TRAIN_BATCH].reshape(
        steps, TRAIN_BATCH)).to(dev)
    draws = fed.draw_fn(torch.Generator(device=dev).manual_seed(SEED),
                        tuple(perm.shape))

    def draw(i):
        return {k: v[i % steps] for k, v in draws.items()}

    def gathered(i):
        return (x_dev.index_select(0, perm[i % steps]),
                y_dev.index_select(0, perm[i % steps]))

    laps("setup")
    zero_counts()
    fed_metrics, batches_equal = [], 0
    for i, (x, y) in zip(range(steps), feed):
        gx, gy = gathered(i)
        batches_equal += bool(torch.equal(x, gx) and torch.equal(y, gy))
        fed_metrics.append(fed.step_from_draws(fed.state, x, y, draw(i)))
    torch.cuda.synchronize()
    launched = counts()
    want = (steps, steps, 2 * KERNEL_LAYERS_PER_FORWARD * steps,
            KERNEL_LAYERS_PER_FORWARD * steps)
    res_metrics = [resident.step_from_draws(resident.state, *gathered(i),
                                            draw(i)) for i in range(steps)]
    torch.cuda.synchronize()
    metrics_equal = all(
        a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
        for a, b in zip(fed_metrics, res_metrics))
    same_state = _states_equal(fed.state, resident.state)
    laps("compare")

    next_ms = []  # the host's wait for each prefetched batch

    def fed_steps(n):
        times = []
        it = iter(feed)
        for i in range(n):
            t0 = time.perf_counter()
            x, y = next(it)
            next_ms.append((time.perf_counter() - t0) * 1e3)
            fed.step_from_draws(fed.state, x, y, draw(i))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        it.close()
        return times

    def resident_steps(n):
        times = []
        for i in range(n):
            t0 = time.perf_counter()
            resident.step_from_draws(resident.state, *gathered(i), draw(i))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    turns = {"prefetched": [], "resident": []}
    for _ in range(PIPELINE_TURNS):
        for name, fn in (("prefetched", fed_steps),
                         ("resident", resident_steps)):
            turns[name].append(statistics.median(fn(PIPELINE_TIMED)))
    med = {k: statistics.median(v) for k, v in turns.items()}
    turn_next_ms = statistics.median(next_ms)
    laps("turns")

    # a trace of the prefetched steps: launches a step, busy time and the
    # batches' copies, every batch read ahead of the traced steps among
    # them (the first `next` issues PIPELINE_BUFFER copies before its own
    # step's).  A trace's first records may be lost (a whole smoke's trace
    # once held 7 of the 10 copies), so one resident step warms the
    # profiler up first, and a trace may drop records at any time, so up
    # to PROFILE_TRIES
    sizes = {x_dev[:TRAIN_BATCH].nbytes, y_dev[:TRAIN_BATCH].nbytes}
    want_copies = 2 * (PIPELINE_TRACED + PIPELINE_BUFFER)
    attempts = []
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            resident_steps(1)
            prof.step()
            fed_steps(PIPELINE_TRACED)
            prof.step()
        events = device_events(prof)
        per_step = {k: sum(ev.count for ev in events if k in ev.key)
                    / PIPELINE_TRACED for k in REPLAY_LAUNCHES["pallas"]}
        copies = _trace_copies(prof, sizes)
        attempts.append({**per_step, "copies": copies["copies"]})
        exact = (per_step == REPLAY_LAUNCHES["pallas"]
                 and copies["copies"] == want_copies)
        if exact:
            break
    fed_busy = sum(_dev_us(ev) for ev in events) / 1e3 / PIPELINE_TRACED
    resident_busy = device_time(lambda: resident_steps(PIPELINE_TRACED),
                                1)[0]
    if resident_busy is not None:
        resident_busy /= PIPELINE_TRACED
    laps("traces")
    copies_ok = (exact and len(copies["copy_streams"]) == 1
                 and not set(copies["copy_streams"])
                 & set(copies["kernel_streams"])
                 and all("HtoD" in n and "Pinned" in n
                         for n in copies["copy_names"]))
    batches_fed = steps + PIPELINE_TURNS * PIPELINE_TIMED + PIPELINE_TRACED
    # a buffer is allocated only while the ring's others are in flight,
    # and a ring holds at most buffer_size + 1: none a batch
    pinned_ok = 2 <= feed.pinned_buffers <= 2 * (PIPELINE_BUFFER + 1)

    # the host paths: the native normaliser on the full train set and the
    # native IDX reader on the fixture, against their plain versions
    raw = mnist._load_synthetic(0)[0][0]
    native.lib()
    host_times = {
        "normalize_native_ms": host_ms(lambda: mnist.normalize(raw), 3,
                                       warmup=1),
        "normalize_lut_ms": host_ms(lambda: mnist.normalize_plain(raw), 3,
                                    warmup=1)}
    normalize_equal = np.array_equal(mnist.normalize(raw).view(np.uint32),
                                     mnist.normalize_plain(raw).view(
                                         np.uint32))
    idx = {}
    for path in sorted(IDX_FIXTURE.iterdir()):
        fast, plain = native.read_idx(path), mnist._read_idx_plain(str(path))
        idx[path.name] = {
            "shape": list(plain.shape),
            "equal": fast is not None and np.array_equal(fast, plain),
            "native_ms": statistics.median(host_ms(
                lambda: native.read_idx(path), 20)),
            "python_ms": statistics.median(host_ms(
                lambda: mnist._read_idx_plain(str(path)), 20))}
    laps("host paths")
    # the traces leave ~350,000 objects in reference cycles: collected
    # here, inside this phase's time, since later host-bound phases ran
    # ~7% slower while they lived (`custom shapes` alone and after this
    # phase, in turns)
    del prof, events
    gc.collect()
    laps("collect")
    ok = (launched == want and batches_equal == steps and metrics_equal
          and same_state and copies_ok and pinned_ok and normalize_equal
          and all(v["equal"] for v in idx.values())
          and all(math.isfinite(m["d_loss"].item()) for m in fed_metrics))
    emit({"phase": "pipeline", "card": card, "dtype": cfg.compute_dtype,
          "conv_impl": "pallas", "batch": TRAIN_BATCH, "steps": steps,
          "buffer_size": PIPELINE_BUFFER, "train_rows": len(ytr),
          "batches_equal_to_gathered": batches_equal,
          "metrics_equal": metrics_equal, "state_equal": same_state,
          "tolerance": "bit for bit: batches, metrics and state",
          "wrapper_counts_fwd_bwd_conv_dk": launched,
          "wrapper_counts_want": want,
          "profiler_launches_per_step_and_copies_per_trace": attempts,
          "trace": {**copies, "copies_want": want_copies,
                    "copy_bytes": sorted(sizes)},
          "pinned_buffers_allocated": feed.pinned_buffers,
          "batches_fed": batches_fed,
          "prefetched_ms_per_step_in_turns": turns["prefetched"],
          "resident_ms_per_step_in_turns": turns["resident"],
          "prefetched_median_ms": med["prefetched"],
          "prefetched_next_median_ms": turn_next_ms,
          "resident_median_ms": med["resident"],
          "prefetched_device_busy_ms": fed_busy,
          "resident_device_busy_ms": resident_busy,
          "prefetched_device_idle_share": 1 - fed_busy / med["prefetched"],
          "resident_device_idle_share": (
              None if resident_busy is None
              else 1 - resident_busy / med["resident"]),
          "host": {**{k: statistics.median(v)
                      for k, v in host_times.items()},
                   "normalize_rows": list(raw.shape),
                   "normalize_equal": normalize_equal, "read_idx": idx,
                   "cpu_count": os.cpu_count(),
                   "cpus_usable": len(os.sched_getaffinity(0))},
          "part_seconds": laps.s, "ok": ok})
    torch.backends.cudnn.deterministic = False
    if not ok:
        fail("pipeline: the prefetched steps differ from the resident "
             "ones, launched other kernels, copied off the prefetcher's "
             "stream or from pageable memory, or a native host path "
             "differs from its plain version")


def experiment_phase(card: str, dev) -> None:
    """`run()` of the port's MNIST experiment at full width, then again
    on the same directory; one line."""
    import csv
    import shutil

    import numpy as np

    from cfgan_torch.core.provenance import check_run_provenance
    from cfgan_torch.experiments import mnist_countergan as exp
    from cfgan_torch.experiments.presets import MNIST_COUNTERGAN as PRESET

    cfg = PRESET.replace(
        classifier=replace(PRESET.classifier, epochs=EXPERIMENT_CLF_EPOCHS),
        countergan=replace(PRESET.countergan, epochs=EXPERIMENT_EPOCHS))
    out_dir = HERE / "build" / "smoke_experiment"
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        logs = [[], []]
        runs = []
        for i in range(2):
            t0 = time.perf_counter()
            runs.append(exp.run(cfg, out_dir=str(out_dir),
                                limit=EXPERIMENT_LIMIT, device=dev,
                                log=logs[i].append))
            runs[-1]["wall_s"] = time.perf_counter() - t0
            if i == 0:
                csvs = {n: (out_dir / n).read_text() for n in EXPERIMENT_CSVS}
        missing = [f for f in EXPERIMENT_FILES if not (out_dir / f).is_file()]
        missing += [f"unexpected {f}" for f in sorted(
            figure_set(out_dir) - set(MNIST_FIGURES))]
        provenance = check_run_provenance(str(out_dir))
        with open(out_dir / "countergan_metrics_per_class.csv") as f:
            rows = list(csv.DictReader(f))
        flips = [float(r["class_flip_rate"]) for r in rows]
        ladder = runs[0]["serving_selection"]["ladder"]
        rungs = {(r["epoch"], r["candidate"]) for r in ladder}
        want_rungs = {(e, c) for e in (2, 4) for c in (
            "live", "ema_recal_train", "ema_recal_ones")}
        runner = runs[0]["bundle"].epoch_fn
        trained_again = any("[CounteRGAN] epoch" in ln or "[Classifier]" in ln
                            for ln in logs[1])
        report = {
            "phase": "experiment", "card": card, "preset": cfg.name,
            "limit": EXPERIMENT_LIMIT, "clf_epochs": EXPERIMENT_CLF_EPOCHS,
            "epochs": EXPERIMENT_EPOCHS,
            "steps": runs[0]["bundle"].state.step,
            "runner_captures": runner.captures,
            "runner_replays": runner.replays,
            "stage_seconds": runs[0]["stage_seconds"],
            "run_wall_s": runs[0]["wall_s"],
            "rerun_stage_seconds": runs[1]["stage_seconds"],
            "rerun_wall_s": runs[1]["wall_s"],
            "classifier_test_accuracy": runs[0]["classifier"]["accuracy"],
            "serving_candidate": runs[0]["serving_selection"]["candidate"],
            "ladder": [(r["epoch"], r["candidate"], r["score"][0],
                        r["score"][-1]) for r in ladder],
            "per_target_flip": flips,
            "batch_metrics": runs[0]["batch_metrics"],
            "history_flip_rate": runs[0]["history"].get("flip_rate"),
            "patch_budget_curve": [
                (int(r["n_patches"]), float(r["flip_rate"]))
                for r in _csv_rows(out_dir / "patch_budget_curve.csv")],
            "provenance": provenance,
            "missing": missing, "rerun_trained": trained_again}
        ok = (not missing and len(rows) == 10
              and all(np.isfinite(float(v)) for r in rows
                      for v in r.values())
              and rungs == want_rungs and runner.captures == 1
              and not trained_again and runs[1]["history"] == {}
              and all((out_dir / n).read_text() == t
                      for n, t in csvs.items()))
        report["ok"] = ok
        emit(report)
        if not ok:
            fail("the experiment's run dir or its rerun came out wrong")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)



# ------------------------------------------------- the legacy stack
def _legacy_bundle(cfg, dev, clf_sd: dict):
    from cfgan_torch.train.builders import build_mnist_countergan

    return build_mnist_countergan(cfg, clf_sd, seed=SEED, device=dev,
                                  legacy_delta=True)


def legacy_train_phase(card: str, dev, x, y, counts, zero_counts,
                       plain_epilogue) -> tuple:
    """LEGACY_STEPS eager steps of the legacy preset at full width (f32,
    hidden 32) on the corpus's first batches: the epilogue kernels launch
    once forward and once backward a step at (128, 784), and the losses
    equal the same steps' on the plain epilogue within TRAIN_ATOL; one
    line.  Returns the wrappers' counts."""
    import torch

    from cfgan_torch.experiments.presets import MNIST_COUNTERGAN_LEGACY
    from cfgan_torch.train.builders import mnist_models

    cfg = MNIST_COUNTERGAN_LEGACY.countergan
    clf_sd = mnist_models(cfg, generator=torch.Generator().manual_seed(SEED),
                          legacy_delta=True)[1].state_dict()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    def steps():
        bundle = _legacy_bundle(cfg, dev, clf_sd)
        draws = torch.Generator(device=dev).manual_seed(SEED)
        out = [bundle.step_fn(bundle.state, x[i * TRAIN_BATCH:(i + 1)
                                              * TRAIN_BATCH],
                              y[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH], draws)
               for i in range(LEGACY_STEPS)]
        torch.cuda.synchronize()
        return bundle, [(m["d_loss"].item(), m["g_loss"].item(),
                         m["flip_rate"].item()) for m in out]

    zero_counts()
    bundle, losses = steps()
    launched = counts()
    with plain_epilogue():
        _, plain_losses = steps()
    torch.backends.cudnn.deterministic = False
    want = (LEGACY_STEPS, LEGACY_STEPS, 0, 0)
    errs = [max(abs(a - b) for a, b in zip(k[:2], p[:2]))
            for k, p in zip(losses, plain_losses)]
    finite = all(math.isfinite(v) for row in losses for v in row) and all(
        bool(torch.isfinite(p).all()) for net in (bundle.state.g,
                                                  bundle.state.d)
        for p in net.model.parameters())
    ok = (launched == want and counts() == want and finite
          and max(errs) <= TRAIN_ATOL["float32"])
    emit({"phase": "legacy train", "card": card, "preset":
          "mnist_countergan_legacy", "dtype": cfg.compute_dtype,
          "hidden": cfg.hidden_dim, "batch": TRAIN_BATCH,
          "steps": LEGACY_STEPS, "fixed_target": cfg.fixed_target,
          "wrapper_counts_fwd_bwd_conv_dk": launched,
          "d_g_loss_flip_per_step": losses,
          "plain_epilogue_d_g_loss_flip_per_step": plain_losses,
          "loss_max_abs_err_per_step": errs,
          "tolerance": f"abs <= {TRAIN_ATOL['float32']}", "ok": ok})
    if not ok:
        fail(f"legacy training launched {launched}, not {want}, or differs "
             f"from the plain epilogue: {errs}")
    return launched


def legacy_runner_phase(card: str, dev, x, y, counts, zero_counts) -> None:
    """One epoch of LEGACY_RUNNER_STEPS legacy steps through the epoch
    runner (3 eager, then replays under sync debug mode "error") against
    the same steps eager, bit for bit; launches per replayed step by the
    profiler; replayed and eager steps timed in turns; one line."""
    import numpy as np
    import torch

    from cfgan_torch.data.pipeline import epoch_perm
    from cfgan_torch.experiments.presets import MNIST_COUNTERGAN_LEGACY
    from cfgan_torch.train.builders import mnist_models
    from cfgan_torch.train.loop import WARMUP_STEPS, make_epoch_runner

    cfg = MNIST_COUNTERGAN_LEGACY.countergan
    clf_sd = mnist_models(cfg, generator=torch.Generator().manual_seed(SEED),
                          legacy_delta=True)[1].state_dict()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    ours, ref = (_legacy_bundle(cfg, dev, clf_sd) for _ in range(2))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    perm = epoch_perm(gen, len(y), TRAIN_BATCH)[:LEGACY_RUNNER_STEPS]
    draws = ours.draw_fn(gen, tuple(perm.shape))
    runner = make_epoch_runner(ours.step_from_draws, reduce=False)
    zero_counts()
    got = runner(ours.state, x, y, perm, draws)
    torch.cuda.synchronize()
    wrapper = counts()
    graphs = (runner.captures, runner.replays)
    eager = [ref.step_from_draws(ref.state, x[perm[i]], y[perm[i]],
                                 {k: v[i] for k, v in draws.items()})
             for i in range(LEGACY_RUNNER_STEPS)]
    eager = {k: [m[k].item() for m in eager] for k in got}
    equal = all(np.float32(e) == g for k in got
                for g, e in zip(got[k], eager[k]))
    same_state = _states_equal(ours.state, ref.state)
    replays = LEGACY_RUNNER_STEPS - WARMUP_STEPS

    def epoch():
        runner(ours.state, x, y, perm, draws)

    attempts = []
    for _ in range(PROFILE_TRIES):
        busy, top, per = device_time(epoch, 1, top=6,
                                     match=tuple(MLP_REPLAY_LAUNCHES))
        attempts.append({k: n / LEGACY_RUNNER_STEPS
                         for k, (_, n) in per.items()})
        if busy is not None and attempts[-1] == MLP_REPLAY_LAUNCHES:
            break

    def eager_steps():
        for i in range(LEGACY_RUNNER_STEPS):
            ref.step_from_draws(ref.state, x[perm[i]], y[perm[i]],
                                {k: v[i] for k, v in draws.items()})
        torch.cuda.synchronize()

    times = {"replayed": [], "eager": []}
    for _ in range(3):
        for name, fn in (("replayed", epoch), ("eager", eager_steps)):
            t0 = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t0) * 1e3
                               / LEGACY_RUNNER_STEPS)
    med = {k: statistics.median(v) for k, v in times.items()}
    torch.backends.cudnn.deterministic = False
    ok = (equal and same_state and graphs == (1, replays)
          and attempts[-1] == MLP_REPLAY_LAUNCHES
          and wrapper[:2] == (WARMUP_STEPS + 1, WARMUP_STEPS + 1))
    emit({"phase": "legacy epoch runner", "card": card,
          "dtype": cfg.compute_dtype, "batch": TRAIN_BATCH,
          "steps": LEGACY_RUNNER_STEPS, "eager_steps": WARMUP_STEPS,
          "replayed_steps": replays, "captures_and_replays": graphs,
          "metrics_equal_to_eager": equal, "state_equal_to_eager": same_state,
          "wrapper_counts_fwd_bwd_conv_dk": wrapper,
          "profiler_launches_per_replayed_step_per_trace": attempts,
          "sync_debug_mode_during_replays": "error",
          "replayed_ms_per_step_in_turns": times["replayed"],
          "eager_ms_per_step_in_turns": times["eager"],
          "replayed_median_ms": med["replayed"],
          "eager_median_ms": med["eager"],
          "replayed_images_per_s": TRAIN_BATCH / med["replayed"] * 1e3,
          "replayed_device_busy_ms": (None if busy is None
                                      else busy / LEGACY_RUNNER_STEPS),
          "replayed_device_idle_share": (
              None if busy is None
              else 1 - busy / LEGACY_RUNNER_STEPS / med["replayed"]),
          "device_time_by_kernel_ms_per_epoch": top,
          "tolerance": "bit for bit: metrics and state", "ok": ok})
    if not ok:
        fail("the legacy epoch runner differs from eager steps or launched "
             f"{attempts} a replayed step")


def legacy_experiment_phase(card: str, dev) -> None:
    """`mnist_countergan2 --target 5` at the preset's width (hidden 64) on
    EXPERIMENT_LIMIT corpus images, one classifier and one GAN epoch;
    the run dir and its three PNG grids, read back (`read_png`: zlib,
    CRCs checked) against `to_uint8_grid` of the same arrays; then the
    rerun, which loads the checkpoints and writes the same grids; one
    line."""
    import numpy as np
    import torch

    from cfgan_torch.core.provenance import check_run_provenance
    from cfgan_torch.data.mnist import load_mnist
    from cfgan_torch.eval.figure import read_png
    from cfgan_torch.eval.samples import to_uint8_grid
    from cfgan_torch.experiments import mnist_countergan2 as exp2

    out_dir = HERE / "build" / "smoke_legacy_experiment"
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--target", str(LEGACY_TARGET), "--epochs", "1",
            "--clf-epochs", "1", "--limit", str(EXPERIMENT_LIMIT),
            "--out-dir", str(out_dir)]
    try:
        logs, runs = [[], []], []
        for i in range(2):
            t0 = time.perf_counter()
            runs.append(exp2.main(argv, log=logs[i].append))
            runs[-1]["wall_s"] = time.perf_counter() - t0
            if i == 0:
                pngs = {n: (out_dir / n).read_bytes() for n in exp2.GRIDS}
        res = runs[0]
        _, _, (xte, _) = load_mnist(limit=EXPERIMENT_LIMIT)
        x = torch.as_tensor(xte[:exp2.GRID_IMAGES]).to(dev)
        t = torch.full((len(x),), LEGACY_TARGET, device=dev)
        x_cf, delta, _ = res["bundle"].cf_fn(res["g_vars"], x, t,
                                             torch.ones_like(x))
        arrays = {"original.png": x, "counterfactual.png": x_cf,
                  "delta.png": delta * 0.5}
        grids_equal = {n: bool(np.array_equal(
            read_png(out_dir / n),
            to_uint8_grid(a.cpu().numpy(), nrow=4))) for n, a in
            arrays.items()}
        missing = [f for f in (*EXPERIMENT_FILES, *exp2.GRIDS)
                   if not (out_dir / f).is_file()]
        missing += [f"unexpected {f}" for f in sorted(
            figure_set(out_dir) - set(MNIST_FIGURES) - set(exp2.GRIDS))]
        trained_again = any("[CounteRGAN] epoch" in ln or "[Classifier]" in ln
                            for ln in logs[1])
        flips = [float(r["class_flip_rate"]) for r in _csv_rows(
            out_dir / "countergan_metrics_per_class.csv")]
        provenance = check_run_provenance(str(out_dir))
        ok = (not missing and all(grids_equal.values())
              and not trained_again and runs[1]["history"] == {}
              and all((out_dir / n).read_bytes() == b
                      for n, b in pngs.items())
              and res["bundle"].state.step > 0
              and all(np.isfinite(flips)))
        emit({"phase": "legacy experiment", "card": card,
              "preset": "mnist_countergan2", "target": LEGACY_TARGET,
              "hidden": res["bundle"].cfg.hidden_dim,
              "limit": EXPERIMENT_LIMIT, "epochs": 1, "clf_epochs": 1,
              "steps": res["bundle"].state.step,
              "runner_captures": res["bundle"].epoch_fn.captures,
              "stage_seconds": res["stage_seconds"],
              "run_wall_s": runs[0]["wall_s"],
              "rerun_wall_s": runs[1]["wall_s"],
              "classifier_test_accuracy": res["classifier"]["accuracy"],
              "batch_metrics": res["batch_metrics"],
              "per_target_flip": flips,
              "history_flip_rate": res["history"].get("flip_rate"),
              "png_bytes": {n: len(b) for n, b in pngs.items()},
              "pngs_equal_to_uint8_grid": grids_equal,
              "provenance": provenance, "missing": missing,
              "rerun_trained": trained_again, "ok": ok})
        if not ok:
            fail("the legacy experiment's run dir, grids or rerun came out "
                 "wrong")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


# ------------------------------------------------- the memory options
def memory_launches(impl, remat: bool, k: int) -> tuple:
    """The wrappers' (epilogue fwd, epilogue bwd, conv3x3, dK) launches of
    one MNIST step: the micro step's D phase takes a plain forward and
    each of its K chunks a forward and a backward; the conv kernel runs on
    KERNEL_LAYERS_PER_FORWARD layers a forward, and again for their dx;
    `remat` runs each differentiated forward's residual blocks
    (RESBLOCK_KERNEL_LAYERS of those layers) again in the backward."""
    pallas = impl == "pallas"
    n = KERNEL_LAYERS_PER_FORWARD if pallas else 0
    chunks = k if k >= 2 else 1
    plain_fwd = 1 if k >= 2 else 0
    conv = (n * (plain_fwd + 2 * chunks)
            + remat * pallas * RESBLOCK_KERNEL_LAYERS * chunks)
    return (plain_fwd + chunks, chunks, conv, n * chunks)


def memory_phase(card: str, dev, x, y, clf_sd: dict, counts, zero_counts,
                 plain_epilogue) -> dict:
    """The shipped MNIST preset (bf16, 64 channels, 6 blocks) at batch
    128, each of remat {off, on} x g_microbatch {0, 2, 4}, with cuDNN's
    convs and with the conv kernel: an eager step's launches against
    `memory_launches` and its peak memory; MEMORY_STEPS steps through the
    epoch runner against the same steps eager, bit for bit; the same
    eager steps on the plain epilogue (losses within TRAIN_ATOL); the
    replayed step timed in turns against the remat-off, K = 0 arm's.
    Then float32 at batch MEMORY_F32_BATCH, remat {off, on} x K {0, 4}:
    peak memory and eager step ms.  One line an arm.  Returns the
    launches a step at the chunks' rows (B/2 and B/4) of g_microbatch 2
    and 4 without remat: {B/K: (epilogue fwd, epilogue bwd)} on cuDNN's
    convs and {B/K: (conv3x3, dK)} on the conv kernel (bf16)."""
    import numpy as np
    import torch

    from cfgan_torch.core.config import MNIST_COUNTERGAN
    from cfgan_torch.data.pipeline import epoch_perm
    from cfgan_torch.train.builders import build_mnist_countergan
    from cfgan_torch.train.loop import make_epoch_runner

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    gen = torch.Generator(device=dev).manual_seed(SEED)
    perm = epoch_perm(gen, len(y), TRAIN_BATCH)[:MEMORY_STEPS]
    chunk_launches, chunk_conv_launches = {}, {}

    def arm_bundles(cfg):
        return [build_mnist_countergan(cfg, clf_sd, seed=SEED, device=dev)
                for _ in range(2)]

    def eager(bundle, draws, steps):
        out = [bundle.step_from_draws(bundle.state, x[perm[i]], y[perm[i]],
                                      {k: v[i] for k, v in draws.items()})
               for i in range(steps)]
        return [(m["d_loss"].item(), m["g_loss"].item()) for m in out]

    def timed_epoch(runner, bundle, draws):
        def fn():
            runner(bundle.state, x, y, perm, draws)
        return fn

    for impl in (None, "pallas"):
        base = None
        for remat in (False, True):
            for k in (0, 2, 4):
                t_arm = time.perf_counter()
                cfg = replace(MNIST_COUNTERGAN, conv_impl=impl, remat=remat,
                              g_microbatch=k)
                ours, ref = arm_bundles(cfg)
                draws = ours.draw_fn(gen, tuple(perm.shape))
                # one eager step: launches and peak memory
                probe = build_mnist_countergan(cfg, clf_sd, seed=SEED,
                                               device=dev)
                eager(probe, draws, 1)  # Adam's state, cuDNN's choices
                torch.cuda.synchronize()
                zero_counts()
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                eager(probe, draws, 1)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                launched = counts()
                want = memory_launches(impl, remat, k)
                # all but the D phase's full-batch forward run at the
                # chunks' rows
                if k and impl is None and not remat:
                    chunk_launches[TRAIN_BATCH // k] = (launched[0] - 1,
                                                        launched[1])
                if k and impl == "pallas" and not remat:
                    chunk_conv_launches[TRAIN_BATCH // k] = (
                        launched[2] - KERNEL_LAYERS_PER_FORWARD, launched[3])
                del probe
                runner = make_epoch_runner(ours.step_from_draws,
                                           reduce=False)
                got = runner(ours.state, x, y, perm, draws)
                eager_losses = eager(ref, draws, MEMORY_STEPS)
                replayed = list(zip(got["d_loss"].tolist(),
                                    got["g_loss"].tolist()))
                replay_equal = (all(np.float32(a) == r for e, g in
                                    zip(eager_losses, replayed)
                                    for a, r in zip(e, g))
                                and _states_equal(ours.state, ref.state))
                plain = build_mnist_countergan(cfg, clf_sd, seed=SEED,
                                               device=dev)
                with plain_epilogue():
                    plain_losses = eager(plain, draws, MEMORY_STEPS)
                del plain
                errs = [max(abs(a - b) for a, b in zip(e, p))
                        for e, p in zip(eager_losses, plain_losses)]
                fn = timed_epoch(runner, ours, draws)
                if base is None:
                    base = fn
                times = {"arm": [], "base": []}
                for _ in range(3):  # in turns
                    for name, f in (("arm", fn), ("base", base)):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        f()
                        torch.cuda.synchronize()
                        times[name].append((time.perf_counter() - t0) * 1e3
                                           / MEMORY_STEPS)
                med = {n: statistics.median(v) for n, v in times.items()}
                finite = all(math.isfinite(v) for e in eager_losses
                             for v in e)
                ok = (launched == want and replay_equal and finite
                      and max(errs) <= TRAIN_ATOL[cfg.compute_dtype]
                      and runner.captures == 1)
                emit({"phase": "memory options", "card": card,
                      "conv_impl": impl, "remat": remat, "g_microbatch": k,
                      "dtype": cfg.compute_dtype, "batch": TRAIN_BATCH,
                      "steps": MEMORY_STEPS,
                      "wrapper_counts_fwd_bwd_conv_dk": launched,
                      "expected_counts": want,
                      "peak_allocated_mib": peak / 2 ** 20,
                      "step_peak_over_resident_mib": (peak - resident)
                      / 2 ** 20,
                      "replayed_equal_to_eager": replay_equal,
                      "d_g_loss_per_step": eager_losses,
                      "plain_epilogue_loss_max_abs_err": max(errs),
                      "loss_tolerance": f"abs <= "
                                        f"{TRAIN_ATOL[cfg.compute_dtype]}",
                      "replayed_ms_per_step_in_turns": times["arm"],
                      "base_replayed_ms_per_step_in_turns": times["base"],
                      "replayed_median_ms": med["arm"],
                      "base_median_ms": med["base"],
                      "images_per_s": TRAIN_BATCH / med["arm"] * 1e3,
                      "base": "remat off, g_microbatch 0, same conv_impl",
                      "arm_s": time.perf_counter() - t_arm, "ok": ok})
                if not ok:
                    fail(f"memory options {impl} remat={remat} K={k}: "
                         f"launches {launched} (want {want}), replay equal "
                         f"{replay_equal}, plain-epilogue err {max(errs)}")
                del ours, ref, runner
        del base
    torch.backends.cudnn.deterministic = False

    # float32 at a batch where the activations dominate
    xb = x[:MEMORY_F32_BATCH]
    yb = y[:MEMORY_F32_BATCH]
    for remat in (False, True):
        for k in (0, 4):
            cfg = replace(MNIST_COUNTERGAN, compute_dtype="float32",
                          remat=remat, g_microbatch=k)
            bundle = build_mnist_countergan(cfg, clf_sd, seed=SEED,
                                            device=dev)
            draws = torch.Generator(device=dev).manual_seed(SEED)

            def step():
                bundle.step_fn(bundle.state, xb, yb, draws)
                torch.cuda.synchronize()

            step()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            step()
            peak = torch.cuda.max_memory_allocated()
            lat = host_ms(step, 3, warmup=1)
            median = statistics.median(lat)
            emit({"phase": "memory options", "card": card,
                  "conv_impl": None, "remat": remat, "g_microbatch": k,
                  "dtype": "float32", "batch": MEMORY_F32_BATCH,
                  "peak_allocated_mib": peak / 2 ** 20,
                  "step_peak_over_resident_mib": (peak - resident) / 2 ** 20,
                  "eager_step_ms": lat, "eager_median_ms": median,
                  "images_per_s": MEMORY_F32_BATCH / median * 1e3,
                  "ok": True})
            del bundle
    torch.cuda.empty_cache()
    return chunk_launches, chunk_conv_launches


EXPORT_SUBPACKAGES = ("core", "data", "eval", "experiments", "losses",
                      "masks", "models", "nn", "ops", "parallel", "serve",
                      "train")
GRAD_NORM_RTOL = 1e-6
TERMS_RTOL = 1e-5  # f32: the kernel's row sums run in another order


def _exported(mod) -> dict:
    """A package's exported names: its `__all__`, else the public
    attributes it binds that are not modules."""
    import types

    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, v in vars(mod).items()
                 if not n.startswith("_")
                 and not isinstance(v, types.ModuleType)]
    return {n: getattr(mod, n) for n in names}


def _defined_in_port(pkg, name: str, obj) -> bool:
    home = getattr(obj, "__module__", None)
    if home is None:  # data, such as the presets' dict
        home = next((m for m, mod in sys.modules.items()
                     if m.startswith("cfgan_torch.") and mod is not pkg
                     and getattr(mod, name, None) is obj), "")
    return home.startswith("cfgan_torch.")


def exports_part(dev, bundle, clf_sd: dict, x, y, counts,
                 zero_counts) -> dict:
    """The port's import surface and the helpers of its last slice on the
    card, on `bundle` (the bf16 preset at full width, conv_impl="pallas"):

    (a) every exported name of the twelve subpackages resolves to an
        object defined in the port;
    (b) one generator forward (13 conv launches) on the batch `x` with
        targets and masks drawn by `bundle.draw_fn`, the raw residual in
        float32 through `cf_epilogue` (one forward launch), the
        classifier and the discriminator on its x_cf, and
        `countergan_g_terms`, whose reg_l1, reg_l2 and mask_penalty are
        held against `epilogue_terms` of the kernel's row sums for both
        reductions, at relative TERMS_RTOL;
    (c) the backward of the preset's total through the generator (one
        epilogue backward, 13 dx and 13 dK launches), and
        `global_grad_norm` of the generator's gradients against
        `vector_norm` of their concatenation in float64, at relative
        GRAD_NORM_RTOL (the float32 `vector_norm`'s distance is reported);
    (d) engines served from `g_eval_variables(state)` with the EMA and
        without it (the same state with `g_ema=None`), each at b=128 bit
        for bit the engine of the same variables assembled by hand from
        the module's buffers and parameters or EMA, 13 conv launches a
        forward.

    Returns the part's line; fails on any check."""
    import dataclasses
    import importlib

    import torch

    from cfgan_torch.losses import countergan_g_terms
    from cfgan_torch.losses import gan as gan_losses
    from cfgan_torch.masks import random_patch_mask
    from cfgan_torch.ops import cf_epilogue, epilogue_terms
    from cfgan_torch.train import global_grad_norm
    from cfgan_torch.train.builders import (
        clf_forward_fn,
        make_mixed_precision,
        mnist_models,
    )
    from cfgan_torch.train.countergan import sample_targets
    from cfgan_torch.train.state import g_eval_variables

    t0 = time.perf_counter()
    cfg, state = bundle.cfg, bundle.state
    report = {"phase": "train pallas", "part": "exports",
              "dtype": cfg.compute_dtype, "batch": x.shape[0]}

    # (a) the import surface
    unresolved, n_names = [], 0
    for sub in EXPORT_SUBPACKAGES:
        pkg = importlib.import_module(f"cfgan_torch.{sub}")
        for name, obj in _exported(pkg).items():
            n_names += 1
            if not _defined_in_port(pkg, name, obj):
                unresolved.append(f"{sub}.{name}")
    report["exported_names"] = n_names
    if unresolved:
        fail(f"exported names not defined in the port: {unresolved}")

    # (b) the terms against the epilogue kernel's sums
    g_forward = make_mixed_precision(state.g.model, cfg.compute_dtype)
    d_forward = make_mixed_precision(state.d.model, cfg.compute_dtype)
    clf_model = mnist_models(cfg)[1]
    clf_model.load_state_dict(clf_sd)
    clf_forward = clf_forward_fn(clf_model.to(dev), cfg.compute_dtype)
    g_adv = {"bce": gan_losses.g_loss_bce,
             "wasserstein": gan_losses.g_loss_wasserstein}[cfg.adv_loss]
    draws = bundle.draw_fn(torch.Generator(device=dev).manual_seed(SEED),
                           (x.shape[0],))
    t = sample_targets(y, bundle.num_classes, cfg.resample_target,
                       draws=draws["targets"])
    m = cfg.mask
    mask = random_patch_mask(x.shape[0], x.shape[1:3], m.patch_size,
                             m.num_modifiable_patches, channels=x.shape[-1],
                             draws=draws.get("mask"), device=dev)
    lo, hi = cfg.clamp_cf if cfg.clamp_cf is not None else (-1e30, 1e30)
    lambdas = dict(lambda_adv=cfg.lambda_adv, lambda_cls=cfg.lambda_cls,
                   lambda_reg_l1=cfg.lambda_reg_l1,
                   lambda_reg_l2=cfg.lambda_reg_l2,
                   lambda_mask=cfg.lambda_mask)
    state.g.model.zero_grad(set_to_none=True)
    zero_counts()
    raw, _ = g_forward(x, t, mask, update_stats=False)
    raw, xf = raw.float(), x.float()
    x_cf, *sums = cf_epilogue(xf, raw, mask, lo, hi)
    clf_logits = clf_forward(x_cf)
    adv = g_adv(d_forward(x_cf, t, detach=True, train=False))
    n_features = x[0].numel()
    terms_err = {}
    for reduction in ("per_sample_norm", "mean_abs"):
        # a nonzero lambda_reg_l2 computes reg_l2, which the preset skips
        got = countergan_g_terms(adv, clf_logits, t, raw * mask, raw, mask,
                                 **{**lambdas, "lambda_reg_l2": 1.0},
                                 reg_reduction=reduction)
        want = epilogue_terms(*(v.detach() for v in sums), n_features,
                              reduction)
        for name, a, b in zip(("reg_l1", "reg_l2", "mask_penalty"),
                              (got.reg_l1, got.reg_l2, got.mask_penalty),
                              want):
            terms_err[f"{reduction}/{name}"] = abs(
                a.item() - b.item()) / abs(b.item())
    terms = countergan_g_terms(adv, clf_logits, t, raw * mask, raw, mask,
                               **lambdas, reg_reduction=cfg.reg_reduction)
    if cfg.lambda_reg_l2 == 0 and not (terms.reg_l2.shape == ()
                                       and terms.reg_l2.device == x.device
                                       and terms.reg_l2.item() == 0.0):
        fail(f"reg_l2 is not a 0-d zero on the card: {terms.reg_l2}")

    # (c) the backward and the gradients' norm
    terms.total.backward()
    torch.cuda.synchronize()
    launched = counts()
    want_launches = (1, 1, 2 * KERNEL_LAYERS_PER_FORWARD,
                     KERNEL_LAYERS_PER_FORWARD)
    grads = {n: p.grad for n, p in state.g.model.named_parameters()
             if p.grad is not None}
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    norm = global_grad_norm(grads).item()
    exact = torch.linalg.vector_norm(flat, dtype=torch.float64).item()
    f32 = torch.linalg.vector_norm(flat).item()
    state.g.model.zero_grad(set_to_none=True)
    report.update({
        "total": terms.total.item(),
        "terms_rel_err": terms_err, "terms_tolerance": f"rel <= {TERMS_RTOL}",
        "launches_fwd_bwd_conv_dk": list(launched),
        "grad_leaves": len(grads), "grad_elements": flat.numel(),
        "global_grad_norm": norm, "vector_norm_f64": exact,
        "grad_norm_rel_err": abs(norm - exact) / exact,
        "vector_norm_f32_rel_err": abs(f32 - exact) / exact,
        "grad_norm_tolerance": f"rel <= {GRAD_NORM_RTOL}"})
    if launched != want_launches:
        fail(f"the exports part launched (fwd, bwd, conv, dK) = {launched}, "
             f"not {want_launches}")
    if max(terms_err.values()) > TERMS_RTOL:
        fail(f"countergan_g_terms part from the epilogue kernel's terms: "
             f"{terms_err}")
    if report["grad_norm_rel_err"] > GRAD_NORM_RTOL:
        fail(f"global_grad_norm {norm} is not the gradients' norm {exact}")

    # (d) engines from g_eval_variables, with and without the EMA
    model = state.g.model
    buffers = dict(model.named_buffers())
    xs, ts = x.cpu().numpy(), t.cpu().numpy()
    served = {}
    for arm, st, by_hand in (
            ("ema", state, {**buffers, **state.g_ema}),
            ("live", dataclasses.replace(state, g_ema=None),
             {**buffers, **dict(model.named_parameters())})):
        ours = g_eval_variables(st)
        if ours.keys() != by_hand.keys():
            fail(f"g_eval_variables' names ({arm}) are not the module's")
        results, conv = [], []
        for g_vars in (ours, by_hand):
            e = served_engine(cfg, g_vars, clf_sd, dev, cfg.compute_dtype)
            zero_counts()
            results.append(e.generate(xs, ts))
            torch.cuda.synchronize()
            conv.append(counts()[2])
        served[arm] = ours
        same = _same_result(*results)
        report[f"served_{arm}"] = {"bit_for_bit": same,
                                   "conv3x3_launches": conv}
        if not same or conv != [KERNEL_LAYERS_PER_FORWARD] * 2:
            fail(f"the engine from g_eval_variables ({arm}) served "
                 f"{'other' if not same else 'the same'} results with "
                 f"{conv} conv launches")
    report["ema_differs_from_live"] = any(
        not torch.equal(served["ema"][k], served["live"][k])
        for k in state.g_ema)
    if not report["ema_differs_from_live"]:
        fail("the EMA parameters equal the live ones: (d) shows nothing")
    report["part_seconds"] = round(time.perf_counter() - t0, 3)
    return report


def randomize_batch_norms(model, gen) -> None:
    """Non-trivial BatchNorm statistics, scales and shifts for `model`'s
    served BatchNorms, drawn from `gen`."""
    import torch

    from cfgan_torch.nn.layers import BatchNorm

    for bn in model.modules():
        if isinstance(bn, BatchNorm):
            n = bn.running_mean.shape[0]
            bn.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
            bn.running_var.copy_(0.5 + torch.rand(n, generator=gen))
            bn.weight.data.copy_(0.5 + torch.rand(n, generator=gen))
            bn.bias.data.copy_(0.1 * torch.randn(n, generator=gen))


def served_engine(cfg, g_sd: dict, c_sd: dict, dev, dtype: str,
                  plain: bool = False, **shape):
    """The served preset `cfg` at `dtype` (`build_mnist_serving`; `shape`:
    its `num_classes` and `image_hw`); `plain=True` switches the layers
    routed to the conv kernel over to its plain version, and nothing
    else.  Fails unless KERNEL_LAYERS_PER_FORWARD layers are routed."""
    from cfgan_torch.nn.layers import Conv
    from cfgan_torch.serve.engine import CounterfactualEngine
    from cfgan_torch.train.builders import build_mnist_serving

    s = build_mnist_serving(replace(cfg, compute_dtype=dtype), g_sd, c_sd,
                            device=dev, **shape)
    routed = [m for m in s.generator.modules()
              if isinstance(m, Conv) and m.impl == "pallas"]
    if len(routed) != KERNEL_LAYERS_PER_FORWARD:
        fail(f"{len(routed)} generator layers routed to the kernel, not "
             f"{KERNEL_LAYERS_PER_FORWARD}")
    for m in routed if plain else ():
        m.impl = "matmul"

    def replica(d):
        r = build_mnist_serving(replace(cfg, compute_dtype=dtype), g_sd,
                                c_sd, device=d, **shape)
        return r.cf_fn, r.clf_fn

    return CounterfactualEngine(s.cf_fn, s.clf_fn, s.num_classes,
                                patch_size=cfg.mask.patch_size, device=dev,
                                replica_fn=None if plain else replica)


def compare_served(report: dict, ours: dict, plain: dict, num_classes: int,
                   dtype: str, what: str) -> None:
    """Each request of `ours` (name -> CFResult) against the same request
    of `plain` at the serving bars (x_cf F32_ATOL in f32, BF16_CF_ATOL in
    bf16; probabilities PROBS_ATOL), shapes and finite values, into
    `report[name]`; fails on the first that misses."""
    import numpy as np

    cf_atol = F32_ATOL if dtype == "float32" else BF16_CF_ATOL
    for name, r in ours.items():
        p = plain[name]
        shape_ok = (r.x_cf.shape == p.x_cf.shape
                    and r.probs.shape == (p.x_cf.shape[0], num_classes)
                    and np.isfinite(r.x_cf).all()
                    and np.isfinite(r.probs).all())
        cf_err = float(np.abs(r.x_cf - p.x_cf).max())
        pr_err = float(np.abs(r.probs - p.probs).max())
        report[name] = {"rows": int(r.x_cf.shape[0]),
                        "x_cf_max_abs_err": cf_err,
                        "probs_max_abs_err": pr_err,
                        "flip_rate": float(r.flipped.mean())}
        if not shape_ok:
            fail(f"{what} {dtype} {name}: bad shape or non-finite values")
        if cf_err > cf_atol or pr_err > PROBS_ATOL[dtype]:
            fail(f"{what} {dtype} {name}: kernel engine differs from the "
                 f"plain-conv engine (x_cf {cf_err}, probs {pr_err})")


# ------------------------------------------ any shape and class count
def _example(name: str):
    """The port's example module `examples/{name}.py`, imported from this
    checkout."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, HERE / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def moment_report(mu: dict, plain_mu: dict, ours: dict, theirs: dict,
                  lr: float, dtype: str) -> tuple[dict, bool]:
    """The `train pallas` bars on one net of two runs: every weight leaf's
    first moment after the first step within PALLAS_MU_RTOL[dtype] of its
    2-norm (bias leaves left out), and in f32 at most
    PALLAS_F32_OUTLIER_SHARE of the parameters more than lr / 10 apart.
    Returns (report, ok)."""
    import numpy as np

    rel = {name: float(np.linalg.norm(m - plain_mu[name])
                       / np.linalg.norm(plain_mu[name]))
           for name, m in mu.items() if not name.endswith("bias")}
    worst = max(rel, key=rel.get)
    if ours.keys() != theirs.keys():
        fail("the two runs hold other parameters")
    diff = np.concatenate([np.abs(ours[k] - theirs[k]).ravel() for k in ours])
    share = float((diff > lr / 10).mean())
    report = {"first_moment_worst_rel_err": rel[worst], "worst_leaf": worst,
              "first_moment_rtol": PALLAS_MU_RTOL[dtype],
              "param_max_abs_diff": float(diff.max()),
              "share_over_lr_10": share}
    ok = rel[worst] <= PALLAS_MU_RTOL[dtype]
    if dtype == "float32":
        report["share_bound"] = PALLAS_F32_OUTLIER_SHARE
        ok = ok and share <= PALLAS_F32_OUTLIER_SHARE
    return report, ok


def custom_shapes_phase(card: str, dev, counts, zero_counts) -> dict:
    """The shipped MNIST preset (64 channels, 6 blocks, bf16, EMA 0.999)
    built at CUSTOM_CLASSES classes and CUSTOM_HW images with the conv
    kernel and the image example's 4x4 grid of 5-px patches, on the
    example's shape data:

    (a) the conv kernel (forward, dx) and dK, bf16 and f32, at
        CUSTOM_CONV_SHAPES, and the epilogue kernels at CUSTOM_EPI_ROWS,
        against their plain versions at the bars of the 28x28 shapes,
        naming the epilogue variant each launched;
    (b) CUSTOM_STEPS eager steps at batch 128 and 64, bf16 and f32: 26
        conv, 13 dK and 1 + 1 epilogue launches a step, the losses and
        Adam's first moments of the same steps with the plain conv at the
        `train pallas` bars;
    (c) one epoch of the bf16 step through the epoch runner equal to the
        same steps eager, bit for bit;
    (d) the served preset at 20x20 (13 conv launches a generator forward,
        b=64 alone among them) equal to the same weights on cuDNN's convs
        at the serving bars, edits outside a patch mask zero;
    (e) the device times of the new shapes, each with its bound and
        cuDNN's time (`time_conv`, `time_dkernel`, `time_epilogue`).

    Returns the errors, launches and timings for the `kernels` line."""
    import numpy as np
    import torch

    from cfgan_torch.convert import adam_moments_to_flax, gan_state_to_flax
    from cfgan_torch.core.config import MNIST_COUNTERGAN, MaskConfig
    from cfgan_torch.data.pipeline import epoch_perm
    from cfgan_torch.models.classifiers import CNNClassifier
    from cfgan_torch.train.builders import build_mnist_countergan, mnist_models
    from cfgan_torch.train.loop import WARMUP_STEPS, make_epoch_runner

    hw, nc = CUSTOM_HW, CUSTOM_CLASSES
    gen = torch.Generator().manual_seed(SEED + 20)
    out = {"conv_err": {}, "dk_err": {}, "epi_err": {}, "launches": {},
           "timing": {}}

    # (a) the kernels against their plain versions
    for shape in CUSTOM_CONV_SHAPES:
        for dtype in ("float32", "bfloat16"):
            out["conv_err"][shape, dtype] = check_conv(
                gen, dev, shape, dtype, "custom shapes")
            out["dk_err"][shape, dtype] = check_dkernel(
                gen, dev, shape, dtype, "custom shapes")
    for b, n in CUSTOM_EPI_ROWS:
        errs = [check_epilogue(gen, dev, b, n, False, lo, hi,
                               "custom shapes") for lo, hi in EPI_BOUNDS]
        want = "16-byte" if n % 4 == 0 else "4-byte"
        if any(e["variant"] != {"fwd": want, "bwd": want} for e in errs):
            fail(f"the epilogue at {(b, n)} ran {errs[0]['variant']}, not "
                 f"the {want} variant")
        out["epi_err"][b, n] = {k: max(e[k] for e in errs)
                                for k in ("fwd", "bwd")}

    # (b) eager steps, kernels against plain convs
    xs, ys = _example("torch_custom_images").make_shape_dataset()
    n_train = int(0.8 * len(ys))
    x = torch.as_tensor(xs[:n_train]).to(dev)
    y = torch.as_tensor(ys[:n_train]).to(dev, torch.long)
    cfg = replace(MNIST_COUNTERGAN, conv_impl="pallas",
                  mask=MaskConfig(kind="patch", patch_size=CUSTOM_PATCH,
                                  num_modifiable_patches=CUSTOM_MODIFIABLE))
    clf_sd = CNNClassifier(nc, image_hw=hw, generator=gen).state_dict()

    def bundle_of(c):
        return build_mnist_countergan(c, clf_sd, seed=SEED, device=dev,
                                      num_classes=nc, image_hw=hw)

    def run_steps(c, batch: int):
        bundle = bundle_of(c)
        draws = torch.Generator(device=dev).manual_seed(SEED)
        losses = []
        for i in range(CUSTOM_STEPS):
            rows = slice(i * batch, (i + 1) * batch)
            m = bundle.step_fn(bundle.state, x[rows], y[rows], draws)
            losses.append((m["d_loss"], m["g_loss"]))
            if i == 0:
                mu = {net: _flat(t) for net, t in
                      adam_moments_to_flax(bundle.state).items()}
        torch.cuda.synchronize()
        return bundle, [(d.item(), g.item()) for d, g in losses], mu

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    for dtype in ("bfloat16", "float32"):
        for batch in (128, 64):
            c = replace(cfg, compute_dtype=dtype)
            want = (CUSTOM_STEPS, CUSTOM_STEPS,
                    2 * KERNEL_LAYERS_PER_FORWARD * CUSTOM_STEPS,
                    KERNEL_LAYERS_PER_FORWARD * CUSTOM_STEPS)
            zero_counts()
            bundle, losses, mu = run_steps(c, batch)
            launched = counts()
            if launched != want:
                fail(f"custom shapes {dtype} batch {batch}: (fwd, bwd, "
                     f"conv, dK) = {launched}, not {want}")
            plain, plain_losses, plain_mu = run_steps(
                replace(c, conv_impl="matmul"), batch)
            if counts()[2:] != launched[2:]:
                fail("the plain-conv run launched the conv or dK kernel")
            out["launches"][dtype, batch] = launched
            errs = [max(abs(a - b) for a, b in zip(k, p))
                    for k, p in zip(losses, plain_losses)]
            finite = all(math.isfinite(v) for pair in losses + plain_losses
                         for v in pair)
            report = {"phase": "custom shapes", "part": "steps",
                      "card": card, "dtype": dtype, "batch": batch,
                      "image_hw": hw, "num_classes": nc,
                      "steps": CUSTOM_STEPS,
                      "wrapper_counts_fwd_bwd_conv_dk": launched,
                      "d_g_loss_per_step": losses,
                      "plain_conv_d_g_loss_per_step": plain_losses,
                      "loss_max_abs_err_per_step": errs,
                      "loss_tolerance": f"abs <= {TRAIN_ATOL[dtype]}"}
            ok = finite and max(errs) <= TRAIN_ATOL[dtype]
            ours = gan_state_to_flax(bundle.state)
            theirs = gan_state_to_flax(plain.state)
            for net, lr in (("g", c.lr_g), ("d", c.lr_d)):
                report[net], net_ok = moment_report(
                    mu[net], plain_mu[net], _flat(ours[net]["params"]),
                    _flat(theirs[net]["params"]), lr, dtype)
                ok = ok and net_ok
            report["ok"] = bool(ok)
            emit(report)
            if not ok:
                fail(f"custom shapes {dtype} batch {batch}: the conv kernel's "
                     f"steps differ from the plain conv's")
            del bundle, plain

    # (c) one epoch through the runner against eager, bit for bit
    c = replace(cfg, compute_dtype="bfloat16")
    ours, ref = bundle_of(c), bundle_of(c)
    g_perm = torch.Generator(device=dev).manual_seed(SEED)
    perm = epoch_perm(g_perm, len(y), TRAIN_BATCH)
    draws = ours.draw_fn(g_perm, tuple(perm.shape))
    runner = make_epoch_runner(ours.step_from_draws, reduce=False)
    got = runner(ours.state, x, y, perm, draws)
    eager = [ref.step_from_draws(ref.state, x[perm[i]], y[perm[i]],
                                 {k: v[i] for k, v in draws.items()})
             for i in range(perm.shape[0])]
    eager = [(m["d_loss"].item(), m["g_loss"].item()) for m in eager]
    replayed = list(zip(got["d_loss"].tolist(), got["g_loss"].tolist()))
    same_losses = all(np.float32(a) == r for e, g in zip(eager, replayed)
                      for a, r in zip(e, g))
    same_state = _states_equal(ours.state, ref.state)
    ok = (same_losses and same_state and runner.captures == 1
          and runner.replays == perm.shape[0] - WARMUP_STEPS)
    emit({"phase": "custom shapes", "part": "epoch runner", "card": card,
          "dtype": "bfloat16", "batch": TRAIN_BATCH, "steps": perm.shape[0],
          "captures": runner.captures, "replays": runner.replays,
          "d_g_loss_per_step": replayed, "losses_equal_to_eager": same_losses,
          "state_equal_to_eager": same_state,
          "tolerance": "bit for bit: losses and state", "ok": ok})
    if not ok:
        fail("custom shapes: the replayed epoch differs from eager steps")
    del ours, ref, runner
    torch.backends.cudnn.deterministic = False

    # (d) serving, the kernel route against cuDNN's convs
    g_model, c_model = mnist_models(cfg, generator=gen, num_classes=nc,
                                    image_hw=hw)
    randomize_batch_norms(g_model, gen)
    g_sd, c_sd = g_model.state_dict(), c_model.state_dict()
    xq = xs[n_train:]
    tq = np.arange(len(xq)) % nc

    for dtype in ("bfloat16", "float32"):
        served, launched = {}, {}
        for plain in (False, True):
            e = served_engine(cfg, g_sd, c_sd, dev, dtype, plain,
                              num_classes=nc, image_hw=hw)
            mask = e.mask_from_patches(CUSTOM_PATCHES, 128, hw)
            zero_counts()
            b64 = e.generate(xq[:64], tq[:64])
            launched[plain, "b64"] = counts()[2]
            served[plain] = {
                "b1": e.generate(xq[0], 1), "b64": b64,
                "b128_patches": e.generate(xq[:128], tq[:128], mask),
                "zero_mask": e.generate(xq[:128], tq[:128],
                                        np.zeros_like(xq[:128])),
                "bulk": e.generate_bulk(xq, tq, chunk=128)}
            torch.cuda.synchronize()
            launched[plain] = counts()[2]
        # four generate calls and four bulk chunks (three padded to four)
        want = KERNEL_LAYERS_PER_FORWARD * 8
        if (launched[False], launched[False, "b64"]) != (
                want, KERNEL_LAYERS_PER_FORWARD) or launched[True] != 0:
            fail(f"custom shapes serving {dtype}: conv launches {launched}, "
                 f"not {want} (13 at b=64) and none on cuDNN's route")
        out["launches"]["serve", dtype] = launched[False]
        out["launches"]["serve_b64", dtype] = launched[False, "b64"]
        report = {"phase": "custom shapes", "part": "serve", "card": card,
                  "dtype": dtype, "image_hw": hw, "num_classes": nc,
                  "kernel_launches": launched[False],
                  "b64_kernel_launches": launched[False, "b64"],
                  "x_cf_atol": (F32_ATOL if dtype == "float32"
                                else BF16_CF_ATOL),
                  "probs_atol": PROBS_ATOL[dtype]}
        compare_served(report, served[False], served[True], nc, dtype,
                       "custom shapes")
        keep = mask.cpu().numpy()
        leak = float((np.abs(served[False]["b128_patches"].x_cf - xq[:128])
                      * (1 - keep)).max())
        zero = served[False]["zero_mask"]
        report["max_edit_outside_patches"] = leak
        report["zero_mask_returns_x"] = bool(
            np.array_equal(zero.x_cf, xq[:128]) and not zero.residual.any())
        report["ok"] = leak == 0.0 and report["zero_mask_returns_x"]
        emit(report)
        if not report["ok"]:
            fail(f"custom shapes serving {dtype}: an edit outside the mask")

    # (e) device times at the new shapes
    for shape in CUSTOM_CONV_SHAPES:
        for dtype in ("bfloat16", "float32"):
            out["timing"][shape, dtype] = time_conv(
                card, gen, dev, shape, dtype, "custom shapes")
            out["timing"]["dk", shape, dtype] = time_dkernel(
                card, gen, dev, shape, dtype, "custom shapes")
    for b, n in CUSTOM_EPI_ROWS:
        out["timing"]["epi", b, n] = time_epilogue(
            card, dev, n=n, b=b, bounds=(-1.0, 1.0) if n == 400 else
            (0.0, 1.0))
    return out


def examples_phase(card: str, dev, counts, zero_counts) -> dict:
    """Both port examples whole at their shipped sizes on the card, with
    their own checks (an AssertionError fails the phase); one line each
    with the wall seconds, the classifier's accuracy, the mean flip rate,
    the largest edit outside the allowed patches or the features changed,
    and the wrappers' launches.  Returns {example: (fwd, bwd, conv, dK)}
    launches."""
    import contextlib
    import io

    launches = {}
    for name in ("torch_custom_images", "torch_custom_tabular"):
        module = _example(name)
        zero_counts()
        log = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(log):
                result = module.main(device=dev)
        except AssertionError as e:
            print(log.getvalue()[-3000:], flush=True)
            fail(f"{name}: {e}")
        wall = time.perf_counter() - t0
        launches[name] = counts()
        emit({"phase": "examples", "example": f"examples/{name}.py",
              "card": card, "wall_s": wall, **result,
              "wrapper_counts_fwd_bwd_conv_dk": launches[name],
              "log_tail": log.getvalue().splitlines()[-4:], "ok": True})
        if not launches[name][0]:
            fail(f"{name}: the epilogue kernel never launched")
    return launches


def figures_phase(card: str, dev, counts, zero_counts) -> dict:
    """The MNIST figures of the shipped generator and classifier
    (FIGURES_RUN_DIR, bf16) drawn through the conv kernel into
    `build/smoke_figures/`: the counterfactual grid, the heatmap panels,
    the patch-budget curve, the patch grid and the user-modification
    example, each figure's conv launches counted (13 a generator
    forward); the kernel against its plain version at the figures'
    batches; the kernel route's grid against cuDNN's route on the same
    weights (x_cf as close to a float32 route's as cuDNN's, within
    API_KERNEL_SLACK; flips equal but where the target's logit margin is
    under BF16_CF_ATOL); every
    PNG read back equal to its `render()`; each figure's host ms and the
    kernel's device ms at the figures' batches.  Returns {b: {launches,
    err, timing}} for the kernels line."""
    import numpy as np
    import torch

    from cfgan_torch.core.config import MNIST_COUNTERGAN
    from cfgan_torch.data.mnist import load_mnist
    from cfgan_torch.eval import figure as fig_mod
    from cfgan_torch.eval.images import (
        counterfactual_grid,
        heatmap_panels,
        patch_grid_overlay,
        pick_one_per_class,
        user_modification_example,
    )
    from cfgan_torch.eval.mask_analysis import patch_budget_curve
    from cfgan_torch.masks.patch import random_patch_mask
    from cfgan_torch.serve.launch import restore_state_dict
    from cfgan_torch.train.builders import build_mnist_serving, mnist_models

    for part in ("classifier", "generator"):
        if not (FIGURES_RUN_DIR / part).is_dir():
            fail(f"the figures phase draws the committed run dir; missing "
                 f"{FIGURES_RUN_DIR / part}")
    laps = Laps()
    out_dir = HERE / "build" / "smoke_figures"
    shutil.rmtree(out_dir, ignore_errors=True)

    def routes(conv_impl, dtype):
        """(cf_fn in the figures' signature, clf_fn) of the run dir."""
        cfg = replace(MNIST_COUNTERGAN, conv_impl=conv_impl,
                      compute_dtype=dtype)
        g_model, clf_model = mnist_models(cfg)
        s = build_mnist_serving(
            cfg, restore_state_dict(g_model, f"{FIGURES_RUN_DIR}/generator"),
            restore_state_dict(clf_model, f"{FIGURES_RUN_DIR}/classifier"),
            device=dev)
        return (lambda g_vars, x, t, m, key=None: s.cf_fn(x, t, m, key),
                s.clf_fn)

    cf_kernel, clf_fn = routes("pallas", "bfloat16")
    cf_cudnn, _ = routes(None, "bfloat16")
    cf_f32, _ = routes(None, "float32")
    cfg = MNIST_COUNTERGAN
    ps, n_mod = cfg.mask.patch_size, cfg.mask.num_modifiable_patches
    _, _, (xte, yte) = load_mnist()
    laps("setup")

    # every figure the raster saves: its path, figure and save ms
    saved = []
    save = fig_mod.Figure.save

    def spy(self, path):
        t0 = time.perf_counter()
        out = save(self, path)
        saved.append((Path(path), self, (time.perf_counter() - t0) * 1e3))
        return out

    gen = torch.Generator(device=dev).manual_seed(SEED)
    vis_mask = random_patch_mask(FIGURE_SAMPLES, (28, 28), ps, n_mod,
                                 generator=gen, device=dev)
    vis_t = torch.randint(0, 10, (FIGURE_SAMPLES,), generator=gen,
                          device=dev)
    figures = {
        "cf_grid": (1, lambda: counterfactual_grid(
            cf_kernel, clf_fn, {}, xte, yte, 10,
            str(out_dir / "cf_grid.png"), device=dev)),
        "heatmap_panels": (1, lambda: heatmap_panels(
            cf_kernel, clf_fn, {}, xte[:FIGURE_SAMPLES],
            yte[:FIGURE_SAMPLES], vis_t, vis_mask,
            str(out_dir / "eval_visuals"), device=dev)),
        "patch_budget_curve": (8, lambda: patch_budget_curve(
            cf_kernel, clf_fn, {}, xte, yte, 10, ps, out_dir=str(out_dir),
            generator=torch.Generator(device=dev).manual_seed(SEED),
            device=dev)),
        "patch_grid": (0, lambda: patch_grid_overlay(
            xte[0], ps, str(out_dir / "patch_grid.png"))),
        "user_modification_example": (1, lambda: user_modification_example(
            cf_kernel, clf_fn, {}, xte[0], target=3,
            patch_indices=list(range(6, 12)), patch_size=ps,
            path=str(out_dir / "user_modification_example.png"),
            device=dev))}
    drawn, results = {}, {}
    fig_mod.Figure.save = spy
    try:
        for name, (forwards, draw) in figures.items():
            zero_counts()
            n_saved = len(saved)
            t0 = time.perf_counter()
            results[name] = draw()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            launched = counts()[2]
            drawn[name] = {
                "conv3x3_launches": launched,
                "generator_forwards": forwards,
                "host_ms": wall_ms,
                "save_ms": sum(ms for _, _, ms in saved[n_saved:]),
                "files": len(saved) - n_saved}
            if launched != KERNEL_LAYERS_PER_FORWARD * forwards:
                fail(f"the {name} figure launched the conv kernel "
                     f"{launched} times, not {KERNEL_LAYERS_PER_FORWARD} "
                     f"x {forwards}")
    finally:
        fig_mod.Figure.save = save
    total = sum(d["conv3x3_launches"] for d in drawn.values())
    laps("draw")

    # every PNG read back: its IHDR size and pixels against render()
    readback = {}
    for path, fig, _ in saved:
        px = fig_mod.read_png(path)
        readback[path.relative_to(out_dir).as_posix()] = (
            px.shape[:2] == (fig.height, fig.width)
            and bool(np.array_equal(px, fig.render())))
    written = figure_set(out_dir)
    want = {f for f in MNIST_FIGURES if not f.startswith((
        "classifier", "gan_losses"))}
    laps("readback")

    # the kernel against its plain version at the figures' batches
    cgen = torch.Generator().manual_seed(SEED)
    err = {(shape, dtype): check_conv(cgen, dev, shape, dtype, "figures")
           for shape in FIGURE_CONV_SHAPES + (FIGURE_BUDGET_SHAPE,)
           for dtype in ("bfloat16", "float32")}
    laps("kernel vs plain")

    # the kernel route's grid against cuDNN's and the float32 route's
    sources, _ = pick_one_per_class(xte, yte, 10)
    xs = torch.as_tensor(np.repeat(sources, 10, axis=0)).to(dev)
    ts = torch.arange(10, device=dev).repeat(10)
    ones = torch.ones_like(xs)
    with torch.no_grad():
        x_k, x_c, x_f = (f({}, xs, ts, ones)[0]
                         for f in (cf_kernel, cf_cudnn, cf_f32))
        logits = {k: clf_fn(v) for k, v in (("kernel", x_k),
                                             ("cudnn", x_c))}
    flips_k = results["cf_grid"]
    flips_c = (logits["cudnn"].argmax(1) == ts).cpu().numpy().reshape(10, 10)

    def margin(lg):
        other = lg.clone()
        other[torch.arange(len(ts)), ts] = -torch.inf
        return (lg.gather(1, ts[:, None])[:, 0] - other.max(1).values)

    near = ((margin(logits["kernel"]).abs() < BF16_CF_ATOL)
            | (margin(logits["cudnn"]).abs() < BF16_CF_ATOL)).cpu().numpy(
                ).reshape(10, 10)
    differ = flips_k != flips_c

    def dist(a, b):
        return float((a - b).abs().max()), float((a - b).abs().mean())

    grid = {"kernel_vs_cudnn_x_cf_max_mean": dist(x_k, x_c),
            "kernel_vs_f32_x_cf_max_mean": dist(x_k, x_f),
            "cudnn_vs_f32_x_cf_max_mean": dist(x_c, x_f),
            "flips_kernel": int(flips_k.sum()),
            "flips_cudnn": int(flips_c.sum()),
            "cells_flip_differs": int(differ.sum()),
            "cells_margin_under_bar": int(near.sum())}
    laps("grid vs cuDNN")

    # the kernel's device time at the figures' batches (bf16, the path's)
    timing = {shape[0]: time_conv(card, cgen, dev, shape, "bfloat16",
                                  "figures")
              for shape in FIGURE_CONV_SHAPES + (FIGURE_BUDGET_SHAPE,)}
    laps("timing")
    # x_cf: the shipped weights' residuals reach ~5, where a bf16 ulp is
    # 2**-5 to 2**-6, so the two bf16 routes part by more than the
    # random-weight bar (reported as `bf16_bar_holds`); each is held
    # against the float32 route as the api phase holds the served kernel
    (k_max, k_mean), (c_max, c_mean) = (grid["kernel_vs_f32_x_cf_max_mean"],
                                        grid["cudnn_vs_f32_x_cf_max_mean"])
    grid["bf16_bar_holds"] = (grid["kernel_vs_cudnn_x_cf_max_mean"][0]
                              <= BF16_CF_ATOL)
    ok = (total > 0 and all(readback.values()) and written == want
          and k_max <= API_KERNEL_SLACK * c_max
          and k_mean <= API_KERNEL_SLACK * c_mean
          and not (differ & ~near).any())
    emit({"phase": "figures", "card": card, "run_dir": str(
              FIGURES_RUN_DIR.relative_to(HERE)), "dtype": "bfloat16",
          "figures": drawn, "conv3x3_launches": total,
          "pngs_read_back_equal": sum(readback.values()),
          "pngs": len(readback),
          "files_missing": sorted(want - written),
          "files_unexpected": sorted(written - want),
          "grid": grid,
          "tolerance": f"against the float32 route, the kernel's x_cf max "
                       f"and mean abs error <= {API_KERNEL_SLACK} x the "
                       f"bf16 cuDNN route's; flips equal to cuDNN's where "
                       f"both routes' target-logit margins are >= "
                       f"{BF16_CF_ATOL}; bf16_bar_holds: x_cf kernel vs "
                       f"cuDNN <= {BF16_CF_ATOL}",
          "user_example": {k: results["user_modification_example"][k]
                           for k in ("pred", "confidence")},
          "heatmap_preds": results["heatmap_panels"]["preds"].tolist(),
          "part_seconds": laps.s, "ok": ok})
    shutil.rmtree(out_dir, ignore_errors=True)
    if not ok:
        fail("the figures missed the conv kernel, a PNG read back other "
             "than drawn, or the kernel route's grid left cuDNN's")
    return {shape[0]: {"launches": drawn[name]["conv3x3_launches"],
                       "err": err[shape, "bfloat16"],
                       "timing": timing[shape[0]]}
            for shape, name in zip(
                FIGURE_CONV_SHAPES + (FIGURE_BUDGET_SHAPE,),
                ("cf_grid", "heatmap_panels", "patch_budget_curve"))}


def house_data_phase(card: str) -> tuple:
    """The house table through `load_kc_house` (the synthetic one where no
    CSV is found), its split sizes, class counts and quartile edges; one
    line.  Returns what `load_kc_house` returns."""
    import numpy as np

    from cfgan_torch.data import kc_house

    source = "csv" if kc_house.resolve_csv(None) else "synthetic"
    t0 = time.perf_counter()
    data = kc_house.load_kc_house()
    load_s = time.perf_counter() - t0
    (xtr, ytr), (xte, yte), stats, bins, schema = data
    sizes = {"train": len(ytr), "test": len(yte)}
    counts = {name: np.bincount(y, minlength=4).tolist()
              for name, y in (("train", ytr), ("test", yte))}
    ok = (xtr.shape[1] == xte.shape[1] == HOUSE_FEATURES
          and all(min(c) > 0 for c in counts.values())
          and all(x.dtype == np.float32 and np.isfinite(x).all()
                  and x.min() > -1e-5 and x.max() < 1 + 1e-5
                  for x in (xtr, xte))
          and len(bins) == 5 and bool(np.all(np.diff(bins) > 0)))
    if source == "synthetic":
        ok = ok and sizes == {"train": 17290, "test": 4323}
    emit({"phase": "house data", "card": card, "source": source,
          "rows": sizes["train"] + sizes["test"], "sizes": sizes,
          "per_class": counts, "qcut_edges": [float(b) for b in bins],
          "load_s": load_s, "ok": ok})
    if not ok:
        fail(f"the house table came out wrong: {sizes}, {counts}")
    return data


def _power_iteration(w, u, eps: float = 1e-12):
    """One plain power iteration of a (out, in) weight from u."""
    v = u @ w
    v = v / (v.norm() + eps)
    u = w @ v
    return u / (u.norm() + eps)


def _house_bundle(dev, data):
    """The shipped house preset at full width on the card, initial weights
    from SEED, on a random frozen classifier."""
    import torch

    from cfgan_torch.core.config import HOUSE_COUNTERGAN
    from cfgan_torch.models.classifiers import TabularClassifier
    from cfgan_torch.train.builders import build_tabular_countergan

    _, _, stats, _, schema = data
    clf = TabularClassifier(generator=torch.Generator().manual_seed(SEED))
    return build_tabular_countergan(HOUSE_COUNTERGAN, clf.state_dict(),
                                    schema, stats, seed=SEED, device=dev)


def mlp_train_phase(card: str, dev, family: str, data, counts, zero_counts,
                    plain_epilogue) -> tuple:
    """MLP_FAMILIES[family]["steps"] eager steps of the family's preset:
    the epilogue kernels' launches and variant, the losses against the
    plain epilogue's, and each critic layer's `u` against one plain power
    iteration a step; one line.  Returns the wrappers' counts of the
    kernels' run."""
    import torch

    from cfgan_torch.ops import epilogue as tep

    f = MLP_FAMILIES[family]
    (xtr, ytr) = data[0]
    steps, batch = f["steps"], f["batch"]
    xs = torch.as_tensor(xtr[:steps * batch]).to(dev).reshape(steps, batch,
                                                              -1)
    ys = torch.as_tensor(ytr[:steps * batch]).to(dev, torch.long).reshape(
        steps, -1)

    def train():
        bundle = f["bundle"](dev, data)
        draws = torch.Generator(device=dev).manual_seed(SEED)
        layers = list(bundle.state.d.model.children())
        losses, u_err = [], 0.0
        for i in range(steps):
            before = [(m.weight.detach().clone(), m.u.clone())
                      for m in layers]
            m = bundle.step_fn(bundle.state, xs[i], ys[i], draws)
            losses.append((m["d_loss"], m["g_loss"]))
            u_err = max([u_err] + [
                (layer.u - _power_iteration(w, u)).abs().max().item()
                for layer, (w, u) in zip(layers, before)])
        torch.cuda.synchronize()
        return bundle, [(d.item(), g.item()) for d, g in losses], u_err

    zero_counts()
    bundle, losses, u_err = train()
    launched = counts()
    variant = {k: "16-byte" if fn.last_float4 else "4-byte"
               for k, fn in (("fwd", tep.cf_epilogue_fwd),
                             ("bwd", tep.cf_epilogue_bwd))}
    if launched != (steps, steps, 0, 0):
        fail(f"{family} training launched (fwd, bwd, conv, dK) = "
             f"{launched}, not {(steps, steps, 0, 0)}")
    if set(variant.values()) != {"4-byte"}:
        fail(f"{family} training launched the epilogue variants {variant}")
    with plain_epilogue():
        plain_bundle, plain_losses, _ = train()
    if counts() != launched:
        fail(f"the plain-epilogue {family} run launched a kernel")
    errs = [max(abs(a - b) for a, b in zip(k, p))
            for k, p in zip(losses, plain_losses)]
    finite = all(math.isfinite(v) for pair in losses + plain_losses
                 for v in pair) and all(
        bool(torch.isfinite(p).all()) for b in (bundle, plain_bundle)
        for net in (b.state.g, b.state.d) for p in net.model.parameters())
    ok = max(errs) <= TRAIN_ATOL["float32"] and u_err <= 1e-6 and finite
    emit({"phase": f"{family} train", "card": card,
          "preset": f"{family}_countergan", "dtype": "float32",
          "batch": batch, "features": f["features"],
          "clamp": list(bundle.cfg.clamp_cf or (-1e30, 1e30)),
          "steps": steps, "epilogue_fwd_launches": launched[0],
          "epilogue_bwd_launches": launched[1], "variant": variant,
          "d_g_loss_per_step": losses,
          "plain_epilogue_d_g_loss_per_step": plain_losses,
          "loss_max_abs_err_per_step": errs,
          "u_max_abs_err_vs_one_power_iteration_a_step": u_err,
          "tolerance": f"loss abs <= {TRAIN_ATOL['float32']}; u abs <= 1e-6",
          "ok": ok})
    if not ok:
        fail(f"{family} training with the epilogue kernels differs from the "
             f"plain epilogue, or u did not advance once a step: {errs}, "
             f"{u_err}")
    return launched


def mlp_runner_phase(card: str, dev, family: str, data, counts,
                     zero_counts) -> None:
    """One epoch of the family's step through the epoch runner against the
    same steps eager (bit for bit), its launches per replayed step by the
    profiler, and replayed and eager steps timed in turns; one line."""
    import torch

    from cfgan_torch.data.pipeline import epoch_perm
    from cfgan_torch.train.loop import WARMUP_STEPS, make_epoch_runner

    laps = Laps()
    f = MLP_FAMILIES[family]
    (xtr, ytr) = data[0]
    x = torch.as_tensor(xtr).to(dev)
    y = torch.as_tensor(ytr).to(dev, torch.long)
    ours, ref = f["bundle"](dev, data), f["bundle"](dev, data)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    perm = epoch_perm(gen, len(y), f["batch"])
    steps = perm.shape[0]
    draws = ours.draw_fn(gen, tuple(perm.shape))
    runner = make_epoch_runner(ours.step_from_draws, reduce=False)
    zero_counts()
    got = runner(ours.state, x, y, perm, draws)
    torch.cuda.synchronize()
    wrapper = counts()
    if (runner.captures, runner.replays) != (1, steps - WARMUP_STEPS):
        fail(f"{family} runner: {runner.captures} captures and "
             f"{runner.replays} replays, not 1 and {steps - WARMUP_STEPS}")

    def eager_step(i):
        return ref.step_from_draws(ref.state, x[perm[i]], y[perm[i]],
                                   {k: v[i] for k, v in draws.items()})

    eager = [{k: v.item() for k, v in eager_step(i).items()}
             for i in range(steps)]
    mismatched = sorted({k for i, m in enumerate(eager) for k, v in m.items()
                         if got[k][i] != v})
    same_state = _states_equal(ours.state, ref.state)
    finite = all(math.isfinite(v) for m in eager for v in m.values())
    report = {"phase": f"{family} epoch runner", "card": card,
              "preset": f"{family}_countergan", "dtype": "float32",
              "batch": f["batch"], "steps": steps,
              "eager_steps": WARMUP_STEPS,
              "replayed_steps": steps - WARMUP_STEPS,
              "dataset_on_device": list(x.shape),
              "wrapper_counts_fwd_bwd_conv_dk": wrapper,
              "metrics_differing_from_eager": mismatched,
              "state_equal_to_eager": same_state,
              "tolerance": "bit for bit: every metric of every step, and "
                           "the state (u, BatchNorm statistics, the EMA "
                           "and Adam included)"}
    if mismatched or not same_state or not finite:
        emit({**report, "ok": False})
        fail(f"{family} replayed steps differ from eager steps: "
             f"{mismatched}, state equal {same_state}")

    laps("compare_s")

    def epochs(n=f["timed_epochs"]):
        for _ in range(n):
            runner(ours.state, x, y, perm, draws)

    def eager_steps(n):
        for i in range(n):
            eager_step(i)
        torch.cuda.synchronize()

    # eager steps are timed over the first `profiled` of the epoch's
    profiled = min(MLP_PROFILE_STEPS, steps)
    times = {"replayed": [], "eager": []}
    for _ in range(3):  # in turns
        for name, fn, n in (("replayed", epochs, f["timed_epochs"] * steps),
                            ("eager", lambda: eager_steps(profiled),
                             profiled)):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3 / n)
    med = {k: statistics.median(v) for k, v in times.items()}
    laps("turns_s")
    eager_busy = device_time(lambda: eager_steps(EAGER_PROFILE_STEPS), 1)[0]
    eager_busy_ms = (None if eager_busy is None
                     else eager_busy / EAGER_PROFILE_STEPS)
    laps("eager_trace_s")

    # the launches and device time of replayed steps, from traces of an
    # epoch of the first `profiled` steps (captured, then replayed whole):
    # a whole replayed house epoch holds ~10^5 kernel records
    short = (perm[:profiled], {k: v[:profiled] for k, v in draws.items()})
    runner(ours.state, x, y, *short)
    attempts = []
    for _ in range(PROFILE_TRIES):
        busy, top, ours_ms = device_time(
            lambda: runner(ours.state, x, y, *short), 1, top=8,
            match=tuple(MLP_REPLAY_LAUNCHES))
        per_step = {k: (ms / profiled, n / profiled)
                    for k, (ms, n) in ours_ms.items()}
        attempts.append({k: v[1] for k, v in per_step.items()})
        exact = busy is not None and all(
            v[1] == MLP_REPLAY_LAUNCHES[k] for k, v in per_step.items())
        if exact:
            break
    report["profiler_launch_counts_per_trace"] = attempts
    if not exact:
        fail(f"{family} launches per replayed step {attempts}, not "
             f"{MLP_REPLAY_LAUNCHES}")
    laps("replay_traces_s")
    report.update({
        "part_seconds": laps.s,
        "launches_per_replayed_step": {k: v[1] for k, v in per_step.items()},
        "our_kernels_ms_per_replayed_step": {k: v[0]
                                             for k, v in per_step.items()},
        "sync_debug_mode_during_replays": "error",
        "replayed_epochs_per_turn": f["timed_epochs"],
        "replayed_ms_per_step_in_turns": times["replayed"],
        "eager_ms_per_step_in_turns": times["eager"],
        "replayed_median_ms": med["replayed"],
        "eager_median_ms": med["eager"],
        "replay_speedup": med["eager"] / med["replayed"],
        "replayed_rows_per_s": f["batch"] / med["replayed"] * 1e3,
        "eager_rows_per_s": f["batch"] / med["eager"] * 1e3,
        "replayed_device_busy_ms": busy / profiled,
        "replayed_device_idle_share": 1 - busy / profiled / med["replayed"],
        "eager_device_busy_ms": eager_busy_ms,
        "eager_device_idle_share": (None if eager_busy_ms is None
                                    else 1 - eager_busy_ms / med["eager"]),
        "eager_timed_steps_per_turn": profiled,
        "eager_busy_profiled_steps": EAGER_PROFILE_STEPS,
        "replayed_steps_profiled": profiled,
        "device_time_by_kernel_ms_per_profiled_steps": top, "ok": True})
    emit(report)


def house_experiment_phase(card: str, dev, out_dir: Path) -> None:
    """`run()` of the port's house experiment at full width into
    `out_dir`, then again on it; one line."""
    import csv

    import numpy as np

    from cfgan_torch.core.provenance import check_run_provenance
    from cfgan_torch.experiments import house_countergan as exp
    from cfgan_torch.experiments.presets import HOUSE_COUNTERGAN as PRESET

    cfg = PRESET.replace(
        classifier=replace(PRESET.classifier, epochs=HOUSE_CLF_EPOCHS),
        countergan=replace(PRESET.countergan, epochs=HOUSE_EPOCHS,
                           snapshot_every=HOUSE_EVERY))
    shutil.rmtree(out_dir, ignore_errors=True)
    logs, runs, csvs = [[], []], [], {}
    names = ("countergan_metrics.csv",
             "countergan_metrics_reference_protocol.csv")
    for i in range(2):
        t0 = time.perf_counter()
        runs.append(exp.run(cfg, out_dir=str(out_dir), device=dev,
                            log=logs[i].append))
        runs[-1]["wall_s"] = time.perf_counter() - t0
        if i == 0:
            csvs = {name: (out_dir / name).read_text() for name in HOUSE_CSVS}
    missing = [f for f in HOUSE_FILES if not (out_dir / f).is_file()]
    missing += [f"unexpected {f}" for f in sorted(
        figure_set(out_dir) - set(HOUSE_FIGURES))]
    provenance = check_run_provenance(str(out_dir))
    flips = {}
    for name in names:
        with open(out_dir / name) as f:
            flips[name] = [float(r["class_flip_rate"])
                           for r in csv.DictReader(f)]
    ladder = runs[0]["serving_selection"]["ladder"]
    rungs = {(r["epoch"], r["candidate"]) for r in ladder}
    want_rungs = {(e, c) for e in range(HOUSE_EVERY, HOUSE_EPOCHS + 1,
                                        HOUSE_EVERY)
                  for c in ("live", "ema_recal_train", "ema_recal_ones")}
    runner = runs[0]["bundle"].epoch_fn
    trained_again = any("[CounteRGAN] epoch" in ln or "[Classifier]" in ln
                        for ln in logs[1])
    ok = (not missing and all(len(v) == 4 and np.isfinite(v).all()
                              for v in flips.values())
          and rungs == want_rungs and runner.captures == 1
          and not trained_again and runs[1]["history"] == {}
          and all((out_dir / n).read_text() == t for n, t in csvs.items()))
    emit({"phase": "house experiment", "card": card, "preset": cfg.name,
          "cuts": {"classifier_epochs": [HOUSE_CLF_EPOCHS,
                                         PRESET.classifier.epochs],
                   "gan_epochs": [HOUSE_EPOCHS, PRESET.countergan.epochs],
                   "snapshot_every": [HOUSE_EVERY,
                                      PRESET.countergan.snapshot_every]},
          "steps": runs[0]["bundle"].state.step,
          "runner_captures": runner.captures,
          "runner_replays": runner.replays,
          "stage_seconds": runs[0]["stage_seconds"],
          "run_wall_s": runs[0]["wall_s"],
          "rerun_stage_seconds": runs[1]["stage_seconds"],
          "rerun_wall_s": runs[1]["wall_s"],
          "classifier_test_accuracy": runs[0]["classifier"]["accuracy"],
          "serving_candidate": runs[0]["serving_selection"]["candidate"],
          "ladder": [(r["epoch"], r["candidate"], r["score"])
                     for r in ladder],
          "per_target_flip": flips[names[0]],
          "per_target_flip_reference_protocol": flips[names[1]],
          "feature_shift_top3": [r["feature"] for r in _csv_rows(
              out_dir / "feature_shift_importance.csv")[:3]],
          "case_studies": _csv_rows(
              out_dir / "case_studies/case_study_aggregate_summary.csv")[0],
          "mask_policies": len(_csv_rows(
              out_dir / "mask_policy_analysis.csv")) // 4,
          "provenance": provenance,
          "missing": missing, "rerun_trained": trained_again, "ok": ok})
    if not ok:
        fail("the house experiment's run dir or its rerun came out wrong")


def house_serve_phase(card: str, dev, data, fallback_dir: Path) -> None:
    """`house_engine` on the committed house run dir (or `fallback_dir`
    where this checkout lacks it) on the card: requests at b=1 and b=128
    and the bulk path on the test rows, padded against unpadded, the card
    against the CPU; one line."""
    import numpy as np

    from cfgan_torch.convert import flax_from_state_dict, state_dict_from_flax
    from cfgan_torch.core import checkpoint as ckpt
    from cfgan_torch.core.config import HOUSE_COUNTERGAN
    from cfgan_torch.models.classifiers import TabularClassifier
    from cfgan_torch.train.builders import build_tabular_countergan, house_engine
    from cfgan_torch.train.classifier import make_eval_fn

    _, (xte, _), stats, _, schema = data
    committed = all(ckpt.exists(str(HOUSE_RUN_DIR / part))
                    for part in ("classifier", "generator"))
    run_dir = HOUSE_RUN_DIR if committed else fallback_dir

    def engine(device, pad=True):
        clf = TabularClassifier()
        clf.load_state_dict(state_dict_from_flax(clf, ckpt.restore(
            str(run_dir / "classifier"),
            flax_from_state_dict(clf, clf.state_dict()))))
        clf.to(device).eval()
        bundle = build_tabular_countergan(HOUSE_COUNTERGAN, clf.state_dict(),
                                          schema, stats, device=device)
        g = bundle.state.g.model
        gv = state_dict_from_flax(g, ckpt.restore(
            str(run_dir / "generator"), flax_from_state_dict(
                g, g.state_dict())))
        e = house_engine(bundle, make_eval_fn(clf)[0],
                         g_variables={k: v.to(device) for k, v in gv.items()},
                         device=device)
        e.pad_to_bucket = pad
        return e

    card_e, exact_e, cpu_e = engine(dev), engine(dev, False), engine("cpu")
    key = (0, 42)
    x1, x77, x128 = xte[0], xte[:77], xte[:128]
    t128 = np.arange(128) % 4
    t_bulk = np.arange(len(xte)) % 4
    b1 = card_e.generate(x1, 2, key=key)
    b128 = card_e.generate(x128, t128, key=key)
    padded = card_e.generate(x77, 3, key=key)
    unpadded = exact_e.generate(x77, 3, key=key)
    bulk = card_e.generate_bulk(xte, t_bulk, key=key)
    cpu = cpu_e.generate(x128, t128, key=key)
    agree = cpu.pred == b128.pred
    pad_err = float(np.abs(padded.x_cf - unpadded.x_cf).max())
    cpu_err = float(np.abs(cpu.x_cf - b128.x_cf)[agree].max(initial=0.0))
    imm = list(schema.immutable_idx)
    ok = (b1.x_cf.shape == (1, HOUSE_FEATURES)
          and b128.x_cf.shape == (128, HOUSE_FEATURES)
          and bulk.x_cf.shape == xte.shape
          and all(np.isfinite(r.x_cf).all() and np.isfinite(r.probs).all()
                  for r in (b1, b128, bulk, padded))
          and all(r.x_cf.min() >= 0.0 and r.x_cf.max() <= 1.0
                  for r in (b1, b128, bulk))
          and np.array_equal(bulk.x_cf[:, imm], xte[:, imm])
          and pad_err <= 1e-5 and np.array_equal(padded.pred, unpadded.pred)
          and agree.mean() >= HOUSE_PRED_AGREE)
    report = {"phase": "house serve", "card": card,
              "run_dir": str(run_dir.relative_to(HERE)),
              "committed_run_dir": committed, "dtype": "float32",
              "flip_rate": {"b1": float(b1.flipped.mean()),
                            "b128": float(b128.flipped.mean()),
                            "bulk": float(bulk.flipped.mean())},
              "bulk_rows": len(xte),
              "padded_vs_unpadded_x_cf_max_abs_err": pad_err,
              "card_vs_cpu_pred_agreement": float(agree.mean()),
              "card_vs_cpu_x_cf_max_abs_err_where_preds_agree": cpu_err,
              "tolerance": f"padded vs unpadded x_cf abs <= 1e-5 and equal "
                           f"predictions; card vs CPU predictions agree on "
                           f">= {HOUSE_PRED_AGREE}; immutable features "
                           f"unchanged; x_cf in [0, 1]"}
    if not ok:
        emit({**report, "ok": False})
        fail("house serving came out wrong")
    for b, x, t in ((1, x1, 2), (128, x128, t128)):
        lat = host_ms(lambda: card_e.generate(x, t, key=key), 30)
        busy_ms, top, _ = device_time(
            lambda: card_e.generate(x, t, key=key), 5)
        median = statistics.median(lat)
        report[f"generate_b{b}"] = {
            "median_ms": median, "p90_ms": sorted(lat)[int(0.9 * len(lat))],
            "min_ms": min(lat), "device_busy_ms": busy_ms,
            "device_idle_share": (None if busy_ms is None
                                  else 1 - busy_ms / median),
            "device_time_by_kernel_ms": top}
    bulk_lat = host_ms(lambda: card_e.generate_bulk(xte, t_bulk, key=key),
                       5, warmup=1)
    report["generate_bulk"] = {
        "rows": len(xte), "chunk": 128,
        "median_ms": statistics.median(bulk_lat),
        "counterfactuals_per_s": len(xte) / statistics.median(bulk_lat)
        * 1e3}
    report["ok"] = True
    emit(report)


def moons_data_phase(card: str) -> tuple:
    """The three-class moons through `load_moons3`: split sizes and class
    counts; one line.  Returns what `load_moons3` returns."""
    import numpy as np

    from cfgan_torch.data.moons import load_moons3

    t0 = time.perf_counter()
    data = load_moons3()
    load_s = time.perf_counter() - t0
    (xtr, ytr), (xte, yte), _ = data
    sizes = {"train": len(ytr), "test": len(yte)}
    counts = {name: np.bincount(y, minlength=3).tolist()
              for name, y in (("train", ytr), ("test", yte))}
    ok = (sizes == MOONS_SIZES and xtr.shape[1] == xte.shape[1] == 2
          and [a + b for a, b in zip(counts["train"], counts["test"])]
          == [400, 400, 400]
          and all(x.dtype == np.float32 and np.isfinite(x).all()
                  and x.min() > -1e-5 and x.max() < 1 + 1e-5
                  for x in (xtr, xte)))
    emit({"phase": "moons data", "card": card, "sizes": sizes,
          "per_class": counts, "load_s": load_s, "ok": ok})
    if not ok:
        fail(f"the moons data came out wrong: {sizes}, {counts}")
    return data


def _moons_bundle(dev, data=None):
    """The shipped moons preset at full width on the card, initial weights
    from SEED, on a random frozen classifier (`data` is not needed: the
    signature is the house bundle's)."""
    import torch

    from cfgan_torch.core.config import MOONS_COUNTERGAN
    from cfgan_torch.models.classifiers import MLPClassifier
    from cfgan_torch.train.builders import build_moons_countergan

    clf = MLPClassifier(generator=torch.Generator().manual_seed(SEED))
    return build_moons_countergan(MOONS_COUNTERGAN, clf.state_dict(),
                                  seed=SEED, device=dev)


# what `mlp_train_phase` and `mlp_runner_phase` take of each family: its
# bundle, batch, features, eager steps, and the replayed epochs timed a
# turn (the moons epoch is 15 steps)
MLP_FAMILIES = {
    "house": {"bundle": _house_bundle, "batch": TRAIN_BATCH,
              "features": HOUSE_FEATURES, "steps": HOUSE_STEPS,
              "timed_epochs": 1},
    "moons": {"bundle": _moons_bundle, "batch": MOONS_BATCH, "features": 2,
              "steps": MOONS_STEPS, "timed_epochs": MOONS_TIMED_EPOCHS}}


def figure_set(run_dir: Path) -> set[str]:
    """The PNG and GIF files under `run_dir`, relative, '/'-joined."""
    return {p.relative_to(run_dir).as_posix() for p in run_dir.rglob("*")
            if p.suffix in (".png", ".gif")}


def _csv_rows(path: Path) -> list[dict]:
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


def _csv_gap(got: Path, want: Path) -> float | None:
    """The largest difference between the numbers of two CSVs of the same
    layout (None where `want` is missing or the layouts differ)."""
    if not want.is_file():
        return None
    a, b = _csv_rows(got), _csv_rows(want)
    if len(a) != len(b) or any(r.keys() != s.keys() for r, s in zip(a, b)):
        return None
    gap = 0.0
    for r, s in zip(a, b):
        for k in r:
            try:
                gap = max(gap, abs(float(r[k] or "nan")
                                   - float(s[k] or "nan")))
            except ValueError:
                if r[k] != s[k]:
                    return None
    return gap


def moons_experiment_phase(card: str, dev) -> None:
    """`run()` of the port's moons experiment with the full shipped preset
    into build/, then again on it; then `run()` on a copy of the committed
    run dir, on the card and on the CPU; one line."""
    import numpy as np

    from cfgan_torch.core.provenance import (
        check_run_provenance,
        serving_candidate_of,
    )
    from cfgan_torch.experiments import moons_countergan as exp
    from cfgan_torch.experiments.presets import MOONS_COUNTERGAN as PRESET

    out_dir = HERE / "build" / "smoke_moons_experiment"
    copies = {d: HERE / "build" / f"smoke_moons_committed_{d}"
              for d in ("card", "cpu")}
    names = ("countergan_metrics.csv", "countergan_metrics_per_mask.csv")
    for d in (out_dir, *copies.values()):
        shutil.rmtree(d, ignore_errors=True)
    try:
        logs, runs, csvs = [[], []], [], {}
        for i in range(2):
            t0 = time.perf_counter()
            runs.append(exp.run(PRESET, out_dir=str(out_dir), device=dev,
                                log=logs[i].append))
            runs[-1]["wall_s"] = time.perf_counter() - t0
            if i == 0:
                csvs = {n: (out_dir / n).read_text() for n in names}
        missing = [f for f in MOONS_FILES if not (out_dir / f).is_file()]
        missing += [f"unexpected {f}" for f in sorted(
            figure_set(out_dir) - set(MOONS_FIGURES))]
        flips = [float(r["class_flip_rate"])
                 for r in _csv_rows(out_dir / names[0])]
        ladder = runs[0]["serving_selection"]["ladder"]
        rungs = [(r["epoch"], r["candidate"]) for r in ladder]
        want_rungs = [(e, "live") for e in range(
            PRESET.countergan.snapshot_every, PRESET.countergan.epochs + 1,
            PRESET.countergan.snapshot_every)]
        runner = runs[0]["bundle"].epoch_fn
        trained_again = any("[CounteRGAN] epoch" in ln or "[Classifier]" in ln
                            for ln in logs[1])
        provenance = check_run_provenance(str(out_dir))
        committed = {"per_target_flip": None, "provenance": None}
        if (MOONS_RUN_DIR / names[0]).is_file():
            committed["per_target_flip"] = [
                float(r["class_flip_rate"])
                for r in _csv_rows(MOONS_RUN_DIR / names[0])]
        if (MOONS_RUN_DIR / "run_provenance.json").is_file():
            committed["provenance"] = json.loads(
                (MOONS_RUN_DIR / "run_provenance.json").read_text())
        # the committed run dir's weights, evaluated on the card and on
        # the CPU
        loaded = {}
        for where, d in copies.items():
            for part in ("classifier", "generator"):
                shutil.copytree(MOONS_RUN_DIR / part, d / part)
            lines = []
            t0 = time.perf_counter()
            res = exp.run(PRESET, out_dir=str(d),
                          device=dev if where == "card" else "cpu",
                          log=lines.append)
            loaded[where] = {
                "wall_s": time.perf_counter() - t0,
                "trained": res["history"] != {} or any(
                    "[CounteRGAN]" in ln or "[Classifier]" in ln
                    for ln in lines),
                "candidate": check_run_provenance(str(d))[
                    "serving_candidate"]}
        card_vs_cpu = {n: _csv_gap(copies["card"] / n, copies["cpu"] / n)
                       for n in names}
        vs_committed = {n: _csv_gap(copies["card"] / n, MOONS_RUN_DIR / n)
                        for n in names}
        report = {
            "phase": "moons experiment", "card": card, "preset": PRESET.name,
            "classifier_steps": PRESET.classifier.steps,
            "epochs": PRESET.countergan.epochs,
            "snapshot_every": PRESET.countergan.snapshot_every,
            "steps": runs[0]["bundle"].state.step,
            "runner_captures": runner.captures,
            "runner_replays": runner.replays,
            "stage_seconds": runs[0]["stage_seconds"],
            "run_wall_s": runs[0]["wall_s"],
            "rerun_stage_seconds": runs[1]["stage_seconds"],
            "rerun_wall_s": runs[1]["wall_s"],
            "classifier_test_accuracy": runs[0]["classifier"]["accuracy"],
            "serving_candidate": provenance["serving_candidate"],
            "ladder": [(r["epoch"], r["candidate"], r["score"])
                       for r in ladder],
            "per_target_flip": flips,
            "committed_per_target_flip": committed["per_target_flip"],
            "committed_serving_candidate": (committed["provenance"] or {}).get(
                "serving_candidate"),
            "history_flip_rate_last": runs[0]["history"]["flip_rate"][-1],
            "missing": missing, "rerun_trained": trained_again,
            "committed_run_dir": loaded,
            "committed_card_vs_cpu_max_abs_gap": card_vs_cpu,
            "committed_card_vs_committed_csv_max_abs_gap": vs_committed,
            "tolerance": f"rerun CSVs byte for byte; committed weights on "
                         f"the card vs the CPU within {MOONS_CPU_ATOL}"}
        ok = (not missing and len(flips) == 3 and np.isfinite(flips).all()
              and rungs == want_rungs and runner.captures == 1
              and runs[0]["bundle"].state.step == PRESET.countergan.epochs
              * MOONS_SIZES["train"] // MOONS_BATCH
              and not trained_again and runs[1]["history"] == {}
              and all((out_dir / n).read_text() == t for n, t in csvs.items())
              and not any(v["trained"] for v in loaded.values())
              and all(v["candidate"] == serving_candidate_of(
                  str(MOONS_RUN_DIR)) for v in loaded.values())
              and all(g is not None and g <= MOONS_CPU_ATOL
                      for g in card_vs_cpu.values()))
        report["ok"] = bool(ok)
        emit(report)
        if not ok:
            fail("the moons experiment's run dir, its rerun or the "
                 "committed run dir's evaluation came out wrong")
    finally:
        for d in (out_dir, *copies.values()):
            shutil.rmtree(d, ignore_errors=True)


def _gan_data(preset: str, mnist, dev, rows: int = GAN_EPOCH_ROWS):
    """(x, y, num_classes) of a generation preset on the card: moons2's
    2,000 points, or the first `rows` of the data phase's MNIST training
    images (resized to 64x64 on the card for DCGAN)."""
    import torch

    from cfgan_torch.data.moons import load_moons2
    from cfgan_torch.experiments.generation import resize_images
    from cfgan_torch.experiments.presets import PRESETS

    cfg = PRESETS[preset]
    if cfg.data.name == "moons2":
        x, y = load_moons2(seed=cfg.data.seed)
        nc = 2
    else:
        x, y = mnist[0][:rows], mnist[1][:rows]
        nc = 10
    x = torch.as_tensor(x).to(dev)
    if cfg.data.resize_to:
        x = resize_images(x, cfg.data.resize_to)
    return x, torch.as_tensor(y).to(dev, torch.long), nc


def _gan_bundle(preset: str, nc: int, dev):
    """The preset's family at its shipped widths on the card, initial
    weights from SEED."""
    from cfgan_torch.experiments.presets import PRESETS
    from cfgan_torch.train.gan_builders import build_gan

    return build_gan(PRESETS[preset].gan, num_classes=nc, seed=SEED,
                     device=dev)


def _n_params(model) -> int:
    return sum(p.numel() for p in model.parameters())


def gan_train_phase(card: str, dev, mnist, counts, zero_counts) -> None:
    """For each generation preset at its shipped widths: GAN_EAGER_STEPS
    eager steps (finite losses; both networks' parameters moved; WGAN-GP:
    G's parameters and AdamW count move on the steps whose global index
    is a multiple of 5 only, and G's BatchNorms run two train-mode
    forwards on those steps, one on the others), then one epoch through
    the epoch runner against the same steps eager, bit for bit (metrics,
    parameters, BatchNorm statistics, Adam/AdamW); none of the port's
    kernels launches; one line a preset."""
    import torch

    from cfgan_torch.experiments.generation import GENERATION_PRESETS
    from cfgan_torch.experiments.presets import PRESETS
    from cfgan_torch.nn.layers import BatchNorm
    from cfgan_torch.train.loop import WARMUP_STEPS, make_epoch_runner

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    for preset in GENERATION_PRESETS:
        cfg = PRESETS[preset]
        batch = cfg.data.batch_size
        x, y, nc = _gan_data(preset, mnist, dev)
        zero_counts()
        bundle = _gan_bundle(preset, nc, dev)
        state = bundle.state
        start = {net: [p.detach().clone() for p in
                       getattr(state, net).model.parameters()]
                 for net in ("g", "d")}
        bn_calls = []
        for m in bundle.g_model.modules():
            if isinstance(m, BatchNorm):
                m.register_forward_hook(
                    lambda mod, args, out: bn_calls.append(1))
        n_bn = len([m for m in bundle.g_model.modules()
                    if isinstance(m, BatchNorm)])
        draws = torch.Generator(device=dev).manual_seed(SEED)
        losses, schedule = [], []
        for i in range(GAN_EAGER_STEPS):
            g_before = [p.detach().clone()
                        for p in bundle.g_model.parameters()]
            calls = len(bn_calls)
            j = (i * batch) % (len(y) - batch)
            m = bundle.step_fn(state, x[j:j + batch], y[j:j + batch], draws)
            losses.append(m)
            g_moved = any(not torch.equal(p, q) for p, q in
                          zip(bundle.g_model.parameters(), g_before))
            g_count = {int(state.g.opt.state[p]["step"])
                       for p in bundle.g_model.parameters()
                       if "step" in state.g.opt.state[p]}
            schedule.append({"step": i, "g_moved": g_moved,
                             "g_adam_steps": sorted(g_count),
                             "g_bn_forwards": ((len(bn_calls) - calls)
                                               // max(n_bn, 1))})
        torch.cuda.synchronize()
        losses = [{k: v.item() for k, v in m.items()} for m in losses]
        # the share of each network's parameter tensors that moved
        moved = {net: sum(not torch.equal(p, q) for p, q in zip(
            getattr(state, net).model.parameters(), start[net]))
            / len(start[net]) for net in ("g", "d")}
        finite = all(math.isfinite(v) for m in losses for v in m.values())
        if cfg.gan.n_critic > 1:
            want_sched = [{"step": i, "g_moved": i % 5 == 0,
                           "g_adam_steps": [i // 5 + 1],
                           "g_bn_forwards": 2 if i % 5 == 0 else 1}
                          for i in range(GAN_EAGER_STEPS)]
        else:
            want_sched = [{"step": i, "g_moved": True,
                           "g_adam_steps": [i + 1],
                           "g_bn_forwards": 1 if n_bn else 0}
                          for i in range(GAN_EAGER_STEPS)]
        eager_launches = counts()

        # one epoch replayed against the same steps eager
        ours, ref = _gan_bundle(preset, nc, dev), _gan_bundle(preset, nc,
                                                             dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        perm = torch.randperm(len(y), device=dev, generator=gen)
        steps = len(y) // batch
        perm = perm[:steps * batch].reshape(steps, batch)
        epoch_draws = ours.draw_fn(gen, tuple(perm.shape))
        runner = make_epoch_runner(ours.step_from_draws, reduce=False,
                                   schedule=ours.schedule)
        zero_counts()
        got = runner(ours.state, x, y, perm, epoch_draws)
        torch.cuda.synchronize()
        replay_launches = counts()
        eager = [{k: v.item() for k, v in ref.step_from_draws(
            ref.state, x[perm[i]], y[perm[i]],
            {k: v[i] for k, v in epoch_draws.items()}).items()}
            for i in range(steps)]
        mismatched = sorted({k for i, m in enumerate(eager)
                             for k, v in m.items() if got[k][i] != v})
        same_state = _states_equal(ours.state, ref.state)
        kinds = 2 if ours.schedule is not None else 1
        report = {
            "phase": "gan train", "card": card, "preset": preset,
            "family": cfg.gan.family, "batch": batch,
            "hidden_dim": cfg.gan.hidden_dim,
            "latent_dim": cfg.gan.latent_dim, "n_critic": cfg.gan.n_critic,
            "params_g_d": [_n_params(bundle.g_model),
                           _n_params(bundle.d_model)],
            "input": list(x.shape[1:]), "eager_steps": GAN_EAGER_STEPS,
            "metrics_per_eager_step": losses,
            "share_of_param_tensors_moved": moved,
            "generator_schedule": schedule,
            "epoch_rows": len(y), "epoch_steps": steps,
            "runner_captures": runner.captures,
            "runner_replays": runner.replays,
            "metrics_differing_from_eager": mismatched,
            "state_equal_to_eager": same_state,
            "our_kernel_launches_eager_and_replayed": [eager_launches,
                                                       replay_launches],
            "tolerance": "replay bit for bit: every metric of every step "
                         "and the state (BatchNorm statistics and Adam "
                         "included)"}
        ok = (finite and all(moved.values()) and schedule == want_sched
              and not mismatched and same_state
              and (runner.captures, runner.replays)
              == (kinds, steps - WARMUP_STEPS)
              and eager_launches == replay_launches == (0, 0, 0, 0))
        report["ok"] = bool(ok)
        emit(report)
        if not ok:
            fail(f"{preset}: the eager steps, the generator's schedule or "
                 f"the replayed epoch came out wrong")
        del bundle, ours, ref, runner, x, y
    torch.backends.cudnn.deterministic = False


def _trace_launches(fn, steps: int):
    """Up to PROFILE_TRIES profiler traces of `fn` (`steps` replayed
    steps): each trace's (busy ms, top entries, device records a step),
    for the traces that hold device time.  The records count every
    kernel, copy and fill, the epoch's few copies into the runner's
    buffers included.  A trace drops records now and then (one of a
    10-step DCGAN epoch read 10,624 against 10,745; of a 50-step WGAN-GP
    epoch 45,043 against 45,102), so the count is the largest of the
    traces', and the tracing stops once two traces agree on it."""
    traces = []
    for _ in range(PROFILE_TRIES):
        busy, top, every = device_time(fn, 1, top=8, match=("",))
        if busy is not None:
            traces.append((busy / steps, top, every[""][1] / steps))
        if len({t[2] for t in traces}) < len(traces):
            break
    return traces


def gan_runner_phase(card: str, dev, mnist) -> None:
    """For DCGAN and WGAN-GP at their shipped widths and batch 128: an
    epoch of GAN_TIMED_ROWS images replayed through the epoch runner
    against the same steps eager, in turns (three turns, medians); device
    busy ms and idle share, the longest device entries and the launches a
    replayed step from more than one profiler trace.  WGAN-GP also: its
    critic-only step, its critic + generator step and its five-step cycle
    apart (each a CUDA graph of those steps alone, replayed), and the
    gradient penalty's share of the critic-only step.  One line each."""
    import torch

    from cfgan_torch.losses.gan import gradient_penalty
    from cfgan_torch.nn.layers import one_hot

    for preset in GAN_TIMED:
        x, y, nc = _gan_data(preset, mnist, dev, rows=GAN_TIMED_ROWS)
        ours, ref = _gan_bundle(preset, nc, dev), _gan_bundle(preset, nc,
                                                             dev)
        cfg = ours.cfg
        batch = 128
        gen = torch.Generator(device=dev).manual_seed(SEED)
        steps = len(y) // batch
        perm = torch.randperm(len(y), device=dev, generator=gen)[
            :steps * batch].reshape(steps, batch)
        draws = ours.draw_fn(gen, tuple(perm.shape))
        runner = ours.epoch_fn

        def epoch():
            runner(ours.state, x, y, perm, draws)

        def eager_epoch(n=steps):
            for i in range(n):
                ref.step_from_draws(ref.state, x[perm[i]], y[perm[i]],
                                    {k: v[i] for k, v in draws.items()})
            torch.cuda.synchronize()

        epoch()  # warm-up and the captures
        eager_epoch(2)
        torch.cuda.synchronize()
        traces = _trace_launches(epoch, steps)
        eager_busy = device_time(lambda: eager_epoch(), 1)[0]
        times = {"replayed": [], "eager": []}
        for _ in range(3):  # in turns
            for name, fn in (("replayed", epoch), ("eager", eager_epoch)):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3 / steps)
        med = {k: statistics.median(v) for k, v in times.items()}
        # the busiest trace: a trace that drops records reads low
        best = max(traces, key=lambda t: t[2]) if traces else None
        busy = best[0] if best else None
        report = {
            "phase": "gan epoch runner", "card": card, "preset": preset,
            "family": cfg.family, "dtype": cfg.compute_dtype,
            "tf32": False, "batch": batch, "input": list(x.shape[1:]),
            "params_g_d": [_n_params(ours.g_model),
                           _n_params(ours.d_model)],
            "epoch_steps": steps, "runner_captures": runner.captures,
            "runner_replays": runner.replays,
            "replayed_ms_per_step_in_turns": times["replayed"],
            "eager_ms_per_step_in_turns": times["eager"],
            "replayed_median_ms": med["replayed"],
            "eager_median_ms": med["eager"],
            "replayed_images_per_s": batch / med["replayed"] * 1e3,
            "eager_images_per_s": batch / med["eager"] * 1e3,
            "replayed_device_busy_ms": busy,
            "replayed_device_idle_share": (None if busy is None
                                           else 1 - busy / med["replayed"]),
            "eager_device_busy_ms": (None if eager_busy is None
                                     else eager_busy / steps),
            "eager_device_idle_share": (
                None if eager_busy is None
                else 1 - eager_busy / steps / med["eager"]),
            "device_records_per_replayed_step_per_trace": [
                t[2] for t in traces],
            "device_records_per_replayed_step": best and best[2],
            "device_time_by_kernel_ms_per_epoch": best and best[1]}
        if cfg.n_critic > 1:
            # each kind of step alone, and the cycle, as graphs of their
            # own on one batch (state.step set to a step of the kind)
            xb, yb = x[perm[0]], y[perm[0]]
            one = {k: v[0] for k, v in draws.items()}

            def kind_step(step_index):
                def fn():
                    ours.state.step = step_index
                    ours.step_from_draws(ours.state, xb, yb, one)
                return fn

            def cycle():
                ours.state.step = 0
                for _ in range(cfg.n_critic):
                    ours.step_from_draws(ours.state, xb, yb, one)

            d_model = ours.d_model
            with torch.no_grad():
                fake = ours.g_model(one["z"], one_hot(yb, nc, torch.float32))
            cond = one_hot(yb, nc, torch.float32)

            def penalty():
                d_model.zero_grad(set_to_none=True)
                gradient_penalty(
                    lambda xh: d_model(xh, cond, update_stats=False), xb,
                    fake, one["gp_eps"]).backward()

            critic_ms = graph_ms(kind_step(1), iters=5, replays=3)
            g_step_ms = graph_ms(kind_step(0), iters=5, replays=3)
            cycle_ms = graph_ms(cycle, iters=2, replays=3)
            gp_ms = graph_ms(penalty, iters=5, replays=3)
            report.update({
                "critic_only_step_ms": critic_ms,
                "critic_and_generator_step_ms": g_step_ms,
                "five_step_cycle_ms": cycle_ms,
                "cycle_images_per_s": cfg.n_critic * batch / cycle_ms * 1e3,
                "gradient_penalty_ms": gp_ms,
                "gradient_penalty_share_of_critic_step": gp_ms / critic_ms,
                "kinds_timed_by": "CUDA events around replays of a graph of "
                                  "those steps alone, one batch"})
        ok = len(traces) >= 2 and all(math.isfinite(v) for v in med.values())
        report["ok"] = bool(ok)
        emit(report)
        if not ok:
            fail(f"{preset}: fewer than two profiler traces of the replayed "
                 f"epoch held device time, or a time is not finite")
        del ours, ref, runner, x, y


def generation_phase(card: str, dev) -> None:
    """`run()` of each generation preset through the entry point: the
    moons presets whole, the MNIST ones GENERATION_EPOCHS epochs on
    GENERATION_LIMIT images (the corpus the data phase cached); each run's
    `generator/` restored by the port gives its samples bit for bit; then
    the committed `results/simple_gan_moons/` and `results/cgan_moons/`
    generators sampled on the card and on the CPU.  One line."""
    import numpy as np
    import torch

    from cfgan_torch.experiments import generation as gen
    from cfgan_torch.experiments.presets import PRESETS
    from cfgan_torch.train.gan_builders import build_gan

    root = HERE / "build" / "smoke_generation"
    shutil.rmtree(root, ignore_errors=True)
    runs, ok = {}, True
    # run() trains under cuDNN's default algorithms, as a user runs it; its
    # sample_fn asks for the deterministic ones, so that a restored
    # generator samples what the run sampled, bit for bit
    if torch.backends.cudnn.deterministic or torch.backends.cudnn.benchmark:
        fail("the generation phase must start from cuDNN's defaults")
    try:
        for preset in gen.GENERATION_PRESETS:
            cut = PRESETS[preset].data.name == "mnist"
            lines = []
            t0 = time.perf_counter()
            res = gen.run(preset,
                          epochs=GENERATION_EPOCHS if cut else None,
                          limit=GENERATION_LIMIT if cut else None,
                          out_dir=str(root / preset), device=dev,
                          log=lines.append)
            wall = time.perf_counter() - t0
            bundle, hist = res["bundle"], res["history"]
            z, oh, _ = res["fixed_noise"]
            again = bundle.sample_fn(gen.load_generator(
                str(root / preset / "generator"), bundle), z, oh)
            restored = bool(np.array_equal(again.cpu().numpy(),
                                           res["samples"]))
            ok = ok and not (torch.backends.cudnn.deterministic
                             or torch.backends.cudnn.benchmark)
            figures = figure_set(root / preset)
            want_figures = set(GENERATION_FIGURES["image" if cut
                                                  else "points"])
            ok = ok and figures == want_figures
            runner = bundle.epoch_fn
            epochs = len(hist["d_loss"])
            finite = (all(np.isfinite(hist[k]).all() for k in hist)
                      and np.isfinite(res["samples"]).all())
            runs[preset] = {
                "epochs": epochs, "limit": GENERATION_LIMIT if cut else None,
                "steps": bundle.state.step, "wall_s": wall,
                "train_wall_s": hist["wall_time_s"],
                "steps_per_s": bundle.state.step / hist["wall_time_s"],
                "runner_captures": runner.captures,
                "runner_replays": runner.replays,
                "last_epoch": {k: hist[k][-1] for k in ("d_loss", "g_loss",
                                                       "d_real", "d_fake")},
                "samples_shape": list(res["samples"].shape),
                "frames": len(res["frames"]),
                "figures": sorted(figures),
                "figures_missing": sorted(want_figures - figures),
                "figures_unexpected": sorted(figures - want_figures),
                "restored_samples_equal": restored, "lines": len(lines)}
            ok = ok and finite and restored and epochs == (
                GENERATION_EPOCHS if cut else PRESETS[preset].gan.epochs)
        committed = {}
        for name in ("simple_gan_moons", "cgan_moons"):
            run_dir = HERE / "results" / name / "generator"
            samples = {}
            for where in ("card", "cpu"):
                d = dev if where == "card" else torch.device("cpu")
                b = build_gan(PRESETS[name].gan, num_classes=2, device=d)
                z, oh, _ = gen.fixed_noise(b, d)
                samples[where] = b.sample_fn(gen.load_generator(
                    str(run_dir), b), z, oh).cpu().numpy()
            gap = float(np.abs(samples["card"] - samples["cpu"]).max())
            scale = max(1.0, float(np.abs(samples["cpu"]).max()))
            committed[name] = {"card_vs_cpu_max_abs_gap": gap,
                               "scale": scale,
                               "samples": samples["card"].shape[0]}
            ok = ok and gap <= GENERATION_CPU_RTOL * scale
        emit({"phase": "generation", "card": card, "runs": runs,
              "cudnn_in_training": "default algorithms",
              "cudnn_in_sample_fn": "deterministic algorithms",
              "committed_generators": committed,
              "tolerance": f"restored samples bit for bit; committed "
                           f"generators card vs CPU within "
                           f"{GENERATION_CPU_RTOL} of the samples' scale",
              "ok": bool(ok)})
        if not ok:
            fail("a generation run, its restored generator or the committed "
                 "generators came out wrong")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _same_result(got, want) -> bool:
    """Every field of two `CFResult`s equal, bit for bit."""
    import numpy as np

    return all(np.array_equal(getattr(got, f), getattr(want, f))
               for f in ("x_cf", "residual", "pred", "confidence", "probs",
                         "probs_orig", "flipped"))


def _mnist_float32_engine(run_dir: str, dev):
    """The MNIST run dir's engine with its generator in float32 (cuDNN;
    TF32 is off): the reference the bf16 routes are held against."""
    from cfgan_torch.core.config import MNIST_COUNTERGAN
    from cfgan_torch.serve.engine import CounterfactualEngine
    from cfgan_torch.serve.launch import restore_state_dict
    from cfgan_torch.train.builders import build_mnist_serving, mnist_models

    cfg = replace(MNIST_COUNTERGAN, compute_dtype="float32")
    g_model, clf_model = mnist_models(cfg)
    s = build_mnist_serving(
        cfg, restore_state_dict(g_model, f"{run_dir}/generator"),
        restore_state_dict(clf_model, f"{run_dir}/classifier"), device=dev)
    return CounterfactualEngine(s.cf_fn, s.clf_fn, s.num_classes,
                                patch_size=cfg.mask.patch_size, device=dev)


def _start_launcher(app: str, run_dir: str, out_dir: Path):
    """`python -m cfgan_torch.serve.launch --app APP --api --port 0` on the
    card, its output in files under `out_dir`."""
    with open(out_dir / f"{app}.out", "w") as fo, \
            open(out_dir / f"{app}.err", "w") as fe:
        return subprocess.Popen(
            [sys.executable, "-m", "cfgan_torch.serve.launch", "--app", app,
             "--api", "--port", "0", "--results", run_dir], cwd=HERE,
            stdout=fo, stderr=fe)


def _launcher_address(app: str, proc, out_dir: Path, deadline: float) -> str:
    """The address a launcher printed; fails where it exits or is late."""
    while time.monotonic() < deadline:
        m = re.search(r"listening on (http://\S+)",
                      (out_dir / f"{app}.out").read_text())
        if m:
            return m.group(1)
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    err = (out_dir / f"{app}.err").read_text()[-3000:]
    fail(f"the {app} launcher printed no address (exit {proc.poll()}): "
         f"{err}")


def _stop_launchers(procs: dict, out_dir: Path, check: bool) -> dict:
    """SIGINT to each launcher still running; {app: exit code}.  With
    `check`, a launcher that had already died, or does not exit 0 on the
    signal, is a failure, after every launcher is stopped (without it the
    phase is failing already, and its own error stands)."""
    import signal

    alive = {app: p.poll() is None for app, p in procs.items()}
    for app, p in procs.items():
        if alive[app]:
            p.send_signal(signal.SIGINT)
    codes = {}
    for app, p in procs.items():
        try:
            codes[app] = p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            p.kill()
            codes[app] = p.wait()
    bad = {app: c for app, c in codes.items() if not alive[app] or c != 0}
    if bad and check:
        errs = {app: (out_dir / f"{app}.err").read_text()[-2000:]
                for app in bad}
        fail(f"launchers did not stop cleanly (exit codes {bad}; died "
             f"before the stop: {[a for a in bad if not alive[a]]}): {errs}")
    return codes


def api_phase(card: str, dev) -> None:
    """The serving front door on the card: (a) the three launchers
    (`python -m cfgan_torch.serve.launch --api`) against in-process
    engines of the same `setup_*`, bit for bit over both wire formats;
    (b) the MNIST weights behind `make_server` with `conv_impl="pallas"`:
    13 conv kernel launches a generator forward from serial requests, as
    close to the float32 result as the bf16 cuDNN route (API_KERNEL_SLACK;
    on trained weights the random-weight bars against cuDNN hold at b=1
    only); (c) 8 client threads x 25
    mixed requests against one server, each equal to its serial answer;
    (d) the wire's latency and bulk rate against the engine's, in turns.
    One line each."""
    import threading

    import numpy as np

    from cfgan_torch.models.tabular import jax_key
    from cfgan_torch.ops.conv import conv3x3_same
    from cfgan_torch.serve import CFClient
    from cfgan_torch.serve.api import make_server
    from cfgan_torch.serve.launch import setup_house, setup_mnist, setup_moons

    from cfgan_torch.core import checkpoint as ckpt

    runs = {app: str(HERE / run_dir) for app, run_dir in API_RUNS}
    missing = [f"{run}/{part}" for run in runs.values()
               for part in ("classifier", "generator")
               if not ckpt.exists(f"{run}/{part}")]
    if missing:
        fail(f"the api phase serves the committed run dirs; missing "
             f"{missing}")
    out_dir = HERE / "build" / "smoke_api"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    procs = {}
    servers = []
    done = False
    try:
        t0 = time.perf_counter()
        for app, run_dir in runs.items():
            procs[app] = _start_launcher(app, run_dir, out_dir)
        local = {"mnist": setup_mnist(runs["mnist"], dev),
                 "house": setup_house(runs["house"], dev),
                 "moons": setup_moons(runs["moons"], dev)}
        kernel_e = setup_mnist(runs["mnist"], dev, conv_impl="pallas")[0]
        f32_e = _mnist_float32_engine(runs["mnist"], dev)
        setup_s = time.perf_counter() - t0
        tests = {"mnist": local["mnist"][1:3], "house": local["house"][1:3],
                 "moons": local["moons"][2:4]}

        def serve_here(engine):
            server = make_server(engine, port=0)
            servers.append(server)
            threading.Thread(target=server.serve_forever,
                             daemon=True).start()
            return f"http://127.0.0.1:{server.server_address[1]}"

        # ---- (b) the conv kernel behind the wire, serial requests
        mnist_e = local["mnist"][0]
        xte, yte = tests["mnist"]
        x128, t128 = xte[:128], (yte[:128] + 1) % 10
        kbase = serve_here(kernel_e)
        kc, kj = CFClient(kbase), CFClient(kbase, wire="json")
        kernel_e.generate(x128, t128)  # warm: one forward, not counted
        patch_mask = mnist_e.mask_from_patches(API_PATCHES, len(x128),
                                               (28, 28))
        bulk_x, bulk_t = xte[:API_JSON_BULK], (yte[:API_JSON_BULK] + 3) % 10
        conv3x3_same.launches = 0
        served = {"b1": kc.counterfactual(xte[0], 3),
                  "b128": kc.counterfactual(x128, t128),
                  "b128_patches": kj.counterfactual(x128, t128,
                                                    patches=API_PATCHES),
                  "bulk": kc.counterfactual_bulk(bulk_x, bulk_t, chunk=128)}
        # each response follows its launches on the server's thread
        launched = conv3x3_same.launches
        forwards = 3 + -(-API_JSON_BULK // 128)  # 3 requests, 8 chunks
        requests = {
            "b1": lambda e: e.generate(xte[0], 3),
            "b128": lambda e: e.generate(x128, t128),
            "b128_patches": lambda e: e.generate(x128, t128,
                                                 mask=patch_mask),
            "bulk": lambda e: e.generate_bulk(bulk_x, bulk_t, chunk=128)}
        cudnn = {name: ask(mnist_e) for name, ask in requests.items()}
        ref = {name: ask(f32_e) for name, ask in requests.items()}

        def dist(a, b):
            d = np.abs(a - b)
            return float(d.max()), float(d.mean())

        errs, ok = {}, launched == KERNEL_LAYERS_PER_FORWARD * forwards
        for name, r in served.items():
            c, f = cudnn[name], ref[name]
            e = errs[name] = {
                "vs_cudnn_x_cf_max_mean": dist(r.x_cf, c.x_cf),
                "vs_cudnn_probs_max": dist(r.probs, c.probs)[0],
                "vs_cudnn_pred_agreement": float((r.pred == c.pred).mean()),
                "kernel_vs_f32_x_cf_max_mean": dist(r.x_cf, f.x_cf),
                "cudnn_vs_f32_x_cf_max_mean": dist(c.x_cf, f.x_cf),
                "kernel_vs_f32_probs_max": dist(r.probs, f.probs)[0],
                "cudnn_vs_f32_probs_max": dist(c.probs, f.probs)[0],
                "raw_max_abs": float(np.abs(r.residual).max())}
            e["random_weight_bars_hold"] = (
                e["vs_cudnn_x_cf_max_mean"][0] <= BF16_CF_ATOL
                and e["vs_cudnn_probs_max"] <= PROBS_ATOL["bfloat16"])
            (k_max, k_mean), (c_max, c_mean) = (
                e["kernel_vs_f32_x_cf_max_mean"],
                e["cudnn_vs_f32_x_cf_max_mean"])
            ok = (ok and np.isfinite(r.x_cf).all()
                  and k_max <= API_KERNEL_SLACK * c_max
                  and k_mean <= API_KERNEL_SLACK * c_mean
                  and e["kernel_vs_f32_probs_max"]
                  <= e["cudnn_vs_f32_probs_max"] + PROBS_ATOL["bfloat16"])
        emit({"phase": "api", "part": "kernel behind the wire", "card": card,
              "dtype": "bfloat16", "conv3x3_launches": launched,
              "generator_forwards": forwards,
              "launches_per_forward": KERNEL_LAYERS_PER_FORWARD,
              "against": "the cuDNN route in bf16 and in float32 (TF32 "
                         "off), in process, on the same requests",
              "errors": errs,
              "tolerance": f"against the float32 result, the kernel's x_cf "
                           f"max and mean abs error <= {API_KERNEL_SLACK} x "
                           f"the bf16 cuDNN route's, its probabilities' max "
                           f"abs error <= the cuDNN route's + "
                           f"{PROBS_ATOL['bfloat16']}; "
                           f"random_weight_bars_hold: the random-weight "
                           f"bars against the cuDNN route "
                           f"(x_cf {BF16_CF_ATOL}, probs "
                           f"{PROBS_ATOL['bfloat16']})", "ok": ok})
        if not ok:
            fail("the conv kernel's server sits farther from the float32 "
                 "result than the cuDNN route, or launched the kernel other "
                 "than 13 times a generator forward")

        # ---- (a) the launchers against in-process engines
        deadline = time.monotonic() + API_START_S
        bases = {app: _launcher_address(app, procs[app], out_dir, deadline)
                 for app, _ in API_RUNS}
        start_s = time.perf_counter() - t0
        for app, _ in API_RUNS:
            engine = local[app][0]
            x, y = tests[app]
            c = engine.num_classes
            t = (y + 1) % c
            npz, js = CFClient(bases[app]), CFClient(bases[app], wire="json")
            checks, sent = {}, {"/classify": 0, "/counterfactual": 0,
                                "/counterfactual_bulk": 0}

            def check(name, got, want, path):
                checks[name] = _same_result(got, want)
                sent[path] += 1

            probs, pred = npz.classify(x[:128])
            checks["classify"] = (np.array_equal(probs, engine.classify(
                x[:128])) and np.array_equal(pred, probs.argmax(1)))
            sent["/classify"] += 1
            for wire, cl in (("npz", npz), ("json", js)):
                check(f"b1_{wire}", cl.counterfactual(x[0], int(t[0])),
                      engine.generate(x[0], int(t[0])), "/counterfactual")
                check(f"b128_{wire}", cl.counterfactual(x[:128], t[:128]),
                      engine.generate(x[:128], t[:128]), "/counterfactual")
            if app == "mnist":
                check("b128_patches", npz.counterfactual(
                    x[:128], t[:128], patches=API_PATCHES),
                    engine.generate(x[:128], t[:128], mask=patch_mask),
                    "/counterfactual")
                check("bulk_json", js.counterfactual_bulk(
                    x[:API_JSON_BULK], t[:API_JSON_BULK], chunk=128),
                    engine.generate_bulk(x[:API_JSON_BULK],
                                         t[:API_JSON_BULK], chunk=128),
                    "/counterfactual_bulk")
            if app == "house":
                feats = engine.mask_from_feature_names(API_FEATURES,
                                                       len(x[:128]))
                for seed in API_SEEDS:
                    check(f"b128_features_seed{seed}", npz.counterfactual(
                        x[:128], t[:128], features=API_FEATURES, seed=seed),
                        engine.generate(x[:128], t[:128], mask=feats,
                                        key=jax_key(seed)),
                        "/counterfactual")
                    check(f"b128_seed{seed}", npz.counterfactual(
                        x[:128], t[:128], seed=seed),
                        engine.generate(x[:128], t[:128],
                                        key=jax_key(seed)),
                        "/counterfactual")
            bulk = npz.counterfactual_bulk(x, t, chunk=128)
            check("bulk_npz", bulk, engine.generate_bulk(x, t, chunk=128),
                  "/counterfactual_bulk")
            stats = npz.stats()["endpoints"]
            counted = {p: (stats[p]["requests"], stats[p]["errors"])
                       for p in stats}
            checks["stats"] = counted == {p: (n, 0) for p, n in sent.items()
                                          if n}
            ok = (all(checks.values()) and bulk.x_cf.shape == x.shape
                  and np.isfinite(bulk.x_cf).all()
                  and npz.health()["num_classes"] == c)
            emit({"phase": "api", "part": "launcher", "app": app,
                  "card": card, "run_dir": dict(API_RUNS)[app],
                  "address": bases[app], "bulk_rows": len(x),
                  "bulk_flip_rate": float(bulk.flipped.mean()),
                  "stats_requests_errors": counted,
                  "equal_bit_for_bit": checks,
                  "tolerance": "every array equal, bit for bit, to the "
                               "in-process engine of the same setup_*",
                  "ok": ok})
            if not ok:
                fail(f"the {app} launcher's answers differ from the "
                     f"in-process engine's: {checks}")

        # ---- (c) concurrent mixed requests against one server
        cbase = serve_here(kernel_e)
        mixed = [
            ("classify", lambda cl, _: cl.classify(xte[:4]),
             lambda: kernel_e.classify(xte[:4])),
            ("b1_json", lambda _, cj: cj.counterfactual(xte[5], 7),
             lambda: kernel_e.generate(xte[5], 7)),
            ("b32_npz", lambda cl, _: cl.counterfactual(xte[:32], t128[:32]),
             lambda: kernel_e.generate(xte[:32], t128[:32])),
            ("b8_patches_json", lambda cl, _: cl.counterfactual(
                xte[:8], 2, patches=API_PATCHES),
             lambda: kernel_e.generate(xte[:8], 2, mask=mnist_e.
                                       mask_from_patches(API_PATCHES, 8,
                                                         (28, 28)))),
            ("bulk300_npz", lambda cl, _: cl.counterfactual_bulk(
                xte[:300], 4, chunk=128),
             lambda: kernel_e.generate_bulk(xte[:300], 4, chunk=128)),
        ]
        serial = {name: ref_fn() for name, _, ref_fn in mixed}
        mismatches = []

        def worker(tid: int) -> int:
            cl, cj = CFClient(cbase), CFClient(cbase, wire="json")
            for i in range(API_PER_THREAD):
                name, ask, _ = mixed[(tid + i) % len(mixed)]
                got, want = ask(cl, cj), serial[name]
                same = (_same_result(got, want) if name != "classify"
                        else np.array_equal(got[0], want))
                if not same:
                    mismatches.append((tid, i, name))
            cl.close()
            cj.close()
            return tid

        import concurrent.futures

        t_c = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(API_THREADS) as pool:
            done = list(pool.map(worker, range(API_THREADS), timeout=600))
        concurrent_s = time.perf_counter() - t_c
        stats = CFClient(cbase).stats()["endpoints"]
        total = sum(v["requests"] for v in stats.values())
        errors = sum(v["errors"] for v in stats.values())
        ok = (done == list(range(API_THREADS)) and not mismatches
              and total == API_THREADS * API_PER_THREAD and errors == 0)
        emit({"phase": "api", "part": "concurrency", "card": card,
              "threads": API_THREADS, "requests_per_thread": API_PER_THREAD,
              "server": "make_server, MNIST conv_impl='pallas'",
              "stats_requests": total, "stats_errors": errors,
              "mismatches": mismatches[:10], "wall_s": concurrent_s,
              "ok": ok})
        if not ok:
            fail(f"concurrent requests: {len(mismatches)} differ from their "
                 f"serial answers, /stats counted {total} ({errors} errors)")

        # ---- (d) timing: the wire against the engine, in turns
        mbase = bases["mnist"]
        npz, js = CFClient(mbase), CFClient(mbase, wire="json")
        x1, t1 = xte[:1], int(t128[0])
        per_turn = API_TIMED // API_TURNS
        lat = {"wire_npz": [], "wire_json": [], "engine": []}
        for _ in range(API_TURNS):
            lat["wire_npz"] += host_ms(lambda: npz.counterfactual(x1, t1),
                                       per_turn, warmup=2)
            lat["wire_json"] += host_ms(lambda: js.counterfactual(x1, t1),
                                        per_turn, warmup=2)
            lat["engine"] += host_ms(lambda: mnist_e.generate(x1, t1),
                                     per_turn, warmup=2)
        t_all = (yte + 1) % 10
        bulk_ms = {"wire_npz": [], "engine": []}
        for _ in range(API_BULK_TURNS):
            bulk_ms["wire_npz"] += host_ms(lambda: npz.counterfactual_bulk(
                xte, t_all, chunk=128), 1, warmup=0)
            bulk_ms["engine"] += host_ms(lambda: mnist_e.generate_bulk(
                xte, t_all, chunk=128), 1, warmup=0)
        json_bulk_ms = {"wire_json": [], "engine": []}
        jx, jt = xte[:API_JSON_BULK], t_all[:API_JSON_BULK]
        for _ in range(API_BULK_TURNS):
            json_bulk_ms["wire_json"] += host_ms(
                lambda: js.counterfactual_bulk(jx, jt, chunk=128), 1,
                warmup=0)
            json_bulk_ms["engine"] += host_ms(
                lambda: mnist_e.generate_bulk(jx, jt, chunk=128), 1,
                warmup=0)
        server_lat = npz.stats()["endpoints"]["/counterfactual"][
            "latency_ms"]
        # device idle share of one b=1 request through a server in this
        # process (the profiler sees this process's kernels only)
        ibase = serve_here(mnist_e)
        inpz = CFClient(ibase)
        in_lat = host_ms(lambda: inpz.counterfactual(x1, t1), 50, warmup=3)
        busy_ms, top, _ = device_time(lambda: inpz.counterfactual(x1, t1),
                                      20)
        med = {k: statistics.median(v) for k, v in lat.items()}
        emit({"phase": "api", "part": "timing", "card": card,
              "app": "mnist", "dtype": "bfloat16",
              "b1_ms": {k: {"median": med[k],
                            "p90": sorted(v)[int(0.9 * len(v))],
                            "min": min(v), "n": len(v)}
                        for k, v in lat.items()},
              "wire_overhead_b1_ms": {k: med[k] - med["engine"]
                                      for k in ("wire_npz", "wire_json")},
              "server_p50_ms_from_stats": server_lat["p50"],
              "server_p95_ms_from_stats": server_lat["p95"],
              "bulk_rows": len(xte), "bulk_chunk": 128,
              "bulk_ms": bulk_ms,
              "bulk_counterfactuals_per_s": {
                  k: len(xte) / statistics.median(v) * 1e3
                  for k, v in bulk_ms.items()},
              "json_bulk_rows": API_JSON_BULK, "json_bulk_ms": json_bulk_ms,
              "json_bulk_counterfactuals_per_s": {
                  k: API_JSON_BULK / statistics.median(v) * 1e3
                  for k, v in json_bulk_ms.items()},
              "in_process_server_b1_median_ms": statistics.median(in_lat),
              "b1_request_device_busy_ms": busy_ms,
              "b1_request_device_idle_share": (
                  None if busy_ms is None
                  else 1 - busy_ms / statistics.median(in_lat)),
              "device_time_by_kernel_ms": top,
              "launchers_setup_s": setup_s, "launchers_up_s": start_s})
        done = True
    finally:
        for server in servers:
            server.shutdown()
            server.server_close()
        codes = _stop_launchers(procs, out_dir, check=done)
    emit({"phase": "api", "part": "stop", "card": card,
          "launcher_exit_codes": codes, "ok": True})


def reference_mnist_generator(path: Path, seed: int, ch: int = 64,
                               blocks: int = 6) -> None:
    """A state dict in the PyTorch reference's MNIST generator layout
    (`embed`, `conv_in`, `resblocks.{i}.{conv1,bn1,conv2,bn2}`,
    `conv_mid`, `conv_out`; OIHW convs, BatchNorm2d buffers), values from
    a numpy seed at a trained model's scales, saved with `torch.save`."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    sd = {"embed.weight": 0.3 * rng.standard_normal((10, 28 * 28))}

    def conv(name, cin, cout):
        sd[f"{name}.weight"] = (rng.standard_normal((cout, cin, 3, 3))
                                / math.sqrt(9 * cin))
        sd[f"{name}.bias"] = 0.01 * rng.standard_normal(cout)

    def bn(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, c)
        sd[f"{name}.bias"] = 0.1 * rng.standard_normal(c)
        sd[f"{name}.running_mean"] = 0.1 * rng.standard_normal(c)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, c)

    conv("conv_in", 3, ch)
    for i in range(blocks):
        for j in (1, 2):
            conv(f"resblocks.{i}.conv{j}", ch, ch)
            bn(f"resblocks.{i}.bn{j}", ch)
    conv("conv_mid", ch, ch)
    conv("conv_out", ch, 1)
    out = {k: torch.from_numpy(np.asarray(v, np.float32))
           for k, v in sd.items()}
    for i in range(blocks):
        for j in (1, 2):
            out[f"resblocks.{i}.bn{j}.num_batches_tracked"] = torch.tensor(1)
    torch.save(out, path)


def apps_phase(card: str, dev, counts, zero_counts) -> dict:
    """The promptable front ends on the card (`cfgan_torch.serve.apps`,
    no gradio, no LLM provider, no network):

    - the MNIST chat (`MnistChatBackend(llm=False)`) on
      `setup_mnist(FIGURES_RUN_DIR, conv_impl="pallas")`: APPS_CHAT, then
      one reply through a scripted `llm`; 13 conv kernel launches a
      transform; each transform's pred, confidence and x_cf against the
      same dialogue on cuDNN's route (APPS_CUDNN_CF_ATOL, PROBS_ATOL) and
      its distance from a float32 route reported;
    - the house backend on `results/house_countergan/`: a sample, then
      APPS_HOUSE_INSTRUCTION: exactly those features allowed, every other
      feature unmoved but where the clamp to [0, 1] moves a test value
      outside the training range (as the JAX engine does), rows in
      pandas' `sort_values(ascending=False)` order;
    - the moons backend on `results/moons_countergan/`: a sample, then
      each mask row: "none" returns x, "x_only" and "y_only" keep the
      other coordinate exactly;
    - every PNG read back (`read_png`) equal to its `render()`;
    - migrate: a synthetic reference-layout MNIST generator (full width)
      imported by `import_mnist_generator` and served in float32 on the
      kernel route against cuDNN's (F32_ATOL), 13 launches a forward;
    - the launcher's app mode, `python -m cfgan_torch.serve.launch --app
      moons`: without gradio it exits non-zero with the ImportError's
      message (with gradio present that check is skipped, and said);
    - the conv at these b=1 shapes against its plain version and timed.
    Returns {"chat" | "migrate": {launches, err, timing}} for the
    kernels line."""
    import importlib.util
    import os
    import tempfile

    import numpy as np
    import torch

    from cfgan_torch import migrate
    from cfgan_torch.core.config import MNIST_COUNTERGAN
    from cfgan_torch.eval import figure as fig_mod
    from cfgan_torch.eval import images as img_mod
    from cfgan_torch.eval.tabular import descending_order
    from cfgan_torch.serve import apps, intent
    from cfgan_torch.serve.engine import CounterfactualEngine
    from cfgan_torch.serve.launch import (
        restore_state_dict,
        setup_house,
        setup_mnist,
        setup_moons,
    )
    from cfgan_torch.train.builders import build_mnist_serving, mnist_models

    for run in (FIGURES_RUN_DIR, HOUSE_RUN_DIR, MOONS_RUN_DIR):
        for part in ("classifier", "generator"):
            if not (run / part).is_dir():
                fail(f"the apps phase serves the committed run dirs; "
                     f"missing {run / part}")
    for k in ("GEMINI_API_KEY", "GOOGLE_API_KEY", "OPENAI_API_KEY"):
        os.environ.pop(k, None)  # the regex path serves, as on any host
    if intent.llm_client() is not None:
        fail("an LLM provider is configured with no key")
    laps = Laps()
    out_dir = HERE / "build" / "smoke_apps"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    saved, transforms = [], []
    save, ume = fig_mod.Figure.save, img_mod.user_modification_example

    def save_spy(self, path):
        saved.append((Path(path), self))
        return save(self, path)

    def ume_spy(*a, **k):
        out = ume(*a, **k)
        transforms.append(out)
        return out

    tmp_before = tempfile.tempdir
    tempfile.tempdir = str(out_dir)  # the backends' PNGs
    fig_mod.Figure.save = save_spy
    img_mod.user_modification_example = ume_spy
    try:
        # ---- MNIST chat: the kernel route, then cuDNN's and float32's
        eng_k, xte, yte, ps = setup_mnist(str(FIGURES_RUN_DIR), device=dev,
                                          conv_impl="pallas")

        def engine(conv_impl, dtype):
            cfg = replace(MNIST_COUNTERGAN, conv_impl=conv_impl,
                          compute_dtype=dtype)
            g_model, clf_model = mnist_models(cfg)
            s = build_mnist_serving(
                cfg, restore_state_dict(g_model,
                                        f"{FIGURES_RUN_DIR}/generator"),
                restore_state_dict(clf_model,
                                   f"{FIGURES_RUN_DIR}/classifier"),
                device=dev)
            return CounterfactualEngine(s.cf_fn, s.clf_fn, s.num_classes,
                                        patch_size=ps, device=dev)

        def dialogue(eng):
            """APPS_CHAT on a regex backend, then one scripted-LLM reply:
            (replies, current_idx after each, the transforms' results)."""
            first = len(transforms)
            b = apps.MnistChatBackend(eng, xte, yte, ps, llm=False, seed=SEED)
            replies, idx = [], []
            for msg in APPS_CHAT:
                replies.append(b.reply(msg, [])[0])
                idx.append(b.current_idx)
            b.llm = lambda prompt: APPS_LLM_REPLY
            replies.append(b.reply("now make it a one, middle rows", [])[0])
            idx.append(b.current_idx)
            return replies, idx, transforms[first:]

        zero_counts()
        chat_k = dialogue(eng_k)
        torch.cuda.synchronize()
        chat_counts = counts()
        chat_launches = chat_counts[2]
        laps("mnist chat")
        chat_c = dialogue(engine(None, "bfloat16"))
        cudnn_launches = counts()[2] - chat_launches
        chat_f = dialogue(engine(None, "float32"))
        laps("mnist chat, cuDNN and float32 routes")
        n_tr = len(chat_k[2])
        cmp = [{"pred": (k["pred"], c["pred"]),
                "confidence": (k["confidence"], c["confidence"]),
                "x_cf_vs_cudnn": float(np.abs(k["x_cf"] - c["x_cf"]).max()),
                "x_cf_vs_f32": float(np.abs(k["x_cf"] - f["x_cf"]).max()),
                "cudnn_x_cf_vs_f32": float(np.abs(c["x_cf"]
                                                  - f["x_cf"]).max()),
                "edit_outside_mask": float(np.abs(
                    (k["x_cf"] - xte[i]) * (1 - k["mask"])).max())}
               for k, c, f, i in zip(chat_k[2], chat_c[2], chat_f[2],
                                     (chat_k[1][1], chat_k[1][3]))]
        chat_ok = (n_tr == 2 and len(chat_c[2]) == len(chat_f[2]) == 2
                   and chat_launches == KERNEL_LAYERS_PER_FORWARD * n_tr
                   and cudnn_launches == 0
                   and chat_k[0] == chat_c[0] and chat_k[1] == chat_c[1]
                   and chat_k[1][0] is not None
                   and int(yte[chat_k[1][0]]) == 3
                   and all(c["pred"][0] == c["pred"][1]
                           and abs(c["confidence"][0] - c["confidence"][1])
                           <= PROBS_ATOL["bfloat16"]
                           and c["x_cf_vs_cudnn"] <= APPS_CUDNN_CF_ATOL
                           and c["edit_outside_mask"] == 0.0
                           for c in cmp)
                   and "classifier says" in chat_k[0][1]
                   and chat_k[0][2].startswith("I can "))
        emit({"phase": "apps", "part": "mnist chat", "card": card,
              "run_dir": str(FIGURES_RUN_DIR.relative_to(HERE)),
              "dtype": "bfloat16", "replies": chat_k[0],
              "current_idx": chat_k[1], "transforms": cmp,
              "conv3x3_launches": chat_launches,
              "launches_fwd_bwd_conv_dk": chat_counts,
              "cudnn_route_conv3x3_launches": cudnn_launches,
              "tolerance": f"pred equal, confidence within "
                           f"{PROBS_ATOL['bfloat16']} and x_cf within "
                           f"{APPS_CUDNN_CF_ATOL} of cuDNN's route; "
                           f"replies and picks equal; no edit outside the "
                           f"patches", "ok": chat_ok})
        if not chat_ok:
            fail("the MNIST chat on the conv kernel left the cuDNN route's "
                 "dialogue or missed the kernel")

        # ---- house
        h_eng, h_x, h_y, schema, stats, bins = setup_house(
            str(HOUSE_RUN_DIR), device=dev)
        hb = apps.HouseBackend(h_eng, h_x, h_y, schema, stats, bins)
        sample, probs = hb.show_sample(0)
        table, verdict = hb.generate(3, APPS_HOUSE_INSTRUCTION)
        names = list(schema.feature_names)
        delta = dict(zip(table.column("feature"), table.column("abs_delta")))
        v = np.asarray([delta[f] for f in names], np.float32)
        x0 = h_x[hb.current_idx]
        clamp_move = np.abs(np.clip(x0, 0, 1) - x0)
        moved_out = [f for f, d in zip(names, v)
                     if f not in APPS_HOUSE_FEATURES and d != 0]
        house_ok = (
            verdict.endswith("allowed features: "
                             + ", ".join(APPS_HOUSE_FEATURES))
            and table.columns == ["feature", "original", "counterfactual",
                                  "change", "abs_delta"]
            and table.column("feature").tolist()
            == [names[i] for i in descending_order(v)]
            and all(v[names.index(f)] == clamp_move[names.index(f)]
                    for f in names if f not in APPS_HOUSE_FEATURES)
            and sample.columns == ["feature", "value"]
            and int(h_y[hb.current_idx]) == 0)
        emit({"phase": "apps", "part": "house", "card": card,
              "current_idx": hb.current_idx, "probs": probs,
              "verdict": verdict, "rows": table["data"],
              "moved_outside_the_mask_by_the_clamp": moved_out,
              "ok": house_ok})
        if not house_ok:
            fail("the house backend moved a feature outside its mask, "
                 "parsed other features, or left pandas' row order")
        laps("house")

        # ---- moons
        m_eng, m_clf, m_x, m_y = setup_moons(str(MOONS_RUN_DIR), device=dev)
        mb = apps.MoonsBackend(m_eng, m_clf, m_x, m_y)
        mb.show_sample(0)
        mx = m_x[mb.current_idx]
        moons = {}
        for choice in apps.MoonsBackend.MASK_ROWS:
            _, res, verdict = mb.generate(1, choice)
            moons[choice] = {"x_cf": res.x_cf[0].tolist(),
                             "pred": int(res.pred[0]), "verdict": verdict}
        keep = {"none": (0, 1), "x_only": (1,), "y_only": (0,), "both": ()}
        moons_ok = all(moons[c]["x_cf"][i] == float(mx[i])
                       for c, idx in keep.items() for i in idx) and all(
            math.isfinite(t) for r in moons.values() for t in r["x_cf"])
        emit({"phase": "apps", "part": "moons", "card": card,
              "current_idx": mb.current_idx, "x": mx.tolist(),
              "generate": moons, "ok": moons_ok})
        if not moons_ok:
            fail("a moons mask row moved a coordinate it holds fixed")
        laps("moons")
    finally:
        fig_mod.Figure.save = save
        img_mod.user_modification_example = ume
        tempfile.tempdir = tmp_before

    readback = [fig_mod.read_png(p).shape[:2] == (f.height, f.width)
                and bool(np.array_equal(fig_mod.read_png(p), f.render()))
                for p, f in saved]
    # three dialogues of a patch grid and two transforms; a boundary plot
    # and four arrow plots
    if len(readback) != 3 * 3 + 1 + 4 or not all(readback):
        fail(f"the apps' PNGs: {sum(readback)} of {len(readback)} read "
             f"back equal to render()")
    laps("readback")

    # ---- migrate: the reference's layout, imported and served
    ref = out_dir / "generator.pt"
    reference_mnist_generator(ref, SEED)
    g_sd = migrate.import_mnist_generator(str(ref))
    c_sd = mnist_models(MNIST_COUNTERGAN, generator=torch.Generator(
        ).manual_seed(SEED))[1].state_dict()
    cfg = replace(MNIST_COUNTERGAN, compute_dtype="float32")
    x1 = xte[:2]
    mask = eng_k.mask_from_patches([5, 6, 9, 10], 1, (28, 28))
    served = {}
    for impl in ("pallas", None):
        s = build_mnist_serving(replace(cfg, conv_impl=impl), g_sd, c_sd,
                                device=dev)
        e = CounterfactualEngine(s.cf_fn, s.clf_fn, s.num_classes,
                                 patch_size=ps, device=dev)
        zero_counts()
        served[impl] = [e.generate(x1[0], 3), e.generate(x1[1], 8, mask)]
        torch.cuda.synchronize()
        served[impl, "launches"] = counts()[2]
    errs = [float(np.abs(a.x_cf - b.x_cf).max())
            for a, b in zip(served["pallas"], served[None])]
    p_errs = [float(np.abs(a.probs - b.probs).max())
              for a, b in zip(served["pallas"], served[None])]
    mig_launches = served["pallas", "launches"]
    migrate_ok = (mig_launches == 2 * KERNEL_LAYERS_PER_FORWARD
                  and served[None, "launches"] == 0
                  and max(errs) <= F32_ATOL
                  and max(p_errs) <= PROBS_ATOL["float32"]
                  and all(np.isfinite(r.x_cf).all() and r.x_cf.shape
                          == (1, 28, 28, 1) for r in served["pallas"]))
    emit({"phase": "apps", "part": "migrate", "card": card,
          "state_dict_keys": len(g_sd), "dtype": "float32",
          "x_cf_max_abs_err": errs, "probs_max_abs_err": p_errs,
          "conv3x3_launches": mig_launches,
          "tolerance": f"x_cf abs <= {F32_ATOL}, probs abs <= "
                       f"{PROBS_ATOL['float32']} against cuDNN's route",
          "ok": migrate_ok})
    if not migrate_ok:
        fail("the imported generator on the conv kernel differs from "
             "cuDNN's route or missed the kernel")
    laps("migrate")

    # ---- the launcher's app mode
    has_gradio = importlib.util.find_spec("gradio") is not None
    launcher = {"gradio_present": has_gradio}
    if has_gradio:
        launcher["skipped"] = ("gradio is installed: the launcher would "
                               "serve the app, so its failure is not checked")
    else:
        proc = subprocess.run(
            [sys.executable, "-m", "cfgan_torch.serve.launch", "--app",
             "moons"], cwd=HERE, capture_output=True, text=True, timeout=120)
        launcher.update(exit_code=proc.returncode,
                        stderr=proc.stderr.strip()[-400:])
        if proc.returncode == 0 or "gradio is not installed" not in \
                proc.stderr or "listening" in proc.stdout:
            fail(f"the launcher without gradio: exit {proc.returncode}, "
                 f"{proc.stderr[-1000:]}")
    emit({"phase": "apps", "part": "launcher", **launcher, "ok": True})
    laps("launcher")

    # ---- the conv at the b=1 shape these paths give it
    cgen = torch.Generator().manual_seed(SEED)
    err = {d: check_conv(cgen, dev, APPS_SHAPE, d, "apps")
           for d in ("bfloat16", "float32")}
    timing = {d: time_conv(card, cgen, dev, APPS_SHAPE, d, "apps")
              for d in ("bfloat16", "float32")}
    laps("kernel")
    emit({"phase": "apps", "card": card, "pngs_read_back_equal":
          sum(readback), "part_seconds": laps.s, "ok": True})
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"chat": {"launches": chat_launches, "err": err["bfloat16"],
                     "timing": timing["bfloat16"]},
            "migrate": {"launches": mig_launches, "err": err["float32"],
                        "timing": timing["float32"]}}


def sharded_steps(dev, dtype: str, mesh=None, counts=None,
                  channel: bool = False):
    """SHARDED_STEPS steps of the shipped preset with the conv kernel at
    `dtype` on the global batch of TRAIN_BATCH rows, from initial weights
    and data made from SEED (the same on every rank), on a state
    replicated on `mesh` (None: one process), with `channel` its
    generator channel-sharded over the mesh's "model" axis.  Builds the
    bundle and its batches, then returns (`run`, `step`): `run()` takes
    the steps and returns the metrics by step, Adam's first moments after
    the first step and the parameters after the last (flax paths, numpy,
    gathered whole), the mean ms of a step after the first, the kernel
    launches (with `counts`), whether every rank holds the same state,
    the bytes of this rank's state and of its generator's optimizer
    state; `step()` takes one more step on the first batch and returns
    its wall ms."""
    import numpy as np
    import torch

    from cfgan_torch.convert import adam_moments_to_flax, gan_state_to_flax
    from cfgan_torch.core.config import MNIST_COUNTERGAN
    from cfgan_torch.parallel import (
        channel_sharding_spec,
        replicate,
        shard_leaves,
    )
    from cfgan_torch.parallel.sharding import (
        _optimizer_tensors,
        replicas_equal,
        state_tensors,
    )
    from cfgan_torch.train.builders import build_mnist_countergan, mnist_models

    cfg = replace(MNIST_COUNTERGAN, conv_impl="pallas", compute_dtype=dtype)
    gen = torch.Generator().manual_seed(SEED + 30)
    clf_sd = mnist_models(cfg, generator=gen)[1].state_dict()
    b = TRAIN_BATCH
    x = (torch.rand((SHARDED_STEPS, b, 28, 28, 1), generator=gen) * 2
         - 1).to(dev)
    y = torch.randint(0, 10, (SHARDED_STEPS, b), generator=gen).to(dev)
    bundle = build_mnist_countergan(cfg, clf_sd, seed=SEED, device=dev)
    draws = {k: v.to(dev) for k, v in bundle.draw_fn(
        torch.Generator().manual_seed(SEED + 31), (SHARDED_STEPS, b)).items()}
    if mesh is not None:
        replicate(mesh, bundle.state)
    if channel:
        shard_leaves(bundle.state.g, channel_sharding_spec(
            mesh, bundle.state.g, axis="model"))

    def nbytes(tensors) -> int:
        return sum(t.numel() * t.element_size() for t in tensors)

    def step(i: int) -> float:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        m = bundle.step_from_draws(bundle.state, x[i], y[i],
                                   {k: v[i] for k, v in draws.items()})
        torch.cuda.synchronize(dev)
        return m, (time.perf_counter() - t0) * 1e3

    def run() -> dict:
        metrics, times = [], []
        before = counts() if counts is not None else None
        for i in range(SHARDED_STEPS):
            m, ms = step(i)
            times.append(ms)
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                mu = {net: _flat(tree) for net, tree in
                      adam_moments_to_flax(bundle.state).items()}
        launched = (None if counts is None else
                    tuple(a - c for a, c in zip(counts(), before)))
        tree = gan_state_to_flax(bundle.state)
        params = {net: {k: np.asarray(v, np.float32)
                        for k, v in _flat(tree[net]["params"]).items()}
                  for net in ("g", "d")}
        return {"metrics": metrics, "mu": mu, "params": params,
                "step_ms": statistics.mean(times[1:]), "launches": launched,
                "equal": replicas_equal(bundle.state),
                "state_bytes": nbytes(state_tensors(bundle.state)),
                "g_opt_bytes": nbytes(_optimizer_tensors(bundle.state.g.opt)),
                "lr": (cfg.lr_g, cfg.lr_d)}

    return run, lambda: step(0)[1]


def sharded_loop(dev, mesh, mesh2) -> dict:
    """On a world of four NCCL ranks, one a card: SHARDED_EPOCHS epochs of
    SHARDED_ROWS rows of the shipped preset with the conv kernel through
    `train_countergan_loop` on the ("data", "model") mesh `mesh2` with the
    generator channel-sharded over "model", and on the 1-D `mesh`; the
    same epochs eager, step by step, on a second channel-sharded state;
    then one more epoch of each loop's bundle replayed, timed in turns.
    Returns the 2-D runner's captures and replays, whether its history
    and this rank's state equal the eager run's bit for bit and the
    ranks hold one state, and each layout's replayed step ms by turn."""
    import torch

    from cfgan_torch.core.config import MNIST_COUNTERGAN
    from cfgan_torch.data.pipeline import epoch_perm
    from cfgan_torch.parallel import (
        channel_sharding_spec,
        replicate,
        shard_leaves,
    )
    from cfgan_torch.parallel.sharding import replicas_equal, state_tensors
    from cfgan_torch.train.builders import build_mnist_countergan, mnist_models
    from cfgan_torch.train.loop import epoch_generators, train_countergan_loop

    cfg = replace(MNIST_COUNTERGAN, conv_impl="pallas")
    gen = torch.Generator().manual_seed(SEED + 32)
    clf_sd = mnist_models(cfg, generator=gen)[1].state_dict()
    x = (torch.rand((SHARDED_ROWS, 28, 28, 1), generator=gen) * 2 - 1)
    y = torch.randint(0, 10, (SHARDED_ROWS,), generator=gen)

    def bundle_on(m, channel: bool):
        b = build_mnist_countergan(cfg, clf_sd, seed=SEED, device=dev)
        replicate(m, b.state)
        if channel:
            shard_leaves(b.state.g, channel_sharding_spec(m, b.state.g))
        return b

    def epoch_inputs(b, epoch: int):
        g_perm, g_draws = epoch_generators(SEED, epoch, dev)
        perm = epoch_perm(g_perm, len(y), TRAIN_BATCH)
        return perm, b.draw_fn(g_draws, tuple(perm.shape))

    loops = {}
    for name, m in (("2d", mesh2), ("1d", mesh)):
        b = bundle_on(m, name == "2d")
        _, hist = train_countergan_loop(b, x, y, epochs=SHARDED_EPOCHS,
                                        batch_size=TRAIN_BATCH, seed=SEED,
                                        mesh=m, log=lambda line: None)
        hist.pop("wall_time_s")
        loops[name] = (b, hist)
    b2, hist2 = loops["2d"]
    captures, replays = b2.epoch_fn.captures, b2.epoch_fn.replays

    # the same epochs eager, as the runner reduces them
    e = bundle_on(mesh2, True)
    xd, yd = x.to(dev), y.to(dev, torch.long)
    eager: dict = {}
    for epoch in range(SHARDED_EPOCHS):
        perm, draws = epoch_inputs(e, epoch)
        rows = []
        for i in range(perm.shape[0]):
            m = e.step_from_draws(e.state, xd.index_select(0, perm[i]),
                                  yd.index_select(0, perm[i]),
                                  {k: v[i] for k, v in draws.items()})
            rows.append(torch.stack([v.float() for v in m.values()]))
        for k, v in zip(m, torch.stack(rows).mean(0).cpu().tolist()):
            eager.setdefault(k, []).append(v)
    same_state = all(torch.equal(a, c) for a, c in zip(
        state_tensors(b2.state), state_tensors(e.state)))

    # one more epoch of each, replayed whole, in turns (the first call on
    # these tensors captures)
    perm, draws = epoch_inputs(b2, SHARDED_EPOCHS)
    for b, _ in loops.values():
        b.epoch_fn(b.state, xd, yd, perm, draws)
    replayed = {name: [] for name in loops}
    for _ in range(2):
        for name, (b, _) in loops.items():
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            b.epoch_fn(b.state, xd, yd, perm, draws)
            torch.cuda.synchronize(dev)
            replayed[name].append((time.perf_counter() - t0) * 1e3
                                  / perm.shape[0])
    return {"captures": captures, "replays": replays,
            "history_equal": eager == hist2, "state_equal": same_state,
            "replicas_equal": replicas_equal(b2.state),
            "replayed_step_ms": replayed}


def sharded_rank(rank: int, library: str, single_card: bool, go) -> dict:
    """One rank of the sharded phase's world (b), in a process of its own:
    the prebuilt kernel library, this rank's card (card 0 for every rank
    of a gloo world on one card), the states of `sharded_steps` in f32 and
    bf16 replicated on the world's 1-D mesh and on its ("data", "model")
    mesh (world / 2, 2) with the generator channel-sharded, then, once the
    parent sets `go`, their steps, SHARDED_TURNS more eager steps of each
    in turns and, on a world of four cards, `sharded_loop`."""
    import torch

    from cfgan_torch.ops import _build
    from cfgan_torch.ops import epilogue as tep
    from cfgan_torch.ops.conv import conv3x3_same, conv3x3_same_dkernel
    from cfgan_torch.parallel import create_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    _build.load_library(library)
    dev = torch.device("cuda", 0 if single_card else rank)
    torch.cuda.set_device(dev)
    mesh = create_mesh(devices=[dev])
    mesh2 = create_mesh((mesh.world_size // 2, 2), ("data", "model"),
                        devices=[dev])

    def counts():
        return (tep.cf_epilogue_fwd.launches, tep.cf_epilogue_bwd.launches,
                conv3x3_same.launches, conv3x3_same_dkernel.launches)

    runs = {(layout, dtype): sharded_steps(dev, dtype, m, counts,
                                           channel=layout == "2d")
            for layout, m in (("1d", mesh), ("2d", mesh2))
            for dtype in ("float32", "bfloat16")}
    if not go.wait(SHARDED_WAIT):
        raise TimeoutError("the parent never started the steps")
    out = {key: run() for key, (run, _) in runs.items()}
    turns = {key: [] for key in runs}
    for _ in range(SHARDED_TURNS):
        for key, (_, step) in runs.items():
            turns[key].append(step())
    loop = (sharded_loop(dev, mesh, mesh2)
            if mesh.world_size == 4 and not single_card else None)
    return {"steps": out, "turn_ms": turns, "loop": loop}


class ShardedRanks:
    """The sharded phase's world (b), started ahead of the phase (the
    full smoke starts it after the build, so that the ranks' start, the
    kernel library's load and their states overlap the other phases):
    a daemon thread runs `spawn_world(sharded_rank, ...)`, whose ranks
    wait on `go` (SHARDED_WAIT seconds at most) before their steps.
    `result()` sets `go` and returns the ranks' results.  A smoke that
    fails first exits without waiting: the ranks are daemonic processes,
    ended with it."""

    def __init__(self):
        import multiprocessing as mp
        import threading

        import torch

        from cfgan_torch.ops import _build
        from cfgan_torch.parallel import spawn_world

        n_cards = torch.cuda.device_count()
        self.world = 4 if n_cards >= 4 else 2
        self.backend = "nccl" if n_cards >= 2 else "gloo"
        self.go = mp.get_context("spawn").Event()
        self._out: dict = {}
        args = (str(_build.load_library().path), n_cards < 2, self.go)

        def run():
            try:
                self._out["value"] = spawn_world(
                    sharded_rank, self.world, args, backend=self.backend,
                    timeout=SHARDED_WAIT + SHARDED_TIMEOUT, threads=None)
            except BaseException as e:  # raised again by result()
                self._out["error"] = e

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def result(self) -> list:
        self.go.set()
        self.thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


def sharded_phase(card: str, dev, counts, zero_counts,
                  ranks: ShardedRanks | None = None) -> dict:
    """The mesh and sharding layer on the card, at the shipped preset's
    width (64 channels, 6 blocks, batch 128, `conv_impl="pallas"`):

    (a) a world of one on this card with NCCL: SHARDED_EPOCHS epochs of
        SHARDED_ROWS rows through `train_countergan_loop(mesh=create_mesh
        ())`, whose epoch runner captures the step, the all-reduces of the
        BatchNorm statistics, the gradients and the metrics inside, as
        CUDA graphs (captures and replays printed); its history and its
        whole state equal the same loop's without a mesh bit for bit (a
        sum over one rank and a division by 1 change no bit); the
        epilogue, conv and dK kernels launched;
    (b) a world of 2 processes on this card joined by gloo over CUDA
        tensors (NCCL refuses two ranks on one device; with two or more
        cards, one NCCL rank a card, up to 4), each rank SHARDED_STEPS
        steps of the global batch on its rows, in f32 and bf16, from one
        initial state and the same draws, against the single-process
        steps on this card: metrics at SHARDED_RTOL / SHARDED_ATOL (f32)
        and TRAIN_ATOL (bf16), gradients and parameters by
        `moment_report`; the ranks' states equal bit for bit; the ranks
        start (and load the kernels) before the phase (`ShardedRanks`;
        the full smoke starts them after the build) or while the parent
        runs (a) and (c), and take their steps alone on the card;
    (c) the f32 kernel engine sharded over [card, card] (or the cards)
        against the engine unsharded: `generate` at SHARDED_SIZES and
        `generate_bulk` at chunk SHARDED_CHUNK within SHARDED_SERVE_ATOL,
        a chunk of SHARDED_BAD_CHUNK rejected with ValueError; and sharded
        on a ("data", "model") mesh, (2, 1) over [card, card] (or (2, 2)
        over four cards), along each axis at SHARDED_SIZES;
    (d) the ranks of (b) on their ("data", "model") mesh (world / 2, 2),
        the generator's weights and Adam moments channel-sharded over
        "model": SHARDED_STEPS steps in f32 and bf16 against the same
        ranks' 1-D steps at (b)'s bars, their launches, each rank's state
        bytes against the 1-D state's, and the eager step of both layouts
        timed in turns; with four cards, `sharded_loop`: the (2, 2) NCCL
        world's loop captured and replayed, bit for bit against its eager
        steps, its replayed step timed in turns against the 1-D world of
        4's.

    Returns the launches by kernel of a rank's bf16 steps in (b) and in
    (d), and its rows, for the `kernels` line."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cfgan_torch.core.config import MNIST_COUNTERGAN
    from cfgan_torch.ops.conv import conv3x3_same
    from cfgan_torch.parallel import create_mesh
    from cfgan_torch.parallel.mesh import free_port
    from cfgan_torch.parallel.sharding import state_tensors
    from cfgan_torch.train.builders import build_mnist_countergan, mnist_models
    from cfgan_torch.train.loop import train_countergan_loop

    laps = Laps()
    n_cards = torch.cuda.device_count()
    ranks = ranks or ShardedRanks()
    world, backend = ranks.world, ranks.backend
    try:
        cudnn = (torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

        # (a) a world of one with NCCL, the loop's runner capturing it
        cfg = replace(MNIST_COUNTERGAN, conv_impl="pallas")
        gen = torch.Generator().manual_seed(SEED + 32)
        clf_sd = mnist_models(cfg, generator=gen)[1].state_dict()
        x = (torch.rand((SHARDED_ROWS, 28, 28, 1), generator=gen) * 2 - 1)
        y = torch.randint(0, 10, (SHARDED_ROWS,), generator=gen)
        dist.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
            world_size=1, rank=0,
            device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            runs, ends = {}, {}
            for name in ("mesh", "plain"):
                mesh = create_mesh() if name == "mesh" else None
                bundle = build_mnist_countergan(cfg, clf_sd, seed=SEED,
                                                device=dev)
                zero_counts()
                ends[name] = [time.perf_counter()]
                _, hist = train_countergan_loop(
                    bundle, x, y, epochs=SHARDED_EPOCHS,
                    batch_size=TRAIN_BATCH, seed=SEED, mesh=mesh,
                    log=lambda line: None,
                    epoch_cb=lambda e, st, t=ends[name]: t.append(
                        time.perf_counter()))
                torch.cuda.synchronize()
                runs[name] = (bundle, hist, counts())
        finally:
            dist.destroy_process_group()
        (mb, mh, launched), (pb, ph, _) = runs["mesh"], runs["plain"]
        runner = mb.epoch_fn
        for h in (mh, ph):
            h.pop("wall_time_s")
        # the last epoch replays every step: its wall over its steps
        steps = SHARDED_ROWS // TRAIN_BATCH
        replayed_ms = {k: (t[-1] - t[-2]) / steps * 1e3
                       for k, t in ends.items()}
        first_epoch_s = {k: t[1] - t[0] for k, t in ends.items()}
        same_state = all(torch.equal(a, b) for a, b in zip(
            state_tensors(mb.state), state_tensors(pb.state)))
        ok = (mh == ph and same_state and mb.state.mesh is not None
              and runner.captures >= 1 and runner.replays > 0
              and all(launched))
        emit({"phase": "sharded", "part": "world of one", "card": card,
              "backend": "nccl", "epochs": SHARDED_EPOCHS,
              "rows": SHARDED_ROWS, "batch": TRAIN_BATCH,
              "captures": runner.captures, "replays": runner.replays,
              "launches": dict(zip(("epilogue_fwd", "epilogue_bwd", "conv",
                                    "conv_dk"), launched)),
              "history_equal": mh == ph, "state_equal": same_state,
              "replayed_step_ms": replayed_ms,
              "first_epoch_s": first_epoch_s, "ok": ok})
        if not ok:
            fail("the world of one's loop is not the plain loop bit for "
                 "bit, or was not captured, or skipped a kernel")
        laps("world of one")

        # (b)'s single-process steps on this card
        plain = {dtype: sharded_steps(dev, dtype)[0]()
                 for dtype in ("float32", "bfloat16")}
        laps("single-process steps")

        # (c) the engine sharded over the card twice (or the cards)
        preset = replace(MNIST_COUNTERGAN, conv_impl="pallas")
        g_model, c_model = mnist_models(preset, generator=gen)
        randomize_batch_norms(g_model, gen)
        g_sd, c_sd = g_model.state_dict(), c_model.state_dict()
        devices = ([torch.device("cuda", i) for i in range(n_cards)]
                   if n_cards >= 2 else [dev, dev])
        mesh = create_mesh(devices=devices)
        single = served_engine(preset, g_sd, c_sd, dev, "float32")
        sharded = served_engine(preset, g_sd, c_sd, dev, "float32").shard(
            mesh)
        xs = (torch.rand((max(SHARDED_SIZES), 28, 28, 1), generator=gen)
              * 2 - 1).numpy()
        ts = torch.randint(0, 10, (max(SHARDED_SIZES),), generator=gen
                           ).numpy()
        errs, launches = {}, {}
        for b in SHARDED_SIZES:
            conv3x3_same.launches = 0
            got = sharded.generate(xs[:b], ts[:b])
            torch.cuda.synchronize()
            launches[f"b={b}"] = conv3x3_same.launches
            want = single.generate(xs[:b], ts[:b])
            errs[f"b={b}"] = max(float(np.abs(getattr(got, k)
                                              - getattr(want, k)).max())
                                 for k in ("x_cf", "residual", "probs"))
            errs[f"b={b} pred_equal"] = bool(np.array_equal(got.pred,
                                                            want.pred))
        got = sharded.generate_bulk(xs, ts, chunk=SHARDED_CHUNK)
        want = single.generate_bulk(xs, ts, chunk=SHARDED_CHUNK)
        errs["bulk"] = max(float(np.abs(getattr(got, k)
                                        - getattr(want, k)).max())
                           for k in ("x_cf", "residual", "probs"))
        errs["bulk pred_equal"] = bool(np.array_equal(got.pred, want.pred))
        try:
            sharded.generate_bulk(xs, ts, chunk=SHARDED_BAD_CHUNK)
            rejected = False
        except ValueError:
            rejected = True
        served_ok = rejected and all(
            v is True or (v is not False and v <= SHARDED_SERVE_ATOL)
            for v in errs.values())
        ms = {}
        for name, e in (("sharded", sharded), ("single", single)):
            ms[name] = statistics.median(host_ms(
                lambda e=e: e.generate(xs, ts), 10))
        emit({"phase": "sharded", "part": "engine", "card": card,
              "devices": [str(d) for d in devices], "dtype": "float32",
              "max_abs_err": errs, "atol": SHARDED_SERVE_ATOL,
              "conv_launches": launches,
              "chunk_rejected": rejected,
              "generate_b100_median_ms": ms, "ok": served_ok})
        if not served_ok:
            fail(f"the sharded engine differs from the unsharded one: "
                 f"{errs}, chunk {SHARDED_BAD_CHUNK} rejected: {rejected}")
        laps("engine")

        # (c) on a ("data", "model") mesh, along each axis
        devices2 = devices[:4] if n_cards >= 4 else [dev, dev]
        mesh2 = create_mesh((2, len(devices2) // 2), ("data", "model"),
                            devices=devices2)
        errs2, shards2 = {}, {}
        for axis in ("data", "model"):
            eng = served_engine(preset, g_sd, c_sd, dev, "float32").shard(
                mesh2, axis)
            shards2[axis] = len(eng._shards)
            for b in SHARDED_SIZES:
                got, want = (e.generate(xs[:b], ts[:b])
                             for e in (eng, single))
                errs2[f"{axis} b={b}"] = max(
                    float(np.abs(getattr(got, k) - getattr(want, k)).max())
                    for k in ("x_cf", "residual", "probs"))
                errs2[f"{axis} b={b} pred_equal"] = bool(np.array_equal(
                    got.pred, want.pred))
        served2_ok = shards2 == {"data": 2, "model": mesh2.shape[1]} and all(
            v is True or (v is not False and v <= SHARDED_SERVE_ATOL)
            for v in errs2.values())
        emit({"phase": "sharded", "part": "engine 2-D", "card": card,
              "mesh": list(mesh2.shape), "axes": list(mesh2.axis_names),
              "devices": [str(d) for d in devices2], "dtype": "float32",
              "shards": shards2, "max_abs_err": errs2,
              "atol": SHARDED_SERVE_ATOL, "ok": served2_ok})
        if not served2_ok:
            fail(f"the engine on the 2-D mesh differs from the unsharded "
                 f"one: {errs2}, shards {shards2}")
        laps("engine 2-D")
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark \
            = cudnn

        # (b) the ranks take their steps alone on the card
        outs = ranks.result()
    finally:
        ranks.go.set()
    laps("ranks")
    report = {"phase": "sharded", "part": "ranks", "card": card,
              "world": world, "backend": backend,
              "rows_per_rank": TRAIN_BATCH // world, "steps": SHARDED_STEPS}
    steps = [o["steps"] for o in outs]

    def compare(got, want, dtype):
        """(report, ok) of `got`'s steps against `want`'s at (b)'s bars."""
        flips = [abs(g["flip_rate"] - w["flip_rate"])
                 for g, w in zip(got["metrics"], want["metrics"])]
        if dtype == "float32":
            errs = [max(abs(g[k] - w[k]) - SHARDED_RTOL * abs(w[k])
                        for k in w)
                    for g, w in zip(got["metrics"], want["metrics"])]
            m_ok = max(errs) <= SHARDED_ATOL
            bar = f"abs <= {SHARDED_ATOL} + {SHARDED_RTOL} |single|"
        else:
            errs = [max(abs(g[k] - w[k]) for k in w if k != "flip_rate")
                    for g, w in zip(got["metrics"], want["metrics"])]
            m_ok = (max(errs) <= TRAIN_ATOL[dtype]
                    and max(flips) <= 1 / TRAIN_BATCH)
            bar = (f"abs <= {TRAIN_ATOL[dtype]}, flip_rate <= "
                   f"1/{TRAIN_BATCH}")
        nets = {}
        for net, lr in zip(("g", "d"), want["lr"]):
            nets[net], net_ok = moment_report(
                got["mu"][net], want["mu"][net], got["params"][net],
                want["params"][net], lr, dtype)
            m_ok = m_ok and net_ok
        return {"metric_excess_per_step" if dtype == "float32" else
                "metric_max_abs_err_per_step": errs, "metric_bar": bar,
                "flip_rate_err_per_step": flips, **nets}, m_ok

    def launches_of(got):
        return dict(zip(("epilogue_fwd", "epilogue_bwd", "conv", "conv_dk"),
                        got["launches"]))

    ok = all(st[k]["equal"] for st in steps for k in st)
    for dtype in ("float32", "bfloat16"):
        got, want = steps[0]["1d", dtype], plain[dtype]
        report[dtype], m_ok = compare(got, want, dtype)
        same = all(st["1d", dtype]["metrics"] == got["metrics"]
                   for st in steps)
        report[dtype].update({
            "ranks_report_the_same_metrics": same,
            "sharded_step_ms": got["step_ms"],
            "single_process_step_ms": want["step_ms"],
            "rank0_launches": launches_of(got)})
        ok = ok and m_ok and same
    report["replicas_equal"] = all(st["1d", d]["equal"] for st in steps
                                   for d in ("float32", "bfloat16"))
    report["part_seconds"] = laps.s
    report["ok"] = bool(ok)
    emit(report)
    if not ok:
        fail("the sharded ranks differ from the single-process steps or "
             "from each other")

    # (d) the same ranks on their ("data", "model") mesh
    report2 = {"phase": "sharded", "part": "ranks 2-D", "card": card,
               "world": world, "backend": backend,
               "mesh": [world // 2, 2], "axes": ["data", "model"],
               "rows_per_rank": TRAIN_BATCH // world,
               "steps": SHARDED_STEPS}
    ok2 = all(st["2d", d]["equal"] for st in steps
              for d in ("float32", "bfloat16"))
    for dtype in ("float32", "bfloat16"):
        got, want = steps[0]["2d", dtype], steps[0]["1d", dtype]
        report2[dtype], m_ok = compare(got, want, dtype)
        same = all(st["2d", dtype]["metrics"] == got["metrics"]
                   for st in steps)
        launched = launches_of(got)
        per_step = {"epilogue_fwd": 1, "epilogue_bwd": 1,
                    "conv": 2 * KERNEL_LAYERS_PER_FORWARD,
                    "conv_dk": KERNEL_LAYERS_PER_FORWARD}
        l_ok = launched == {k: v * SHARDED_STEPS for k, v in per_step.items()}
        turn = {layout: outs[0]["turn_ms"][layout, dtype]
                for layout in ("1d", "2d")}
        report2[dtype].update({
            "ranks_report_the_same_metrics": same,
            "rank0_launches": launched, "launches_ok": l_ok,
            "state_bytes_by_rank": {
                layout: [st[layout, dtype]["state_bytes"] for st in steps]
                for layout in ("1d", "2d")},
            "g_adam_bytes_by_rank": {
                layout: [st[layout, dtype]["g_opt_bytes"] for st in steps]
                for layout in ("1d", "2d")},
            "eager_step_ms_in_turns": turn,
            "eager_step_median_ms": {k: statistics.median(v)
                                     for k, v in turn.items()}})
        ok2 = ok2 and m_ok and same and l_ok
    report2["replicas_equal"] = all(st["2d", d]["equal"] for st in steps
                                    for d in ("float32", "bfloat16"))
    loops = [o["loop"] for o in outs]
    if loops[0] is not None:
        loop_ok = all(lp["history_equal"] and lp["state_equal"]
                      and lp["replicas_equal"] and lp["captures"] >= 1
                      and lp["replays"] > 0 for lp in loops)
        report2["loop"] = {
            "backend": "nccl", "epochs": SHARDED_EPOCHS,
            "rows": SHARDED_ROWS, "batch": TRAIN_BATCH,
            "captures": loops[0]["captures"], "replays": loops[0]["replays"],
            "eager_equal_by_rank": [lp["history_equal"] and lp["state_equal"]
                                    for lp in loops],
            "replayed_step_ms_in_turns": loops[0]["replayed_step_ms"],
            "ok": loop_ok}
        ok2 = ok2 and loop_ok
    report2["ok"] = bool(ok2)
    emit(report2)
    if not ok2:
        fail("the ranks' steps on the 2-D mesh differ from their 1-D steps "
             "or from each other, launched other kernels, or the 2-D loop "
             "was not its eager steps bit for bit")
    return {"rows": TRAIN_BATCH // world,
            "launches": steps[0]["1d", "bfloat16"]["launches"],
            "launches_2d": steps[0]["2d", "bfloat16"]["launches"]}


# the phases `--phases` may name: each needs only the built kernels
STANDALONE_PHASES = {"pipeline": pipeline_phase,
                     "custom shapes": custom_shapes_phase,
                     "examples": examples_phase,
                     "figures": figures_phase,
                     "apps": apps_phase,
                     "sharded": sharded_phase}


def _selected_phases(argv: list[str]) -> list[str] | None:
    """The phases `--phases a,b` names (None: every phase, as the smoke
    runs without arguments); exits 2 on a name it cannot run alone."""
    if "--phases" not in argv:
        return None
    i = argv.index("--phases")
    names = [n.strip() for n in (argv[i + 1] if i + 1 < len(argv)
                                 else "").split(",") if n.strip()]
    unknown = [n for n in names if n not in STANDALONE_PHASES]
    if unknown or not names:
        print(f"chip_smoke: --phases takes a comma-separated list of "
              f"{sorted(STANDALONE_PHASES)}, not {argv[i + 1:i + 2]}",
              file=sys.stderr)
        sys.exit(2)
    return names


def main() -> None:
    import contextlib

    import numpy as np
    import torch

    selected = _selected_phases(sys.argv[1:])
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    if not (HERE / "cfgan_torch" / "__init__.py").is_file():
        fail(f"no cfgan_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(HERE))

    from cfgan_torch.convert import adam_moments_to_flax, gan_state_to_flax
    from cfgan_torch.core.config import MNIST_COUNTERGAN
    from cfgan_torch.ops import _build
    from cfgan_torch.ops import epilogue as tep
    from cfgan_torch.ops.conv import conv3x3_same, conv3x3_same_dkernel
    from cfgan_torch.serve.engine import CounterfactualEngine
    from cfgan_torch.train.builders import build_mnist_countergan, mnist_models

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)

    # ------------------------------------------------------------ device
    with Phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        card = smi.stdout.strip().splitlines()[0].strip()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        emit({"phase": "device", "nvidia_smi": card, "name": kind,
              "count": count, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
              "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    # ------------------------------------------------------------- build
    with Phase("build"):
        lib = _build.load_library()
        ptxas = [ln.strip() for ln in lib.ptxas_log.splitlines()
                 if any(k in ln for k in ("Compiling entry", "registers",
                                          "spill", "smem", "Performance"))]
        spills = [ln for ln in ptxas if any(
            int(n) for n in re.findall(r"(\d+) bytes spill", ln))]
        emit({"phase": "build", "seconds": round(lib.seconds, 3),
              "library": str(lib.path.relative_to(HERE)), "ptxas": ptxas,
              "spills": spills,
              "conv": kernel_ptxas(
                  lib.ptxas_log,
                  r"conv3x3_(?:wgmma_ws|wgmma|tf32_ws|tf32_ksplit|tf32)"
                  r"_kernel"),
              "dkernel": kernel_ptxas(
                  lib.ptxas_log,
                  r"conv3x3_dkernel_(?:wgmma|tf32_ws|tf32)_kernel"
                  r"|dkernel_reduce_kernel")})
        if spills:
            fail(f"a kernel spills registers: {spills}")

    def counts():
        return (tep.cf_epilogue_fwd.launches, tep.cf_epilogue_bwd.launches,
                conv3x3_same.launches, conv3x3_same_dkernel.launches)

    def zero_counts():
        tep.cf_epilogue_fwd.launches = tep.cf_epilogue_bwd.launches = 0
        conv3x3_same.launches = conv3x3_same_dkernel.launches = 0

    if selected is not None:  # --phases: only the phases named
        for name in selected:
            with Phase(name):
                STANDALONE_PHASES[name](card, dev, counts, zero_counts)
        print(card, flush=True)
        emit({"ok": True, "phases": selected,
              "device": {"platform": "gpu", "kind": kind, "count": count}})
        return

    if "--train-timing-only" in sys.argv[1:]:
        clf_sd = mnist_models(MNIST_COUNTERGAN, generator=gen)[1].state_dict()
        train_x = (torch.rand((TRAIN_STEPS, TRAIN_BATCH, 28, 28, 1),
                              generator=gen) * 2 - 1).to(dev)
        train_y = torch.randint(0, 10, (TRAIN_STEPS, TRAIN_BATCH),
                                generator=gen).to(dev)
        with Phase("timing train"):
            time_train_steps(card, dev, clf_sd, train_x, train_y)
            time_epilogue(card, dev)
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                     "count": count}})
        return

    # the sharded phase's ranks start now and wait for it
    sharded_ranks = ShardedRanks()

    # ----------------------------------------------- kernel vs plain
    kernel_err = {}
    with Phase("kernel conv3x3"):
        laps = Laps()
        for shape in CONV_SHAPES:
            for dtype in ("float32", "bfloat16"):
                kernel_err[(shape, dtype)] = check_conv(
                    gen, dev, shape, dtype, "kernel conv3x3",
                    tf32_witness=shape == SERVING_SHAPE)
        laps("shapes")
        for shape in CONV_EDGE_SHAPES:
            kernel_err[(shape, "bfloat16")] = check_conv(
                gen, dev, shape, "bfloat16", "kernel conv3x3")
        laps("bf16 edge shapes")
        for shape in F32_EDGE_SHAPES:
            kernel_err[(shape, "float32")] = check_conv(
                gen, dev, shape, "float32", "kernel conv3x3")
        laps("f32 edge shapes")
        emit({"phase": "kernel conv3x3", "card": card,
              "part_seconds": laps.s})

    dk_err = {}
    with Phase("kernel conv3x3 dK"):
        for shape, dtype in ((s_, d_) for s_ in CONV_SHAPES + DK_EDGE_SHAPES
                             for d_ in ("float32", "bfloat16")):
            dk_err[shape, dtype] = check_dkernel(gen, dev, shape, dtype,
                                                 "kernel conv3x3 dK")
        for shape in DK_F32_EDGE_SHAPES:
            dk_err[shape, "float32"] = check_dkernel(gen, dev, shape,
                                                     "float32",
                                                     "kernel conv3x3 dK")

    # ------------------------------------------------------------ serve
    preset = replace(MNIST_COUNTERGAN, conv_impl="pallas")
    g_model, c_model = mnist_models(preset, generator=gen)
    randomize_batch_norms(g_model, gen)
    g_sd, c_sd = g_model.state_dict(), c_model.state_dict()

    def engine(dtype: str, plain: bool = False) -> CounterfactualEngine:
        return served_engine(preset, g_sd, c_sd, dev, dtype, plain)

    def images(b):
        return (torch.rand((b, 28, 28, 1), generator=gen) * 2 - 1).numpy()

    x1, x7, x128, x_bulk = images(1)[0], images(7), images(128), images(1000)
    t7 = np.arange(7) % 10
    t128 = torch.randint(0, 10, (128,), generator=gen).numpy()
    t_bulk = torch.randint(0, 10, (1000,), generator=gen).numpy()
    zeros = np.zeros_like(x128)

    def requests(e: CounterfactualEngine):
        """The served requests, and how many generator forwards they took."""
        m7 = e.mask_from_patches([0, 5, 10, 15], 7, (28, 28))
        out = {"b1": e.generate(x1, 3), "b7": e.generate(x7, t7, m7),
               "b128": e.generate(x128, t128),
               "zero_mask": e.generate(x128, t128, zeros),
               "bulk": e.generate_bulk(x_bulk, t_bulk, chunk=128)}
        return out, 4 + 8  # four generate calls, eight bulk chunks

    with Phase("serve"):
        served, launches = {}, {}
        for dtype in ("bfloat16", "float32"):
            for impl in ("pallas", "matmul"):
                e = engine(dtype, plain=impl == "matmul")
                conv3x3_same.launches = 0
                served[dtype, impl], forwards = requests(e)
                torch.cuda.synchronize()
                launches[dtype, impl] = conv3x3_same.launches
                want = KERNEL_LAYERS_PER_FORWARD * forwards
                if impl == "pallas" and launches[dtype, impl] != want:
                    fail(f"{dtype} serving launched the kernel "
                         f"{launches[dtype, impl]} times, not {want}")
                if impl == "matmul" and launches[dtype, impl] != 0:
                    fail("the plain-conv engine launched the kernel")
        for dtype in ("bfloat16", "float32"):
            ours, plain = served[dtype, "pallas"], served[dtype, "matmul"]
            report = {"phase": "serve", "dtype": dtype,
                      "kernel_launches": launches[dtype, "pallas"],
                      "launches_per_forward": KERNEL_LAYERS_PER_FORWARD,
                      "x_cf_atol": (F32_ATOL if dtype == "float32"
                                    else BF16_CF_ATOL),
                      "probs_atol": PROBS_ATOL[dtype]}
            compare_served(report, ours, plain, 10, dtype, "serve")
            zero = ours["zero_mask"]
            report["zero_mask_returns_x"] = bool(
                np.array_equal(zero.x_cf, x128) and not zero.residual.any())
            emit(report)
            if not report["zero_mask_returns_x"]:
                fail(f"{dtype}: an all-zero mask did not return x exactly")

    # ------------------------------------------- epilogue kernels vs plain
    epi_err = {"fwd": 0.0, "bwd": 0.0}
    epi_err_house = {"fwd": 0.0, "bwd": 0.0}  # at the house step's rows
    epi_err_moons = {"fwd": 0.0, "bwd": 0.0}  # at the moons step's rows
    # at the micro-batched step's chunk rows, by rows
    epi_err_chunk = {b: {"fwd": 0.0, "bwd": 0.0} for b in (64, 32)}
    with Phase("kernel cf_epilogue"):
        variants = set()
        for b, n, off in EPI_CASES:
            for lo, hi in EPI_BOUNDS:
                err = check_epilogue(gen, dev, b, n, off, lo, hi,
                                     "kernel cf_epilogue")
                variants.update(err["variant"].items())
                kept = [epi_err]
                if (b, n) == (TRAIN_BATCH, HOUSE_FEATURES):
                    kept.append(epi_err_house)
                if (b, n) == (MOONS_BATCH, 2):
                    kept.append(epi_err_moons)
                if n == 784 and b in epi_err_chunk and not off:
                    kept.append(epi_err_chunk[b])
                for e in kept:
                    for key in ("fwd", "bwd"):
                        e[key] = max(e[key], err[key])
        if variants != {(k, v) for k in ("fwd", "bwd")
                        for v in ("16-byte", "4-byte")}:
            fail(f"the epilogue kernels ran the variants {sorted(variants)}, "
                 "not both each")

    # ------------------------------------------------------------ train
    clf_sd = mnist_models(MNIST_COUNTERGAN, generator=gen)[1].state_dict()
    n_batches = TRAIN_STEPS
    train_x = (torch.rand((n_batches, TRAIN_BATCH, 28, 28, 1), generator=gen)
               * 2 - 1).to(dev)
    train_y = torch.randint(0, 10, (n_batches, TRAIN_BATCH),
                            generator=gen).to(dev)

    @contextlib.contextmanager
    def plain_epilogue():
        """The step's epilogue through its plain versions, on the card."""
        kernels = tep.cf_epilogue_fwd, tep.cf_epilogue_bwd
        tep.cf_epilogue_fwd = tep.cf_epilogue_fwd_plain
        tep.cf_epilogue_bwd = tep.cf_epilogue_bwd_plain
        try:
            yield
        finally:
            tep.cf_epilogue_fwd, tep.cf_epilogue_bwd = kernels

    def train(cfg, steps: int):
        """`steps` steps of a fresh bundle (initial weights from SEED) on
        the smoke's batches, targets and masks drawn by `step_fn` from a
        card generator seeded with SEED, so every run of a configuration
        sees the same draws.  Returns (bundle, [(d_loss, g_loss)], Adam's
        first moments after the first step by net and flax leaf path, so
        that runs whose convs hold their kernels in other layouts
        compare)."""
        bundle = build_mnist_countergan(cfg, clf_sd, seed=SEED)
        draws = torch.Generator(device=dev).manual_seed(SEED)
        losses = []
        for i in range(steps):
            m = bundle.step_fn(bundle.state, train_x[i % n_batches],
                               train_y[i % n_batches], draws)
            losses.append((m["d_loss"], m["g_loss"]))
            if i == 0:
                first_mu = {net: _flat(tree) for net, tree in
                            adam_moments_to_flax(bundle.state).items()}
        torch.cuda.synchronize()
        return bundle, [(d.item(), g.item()) for d, g in losses], first_mu

    def finite(bundle, losses) -> bool:
        return (all(math.isfinite(v) for pair in losses for v in pair)
                and all(bool(torch.isfinite(p).all()) for net in
                        (bundle.state.g, bundle.state.d)
                        for p in net.model.parameters()))

    with Phase("train"):
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        train_launches = {}
        for dtype, steps in (("bfloat16", TRAIN_STEPS),
                             ("float32", SHORT_STEPS)):
            cfg = replace(MNIST_COUNTERGAN, compute_dtype=dtype)
            zero_counts()
            bundle, losses, _ = train(cfg, steps)
            launched = counts()
            if launched != (steps, steps, 0, 0):
                fail(f"{dtype} training launched (fwd, bwd, conv, dK) = "
                     f"{launched}, not {(steps, steps, 0, 0)}")
            train_launches[dtype] = launched
            with plain_epilogue():
                plain_bundle, plain_losses, _ = train(cfg, steps)
            if counts() != launched:
                fail("the plain-epilogue run launched a kernel")
            errs = [max(abs(a - b) for a, b in zip(k, p))
                    for k, p in zip(losses, plain_losses)]
            ok = (max(errs) <= TRAIN_ATOL[dtype] and finite(bundle, losses)
                  and finite(plain_bundle, plain_losses))
            emit({"phase": "train", "dtype": dtype, "batch": TRAIN_BATCH,
                  "steps": steps, "epilogue_fwd_launches": launched[0],
                  "epilogue_bwd_launches": launched[1],
                  "d_g_loss_per_step": losses,
                  "plain_epilogue_d_g_loss_per_step": plain_losses,
                  "loss_max_abs_err_per_step": errs,
                  "tolerance": f"abs <= {TRAIN_ATOL[dtype]}", "ok": ok})
            if not ok:
                fail(f"{dtype} training with the epilogue kernels differs "
                     f"from the plain epilogue or is not finite: {errs}")

    with Phase("train pallas"):
        pallas_train_launches, pallas_bundles = {}, {}
        for dtype in ("bfloat16", "float32"):
            # one epilogue forward and backward a step, 13 forward and 13
            # dx launches of the conv kernel, and 13 of the dK kernel
            want = (SHORT_STEPS, SHORT_STEPS,
                    2 * KERNEL_LAYERS_PER_FORWARD * SHORT_STEPS,
                    KERNEL_LAYERS_PER_FORWARD * SHORT_STEPS)
            cfg = replace(MNIST_COUNTERGAN, conv_impl="pallas",
                          compute_dtype=dtype)
            zero_counts()
            bundle, losses, mu = train(cfg, SHORT_STEPS)
            pallas_launches = counts()
            pallas_bundles[dtype] = bundle
            if pallas_launches != want:
                fail(f"{dtype} conv_impl='pallas' training launched (fwd, "
                     f"bwd, conv, dK) = {pallas_launches}, not {want}")
            pallas_train_launches[dtype] = pallas_launches
            plain_bundle, plain_losses, plain_mu = train(
                replace(cfg, conv_impl="matmul"), SHORT_STEPS)
            if counts()[2:] != pallas_launches[2:]:
                fail("the plain-conv run launched the conv or dK kernel")
            errs = [max(abs(a - b) for a, b in zip(k, p))
                    for k, p in zip(losses, plain_losses)]
            report = {"phase": "train pallas", "dtype": dtype,
                      "steps": SHORT_STEPS,
                      "conv3x3_launches": pallas_launches[2],
                      "conv3x3_dk_launches": pallas_launches[3],
                      "launches_per_step": 2 * KERNEL_LAYERS_PER_FORWARD,
                      "d_g_loss_per_step": losses,
                      "plain_conv_d_g_loss_per_step": plain_losses,
                      "loss_max_abs_err_per_step": errs,
                      "loss_tolerance": f"abs <= {TRAIN_ATOL[dtype]}"}
            ok = (finite(bundle, losses) and finite(plain_bundle, plain_losses)
                  and max(errs) <= TRAIN_ATOL[dtype])
            ours = gan_state_to_flax(bundle.state)
            theirs = gan_state_to_flax(plain_bundle.state)
            for net, lr in (("g", cfg.lr_g), ("d", cfg.lr_d)):
                report[net], net_ok = moment_report(
                    mu[net], plain_mu[net], _flat(ours[net]["params"]),
                    _flat(theirs[net]["params"]), lr, dtype)
                ok = ok and net_ok
            report["ok"] = bool(ok)
            emit(report)
            if not ok:
                fail(f"{dtype} conv_impl='pallas' training differs from the "
                     f"plain conv")
        emit(exports_part(dev, pallas_bundles["bfloat16"], clf_sd,
                          train_x[0], train_y[0], counts, zero_counts))
        del pallas_bundles
        torch.backends.cudnn.deterministic = False

    # ------------------------------------------- training end to end
    with Phase("data"):
        (xtr, ytr), _, _ = data_phase(card)

    with Phase("epoch runner"):
        x_dev = torch.as_tensor(xtr).to(dev)
        y_dev = torch.as_tensor(ytr).to(dev, torch.long)
        runner_phase(card, dev, clf_sd, x_dev, y_dev, counts, zero_counts)
        del x_dev, y_dev

    with Phase("pipeline"):
        pipeline_phase(card, dev, counts, zero_counts, clf_sd, (xtr, ytr))

    with Phase("experiment"):
        experiment_phase(card, dev)

    # ------------------------------------------------ the legacy stack
    x_dev = torch.as_tensor(xtr).to(dev)
    y_dev = torch.as_tensor(ytr).to(dev, torch.long)
    with Phase("legacy train"):
        legacy_launches = legacy_train_phase(card, dev, x_dev, y_dev, counts,
                                             zero_counts, plain_epilogue)

    with Phase("legacy epoch runner"):
        legacy_runner_phase(card, dev, x_dev, y_dev, counts, zero_counts)

    with Phase("legacy experiment"):
        legacy_experiment_phase(card, dev)

    # ------------------------------------------------ the memory options
    with Phase("memory options"):
        chunk_launches, chunk_conv_launches = memory_phase(
            card, dev, x_dev, y_dev, clf_sd, counts, zero_counts,
            plain_epilogue)
    del x_dev, y_dev

    # ------------------------------ any image shape, class count, schema
    with Phase("custom shapes"):
        custom = custom_shapes_phase(card, dev, counts, zero_counts)

    with Phase("examples"):
        example_launches = examples_phase(card, dev, counts, zero_counts)

    # --------------------------------------------- the figures, on the card
    with Phase("figures"):
        figures = figures_phase(card, dev, counts, zero_counts)

    # ------------------------------------------ the house CounteRGAN
    with Phase("house data"):
        house = house_data_phase(card)

    with Phase("house train"):
        house_launches = mlp_train_phase(card, dev, "house", house, counts,
                                         zero_counts, plain_epilogue)

    with Phase("house epoch runner"):
        mlp_runner_phase(card, dev, "house", house, counts, zero_counts)

    house_dir = HERE / "build" / "smoke_house_experiment"
    try:
        with Phase("house experiment"):
            house_experiment_phase(card, dev, house_dir)
        with Phase("house serve"):
            house_serve_phase(card, dev, house, house_dir)
    finally:
        shutil.rmtree(house_dir, ignore_errors=True)

    # ------------------------------------------ the moons CounteRGAN
    with Phase("moons data"):
        moons = moons_data_phase(card)

    with Phase("moons train"):
        moons_launches = mlp_train_phase(card, dev, "moons", moons, counts,
                                         zero_counts, plain_epilogue)

    with Phase("moons epoch runner"):
        mlp_runner_phase(card, dev, "moons", moons, counts, zero_counts)

    with Phase("moons experiment"):
        moons_experiment_phase(card, dev)

    # ------------------------------------- the plain-generation GANs
    with Phase("gan train"):
        gan_train_phase(card, dev, (xtr, ytr), counts, zero_counts)

    with Phase("gan epoch runner"):
        gan_runner_phase(card, dev, (xtr, ytr))

    with Phase("generation"):
        generation_phase(card, dev)
    del xtr, ytr

    # ------------------------------------------ the serving front door
    with Phase("api"):
        api_phase(card, dev)

    # ---------------------------- the promptable front ends and migrate
    with Phase("apps"):
        app_paths = apps_phase(card, dev, counts, zero_counts)

    # ------------------------------------- the mesh and sharding layer
    with Phase("sharded"):
        sharded = sharded_phase(card, dev, counts, zero_counts,
                                sharded_ranks)

    # ----------------------------------------------------------- timing
    with Phase("timing"):
        # device time per call (kernel_ms): at batch 1 a launch is shorter
        # than the wrapper's host work, and CUDA events around back-to-back
        # calls would time the host
        timing = {}
        # the serving shapes in both dtypes; the micro chunks' in bf16,
        # the dtype of the memory options' pallas arms
        timed = [(s_, d_) for s_ in (SERVING_SHAPE, (1, 28, 28, 64, 64))
                 for d_ in ("bfloat16", "float32")]
        timed += [(s_, "bfloat16") for s_ in CHUNK_SHAPES]
        for shape, dtype in timed:
            timing[shape, dtype] = time_conv(card, gen, dev, shape, dtype,
                                             "timing")
        for shape, dtype in timed:
            timing["dk", shape, dtype] = time_dkernel(card, gen, dev, shape,
                                                      dtype, "timing")
        e = engine("bfloat16")
        for b, x, t in ((1, x1, 3), (128, x128, t128)):
            lat = host_ms(lambda: e.generate(x, t), 30)
            median = statistics.median(lat)
            busy_ms, top, _ = device_time(lambda: e.generate(x, t), 5)
            emit({"phase": "timing", "what": f"generate b={b}",
                  "card": card, "dtype": "bfloat16", "median_ms": median,
                  "p90_ms": sorted(lat)[int(0.9 * len(lat))],
                  "min_ms": min(lat), "device_busy_ms": busy_ms,
                  "device_idle_share": (None if busy_ms is None
                                        else 1 - busy_ms / median),
                  "device_time_by_kernel_ms": top})
        bulk = host_ms(lambda: e.generate_bulk(x_bulk, t_bulk, chunk=128), 5,
                       warmup=1)
        emit({"phase": "timing", "what": "generate_bulk 1000 rows chunk 128",
              "card": card, "dtype": "bfloat16",
              "median_ms": statistics.median(bulk),
              "counterfactuals_per_s": 1000 / statistics.median(bulk) * 1e3})

    with Phase("timing train"):
        time_train_steps(card, dev, clf_sd, train_x, train_y)
        epi = time_epilogue(card, dev)
        epi_house = time_epilogue(card, dev, n=HOUSE_FEATURES)
        epi_moons = time_epilogue(card, dev, n=2, b=MOONS_BATCH,
                                  bounds=(-1e30, 1e30))
        epi_chunk = {b: time_epilogue(card, dev, b=b) for b in (64, 32)}

    def entry(name, source, replaces, launched, err, t):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launched,
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]}

    conv_src = "cfgan_torch/csrc/conv3x3.cu"
    dk_src = "cfgan_torch/csrc/conv3x3_dkernel.cu"
    emit({"kernels": [
        entry("conv3x3_same", conv_src, "cfgan/ops/conv.py:71",
              launches["bfloat16", "pallas"],
              kernel_err[(SERVING_SHAPE, "bfloat16")],
              timing[SERVING_SHAPE, "bfloat16"]),
        entry("conv3x3_same_f32", conv_src, "cfgan/ops/conv.py:71",
              launches["float32", "pallas"],
              kernel_err[(SERVING_SHAPE, "float32")],
              timing[SERVING_SHAPE, "float32"]),
        entry("conv3x3_same_dkernel", dk_src, "cfgan/ops/conv.py:165",
              pallas_train_launches["bfloat16"][3],
              dk_err[SERVING_SHAPE, "bfloat16"],
              timing["dk", SERVING_SHAPE, "bfloat16"]),
        entry("conv3x3_same_dkernel_f32", dk_src, "cfgan/ops/conv.py:165",
              pallas_train_launches["float32"][3],
              dk_err[SERVING_SHAPE, "float32"],
              timing["dk", SERVING_SHAPE, "float32"]),
    ] + [
        # the conv and dK on the micro-batched step's chunks (bf16, the
        # pallas route): launches a step of g_microbatch 128 / B
        entry(f"{name}_micro_{shape[0]}", src, replaces,
              chunk_conv_launches[shape[0]][i], err[shape, "bfloat16"],
              timing[(*key, shape, "bfloat16")])
        for shape in CHUNK_SHAPES
        for i, (name, src, replaces, err, key) in enumerate((
            ("conv3x3_same", conv_src, "cfgan/ops/conv.py:71",
             kernel_err, ()),
            ("conv3x3_same_dkernel", dk_src, "cfgan/ops/conv.py:165",
             dk_err, ("dk",))))] + [
        entry(name, "cfgan_torch/csrc/epilogue.cu", replaces,
              train_launches["bfloat16"][k], epi_err[key], epi[name])
        for k, (name, key, replaces) in enumerate((
            ("cf_epilogue_fwd", "fwd", "cfgan/ops/epilogue.py:54"),
            ("cf_epilogue_bwd", "bwd", "cfgan/ops/epilogue.py:67")))] + [
        # the same kernels on the house path, at its (128, 17) rows
        entry(f"{name}_house_128x17", "cfgan_torch/csrc/epilogue.cu",
              replaces, house_launches[k], epi_err_house[key],
              epi_house[name])
        for k, (name, key, replaces) in enumerate((
            ("cf_epilogue_fwd", "fwd", "cfgan/ops/epilogue.py:54"),
            ("cf_epilogue_bwd", "bwd", "cfgan/ops/epilogue.py:67")))] + [
        # and on the moons path, at its (64, 2) rows, unclamped
        entry(f"{name}_moons_64x2", "cfgan_torch/csrc/epilogue.cu",
              replaces, moons_launches[k], epi_err_moons[key],
              epi_moons[name])
        for k, (name, key, replaces) in enumerate((
            ("cf_epilogue_fwd", "fwd", "cfgan/ops/epilogue.py:54"),
            ("cf_epilogue_bwd", "bwd", "cfgan/ops/epilogue.py:67")))] + [
        # on the legacy step's (128, 784) rows (all-ones masks)
        entry(f"{name}_legacy_128x784", "cfgan_torch/csrc/epilogue.cu",
              replaces, legacy_launches[k], epi_err[key], epi[name])
        for k, (name, key, replaces) in enumerate((
            ("cf_epilogue_fwd", "fwd", "cfgan/ops/epilogue.py:54"),
            ("cf_epilogue_bwd", "bwd", "cfgan/ops/epilogue.py:67")))] + [
        # on the micro-batched step's chunk rows: launches a step of
        # g_microbatch 128 / b
        entry(f"{name}_micro_{b}x784", "cfgan_torch/csrc/epilogue.cu",
              replaces, chunk_launches[b][k], epi_err_chunk[b][key],
              epi_chunk[b][name])
        for b in (64, 32)
        for k, (name, key, replaces) in enumerate((
            ("cf_epilogue_fwd", "fwd", "cfgan/ops/epilogue.py:54"),
            ("cf_epilogue_bwd", "bwd", "cfgan/ops/epilogue.py:67")))] + [
        # the conv and dK at 20x20 (the custom-shapes steps at batch 128
        # and 64, bf16 and f32: launches of CUSTOM_STEPS steps)
        entry(f"{name}_20x20_b{shape[0]}"
              + ("" if dtype == "bfloat16" else "_f32"), src, replaces,
              custom["launches"][dtype, shape[0]][i],
              custom[err][shape, dtype],
              custom["timing"][(*key, shape, dtype)])
        for shape in CUSTOM_CONV_SHAPES
        for dtype in ("bfloat16", "float32")
        for i, name, src, replaces, err, key in (
            (2, "conv3x3_same", conv_src, "cfgan/ops/conv.py:71",
             "conv_err", ()),
            (3, "conv3x3_same_dkernel", dk_src, "cfgan/ops/conv.py:165",
             "dk_err", ("dk",)))] + [
        # the epilogue at the image rows of those steps (bf16), and at the
        # credit example's (128, 7) rows
        entry(f"{name}_{b}x{n}", "cfgan_torch/csrc/epilogue.cu", replaces,
              (custom["launches"]["bfloat16", b] if n == 400 else
               example_launches["torch_custom_tabular"])[k],
              custom["epi_err"][b, n][key],
              custom["timing"]["epi", b, n][name])
        for b, n in CUSTOM_EPI_ROWS
        for k, (name, key, replaces) in enumerate((
            ("cf_epilogue_fwd", "fwd", "cfgan/ops/epilogue.py:54"),
            ("cf_epilogue_bwd", "bwd", "cfgan/ops/epilogue.py:67")))] + [
        # the conv at the figures' batches (bf16): the grid's 100 cells,
        # the heatmaps' 8 images and the patch-budget curve's 512 rows,
        # launches of the figure that runs it
        entry(f"conv3x3_same_figures_b{b}", conv_src, "cfgan/ops/conv.py:71",
              f["launches"], f["err"], f["timing"])
        for b, f in figures.items()] + [
        # the conv on the app and migrate paths (b=1: the chat's
        # transforms, bf16; the imported generator, f32)
        entry(name, conv_src, "cfgan/ops/conv.py:71", p["launches"],
              p["err"], p["timing"])
        for name, p in (("conv3x3_same_apps_chat_b1", app_paths["chat"]),
                        ("conv3x3_same_f32_migrate_b1",
                         app_paths["migrate"]))] + [
        # a rank's kernels in the sharded phase's world (b) and on its
        # 2-D mesh (d): the bf16 steps on its rows of the global batch of
        # 128 (64 at world 2)
        entry(f"{name}_{tag}_{sharded['rows']}" + suffix, src, replaces,
              sharded[layout][i], err, t)
        for layout, tag in (("launches", "sharded"),
                            ("launches_2d", "sharded2d"))
        for i, name, src, replaces, suffix, err, t in (
            (0, "cf_epilogue_fwd", "cfgan_torch/csrc/epilogue.cu",
             "cfgan/ops/epilogue.py:54", "x784",
             epi_err_chunk[sharded["rows"]]["fwd"],
             epi_chunk[sharded["rows"]]["cf_epilogue_fwd"]),
            (1, "cf_epilogue_bwd", "cfgan_torch/csrc/epilogue.cu",
             "cfgan/ops/epilogue.py:67", "x784",
             epi_err_chunk[sharded["rows"]]["bwd"],
             epi_chunk[sharded["rows"]]["cf_epilogue_bwd"]),
            (2, "conv3x3_same", conv_src, "cfgan/ops/conv.py:71", "",
             kernel_err[(sharded["rows"], 28, 28, 64, 64), "bfloat16"],
             timing[(sharded["rows"], 28, 28, 64, 64), "bfloat16"]),
            (3, "conv3x3_same_dkernel", dk_src, "cfgan/ops/conv.py:165", "",
             dk_err[(sharded["rows"], 28, 28, 64, 64), "bfloat16"],
             timing["dk", (sharded["rows"], 28, 28, 64, 64), "bfloat16"]))]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})


if __name__ == "__main__":
    main()
