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
  moments after the first step) of the same steps with the plain conv.

Then it times the kernels, their plain versions, cuDNN for the conv and
its weight gradient, the serving requests and the train step (bf16 with
cuDNN's convs and with the kernels, f32 with the kernels).

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
OUR_KERNELS = ("conv3x3_wgmma_kernel", "conv3x3_tf32_kernel",
               "conv3x3_tf32_split_kernel", "conv3x3_dkernel_wgmma_kernel",
               "conv3x3_dkernel_tf32_kernel", "dkernel_reduce_kernel",
               "epilogue_fwd_kernel", "epilogue_bwd_kernel")
# (B, H, W, Cin, Cout) the conv kernels are held at: the serving layer at
# batch 128 and 1 (the tensor-core kernel's narrow tiles); Cin not a
# multiple of 8 or 16 and W odd; Cin and Cout of the narrow test presets;
# a batch that is not a multiple of anything
SERVING_SHAPE = (128, 28, 28, 64, 64)
CONV_SHAPES = (SERVING_SHAPE, (1, 28, 28, 64, 64), (2, 13, 11, 20, 40),
               (3, 28, 28, 16, 24), (9, 7, 5, 32, 64))
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
EPI_CASES = ((128, 784, False), (257, 784, False), (3, 17, False),
             (5, 2, False), (64, 4096, False), (128, 784, True))
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


def kernel_ms(fn, iters: int = 20) -> tuple[float, str]:
    """(ms per call, how it was timed): profiler device time, which counts
    kernel time only; where the trace comes back without the card, the
    replays of a CUDA graph of the calls."""
    ms = device_time(fn, iters)[0]
    if ms is not None:
        return ms, "profiler"
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


def device_time(fn, iters: int, top: int = 5, match: tuple = ()):
    """(device ms per call, [(kernel, ms per call, launches per call)] of
    the `top` longest kernels, {name: (ms per call, launches per call)} of
    the kernels whose name holds a string of `match`) from a torch.profiler
    trace of `iters` calls of `fn`, counting device-side kernel events
    only; (None, [], {}) where the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(ev):
        return getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0.0))

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without the card
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        # device-side events only: a CPU op's entry repeats its kernels'
        # time, and so does a user annotation's range on the device (the
        # optimizer's)
        events = [ev for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA and dev_us(ev) > 0
                  and not getattr(ev, "is_user_annotation", False)]
        if events:
            break
    if not events:
        return None, [], {}
    events.sort(key=dev_us, reverse=True)
    longest = [(ev.key[:80], dev_us(ev) / 1e3 / iters, ev.count / iters)
               for ev in events[:top]]
    matched = {m: (sum(dev_us(ev) for ev in events if m in ev.key)
                   / 1e3 / iters,
                   sum(ev.count for ev in events if m in ev.key) / iters)
               for m in match}
    return sum(dev_us(ev) for ev in events) / 1e3 / iters, longest, matched


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


def time_epilogue(card: str, dev) -> dict:
    """Device ms per call (profiler) of the epilogue kernels and of their
    plain versions, and the wrappers' host-bound ms per call
    (`host_call_ms`), at the step's (128, 784) float32 rows: one line
    each.  Uses only what every checkout's `cfgan_torch.ops.epilogue`
    has, so `--train-timing-only` runs it on earlier commits too."""
    import torch

    from cfgan_torch.ops import epilogue as tep

    b, n = TRAIN_BATCH, 28 * 28
    x, raw = (torch.rand((b, n), device=dev) * 2 - 1 for _ in range(2))
    mask = (torch.rand((b, n), device=dev) > 0.5).float()
    gcf = torch.randn((b, n), device=dev)
    cols = [torch.randn((b,), device=dev) for _ in range(3)]
    epi = {}
    for name, kernel, plain, args, backward in (
            ("cf_epilogue_fwd", tep.cf_epilogue_fwd,
             tep.cf_epilogue_fwd_plain, (x, raw, mask, -1.0, 1.0), False),
            ("cf_epilogue_bwd", tep.cf_epilogue_bwd,
             tep.cf_epilogue_bwd_plain,
             (x, raw, mask, gcf, *cols, -1.0, 1.0), True)):
        bound_ms, bound_by = epilogue_bound(b, n, backward)
        # device time per call (kernel_ms): a few microseconds of kernel,
        # shorter than the wrapper's host-side work, so CUDA events around
        # back-to-back calls time the host
        (ms, how), (plain_ms, plain_how) = (
            kernel_ms(lambda: kernel(*args), 200),
            kernel_ms(lambda: plain(*args), 200))
        epi[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None)
        emit({"phase": "timing", "what": name, "card": card,
              "shape": (b, n), "dtype": "float32", **epi[name],
              "timed_by": sorted({how, plain_how}),
              "share_of_bound": bound_ms / ms,
              "host_bound_call_ms": host_call_ms(lambda: kernel(*args)),
              "plain_host_bound_call_ms": host_call_ms(lambda: plain(*args))})
    return epi


# the train steps `timing train` times: (compute dtype, conv_impl); None is
# the preset's cuDNN conv
TIMED_STEPS = (("bfloat16", None), ("bfloat16", "pallas"),
               ("float32", "pallas"))


def time_train_steps(card: str, dev, clf_sd: dict, train_x, train_y) -> None:
    """Wall time (20 steps after 3 of warm-up, each ending in a
    synchronize) and profiler device time (5 steps) of the preset's train
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
        busy_ms, top, ours = device_time(step, 5, top=8, match=OUR_KERNELS)
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


def main() -> None:
    import contextlib

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    if not (HERE / "cfgan_torch" / "__init__.py").is_file():
        fail(f"no cfgan_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(HERE))

    import torch.nn.functional as F

    from cfgan_torch.convert import adam_moments_to_flax, gan_state_to_flax
    from cfgan_torch.core.config import MNIST_COUNTERGAN
    from cfgan_torch.nn.layers import BatchNorm, Conv
    from cfgan_torch.ops import _build
    from cfgan_torch.ops import epilogue as tep
    from cfgan_torch.ops.conv import (
        conv3x3_same,
        conv3x3_same_dkernel,
        conv3x3_same_dkernel_plain,
        conv3x3_same_plain,
    )
    from cfgan_torch.serve.engine import CounterfactualEngine
    from cfgan_torch.train.builders import (
        build_mnist_countergan,
        build_mnist_serving,
        mnist_models,
    )

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
              "spills": spills})
        if spills:
            fail(f"a kernel spills registers: {spills}")

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

    # ----------------------------------------------- kernel vs plain
    def conv_inputs(b, h, w, cin, cout, dtype):
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

    @contextlib.contextmanager
    def tf32_matmuls():
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    kernel_err = {}
    with Phase("kernel conv3x3"):
        for shape in CONV_SHAPES:
            for dtype in ("float32", "bfloat16"):
                x, k = conv_inputs(*shape, getattr(torch, dtype))
                # dx: the cotangent through K read flipped and transposed
                g, _ = conv_inputs(*shape[:3], shape[4], shape[4],
                                   getattr(torch, dtype))
                got = conv3x3_same(x, k).float()
                got_t = conv3x3_same(g, k, transposed=True).float()
                ref = conv3x3_same_plain(x.float(), k.float())
                ref_t = conv3x3_same_plain(
                    g.float(), k.float().flip(0, 1).transpose(2, 3)
                    .contiguous())
                torch.cuda.synchronize()
                ok, tol = conv_ok(got, ref, dtype)
                ok_t, _ = conv_ok(got_t, ref_t, dtype)
                if dtype == "bfloat16":
                    ref, ref_t = ref.bfloat16().float(), ref_t.bfloat16().float()
                err = (got - ref).abs().max().item()
                err_t = (got_t - ref_t).abs().max().item()
                rel = ((got - ref).abs() / ref.abs().clamp_min(1e-3)).max()
                report = {"phase": "kernel conv3x3", "shape": shape,
                          "dtype": dtype, "max_abs_err": err,
                          "max_rel_err": rel.item(), "dx_max_abs_err": err_t,
                          "tolerance": tol}
                if dtype == "float32":
                    # one tf32 product: the plain version's matmuls, TF32 on
                    with tf32_matmuls():
                        tf32 = conv3x3_same_plain(x, k)
                    report.update(
                        max_row_rel_err=row_rel_err(got, ref),
                        dx_max_row_rel_err=row_rel_err(got_t, ref_t),
                        tf32_matmul_max_row_rel_err=row_rel_err(tf32, ref),
                        tf32_matmul_max_abs_err=(tf32 - ref).abs().max()
                        .item())
                    if (shape == SERVING_SHAPE and
                            report["tf32_matmul_max_row_rel_err"]
                            <= F32_ROW_RTOL):
                        fail("the TF32 matmul meets the f32 row bar: the bar "
                             "no longer tells 3xTF32 from one tf32 product")
                report["ok"] = ok and ok_t
                emit(report)
                if not (ok and ok_t) or not (torch.isfinite(got).all()
                                             and torch.isfinite(got_t).all()):
                    fail(f"conv3x3 kernel disagrees with its plain version "
                         f"at {shape} {dtype}: max abs err {err}, dx {err_t}")
                kernel_err[(shape, dtype)] = max(err, err_t)

    dk_err = {}
    with Phase("kernel conv3x3 dK"):
        for shape, dtype in ((s_, d_) for s_ in CONV_SHAPES
                             for d_ in ("float32", "bfloat16")):
            x, _ = conv_inputs(*shape, getattr(torch, dtype))
            g, _ = conv_inputs(*shape[:3], shape[4], shape[4],
                               getattr(torch, dtype))
            got = conv3x3_same_dkernel(x, g)
            again = conv3x3_same_dkernel(x, g)
            ref = conv3x3_same_dkernel_plain(x, g)
            torch.cuda.synchronize()
            norm = ref.reshape(9, -1).norm(dim=1)
            rel = ((got - ref).reshape(9, -1).norm(dim=1)
                   / norm.clamp_min(1e-30))
            same_bits = torch.equal(got, again)
            ok = (bool((rel <= DK_RTOL).all()) and same_bits
                  and got.dtype == torch.float32
                  and bool(torch.isfinite(got).all()))
            err = (got - ref).abs().max().item()
            emit({"phase": "kernel conv3x3 dK", "shape": shape,
                  "dtype": dtype, "max_abs_err": err,
                  "max_tap_rel_err": rel.max().item(),
                  "two_calls_equal_bits": same_bits,
                  "tolerance": f"per tap: 2-norm of the error <= {DK_RTOL}"
                               f" of the plain dK's (float32 sums of up to "
                               f"B*H*W products in another order)",
                  "ok": ok})
            if not ok:
                fail(f"conv3x3 dK kernel disagrees with its plain version at "
                     f"{shape} {dtype}: per-tap rel err {rel.max().item()}, "
                     f"equal bits over two calls {same_bits}")
            dk_err[shape, dtype] = err

    # ------------------------------------------------------------ serve
    preset = replace(MNIST_COUNTERGAN, conv_impl="pallas")
    g_model, c_model = mnist_models(preset, generator=gen)
    for bn in g_model.modules():  # non-trivial served BatchNorm statistics
        if isinstance(bn, BatchNorm):
            n = bn.running_mean.shape[0]
            bn.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
            bn.running_var.copy_(0.5 + torch.rand(n, generator=gen))
            bn.weight.data.copy_(0.5 + torch.rand(n, generator=gen))
            bn.bias.data.copy_(0.1 * torch.randn(n, generator=gen))
    g_sd, c_sd = g_model.state_dict(), c_model.state_dict()

    def engine(dtype: str, plain: bool = False) -> CounterfactualEngine:
        """The served preset at `dtype`; `plain=True` switches the layers
        routed to the kernel over to its plain version, and nothing else."""
        cfg = replace(preset, compute_dtype=dtype)
        s = build_mnist_serving(cfg, g_sd, c_sd, device=dev)
        routed = [m for m in s.generator.modules()
                  if isinstance(m, Conv) and m.impl == "pallas"]
        if len(routed) != KERNEL_LAYERS_PER_FORWARD:
            fail(f"{len(routed)} generator layers routed to the kernel, "
                 f"not {KERNEL_LAYERS_PER_FORWARD}")
        for m in routed if plain else ():
            m.impl = "matmul"
        return CounterfactualEngine(s.cf_fn, s.clf_fn, s.num_classes,
                                    patch_size=cfg.mask.patch_size,
                                    device=dev)

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
            cf_atol = F32_ATOL if dtype == "float32" else BF16_CF_ATOL
            report = {"phase": "serve", "dtype": dtype,
                      "kernel_launches": launches[dtype, "pallas"],
                      "launches_per_forward": KERNEL_LAYERS_PER_FORWARD,
                      "x_cf_atol": cf_atol,
                      "probs_atol": PROBS_ATOL[dtype]}
            for name, r in ours.items():
                p = plain[name]
                shape_ok = (r.x_cf.shape == p.x_cf.shape
                            and r.probs.shape == (p.x_cf.shape[0], 10)
                            and np.isfinite(r.x_cf).all()
                            and np.isfinite(r.probs).all())
                cf_err = float(np.abs(r.x_cf - p.x_cf).max())
                pr_err = float(np.abs(r.probs - p.probs).max())
                report[name] = {"rows": int(r.x_cf.shape[0]),
                                "x_cf_max_abs_err": cf_err,
                                "probs_max_abs_err": pr_err,
                                "flip_rate": float(r.flipped.mean())}
                if not shape_ok:
                    fail(f"{dtype} {name}: bad shape or non-finite values")
                if cf_err > cf_atol or pr_err > PROBS_ATOL[dtype]:
                    fail(f"{dtype} {name}: kernel engine differs from the "
                         f"plain-conv engine (x_cf {cf_err}, probs {pr_err})")
            zero = ours["zero_mask"]
            report["zero_mask_returns_x"] = bool(
                np.array_equal(zero.x_cf, x128) and not zero.residual.any())
            emit(report)
            if not report["zero_mask_returns_x"]:
                fail(f"{dtype}: an all-zero mask did not return x exactly")

    # ------------------------------------------- epilogue kernels vs plain
    def misaligned(t):
        """A contiguous copy of `t` one element into its storage."""
        view = torch.empty(t.numel() + 1, device=t.device)[1:].view(t.shape)
        return view.copy_(t)

    epi_err = {"fwd": 0.0, "bwd": 0.0}
    with Phase("kernel cf_epilogue"):
        variants = set()
        for b, n, off in EPI_CASES:
            for lo, hi in EPI_BOUNDS:
                x = torch.rand((b, n), generator=gen) * 2.4 - 1.2
                raw = torch.randn((b, n), generator=gen) * 0.4
                mask = (torch.rand((b, n), generator=gen) > 0.5).float()
                raw[:, ::5] = 0.0  # sign(0) in the backward
                x[:, 1::5], mask[:, 1::5] = 1.0, 0.0  # u exactly on hi ...
                x[:, 2::5], raw[:, 2::5] = -1.0, 0.0  # ... and on lo
                gcf = torch.randn((b, n), generator=gen)
                cols = [torch.randn((b,), generator=gen) for _ in range(3)]
                x, raw, mask, gcf, *cols = (t.to(dev) for t in
                                            (x, raw, mask, gcf, *cols))
                if off:
                    x, raw, mask, gcf = map(misaligned, (x, raw, mask, gcf))
                got = tep.cf_epilogue_fwd(x, raw, mask, lo, hi)
                ref = tep.cf_epilogue_fwd_plain(x, raw, mask, lo, hi)
                got_b = tep.cf_epilogue_bwd(x, raw, mask, gcf, *cols, lo, hi)
                # the variant each wrapper passed to its kernel
                variant = {k: "16-byte" if f.last_float4 else "4-byte"
                           for k, f in (("fwd", tep.cf_epilogue_fwd),
                                        ("bwd", tep.cf_epilogue_bwd))}
                variants.update(variant.items())
                ref_b = tep.cf_epilogue_bwd_plain(x, raw, mask, gcf, *cols,
                                                  lo, hi)
                torch.cuda.synchronize()
                cf_err = (got[0] - ref[0]).abs().max().item()
                sum_err = max(((g - r).abs() / r.abs().clamp_min(1e-30))
                              .max().item() for g, r in zip(got[1:], ref[1:]))
                sum_abs = max((g - r).abs().max().item()
                              for g, r in zip(got[1:], ref[1:]))
                dx_err, draw_err = ((g - r).abs().max().item()
                                    for g, r in zip(got_b, ref_b))
                ok = (max(cf_err, dx_err, draw_err) <= EPI_ATOL
                      and sum_err <= EPI_SUM_RTOL
                      and all(torch.isfinite(t).all() for t in (*got, *got_b)))
                emit({"phase": "kernel cf_epilogue", "shape": (b, n),
                      "misaligned": off, "variant": variant,
                      "lo": lo, "hi": hi, "x_cf_max_abs_err": cf_err,
                      "sums_max_rel_err": sum_err, "sums_max_abs_err": sum_abs,
                      "dx_max_abs_err": dx_err, "draw_max_abs_err": draw_err,
                      "tolerance": f"x_cf, dx, draw abs <= {EPI_ATOL}; sums "
                                   f"rel <= {EPI_SUM_RTOL}", "ok": ok})
                if not ok:
                    fail(f"cf_epilogue kernels disagree with their plain "
                         f"versions at {(b, n)} {variant}, bounds "
                         f"{(lo, hi)}")
                epi_err["fwd"] = max(epi_err["fwd"], cf_err, sum_abs)
                epi_err["bwd"] = max(epi_err["bwd"], dx_err, draw_err)
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

    def counts():
        return (tep.cf_epilogue_fwd.launches, tep.cf_epilogue_bwd.launches,
                conv3x3_same.launches, conv3x3_same_dkernel.launches)

    def zero_counts():
        tep.cf_epilogue_fwd.launches = tep.cf_epilogue_bwd.launches = 0
        conv3x3_same.launches = conv3x3_same_dkernel.launches = 0

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
        pallas_train_launches = {}
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
                rel = {name: float(np.linalg.norm(m - plain_mu[net][name])
                                   / np.linalg.norm(plain_mu[net][name]))
                       for name, m in mu[net].items()
                       if not name.endswith("bias")}
                worst = max(rel, key=rel.get)
                p_ours = _flat(ours[net]["params"])
                p_theirs = _flat(theirs[net]["params"])
                if p_ours.keys() != p_theirs.keys():
                    fail(f"{net}: the two runs hold other parameters")
                diff = np.concatenate([np.abs(p_ours[k] - p_theirs[k]).ravel()
                                       for k in p_ours])
                share = float((diff > lr / 10).mean())
                report[net] = {"first_moment_worst_rel_err": rel[worst],
                               "worst_leaf": worst,
                               "first_moment_rtol": PALLAS_MU_RTOL[dtype],
                               "param_max_abs_diff": float(diff.max()),
                               "share_over_lr_10": share}
                ok = ok and rel[worst] <= PALLAS_MU_RTOL[dtype]
                if dtype == "float32":
                    report[net]["share_bound"] = PALLAS_F32_OUTLIER_SHARE
                    ok = ok and share <= PALLAS_F32_OUTLIER_SHARE
            report["ok"] = bool(ok)
            emit(report)
            if not ok:
                fail(f"{dtype} conv_impl='pallas' training differs from the "
                     f"plain conv")
        torch.backends.cudnn.deterministic = False

    # ----------------------------------------------------------- timing
    with Phase("timing"):
        # device time per call (kernel_ms): at batch 1 a launch is shorter
        # than the wrapper's host work, and CUDA events around back-to-back
        # calls would time the host
        timed_by = set()

        def dev_ms(fn):
            ms, how = kernel_ms(fn)
            timed_by.add(how)
            return ms

        timing = {}
        for shape in (SERVING_SHAPE, (1, 28, 28, 64, 64)):
            for dtype in ("bfloat16", "float32"):
                x, k = conv_inputs(*shape, getattr(torch, dtype))
                x_nchw = x.permute(0, 3, 1, 2)  # channels-last view, no copy
                w_oihw = k.permute(3, 2, 0, 1).contiguous()
                ms = dev_ms(lambda: conv3x3_same(x, k))
                plain_ms = dev_ms(lambda: conv3x3_same_plain(x, k))
                lib_ms = dev_ms(lambda: F.conv2d(x_nchw, w_oihw, padding=1))
                bound_ms, bound_by, nbytes, ops = conv_bound(*shape, dtype)
                timing[shape, dtype] = dict(
                    ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bound_ms, bound_by=bound_by)
                emit({"phase": "timing", "what": "conv3x3", "card": card,
                      "shape": shape, "dtype": dtype, "ms": ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms,
                      "library": "F.conv2d (cuDNN, TF32 off; its weight "
                                 "re-layout kernel included; in f32 `ms` "
                                 "includes K's split)",
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "bytes": nbytes, "operations": ops,
                      "share_of_bound": bound_ms / ms,
                      "tflops": ops / ms / 1e9,
                      "timed_by": sorted(timed_by),
                      "events_call_ms": cuda_ms(lambda: conv3x3_same(x, k),
                                                50)})
        for shape, dtype in ((s_, d_) for s_ in (SERVING_SHAPE,
                                                 (1, 28, 28, 64, 64))
                             for d_ in ("bfloat16", "float32")):
            x, _ = conv_inputs(*shape, getattr(torch, dtype))
            g, _ = conv_inputs(*shape[:3], shape[4], shape[4],
                               getattr(torch, dtype))
            x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            w_shape = (shape[4], shape[3], 3, 3)
            bound_ms, bound_by = dkernel_bound(*shape, dtype)
            dk = timing["dk", shape, dtype] = dict(
                ms=dev_ms(lambda: conv3x3_same_dkernel(x, g)),
                plain_ms=dev_ms(lambda: conv3x3_same_dkernel_plain(x, g)),
                library_ms=dev_ms(lambda: torch.nn.grad.conv2d_weight(
                    x_nchw, w_shape, g_nchw, padding=1)),
                bound_ms=bound_ms, bound_by=bound_by)
            emit({"phase": "timing", "what": "conv3x3 dK", "card": card,
                  "shape": shape, "dtype": dtype, **dk,
                  "library": "torch.nn.grad.conv2d_weight (cuDNN wgrad, "
                             "channels-last, TF32 off)",
                  "timed_by": sorted(timed_by),
                  "share_of_bound": bound_ms / dk["ms"]})
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
        entry(name, "cfgan_torch/csrc/epilogue.cu", replaces,
              train_launches["bfloat16"][k], epi_err[key], epi[name])
        for k, (name, key, replaces) in enumerate((
            ("cf_epilogue_fwd", "fwd", "cfgan/ops/epilogue.py:54"),
            ("cf_epilogue_bwd", "bwd", "cfgan/ops/epilogue.py:67")))]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})


if __name__ == "__main__":
    main()
