#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`cfgan_torch`) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one
                                 # CUDA card and nvcc (CUDA_HOME or PATH)

It builds the port's CUDA kernel from the sources in the checkout, holds
the kernel against its plain PyTorch version on the card, then serves
MNIST counterfactuals through the port's entry points
(`build_mnist_serving`, `CounterfactualEngine`) at the full width of the
shipped MNIST CounteRGAN preset (64 channels, 6 residual blocks, bf16
compute) with `conv_impl="pallas"`, on random weights made from a seed.
It checks that every generator forward launched the kernel 13 times, that
the served results equal the same requests served with the plain conv on
the card, and that an all-zero mask returns x bit for bit; then it times
the kernel, its plain version, cuDNN on the same shapes, and the serving
requests.

Each phase prints one JSON line and its wall time.  The line before the
last is the card's `nvidia-smi` name and power limit; the last line is
`{"ok": true, "device": {...}}`.  Any failure exits non-zero before that
line is printed, as does a host with no CUDA card or a directory without
the `cfgan_torch` package beside this script.
"""
from __future__ import annotations

import json
import math
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
                  "float32": 67e12}  # outside the tensor cores
# kernel vs plain version: f32 abs <= F32_ATOL (the two sum in other
# orders); bf16 within one bf16 ulp of the plain result rounded to bf16,
# plus F32_ATOL for the float32 sums' own difference, which decides the
# rounding where a sum nearly cancels
F32_ATOL = 1e-4
# bf16 serving, kernel vs plain: the two round the same float32 sums to bf16
# and may differ by one ulp where a sum lies near a rounding boundary; that
# spreads through the later layers.  Allowed: one bf16 ulp at |x_cf| = 1,
# the edge of the clamp.
BF16_CF_ATOL = 2.0 ** -7
PROBS_ATOL = {"float32": 1e-4, "bfloat16": 1e-2}
KERNEL_LAYERS_PER_FORWARD = 13  # 12 resblock convs + conv_mid


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


def device_time(fn, iters: int):
    """(device ms per call, [(kernel, ms per call, launches per call)] of
    the five longest kernels) from a torch.profiler trace of `iters` calls
    of `fn`, counting device-side events only; (None, []) where the trace
    holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    def dev_us(ev):
        return getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0.0))

    # device-side events only: a CPU op's entry repeats its kernels' time
    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA and dev_us(ev) > 0]
    if not events:
        return None, []
    events.sort(key=dev_us, reverse=True)
    top = [(ev.key[:80], dev_us(ev) / 1e3 / iters, ev.count / iters)
           for ev in events[:5]]
    return sum(dev_us(ev) for ev in events) / 1e3 / iters, top


def conv_bound(b, h, w, cin, cout, dtype: str):
    """(bound_ms, bound_by, bytes, operations) of one 3x3 SAME conv on an
    H100 SXM: input, kernel and output each moved once, 2 * MACs at the
    dtype's peak."""
    from cfgan_torch.ops.conv import conv_flops

    elt = 2 if dtype == "bfloat16" else 4
    nbytes = (b * h * w * (cin + cout) + 9 * cin * cout) * elt
    ops = conv_flops(b, (h, w), cin, cout)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    if not (HERE / "cfgan_torch" / "__init__.py").is_file():
        fail(f"no cfgan_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(HERE))

    import torch.nn.functional as F

    from cfgan_torch.core.config import MNIST_COUNTERGAN
    from cfgan_torch.nn.layers import BatchNorm, Conv
    from cfgan_torch.ops import _build
    from cfgan_torch.ops.conv import conv3x3_same, conv3x3_same_plain
    from cfgan_torch.serve.engine import CounterfactualEngine
    from cfgan_torch.train.builders import build_mnist_serving, mnist_models

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
                                          "spill", "smem"))]
        emit({"phase": "build", "seconds": round(lib.seconds, 3),
              "library": str(lib.path.relative_to(HERE)), "ptxas": ptxas})

    # ----------------------------------------------- kernel vs plain
    def conv_inputs(b, h, w, cin, cout, dtype):
        x = torch.randn((b, h, w, cin), generator=gen)
        k = torch.randn((3, 3, cin, cout), generator=gen) * math.sqrt(
            2 / 1.04 / (9 * cin))  # the generator's kaiming init
        return x.to(dev, dtype), k.to(dev, dtype)

    serving_shape = (128, 28, 28, 64, 64)
    kernel_err = {}
    with Phase("kernel conv3x3"):
        for shape in (serving_shape, (3, 28, 28, 16, 24), (9, 7, 5, 32, 64)):
            for dtype in ("float32", "bfloat16"):
                x, k = conv_inputs(*shape, getattr(torch, dtype))
                got = conv3x3_same(x, k).float()
                ref = conv3x3_same_plain(x.float(), k.float())
                torch.cuda.synchronize()
                if dtype == "bfloat16":
                    ref = ref.bfloat16().float()
                    tol = (f"1 bf16 ulp of the plain f32 result rounded to "
                           f"bf16, + {F32_ATOL}")
                    ok = bool(((got - ref).abs()
                               <= bf16_ulp(ref) + F32_ATOL).all())
                else:
                    tol = f"abs <= {F32_ATOL}"
                    ok = (got - ref).abs().max().item() <= F32_ATOL
                err = (got - ref).abs().max().item()
                rel = ((got - ref).abs() / ref.abs().clamp_min(1e-3)).max()
                emit({"phase": "kernel conv3x3", "shape": shape,
                      "dtype": dtype, "max_abs_err": err,
                      "max_rel_err": rel.item(), "tolerance": tol, "ok": ok})
                if not ok or not torch.isfinite(got).all():
                    fail(f"conv3x3 kernel disagrees with its plain version "
                         f"at {shape} {dtype}: max abs err {err}")
                kernel_err[(shape, dtype)] = err

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

    # ----------------------------------------------------------- timing
    with Phase("timing"):
        timing = {}
        for dtype in ("bfloat16", "float32"):
            x, k = conv_inputs(*serving_shape, getattr(torch, dtype))
            x_nchw = x.permute(0, 3, 1, 2)  # channels-last view, no copy
            w_oihw = k.permute(3, 2, 0, 1).contiguous()
            ms = cuda_ms(lambda: conv3x3_same(x, k), 50)
            plain_ms = cuda_ms(lambda: conv3x3_same_plain(x, k), 50)
            lib_ms = cuda_ms(lambda: F.conv2d(x_nchw, w_oihw, padding=1), 50)
            bound_ms, bound_by, nbytes, ops = conv_bound(*serving_shape, dtype)
            timing[dtype] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                 bound_ms=bound_ms, bound_by=bound_by)
            emit({"phase": "timing", "what": "conv3x3", "card": card,
                  "shape": serving_shape, "dtype": dtype, "ms": ms,
                  "plain_ms": plain_ms, "library_ms": lib_ms,
                  "library": "F.conv2d (cuDNN, TF32 off)",
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "bytes": nbytes, "operations": ops,
                  "share_of_bound": bound_ms / ms,
                  "tflops": ops / ms / 1e9})
        e = engine("bfloat16")
        for b, x, t in ((1, x1, 3), (128, x128, t128)):
            lat = host_ms(lambda: e.generate(x, t), 30)
            median = statistics.median(lat)
            busy_ms, top = device_time(lambda: e.generate(x, t), 5)
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

    t = timing["bfloat16"]
    emit({"kernels": [{
        "name": "conv3x3_same", "route": "cuda",
        "source": "cfgan_torch/csrc/conv3x3.cu",
        "replaces": "cfgan/ops/conv.py:71",
        "launches": launches["bfloat16", "pallas"],
        "max_abs_err": kernel_err[(serving_shape, "bfloat16")],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})


if __name__ == "__main__":
    main()
