#!/usr/bin/env python3
"""Time the conv kernels (`cfgan_torch/csrc/conv3x3.cu`) of two checkouts
in turns on one CUDA card, forward and dx, in bf16 or float32.

    python3 tools/conv_ab.py --parent DIR [--dtype bfloat16|float32]
                             [--turns 2] [--out FILE]

DIR is another checkout of this repository, for example the parent commit
unpacked with `git archive` into a directory that `.gitignore` lists (only
its `cfgan_torch/csrc/` is read).  Each tree's `conv3x3.cu` is built
alone into `build/conv_ab/` of this checkout (`tools/ab_common.py`).  Both
take the same inputs, made from a seed.

The build line gives each build's conv entries (registers, spills) and
whether the bf16 kernels' SASS is the same in both builds.  At each shape,
the forward conv and its dx form (K read flipped and transposed):
- each kernel against the plain version (`conv3x3_same_plain`) at the card
  tests' bar (bf16: one bf16 ulp of the float32 sum rounded to bf16, plus
  `chip_smoke.F32_ATOL`; float32: abs `chip_smoke.F32_ATOL` and each
  pixel's row within `chip_smoke.F32_ROW_RTOL`), and the same bits over
  two calls; the run fails otherwise;
- `--turns` rounds of parent, change, cuDNN (`F.conv2d`, or for dx
  `torch.nn.grad.conv2d_input`, channels-last, TF32 off), change, parent,
  each timed by the profiler (`chip_smoke.kernel_ms`: device time only; a
  float32 call is K's split and the conv, its workspace allocated in the
  call as the wrapper does);
- the bound (`chip_smoke.conv_bound`) and each median's share of it, each
  call's host-bound time (CUDA events around back-to-back calls,
  `chip_smoke.host_call_ms`), and the change's launch plan where it has
  one (`cfgan_conv3x3_plan`, `cfgan_conv3x3_f32_plan`).

One JSON line a measurement and a summary line a shape, each with the
card's `nvidia-smi` name and power limit; the last line is {"ok": true}.
Needs one card and nvcc; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (B, H, W, Cin, Cout): the step's batch, the micro-batched chunks, the
# figures' heatmaps (8), serving's b=1, the figures' grid (100) and
# patch-budget curve (512), and the 20x20 preset's batches
SHAPES = ((128, 28, 28, 64, 64), (64, 28, 28, 64, 64), (32, 28, 28, 64, 64),
          (8, 28, 28, 64, 64), (1, 28, 28, 64, 64), (100, 28, 28, 64, 64),
          (512, 28, 28, 64, 64), (128, 20, 20, 64, 64),
          (64, 20, 20, 64, 64))
ENTRY_POINTS = ("cfgan_conv3x3_bf16", "cfgan_conv3x3_plan",
                "cfgan_conv3x3_f32", "cfgan_conv3x3_f32_workspace",
                "cfgan_conv3x3_f32_plan")
# the bf16 kernels, whose SASS the two builds should share
BF16_KERNELS = r"conv3x3_wgmma(_ws)?_kernel"


def caller(lib: ctypes.CDLL, x, k, transposed: bool):
    """A call of `lib`'s conv of x with k at x's dtype (dx form: k flipped
    and transposed, read in place), into one output tensor; in float32
    the call allocates K's workspace, as the wrapper does."""
    import torch

    b, h, w, cin = x.shape
    cout = k.shape[2] if transposed else k.shape[3]
    y = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        if x.dtype == torch.float32:
            floats = lib.cfgan_conv3x3_f32_workspace(cin, cout)
            ws = torch.empty(floats, dtype=torch.float32, device=x.device)
            err = lib.cfgan_conv3x3_f32(x.data_ptr(), k.data_ptr(),
                                        y.data_ptr(), ws.data_ptr(), b, h, w,
                                        cin, cout, int(transposed), floats,
                                        stream)
        else:
            err = lib.cfgan_conv3x3_bf16(x.data_ptr(), k.data_ptr(),
                                         y.data_ptr(), b, h, w, cin, cout,
                                         int(transposed), stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return y
    return call


def plan(lib: ctypes.CDLL, shape, transposed: bool, dtype: str
         ) -> dict | None:
    """`lib`'s launch plan at the call's (B, H, W, Cin, Cout), where it has
    the entry point."""
    from cfgan_torch.ops.conv import _CONV_F32_PLAN_KEYS, _CONV_PLAN_KEYS

    f32 = dtype == "float32"
    entry = "cfgan_conv3x3_f32_plan" if f32 else "cfgan_conv3x3_plan"
    if not hasattr(lib, entry):
        return None
    keys = _CONV_F32_PLAN_KEYS if f32 else _CONV_PLAN_KEYS
    out = (ctypes.c_int * len(keys))()
    args = shape if f32 else (*shape, int(transposed))
    err = getattr(lib, entry)(*args, out)
    return dict(zip(keys, out)) if err == 0 else {"error": err}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="another checkout of this repository")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the lines to this file")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from cfgan_torch.ops.conv import conv3x3_same_plain
    from tools import ab_common as ab

    if not torch.cuda.is_available():
        sys.exit("conv_ab: needs a CUDA card")
    emit = ab.Lines(ab.card_name(), args.out)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = ROOT / "build" / "conv_ab"
    built = ab.build({"parent": args.parent.resolve(), "change": ROOT},
                     "conv3x3.cu", out_dir, ENTRY_POINTS)
    libs = {name: lib for name, (lib, _) in built.items()}
    sass = {name: ab.sass(out_dir / f"lib{name}.so", BF16_KERNELS)
            for name in built}
    emit({"build": {name: [ln.strip() for ln in log.splitlines()
                           if "conv3x3_wgmma" in ln or "conv3x3_tf32" in ln
                           or "registers" in ln or "spill" in ln]
                    for name, (_, log) in built.items()},
          "bf16_sass_equal": {
              name: code == sass["parent"].get(name)
              for name, code in sass["change"].items()},
          "bf16_sass_kernels": {name: len(s) for name, s in sass.items()}})
    dt = getattr(torch, args.dtype)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED)
    for shape in SHAPES:
        b, h, w, cin, cout = shape
        for transposed in (False, True):
            direction = "dx" if transposed else "fwd"
            x, k = cs.make_conv_inputs(gen, dev, *shape, dt)
            if transposed:  # the cotangent, channels Cout; K read flipped
                x, _ = cs.make_conv_inputs(gen, dev, b, h, w, cout, cin, dt)
            kk = (k.float().flip(0, 1).transpose(2, 3).contiguous()
                  if transposed else k.float())
            ref = conv3x3_same_plain(x.float(), kk)
            for name, lib in libs.items():
                call = caller(lib, x, k, transposed)
                got, again = call().clone(), call().clone()
                torch.cuda.synchronize()
                ok, tol = cs.conv_ok(got.float(), ref, args.dtype)
                same = torch.equal(got, again)
                want = ref.bfloat16().float() if dt == torch.bfloat16 else ref
                err = (got.float() - want).abs().max()
                line = {"check": name, "shape": shape,
                        "direction": direction, "dtype": args.dtype,
                        "max_abs_err": err.item(), "tolerance": tol,
                        "two_calls_equal_bits": same, "ok": ok and same}
                if dt == torch.float32:
                    line["max_row_rel_err"] = cs.row_rel_err(got, ref)
                emit(line)
                if not (ok and same):
                    sys.exit(f"conv_ab: {name} disagrees with the plain "
                             f"conv at {shape} {direction}")
            x_nchw = x.permute(0, 3, 1, 2)  # channels-last views, no copy
            w_oihw = k.permute(3, 2, 0, 1).contiguous()
            if transposed:
                def cudnn():
                    return torch.nn.grad.conv2d_input(
                        (b, cin, h, w), w_oihw, x_nchw, padding=1)
            else:
                def cudnn():
                    return F.conv2d(x_nchw, w_oihw, padding=1)
            fns = {"parent": caller(libs["parent"], x, k, transposed),
                   "change": caller(libs["change"], x, k, transposed),
                   "cudnn": cudnn}
            bound_ms, bound_by, _, ops = cs.conv_bound(*shape, args.dtype)
            floor = cs._bound(0, ops, args.dtype)[0]

            def timer(fn):
                return (*cs.kernel_ms(fn, floor_ms=floor), {})
            times = ab.turns(fns, args.turns, timer, emit, shape=shape,
                             direction=direction, dtype=args.dtype)
            # the host time of a call where it exceeds the kernel's: CUDA
            # events around back-to-back calls (chip_smoke.host_call_ms)
            host = {n: cs.host_call_ms(fn) for n, fn in fns.items()}
            med = {n: statistics.median(v) for n, v in times.items()}
            call_shape = (b, h, w, cout, cin) if transposed else shape
            emit({"summary": shape, "direction": direction,
                  "dtype": args.dtype, "turns": times, "median_ms": med,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "share_of_bound": {n: bound_ms / m for n, m in med.items()},
                  "half_bound_reached": med["change"] <= 2 * bound_ms,
                  "change_over_parent": med["change"] / med["parent"],
                  "change_over_cudnn": med["change"] / med["cudnn"],
                  "spread": {n: max(v) - min(v) for n, v in times.items()},
                  "host_bound_call_ms": host,
                  "plan": plan(libs["change"], call_shape, transposed,
                               args.dtype)})
    emit({"ok": True})


if __name__ == "__main__":
    main()
