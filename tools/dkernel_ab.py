#!/usr/bin/env python3
"""Time the dK kernels (`cfgan_torch/csrc/conv3x3_dkernel.cu`) of two
checkouts in turns on one CUDA card.

    python3 tools/dkernel_ab.py --parent DIR [--turns 2] [--out FILE]

DIR is another checkout of this repository, for example the parent commit
unpacked with `git archive` into a directory that `.gitignore` lists.  Each
tree's `conv3x3_dkernel.cu` is built alone into `build/dkernel_ab/` of this
checkout (`tools/ab_common.py`); each is called with its own launch plan
and workspace.  Both take the same inputs, made from a seed.  A first line
compares the two builds' bf16 kernels and the reduction's SASS
(`cuobjdump -sass`, normalised: `ab_common.sass`) and gives each float32
kernel's ptxas registers and spills.

At each shape, bf16 and float32:
- each kernel against the plain dK (`conv3x3_same_dkernel_plain`): each
  tap within `chip_smoke.DK_RTOL` of its 2-norm, the same bits over two
  calls; the run fails otherwise;
- `--turns` rounds of parent, change, cuDNN's wgrad
  (`torch.nn.grad.conv2d_weight`), change, parent, each timed by the
  profiler (`chip_smoke.kernel_ms`: the kernel and its reduction, device
  time only), the reduction's time apart;
- each kernel's CUDA-graph reading (`chip_smoke.graph_ms`, CUDA events
  around replays of 20 calls) with the workspace allocated in each call,
  as the wrapper does, and allocated once.

One JSON line a measurement and a summary line a shape, each with the
card's `nvidia-smi` name and power limit; the last line is
{"ok": true, ...}.  Needs one card and nvcc; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (B, H, W, Cin, Cout): the preset's layers at the step's batch, the
# micro-batched chunks, serving's b=1, and the 20x20 preset's batches
BF16_SHAPES = ((128, 28, 28, 64, 64), (64, 28, 28, 64, 64),
               (32, 28, 28, 64, 64), (1, 28, 28, 64, 64),
               (128, 20, 20, 64, 64), (64, 20, 20, 64, 64))
F32_SHAPES = ((128, 28, 28, 64, 64), (64, 28, 28, 64, 64),
              (32, 28, 28, 64, 64), (1, 28, 28, 64, 64),
              (128, 20, 20, 64, 64), (64, 20, 20, 64, 64))
# the kernels whose SASS the float32 redesign leaves as it was
BF16_KERNELS = r"conv3x3_dkernel_wgmma_kernel|dkernel_reduce_kernel"
ENTRY_POINTS = ("cfgan_conv3x3_dkernel_blocks", "cfgan_conv3x3_dkernel_bf16",
                "cfgan_conv3x3_dkernel_f32")


def caller(lib: ctypes.CDLL, x, g, alloc_per_call: bool = False):
    """A call of `lib`'s dK on x and g, with its own plan's workspace:
    allocated once, or in each call as the wrapper does."""
    import torch

    b, h, w, cin = x.shape
    cout = g.shape[-1]
    f32 = x.dtype == torch.float32
    partials = lib.cfgan_conv3x3_dkernel_blocks(b, h, w, cin, cout, int(f32))
    if partials <= 0:
        raise RuntimeError(f"no launch plan: cudaError {-partials}")
    part = torch.empty((partials, 9 * cin * cout), device=x.device)
    dk = torch.empty((3, 3, cin, cout), device=x.device)
    launch = (lib.cfgan_conv3x3_dkernel_f32 if f32
              else lib.cfgan_conv3x3_dkernel_bf16)

    def call():
        ws = (torch.empty_like(part) if alloc_per_call else part)
        err = launch(x.data_ptr(), g.data_ptr(), ws.data_ptr(), dk.data_ptr(),
                     b, h, w, cin, cout, partials,
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return dk
    return call


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="another checkout of this repository")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the lines to this file")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from cfgan_torch.ops.conv import conv3x3_same_dkernel_plain
    from tools import ab_common as ab

    if not torch.cuda.is_available():
        sys.exit("dkernel_ab: needs a CUDA card")
    emit = ab.Lines(ab.card_name(), args.out)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = ROOT / "build" / "dkernel_ab"
    built = ab.build({"parent": args.parent.resolve(), "change": ROOT},
                     "conv3x3_dkernel.cu", out_dir, ENTRY_POINTS)
    libs = {name: lib for name, (lib, _) in built.items()}
    sass = {name: ab.sass(out_dir / f"lib{name}.so", BF16_KERNELS)
            for name in built}
    emit({"build": {name: cs.kernel_ptxas(
                        log, r"conv3x3_dkernel_tf32(?:_ws)?_kernel")
                    for name, (_, log) in built.items()},
          "bf16_sass_equal": {
              name: code == sass["parent"].get(name)
              for name, code in sass["change"].items()},
          "bf16_sass_kernels": {name: len(k) for name, k in sass.items()}})
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED)
    for dtype, shapes in (("bfloat16", BF16_SHAPES), ("float32", F32_SHAPES)):
        dt = getattr(torch, dtype)
        for shape in shapes:
            x, _ = cs.make_conv_inputs(gen, dev, *shape, dt)
            g, _ = cs.make_conv_inputs(gen, dev, *shape[:3], shape[4],
                                       shape[4], dt)
            ref = conv3x3_same_dkernel_plain(x, g)
            norm = ref.reshape(9, -1).norm(dim=1).clamp_min(1e-30)
            for name, lib in libs.items():
                call = caller(lib, x, g)
                got, again = call().clone(), call().clone()
                torch.cuda.synchronize()
                rel = ((got - ref).reshape(9, -1).norm(dim=1) / norm).max()
                ok = bool(rel <= cs.DK_RTOL) and torch.equal(got, again)
                emit({"check": name, "shape": shape, "dtype": dtype,
                      "max_tap_rel_err": rel.item(),
                      "two_calls_equal_bits": torch.equal(got, again),
                      "ok": ok})
                if not ok:
                    sys.exit(f"dkernel_ab: {name} disagrees with the plain "
                             f"dK at {shape} {dtype}")
            x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            w_shape = (shape[4], shape[3], 3, 3)

            def cudnn():
                return torch.nn.grad.conv2d_weight(x_nchw, w_shape, g_nchw,
                                                   padding=1)
            fns = {"parent": caller(libs["parent"], x, g),
                   "change": caller(libs["change"], x, g), "cudnn": cudnn}

            def timer(fn):
                ms, how = cs.kernel_ms(fn)
                _, _, parts = cs.device_time(fn, 20,
                                            match=("dkernel_reduce",))
                return ms, how, {"reduce_ms": parts.get("dkernel_reduce",
                                                        (None,))[0]}
            times = ab.turns(fns, args.turns, timer, emit, shape=shape,
                             dtype=dtype)
            graphs = {name: {"graph_ms_workspace_each_call": cs.graph_ms(
                                 caller(lib, x, g, alloc_per_call=True)),
                             "graph_ms_workspace_once": cs.graph_ms(
                                 caller(lib, x, g))}
                      for name, lib in libs.items()}
            bound_ms, bound_by = cs.dkernel_bound(*shape, dtype)
            med = {k: statistics.median(v) for k, v in times.items()}
            emit({"summary": shape, "dtype": dtype, "turns": times,
                  "median_ms": med, "bound_ms": bound_ms,
                  "bound_by": bound_by,
                  "change_over_parent": med["change"] / med["parent"],
                  "change_over_cudnn": med["change"] / med["cudnn"],
                  "graphs": graphs})
    emit({"ok": True})


if __name__ == "__main__":
    main()
