#!/usr/bin/env python3
"""Time the dK kernels (`cfgan_torch/csrc/conv3x3_dkernel.cu`) of two
checkouts in turns on one CUDA card.

    python3 tools/dkernel_ab.py --parent DIR [--turns 2] [--out FILE]

DIR is another checkout of this repository, for example the parent commit
unpacked with `git archive` into a directory that `.gitignore` lists.  Each
tree's `conv3x3_dkernel.cu` (with its `sm90.cuh`) is built alone, one `nvcc`
each, started together, into `build/dkernel_ab/` of this checkout, and
loaded with ctypes: the two libraries export the same C entry points, which
each call with its own launch plan and workspace.  Both take the same
inputs, made from a seed.

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
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (B, H, W, Cin, Cout): the preset's layers at the step's batch, the
# micro-batched chunks, serving's b=1, and the 20x20 preset's batches
BF16_SHAPES = ((128, 28, 28, 64, 64), (64, 28, 28, 64, 64),
               (32, 28, 28, 64, 64), (1, 28, 28, 64, 64),
               (128, 20, 20, 64, 64), (64, 20, 20, 64, 64))
F32_SHAPES = ((128, 28, 28, 64, 64), (1, 28, 28, 64, 64),
              (128, 20, 20, 64, 64), (64, 20, 20, 64, 64))
ENTRY_POINTS = ("cfgan_conv3x3_dkernel_blocks", "cfgan_conv3x3_dkernel_bf16",
                "cfgan_conv3x3_dkernel_f32")


def build(trees: dict[str, Path], out_dir: Path) -> dict[str, ctypes.CDLL]:
    """Each tree's dK source into its own shared library, the `nvcc`s
    started together; the libraries, bound."""
    from cfgan_torch.ops import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, tree in trees.items():
        src = tree / "cfgan_torch" / "csrc" / "conv3x3_dkernel.cu"
        lib = out_dir / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
               str(src)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(path))
        for entry in ENTRY_POINTS:
            fn = getattr(lib, entry)
            fn.argtypes = _build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


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

    if not torch.cuda.is_available():
        sys.exit("dkernel_ab: needs a CUDA card")
    sink = open(args.out, "w") if args.out else None

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]

    def emit(obj):
        line = json.dumps({"card": card, **obj})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build({"parent": args.parent.resolve(), "change": ROOT},
                 ROOT / "build" / "dkernel_ab")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED)
    order = ["parent", "change", "cudnn", "change", "parent"] * args.turns
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
            times = {name: [] for name in fns}
            for who in order:
                ms, how = cs.kernel_ms(fns[who])
                _, _, parts = cs.device_time(fns[who], 20,
                                             match=("dkernel_reduce",))
                times[who].append(ms)
                emit({"time": who, "shape": shape, "dtype": dtype, "ms": ms,
                      "timed_by": how,
                      "reduce_ms": parts.get("dkernel_reduce", (None,))[0]})
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
