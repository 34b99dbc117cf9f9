"""Tests of the port that need a CUDA card.  Each skips inside its body
where there is none, so every pytest worker collects the same tests.

This file imports no JAX (the card's machine has none); run it there with

    python -m pytest --noconftest -q tests/test_torch_gpu.py

(`--noconftest`: tests/conftest.py sets up JAX for the other files).
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from cfgan_torch.core.config import MNIST_COUNTERGAN
from cfgan_torch.nn.layers import Conv
from cfgan_torch.ops import conv as tconv
from cfgan_torch.ops import epilogue as tep
from cfgan_torch.serve.engine import CounterfactualEngine
from cfgan_torch.train.builders import (
    build_mnist_countergan,
    build_mnist_serving,
    mnist_models,
)

pytestmark = pytest.mark.gpu

# (B, H, W, Cin, Cout): the serving layer at batch 128 and 1 (the
# tensor-core kernel's 32-wide Cout tiles); several tiles across W; one
# row; Cin not a multiple of 8 or 16, W odd; Cout over three 64-channel
# tiles; Cin over three 64-channel slices; the preset's layers on 20x20
# images at batch 128 and 64 (a halo window of another width, and pixel
# counts that are not multiples of the 28x28 ones); the dK's cluster plan
# at its edges: a block count that is not a multiple of the cluster size,
# a grid of one cluster, a cluster with fewer pixel ranges than blocks,
# and twice the preset's batch; the bf16 conv's plan at its edges: the
# figures' heatmaps (B=8: one tile a block, taps split), 2,352 pixels (not
# a multiple of 64), 126 tiles (a cluster holds a block without a tile),
# Cin over two TMA slices at a batch too small for the TMA body and at
# one that takes it (K reloaded through the cluster every round); TMA
# bodies whose stored box overhangs y: 13 rows in tiles of 7 rows (128
# positions) and of 4 rows (64 positions), Cout 72 and 96 (a second,
# part-filled 64-channel tile) and 40 (one tile, part-filled); the
# float32 TMA body's edges: Cin 96 (its third 32-channel slice), 259 tiles
# (not a multiple of any cluster size), Cout 36 (a store box overhanging
# Cout in its second 32-channel half) and Cin 20 / Cout 44 (multiples of 4,
# not of 8)
SHAPES = [(128, 28, 28, 64, 64), (1, 28, 28, 64, 64), (2, 5, 70, 16, 16),
          (3, 1, 9, 16, 24), (2, 13, 11, 20, 40), (4, 13, 11, 20, 130),
          (9, 7, 5, 32, 64), (2, 6, 6, 130, 70), (128, 20, 20, 64, 64),
          (64, 20, 20, 64, 64), (5, 28, 28, 64, 64), (1, 5, 5, 64, 64),
          (1, 3, 5, 64, 64), (256, 28, 28, 64, 64), (8, 28, 28, 64, 64),
          (3, 28, 28, 64, 64), (9, 28, 28, 64, 64), (2, 28, 28, 128, 64),
          (32, 28, 28, 128, 64), (128, 13, 11, 64, 64), (20, 13, 11, 64, 64),
          (128, 28, 28, 64, 72), (128, 28, 28, 64, 96),
          (128, 28, 28, 64, 40), (64, 28, 28, 96, 64), (37, 28, 28, 64, 64),
          (128, 28, 28, 64, 36), (40, 28, 28, 20, 44)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, dev, seed=0):
    b, h, w, cin, cout = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, h, w, cin), generator=g)
    k = torch.randn((3, 3, cin, cout), generator=g) / (9 * cin) ** 0.5
    return x.to(dev, dtype), k.to(dev, dtype)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain(shape, dtype):
    """f32: abs <= 1e-4 (summation order).  bf16: within one bf16 ulp of
    the plain version's float32 sum rounded to bf16, plus 1e-4 for the
    two float32 sums' difference, which decides the rounding where a sum
    nearly cancels."""
    dev = _card()
    dt = getattr(torch, dtype)
    x, k = _inputs(shape, dt, dev)
    before = tconv.conv3x3_same.launches
    got = tconv.conv3x3_same(x, k)
    torch.cuda.synchronize()
    assert tconv.conv3x3_same.launches == before + 1
    assert got.dtype == dt and got.shape == shape[:3] + (shape[4],)
    ref = tconv.conv3x3_same_plain(x.float(), k.float())
    if dt == torch.float32:
        assert (got - ref).abs().max().item() <= 1e-4
    else:
        ref = ref.to(dt).float()
        ulp = torch.exp2(torch.floor(torch.log2(
            ref.abs().clamp_min(2.0 ** -126))) - 7)
        assert bool(((got.float() - ref).abs() <= ulp + 1e-4).all())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("transposed", [False, True], ids=["fwd", "dx"])
def test_bf16_kernel_gives_the_same_bits_twice(shape, transposed):
    """Two calls of the bf16 conv on the same inputs give the same bits:
    each output is one block's fixed sequence of products, stored once
    (no float atomics, no split sums)."""
    dev = _card()
    b, h, w, cin, cout = shape
    _, k = _inputs(shape, torch.bfloat16, dev, seed=9)
    x, _ = _inputs((b, h, w, cout if transposed else cin, 1), torch.bfloat16,
                   dev, seed=10)
    got = tconv.conv3x3_same(x, k, transposed=transposed)
    again = tconv.conv3x3_same(x, k, transposed=transposed)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("transposed", [False, True], ids=["fwd", "dx"])
def test_f32_kernel_gives_the_same_bits_twice(shape, transposed):
    """Two calls of the float32 conv on the same inputs give the same
    bits: each output is one block's fixed sequence of products and sums,
    stored once (no float atomics, no split sums)."""
    dev = _card()
    b, h, w, cin, cout = shape
    _, k = _inputs(shape, torch.float32, dev, seed=9)
    x, _ = _inputs((b, h, w, cout if transposed else cin, 1), torch.float32,
                   dev, seed=10)
    got = tconv.conv3x3_same(x, k, transposed=transposed)
    again = tconv.conv3x3_same(x, k, transposed=transposed)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def _kernels_launched(fn, count=1):
    """The names of the conv kernels that one call of `fn` launched, by
    the profiler, gathered over up to three traces until `count` kernels
    are seen (a trace now and then comes back without some of the card's
    records)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names = set()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names |= {ev.key for ev in prof.key_averages() if "conv3x3" in ev.key}
        if len(names) >= count:
            break
    return names


# shape -> the body its plan takes on an H100 (132 SMs): TMA where Cin
# and Cout are multiples of 8 and the problem is large enough (tiles of
# 128 positions for every SM, or of 64 for at least half of them, one a
# block), cp.async otherwise
PLAN_BODIES = {(128, 28, 28, 64, 64): 1, (8, 28, 28, 64, 64): 1,
               (32, 28, 28, 128, 64): 1, (1, 28, 28, 64, 64): 0,
               (2, 13, 11, 20, 40): 0, (3, 1, 9, 16, 24): 0,
               (4, 13, 11, 20, 130): 0, (128, 13, 11, 64, 64): 1,
               (20, 13, 11, 64, 64): 1, (128, 28, 28, 64, 72): 1,
               (128, 28, 28, 64, 40): 1}


@pytest.mark.parametrize("shape", list(PLAN_BODIES), ids=str)
@pytest.mark.parametrize("transposed", [False, True], ids=["fwd", "dx"])
def test_conv_plan_picks_the_body_the_kernel_launches(shape, transposed):
    """The plan's body: TMA (the warp-specialised kernel) where Cin and
    Cout are multiples of 8 and the problem fills the card
    (PLAN_BODIES), cp.async otherwise; at the launch, an input one
    element into its storage (not 16-byte aligned) takes the cp.async
    body at any shape.  Both agree with the plain version."""
    dev = _card()
    b, h, w, cin, cout = shape
    c_in, c_out = (cout, cin) if transposed else (cin, cout)
    _, k = _inputs(shape, torch.bfloat16, dev, seed=11)
    x, _ = _inputs((b, h, w, c_in, 1), torch.bfloat16, dev, seed=12)
    plan = tconv.conv_plan(b, h, w, c_in, c_out, transposed=transposed)
    assert plan["tma"] == PLAN_BODIES[shape]
    if c_in % 8 or c_out % 8:
        assert plan["tma"] == 0
    assert plan["grid"] >= 1 and plan["units"] >= 1
    if plan["tma"]:
        assert plan["consumers"] == 2 and plan["cluster"] >= 2
        assert plan["grid"] % plan["cluster"] == 0
    kk = (k.float().flip(0, 1).transpose(2, 3).contiguous() if transposed
          else k.float())
    ref = tconv.conv3x3_same_plain(x.float(), kk)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype,
                          device=dev)[1:].view(x.shape).copy_(x)
    for inp, tma in ((x, plan["tma"]), (shifted, 0)):
        names = _kernels_launched(
            lambda: tconv.conv3x3_same(inp, k, transposed=transposed))
        ws = {n for n in names if "conv3x3_wgmma_ws_kernel" in n}
        assert (len(ws) == 1) == bool(tma), names
        assert len(names) == 1, names
        got = tconv.conv3x3_same(inp, k, transposed=transposed)
        torch.cuda.synchronize()
        assert _bf16_close(got, ref)


# shape -> the body the float32 plan takes on an H100 (132 SMs): TMA where
# Cin and Cout are multiples of 4, W + 2 <= 128 and the problem's tiles of
# 128 positions give every SM one, or where the cp.async body would take
# more than one round of its units (B = 8: 196 units); cp.async otherwise
# (B = 4: 98 units, one round)
F32_PLAN_BODIES = {(128, 28, 28, 64, 64): 1, (64, 28, 28, 64, 64): 1,
                   (32, 28, 28, 64, 64): 1, (8, 28, 28, 64, 64): 1,
                   (4, 28, 28, 64, 64): 0,
                   (1, 28, 28, 64, 64): 0, (2, 13, 11, 20, 40): 0,
                   (4, 13, 11, 20, 130): 0, (2, 5, 70, 16, 16): 0,
                   (64, 28, 28, 96, 64): 1, (37, 28, 28, 64, 64): 1,
                   (128, 28, 28, 64, 36): 1, (40, 28, 28, 20, 44): 1,
                   (128, 13, 11, 64, 64): 1, (128, 20, 20, 64, 64): 1}


@pytest.mark.parametrize("shape", list(F32_PLAN_BODIES), ids=str)
@pytest.mark.parametrize("transposed", [False, True], ids=["fwd", "dx"])
def test_f32_conv_plan_picks_the_body_the_kernel_launches(shape, transposed):
    """The float32 plan's body: TMA (the warp-specialised kernel, after
    its K split) where F32_PLAN_BODIES says, the cp.async body (after its
    own K split) otherwise; at the launch, an input one element into its
    storage (not 16-byte aligned) takes the cp.async body at any shape.
    Both hold the float32 bars against the plain version."""
    dev = _card()
    b, h, w, cin, cout = shape
    c_in, c_out = (cout, cin) if transposed else (cin, cout)
    _, k = _inputs(shape, torch.float32, dev, seed=11)
    x, _ = _inputs((b, h, w, c_in, 1), torch.float32, dev, seed=12)
    plan = tconv.conv_plan(b, h, w, c_in, c_out, transposed=transposed,
                           dtype=torch.float32)
    assert plan["tma"] == F32_PLAN_BODIES[shape]
    assert plan["grid"] >= 1 and plan["units"] >= 1 and plan["chain"] >= 3
    if plan["tma"]:
        assert plan["consumers"] == 2 and plan["cout_tile"] == 64
        assert plan["grid"] % plan["cluster"] == 0
    else:
        assert plan["cluster"] == 1 and plan["chain"] == 3
    kk = k.flip(0, 1).transpose(2, 3).contiguous() if transposed else k
    ref = tconv.conv3x3_same_plain(x, kk)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype,
                          device=dev)[1:].view(x.shape).copy_(x)
    for inp, tma in ((x, plan["tma"]), (shifted, 0)):
        names = _kernels_launched(
            lambda: tconv.conv3x3_same(inp, k, transposed=transposed), 2)
        want = ({"conv3x3_tf32_ws_kernel", "conv3x3_tf32_ksplit_kernel"}
                if tma else {"conv3x3_tf32_kernel",
                             "conv3x3_tf32_split_kernel"})
        assert {n for n in want if any(n in m for m in names)} == want, names
        assert len(names) == 2, names
        got = tconv.conv3x3_same(inp, k, transposed=transposed)
        torch.cuda.synchronize()
        assert (got - ref).abs().max().item() <= 1e-4
        assert _row_rel_err(got, ref) <= 1e-5


def _bf16_close(got, ref):
    """Within one bf16 ulp of the float32 reference rounded to bf16, plus
    1e-4 for the two float32 sums' difference, which decides the rounding
    where a sum nearly cancels."""
    ref = ref.bfloat16().float()
    ulp = torch.exp2(torch.floor(torch.log2(
        ref.abs().clamp_min(2.0 ** -126))) - 7)
    return bool(((got.float() - ref).abs() <= ulp + 1e-4).all())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transposed_kernel_matches_plain(shape, dtype):
    """The dx conv: K read flipped and channel-transposed by the kernel (no
    copy); tolerances as in test_kernel_matches_plain."""
    dev = _card()
    dt = getattr(torch, dtype)
    b, h, w, cin, cout = shape
    _, k = _inputs(shape, dt, dev, seed=2)
    g, _ = _inputs((b, h, w, cout, cout), dt, dev, seed=5)
    before = tconv.conv3x3_same.launches
    got = tconv.conv3x3_same(g, k, transposed=True)
    torch.cuda.synchronize()
    assert tconv.conv3x3_same.launches == before + 1
    assert got.shape == (b, h, w, cin)
    ref = tconv.conv3x3_same_plain(
        g.float(), k.float().flip(0, 1).transpose(2, 3).contiguous())
    if dt == torch.float32:
        assert (got - ref).abs().max().item() <= 1e-4
    else:
        assert _bf16_close(got, ref)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_dkernel_matches_plain_with_equal_bits(shape):
    """bf16 x and cotangent, dK in float32: each tap's (Cin, Cout) block
    within 1e-5 of its 2-norm of the plain version (float32 sums of up to
    B*H*W = 100,352 products in another order); two calls give the same
    bits (per-block partials summed in a fixed order, no atomics)."""
    dev = _card()
    b, h, w, cin, cout = shape
    x, _ = _inputs(shape, torch.bfloat16, dev, seed=3)
    g, _ = _inputs((b, h, w, cout, cout), torch.bfloat16, dev, seed=4)
    before = tconv.conv3x3_same_dkernel.launches
    got = tconv.conv3x3_same_dkernel(x, g)
    again = tconv.conv3x3_same_dkernel(x, g)
    torch.cuda.synchronize()
    assert tconv.conv3x3_same_dkernel.launches == before + 2
    assert got.dtype == torch.float32 and got.shape == (3, 3, cin, cout)
    assert torch.equal(got, again)
    ref = tconv.conv3x3_same_dkernel_plain(x, g)
    err = (got - ref).reshape(9, -1).norm(dim=1)
    assert bool((err <= 1e-5 * ref.reshape(9, -1).norm(dim=1) + 1e-6).all())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dkernel_workspace_is_the_plans_partials(shape, dtype):
    """The wrapper's workspace is the plan's partial count x 9 x Cin x
    Cout floats: in bf16 one partial a cluster of blocks (the grid's
    blocks along the pixels, a multiple of the cluster size, over the
    cluster size), in float32 one a block."""
    dev = _card()
    dt = getattr(torch, dtype)
    b, h, w, cin, cout = shape
    x, _ = _inputs(shape, dt, dev, seed=3)
    g, _ = _inputs((b, h, w, cout, cout), dt, dev, seed=4)
    plan = tconv.dkernel_plan(b, h, w, cin, cout, dt)
    tconv.conv3x3_same_dkernel(x, g)
    torch.cuda.synchronize()
    assert plan["blocks"] % plan["cluster"] == 0
    assert plan["partials"] == plan["blocks"] // plan["cluster"]
    assert tconv.conv3x3_same_dkernel.last_workspace_floats == (
        plan["partials"] * 9 * cin * cout)
    if dt == torch.float32:  # clusters in the TMA body, one a block else
        assert (plan["cluster"] > 1) == (plan["tma"] == 1)
    if shape == (128, 28, 28, 64, 64):  # the preset's layer: clusters
        assert plan["cluster"] > 1 and plan["tma"] == 1


def _row_rel_err(got, ref):
    """The largest over output pixels of |got - ref| / |ref| in the 2-norm
    of the pixel's channels."""
    d = (got.float() - ref).reshape(-1, ref.shape[-1]).norm(dim=1)
    return (d / ref.reshape(-1, ref.shape[-1]).norm(dim=1).clamp_min(1e-30)
            ).max().item()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("transposed", [False, True], ids=["fwd", "dx"])
def test_f32_kernel_keeps_float32_accuracy(shape, transposed):
    """The float32 kernel's 3xTF32 products against the plain version in
    full float32 (TF32 off): abs <= 1e-4, and every output pixel's row of
    channels within 1e-5 of its 2-norm, a bar that one TF32 product misses
    (test_tf32_matmul_misses_the_f32_relative_bar)."""
    dev = _card()
    b, h, w, cin, cout = shape
    _, k = _inputs(shape, torch.float32, dev, seed=6)
    x, _ = _inputs((b, h, w, cout if transposed else cin, 1), torch.float32,
                   dev, seed=7)
    got = tconv.conv3x3_same(x, k, transposed=transposed)
    ref = tconv.conv3x3_same_plain(
        x, k.flip(0, 1).transpose(2, 3).contiguous() if transposed else k)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-4
    assert _row_rel_err(got, ref) <= 1e-5


def _cancelling_inputs(shape, transposed, dev):
    """x with a constant offset of 8 and a kernel whose nine taps nearly
    cancel (a zero-sum pattern over the taps times one (Cin, Cout)
    matrix, plus 1e-3 of noise): inside the image each output is a sum of
    partial sums several times larger than itself, where an accumulator
    that truncates loses the most."""
    b, h, w, cin, cout = shape
    g = torch.Generator().manual_seed(21)
    x = torch.randn((b, h, w, cout if transposed else cin), generator=g)
    pattern = torch.tensor([1.0, 1, 1, 1, -8, 1, 1, 1, 1]).reshape(3, 3, 1, 1)
    base = torch.randn((cin, cout), generator=g) / (9 * cin) ** 0.5
    noise = torch.randn((3, 3, cin, cout), generator=g) / (9 * cin) ** 0.5
    k = pattern / 8 * base + 1e-3 * noise
    return (x + 8.0).to(dev), k.to(dev)


def _conv_f64(x, k, transposed):
    """The SAME 3x3 conv in float64 on the card (dx form: K flipped and
    transposed), NHWC."""
    import torch.nn.functional as F

    kk = k.flip(0, 1).transpose(2, 3) if transposed else k
    y = F.conv2d(x.double().permute(0, 3, 1, 2),
                 kk.double().permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


# the design before the TMA body (the cp.async body, which sums each k8
# step's three products into a fresh accumulator) on _cancelling_inputs
# at the step's shape, against the float64 conv: (max abs, max row rel),
# measured on an NVIDIA H100 80GB HBM3 at 700 W by
# `tools/conv_f32_probe.py --parts chain` (its "parent" lines)
PARENT_CANCELLING_ERR = {"fwd": (3.370e-06, 2.174e-06),
                         "dx": (2.944e-06, 1.984e-06)}


@pytest.mark.parametrize("transposed", [False, True], ids=["fwd", "dx"])
def test_f32_kernel_holds_cancelling_sums(transposed):
    """Long accumulation chains lose the most where the partial sums are
    large against the result (the tensor cores truncate as they add):
    with x offset by 8 and taps that nearly cancel, at the step's shape
    (128, 28, 28, 64 -> 64), the kernel's error against the float64 conv
    is at most twice the parent design's on the same inputs
    (PARENT_CANCELLING_ERR, measured on the card with the parent's
    kernel: max abs 3.370e-6 forward, 2.944e-6 dx; max row rel 2.174e-6,
    1.984e-6)."""
    dev = _card()
    shape = (128, 28, 28, 64, 64)
    x, k = _cancelling_inputs(shape, transposed, dev)
    got = tconv.conv3x3_same(x, k, transposed=transposed)
    ref = _conv_f64(x, k, transposed)
    torch.cuda.synchronize()
    err = (got.double() - ref).abs().max().item()
    row = _row_rel_err(got.double(), ref)
    abs_bar, row_bar = PARENT_CANCELLING_ERR["dx" if transposed else "fwd"]
    assert err <= 2 * abs_bar and row <= 2 * row_bar, (err, row)


def test_tf32_matmul_misses_the_f32_relative_bar():
    """Why the float32 kernel splits its operands: the plain version's
    matmuls with TF32 on (one tf32 product each) miss the 1e-5 row bar at
    the serving shape, which the kernel holds."""
    dev = _card()
    x, k = _inputs(SHAPES[0], torch.float32, dev, seed=8)
    ref = tconv.conv3x3_same_plain(x, k)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = tconv.conv3x3_same_plain(x, k)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    got = tconv.conv3x3_same(x, k)
    torch.cuda.synchronize()
    assert _row_rel_err(tf32, ref) > 1e-5
    assert _row_rel_err(got, ref) <= 1e-5


# the float32 dK's plan at its edges beyond SHAPES (which hold B=1 at
# 28x28 over clusters, 20x20 B=64, 13x11 rows in stages of several rows, a
# cluster with fewer stage ranges than blocks, Cin 96 and 130, Cout 36, 44
# and 130, and shapes that take the cp.async body): Cin 132 (a third slice
# of one 32-channel box), Cout 132 (a fifth 32-wide tile of 4 channels),
# and W 130 (a row wider than a stage: the cp.async body)
F32_DK_EDGES = [(8, 28, 28, 132, 64), (8, 28, 28, 64, 132),
                (2, 4, 130, 64, 64)]


@pytest.mark.parametrize("shape", SHAPES + F32_DK_EDGES, ids=str)
def test_f32_dkernel_matches_plain_with_equal_bits(shape):
    """float32 x and cotangent (3xTF32): each tap's (Cin, Cout) block within
    1e-5 of its 2-norm of the plain version in full float32 (sums of up to
    B*H*W = 100,352 products in another order, every six products of a tap
    summed apart on the tensor cores); two calls give the same bits."""
    dev = _card()
    b, h, w, cin, cout = shape
    x, _ = _inputs(shape, torch.float32, dev, seed=3)
    g, _ = _inputs((b, h, w, cout, cout), torch.float32, dev, seed=4)
    before = tconv.conv3x3_same_dkernel.launches
    got = tconv.conv3x3_same_dkernel(x, g)
    again = tconv.conv3x3_same_dkernel(x, g)
    torch.cuda.synchronize()
    assert tconv.conv3x3_same_dkernel.launches == before + 2
    assert got.dtype == torch.float32 and got.shape == (3, 3, cin, cout)
    assert torch.equal(got, again)
    ref = tconv.conv3x3_same_dkernel_plain(x, g)
    err = (got - ref).reshape(9, -1).norm(dim=1)
    assert bool((err <= 1e-5 * ref.reshape(9, -1).norm(dim=1) + 1e-6).all())


@pytest.mark.parametrize("shape,tma", [
    ((128, 28, 28, 64, 64), 1), ((1, 28, 28, 64, 64), 1),
    ((64, 20, 20, 64, 64), 1), ((128, 13, 11, 64, 64), 1),
    ((2, 6, 6, 130, 70), 0), ((4, 13, 11, 20, 130), 0),
    ((2, 4, 130, 64, 64), 0)], ids=str)
def test_f32_dkernel_plan_picks_its_body_by_shape(shape, tma):
    """The float32 plan takes the TMA body where Cin and Cout are multiples
    of 4 and a padded row fits a stage (W + 2 <= 128), else the cp.async
    body: by shape, before any launch.  The TMA body's stages are whole
    padded rows (depth R (W + 2) rounded up to 8, at most 128), its
    clusters hold 2-8 blocks, and B=1 at 28x28 spreads over at least 28
    blocks."""
    _card()
    plan = tconv.dkernel_plan(*shape, torch.float32)
    assert plan["tma"] == tma
    if tma:
        b, h, w = shape[:3]
        assert 1 <= plan["rows"] <= h
        assert plan["depth"] == -(-plan["rows"] * (w + 2) // 8) * 8 <= 128
        assert plan["cluster"] in (2, 4, 8) and plan["chain"] == 6
        assert plan["partials"] * plan["cluster"] == plan["blocks"]
        if b == 1:
            assert plan["blocks"] >= 28
    else:
        assert plan["cluster"] == 1 and plan["rows"] == 0


def test_f32_dkernel_misaligned_inputs_take_the_cp_async_body():
    """An x or g that is not 16-byte aligned cannot be read by TMA: the
    launch takes the cp.async body on the TMA plan's workspace (no more
    blocks than its partials) and gives the plain version's dK."""
    dev = _card()
    shape = (8, 28, 28, 64, 64)
    assert tconv.dkernel_plan(*shape, torch.float32)["tma"] == 1
    b, h, w, cin, cout = shape
    n = b * h * w * cin
    gen = torch.Generator().manual_seed(5)
    buf = torch.randn(n + 1, generator=gen).to(dev)
    x = buf[1:].view(b, h, w, cin)  # 4 bytes past an aligned start
    g = torch.randn((b, h, w, cout), generator=gen).to(dev)
    for xx, gg in ((x, g), (x.clone(), buf[1:].view(b, h, w, cout))):
        got = tconv.conv3x3_same_dkernel(xx, gg)
        again = tconv.conv3x3_same_dkernel(xx, gg)
        ref = tconv.conv3x3_same_dkernel_plain(xx, gg)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        err = (got - ref).reshape(9, -1).norm(dim=1)
        assert bool((err <= 1e-5 * ref.reshape(9, -1).norm(dim=1)
                     + 1e-6).all())


def _cancelling_dk_inputs(shape, dev):
    """x with a constant offset of 8 and a cotangent whose pixels nearly
    cancel (one (Cout,) pattern, + in the image's top half of rows and -
    in its bottom half, plus 1e-3 of noise): each dK entry is a sum of
    partial sums (a stage's, a block's, a cluster's) much larger than
    itself, where an accumulator that truncates loses the most."""
    b, h, w, cin, cout = shape
    g = torch.Generator().manual_seed(21)
    x = torch.randn((b, h, w, cin), generator=g) + 8.0
    base = torch.randn((cout,), generator=g)
    sign = torch.where(torch.arange(h) < h // 2, 1.0, -1.0).reshape(1, h, 1, 1)
    cot = sign * base + 1e-3 * torch.randn((b, h, w, cout), generator=g)
    return x.to(dev), cot.to(dev)


def _dkernel_f64(x, g):
    """dK[dy, dx] = tap(x, dy, dx)^T @ g in float64 on the card."""
    import torch.nn.functional as F

    b, h, w, cin = x.shape
    xp = F.pad(x.double(), (0, 0, 1, 1, 1, 1))
    gm = g.double().reshape(-1, g.shape[-1])
    return torch.stack([xp[:, dy:dy + h, dx:dx + w, :].reshape(-1, cin).T @ gm
                        for dy in range(3) for dx in range(3)]
                       ).reshape(3, 3, cin, g.shape[-1])


def _dk_errors(got, ref):
    """(max abs error, the largest tap's 2-norm error over its 2-norm)."""
    d = got.double() - ref
    return (d.abs().max().item(),
            (d.reshape(9, -1).norm(dim=1) / ref.reshape(9, -1).norm(dim=1)
             ).max().item())


# the float32 dK's parent design (the cp.async body: each k8 step's three
# products of a tap into a fresh accumulator) on _cancelling_dk_inputs
# against the float64 dK, (max abs, max tap rel), at the step's shape and
# the 20x20 preset's: measured on an NVIDIA H100 80GB HBM3 at 700 W by
# `tools/dkernel_f32_probe.py --parts chain` (its "parent" lines)
PARENT_DK_CANCELLING_ERR = {(128, 28, 28, 64, 64): (0.03966, 1.270e-05),
                            (128, 20, 20, 64, 64): (0.01326, 6.10e-06)}


@pytest.mark.parametrize("shape", sorted(PARENT_DK_CANCELLING_ERR), ids=str)
def test_f32_dkernel_holds_cancelling_sums(shape):
    """The tensor cores truncate as they add, so the float32 dK sums a
    tap's products into a fresh accumulator every few products: on
    cotangents whose pixels nearly cancel, its error against the float64
    dK is at most twice the parent design's on the same inputs
    (PARENT_DK_CANCELLING_ERR, measured on the card with the parent's
    kernel)."""
    dev = _card()
    x, g = _cancelling_dk_inputs(shape, dev)
    got = tconv.conv3x3_same_dkernel(x, g)
    ref = _dkernel_f64(x, g)
    torch.cuda.synchronize()
    err, tap = _dk_errors(got, ref)
    abs_bar, tap_bar = PARENT_DK_CANCELLING_ERR[shape]
    assert err <= 2 * abs_bar and tap <= 2 * tap_bar, (err, tap)


def test_dkernel_wrapper_rejects_what_the_kernel_does_not_take():
    dev = _card()
    x, _ = _inputs((2, 8, 8, 16, 16), torch.bfloat16, dev)
    with pytest.raises(TypeError):
        tconv.conv3x3_same_dkernel(x.half(), x.half())
    with pytest.raises(TypeError):
        tconv.conv3x3_same_dkernel(x.float(), x)
    with pytest.raises(ValueError):
        tconv.conv3x3_same_dkernel(x, x[:, :4])
    with pytest.raises(ValueError):
        tconv.conv3x3_same_dkernel(x, x.cpu())


def test_kernel_matches_cudnn():
    dev = _card()
    x, k = _inputs(SHAPES[0], torch.float32, dev, seed=1)
    want = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), padding=1)
    got = tconv.conv3x3_same(x, k)
    assert (got - want.permute(0, 2, 3, 1)).abs().max().item() <= 1e-4


def test_wrapper_rejects_what_the_kernel_does_not_take():
    dev = _card()
    x, k = _inputs((2, 8, 8, 16, 16), torch.float32, dev)
    with pytest.raises(TypeError):
        tconv.conv3x3_same(x.half(), k.half())
    with pytest.raises(TypeError):
        tconv.conv3x3_same(x, k.bfloat16())
    with pytest.raises(ValueError):
        tconv.conv3x3_same(x.transpose(1, 2), k)
    with pytest.raises(ValueError):
        tconv.conv3x3_same(x, k.cpu())
    with pytest.raises(ValueError):
        tconv.conv3x3_same(x, k[:, :, :8])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_on_card_matches_cpu(dtype):
    """A narrow engine on the card (kernel) against the same engine on the
    CPU (plain version): f32 abs <= 1e-4; bf16 abs <= 2**-7 on x_cf."""
    dev = _card()
    cfg = replace(MNIST_COUNTERGAN, hidden_dim=32, num_res_blocks=2,
                  conv_impl="pallas", compute_dtype=dtype)
    g, c = mnist_models(cfg, generator=torch.Generator().manual_seed(0))
    x = np.random.default_rng(0).uniform(-1, 1, (5, 28, 28, 1)).astype(
        np.float32)
    results = []
    for device in (dev, "cpu"):
        s = build_mnist_serving(cfg, g.state_dict(), c.state_dict(),
                                device=device)
        e = CounterfactualEngine(s.cf_fn, s.clf_fn, 10, patch_size=7,
                                 device=device)
        before = tconv.conv3x3_same.launches
        results.append(e.generate(x, 4))
        launched = tconv.conv3x3_same.launches - before
        assert launched == (5 if device == dev else 0)
    atol = 1e-4 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(results[0].x_cf, results[1].x_cf, atol=atol,
                               rtol=0)


def _epilogue_inputs(b, n, dev, seed=0):
    """Rows with values exactly on the bounds (x = +-1 where masked = 0)
    and zeros in raw, and random cotangents."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((b, n), generator=g) * 2.4 - 1.2
    raw = torch.randn((b, n), generator=g) * 0.4
    mask = (torch.rand((b, n), generator=g) > 0.5).float()
    raw[:, ::5] = 0.0
    x[:, 1::5], mask[:, 1::5] = 1.0, 0.0
    x[:, 2::5], raw[:, 2::5] = -1.0, 0.0
    gcf = torch.randn((b, n), generator=g)
    cols = [torch.randn((b,), generator=g) for _ in range(3)]
    return [t.to(dev) for t in (x, raw, mask, gcf, *cols)]


def _misaligned(t):
    """A contiguous copy of `t` that starts one element into its storage,
    so 4 bytes past a 16-byte boundary."""
    view = torch.empty(t.numel() + 1, device=t.device)[1:].view(t.shape)
    return view.copy_(t)


# (B, N, misaligned): the step's rows (the 16-byte variant, one quad a
# thread), more rows than SMs, N % 4 != 0 and N < 4 (the 4-byte variant),
# a row longer than one block's quads (several trips a thread), and the
# step's rows as views one element into their storage (4-byte variant);
# the 20x20 image rows at batch 128 and 64 and the credit table's 7
# features (the 4-byte variant)
EPILOGUE_CASES = [(128, 784, False), (257, 784, False), (3, 17, False),
                  (5, 2, False), (64, 4096, False), (128, 784, True),
                  (128, 400, False), (64, 400, False), (128, 7, False)]


@pytest.mark.parametrize("case", EPILOGUE_CASES,
                         ids=lambda c: f"{c[0]}x{c[1]}" + ("_misaligned"
                                                           if c[2] else ""))
@pytest.mark.parametrize("bounds", [(-1.0, 1.0), (-1e30, 1e30)],
                         ids=["clamp", "no_clamp"])
def test_epilogue_kernels_match_plain(case, bounds):
    """x_cf, dx and draw abs <= 1e-6 (the same elementwise float32 ops;
    the kernels do not contract them into FMAs, so they round where the
    plain version does); the row sums rel <= 1e-5 (summation order)."""
    dev = _card()
    b, n, misaligned = case
    x, raw, mask, gcf, gl1, gl2, gpen = _epilogue_inputs(b, n, dev)
    if misaligned:
        x, raw, mask, gcf = map(_misaligned, (x, raw, mask, gcf))
    assert tep.float4_rows(x, raw, mask, gcf) is (n % 4 == 0
                                                  and not misaligned)
    f0, b0 = tep.cf_epilogue_fwd.launches, tep.cf_epilogue_bwd.launches
    got = tep.cf_epilogue_fwd(x, raw, mask, *bounds)
    want = tep.cf_epilogue_fwd_plain(x, raw, mask, *bounds)
    got_b = tep.cf_epilogue_bwd(x, raw, mask, gcf, gl1, gl2, gpen, *bounds)
    want_b = tep.cf_epilogue_bwd_plain(x, raw, mask, gcf, gl1, gl2, gpen,
                                       *bounds)
    torch.cuda.synchronize()
    assert (tep.cf_epilogue_fwd.launches, tep.cf_epilogue_bwd.launches) == (
        f0 + 1, b0 + 1)
    # the variant each wrapper passed to its kernel
    assert tep.cf_epilogue_fwd.last_float4 is (n % 4 == 0 and not misaligned)
    assert tep.cf_epilogue_bwd.last_float4 is (n % 4 == 0 and not misaligned)
    assert (got[0] - want[0]).abs().max().item() <= 1e-6
    for g, w in zip(got[1:], want[1:]):
        assert ((g - w).abs() <= 1e-5 * w.abs() + 1e-30).all()
    for g, w in zip(got_b, want_b):
        assert (g - w).abs().max().item() <= 1e-6



def test_countergan_g_terms_match_the_epilogue_kernels_terms():
    """`countergan_g_terms` on (128, 784) float32 residuals and a patch
    mask: its reg_l1, reg_l2 and mask_penalty against `epilogue_terms` of
    the forward kernel's row sums, for both reductions, relative 1e-5
    (the sums run in another order)."""
    from cfgan_torch.losses import countergan_g_terms

    dev = _card()
    g = torch.Generator().manual_seed(5)
    x = (torch.rand((128, 28, 28, 1), generator=g) * 2 - 1).to(dev)
    raw = (0.5 * torch.randn((128, 28, 28, 1), generator=g)).to(dev)
    patches = (torch.rand((128, 4, 4), generator=g) < 0.5).float()
    mask = patches.repeat_interleave(7, 1).repeat_interleave(7, 2)[
        ..., None].to(dev)
    logits = torch.randn((128, 10), generator=g).to(dev)
    t = torch.randint(0, 10, (128,), generator=g).to(dev)
    before = tep.cf_epilogue_fwd.launches
    _, *sums = tep.cf_epilogue(x, raw, mask, -1.0, 1.0)
    torch.cuda.synchronize()
    assert tep.cf_epilogue_fwd.launches == before + 1
    for reduction in ("per_sample_norm", "mean_abs"):
        want = tep.epilogue_terms(*sums, 28 * 28, reduction)
        terms = countergan_g_terms(torch.zeros((), device=dev), logits, t,
                                   raw * mask, raw, mask, lambda_reg_l2=0.5,
                                   reg_reduction=reduction)
        got = (terms.reg_l1, terms.reg_l2, terms.mask_penalty)
        for name, a, b in zip(("reg_l1", "reg_l2", "mask_penalty"), got,
                              want):
            assert abs(a.item() - b.item()) <= 1e-5 * abs(b.item()), (
                reduction, name, a.item(), b.item())

def test_epilogue_wrapper_rejects_what_the_kernels_do_not_take():
    dev = _card()
    x, raw, mask, gcf, gl1, gl2, gpen = _epilogue_inputs(4, 9, dev)
    with pytest.raises(TypeError):
        tep.cf_epilogue_fwd(x.bfloat16(), raw.bfloat16(), mask.bfloat16(),
                            -1.0, 1.0)
    with pytest.raises(ValueError):
        tep.cf_epilogue_fwd(x, raw.t().contiguous().t(), mask, -1.0, 1.0)
    with pytest.raises(ValueError):
        tep.cf_epilogue_fwd(x, raw.cpu(), mask, -1.0, 1.0)
    with pytest.raises(ValueError):
        tep.cf_epilogue_bwd(x, raw, mask, gcf, gl1[:2], gl2, gpen, -1.0, 1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("conv_impl", [None, "pallas"],
                         ids=["cudnn_conv", "pallas_conv"])
def test_train_step_launches_each_epilogue_kernel_once(dtype, conv_impl):
    """One train step launches the epilogue's forward kernel once and its
    backward kernel once (width 16 routes the resblock convs to the conv
    kernel with `conv_impl="pallas"`)."""
    dev = _card()
    cfg = replace(MNIST_COUNTERGAN, hidden_dim=16, num_res_blocks=1,
                  compute_dtype=dtype, conv_impl=conv_impl)
    clf = mnist_models(cfg, generator=torch.Generator().manual_seed(0))[1]
    bundle = build_mnist_countergan(cfg, clf.state_dict(), device=dev)
    draws = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((8, 28, 28, 1), device=dev) * 2 - 1
    y = torch.randint(0, 10, (8,), device=dev)
    f0, b0 = tep.cf_epilogue_fwd.launches, tep.cf_epilogue_bwd.launches
    conv0 = tconv.conv3x3_same.launches
    metrics = bundle.step_fn(bundle.state, x, y, draws)
    torch.cuda.synchronize()
    assert (tep.cf_epilogue_fwd.launches - f0,
            tep.cf_epilogue_bwd.launches - b0) == (1, 1)
    assert (tconv.conv3x3_same.launches > conv0) == (conv_impl == "pallas")
    assert all(torch.isfinite(v).all() for v in metrics.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_pallas_layer_passes_gradients_like_matmul(dtype):
    """The conv3x3 gradient repair: `Conv(impl="pallas")` on the card gives
    its kernel, bias and input the gradients of `impl="matmul"` (autograd
    through the plain version).  Before the repair the kernel's output had
    no grad_fn and only the bias got a gradient.  f32 abs <= 1e-3 on sums
    over 8 x 28 x 28 terms of order 10; bf16 rel <= 2e-2 (bf16 dx, bf16
    cast of the f32 dK)."""
    dev = _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(1)
    layer = Conv(64, 64, 3, 1, 1, impl="pallas", generator=gen).to(dev)
    ref = Conv(64, 64, 3, 1, 1, impl="matmul").to(dev)
    ref.load_state_dict(layer.state_dict())
    x = torch.randn((8, 28, 28, 64), generator=gen).to(dev)
    grads = []
    for m in (layer, ref):
        xi = x.to(dt).requires_grad_(True)
        params = {n: p.to(dt) for n, p in m.named_parameters()}
        y = torch.func.functional_call(m, params, (xi,))
        (y.float() ** 2).sum().backward()
        grads.append((xi.grad.float(), m.kernel.grad, m.bias.grad))
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        assert got is not None and want is not None
        scale = want.abs().max().item()
        tol = 1e-3 if dtype == "float32" else 2e-2 * scale
        assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dkernel_launches_once_per_backward(dtype):
    dev = _card()
    dt = getattr(torch, dtype)
    layer = Conv(32, 32, 3, 1, 1, impl="pallas").to(dev)
    x = torch.randn((2, 9, 9, 32), device=dev, dtype=dt, requires_grad=True)
    params = {n: p.to(dt) for n, p in layer.named_parameters()}
    before = tconv.conv3x3_same_dkernel.launches
    torch.func.functional_call(layer, params, (x,)).float().sum().backward()
    torch.cuda.synchronize()
    assert tconv.conv3x3_same_dkernel.launches == before + 1


def test_engine_rejects_a_target_and_serves_the_next_request():
    """A target outside the class range is refused on the host, before the
    card sees it (an embedding lookup out of range is a device-side assert,
    which would end the process's CUDA context); the next request serves."""
    dev = _card()
    cfg = replace(MNIST_COUNTERGAN, hidden_dim=32, num_res_blocks=1,
                  conv_impl="pallas")
    g, c = mnist_models(cfg, generator=torch.Generator().manual_seed(0))
    s = build_mnist_serving(cfg, g.state_dict(), c.state_dict(), device=dev)
    e = CounterfactualEngine(s.cf_fn, s.clf_fn, 10, patch_size=7, device=dev)
    x = np.random.default_rng(1).uniform(-1, 1, (3, 28, 28, 1)).astype(
        np.float32)
    for bad in (10, -1, [0, 1, 10]):
        with pytest.raises(ValueError, match="class range"):
            e.generate(x, bad)
        with pytest.raises(ValueError, match="class range"):
            e.generate_bulk(x, bad, chunk=2)
    r = e.generate(x, [9, 0, 4])
    torch.cuda.synchronize()
    assert r.x_cf.shape == x.shape and np.isfinite(r.x_cf).all()


def test_conv_pallas_backward_launches_the_kernel_for_dx():
    dev = _card()
    layer = Conv(32, 32, 3, 1, 1, impl="pallas").to(dev)
    x = torch.randn((2, 9, 9, 32), device=dev, requires_grad=True)
    before = tconv.conv3x3_same.launches
    y = layer(x)
    assert tconv.conv3x3_same.launches == before + 1
    y.sum().backward()
    assert tconv.conv3x3_same.launches == before + 2
    assert x.grad is not None and layer.kernel.grad is not None


# ------------------------------------------------- the epoch runner
def _deterministic():
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _runner_pair(dev, conv_impl, dtype, n=192, batch=32, seed=0,
                 base=MNIST_COUNTERGAN, legacy_delta=False, **options):
    """Two bundles from one initial state, a device dataset, one epoch's
    permutation and draws."""
    cfg = replace(base, hidden_dim=16, num_res_blocks=1,
                  compute_dtype=dtype, conv_impl=conv_impl, **options)
    clf = mnist_models(cfg, generator=torch.Generator().manual_seed(0),
                       legacy_delta=legacy_delta)[1]
    a, b = (build_mnist_countergan(cfg, clf.state_dict(), seed=seed,
                                   device=dev, legacy_delta=legacy_delta)
            for _ in range(2))
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((n, 28, 28, 1), device=dev, generator=g) * 2 - 1
    y = torch.randint(0, 10, (n,), device=dev, generator=g)
    perm = torch.randperm(n, device=dev, generator=g).reshape(-1, batch)
    draws = a.draw_fn(g, tuple(perm.shape))
    return a, b, x, y, perm, draws


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("conv_impl", [None, "pallas"],
                         ids=["cudnn_conv", "pallas_conv"])
def test_replayed_steps_equal_eager_steps(dtype, conv_impl):
    """An epoch of 6 steps through the runner (3 eager, a capture, 3
    replays of the CUDA graph) equals the same 6 steps run eagerly by
    `step_from_draws` from the same initial state and draws, bit for bit
    (same kernels, same inputs; cuDNN deterministic): every step's
    metrics, and every parameter, statistic, EMA leaf and Adam moment."""
    dev = _card()
    _deterministic()
    from cfgan_torch.train.loop import make_epoch_runner

    a, b, x, y, perm, draws = _runner_pair(dev, conv_impl, dtype)
    runner = make_epoch_runner(a.step_from_draws, reduce=False)
    got = runner(a.state, x, y, perm, draws)
    assert (runner.captures, runner.replays) == (1, perm.shape[0] - 3)
    want = []
    for i in range(perm.shape[0]):
        m = b.step_from_draws(b.state, x[perm[i]], y[perm[i]],
                              {k: v[i] for k, v in draws.items()})
        want.append({k: v.item() for k, v in m.items()})
    for i, w in enumerate(want):
        for k, v in w.items():
            assert got[k][i] == np.float32(v), (i, k)
    assert a.state.step == b.state.step == perm.shape[0]
    for net in ("g", "d"):
        sa, sb = getattr(a.state, net), getattr(b.state, net)
        for (name, t), u in zip(sa.model.state_dict().items(),
                                sb.model.state_dict().values()):
            assert torch.equal(t, u), (net, name)
        for p, q in zip(sa.model.parameters(), sb.model.parameters()):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(sa.opt.state[p][key], sb.opt.state[q][key])
    for k, v in a.state.g_ema.items():
        assert torch.equal(v, b.state.g_ema[k]), k


def _assert_replay_equals_eager(a, b, x, y, perm, draws):
    """An epoch through the runner (3 eager steps, a capture, replays)
    against the same steps eager: metrics and state bit for bit."""
    from cfgan_torch.train.loop import make_epoch_runner

    runner = make_epoch_runner(a.step_from_draws, reduce=False)
    got = runner(a.state, x, y, perm, draws)
    assert (runner.captures, runner.replays) == (1, perm.shape[0] - 3)
    for i in range(perm.shape[0]):
        m = b.step_from_draws(b.state, x[perm[i]], y[perm[i]],
                              {k: v[i] for k, v in draws.items()})
        for k, v in m.items():
            assert got[k][i] == np.float32(v.item()), (i, k)
    for net in ("g", "d"):
        sa, sb = getattr(a.state, net), getattr(b.state, net)
        for (name, t), u in zip(sa.model.state_dict().items(),
                                sb.model.state_dict().values()):
            assert torch.equal(t, u), (net, name)
        for p, q in zip(sa.model.parameters(), sb.model.parameters()):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(sa.opt.state[p][key], sb.opt.state[q][key])
    if a.state.g_ema is not None:
        for k, v in a.state.g_ema.items():
            assert torch.equal(v, b.state.g_ema[k]), k


@pytest.mark.parametrize("conv_impl", [None, "pallas"],
                         ids=["cudnn_conv", "pallas_conv"])
@pytest.mark.parametrize("legacy_delta", [False, True],
                         ids=["residual", "legacy"])
def test_custom_shape_replayed_steps_equal_eager_steps(conv_impl,
                                                       legacy_delta):
    """20x20 images of three classes, 5-px patches (8 of 16 modifiable),
    bf16: an epoch through the runner equals the same steps eager, bit
    for bit; the conv kernel's route launches 26 conv and 13 dK kernels
    an eager step."""
    from cfgan_torch.core.config import MaskConfig
    from cfgan_torch.models.classifiers import (
        CNNClassifier,
        LegacyCNNClassifier,
    )

    dev = _card()
    _deterministic()
    hw, nc = (20, 20), 3
    cfg = replace(MNIST_COUNTERGAN, hidden_dim=16, conv_impl=conv_impl,
                  mask=MaskConfig(kind="patch", patch_size=5,
                                  num_modifiable_patches=8),
                  fixed_target=2 if legacy_delta else None)
    clf = (LegacyCNNClassifier if legacy_delta else CNNClassifier)(
        nc, image_hw=hw, generator=torch.Generator().manual_seed(0))
    a, b = (build_mnist_countergan(cfg, clf.state_dict(), seed=0, device=dev,
                                   legacy_delta=legacy_delta,
                                   num_classes=nc, image_hw=hw)
            for _ in range(2))
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((192, *hw, 1), device=dev, generator=g) * 2 - 1
    y = torch.randint(0, nc, (192,), device=dev, generator=g)
    perm = torch.randperm(192, device=dev, generator=g).reshape(-1, 32)
    draws = a.draw_fn(g, tuple(perm.shape))
    _assert_replay_equals_eager(a, b, x, y, perm, draws)
    c0, d0 = tconv.conv3x3_same.launches, tconv.conv3x3_same_dkernel.launches
    b.step_from_draws(b.state, x[perm[0]], y[perm[0]],
                      {k: v[0] for k, v in draws.items()})
    torch.cuda.synchronize()
    routed = conv_impl == "pallas" and not legacy_delta
    assert (tconv.conv3x3_same.launches - c0,
            tconv.conv3x3_same_dkernel.launches - d0) == (
        (26, 13) if routed else (0, 0))


def test_legacy_replayed_steps_equal_eager_steps():
    """The legacy delta CounteRGAN (fixed target, all-ones masks,
    clipped-log losses) through the epoch runner equals its eager steps,
    bit for bit."""
    from cfgan_torch.experiments.presets import MNIST_COUNTERGAN_LEGACY

    dev = _card()
    _deterministic()
    _assert_replay_equals_eager(*_runner_pair(
        dev, None, "float32", base=MNIST_COUNTERGAN_LEGACY.countergan,
        legacy_delta=True))


@pytest.mark.parametrize("conv_impl", [None, "pallas"],
                         ids=["cudnn_conv", "pallas_conv"])
@pytest.mark.parametrize("options", [{"remat": True}, {"g_microbatch": 2},
                                     {"remat": True, "g_microbatch": 2}],
                         ids=["remat", "micro2", "remat_micro2"])
def test_memory_options_replayed_steps_equal_eager_steps(conv_impl, options):
    """`remat` and `g_microbatch` inside the captured CUDA graph (the
    checkpointed forward does not read the RNG state; the chunks copy
    nothing from the host): the replayed epoch equals its eager steps,
    bit for bit."""
    dev = _card()
    _deterministic()
    _assert_replay_equals_eager(*_runner_pair(dev, conv_impl, "bfloat16",
                                              **options))


def test_house_micro_replayed_steps_equal_eager_steps():
    """The house step with g_microbatch = 2, each chunk on its own Gumbel
    noise from the epoch's draws, replayed equals eager, bit for bit."""
    dev = _card()
    _assert_replay_equals_eager(*_house_pair(dev, g_microbatch=2))


@pytest.mark.parametrize("k", [2, 4])
def test_micro_step_launches_the_epilogue_k_plus_one_times(k):
    dev = _card()
    a, _, x, y, perm, draws = _runner_pair(dev, "pallas", "bfloat16",
                                           g_microbatch=k)
    tep.cf_epilogue_fwd.launches = tep.cf_epilogue_bwd.launches = 0
    tconv.conv3x3_same.launches = tconv.conv3x3_same_dkernel.launches = 0
    a.step_from_draws(a.state, x[perm[0]], y[perm[0]],
                      {n: v[0] for n, v in draws.items()})
    torch.cuda.synchronize()
    # one resblock (2 convs) + conv_mid: 3 kernel layers a forward
    assert (tep.cf_epilogue_fwd.launches, tep.cf_epilogue_bwd.launches) == (
        k + 1, k)
    assert tconv.conv3x3_same.launches == 3 * (k + 1) + 3 * k
    assert tconv.conv3x3_same_dkernel.launches == 3 * k


def test_remat_step_runs_the_residual_blocks_again():
    """`remat` on the kernel route: the one residual block's two convs
    run once more in the backward (conv_mid is not checkpointed), and
    dK runs once a layer."""
    dev = _card()
    a, _, x, y, perm, draws = _runner_pair(dev, "pallas", "bfloat16",
                                           remat=True)
    tconv.conv3x3_same.launches = tconv.conv3x3_same_dkernel.launches = 0
    a.step_from_draws(a.state, x[perm[0]], y[perm[0]],
                      {n: v[0] for n, v in draws.items()})
    torch.cuda.synchronize()
    assert tconv.conv3x3_same.launches == 2 * 3 + 2
    assert tconv.conv3x3_same_dkernel.launches == 3


def test_resumed_loop_on_the_card_restores_under_the_captured_graph(
        tmp_path):
    """A bundle whose runner has captured its graph trains on, then
    restores its epoch-1 checkpoint in place and finishes the run: the
    same graph replays (no second capture) and the state equals the
    uninterrupted 3-epoch run's exactly."""
    dev = _card()
    _deterministic()
    from cfgan_torch.convert import train_state_to_flax
    from cfgan_torch.train.loop import train_countergan_loop

    whole, resumed, x, y, _, _ = _runner_pair(dev, None, "bfloat16", n=160)

    def loop(bundle, epochs, **kw):
        return train_countergan_loop(bundle, x, y, epochs=epochs,
                                     batch_size=32, seed=3,
                                     log=lambda s: None, **kw)

    loop(whole, 3)
    loop(resumed, 1, checkpoint_dir=str(tmp_path), checkpoint_every=1)
    loop(resumed, 2, resume=False)  # moves the state on, same graph
    loop(resumed, 3, checkpoint_dir=str(tmp_path), resume=True)
    assert resumed.epoch_fn.captures == 1
    assert resumed.state.step == whole.state.step == 15
    got, want = (train_state_to_flax(b.state) for b in (resumed, whole))

    def equal(u, w):
        if isinstance(w, dict):
            assert u.keys() == w.keys()
            for k in w:
                equal(u[k], w[k])
        else:
            assert np.array_equal(np.asarray(u), np.asarray(w))

    equal(got, want)


def test_runner_raises_where_the_step_cannot_be_captured():
    """A step that reads a value back to the host runs eagerly but cannot
    be captured: the runner raises instead of running eager steps.  In a
    child process, so that the failed capture leaves this one alone."""
    _card()
    import subprocess
    import sys

    code = r'''
import torch
from cfgan_torch.train.loop import make_epoch_runner

class State:
    step = 0

def step(state, x, y, draws):
    v = float(x.sum())  # a host read: fine eagerly, not in a capture
    state.step += 1
    return {"v": torch.full((), v, device=x.device)}

runner = make_epoch_runner(step)
x = torch.ones((8, 2), device="cuda")
y = torch.zeros(8, dtype=torch.long, device="cuda")
perm = torch.arange(8, device="cuda").reshape(4, 2)
try:
    runner(State(), x, y, perm, {})
except RuntimeError as e:
    print("RAISED", runner.captures, runner.replays, "no eager fallback" in
          str(e))
else:
    print("NO ERROR")
'''
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert "RAISED 0 0 True" in proc.stdout, proc.stdout + proc.stderr


def test_dropout_with_a_generator_is_reproducible_on_the_card():
    dev = _card()
    from cfgan_torch.models.classifiers import CNNClassifier

    m = CNNClassifier(generator=torch.Generator().manual_seed(0)).to(dev)
    m.train()
    x = torch.rand((16, 28, 28, 1), device=dev)

    def logits(seed):
        return m(x, torch.Generator(device=dev).manual_seed(seed))

    assert torch.equal(logits(1), logits(1))
    assert not torch.equal(logits(1), logits(2))
    with pytest.raises(ValueError):
        m(x)


def test_experiment_runs_on_the_card(tmp_path):
    """`run()` on the card at width 16 on the IDX fixture: the run dir,
    a finite per-target CSV, and every epoch's steps through the runner."""
    dev = _card()
    import csv
    from pathlib import Path

    from cfgan_torch.experiments import mnist_countergan as exp
    from cfgan_torch.experiments.presets import MNIST_COUNTERGAN as PRESET

    fixture = str(Path(__file__).resolve().parent / "fixtures" / "mnist_idx")
    cfg = PRESET.replace(
        data=replace(PRESET.data, path=fixture, batch_size=16),
        classifier=replace(PRESET.classifier, epochs=1, batch_size=32),
        countergan=replace(PRESET.countergan, epochs=2, hidden_dim=16,
                           num_res_blocks=1))
    out = exp.run(cfg, out_dir=str(tmp_path), device=dev,
                  log=lambda s: None)
    runner = out["bundle"].epoch_fn
    assert runner.captures == 1 and runner.replays == 2 * 6 - 3
    with open(tmp_path / "countergan_metrics_per_class.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 10
    assert all(np.isfinite(float(r["class_flip_rate"])) for r in rows)


# ------------------------------------------------------------ house
def _house_pair(dev, n=256, batch=32, seed=0, **options):
    """Two house bundles (the shipped preset at width 16, two FiLM
    blocks) from one initial state, the synthetic table's first `n`
    training rows on the card, one epoch's permutation and draws."""
    from cfgan_torch.core.config import HOUSE_COUNTERGAN
    from cfgan_torch.data.kc_house import KC_SCHEMA, load_kc_house
    from cfgan_torch.models.classifiers import TabularClassifier
    from cfgan_torch.train.builders import build_tabular_countergan

    (xtr, ytr), _, stats, _, _ = load_kc_house()
    cfg = replace(HOUSE_COUNTERGAN, hidden_dim=16, num_res_blocks=2,
                  **options)
    clf = TabularClassifier(generator=torch.Generator().manual_seed(0))
    a, b = (build_tabular_countergan(cfg, clf.state_dict(), KC_SCHEMA,
                                     stats, seed=seed, device=dev)
            for _ in range(2))
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.as_tensor(xtr[:n]).to(dev)
    y = torch.as_tensor(ytr[:n]).to(dev, torch.long)
    perm = torch.randperm(n, device=dev, generator=g).reshape(-1, batch)
    draws = a.draw_fn(g, tuple(perm.shape))
    return a, b, x, y, perm, draws


def test_house_step_on_the_kernels_equals_the_plain_epilogue(monkeypatch):
    """Three house steps launch the epilogue kernels once forward and once
    backward each, in the 4-byte variant ((B, 17) rows), and give the
    losses of the same steps on the plain epilogue within 1e-4 (float32,
    the MNIST `train` phase's bar) and the same critic `u`."""
    dev = _card()
    a, b, x, y, perm, draws = _house_pair(dev)
    f0, b0 = tep.cf_epilogue_fwd.launches, tep.cf_epilogue_bwd.launches
    got = [a.step_from_draws(a.state, x[perm[i]], y[perm[i]],
                             {k: v[i] for k, v in draws.items()})
           for i in range(3)]
    torch.cuda.synchronize()
    assert (tep.cf_epilogue_fwd.launches - f0,
            tep.cf_epilogue_bwd.launches - b0) == (3, 3)
    assert tep.cf_epilogue_fwd.last_float4 is False
    assert tep.cf_epilogue_bwd.last_float4 is False
    monkeypatch.setattr(tep, "cf_epilogue_fwd", tep.cf_epilogue_fwd_plain)
    monkeypatch.setattr(tep, "cf_epilogue_bwd", tep.cf_epilogue_bwd_plain)
    want = [b.step_from_draws(b.state, x[perm[i]], y[perm[i]],
                              {k: v[i] for k, v in draws.items()})
            for i in range(3)]
    for g_, w in zip(got, want):
        for k in ("d_loss", "g_loss"):
            assert abs(g_[k].item() - w[k].item()) <= 1e-4, k
    for (name, m), n in zip(a.state.d.model.named_children(),
                            b.state.d.model.children()):
        assert torch.allclose(m.u, n.u, atol=1e-5), name


def test_house_replayed_steps_equal_eager_steps():
    """An epoch of 8 house steps through the runner (3 eager, a capture,
    5 replays) equals the same steps run eagerly, bit for bit: every
    step's metrics, and every parameter, BatchNorm statistic, critic `u`,
    EMA leaf and Adam tensor."""
    dev = _card()
    from cfgan_torch.train.loop import make_epoch_runner

    a, b, x, y, perm, draws = _house_pair(dev)
    runner = make_epoch_runner(a.step_from_draws, reduce=False)
    got = runner(a.state, x, y, perm, draws)
    assert (runner.captures, runner.replays) == (1, perm.shape[0] - 3)
    for i in range(perm.shape[0]):
        m = b.step_from_draws(b.state, x[perm[i]], y[perm[i]],
                              {k: v[i] for k, v in draws.items()})
        for k, v in m.items():
            assert got[k][i] == np.float32(v.item()), (i, k)
    for net in ("g", "d"):
        sa, sb = getattr(a.state, net), getattr(b.state, net)
        for (name, t), u in zip(sa.model.state_dict().items(),
                                sb.model.state_dict().values()):
            assert torch.equal(t, u), (net, name)
        for p, q in zip(sa.model.parameters(), sb.model.parameters()):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(sa.opt.state[p][key], sb.opt.state[q][key])
    for k, v in a.state.g_ema.items():
        assert torch.equal(v, b.state.g_ema[k]), k


def test_house_noise_is_derived_on_the_card():
    """The serving path's threefry noise computed on the card: its integer
    words, and the uniform draws they give, equal the CPU's bit for bit;
    the two logs after them within 2 float32 ulps of the CPU's value (a
    noise of magnitude 8 or more has an ulp of 9.5e-7 already, so one
    ulp between two `log` implementations may exceed a fixed 1e-6), and
    never held tighter than 1e-6."""
    dev = _card()
    from cfgan_torch.data.kc_house import KC_SCHEMA
    from cfgan_torch.models.tabular import (
        _uniform_from_bits,
        derive_gumbel_noise,
        gumbel_bits,
    )

    info = KC_SCHEMA.categorical_info
    _, _, bits_cpu = gumbel_bits((0, 42), 128, info, device="cpu")
    _, _, bits_card = gumbel_bits((0, 42), 128, info, device=dev)
    assert torch.equal(bits_card.cpu(), bits_cpu)
    assert torch.equal(_uniform_from_bits(bits_card, torch.float32).cpu(),
                       _uniform_from_bits(bits_cpu, torch.float32))
    cpu = derive_gumbel_noise((0, 42), 128, info, device="cpu")
    card = derive_gumbel_noise((0, 42), 128, info, device=dev)
    eps = torch.finfo(torch.float32).eps
    for idx in info:
        assert card[idx].device.type == "cuda"
        bar = torch.clamp_min(2 * eps * cpu[idx].abs(), 1e-6)
        assert bool(((card[idx].cpu() - cpu[idx]).abs() <= bar).all())


# ------------------------------------------------- the serving front door
@pytest.mark.parametrize("app", ["mnist", "house", "moons"])
def test_wire_round_trip_equals_the_engine_on_the_card(app, monkeypatch):
    """Each family's engine (`cfgan_torch.serve.launch.setup_*` on its
    committed run dir; MNIST's test split from the IDX fixture) behind
    `make_server`: a counterfactual at b=1 and b=128 over npz and over
    JSON equals the engine's own, bit for bit."""
    import threading
    from pathlib import Path

    from cfgan_torch.models.tabular import jax_key
    from cfgan_torch.serve import CFClient, launch
    from cfgan_torch.serve.api import make_server

    dev = _card()
    root = Path(__file__).resolve().parent.parent
    monkeypatch.setenv("CFGAN_DATA_DIR",
                       str(root / "tests" / "fixtures" / "mnist_idx"))
    run = root / "results" / {"mnist": "mnist_countergan_seed43",
                              "house": "house_countergan",
                              "moons": "moons_countergan"}[app]
    out = launch.SETUPS[app](str(run), device=dev)
    engine, x = out[0], out[2] if app == "moons" else out[1]
    server = make_server(engine, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        for b in (1, 128):
            xb = np.resize(x, (b, *x.shape[1:])).astype(np.float32)
            t = np.arange(b) % engine.num_classes
            want = engine.generate(xb, t, key=jax_key(7))
            for wire in ("npz", "json"):
                got = CFClient(base, wire=wire).counterfactual(xb, t, seed=7)
                for field in ("x_cf", "residual", "pred", "confidence",
                              "probs", "probs_orig", "flipped"):
                    assert np.array_equal(getattr(got, field),
                                          getattr(want, field)), (b, wire,
                                                                  field)
    finally:
        server.shutdown()
        server.server_close()


# ------------------------------------------------------------ moons
def _moons_pair(dev, seed=0):
    """Two moons bundles (the shipped preset at full width) from one
    initial state, the training set on the card, one epoch's permutation
    (15 steps of 64) and draws."""
    from cfgan_torch.core.config import MOONS_COUNTERGAN
    from cfgan_torch.data.moons import load_moons3
    from cfgan_torch.data.pipeline import epoch_perm
    from cfgan_torch.models.classifiers import MLPClassifier
    from cfgan_torch.train.builders import build_moons_countergan

    (xtr, ytr), _, _ = load_moons3()
    clf = MLPClassifier(generator=torch.Generator().manual_seed(0))
    a, b = (build_moons_countergan(MOONS_COUNTERGAN, clf.state_dict(),
                                   seed=seed, device=dev) for _ in range(2))
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.as_tensor(xtr).to(dev)
    y = torch.as_tensor(ytr).to(dev, torch.long)
    perm = epoch_perm(g, len(y), 64)
    return a, b, x, y, perm, a.draw_fn(g, tuple(perm.shape))


def test_moons_step_on_the_kernels_equals_the_plain_epilogue(monkeypatch):
    """Three moons steps launch the epilogue kernels once forward and once
    backward each, in the 4-byte variant ((64, 2) rows, unclamped), and
    give the losses of the same steps on the plain epilogue within 1e-4
    and the same critic `u`."""
    dev = _card()
    a, b, x, y, perm, draws = _moons_pair(dev)
    f0, b0 = tep.cf_epilogue_fwd.launches, tep.cf_epilogue_bwd.launches
    got = [a.step_from_draws(a.state, x[perm[i]], y[perm[i]],
                             {k: v[i] for k, v in draws.items()})
           for i in range(3)]
    torch.cuda.synchronize()
    assert (tep.cf_epilogue_fwd.launches - f0,
            tep.cf_epilogue_bwd.launches - b0) == (3, 3)
    assert tep.cf_epilogue_fwd.last_float4 is False
    assert tep.cf_epilogue_bwd.last_float4 is False
    monkeypatch.setattr(tep, "cf_epilogue_fwd", tep.cf_epilogue_fwd_plain)
    monkeypatch.setattr(tep, "cf_epilogue_bwd", tep.cf_epilogue_bwd_plain)
    want = [b.step_from_draws(b.state, x[perm[i]], y[perm[i]],
                              {k: v[i] for k, v in draws.items()})
            for i in range(3)]
    for g_, w in zip(got, want):
        for k in ("d_loss", "g_loss"):
            assert abs(g_[k].item() - w[k].item()) <= 1e-4, k
    for (name, m), n in zip(a.state.d.model.named_children(),
                            b.state.d.model.children()):
        assert torch.allclose(m.u, n.u, atol=1e-5), name


def test_moons_replayed_steps_equal_eager_steps():
    """A moons epoch (15 steps: 3 eager, a capture, 12 replays) equals the
    same steps run eagerly, bit for bit: every step's metrics, and every
    parameter, BatchNorm statistic, critic `u` and Adam tensor."""
    dev = _card()
    from cfgan_torch.train.loop import make_epoch_runner

    a, b, x, y, perm, draws = _moons_pair(dev)
    runner = make_epoch_runner(a.step_from_draws, reduce=False)
    got = runner(a.state, x, y, perm, draws)
    assert (runner.captures, runner.replays) == (1, 15 - 3)
    for i in range(perm.shape[0]):
        m = b.step_from_draws(b.state, x[perm[i]], y[perm[i]],
                              {k: v[i] for k, v in draws.items()})
        for k, v in m.items():
            assert got[k][i] == np.float32(v.item()), (i, k)
    for net in ("g", "d"):
        sa, sb = getattr(a.state, net), getattr(b.state, net)
        for (name, t), u in zip(sa.model.state_dict().items(),
                                sb.model.state_dict().values()):
            assert torch.equal(t, u), (net, name)
        for p, q in zip(sa.model.parameters(), sb.model.parameters()):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(sa.opt.state[p][key], sb.opt.state[q][key])
    assert a.state.g_ema is None and b.state.g_ema is None


def test_moons_experiment_runs_on_the_card(tmp_path):
    """`run()` of the moons experiment on the card (20 classifier steps, 2
    epochs): every epoch's steps through the runner, the run dir and its
    provenance record, and a rerun that trains nothing."""
    dev = _card()
    from cfgan_torch.core.provenance import check_run_provenance
    from cfgan_torch.experiments import moons_countergan as exp
    from cfgan_torch.experiments.presets import MOONS_COUNTERGAN as PRESET

    cfg = PRESET.replace(classifier=replace(PRESET.classifier, steps=20),
                         countergan=replace(PRESET.countergan, epochs=2))
    out = exp.run(cfg, out_dir=str(tmp_path), device=dev, log=lambda s: None)
    runner = out["bundle"].epoch_fn
    assert runner.captures == 1 and runner.replays == 2 * 15 - 3
    assert check_run_provenance(str(tmp_path))["serving_candidate"] == \
        "snapshot_e2_live"
    text = (tmp_path / "countergan_metrics_per_mask.csv").read_text()
    again = exp.run(cfg, out_dir=str(tmp_path), device=dev,
                    log=lambda s: None)
    assert again["history"] == {}
    assert (tmp_path / "countergan_metrics_per_mask.csv").read_text() == text


# ------------------------------------------- the plain-generation GANs
def _gan_pair(dev, family, n_steps=6, batch=16, seed=0):
    """Two bundles of the family's preset at small width from one initial
    state, a device dataset, one epoch's permutation and draws."""
    from cfgan_torch.experiments import presets
    from cfgan_torch.train.gan_builders import build_gan

    preset = {"dcgan": presets.DCGAN_MNIST,
              "wgan_gp": presets.WGAN_GP_MNIST}[family]
    cfg = replace(preset.gan, hidden_dim=16, latent_dim=8)
    a, b = (build_gan(cfg, num_classes=10, seed=seed, device=dev)
            for _ in range(2))
    side = 64 if family == "dcgan" else 28
    g = torch.Generator(device=dev).manual_seed(seed)
    n = n_steps * batch
    x = torch.rand((n, side, side, 1), device=dev, generator=g) * 2 - 1
    y = torch.randint(0, 10, (n,), device=dev, generator=g)
    perm = torch.randperm(n, device=dev, generator=g).reshape(-1, batch)
    return a, b, x, y, perm, a.draw_fn(g, tuple(perm.shape))


@pytest.mark.parametrize("family", ["dcgan", "wgan_gp"])
def test_gan_replayed_steps_equal_eager_steps(family):
    """Two epochs through the runner equal the same steps run eagerly, bit
    for bit: metrics, parameters, BatchNorm statistics and Adam/AdamW
    tensors.  WGAN-GP's runner captures its critic-only step and its
    critic + generator step (global steps 0, 5, 10 update G) and replays
    them in the order of the global step."""
    dev = _card()
    _deterministic()
    from cfgan_torch.train.loop import make_epoch_runner

    a, b, x, y, perm, draws = _gan_pair(dev, family)
    runner = make_epoch_runner(a.step_from_draws, reduce=False,
                               schedule=a.schedule)
    got = [runner(a.state, x, y, perm, draws) for _ in range(2)]
    steps = perm.shape[0]
    assert runner.captures == (2 if family == "wgan_gp" else 1)
    assert runner.replays == 2 * steps - 3
    for epoch in range(2):
        for i in range(steps):
            m = b.step_from_draws(b.state, x[perm[i]], y[perm[i]],
                                  {k: v[i] for k, v in draws.items()})
            for k, v in m.items():
                assert got[epoch][k][i] == np.float32(v.item()), (epoch, i, k)
    assert a.state.step == b.state.step == 2 * steps
    for net in ("g", "d"):
        sa, sb = getattr(a.state, net), getattr(b.state, net)
        for (name, t), u in zip(sa.model.state_dict().items(),
                                sb.model.state_dict().values()):
            assert torch.equal(t, u), (net, name)
        for p, q in zip(sa.model.parameters(), sb.model.parameters()):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(sa.opt.state[p][key], sb.opt.state[q][key])
    if family == "wgan_gp":
        assert {int(a.state.g.opt.state[p]["step"])
                for p in a.g_model.parameters()} == {3}


def test_cgan_moons_generation_runs_on_the_card(tmp_path):
    """`run()` of cgan_moons on the card (5 epochs of the 31-step moons
    epoch through the runner) writes a `generator/` that the port restores
    to the same samples, and the card's samples are the CPU's within
    1e-6."""
    dev = _card()
    from cfgan_torch.experiments import generation as gen
    from cfgan_torch.train.gan_builders import build_gan

    out = gen.run("cgan_moons", epochs=5, out_dir=str(tmp_path), device=dev,
                  log=lambda s: None)
    runner = out["bundle"].epoch_fn
    assert runner.captures == 1 and runner.replays == 5 * 31 - 3
    assert sorted(out["history"]) == ["d_fake", "d_loss", "d_real",
                                      "g_loss", "wall_time_s"]
    bundle = out["bundle"]
    z, oh, _ = out["fixed_noise"]
    g_vars = gen.load_generator(str(tmp_path / "generator"), bundle)
    again = bundle.sample_fn(g_vars, z, oh).cpu().numpy()
    assert np.array_equal(again, out["samples"])
    cpu = build_gan(bundle.cfg, num_classes=2, device="cpu")
    on_cpu = cpu.sample_fn({k: v.cpu() for k, v in g_vars.items()},
                           z.cpu(), oh.cpu()).numpy()
    np.testing.assert_allclose(on_cpu, out["samples"], rtol=0, atol=1e-6)


# ---------------------------------------------------------- figures
def _figure_routes(dev, dtype):
    """A narrow served preset (hidden 32, two residual blocks) on the card
    twice from one state: its routed convs on the kernel, and switched to
    the plain version.  Returns (kernel cf_fn, plain cf_fn, clf_fn, the
    routed layers a forward), the cf_fns in the figures' signature."""
    cfg = replace(MNIST_COUNTERGAN, hidden_dim=32, num_res_blocks=2,
                  conv_impl="pallas", compute_dtype=dtype)
    g, c = mnist_models(cfg, generator=torch.Generator().manual_seed(0))
    fns = []
    for plain in (False, True):
        s = build_mnist_serving(cfg, g.state_dict(), c.state_dict(),
                                device=dev)
        routed = [m for m in s.generator.modules()
                  if isinstance(m, Conv) and m.impl == "pallas"]
        for m in routed if plain else ():
            m.impl = "matmul"
        fns.append(lambda g_vars, x, t, m, key=None, s=s: s.cf_fn(x, t, m,
                                                                  key))
    return fns[0], fns[1], s.clf_fn, len(routed)


def _figure_data():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (40, 28, 28, 1)).astype(np.float32)
    y = np.arange(40) % 10
    return x, y


def _saved_figures(monkeypatch):
    """Record each figure the raster saves, by file name."""
    from cfgan_torch.eval import figure

    saved = {}
    save = figure.Figure.save

    def spy(self, path):
        saved[path.replace("\\", "/").rsplit("/", 1)[-1]] = self
        return save(self, path)

    monkeypatch.setattr(figure.Figure, "save", spy)
    return saved


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_figures_through_the_kernel_equal_the_plain_conv(dtype, tmp_path,
                                                         monkeypatch):
    """The counterfactual grid and the heatmap panels through the conv
    kernel against the same figures through its plain version: every
    image panel within 1e-4 (f32) or 2**-7 (bf16, one ulp at the clamp);
    in f32 the flips, predictions and confidences (1e-4) too."""
    from cfgan_torch.eval.images import counterfactual_grid, heatmap_panels

    dev = _card()
    kernel, plain, clf, _ = _figure_routes(dev, dtype)
    x, y = _figure_data()
    mask = np.ones((8, 28, 28, 1), np.float32)
    mask[:, :14] = 0.0
    out = {}
    for name, cf in (("kernel", kernel), ("plain", plain)):
        saved = _saved_figures(monkeypatch)
        flips = counterfactual_grid(cf, clf, {}, x, y, 10,
                                    str(tmp_path / name / "grid.png"),
                                    device=dev)
        panels = heatmap_panels(cf, clf, {}, x[:8], y[:8], (y[:8] + 3) % 10,
                                mask, str(tmp_path / name), device=dev)
        out[name] = flips, panels, dict(saved)
    atol = 1e-4 if dtype == "float32" else 2.0 ** -7
    (fk, pk, sk), (fp, pp, sp) = out["kernel"], out["plain"]
    assert sorted(sk) == sorted(sp) and len(sk) == 10
    for name, fig in sk.items():
        for ax, ax_p in zip(fig.axes, sp[name].axes):
            for im, im_p in zip(ax.images, ax_p.images):
                np.testing.assert_allclose(im["data"], im_p["data"],
                                           atol=atol, rtol=0)
    if dtype == "float32":
        np.testing.assert_array_equal(fk, fp)
        np.testing.assert_array_equal(pk["preds"], pp["preds"])
        np.testing.assert_allclose(pk["confidence"], pp["confidence"],
                                   atol=1e-4, rtol=0)


def test_figures_launch_the_kernel_once_a_routed_layer_a_forward(tmp_path):
    """Each MNIST figure's conv launches on the card: the routed layers
    once per generator forward (grid 1, heatmaps 1, user example 1,
    patch-budget curve one a budget); the patch grid none."""
    from cfgan_torch.eval.images import (
        counterfactual_grid,
        heatmap_panels,
        patch_grid_overlay,
        user_modification_example,
    )
    from cfgan_torch.eval.mask_analysis import patch_budget_curve

    dev = _card()
    kernel, _, clf, routed = _figure_routes(dev, "bfloat16")
    x, y = _figure_data()
    mask = np.ones((8, 28, 28, 1), np.float32)
    draws = {
        "grid": (1, lambda: counterfactual_grid(
            kernel, clf, {}, x, y, 10, str(tmp_path / "g.png"), device=dev)),
        "heatmaps": (1, lambda: heatmap_panels(
            kernel, clf, {}, x[:8], y[:8], y[:8], mask, str(tmp_path),
            device=dev)),
        "user": (1, lambda: user_modification_example(
            kernel, clf, {}, x[0], 3, [6, 7], 7,
            path=str(tmp_path / "u.png"), device=dev)),
        "budget": (8, lambda: patch_budget_curve(
            kernel, clf, {}, x, y, 10, 7, out_dir=str(tmp_path),
            generator=torch.Generator(device=dev).manual_seed(0),
            device=dev)),
        "patch_grid": (0, lambda: patch_grid_overlay(
            x[0], 7, str(tmp_path / "p.png")))}
    for name, (forwards, draw) in draws.items():
        before = tconv.conv3x3_same.launches
        draw()
        torch.cuda.synchronize()
        assert tconv.conv3x3_same.launches - before == routed * forwards, name


# ------------------------------------------------------------ sharding
@pytest.fixture
def world_of_one():
    """A torch.distributed world of this one process on the card (NCCL),
    destroyed after the test."""
    import torch.distributed as dist

    from cfgan_torch.parallel.mesh import free_port

    dev = _card()
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def test_world_of_one_captures_the_collectives(world_of_one):
    """The moons epoch on a state replicated on an NCCL world of one: the
    runner captures the step with its all-reduces (BatchNorm statistics,
    gradients, metrics) and replays it under sync debug mode "error"; the
    metrics and the whole state equal the same epoch without a mesh bit
    for bit."""
    from cfgan_torch.parallel import create_mesh, replicate
    from cfgan_torch.parallel.sharding import state_tensors

    dev = world_of_one
    a, b, x, y, perm, draws = _moons_pair(dev)
    replicate(create_mesh(), a.state)
    got = a.epoch_fn(a.state, x, y, perm, draws)
    want = b.epoch_fn(b.state, x, y, perm, draws)
    assert got == want
    assert a.epoch_fn.captures == 1 and a.epoch_fn.replays == len(perm) - 3
    for p, q in zip(state_tensors(a.state), state_tensors(b.state)):
        assert torch.equal(p, q)


def test_world_of_one_captures_a_channel_sharded_step(world_of_one):
    """The moons epoch on a (1, 1) ("data", "model") mesh of an NCCL world
    of one, the generator channel-sharded over "model": the runner
    captures the step with the layout's slice copies and replays it; the
    metrics and the whole state (the generator's slices against its
    parameters) equal the same epoch without a mesh bit for bit."""
    from cfgan_torch.parallel import (
        channel_sharding_spec,
        create_mesh,
        replicate,
        shard_leaves,
    )

    dev = world_of_one
    a, b, x, y, perm, draws = _moons_pair(dev)
    mesh = create_mesh((1, 1), ("data", "model"))
    replicate(mesh, a.state)
    shard_leaves(a.state.g, channel_sharding_spec(mesh, a.state.g))
    assert a.state.g.layout is not None
    got = a.epoch_fn(a.state, x, y, perm, draws)
    want = b.epoch_fn(b.state, x, y, perm, draws)
    assert got == want
    assert a.epoch_fn.captures == 1 and a.epoch_fn.replays == len(perm) - 3
    for net in ("g", "d"):
        sa, sb = getattr(a.state, net), getattr(b.state, net)
        for (name, p), q in zip(sa.opt_params().items(),
                                sb.model.parameters()):
            assert torch.equal(p, q), name
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(sa.opt.state[p][key],
                                   sb.opt.state[q][key]), (name, key)
        for p, q in zip(sa.model.parameters(), sb.model.parameters()):
            assert torch.equal(p, q)


def test_engine_on_a_2d_mesh_of_the_card_equals_the_unsharded_one():
    """The moons engine sharded on a (2, 1) ("data", "model") mesh over
    the card twice: 2 shards along "data", 1 along "model", each equal to
    the unsharded engine within the sharded serving bar 1e-6."""
    from pathlib import Path

    from cfgan_torch.parallel import create_mesh
    from cfgan_torch.serve import launch

    dev = _card()
    run_dir = str(Path(__file__).resolve().parent.parent / "results"
                  / "moons_countergan")
    plain, _, xte, _ = launch.setup_moons(run_dir, device=dev)
    mesh = create_mesh((2, 1), ("data", "model"), devices=[dev, dev])
    for axis, n in (("data", 2), ("model", 1)):
        eng = launch.setup_moons(run_dir, device=dev)[0].shard(mesh, axis)
        assert len(eng._shards) == n
        for b in (1, 5, 100):
            got, want = eng.generate(xte[:b], 1), plain.generate(xte[:b], 1)
            for name in ("x_cf", "residual", "probs", "probs_orig"):
                np.testing.assert_allclose(getattr(got, name),
                                           getattr(want, name), rtol=0,
                                           atol=1e-6, err_msg=(axis, name))
            np.testing.assert_array_equal(got.pred, want.pred)


def test_runner_refuses_a_gloo_group_on_the_card():
    """A CUDA state on a gloo group cannot be captured: the runner raises
    and names the cause; it does not run eager steps instead."""
    import torch.distributed as dist

    from cfgan_torch.parallel import create_mesh, replicate
    from cfgan_torch.parallel.mesh import free_port

    dev = _card()
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        a, _, x, y, perm, draws = _moons_pair(dev)
        replicate(create_mesh(devices=[dev]), a.state)
        with pytest.raises(RuntimeError, match="gloo"):
            a.epoch_fn(a.state, x, y, perm, draws)
        assert a.state.step == 0
    finally:
        dist.destroy_process_group()


# ------------------------------------------------- the host pipeline
def _host_batches(n=40, batch=8, seed=0):
    from cfgan_torch.data.pipeline import HostIterator

    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n, 28, 28, 1)).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.int64)
    return HostIterator((x, y), batch), list(HostIterator((x, y), batch))


def _chrome_events(prof, tmp_path) -> list:
    import json

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def test_prefetcher_copies_on_its_stream_from_pinned_buffers(tmp_path):
    """Every host-to-device copy of a batch is a pinned copy on one stream
    that no kernel of the consumer runs on; the pinned buffers, at most a
    ring of 3 per array at buffer_size 2, are reused before another is
    allocated: the short last batch's own ring holds one buffer an array
    in every epoch, and no ring outgrows its 3."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from cfgan_torch.data.pipeline import DevicePrefetcher

    dev = _card()
    host, want = _host_batches(n=44)  # 5 batches of 8 and one of 4
    feed = DevicePrefetcher(host, buffer_size=2)
    assert feed.device.type == "cuda"
    sizes = {b.nbytes for batch in want for b in batch}
    allocated = None
    for _ in range(3):  # a trace drops records now and then
        # a warm-up step first: a trace's first records may be lost
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            torch.ones(8, device=dev).sum().item()
            prof.step()
            for x, y in feed:
                (x.sum() + y.sum()).item()
            torch.cuda.synchronize()
            prof.step()
        if allocated is None:
            allocated = feed.pinned_buffers
        events = _chrome_events(prof, tmp_path)
        copies = [e for e in events if e.get("cat") == "gpu_memcpy"
                  and e.get("args", {}).get("bytes") in sizes]
        if len(copies) == 2 * len(want):
            break
    assert all(b.is_pinned() for r in feed._rings.values()
               for b in r.buffers)
    kernels = {e["args"]["stream"] for e in events
               if e.get("cat") == "kernel"}
    assert len(copies) == 2 * len(want)
    streams = {e["args"]["stream"] for e in copies}
    assert len(streams) == 1 and not streams & kernels
    assert all("Pinned" in e["name"] and "HtoD" in e["name"]
               for e in copies)
    assert feed.stream != torch.cuda.current_stream(dev)
    allocated = [allocated]
    short = [r for r in feed._rings.values() if r.shape[0] == 4]
    for _ in range(4):
        got = [tuple(t.cpu().numpy() for t in b) for b in feed]
        allocated.append(feed.pinned_buffers)
        assert len(short) == 2 and all(len(r.buffers) == 1 for r in short)
        for g, w in zip(got, want):
            assert all(np.array_equal(a, b) for a, b in zip(g, w))
    # two arrays: full-batch rings of 1-3 buffers, short rings of 1
    assert len(feed._rings) == 4
    assert all(len(r.buffers) <= 3 for r in feed._rings.values())
    assert 4 <= allocated[0] and max(allocated) <= 8
    assert allocated == sorted(allocated)


@pytest.mark.parametrize("keep", [True, False], ids=["kept", "dropped"])
def test_a_slow_consumer_reads_each_batch_bits(keep):
    """The consumer's stream sleeps before reading each batch, so the
    copies run far ahead: every batch still holds its own bits.  With
    `dropped` each batch is released right after its read is queued, so
    a tensor whose memory the allocator handed back to the copy stream
    before the read ran would show the next batch's bits."""
    from cfgan_torch.data.pipeline import DevicePrefetcher

    _card()
    host, want = _host_batches(n=96, batch=8, seed=1)
    kept, reads = [], []
    for x, y in DevicePrefetcher(host, buffer_size=2):
        torch.cuda._sleep(20_000_000)  # ~10 ms of the consumer stream
        reads.append((x * 1.0, y + 0))
        if keep:
            kept.append((x, y))
        del x, y
    torch.cuda.synchronize()
    assert len(reads) == len(want)
    for (gx, gy), (wx, wy) in zip(reads, want):
        assert np.array_equal(gx.cpu().numpy(), wx)
        assert np.array_equal(gy.cpu().numpy(), wy)


def test_prefetcher_memory_is_not_reused_under_the_consumer():
    """A yielded tensor's block goes back to the allocator only after the
    consumer stream's work on it: while the consumer sleeps on batch k,
    no later batch lands in batch k's memory."""
    from cfgan_torch.data.pipeline import DevicePrefetcher

    dev = _card()
    host, want = _host_batches(n=64, batch=8, seed=2)
    consumer = torch.cuda.current_stream(dev)
    seen = []
    it = iter(DevicePrefetcher(host, buffer_size=2))
    x, _ = next(it)
    ptr = x.data_ptr()
    torch.cuda._sleep(50_000_000)  # the consumer is busy for ~25 ms
    snapshot = x * 1.0
    del x
    for x, _ in it:  # copies of the rest queue up meanwhile
        seen.append(x.data_ptr())
        del x
    assert not consumer.query()  # still sleeping when the copies were issued
    torch.cuda.synchronize()
    assert seen and ptr not in seen
    assert np.array_equal(snapshot.cpu().numpy(), want[0][0])


def test_device_put_dataset_on_the_card():
    from cfgan_torch.data.pipeline import device_put_dataset
    from cfgan_torch.parallel import create_mesh

    dev = _card()
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    got = device_put_dataset(create_mesh(devices=[dev]), x)
    assert got[0].device.type == "cuda"
    assert np.array_equal(got[0].cpu().numpy(), x)
