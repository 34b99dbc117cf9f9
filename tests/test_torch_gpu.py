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
# tiles; Cin over three 64-channel slices
SHAPES = [(128, 28, 28, 64, 64), (1, 28, 28, 64, 64), (2, 5, 70, 16, 16),
          (3, 1, 9, 16, 24), (2, 13, 11, 20, 40), (4, 13, 11, 20, 130),
          (9, 7, 5, 32, 64), (2, 6, 6, 130, 70)]


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


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_f32_dkernel_matches_plain_with_equal_bits(shape):
    """float32 x and cotangent (3xTF32): each tap's (Cin, Cout) block within
    1e-5 of its 2-norm of the plain version in full float32 (sums of up to
    B*H*W = 100,352 products in another order, each stage's products summed
    apart on the tensor cores); two calls give the same bits."""
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
# step's rows as views one element into their storage (4-byte variant)
EPILOGUE_CASES = [(128, 784, False), (257, 784, False), (3, 17, False),
                  (5, 2, False), (64, 4096, False), (128, 784, True)]


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
