"""The port's fused counterfactual epilogue (cfgan_torch.ops.epilogue)
against the JAX package's `cf_epilogue`, on the CPU, where the port runs
its kernels' plain versions: values on both JAX paths (the jnp path, and
the Pallas kernels in TPU interpret mode, as tests/test_ops_epilogue.py
runs them), gradients under random cotangents on all four outputs against
`jax.vjp`, and `epilogue_terms` for both reductions.

Tolerance rtol 1e-5 / atol 1e-6: the same float32 elementwise operations,
with the row sums taken in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cfgan.ops.epilogue import cf_epilogue as jax_cf_epilogue
from cfgan.ops.epilogue import epilogue_terms as jax_epilogue_terms
from cfgan_torch.ops import _build
from cfgan_torch.ops import epilogue as tep

RTOL, ATOL = 1e-5, 1e-6
SHAPES = [(6, 28, 28, 1), (5, 17), (4, 2)]
BOUNDS = [(-1.0, 1.0), (-1e30, 1e30)]


def _data(shape, seed=0):
    """x, raw and mask with values exactly on the bounds (x = +-1 where
    raw * mask = 0), zeros in raw (sign(0) in the backward) and masked
    zeros where mask = 0."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1.2, 1.2, shape).astype(np.float32)
    raw = rng.normal(0, 0.4, shape).astype(np.float32)
    mask = (rng.uniform(0, 1, shape) > 0.5).astype(np.float32)
    flat = [a.reshape(shape[0], -1) for a in (x, raw, mask)]
    flat[1][:, ::5] = 0.0  # raw zeros
    flat[0][:, 1::5] = 1.0  # x on hi where masked is 0 ...
    flat[2][:, 1::5] = 0.0
    flat[0][:, 2::5] = -1.0  # ... and on lo
    flat[1][:, 2::5] = 0.0
    return x, raw, mask


def _assert_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _port(x, raw, mask, lo, hi, requires_grad=False):
    xt, rt, mt = (torch.tensor(a, requires_grad=requires_grad)
                  for a in (x, raw, mask))
    return (xt, rt, mt), tep.cf_epilogue(xt, rt, mt, lo, hi)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("bounds", BOUNDS, ids=["clamp", "no_clamp"])
@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["jnp", "pallas_interpret"])
def test_forward_matches_jax(shape, bounds, use_pallas):
    x, raw, mask = _data(shape)
    lo, hi = bounds
    if use_pallas:
        with pltpu.force_tpu_interpret_mode():
            want = jax_cf_epilogue(x, raw, mask, lo, hi, True)
    else:
        want = jax_cf_epilogue(x, raw, mask, lo, hi, False)
    _, got = _port(x, raw, mask, lo, hi)
    assert got[0].shape == shape and all(g.shape == (shape[0],)
                                         for g in got[1:])
    for g, w in zip(got, want):
        _assert_close(g.numpy(), w)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("bounds", BOUNDS, ids=["clamp", "no_clamp"])
def test_vjp_matches_jax(shape, bounds):
    """Random cotangents on all four outputs: dx and draw equal
    jax.vjp's, the mask gets no gradient."""
    x, raw, mask = _data(shape, seed=1)
    lo, hi = bounds
    rng = np.random.RandomState(2)
    cts = (rng.normal(size=shape).astype(np.float32),
           *(rng.normal(size=shape[0]).astype(np.float32) for _ in range(3)))
    _, vjp = jax.vjp(lambda a, b: jax_cf_epilogue(a, b, mask, lo, hi, False),
                     jnp.asarray(x), jnp.asarray(raw))
    want_dx, want_draw = vjp(tuple(jnp.asarray(c) for c in cts))
    (xt, rt, mt), outs = _port(x, raw, mask, lo, hi, requires_grad=True)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cts])
    _assert_close(xt.grad.numpy(), want_dx)
    _assert_close(rt.grad.numpy(), want_draw)
    assert mt.grad is None


def test_vjp_matches_pallas_interpret():
    x, raw, mask = _data((8, 28, 28, 1), seed=3)

    def loss(raw_):
        cf, l1, l2, pen = jax_cf_epilogue(x, raw_, mask, -1.0, 1.0, True)
        return jnp.sum(cf ** 2) + jnp.mean(l1) + jnp.mean(pen)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss)(jnp.asarray(raw))
    (_, rt, _), (cf, l1, _, pen) = _port(x, raw, mask, -1.0, 1.0,
                                         requires_grad=True)
    ((cf ** 2).sum() + l1.mean() + pen.mean()).backward()
    _assert_close(rt.grad.numpy(), want)


def test_only_x_raw_and_mask_are_saved():
    x, raw, mask = _data((3, 17))
    (xt, rt, mt), outs = _port(x, raw, mask, -1.0, 1.0, requires_grad=True)
    saved = outs[0].grad_fn.saved_tensors
    assert len(saved) == 3
    assert all(s is t for s, t in zip(saved, (xt, rt, mt)))


@pytest.mark.parametrize("reduction", ["mean_abs", "per_sample_norm"])
def test_epilogue_terms_match_jax(reduction):
    x, raw, mask = _data((6, 28, 28, 1), seed=4)
    _, (_, l1s, l2s, pens) = _port(x, raw, mask, -1.0, 1.0)
    want = jax_epilogue_terms(*jax_cf_epilogue(x, raw, mask, -1.0, 1.0,
                                               False)[1:], 784, reduction)
    got = tep.epilogue_terms(l1s, l2s, pens, 784, reduction)
    for g, w in zip(got, want):
        _assert_close(g.numpy(), w)


def test_plain_versions_are_the_cpu_path_and_launch_nothing():
    x, raw, mask = (torch.from_numpy(a) for a in _data((3, 17)))
    fwd0, bwd0 = tep.cf_epilogue_fwd.launches, tep.cf_epilogue_bwd.launches
    got = tep.cf_epilogue_fwd(x, raw, mask, -1.0, 1.0)
    want = tep.cf_epilogue_fwd_plain(x, raw, mask, -1.0, 1.0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    g = torch.ones(3)
    got = tep.cf_epilogue_bwd(x, raw, mask, x, g, g, g, -1.0, 1.0)
    want = tep.cf_epilogue_bwd_plain(x, raw, mask, x, g, g, g, -1.0, 1.0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (tep.cf_epilogue_fwd.launches, tep.cf_epilogue_bwd.launches) == (
        fwd0, bwd0)


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_wrappers_do_not_fall_back_when_the_build_fails(monkeypatch, which):
    """Off the CPU the wrappers launch the kernel or raise."""
    class BuildFailed(RuntimeError):
        pass

    def fail():
        raise BuildFailed("nvcc failed")

    monkeypatch.setattr(_build, "load_library", fail)
    rows = torch.empty((4, 9), device="meta")
    col = torch.empty((4,), device="meta")
    with pytest.raises(BuildFailed):
        if which == "fwd":
            tep.cf_epilogue_fwd(rows, rows, rows, -1.0, 1.0)
        else:
            tep.cf_epilogue_bwd(rows, rows, rows, rows, col, col, col,
                                -1.0, 1.0)


def test_kernel_entry_points_are_declared():
    """The C entry points of both kernels are bound with pointer-sized
    arguments (a pointer passed as a 32-bit int would be cut): the tensors
    and the stream are pointers, the bounds floats, the variant an int."""
    import ctypes

    for name, tensors in (("cfgan_epilogue_fwd_f32", 5),
                          ("cfgan_epilogue_bwd_f32", 9)):
        args = _build.SIGNATURES[name]
        assert args[:tensors] == [ctypes.c_void_p] * tensors
        assert args[tensors:] == [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [
            ctypes.c_int, ctypes.c_void_p]
    src = (_build.SOURCES[1]).read_text()
    assert "cfgan_epilogue_fwd_f32" in src and "cfgan_epilogue_bwd_f32" in src


def _offset_rows(b, n, offset):
    """A contiguous (b, n) float32 view whose first element lies `offset`
    elements into its storage."""
    return torch.zeros(b * n + offset)[offset:].view(b, n)


@pytest.mark.parametrize("rows, float4", [
    (lambda: [torch.zeros(128, 784) for _ in range(3)], True),
    (lambda: [torch.zeros(5, 17) for _ in range(3)], False),
    (lambda: [torch.zeros(128, 784), _offset_rows(128, 784, 1),
              torch.zeros(128, 784)], False),
    (lambda: [_offset_rows(128, 784, 4) for _ in range(3)], True),
], ids=["784_aligned", "17", "storage_offset_1", "storage_offset_4"])
def test_float4_variant_only_for_aligned_rows(rows, float4):
    """The 16-byte variant needs N % 4 == 0 and every row tensor 16-byte
    aligned; else the wrapper takes the 4-byte variant of the same kernels
    (N = 17; a contiguous view one element into its storage)."""
    rows = rows()
    assert all(t.is_contiguous() for t in rows)
    assert tep.float4_rows(*rows) is float4
