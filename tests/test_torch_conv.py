"""The port's 3x3 conv (cfgan_torch.ops.conv) against the JAX package's
Pallas kernel (interpret mode on the CPU) and its matmul decomposition.

f32 tolerance: abs <= 1e-5.  The three compute the same nine-tap sum in
float32 in different orders; at these sizes the reordering moves the
result by a few float32 ulps of values of order 1.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgan.ops.conv import (
    conv3x3_same_matmul,
    conv_flops as jax_conv_flops,
    make_conv3x3_same_pallas,
)
from cfgan_torch.ops import _build
from cfgan_torch.ops import conv as tconv

# (B, H, W, Cin, Cout): B not a multiple of the Pallas tile of 8, W != H,
# Cin != Cout, and the serving layer's channel count
SHAPES = [(5, 9, 7, 16, 24), (3, 6, 10, 8, 4), (2, 28, 28, 64, 64)]


def _inputs(shape, seed=0):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout))
         / np.sqrt(9 * cin)).astype(np.float32)
    return x, k


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("reference", ["pallas_interpret", "matmul"])
def test_plain_conv_matches_jax_f32(shape, reference):
    x, k = _inputs(shape)
    if reference == "pallas_interpret":
        want = make_conv3x3_same_pallas(interpret=True)(jnp.asarray(x),
                                                        jnp.asarray(k))
    else:
        want = conv3x3_same_matmul(jnp.asarray(x), jnp.asarray(k))
    got = tconv.conv3x3_same_plain(torch.from_numpy(x), torch.from_numpy(k))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_plain_conv_bf16_rounds_once_like_jax():
    """bf16 in, f32 accumulation, one rounding: within one bf16 ulp of
    the JAX matmul decomposition, plus the f32 tolerance (the f32 sums
    differ in order, so a sum near a rounding boundary may round the
    other way)."""
    x, k = _inputs((3, 9, 11, 16, 24), seed=1)
    xb, kb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)
    want = np.asarray(conv3x3_same_matmul(xb, kb).astype(jnp.float32))
    got = tconv.conv3x3_same_plain(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(k).bfloat16())
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    assert np.all(np.abs(got.float().numpy() - want) <= ulp + 1e-5)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    x, k = _inputs(SHAPES[0])
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    before = tconv.conv3x3_same.launches
    got = tconv.conv3x3_same(xt, kt)
    assert tconv.conv3x3_same.launches == before
    assert torch.equal(got, tconv.conv3x3_same_plain(xt, kt))


def test_wrapper_does_not_fall_back_when_the_build_fails(monkeypatch):
    """Off the CPU the wrapper launches the kernel or raises: with the
    loader failing, a non-CPU tensor gets the loader's error, not the
    plain version."""
    class BuildFailed(RuntimeError):
        pass

    def fail():
        raise BuildFailed("nvcc failed")

    monkeypatch.setattr(_build, "load_library", fail)
    x = torch.empty((2, 8, 8, 16), device="meta")
    k = torch.empty((3, 3, 16, 16), device="meta")
    with pytest.raises(BuildFailed):
        tconv.conv3x3_same(x, k)


def test_plain_conv_rejects_a_mismatched_kernel():
    with pytest.raises(ValueError):
        tconv.conv3x3_same_plain(torch.zeros(1, 4, 4, 8),
                                 torch.zeros(3, 3, 4, 8))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_conv_flops_matches_jax(shape):
    b, h, w, cin, cout = shape
    assert tconv.conv_flops(b, (h, w), cin, cout) == jax_conv_flops(
        b, (h, w), cin, cout)


def test_nvcc_command_targets_hopper_without_torch_headers():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-Xptxas -v" in flags
    src = _build.SOURCE.read_text()
    assert "#include <torch" not in src and "extension.h" not in src

