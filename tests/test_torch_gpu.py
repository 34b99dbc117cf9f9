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
from cfgan_torch.ops import conv as tconv
from cfgan_torch.serve.engine import CounterfactualEngine
from cfgan_torch.train.builders import build_mnist_serving, mnist_models

pytestmark = pytest.mark.gpu

# (B, H, W, Cin, Cout): the serving layer; several tiles across W; one
# row; Cin not a multiple of the kernel's 16-channel stage; Cout over
# two 64-channel tiles
SHAPES = [(128, 28, 28, 64, 64), (2, 5, 70, 16, 16), (3, 1, 9, 16, 24),
          (4, 13, 11, 20, 130), (9, 7, 5, 32, 64)]


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
