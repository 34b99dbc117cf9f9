"""The port's layers (cfgan_torch.nn) against flax `apply` of the JAX
package's layers, on weights carried across by cfgan_torch.convert.

f32 tolerance: abs <= 1e-5 (the same float32 arithmetic, summed in other
orders by XLA and by PyTorch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgan.nn import layers as jl
from cfgan_torch.convert import state_dict_from_flax
from cfgan_torch.nn import init as tinit
from cfgan_torch.nn import layers as tl
from cfgan_torch.ops import conv as tconv


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _with_random_stats(variables, rng):
    """Give BatchNorm non-trivial statistics and affine parameters."""
    v = _np_tree(variables)

    def bn(tree):
        return {k: (bn(a) if isinstance(a, dict) else
                    rng.uniform(0.5, 1.5, a.shape).astype(np.float32))
                for k, a in tree.items()}

    if "batch_stats" in v:
        v["batch_stats"] = bn(v["batch_stats"])
    return v


def _parity(jmod, tmod, *args, atol=1e-5, jkw=None, init_args=None):
    rng = np.random.default_rng(0)
    jargs = [jnp.asarray(a) for a in args]
    variables = jmod.init(jax.random.key(0), *(init_args or jargs),
                          **(jkw or {}))
    variables = _with_random_stats(variables, rng)
    tmod.load_state_dict(state_dict_from_flax(tmod, variables))
    tmod.eval()
    want = np.asarray(jmod.apply(variables, *jargs, **(jkw or {})))
    with torch.no_grad():
        got = tmod(*[torch.from_numpy(np.asarray(a)) for a in args]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_linear():
    _parity(jl.Linear(7), tl.Linear(5, 7), _x((4, 5)))


# (Cin, Cout, stride, padding, impl)
CONVS = [
    (3, 16, 1, 1, None),      # conv_in on cuDNN
    (32, 64, 2, 1, None),     # the classifier's stride-2 convs
    (16, 24, 1, 1, "matmul"),
    (16, 24, 1, 1, "pallas"),  # routed to the kernel
    (3, 16, 1, 1, "pallas"),  # Cin < 16: the gate keeps it on cuDNN
    (16, 1, 1, 1, "pallas"),  # Cout < 16: likewise
    (16, 16, 2, 1, "pallas"),  # stride 2: not a kernel shape
]


@pytest.mark.parametrize("cin,cout,stride,pad,impl", CONVS, ids=str)
def test_conv(cin, cout, stride, pad, impl):
    tmod = tl.Conv(cin, cout, 3, stride, pad, impl=impl)
    routed = impl is not None and min(cin, cout) >= 16 and stride == 1
    assert (tmod.impl is not None) == routed
    assert hasattr(tmod, "kernel") == routed
    _parity(jl.Conv(cout, 3, stride, pad, impl=impl), tmod,
            _x((3, 9, 7, cin)))


def test_conv_state_dict_loads_across_impls():
    """A conv's weights carry between the cuDNN layout (OIHW `weight`)
    and the kernel's (HWIO `kernel`), as the JAX package's params do
    between its impls; the two compute the same function."""
    g = torch.Generator().manual_seed(0)
    a = tl.Conv(16, 24, 3, 1, 1, impl=None, generator=g)
    b = tl.Conv(16, 24, 3, 1, 1, impl="pallas")
    b.load_state_dict(a.state_dict())
    assert torch.equal(b.kernel, a.weight.permute(2, 3, 1, 0))
    c = tl.Conv(16, 24, 3, 1, 1, impl=None)
    c.load_state_dict(b.state_dict())
    assert torch.equal(c.weight, a.weight)
    x = torch.from_numpy(_x((2, 6, 5, 16)))
    with torch.no_grad():
        torch.testing.assert_close(b(x), a(x), atol=1e-5, rtol=0)


def test_batchnorm_eval():
    x = _x((4, 5, 3, 8))
    jmod = jl.BatchNorm(use_running_average=True)
    _parity(jmod, tl.BatchNorm(8), x)


def test_embed():
    idx = np.array([3, 0, 9, 3], dtype=np.int32)
    _parity(jl.Embed(10, 12), tl.Embed(10, 12), idx)


@pytest.mark.parametrize("impl", [None, "pallas"])
def test_conv_resblock(impl):
    x = _x((3, 8, 6, 16))
    _parity(jl.ConvResBlock(16, conv_impl=impl),
            tl.ConvResBlock(16, conv_impl=impl), x,
            jkw={"train": False})


def test_leaky_relu():
    x = _x((64,))
    np.testing.assert_allclose(
        tl.leaky_relu(torch.from_numpy(x)).numpy(),
        np.asarray(jl.leaky_relu(jnp.asarray(x))), atol=0, rtol=0)


@pytest.mark.parametrize("channelwise", [False, True])
def test_dropout(channelwise):
    """Identity in eval, as the JAX package's deterministic dropout; in
    train mode it keeps 1 - rate of the entries (whole channels when
    channelwise) and scales them by 1 / (1 - rate)."""
    x = torch.ones(64, 4, 4, 32)
    d = tl.Dropout(0.25, channelwise=channelwise)
    assert d.eval()(x) is x
    torch.manual_seed(0)
    y = d.train()(x)
    assert set(torch.unique(y).tolist()) <= {0.0, float(np.float32(1 / 0.75))}
    assert abs((y > 0).float().mean().item() - 0.75) < 0.03
    if channelwise:
        assert bool((y == y[:, :1, :1, :]).all())


@pytest.mark.parametrize("name", ["scaled_uniform", "kaiming_normal",
                                  "normal"])
def test_init_distributions(name):
    """Same distributions as cfgan.nn.init (PRNG streams differ, so the
    moments are compared with the formulas), same draw for one seed."""
    shape, fan_in = (200, 300), 300

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        if name == "scaled_uniform":
            return tinit.scaled_uniform(shape, fan_in, g)
        if name == "kaiming_normal":
            return tinit.kaiming_normal(shape, fan_in, 0.2, g)
        return tinit.normal(shape, 0.01, g)

    w = draw(3)
    assert torch.equal(w, draw(3))
    std = {"scaled_uniform": 1 / np.sqrt(3 * fan_in),
           "kaiming_normal": np.sqrt(2 / 1.04 / fan_in),
           "normal": 0.01}[name]
    assert abs(w.mean().item()) < 0.02 * std
    assert abs(w.std().item() / std - 1) < 0.02
    if name == "scaled_uniform":
        assert w.abs().max().item() <= 1 / np.sqrt(fan_in)


def test_conv_layer_counts_no_launch_on_cpu():
    before = tconv.conv3x3_same.launches
    m = tl.Conv(16, 16, 3, 1, 1, impl="pallas")
    with torch.no_grad():
        m(torch.zeros(1, 4, 4, 16))
    assert tconv.conv3x3_same.launches == before
