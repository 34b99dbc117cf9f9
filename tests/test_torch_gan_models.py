"""The port's plain-generation networks against the JAX package's, on the
CPU: the five generators and four discriminators of `build_gan`'s
families at small widths (MLP hidden 8, WGAN-GP sizes 16, DCGAN hidden 8 at
64x64), on weights carried over from flax by `cfgan_torch.convert`, in
train mode (batch statistics, the running statistics' update) and in
eval mode (non-trivial running statistics); the DCGAN discriminator's
G-phase call that normalizes by the batch and leaves its running
statistics alone; `ConvTranspose`'s geometry at every (k, s, p) the
generators use; `InstanceNorm`; and the conversion round trip.

Inputs are made from numpy seeds.  Bar: 3e-5 in float32 (TF32 does not
apply on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgan.models import discriminators as jd
from cfgan.models import generators as jg
from cfgan.nn import layers as jl
from cfgan_torch.convert import flax_from_state_dict, state_dict_from_flax
from cfgan_torch.models import discriminators as pd
from cfgan_torch.models import generators as pg
from cfgan_torch.nn import layers as pl

ATOL = 3e-5
B, LD, NC = 6, 8, 10


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def _rand(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _onehot(rng, n=B):
    return np.eye(NC, dtype=np.float32)[rng.randint(0, NC, n)]


# name -> (JAX module, port module, inputs(rng))
def _cases():
    return {
        "MLPGenerator": (jg.MLPGenerator(out_dim=2, hidden_dim=8),
                         pg.MLPGenerator(LD, 2, 8),
                         lambda r: (_rand(r, B, LD),)),
        "ConditionalMLPGenerator": (
            jg.ConditionalMLPGenerator(out_dim=2, hidden_dim=8),
            pg.ConditionalMLPGenerator(LD, NC, 2, 8),
            lambda r: (_rand(r, B, LD), _onehot(r))),
        "MLPImageGenerator": (jg.MLPImageGenerator(),
                              pg.MLPImageGenerator(LD),
                              lambda r: (_rand(r, B, LD),)),
        "DCGANGenerator": (jg.DCGANGenerator(g_hidden=8),
                           pg.DCGANGenerator(LD, 8),
                           lambda r: (_rand(r, B, LD),)),
        "WGANGenerator": (jg.WGANGenerator(generator_size=16, num_classes=NC),
                          pg.WGANGenerator(LD, 16, NC),
                          lambda r: (_rand(r, B, LD), _onehot(r))),
        "MLPDiscriminator": (jd.MLPDiscriminator(hidden_dims=(8,)),
                             pd.MLPDiscriminator(2, (8,)),
                             lambda r: (_rand(r, B, 2),)),
        "MLPDiscriminator_image": (
            jd.MLPDiscriminator(hidden_dims=(16, 8), negative_slope=0.2,
                                flatten=True),
            pd.MLPDiscriminator(784, (16, 8), 0.2, flatten=True),
            lambda r: (_rand(r, B, 28, 28, 1),)),
        "ConditionalMLPDiscriminator": (
            jd.ConditionalMLPDiscriminator(hidden_dim=8),
            pd.ConditionalMLPDiscriminator(2, NC, 8),
            lambda r: (_rand(r, B, 2), _onehot(r))),
        "DCGANDiscriminator": (jd.DCGANDiscriminator(d_hidden=8),
                               pd.DCGANDiscriminator(8),
                               lambda r: (_rand(r, B, 64, 64, 1),)),
        "WGANCritic": (jd.WGANCritic(critic_size=16, hidden_size=16,
                                     num_classes=NC),
                       pd.WGANCritic(16, 16, NC),
                       lambda r: (_rand(r, B, 28, 28, 1), _onehot(r))),
    }


CASES = sorted(_cases())
TRAIN_FLAG = {"MLPImageGenerator", "DCGANGenerator", "WGANGenerator",
              "DCGANDiscriminator"}


def _pair(name, seed=0):
    """(JAX module, its variables with random running statistics, port
    module loaded with them, numpy inputs)."""
    jmod, pmod, inputs = _cases()[name]
    rng = np.random.RandomState(seed)
    args = inputs(rng)
    kw = {"train": False} if name in TRAIN_FLAG else {}
    variables = _np(jmod.init(jax.random.key(seed),
                              *map(jnp.asarray, args), **kw))
    if "batch_stats" in variables:
        variables["batch_stats"] = {
            k: {"mean": _rand(rng, *v["mean"].shape, lo=-0.2, hi=0.2),
                "var": _rand(rng, *v["var"].shape, lo=0.5, hi=1.5)}
            for k, v in variables["batch_stats"].items()}
    pmod.load_state_dict(state_dict_from_flax(pmod, variables), strict=True)
    return jmod, variables, pmod, args


def _port(pmod, args, **kw):
    return pmod(*map(torch.from_numpy, args), **kw).detach().numpy()


@pytest.mark.parametrize("name", CASES)
def test_eval_forward_matches_jax(name):
    jmod, variables, pmod, args = _pair(name)
    kw = {"train": False} if name in TRAIN_FLAG else {}
    want = np.asarray(jmod.apply(variables, *map(jnp.asarray, args), **kw))
    pmod.eval()
    got = _port(pmod, args)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", sorted(TRAIN_FLAG))
def test_train_forward_and_running_stats_match_jax(name):
    """Batch statistics normalize; the running statistics move as JAX's
    mutable `batch_stats` do."""
    jmod, variables, pmod, args = _pair(name, seed=1)
    want, new = jmod.apply(variables, *map(jnp.asarray, args), train=True,
                           mutable=["batch_stats"])
    pmod.train()
    got = _port(pmod, args)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    stats = flax_from_state_dict(pmod, pmod.state_dict())["batch_stats"]
    got_s = dict(_leaves(stats))
    want_s = dict(_leaves(_np(new)["batch_stats"]))
    assert got_s.keys() == want_s.keys()
    for k, w in want_s.items():
        np.testing.assert_allclose(got_s[k], w, rtol=0, atol=ATOL,
                                   err_msg=k)


def test_dcgan_g_phase_call_leaves_the_running_stats():
    """`update_stats=False` in train mode: JAX's train-mode output (batch
    statistics), and the running statistics where they were."""
    jmod, variables, pmod, args = _pair("DCGANDiscriminator", seed=2)
    want = np.asarray(jmod.apply(variables, jnp.asarray(args[0]),
                                 train=True, mutable=["batch_stats"])[0])
    before = {k: v.clone() for k, v in pmod.state_dict().items()}
    pmod.train()
    got = _port(pmod, args, update_stats=False)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert got.shape == (B,)
    for k, v in pmod.state_dict().items():
        assert torch.equal(v, before[k]), k
    pmod(torch.from_numpy(args[0]))  # the D phase's call moves them
    assert not torch.equal(pmod.bn1.running_mean, before["bn1.running_mean"])


@pytest.mark.parametrize("name", CASES)
def test_conversion_round_trip(name):
    _, variables, pmod, _ = _pair(name, seed=3)
    back = flax_from_state_dict(pmod, pmod.state_dict())
    got, want = dict(_leaves(back)), dict(_leaves(variables))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert np.array_equal(got[k], w), k
    for v in state_dict_from_flax(pmod, variables).values():
        assert v.is_contiguous()


# (in_ch, out_ch, k, s, p, H): DCGAN's 1 -> 4 -> 8 (k4), WGAN's 4 -> 7 (k3
# s2 p1) and 7 -> 14 (k4 s2 p1)
TCONV = [(6, 5, 4, 1, 0, 1), (5, 4, 4, 2, 1, 4), (4, 3, 3, 2, 1, 4),
         (3, 2, 4, 2, 1, 7)]


@pytest.mark.parametrize("cin,cout,k,s,p,h", TCONV)
def test_conv_transpose_geometry_and_values(cin, cout, k, s, p, h):
    """Output (H - 1) s - 2p + k, and the values of the JAX layer on the
    same kernel, bias included."""
    rng = np.random.RandomState(k * 10 + s + p + h)
    x = _rand(rng, 3, h, h, cin)
    jmod = jl.ConvTranspose(cout, k, s, p)
    variables = _np(jmod.init(jax.random.key(0), jnp.asarray(x)))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    pmod = pl.ConvTranspose(cin, cout, k, s, p)
    assert pmod.weight.shape == (cin, cout, k, k)
    pmod.load_state_dict(state_dict_from_flax(pmod, variables), strict=True)
    got = _port(pmod, (x,))
    side = (h - 1) * s - 2 * p + k
    assert got.shape == want.shape == (3, side, side, cout)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_conv_transpose_init_fan_in():
    """U(+-1/sqrt(out k k)) for kernel and bias, as the JAX layer's."""
    pmod = pl.ConvTranspose(64, 32, 4, 2, 1,
                            generator=torch.Generator().manual_seed(0))
    bound = 1 / np.sqrt(32 * 16)
    for t in (pmod.weight.detach(), pmod.bias.detach()):
        assert float(t.abs().max()) <= bound
        assert float(t.abs().max()) > 0.95 * bound
    dc = pl.ConvTranspose(64, 32, 4, 2, 1, use_bias=False, normal_std=0.02,
                          generator=torch.Generator().manual_seed(0))
    assert dc.bias is None
    assert abs(float(dc.weight.std()) - 0.02) < 1e-3


def test_instance_norm_matches_jax():
    rng = np.random.RandomState(4)
    x = _rand(rng, 3, 5, 7, 4) * 3 + 1
    jmod = jl.InstanceNorm()
    variables = {"params": {"scale": _rand(rng, 4), "bias": _rand(rng, 4)}}
    want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    pmod = pl.InstanceNorm(4)
    pmod.load_state_dict(state_dict_from_flax(pmod, variables), strict=True)
    np.testing.assert_allclose(_port(pmod, (x,)), want, rtol=0, atol=ATOL)


def test_batchnorm_epsilon_and_dcgan_scale_init():
    """MLPImageGenerator's BatchNorms take eps 0.8; DCGAN's scales start
    at 1 + 0.02 N(0, 1)."""
    g = pg.MLPImageGenerator(LD)
    bns = [m for m in g.modules() if isinstance(m, pl.BatchNorm)]
    assert [m.epsilon for m in bns] == [0.8] * 3
    d = pd.DCGANDiscriminator(64, generator=torch.Generator().manual_seed(0))
    scale = torch.cat([d.bn1.weight, d.bn2.weight, d.bn3.weight]).detach()
    assert abs(float(scale.mean()) - 1.0) < 3e-3
    assert abs(float(scale.std()) - 0.02) < 3e-3
    assert all(m.bias is None for m in d.modules()
               if isinstance(m, pl.Conv))
