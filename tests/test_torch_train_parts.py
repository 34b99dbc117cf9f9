"""The parts of the port's train step against the JAX package's, on the
CPU: BatchNorm's train path, `CondConvDiscriminator`, the GAN and
CounteRGAN losses (values and gradients, the floored log at a saturated
probability included), patch masks and targets fed JAX's own draws, the
mixed-precision wrapper, and the state conversion both ways.

Tolerances: float32 abs <= 1e-5 on activations and losses (same
arithmetic, other summation orders), 1e-6 on BatchNorm's running
statistics (one momentum step of the batch statistics); masks and
targets exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgan.losses import countergan as jcg
from cfgan.losses import gan as jgan
from cfgan.masks.patch import random_patch_mask as jax_patch_mask
from cfgan.models.discriminators import CondConvDiscriminator as JaxD
from cfgan.models.generators import ImageResidualGenerator as JaxG
from cfgan.nn import layers as jl
from cfgan.train.builders import _with_ones_fraction
from cfgan.train.countergan import sample_targets as jax_sample_targets
from cfgan_torch.convert import (
    flax_from_state_dict,
    gan_state_to_flax,
    load_gan_state,
    state_dict_from_flax,
)
from cfgan_torch.core.config import MNIST_COUNTERGAN, CounterGANConfig
from cfgan_torch.losses import countergan as tcg
from cfgan_torch.losses import gan as tgan
from cfgan_torch.masks.patch import random_patch_mask, with_ones_fraction
from cfgan_torch.models.classifiers import CNNClassifier
from cfgan_torch.models.discriminators import CondConvDiscriminator
from cfgan_torch.models.generators import ImageResidualGenerator
from cfgan_torch.nn import layers as tl
from cfgan_torch.train.builders import (
    build_mnist_countergan,
    make_mixed_precision,
)
from cfgan_torch.train.countergan import sample_targets


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _x(shape, seed=0, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (shift + scale * rng.standard_normal(shape)).astype(np.float32)


# ------------------------------------------------------------ BatchNorm
@pytest.mark.parametrize("shape", [(4, 5, 3, 6), (7, 6)], ids=str)
def test_batchnorm_train_path_matches_jax(shape):
    """Normalizes by the biased batch variance, updates the running
    variance with the unbiased one, momentum 0.9 (JAX convention)."""
    x = _x(shape, shift=0.7, scale=1.3)
    jbn = jl.BatchNorm()
    v = _np(jbn.init(jax.random.key(0), x, use_running_average=True))
    rng = np.random.default_rng(1)
    v = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), v)
    want, new = jbn.apply(v, x, use_running_average=False,
                          mutable=["batch_stats"])
    tbn = tl.BatchNorm(shape[-1])
    tbn.load_state_dict(state_dict_from_flax(tbn, v))
    got = tbn.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(
            getattr(tbn, ours).numpy(),
            np.asarray(new["batch_stats"][theirs]), atol=1e-6, rtol=0)


def test_batchnorm_train_gradients_match_jax():
    x = _x((6, 4, 4, 5), seed=2, shift=0.3)
    g = _x((6, 4, 4, 5), seed=3)
    jbn = jl.BatchNorm()
    v = _np(jbn.init(jax.random.key(0), x, use_running_average=True))

    def f(xx, params):
        y, _ = jbn.apply({**v, "params": params}, xx,
                         use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y * g)

    want_dx, want_dp = jax.grad(f, argnums=(0, 1))(jnp.asarray(x),
                                                   v["params"])
    tbn = tl.BatchNorm(5)
    tbn.load_state_dict(state_dict_from_flax(tbn, v))
    xt = torch.tensor(x, requires_grad=True)
    (tbn.train()(xt) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tbn.weight.grad.numpy(),
                               np.asarray(want_dp["scale"]), atol=1e-5)
    np.testing.assert_allclose(tbn.bias.grad.numpy(),
                               np.asarray(want_dp["bias"]), atol=1e-5)


def test_batchnorm_running_stats_stay_float32_under_bf16():
    tbn = tl.BatchNorm(4).train()
    tbn.weight.data = tbn.weight.data.bfloat16()
    tbn.bias.data = tbn.bias.data.bfloat16()
    y = tbn(torch.from_numpy(_x((3, 5, 4), shift=2.0)).bfloat16())
    assert y.dtype == torch.bfloat16
    assert tbn.running_mean.dtype == tbn.running_var.dtype == torch.float32
    assert float(tbn.running_mean.mean()) > 0.1


# -------------------------------------------------------- discriminator
@pytest.mark.parametrize("d_hidden", [8, 64])
def test_discriminator_matches_jax(d_hidden):
    x = _x((3, 28, 28, 1), seed=4)
    t = np.array([1, 7, 3], np.int32)
    jd = JaxD(num_classes=10, d_hidden=d_hidden)
    v = _np(jd.init(jax.random.key(2), x, t))
    td = CondConvDiscriminator(10, d_hidden)
    td.load_state_dict(state_dict_from_flax(td, v), strict=True)
    want = jd.apply(v, x, t)
    got = td(torch.from_numpy(x), torch.from_numpy(t).long())
    assert got.shape == (3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    assert all(c.bias is None for c in (td.conv0, td.conv1, td.conv2,
                                        td.conv3))
    assert [td.conv3.weight.shape[0], td.adv_head.weight.shape[1]] == [
        4 * d_hidden, 4 * d_hidden]


# --------------------------------------------------------------- losses
LOGITS = np.array([[-3.0], [-0.5], [1e-3], [0.25], [2.0], [40.0]],
                  np.float32)


def test_bce_gradient_at_a_zero_logit_is_sigmoid_minus_target():
    """At a logit of exactly 0 the port's BCE gradient is the derivative
    sigmoid(0) - target.  The JAX package's autodiff of the same formula
    takes |l|'(0) = 1 and gives -1 and 0 there, for targets 1 and 0
    (ROADMAP, Queue C); everywhere else the two agree
    (test_d_losses_match_jax)."""
    for target, jax_grad in ((1.0, -1.0), (0.0, 0.0)):
        lt = torch.zeros(1, requires_grad=True)
        tgan.bce_logits(lt, torch.full((1,), target)).backward()
        assert lt.grad.item() == 0.5 - target
        got = jax.grad(lambda v: jgan.bce_logits(v, target))(jnp.zeros(1))
        assert float(got[0]) == jax_grad


@pytest.mark.parametrize("name", ["d_loss_bce", "d_loss_wasserstein"])
def test_d_losses_match_jax(name):
    real, fake = LOGITS, LOGITS[::-1] * 0.5
    want_v, want_g = jax.value_and_grad(getattr(jgan, name), (0, 1))(
        jnp.asarray(real), jnp.asarray(fake))
    rt, ft = (torch.tensor(a, requires_grad=True) for a in (real, fake))
    got = getattr(tgan, name)(rt, ft)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want_v), atol=1e-6)
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(want_g[0]),
                               atol=1e-6)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want_g[1]),
                               atol=1e-6)


@pytest.mark.parametrize("name", ["g_loss_bce", "g_loss_wasserstein",
                                  "g_loss_nonsaturating"])
def test_g_losses_match_jax(name):
    a = LOGITS
    if name == "g_loss_nonsaturating":
        a = 1.0 / (1.0 + np.exp(-a))
    want_v, want_g = jax.value_and_grad(getattr(jgan, name))(jnp.asarray(a))
    at = torch.tensor(a, requires_grad=True)
    got = getattr(tgan, name)(at)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want_v), rtol=1e-6)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(want_g),
                               rtol=1e-6)


@pytest.mark.parametrize("eps", [0.0, 1e-6])
def test_floored_log_gradient_at_a_saturated_probability(eps):
    """A discriminator saturated to exactly 0 and 1: finite losses and
    large but finite, non-zero gradients, 1/max(p, 1e-12), as in JAX."""
    real = np.array([1.0, 0.0, 0.5], np.float32)
    fake = np.array([1.0, 0.0, 1e-30], np.float32)
    want_v, want_g = jax.value_and_grad(
        lambda r, f: jgan.d_loss_nonsaturating(r, f, eps), (0, 1))(
            jnp.asarray(real), jnp.asarray(fake))
    rt, ft = (torch.tensor(a, requires_grad=True) for a in (real, fake))
    got = tgan.d_loss_nonsaturating(rt, ft, eps)
    got.backward()
    assert np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), float(want_v), rtol=1e-6)
    for ours, theirs in ((rt.grad, want_g[0]), (ft.grad, want_g[1])):
        assert torch.isfinite(ours).all() and (ours != 0).all()
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-6)


@pytest.mark.parametrize("reduction", ["mean_abs", "per_sample_norm"])
def test_countergan_terms_match_jax(reduction):
    raw = _x((4, 6, 6, 1), seed=5, scale=0.3)
    mask = (_x((4, 6, 6, 1), seed=6) > 0).astype(np.float32)
    masked = raw * mask
    logits = _x((4, 10), seed=7, scale=2.0)
    target = np.array([3, 0, 9, 3])
    pairs = [
        (tcg.proximity_l1(torch.from_numpy(masked), reduction),
         jcg.proximity_l1(masked, reduction)),
        (tcg.proximity_l2(torch.from_numpy(masked)),
         jcg.proximity_l2(masked)),
        (tcg.mask_penalty(torch.from_numpy(raw), torch.from_numpy(mask)),
         jcg.mask_penalty(raw, mask)),
        (tcg.classifier_ce(torch.from_numpy(logits),
                           torch.from_numpy(target)),
         jcg.classifier_ce(logits, target)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert tcg.CounterGANTerms._fields == jcg.CounterGANTerms._fields


# ------------------------------------------------------- masks, targets
@pytest.mark.parametrize("num_modifiable", [None, 1, 10, 16, 40])
@pytest.mark.parametrize("shared", [False, True])
def test_random_patch_mask_matches_jax_on_its_draws(num_modifiable, shared):
    """Fed the uniform scores (or 0/1 integers) that JAX draws from the
    same key, the mask is the same, exactly."""
    key, b = jax.random.key(11), 6
    rows = 1 if shared else b
    if num_modifiable is None:
        draws = jax.random.randint(key, (rows, 16), 0, 2)
    else:
        draws = jax.random.uniform(key, (rows, 16))
    want = jax_patch_mask(key, b, (28, 28), 7, num_modifiable, channels=1,
                          shared=shared)
    got = random_patch_mask(b, (28, 28), 7, num_modifiable, channels=1,
                            shared=shared,
                            draws=torch.tensor(np.asarray(draws)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if num_modifiable == 10:
        assert (got.reshape(b, -1).sum(1) == 10 * 49).all()


def test_with_ones_fraction_matches_jax_on_its_draws():
    key, b = jax.random.key(12), 32
    x = jnp.zeros((b, 28, 28, 1))
    sampler = _with_ones_fraction(
        lambda k, xx: jax_patch_mask(k, b, (28, 28), 7, 10), 0.25)
    want = sampler(key, x)
    k1, k2 = jax.random.split(key)
    mask = random_patch_mask(b, (28, 28), 7, 10, draws=torch.tensor(
        np.asarray(jax.random.uniform(k1, (b, 16)))))
    got = with_ones_fraction(mask, 0.25, draws=torch.tensor(
        np.asarray(jax.random.uniform(k2, (b,)))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int((got.reshape(b, -1).min(1).values == 1).sum()) < b
    assert with_ones_fraction(mask, 0.0) is mask


@pytest.mark.parametrize("resample", [False, True])
def test_sample_targets_matches_jax_on_its_draws(resample):
    key = jax.random.key(13)
    y = jnp.asarray(np.arange(64) % 10, jnp.int32)
    want = jax_sample_targets(key, y, 10, resample)
    draws = jax.random.randint(key, y.shape, 0, 10)
    got = sample_targets(torch.tensor(np.asarray(y)).long(), 10, resample,
                         draws=torch.tensor(np.asarray(draws)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if resample:
        assert (got != torch.tensor(np.asarray(y))).all()


def test_draws_come_from_the_generator():
    """Without draws, masks and targets come from the torch.Generator: the
    same seed gives the same draws."""
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return (random_patch_mask(4, (28, 28), 7, 10, generator=g),
                sample_targets(torch.zeros(4, dtype=torch.long), 10, True,
                               generator=g))

    (m1, t1), (m2, t2), (m3, _) = draw(0), draw(0), draw(1)
    assert torch.equal(m1, m2) and torch.equal(t1, t2)
    assert not torch.equal(m1, m3)


# ------------------------------------------------------ mixed precision
def test_mixed_precision_casts_inside_the_graph():
    """bf16 forward, float32 outputs, float32 gradients on the master
    parameters, float32 BatchNorm statistics."""
    g = ImageResidualGenerator(base_ch=16, n_resblocks=1,
                               generator=torch.Generator().manual_seed(0))
    fwd = make_mixed_precision(g.train(), "bfloat16")
    x = torch.rand(2, 28, 28, 1) * 2 - 1
    raw, masked = fwd(x, torch.tensor([1, 2]), torch.ones_like(x))
    assert raw.dtype == masked.dtype == torch.float32
    raw.sum().backward()
    assert all(p.grad.dtype == torch.float32 and p.dtype == torch.float32
               for p in g.parameters())
    assert g.res0.bn1.running_mean.dtype == torch.float32
    assert float(g.res0.bn1.running_var.sub(1).abs().max()) > 0
    d = CondConvDiscriminator(10, 8)
    scores = make_mixed_precision(d, "bfloat16")(x, torch.tensor([1, 2]),
                                                 detach=True)
    assert scores.dtype == torch.float32 and scores.grad_fn is None


# ------------------------------------------------------------ convert
def test_flax_round_trip_of_the_discriminator_and_generator():
    x, t = np.zeros((2, 28, 28, 1), np.float32), np.zeros(2, np.int32)
    for jmod, tmod, args in (
            (JaxD(d_hidden=8), CondConvDiscriminator(10, 8), (x, t)),
            (JaxG(base_ch=16, n_resblocks=1, conv_impl="pallas"),
             ImageResidualGenerator(base_ch=16, n_resblocks=1,
                                    conv_impl="pallas"), (x, t, x))):
        kw = {} if isinstance(jmod, JaxD) else {"train": False}
        v = _np(jmod.init(jax.random.key(0), *args, **kw))
        tmod.load_state_dict(state_dict_from_flax(tmod, v))
        back = flax_from_state_dict(tmod, tmod.state_dict())
        want = jax.tree_util.tree_leaves_with_path(v)
        got = jax.tree_util.tree_leaves_with_path(back)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_gan_state_round_trip():
    cfg = CounterGANConfig(hidden_dim=8, num_res_blocks=1, ema_decay=0.5)
    port = build_mnist_countergan(cfg, CNNClassifier().state_dict(),
                                  seed=1, device="cpu")
    other = build_mnist_countergan(cfg, CNNClassifier().state_dict(),
                                   seed=2, device="cpu")
    trees = gan_state_to_flax(port.state)
    load_gan_state(other.state, trees)
    again = gan_state_to_flax(other.state)
    for a, b in zip(jax.tree_util.tree_leaves(trees),
                    jax.tree_util.tree_leaves(again)):
        np.testing.assert_array_equal(a, b)
    without = build_mnist_countergan(
        CounterGANConfig(hidden_dim=8, num_res_blocks=1),
        CNNClassifier().state_dict(), device="cpu")
    with pytest.raises(ValueError, match="EMA"):
        load_gan_state(without.state, trees)


def test_train_preset_matches_the_jax_preset():
    from cfgan.experiments.presets import MNIST_COUNTERGAN as JAX_PRESET

    want = JAX_PRESET.countergan
    for field in CounterGANConfig.__dataclass_fields__:
        if field != "mask":
            assert getattr(MNIST_COUNTERGAN, field) == getattr(
                want, field), field
    for field in MNIST_COUNTERGAN.mask.__dataclass_fields__:
        assert getattr(MNIST_COUNTERGAN.mask, field) == getattr(
            want.mask, field), field
    # the memory options exist, at the JAX preset's values (its defaults)
    assert MNIST_COUNTERGAN.remat is want.remat is False
    assert MNIST_COUNTERGAN.g_microbatch == want.g_microbatch == 0


def test_build_mnist_countergan_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_mnist_countergan(
            CounterGANConfig(hidden_dim=8, num_res_blocks=1),
            CNNClassifier().state_dict())


def test_step_without_diagnostics_returns_the_losses_only():
    cfg = CounterGANConfig(hidden_dim=8, num_res_blocks=1,
                           mask=MNIST_COUNTERGAN.mask)
    port = build_mnist_countergan(cfg, CNNClassifier().state_dict(),
                                  device="cpu", diagnostics=False)
    g = torch.Generator().manual_seed(0)
    x = torch.rand((4, 28, 28, 1), generator=g) * 2 - 1
    metrics = port.step_fn(port.state, x, torch.arange(4), g)
    assert metrics.keys() == {"d_loss", "g_loss"}
    assert port.state.step == 1


def test_step_rejects_an_unknown_adversarial_loss():
    with pytest.raises(ValueError, match="adv_loss"):
        build_mnist_countergan(
            CounterGANConfig(hidden_dim=8, num_res_blocks=1,
                             adv_loss="hinge"),
            CNNClassifier().state_dict(), device="cpu")
