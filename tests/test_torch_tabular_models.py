"""The port's tabular modules (cfgan_torch.models.tabular, .generators,
.discriminators, .classifiers, cfgan_torch.nn.gumbel, .layers,
cfgan_torch.masks.feature) against the JAX package's, on the CPU, on the
same numpy inputs and the same weights (carried by cfgan_torch.convert).

- `derive_gumbel_noise` (threefry2x32 in torch integer ops) against
  JAX's for 3 keys x B in {1, 5, 128} x all 7 heads: within 1e-6 (the
  bits are equal; the two logs differ in their last ulp, 4.8e-7 at
  most measured); bf16 noise equal bit for bit; hard samples on the
  noise equal; rows [0, 5) the same at B = 5 and B = 128.
- `gumbel_softmax` soft and hard, and the straight-through gradient.
- `SpectralLinear` with and without `update_stats`: output, the `u` it
  leaves, the kernel's gradient.
- The FiLM block, `TabularResidualGenerator` (f32 train and eval; bf16
  with and without `cat_head_f32` at the repo's bf16 bar 4e-3),
  `SpectralMLPDiscriminator` and `TabularClassifier` (eval, and one
  train-mode forward on JAX's dropout masks): outputs and train-mode
  BatchNorm statistics within 3e-5 (PARITY.md:166) in f32.
- `assemble_residual`, `build_cat_norm_values`, the feature masks, and
  the flax round trip of the three networks.
Width 8, two FiLM blocks, batch 16, the real 17-feature schema.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cfgan.data.kc_house import KC_SCHEMA as JAX_SCHEMA
from cfgan.data.transforms import NormStats as JaxNormStats
from cfgan.masks import feature as jmask
from cfgan.models import tabular as jtab
from cfgan.models.classifiers import TabularClassifier as JaxClassifier
from cfgan.models.discriminators import SpectralMLPDiscriminator as JaxD
from cfgan.models.generators import TabularResidualGenerator as JaxG
from cfgan.nn.gumbel import gumbel_softmax as jax_gumbel_softmax
from cfgan.nn.layers import FiLMResidualBlock as JaxFiLMBlock
from cfgan.nn.layers import SpectralLinear as JaxSpectralLinear
from cfgan_torch.convert import flax_from_state_dict, state_dict_from_flax
from cfgan_torch.data.kc_house import KC_SCHEMA
from cfgan_torch.data.transforms import NormStats
from cfgan_torch.masks import feature as pmask
from cfgan_torch.models import tabular as ptab
from cfgan_torch.models.classifiers import TabularClassifier
from cfgan_torch.models.discriminators import SpectralMLPDiscriminator
from cfgan_torch.models.generators import TabularResidualGenerator
from cfgan_torch.nn.gumbel import gumbel_softmax
from cfgan_torch.nn.layers import FiLMResidualBlock, SpectralLinear

B, H, C, D = 16, 8, 4, 17
ATOL, BF16_ATOL, NOISE_ATOL = 3e-5, 4e-3, 1e-6
INFO = JAX_SCHEMA.categorical_info
KEYS = (0, 7, 2 ** 31 + 5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def assert_trees_close(got, want, atol):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= atol, k


def _inputs(seed=0, b=B):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, (b, D)).astype(np.float32)
    t = rng.randint(0, C, b)
    mask = (rng.uniform(size=(b, D)) > 0.5).astype(np.float32)
    return x, t, np.eye(C, dtype=np.float32)[t], mask


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ the noise
@pytest.mark.parametrize("b", [1, 5, 128])
@pytest.mark.parametrize("seed", KEYS)
def test_derived_noise_matches_jax(seed, b):
    want = jtab.derive_gumbel_noise(jax.random.key(seed), b, INFO)
    got = ptab.derive_gumbel_noise(ptab.jax_key(seed), b, INFO, device="cpu")
    assert sorted(got) == sorted(want) == sorted(INFO)
    for idx, w in want.items():
        assert got[idx].dtype == torch.float32
        assert got[idx].shape == w.shape == (b, len(INFO[idx]))
        assert np.abs(got[idx].numpy() - np.asarray(w)).max() <= NOISE_ATOL


def test_derived_bf16_noise_equals_jax_bit_for_bit():
    want = jtab.derive_gumbel_noise(jax.random.key(3), 64, INFO,
                                    jnp.bfloat16)
    got = ptab.derive_gumbel_noise(ptab.jax_key(3), 64, INFO,
                                   torch.bfloat16, device="cpu")
    for idx, w in want.items():
        np.testing.assert_array_equal(
            got[idx].float().numpy(), np.asarray(w.astype(jnp.float32)))


@pytest.mark.parametrize("seed", KEYS)
def test_keys_and_fold_in_match_jax(seed):
    key = jax.random.key(seed)
    assert ptab.jax_key(seed) == tuple(int(v) for v in
                                       jax.random.key_data(key))
    for data in (0, 9001, 2 ** 32 - 1):
        want = jax.random.key_data(jax.random.fold_in(key, data))
        assert ptab.fold_in(ptab.jax_key(seed), data) == tuple(
            int(v) for v in want)


@pytest.mark.parametrize("seed", KEYS)
def test_hard_samples_on_the_noise_equal_jax(seed):
    rng = np.random.RandomState(seed % 97)
    want = jtab.derive_gumbel_noise(jax.random.key(seed), 128, INFO)
    got = ptab.derive_gumbel_noise(ptab.jax_key(seed), 128, INFO,
                                   device="cpu")
    for idx, n in want.items():
        logits = rng.normal(0, 2, n.shape).astype(np.float32)
        y_j = jax_gumbel_softmax(None, jnp.asarray(logits), 0.5, hard=True,
                                 noise=n)
        y_p = gumbel_softmax(_t(logits), got[idx], 0.5, hard=True)
        np.testing.assert_array_equal(y_p.argmax(1).numpy(),
                                      np.asarray(y_j).argmax(1))
        np.testing.assert_allclose(y_p.numpy(), np.asarray(y_j), atol=1e-6)


def test_a_rows_noise_does_not_depend_on_the_batch():
    small = ptab.derive_gumbel_noise((0, 11), 5, INFO, device="cpu")
    large = ptab.derive_gumbel_noise((0, 11), 128, INFO, device="cpu")
    for idx in INFO:
        assert torch.equal(small[idx], large[idx][:5])


# ------------------------------------------------------------ gumbel
@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
def test_gumbel_softmax_and_its_gradient_match_jax(hard):
    rng = np.random.RandomState(1)
    logits = rng.normal(0, 1, (B, 9)).astype(np.float32)
    noise = rng.gumbel(size=(B, 9)).astype(np.float32)
    w = rng.normal(size=(B, 9)).astype(np.float32)

    def f(lg):
        y = jax_gumbel_softmax(None, lg, 0.5, hard=hard,
                               noise=jnp.asarray(noise))
        return jnp.sum(y * w), y

    (_, y_j), g_j = jax.value_and_grad(f, has_aux=True)(jnp.asarray(logits))
    lg = _t(logits).requires_grad_()
    y_p = gumbel_softmax(lg, _t(noise), 0.5, hard=hard)
    (y_p * _t(w)).sum().backward()
    np.testing.assert_allclose(y_p.detach().numpy(), np.asarray(y_j),
                               atol=1e-6)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(g_j), atol=1e-5)
    if hard:  # the forward value is one-hot (y_hard + y - y rounds within
        # an ulp of it), the gradient the soft sample's
        one_hot = F.one_hot(y_p.argmax(1), 9).float()
        np.testing.assert_allclose(y_p.detach().numpy(), one_hot.numpy(),
                                   atol=1e-7)


# ------------------------------------------------------------ layers
@pytest.mark.parametrize("update", [True, False], ids=["update", "frozen"])
def test_spectral_linear_matches_jax(update):
    x = np.random.RandomState(2).normal(size=(B, 12)).astype(np.float32)
    jl = JaxSpectralLinear(6)
    v = _np(jl.init(jax.random.key(4), jnp.asarray(x)))
    pl = SpectralLinear(12, 6)
    pl.load_state_dict(state_dict_from_flax(pl, v))

    def f(params):
        out, new = jl.apply({"params": params, **{"spectral_stats":
                                                  v["spectral_stats"]}},
                            jnp.asarray(x), update_stats=update,
                            mutable=["spectral_stats"])
        return jnp.sum(out ** 2), (out, new)

    (_, (y_j, new)), g_j = jax.value_and_grad(f, has_aux=True)(v["params"])
    y_p = pl(_t(x), update_stats=update)
    (y_p ** 2).sum().backward()
    np.testing.assert_allclose(y_p.detach().numpy(), np.asarray(y_j),
                               atol=ATOL)
    want_u = (np.asarray(new["spectral_stats"]["u"]) if update
              else v["spectral_stats"]["u"])
    np.testing.assert_allclose(pl.u.numpy(), want_u, atol=1e-6)
    if not update:
        np.testing.assert_array_equal(pl.u.numpy(), v["spectral_stats"]["u"])
    np.testing.assert_allclose(pl.weight.grad.numpy().T,
                               np.asarray(g_j["kernel"]), atol=1e-4,
                               rtol=1e-5)


def test_film_block_matches_jax_in_train_and_eval_mode():
    x, _, t_oh, mask = _inputs()
    h = np.random.RandomState(3).normal(size=(B, H)).astype(np.float32)
    cond = np.concatenate([t_oh, mask], 1)
    jb = JaxFiLMBlock(H)
    v = _np(jb.init(jax.random.key(0), jnp.asarray(h), jnp.asarray(cond),
                    False))
    pb = FiLMResidualBlock(H, C + D)
    pb.load_state_dict(state_dict_from_flax(pb, v))
    out, new = jb.apply(v, jnp.asarray(h), jnp.asarray(cond), True,
                        mutable=["batch_stats"])
    got = pb.train()(_t(h), _t(cond))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=ATOL)
    assert_trees_close(flax_from_state_dict(pb, pb.state_dict())
                       ["batch_stats"], _np(new["batch_stats"]), ATOL)
    pb.load_state_dict(state_dict_from_flax(pb, v))
    np.testing.assert_allclose(
        pb.eval()(_t(h), _t(cond)).detach().numpy(),
        np.asarray(jb.apply(v, jnp.asarray(h), jnp.asarray(cond), False)),
        atol=ATOL)


# ------------------------------------------------------------ networks
def _generator_pair(cat_head_f32=True):
    jg = JaxG(input_dim=D, hidden_dim=H, num_classes=C,
              continuous_idx=JAX_SCHEMA.continuous_idx,
              categorical_info=INFO, n_blocks=2, cat_head_f32=cat_head_f32)
    x, _, t_oh, mask = _inputs()
    v = _np(dict(jg.init({"params": jax.random.key(0),
                          "gumbel": jax.random.key(0)}, jnp.asarray(x),
                         jnp.asarray(t_oh), jnp.asarray(mask), train=False)))
    pg = TabularResidualGenerator(D, H, C, KC_SCHEMA.continuous_idx,
                                  KC_SCHEMA.categorical_info, n_blocks=2,
                                  cat_head_f32=cat_head_f32)
    pg.load_state_dict(state_dict_from_flax(pg, v))
    return jg, v, pg


def _noise(b=B, seed=5):
    return {i: np.asarray(n) for i, n in jtab.derive_gumbel_noise(
        jax.random.key(seed), b, INFO).items()}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_generator_matches_jax_f32(train):
    jg, v, pg = _generator_pair()
    x, _, t_oh, mask = _inputs(1)
    noise = _noise()
    kw = dict(temperature=0.5, hard=not train, train=train,
              gumbel_noise={i: jnp.asarray(n) for i, n in noise.items()})
    if train:
        (cont, logits, samples), new = jg.apply(
            v, jnp.asarray(x), jnp.asarray(t_oh), jnp.asarray(mask),
            mutable=["batch_stats"], **kw)
    else:
        cont, logits, samples = jg.apply(v, jnp.asarray(x),
                                         jnp.asarray(t_oh),
                                         jnp.asarray(mask), **kw)
    pg.train(train)
    c, lg, s = pg(_t(x), _t(t_oh), _t(mask),
                  {i: _t(n) for i, n in noise.items()}, hard=not train)
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(cont),
                               atol=ATOL)
    for idx in INFO:
        np.testing.assert_allclose(lg[idx].detach().numpy(),
                                   np.asarray(logits[idx]), atol=ATOL)
        np.testing.assert_allclose(s[idx].detach().numpy(),
                                   np.asarray(samples[idx]), atol=ATOL)
    if train:
        assert_trees_close(flax_from_state_dict(pg, pg.state_dict())
                           ["batch_stats"], _np(new["batch_stats"]), ATOL)


def test_generator_takes_its_noise_side_by_side():
    """One (B, 70) tensor of the heads' noise in sorted order gives what
    the dict of heads gives."""
    _, _, pg = _generator_pair()
    x, _, t_oh, mask = _inputs(1)
    noise = {i: _t(n) for i, n in _noise().items()}
    joined = torch.cat([noise[i] for i in sorted(noise)], 1)
    pg.eval()
    a = pg(_t(x), _t(t_oh), _t(mask), noise, hard=True)
    b = pg(_t(x), _t(t_oh), _t(mask), joined, hard=True)
    assert torch.equal(a[0], b[0])
    for idx in INFO:
        assert torch.equal(a[2][idx], b[2][idx])


@pytest.mark.parametrize("cat_head_f32", [True, False],
                         ids=["f32_heads", "bf16_heads"])
def test_generator_matches_jax_bf16(cat_head_f32):
    """Everything cast to bf16 as the serving `cf_fn` casts it; with
    `cat_head_f32` the heads, noise and softmax run in float32, and the
    samples agree within the bf16 bar.  Without it the sample's input
    (logits + g) / tau is rounded to bf16 (one ulp is 1/16 at |z| in
    [8, 16)) where XLA keeps it in float32 inside its fused softmax: a
    sample moves by up to e^(1/16) - 1 = 6.5% of itself, so there the bar
    is 7% of the sample plus the bf16 bar (the reason `cat_head_f32`
    exists)."""
    jg, v, pg = _generator_pair(cat_head_f32)
    x, _, t_oh, mask = _inputs(2)
    nd = jnp.float32 if cat_head_f32 else jnp.bfloat16
    jn = jtab.derive_gumbel_noise(jax.random.key(6), B, INFO, nd)
    vb = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), v)
    cont, _, samples = jg.apply(
        vb, jnp.asarray(x, jnp.bfloat16), jnp.asarray(t_oh, jnp.bfloat16),
        jnp.asarray(mask, jnp.bfloat16), temperature=0.5, hard=False,
        train=False, gumbel_noise=jn)
    pn = ptab.derive_gumbel_noise(ptab.jax_key(6), B, INFO,
                                  torch.float32 if cat_head_f32
                                  else torch.bfloat16, device="cpu")
    pg.to(torch.bfloat16).eval()
    c, _, s = pg(_t(x).bfloat16(), _t(t_oh).bfloat16(),
                 _t(mask).bfloat16(), pn, hard=False)
    want_dtype = torch.float32 if cat_head_f32 else torch.bfloat16
    np.testing.assert_allclose(c.float().detach().numpy(),
                               np.asarray(cont, np.float32), atol=BF16_ATOL)
    for idx in INFO:
        assert s[idx].dtype == want_dtype
        np.testing.assert_allclose(s[idx].float().detach().numpy(),
                                   np.asarray(samples[idx], np.float32),
                                   atol=BF16_ATOL,
                                   rtol=0 if cat_head_f32 else 0.07)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_discriminator_matches_jax(train):
    x, _, t_oh, _ = _inputs(3)
    jd = JaxD(hidden_dims=(H, 2 * H, 4 * H))
    v = _np(dict(jd.init({"params": jax.random.key(2)}, jnp.asarray(x),
                         jnp.asarray(t_oh))))
    pd_ = SpectralMLPDiscriminator(D + C, (H, 2 * H, 4 * H))
    pd_.load_state_dict(state_dict_from_flax(pd_, v))
    if train:
        out, new = jd.apply(v, jnp.asarray(x), jnp.asarray(t_oh),
                            update_stats=True, mutable=["spectral_stats"])
    else:
        out, new = jd.apply(v, jnp.asarray(x), jnp.asarray(t_oh),
                            update_stats=False), v
    got = pd_(_t(x), _t(t_oh), train=train)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=ATOL)
    assert_trees_close(flax_from_state_dict(pd_, pd_.state_dict())
                       ["spectral_stats"], _np(new["spectral_stats"]), 1e-6)


def test_classifier_matches_jax_in_eval_and_on_its_dropout_masks():
    x, _, _, _ = _inputs(4, b=32)
    jc = JaxClassifier(num_classes=C)
    v = _np(dict(jc.init(jax.random.key(1), jnp.asarray(x))))
    pc = TabularClassifier(C, D)
    pc.load_state_dict(state_dict_from_flax(pc, v))
    np.testing.assert_allclose(
        pc.eval()(_t(x)).detach().numpy(),
        np.asarray(jc.apply(v, jnp.asarray(x), train=False)), atol=ATOL)
    (out, new) = jc.apply(v, jnp.asarray(x), train=True,
                          rngs={"dropout": jax.random.key(9)},
                          mutable=["batch_stats", "intermediates"],
                          capture_intermediates=True)
    inter = new["intermediates"]
    # a dropout output is 0 exactly where the unit was dropped (its
    # BatchNorm input is 0 with probability 0)
    keep = tuple(_t(np.asarray(inter[f"Dropout_{i}"]["__call__"][0]) != 0)
                 for i in range(3))
    got = pc.train()(_t(x), keep=keep)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=ATOL)
    assert_trees_close(flax_from_state_dict(pc, pc.state_dict())
                       ["batch_stats"], _np(new["batch_stats"]), ATOL)


@pytest.mark.parametrize("net", ["generator", "critic", "classifier"])
def test_flax_round_trip(net):
    x, _, t_oh, mask = _inputs()
    if net == "generator":
        _, v, mod = _generator_pair()
    elif net == "critic":
        v = _np(dict(JaxD(hidden_dims=(H, 2 * H, 4 * H)).init(
            jax.random.key(0), jnp.asarray(x), jnp.asarray(t_oh))))
        mod = SpectralMLPDiscriminator(D + C, (H, 2 * H, 4 * H))
    else:
        v = _np(dict(JaxClassifier(num_classes=C).init(jax.random.key(0),
                                                       jnp.asarray(x))))
        mod = TabularClassifier(C, D)
    mod.load_state_dict(state_dict_from_flax(mod, v))
    back = flax_from_state_dict(mod, mod.state_dict())
    got, want = dict(_leaves(back)), dict(_leaves(v))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------------- assembly, masks
def test_cat_norm_values_match_jax():
    rng = np.random.RandomState(0)
    lo = rng.uniform(0, 2, D).astype(np.float32)
    stats = (lo, (lo + rng.uniform(1, 9, D)).astype(np.float32))
    want = jtab.build_cat_norm_values(INFO, JaxNormStats(*stats))
    got = ptab.build_cat_norm_values(KC_SCHEMA.categorical_info,
                                     NormStats(*stats))
    for idx in INFO:
        np.testing.assert_array_equal(got[idx], want[idx])
        assert got[idx].dtype == np.float32
    for idx, vals in ptab.build_cat_norm_values(
            KC_SCHEMA.categorical_info, None).items():
        np.testing.assert_array_equal(
            vals, jtab.build_cat_norm_values(INFO, None)[idx])


def test_assemble_residual_matches_jax():
    rng = np.random.RandomState(1)
    x, _, _, _ = _inputs(5)
    cont = rng.normal(0, 0.1, (B, len(JAX_SCHEMA.continuous_idx))).astype(
        np.float32)
    samples = {i: rng.dirichlet(np.ones(len(v)), B).astype(np.float32)
               for i, v in INFO.items()}
    nv = jtab.build_cat_norm_values(INFO, None)
    want = jtab.assemble_residual(jnp.asarray(x), jnp.asarray(cont),
                                  {i: jnp.asarray(s)
                                   for i, s in samples.items()},
                                  JAX_SCHEMA.continuous_idx, nv)
    got = ptab.assemble_residual(_t(x), _t(cont),
                                 {i: _t(s) for i, s in samples.items()},
                                 KC_SCHEMA.continuous_idx, nv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_feature_masks_match_jax():
    imm = JAX_SCHEMA.immutable_idx
    draws = jax.random.randint(jax.random.key(4), (B, D), 0, 2)
    np.testing.assert_array_equal(
        pmask.random_feature_mask(_t(draws), imm).numpy(),
        np.asarray(jmask.random_feature_mask(jax.random.key(4), B, D, imm)))
    np.testing.assert_array_equal(
        pmask.immutable_complement_mask(3, D, imm).numpy(),
        np.asarray(jmask.immutable_complement_mask(3, D, imm)))
    for allowed in ((), ("grade", "lat", "bathrooms", "nonsense"),
                    JAX_SCHEMA.feature_names):
        np.testing.assert_array_equal(
            pmask.feature_names_to_mask(allowed, 2, KC_SCHEMA).numpy(),
            np.asarray(jmask.feature_names_to_mask(allowed, 2, JAX_SCHEMA)))
    gen = torch.Generator().manual_seed(0)
    d = pmask.feature_mask_draws((3, B), D, gen)
    assert d.shape == (3, B, D) and set(d.unique().tolist()) <= {0, 1}


def test_ones_fraction_replaces_a_mask_by_the_immutable_complement():
    """`MaskConfig.ones_fraction` for the tabular family: a sample whose
    draw is under the fraction takes the serving mask (immutable features
    still 0), as the JAX sampler's `full_mask_fn` gives; the others keep
    their random mask."""
    from cfgan_torch.masks.patch import with_ones_fraction

    imm = KC_SCHEMA.immutable_idx
    draws = _t(jax.random.randint(jax.random.key(2), (B, D), 0, 2))
    mask = pmask.random_feature_mask(draws, imm)
    full = pmask.immutable_complement_mask(B, D, imm)
    pick = torch.linspace(0, 1, B)
    got = with_ones_fraction(mask, 0.5, draws=pick, full=full)
    chosen = pick < 0.5
    assert torch.equal(got[chosen], full[chosen])
    assert torch.equal(got[~chosen], mask[~chosen])
    assert not got[:, list(imm)].any()
