"""The port's builders at a shape, class count and input width other than
the shipped datasets', against the JAX package's builders, on the CPU:
`build_mnist_countergan(..., num_classes=3, image_hw=(20, 20))` with 5-px
patches (a 4x4 grid, 8 modifiable), the residual family and the legacy
delta family; `build_mnist_serving` and the recalibrator at 20x20; and
`build_moons_countergan(..., num_classes=4, input_dim=3)`.  Then the
builders called without the new arguments against the same builders
called with the shipped values, bit for bit.

Width 8, one residual block, batch 16, float32, inputs from numpy seeds;
both packages start from JAX's initial state (carried by
`cfgan_torch.convert`, which refuses a parameter of another shape) and
take the JAX step's targets and masks, re-derived from its key
(`k_t, k_m, _ = split(fold_in(key, step), 3)`).  Bars as in
tests/test_torch_step.py (d_loss and the diagnostics 3e-5, g_loss 3e-4,
parameters 3e-5, the gradients through Adam's first moments within 5e-5
of each leaf's 2-norm plus 1e-8, BatchNorm statistics 1e-5); the moons
step as tests/test_torch_moons_train.py holds it (with its noise
leaves).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgan.core.config import CounterGANConfig as JaxConfig
from cfgan.core.config import MaskConfig as JaxMaskConfig
from cfgan.experiments import presets as jax_presets
from cfgan.masks.feature import random_feature_mask as jax_feature_mask
from cfgan.masks.patch import random_patch_mask as jax_patch_mask
from cfgan.models.classifiers import CNNClassifier as JaxCNN
from cfgan.models.classifiers import LegacyCNNClassifier as JaxLegacyCNN
from cfgan.models.classifiers import MLPClassifier as JaxMLP
from cfgan.train.builders import build_mnist_countergan as jax_build_mnist
from cfgan.train.builders import build_moons_countergan as jax_build_moons
from cfgan.train.countergan import sample_targets as jax_sample_targets
from cfgan.train.state import NetState as JaxNetState
from cfgan.train.state import adam_like_torch as jax_adam
from cfgan_torch.convert import (
    adam_moments_to_flax,
    flax_from_state_dict,
    gan_state_to_flax,
    load_gan_state,
    state_dict_from_flax,
)
from cfgan_torch.core import config as C
from cfgan_torch.core.config import CounterGANConfig, MaskConfig
from cfgan_torch.eval import metrics
from cfgan_torch.experiments.presets import MNIST_COUNTERGAN_LEGACY
from cfgan_torch.masks.patch import random_patch_mask
from cfgan_torch.models.classifiers import (
    CNNClassifier,
    LegacyCNNClassifier,
    MLPClassifier,
)
from cfgan_torch.train import builders

from test_torch_moons_train import (
    CRITIC_READ,
    NOISE_LEAVES,
    NOISE_MU,
    assert_state_close,
)
from test_torch_step import (
    RECIPE,
    assert_moments_close,
    assert_trees_close,
)

B, NC, HW, PATCH, K = 16, 3, (20, 20), 5, 8
MOONS_NC, MOONS_DIM, MOONS_B = 4, 3, 32
ATOL = 3e-5
DIAGNOSTICS = ("g_adv", "g_cls", "reg_l1", "reg_l2", "mask_penalty",
               "d_real_p", "d_fake_p", "residual_mean", "flip_rate",
               "pred_gain")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU run shares its cores with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_trees(state):
    return _np({"g": state.g.variables(), "d": state.d.variables(),
                "g_ema": state.g_ema})


def _images(seed, b=B, hw=HW):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (b, *hw, 1)).astype(np.float32),
            rng.randint(0, NC, b).astype(np.int32))


def _image_configs(legacy: bool, patch: int = PATCH, k: int = K):
    if legacy:  # the legacy preset at width 8, its fixed target a class
        return (replace(jax_presets.MNIST_COUNTERGAN_LEGACY.countergan,
                        hidden_dim=8, fixed_target=2),
                replace(MNIST_COUNTERGAN_LEGACY.countergan, hidden_dim=8,
                        fixed_target=2))
    mask = dict(kind="patch", patch_size=patch, num_modifiable_patches=k)
    return (JaxConfig(**RECIPE, mask=JaxMaskConfig(**mask)),
            CounterGANConfig(**RECIPE, mask=MaskConfig(**mask)))


def _image_pair(legacy: bool, **overrides):
    """(JAX config, JAX bundle, port bundle, JAX classifier variables) at
    20x20 / 3 classes, the port loaded with JAX's initial state."""
    jcfg, pcfg = (replace(c, **overrides) for c in _image_configs(legacy))
    jclf, pclf = ((JaxLegacyCNN(num_classes=NC),
                   LegacyCNNClassifier(NC, image_hw=HW)) if legacy else
                  (JaxCNN(num_classes=NC), CNNClassifier(NC, image_hw=HW)))
    clf_vars = _np(dict(jclf.init(jax.random.key(1),
                                  jnp.zeros((2, *HW, 1)))))
    bundle = jax_build_mnist(jcfg, jclf,
                             JaxNetState.create(clf_vars, jax_adam(1e-3)),
                             num_classes=NC, image_hw=HW, seed=7,
                             legacy_delta=legacy)
    port = builders.build_mnist_countergan(
        pcfg, state_dict_from_flax(pclf, clf_vars), device="cpu",
        legacy_delta=legacy, num_classes=NC, image_hw=HW)
    load_gan_state(port.state, _jax_trees(bundle.state))
    return jcfg, bundle, port, clf_vars


@pytest.fixture(scope="module", params=["residual", "legacy"])
def image_step(request):
    """One step of each package from one JAX state on one batch: the
    residual family on the JAX step's targets and 4x4-grid masks, the
    legacy family on its fixed target and all-ones mask (`draw_fn`)."""
    legacy = request.param == "legacy"
    jcfg, bundle, port, _ = _image_pair(legacy)
    x, y = _images(11)
    key = jax.random.key(3)
    state, jm = jax.jit(bundle.step_fn)(bundle.state, jnp.asarray(x),
                                        jnp.asarray(y), key)
    if legacy:
        draws = port.draw_fn(torch.Generator().manual_seed(0), (B,))
        pm = port.step_from_draws(port.state, torch.from_numpy(x),
                                  torch.from_numpy(y).long(), draws)
    else:
        k_t, k_m, _ = jax.random.split(jax.random.fold_in(key, 0), 3)
        t = jax_sample_targets(k_t, jnp.asarray(y), NC, jcfg.resample_target)
        mask = jax_patch_mask(k_m, B, HW, PATCH, K, channels=1)
        pm = port.step_with_draws(
            port.state, torch.from_numpy(x), torch.from_numpy(y).long(),
            torch.tensor(np.asarray(t)).long(),
            torch.tensor(np.asarray(mask)))
    jt = {**_jax_trees(state),
          "adam_mu": _np({n: getattr(state, n).opt_state[0].mu
                          for n in ("g", "d")})}
    pt = {**gan_state_to_flax(port.state),
          "adam_mu": adam_moments_to_flax(port.state)}
    return ({k: float(v) for k, v in jm.items()},
            {k: float(v) for k, v in pm.items()}, jt, pt)


def test_image_step_losses_and_diagnostics_match_jax(image_step):
    jm, pm, _, _ = image_step
    assert pm.keys() == jm.keys() == {"d_loss", "g_loss", *DIAGNOSTICS}
    assert abs(pm["g_loss"] - jm["g_loss"]) <= 3e-4
    for name in ("d_loss", *DIAGNOSTICS):
        assert abs(pm[name] - jm[name]) <= ATOL, (name, pm[name], jm[name])


@pytest.mark.parametrize("net", ["g", "d"])
def test_image_step_parameters_and_gradients_match_jax(image_step, net):
    _, _, jt, pt = image_step
    assert_trees_close(pt[net]["params"], jt[net]["params"], ATOL)
    assert_moments_close(pt["adam_mu"][net], jt["adam_mu"][net])


def test_image_step_batch_stats_match_jax(image_step):
    _, _, jt, pt = image_step
    assert_trees_close(pt["g"]["batch_stats"], jt["g"]["batch_stats"], 1e-5)


def test_image_draws_follow_the_shape():
    """Targets in [0, 3); per row 16 patch scores, and a mask of exactly
    8 modifiable 5-px patches over 20x20 pixels, aligned to the grid."""
    _, _, port, _ = _image_pair(False)
    draws = port.draw_fn(torch.Generator().manual_seed(0), (4, B))
    assert draws["targets"].shape == (4, B)
    assert int(draws["targets"].max()) < NC
    assert draws["mask"].shape == (4, B, (HW[0] // PATCH) ** 2)
    m = random_patch_mask(B, HW, PATCH, K, draws=draws["mask"][0])
    assert m.shape == (B, *HW, 1)
    assert (m.sum(dim=(1, 2, 3)) == K * PATCH * PATCH).all()
    cells = m[..., 0].reshape(B, 4, PATCH, 4, PATCH)
    assert (cells == cells[:, :, :1, :, :1]).all()


def test_serving_at_20x20_matches_jax_cf_fn():
    """`build_mnist_serving` on converted weights (random BatchNorm
    statistics) against the JAX bundle's `cf_fn` and classifier, f32."""
    jcfg, bundle, port, clf_vars = _image_pair(False)
    rng = np.random.RandomState(5)
    g_vars = _np(bundle.state.g.variables())
    g_vars["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        g_vars["batch_stats"])
    x, _ = _images(12)
    t = rng.randint(0, NC, B)
    mask = np.array(jax_patch_mask(jax.random.key(4), B, HW, PATCH, K))
    want = bundle.cf_fn(g_vars, jnp.asarray(x), jnp.asarray(t),
                        jnp.asarray(mask))
    g_sd = state_dict_from_flax(port.state.g.model, g_vars)
    clf_sd = state_dict_from_flax(CNNClassifier(NC, image_hw=HW), clf_vars)
    s = builders.build_mnist_serving(replace(port.cfg, compute_dtype="float32"),
                                     g_sd, clf_sd, device="cpu",
                                     num_classes=NC, image_hw=HW)
    assert s.num_classes == NC
    with torch.no_grad():
        got = s.cf_fn(torch.from_numpy(x), torch.from_numpy(t).long(),
                      torch.from_numpy(mask))
        logits = s.clf_fn(got[0])
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=0,
                                   atol=ATOL)
    want_logits = JaxCNN(num_classes=NC).apply(clf_vars, want[0])
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=1e-4)
    # the engine on the bundle serves the same shape and masks by patch
    engine = builders.mnist_engine(port, s.clf_fn, device="cpu")
    m = engine.mask_from_patches([1, 2, 5, 6, 9, 10, 13, 14], 1, HW)
    res = engine.generate(x[:1], 1, m)
    assert res.probs.shape == (1, NC)
    assert not (np.abs(res.x_cf - x[:1]) * (1 - m.numpy())).any()


RECAL_STEPS, RECAL_B, RECAL_N = 5, 16, 40


@pytest.mark.parametrize("mask_mode", ["train", "ones"])
def test_recalibration_at_20x20_matches_jax(mask_mode):
    """`recal_fn` on the draws re-derived from JAX's recalibrator key (per
    step `ki, kt, km, _ = split(k, 4)`), EMA parameters apart from the
    live ones: the recalibrated statistics within 1e-5."""
    _, bundle, port, _ = _image_pair(False, ema_decay=0.999)
    ema = jax.tree_util.tree_map(lambda p: p * 1.1 + 0.01,
                                 bundle.state.g.params)
    load_gan_state(port.state, {**_jax_trees(bundle.state),
                                "g_ema": _np(ema)})
    x = np.random.RandomState(6).uniform(-1, 1, (RECAL_N, *HW, 1)).astype(
        np.float32)
    key = jax.random.key(9)
    want = bundle.recal_fn(ema, dict(bundle.state.g.stats), jnp.asarray(x),
                           key, steps=RECAL_STEPS, batch_size=RECAL_B,
                           mask_mode=mask_mode)
    idx, targets, scores = [], [], []
    for k in jax.random.split(key, RECAL_STEPS):
        ki, kt, km, _ = jax.random.split(k, 4)
        idx.append(np.asarray(jax.random.randint(ki, (RECAL_B,), 0,
                                                 RECAL_N)))
        targets.append(np.asarray(jax.random.randint(kt, (RECAL_B,), 0, NC)))
        scores.append(np.asarray(jax.random.uniform(
            km, (RECAL_B, (HW[0] // PATCH) ** 2))))
    draws = {"idx": torch.tensor(np.stack(idx)).long(),
             "targets": torch.tensor(np.stack(targets)).long(),
             "mask": torch.tensor(np.stack(scores))}
    g = port.state.g.model
    stats = dict(g.named_buffers())
    got = port.recal_fn(port.state.g_ema, stats, torch.from_numpy(x),
                        draws=draws, mask_mode=mask_mode)
    got_tree = flax_from_state_dict(g, got)["batch_stats"]
    assert_trees_close(got_tree, _np(dict(want)["batch_stats"]), 1e-5)


def test_serving_selection_at_20x20_scores_three_targets(monkeypatch):
    """`select_g_serving_variables` on a 20x20 / 3-class bundle with an
    EMA: the three candidates, each scored over the three targets under
    all-ones 20x20 masks, and the chosen variables the generator's
    (recalibration cut to 4 forwards of 16 rows)."""
    monkeypatch.setattr(builders, "RECAL_STEPS", 4)
    monkeypatch.setattr(builders, "RECAL_BATCH", 16)
    _, _, port, _ = _image_pair(False, ema_decay=0.999)
    x, y = _images(13, b=24)
    sweeps = []
    clf = CNNClassifier(NC, image_hw=HW).eval()
    make = metrics.make_per_target_sweep

    def spy(cf_fn, clf_fn, num_classes, **kw):
        sweeps.append(num_classes)
        return make(cf_fn, clf_fn, num_classes, **kw)

    monkeypatch.setattr(metrics, "make_per_target_sweep", spy)
    with torch.no_grad():
        gv, info = builders.select_g_serving_variables(
            port, port.state, torch.from_numpy(x), 0, x, y, clf)
    assert sweeps == [NC]
    assert set(info["scores"]) == {"live", "ema_recal_train",
                                   "ema_recal_ones"}
    assert info["candidate"] in info["scores"]
    assert gv.keys() == port.state.g.model.state_dict().keys()


def _moons_data(seed, n=MOONS_B):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, MOONS_DIM).astype(np.float32),
            rng.randint(0, MOONS_NC, n).astype(np.int32))


@pytest.fixture(scope="module")
def moons_step():
    """Two steps of the shipped moons recipe at 4 classes and 3 features,
    both packages from one JAX state on the JAX step's draws."""
    jcfg = jax_presets.MOONS_COUNTERGAN.countergan
    pcfg = C.MOONS_COUNTERGAN
    clf_vars = _np(dict(JaxMLP(num_classes=MOONS_NC).init(
        jax.random.key(1), jnp.zeros((2, MOONS_DIM)))))
    bundle = jax_build_moons(jcfg, JaxMLP(num_classes=MOONS_NC),
                             JaxNetState.create(clf_vars, jax_adam(1e-2)),
                             num_classes=MOONS_NC, input_dim=MOONS_DIM,
                             seed=7)
    port = builders.build_moons_countergan(
        pcfg, state_dict_from_flax(MLPClassifier(MOONS_NC, 32, MOONS_DIM),
                                   clf_vars),
        device="cpu", num_classes=MOONS_NC, input_dim=MOONS_DIM)
    load_gan_state(port.state, _jax_trees(bundle.state))
    step = jax.jit(bundle.step_fn)
    key = jax.random.key(3)
    state, out = bundle.state, []
    for i in range(2):
        x, y = _moons_data(20 + i)
        k_t, k_m, _ = jax.random.split(jax.random.fold_in(key, i), 3)
        t = np.array(jax_sample_targets(k_t, jnp.asarray(y), MOONS_NC, True))
        mask = np.array(jax_feature_mask(k_m, len(y), MOONS_DIM))
        state, jm = step(state, jnp.asarray(x), jnp.asarray(y), key)
        pm = port.step_with_draws(
            port.state, torch.from_numpy(x), torch.from_numpy(y).long(),
            torch.from_numpy(t).long(), torch.from_numpy(mask))
        out.append(({k: float(v) for k, v in jm.items()},
                    {k: float(v) for k, v in pm.items()},
                    {**_jax_trees(state),
                     "adam_mu": _np({n: getattr(state, n).opt_state[0].mu
                                     for n in ("g", "d")})},
                    {**gan_state_to_flax(port.state),
                     "adam_mu": adam_moments_to_flax(port.state)}))
    return jcfg, bundle, port, out


@pytest.mark.parametrize("at", [0, 1], ids=["step1", "step2"])
def test_moons_step_at_4_classes_and_3_features_matches_jax(moons_step, at):
    jcfg, _, _, out = moons_step
    jm, pm, jt, pt = out[at]
    assert pm.keys() == jm.keys()
    drift = assert_state_close(pt, jt, at + 1, jcfg.lr_g, jcfg.lr_d)
    offset = float(np.linalg.norm(drift["sn2/bias"]))
    for name in jm:
        bar = ATOL + (offset if name in CRITIC_READ else 0.0)
        assert abs(pm[name] - jm[name]) <= bar, (name, pm[name], jm[name])
    noise_leaf = lambda k: k.endswith(NOISE_LEAVES)  # noqa: E731
    if at == 0:
        for net in ("g", "d"):
            assert_moments_close(pt["adam_mu"][net], jt["adam_mu"][net],
                                 skip=noise_leaf)
            assert_moments_close(pt["adam_mu"][net], jt["adam_mu"][net],
                                 atol=NOISE_MU,
                                 skip=lambda k: not noise_leaf(k))


def test_moons_serving_at_4_classes_and_3_features_matches_jax(moons_step):
    """The bundle's `cf_fn` and `build_moons_serving` on the stepped
    generator's variables against JAX's `cf_fn` on the same."""
    _, bundle, port, out = moons_step
    jt = out[-1][2]
    g_vars = {"params": jt["g"]["params"],
              "batch_stats": jt["g"]["batch_stats"]}
    x, _ = _moons_data(30)
    t = np.arange(MOONS_B) % MOONS_NC
    mask = np.ones_like(x)
    want = bundle.cf_fn(g_vars, jnp.asarray(x), jnp.asarray(t),
                        jnp.asarray(mask))
    g_sd = state_dict_from_flax(port.state.g.model, g_vars)
    got = port.cf_fn(g_sd, torch.from_numpy(x), torch.from_numpy(t).long(),
                     torch.from_numpy(mask))
    clf_sd = state_dict_from_flax(
        MLPClassifier(MOONS_NC, 32, MOONS_DIM),
        _np(dict(JaxMLP(num_classes=MOONS_NC).init(
            jax.random.key(1), jnp.zeros((2, MOONS_DIM))))))
    s = builders.build_moons_serving(port.cfg, g_sd, clf_sd, device="cpu",
                                     num_classes=MOONS_NC,
                                     input_dim=MOONS_DIM)
    with torch.no_grad():
        served = s.cf_fn(torch.from_numpy(x), torch.from_numpy(t).long(),
                         torch.from_numpy(mask))
    for g_, s_, w_ in zip(got, served, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=0,
                                   atol=ATOL)
        assert torch.equal(g_, s_)


# ---------------------------------------------- the defaults unchanged
def _state_dicts(bundle):
    return {net: getattr(bundle.state, net).model.state_dict()
            for net in ("g", "d")}


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _step_twice(bundle, make_batch):
    gen = torch.Generator().manual_seed(0)
    out = []
    for i in range(2):
        x, y = make_batch(i)
        m = bundle.step_fn(bundle.state, x, y, gen)
        out.append({k: v.clone() for k, v in m.items()})
    return out


@pytest.mark.parametrize("family", ["residual", "legacy", "moons"])
def test_builders_without_the_new_arguments_are_the_shipped_shapes(family):
    """Each builder called as before equals the same builder called with
    the shipped shape and class count, bit for bit: initial state dicts,
    two steps' metrics and the state after them."""
    if family == "moons":
        cfg = C.MOONS_COUNTERGAN
        clf = MLPClassifier().state_dict()

        def build(**kw):
            return builders.build_moons_countergan(cfg, clf, device="cpu",
                                                   **kw)

        explicit = dict(num_classes=3, input_dim=2)

        def batch(i):
            rng = np.random.RandomState(i)
            return (torch.from_numpy(rng.randn(64, 2).astype(np.float32)),
                    torch.from_numpy(rng.randint(0, 3, 64)).long())
    else:
        legacy = family == "legacy"
        cfg = _image_configs(legacy, patch=7, k=10)[1]
        clf = (LegacyCNNClassifier() if legacy else CNNClassifier()
               ).state_dict()

        def build(**kw):
            return builders.build_mnist_countergan(
                cfg, clf, device="cpu", legacy_delta=legacy, **kw)

        explicit = dict(num_classes=10, image_hw=(28, 28))

        def batch(i):
            rng = np.random.RandomState(i)
            return (torch.from_numpy(rng.uniform(-1, 1, (8, 28, 28, 1))
                                     .astype(np.float32)),
                    torch.from_numpy(rng.randint(0, 10, 8)).long())
    default, given = build(), build(**explicit)
    assert default.num_classes == given.num_classes == explicit["num_classes"]
    assert all(_equal(a, b) for a, b in zip(_state_dicts(default).values(),
                                            _state_dicts(given).values()))
    for m_default, m_given in zip(_step_twice(default, batch),
                                  _step_twice(given, batch)):
        assert _equal(m_default, m_given)
    assert all(_equal(a, b) for a, b in zip(_state_dicts(default).values(),
                                            _state_dicts(given).values()))


def test_serving_builders_without_the_new_arguments_are_the_shipped_shapes():
    """`mnist_models` / `build_mnist_serving` and `moons_models` /
    `build_moons_serving` with no new argument give the shipped models and
    the same counterfactuals as with the shipped values."""
    cfg = replace(C.MNIST_COUNTERGAN_REFERENCE, hidden_dim=8,
                  num_res_blocks=1)
    g, clf = builders.mnist_models(cfg, torch.Generator().manual_seed(0))
    g2, clf2 = builders.mnist_models(cfg, torch.Generator().manual_seed(0),
                                     num_classes=10, image_hw=(28, 28))
    assert _equal(g.state_dict(), g2.state_dict())
    assert _equal(clf.state_dict(), clf2.state_dict())
    x = torch.from_numpy(_images(1, 4, (28, 28))[0])
    t = torch.arange(4)
    mask = torch.ones_like(x)
    outs = [builders.build_mnist_serving(cfg, g.state_dict(),
                                         clf.state_dict(), device="cpu",
                                         **kw).cf_fn(x, t, mask)
            for kw in ({}, dict(num_classes=10, image_hw=(28, 28)))]
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    mcfg = C.MOONS_COUNTERGAN
    mg, mclf = builders.moons_models(mcfg, 32,
                                     torch.Generator().manual_seed(0))
    assert tuple(mclf.Linear_0.weight.shape) == (32, 2)
    xm = torch.randn(5, 2, generator=torch.Generator().manual_seed(1))
    outs = [builders.build_moons_serving(mcfg, mg.state_dict(),
                                         mclf.state_dict(), device="cpu",
                                         **kw).cf_fn(xm, torch.arange(5) % 3,
                                                     torch.ones_like(xm))
            for kw in ({}, dict(num_classes=3, input_dim=2))]
    assert all(torch.equal(a, b) for a, b in zip(*outs))
