"""The port's moons serving slice against the JAX package on the CPU:
`cfgan_torch.data.moons` (bit for bit with `cfgan.data.moons`, whose
scikit-learn draws it redoes in numpy), `MoonsResidualGenerator` and
`MLPClassifier` on converted flax weights (within 1e-6), the moons presets
(field for field), and `moons_engine` on the committed
`results/moons_countergan/` run dir against the JAX engine of
`cfgan.serve.launch.setup_moons` (within 1e-5, equal predictions)."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgan.data import moons as jmoons
from cfgan.experiments import presets as jax_presets
from cfgan.models.classifiers import MLPClassifier as JaxMLP
from cfgan.models.generators import MoonsResidualGenerator as JaxMoonsG
from cfgan.serve.launch import setup_moons as jax_setup_moons
from cfgan_torch.convert import state_dict_from_flax
from cfgan_torch.data import moons as pmoons
from cfgan_torch.experiments import presets
from cfgan_torch.models.classifiers import MLPClassifier
from cfgan_torch.models.generators import MoonsResidualGenerator
from cfgan_torch.serve.launch import setup_moons

ROOT = Path(__file__).resolve().parent.parent
COMMITTED = ROOT / "results" / "moons_countergan"
TOL = 1e-5  # the engine against JAX's: float32 matmuls in other orders
MODEL_TOL = 1e-6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("kw", [
    {}, {"seed": 0}, {"seed": 7, "noise": 0.3},
    {"seed": 3, "n_moons": 101, "n_rect": 7, "test_fraction": 0.33}],
    ids=["default", "seed0", "noise", "odd-sizes"])
def test_load_moons3_is_bit_equal(kw):
    want = jmoons.load_moons3(**kw)
    got = pmoons.load_moons3(**kw)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    for g, w in zip(got[2], want[2]):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_load_moons3_splits_240_test_rows():
    (xtr, ytr), (xte, yte), _ = pmoons.load_moons3()
    assert (len(xtr), len(xte)) == (960, 240)
    assert set(np.unique(np.concatenate([ytr, yte]))) == {0, 1, 2}
    x = np.concatenate([xtr, xte])
    assert x.min() == 0.0 and x.max() == 1.0


@pytest.mark.parametrize("seed,n,noise", [(42, 2000, 0.05), (0, 101, 0.2)])
def test_load_moons2_is_bit_equal(seed, n, noise):
    want = jmoons.load_moons2(seed, n, noise)
    got = pmoons.load_moons2(seed, n, noise)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


# ---------------------------------------------------------------- models
def _moons_inputs(b=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(b, 2).astype(np.float32)
    t = rng.randint(0, 3, b)
    oh = np.eye(3, dtype=np.float32)[t]
    mask = (rng.rand(b, 2) > 0.3).astype(np.float32)
    return x, oh, mask


@pytest.mark.parametrize("hidden", [32, 8])
def test_moons_generator_matches_flax(hidden):
    """Eval mode on random BatchNorm statistics, and train mode with its
    running-statistics update, within 1e-6."""
    x, oh, mask = _moons_inputs()
    jg = JaxMoonsG(hidden_dim=hidden)
    v = _np(jg.init(jax.random.key(1), x[:2], oh[:2], mask[:2]))
    rng = np.random.RandomState(2)
    for name, stats in v["batch_stats"].items():
        stats["mean"] = rng.randn(*stats["mean"].shape).astype(np.float32)
        stats["var"] = (0.5 + rng.rand(*stats["var"].shape)).astype(
            np.float32)
        v["params"][name]["scale"] = (0.5 + rng.rand(
            *stats["var"].shape)).astype(np.float32)
    pg = MoonsResidualGenerator(2, hidden, 3)
    pg.load_state_dict(state_dict_from_flax(pg, v), strict=True)
    want = jg.apply(v, x, oh, mask, train=False)
    got = pg.eval()(*map(torch.from_numpy, (x, oh, mask)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=MODEL_TOL, rtol=0)
    (want_raw, _), new = jg.apply(v, x, oh, mask, train=True,
                                  mutable=["batch_stats"])
    got_raw, _ = pg.train()(*map(torch.from_numpy, (x, oh, mask)))
    np.testing.assert_allclose(got_raw.detach().numpy(),
                               np.asarray(want_raw), atol=MODEL_TOL, rtol=0)
    for i in range(3):
        stats = new["batch_stats"][f"BatchNorm_{i}"]
        bn = getattr(pg, f"BatchNorm_{i}")
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(stats["mean"]),
                                   atol=MODEL_TOL, rtol=0)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(stats["var"]),
                                   atol=MODEL_TOL, rtol=0)


@pytest.mark.parametrize("hidden", [32, 8])
def test_mlp_classifier_matches_flax(hidden):
    x, _, _ = _moons_inputs(100, seed=3)
    jc = JaxMLP(hidden_dim=hidden)
    v = _np(jc.init(jax.random.key(4), x[:2]))
    pc = MLPClassifier(3, hidden)
    pc.load_state_dict(state_dict_from_flax(pc, v), strict=True)
    want = jc.apply(v, jnp.asarray(x), train=False)
    got = pc(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=MODEL_TOL, rtol=0)


# --------------------------------------------------------------- presets
@pytest.mark.parametrize("name", ["MOONS_COUNTERGAN",
                                  "MOONS_COUNTERGAN_REFERENCE"])
def test_presets_equal_the_jax_presets(name):
    got, want = getattr(presets, name), getattr(jax_presets, name)
    assert (got.name, got.seed, got.num_classes) == (
        want.name, want.seed, want.num_classes)
    for part in ("data", "classifier"):
        for field, value in vars(getattr(got, part)).items():
            assert getattr(getattr(want, part), field) == value, field
    for field, value in vars(got.countergan).items():
        if field != "mask":
            assert getattr(want.countergan, field) == value, field
    for field, value in vars(got.countergan.mask).items():
        assert getattr(want.countergan.mask, field) == value, field
    assert presets.PRESETS[got.name] is got


# --------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def engines():
    jeng, _, xte, yte = jax_setup_moons(str(COMMITTED))
    peng, clf_fn, pxte, pyte = setup_moons(str(COMMITTED), device="cpu")
    assert np.array_equal(xte, pxte) and np.array_equal(yte, pyte)
    return jeng, peng, clf_fn, xte, yte


@pytest.mark.parametrize("target", [0, 1, 2])
def test_moons_engine_serves_the_jax_counterfactuals(engines, target):
    jeng, peng, _, xte, _ = engines
    want = jeng.generate(xte, target)
    got = peng.generate(xte, target)
    for field in ("x_cf", "residual", "probs", "probs_orig", "confidence"):
        np.testing.assert_allclose(getattr(got, field),
                                   getattr(want, field), atol=TOL, rtol=0)
    np.testing.assert_array_equal(got.pred, want.pred)
    np.testing.assert_array_equal(got.flipped, want.flipped)


def test_moons_engine_bulk_and_masks_match_jax(engines):
    jeng, peng, _, xte, yte = engines
    t = (yte + 1) % 3
    want = jeng.generate_bulk(xte, t, chunk=64)
    got = peng.generate_bulk(xte, t, chunk=64)
    np.testing.assert_allclose(got.x_cf, want.x_cf, atol=TOL, rtol=0)
    np.testing.assert_array_equal(got.pred, want.pred)
    x_only = np.asarray([1.0, 0.0], np.float32)
    want = jeng.generate(xte[:50], 2, mask=x_only)
    got = peng.generate(xte[:50], 2, mask=x_only)
    np.testing.assert_allclose(got.x_cf, want.x_cf, atol=TOL, rtol=0)
    # an x-only mask leaves feature 1 as it was, bit for bit
    assert np.array_equal(got.x_cf[:, 1], xte[:50, 1])


def test_zero_mask_returns_x_bit_for_bit(engines):
    _, peng, _, xte, _ = engines
    res = peng.generate(xte, 1, mask=np.zeros(2, np.float32))
    assert np.array_equal(res.x_cf, xte) and not res.residual.any()


def test_classifier_logits_match_jax(engines):
    jeng, peng, clf_fn, xte, _ = engines
    np.testing.assert_allclose(peng.classify(xte), jeng.classify(xte),
                               atol=TOL, rtol=0)
    logits = clf_fn(torch.from_numpy(xte)).numpy()
    np.testing.assert_allclose(
        np.exp(logits) / np.exp(logits).sum(1, keepdims=True),
        jeng.classify(xte), atol=TOL, rtol=0)
