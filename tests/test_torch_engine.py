"""The port's MNIST serving path (build_mnist_serving + CounterfactualEngine)
against the JAX package's (build_mnist_countergan's cf_fn, the float32
classifier forward of `CounterfactualEngine.from_bundle`,
CounterfactualEngine), on weights carried across by cfgan_torch.convert.
JAX's Pallas conv runs in interpret mode.

Tolerances: float32 abs <= 1e-5 (same arithmetic, other summation orders).
bfloat16 abs <= 4e-3 on x_cf and the residual and <= 1e-2 on the class
probabilities: XLA and PyTorch round bf16 at different places (see
test_torch_models.py), and the classifier sees x_cf after that rounding.
"""
from dataclasses import replace
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgan.core.config import CounterGANConfig as JaxConfig
from cfgan.core.config import MaskConfig as JaxMaskConfig
from cfgan.masks.patch import patch_indices_to_mask as jax_patch_mask
from cfgan.models.classifiers import CNNClassifier as JaxClassifier
from cfgan.serve.engine import CounterfactualEngine as JaxEngine
from cfgan.train.builders import _clf_forward_fn, build_mnist_countergan
from cfgan_torch.convert import state_dict_from_flax
from cfgan_torch.core.config import MNIST_COUNTERGAN, CounterGANConfig
from cfgan_torch.masks.patch import patch_indices_to_mask
from cfgan_torch.serve.engine import CounterfactualEngine
from cfgan_torch.train.builders import build_mnist_serving, mnist_models

WIDTH, DEPTH = 16, 2
PATCHES = [0, 5, 10, 15]


def _jax_engine(dtype):
    cfg = JaxConfig(hidden_dim=WIDTH, num_res_blocks=DEPTH,
                    compute_dtype=dtype, conv_impl="pallas",
                    mask=JaxMaskConfig(patch_size=7))
    clf_model = JaxClassifier()
    clf_vars = jax.tree_util.tree_map(np.asarray, dict(clf_model.init(
        jax.random.key(1), jnp.zeros((2, 28, 28, 1)))))
    clf_state = SimpleNamespace(params=clf_vars["params"], stats={},
                                variables=lambda: clf_vars)
    bundle = build_mnist_countergan(cfg, clf_model, clf_state, seed=3)
    g_vars = jax.tree_util.tree_map(np.asarray, bundle.state.g.variables())
    rng = np.random.default_rng(4)
    g_vars["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        g_vars["batch_stats"])
    engine = JaxEngine.from_bundle(bundle, clf_model, clf_state,
                                   g_variables=g_vars, patch_size=7)
    return engine, g_vars, clf_vars


def _port_engine(dtype, g_vars, clf_vars, impl="pallas"):
    cfg = replace(MNIST_COUNTERGAN, hidden_dim=WIDTH, num_res_blocks=DEPTH,
                  compute_dtype=dtype, conv_impl=impl)
    g, c = mnist_models(cfg)
    s = build_mnist_serving(cfg, state_dict_from_flax(g, g_vars),
                            state_dict_from_flax(c, clf_vars), device="cpu")
    return CounterfactualEngine(s.cf_fn, s.clf_fn, s.num_classes,
                                patch_size=cfg.mask.patch_size, device="cpu")


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def engines(request):
    dtype = request.param
    jax_engine, g_vars, clf_vars = _jax_engine(dtype)
    return dtype, jax_engine, _port_engine(dtype, g_vars, clf_vars)


def _images(b, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (b, 28, 28, 1)).astype(np.float32)


def _assert_results_match(got, want, dtype):
    atol, p_atol = (1e-5, 1e-5) if dtype == "float32" else (4e-3, 1e-2)
    np.testing.assert_allclose(got.x_cf, np.asarray(want.x_cf), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(got.residual, np.asarray(want.residual),
                               atol=atol, rtol=0)
    for name in ("probs", "probs_orig", "confidence"):
        np.testing.assert_allclose(getattr(got, name),
                                   np.asarray(getattr(want, name)),
                                   atol=p_atol, rtol=0)
    if dtype == "float32":
        np.testing.assert_array_equal(got.pred, want.pred)
        np.testing.assert_array_equal(got.flipped, want.flipped)
    assert got.x_cf.dtype == np.float32 and got.x_cf.shape == want.x_cf.shape


def test_generate_single_sample_int_target(engines):
    dtype, jax_engine, engine = engines
    x = _images(1)[0]
    _assert_results_match(engine.generate(x, 7), jax_engine.generate(x, 7),
                          dtype)


def test_generate_bucket_per_sample_targets_and_patch_mask(engines):
    """b=5 pads to the bucket of 8; targets per sample; one patch mask
    broadcast over the batch."""
    dtype, jax_engine, engine = engines
    x, t = _images(5, seed=1), np.array([3, 1, 4, 1, 5])
    got = engine.generate(x, t, engine.mask_from_patches(PATCHES, 1,
                                                         (28, 28)))
    want = jax_engine.generate(x, t, jax_engine.mask_from_patches(
        PATCHES, 1, (28, 28)))
    _assert_results_match(got, want, dtype)


def test_generate_bulk(engines):
    """20 rows at chunk 8: 3 chunks, padded to 4."""
    dtype, jax_engine, engine = engines
    x = _images(20, seed=2)
    t = np.arange(20) % 10
    _assert_results_match(engine.generate_bulk(x, t, chunk=8),
                          jax_engine.generate_bulk(x, t, chunk=8), dtype)


def test_classify_matches_jax_from_bundle(engines):
    """Served classifier in float32 under either compute dtype, as the JAX
    engine's `from_bundle` applies it: the same function on the same
    weights, abs <= 1e-5."""
    _, jax_engine, engine = engines
    x = _images(6, seed=9)
    np.testing.assert_allclose(engine.classify(x),
                               np.asarray(jax_engine.classify(x)),
                               atol=1e-5, rtol=0)


def test_training_classifier_runs_in_the_compute_dtype():
    """The train step's frozen classifier keeps the compute dtype, as
    `_clf_forward_fn` does: its float32 logits are bf16 values (a float32
    forward's are not), within 1e-2 of JAX's bf16 logits."""
    from cfgan_torch.train.builders import clf_forward_fn

    clf_model = JaxClassifier()
    v = jax.tree_util.tree_map(np.asarray, dict(clf_model.init(
        jax.random.key(1), jnp.zeros((2, 28, 28, 1)))))
    c = mnist_models(replace(MNIST_COUNTERGAN, hidden_dim=WIDTH,
                             num_res_blocks=DEPTH))[1]
    c.load_state_dict(state_dict_from_flax(c, v))
    x = _images(4, seed=10)
    want = _clf_forward_fn(clf_model, v, "bfloat16")(jnp.asarray(x))
    got = clf_forward_fn(c, "bfloat16")(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert torch.equal(got, got.bfloat16().float())
    f32 = clf_forward_fn(c, "float32")(torch.from_numpy(x))
    assert not torch.equal(f32, f32.bfloat16().float())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2,
                               rtol=0)
    assert next(c.parameters()).dtype == torch.float32


@pytest.mark.parametrize("patches,batch,channels",
                         [([], 2, 1), (PATCHES, 3, 1), ([15, 0], 1, 3),
                          ([-1, 2], 2, 1)])
def test_patch_mask_matches_jax(patches, batch, channels):
    got = patch_indices_to_mask(patches, batch, (28, 28), 7, channels)
    want = jax_patch_mask(patches, batch, (28, 28), 7, channels)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_patch_mask_rejects_an_index_outside_the_grid():
    """The JAX package drops such an index silently (ROADMAP, Queue C)."""
    with pytest.raises(ValueError, match="outside"):
        patch_indices_to_mask([3, 16], 1, (28, 28), 7)
    with pytest.raises(ValueError, match="outside"):
        patch_indices_to_mask([-17], 1, (28, 28), 7)


@pytest.fixture(scope="module")
def cpu_engine():
    cfg = replace(MNIST_COUNTERGAN, hidden_dim=WIDTH, num_res_blocks=DEPTH,
                  conv_impl="pallas")
    g, c = mnist_models(cfg, generator=torch.Generator().manual_seed(0))
    s = build_mnist_serving(cfg, g.state_dict(), c.state_dict(),
                            device="cpu")
    return s


def _engine(serving, pad=True):
    e = CounterfactualEngine(serving.cf_fn, serving.clf_fn, 10,
                             patch_size=7, device="cpu")
    e.pad_to_bucket = pad
    return e


def test_zero_mask_returns_x_bit_for_bit(cpu_engine):
    x = _images(3, seed=5)
    r = _engine(cpu_engine).generate(x, 2, np.zeros_like(x))
    assert np.array_equal(r.x_cf, x)
    assert not r.residual.any()


def test_bucket_padding_does_not_change_values(cpu_engine):
    x, t = _images(5, seed=6), np.array([0, 9, 2, 2, 7])
    padded = _engine(cpu_engine).generate(x, t)
    exact = _engine(cpu_engine, pad=False).generate(x, t)
    np.testing.assert_allclose(padded.x_cf, exact.x_cf, atol=1e-6, rtol=0)
    np.testing.assert_allclose(padded.probs, exact.probs, atol=1e-6, rtol=0)


def test_generate_bulk_matches_generate(cpu_engine):
    x = _images(11, seed=7)
    e = _engine(cpu_engine)
    bulk, one = e.generate_bulk(x, 4, chunk=4), e.generate(x, 4)
    np.testing.assert_allclose(bulk.x_cf, one.x_cf, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(bulk.pred, one.pred)


def test_classify_matches_probs_orig(cpu_engine):
    x = _images(4, seed=8)
    e = _engine(cpu_engine)
    np.testing.assert_allclose(e.classify(x), e.generate(x, 1).probs_orig,
                               atol=1e-6, rtol=0)


def test_config_frozen_after_first_request(cpu_engine):
    e = _engine(cpu_engine)
    e.generate(_images(1), 0)
    with pytest.raises(RuntimeError):
        e.pad_to_bucket = False


@pytest.mark.parametrize("entry", ["generate", "generate_bulk"])
@pytest.mark.parametrize("target", [10, -1, [3, 10], np.array([-1, 0])],
                         ids=["10", "-1", "per_row_10", "per_row_-1"])
def test_target_outside_the_class_range_is_rejected(cpu_engine, entry,
                                                    target):
    """The JAX engine serves NaN for target 10 and wraps -1 (ROADMAP,
    Queue C); the port rejects both on the host, and a valid request
    still serves afterwards."""
    e = _engine(cpu_engine)
    x = _images(2, seed=9)
    with pytest.raises(ValueError, match="class range"):
        getattr(e, entry)(x, target)
    r = getattr(e, entry)(x, [9, 0])
    assert r.x_cf.shape == x.shape and np.isfinite(r.x_cf).all()


@pytest.mark.parametrize("b", [1, 2, 3, 5, 8, 100, 512, 513, 1500])
def test_bucket_sizes_match_jax(b):
    assert CounterfactualEngine._bucket(b) == JaxEngine._bucket(b)


def test_entry_points_raise_without_a_card(monkeypatch, cpu_engine):
    """device=None means the CUDA card; where there is none the entry
    points raise instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = replace(MNIST_COUNTERGAN, hidden_dim=WIDTH, num_res_blocks=DEPTH)
    g, c = mnist_models(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_mnist_serving(cfg, g.state_dict(), c.state_dict())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CounterfactualEngine(cpu_engine.cf_fn, cpu_engine.clf_fn, 10)


def test_serving_preset_matches_the_jax_preset():
    from cfgan.experiments.presets import MNIST_COUNTERGAN as JAX_PRESET

    want = JAX_PRESET.countergan
    for field in ("hidden_dim", "num_res_blocks", "residual_scaling",
                  "compute_dtype", "conv_impl"):
        assert getattr(MNIST_COUNTERGAN, field) == getattr(want, field)
    assert MNIST_COUNTERGAN.mask.patch_size == want.mask.patch_size
    assert isinstance(MNIST_COUNTERGAN, CounterGANConfig)
