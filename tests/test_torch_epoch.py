"""The port's epoch runner and train loop (cfgan_torch.train) against the
JAX package's `make_epoch_runner`, on the CPU (where the runner runs its
steps eagerly; the card's CUDA-graph replay is held against eager steps in
tests/test_torch_gpu.py).

- One epoch of 4 steps from one initial state (carried across by
  cfgan_torch.convert) on the same dataset, permutation and draws: the
  targets' and masks' draws are re-derived from the JAX step's key
  (`fold_in(key, step)`), as tests/test_torch_step.py re-derives them.
  Width 8, one residual block, batch 16, float32, the reference recipe
  with the generator EMA.  Bars: per-step d_loss 1e-4 and g_loss 3e-4,
  the diagnostics 1e-4, the epoch means the same, and after the epoch
  every parameter, BatchNorm statistic and EMA leaf 1e-4 (the three-step
  bars of tests/test_torch_step.py).
- A loop resumed from its checkpoint after epoch 1 equals the
  uninterrupted 2-epoch run exactly (parameters, statistics, EMA, Adam's
  moments and count, history).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgan.models.classifiers import CNNClassifier as JaxClassifier
from cfgan.train.builders import build_mnist_countergan as jax_build
from cfgan.train.countergan import make_epoch_runner as jax_epoch_runner
from cfgan.train.state import NetState as JaxNetState
from cfgan.train.state import adam_like_torch as jax_adam
from cfgan_torch.convert import (
    gan_state_to_flax,
    load_gan_state,
    state_dict_from_flax,
    train_state_to_flax,
)
from cfgan_torch.models.classifiers import CNNClassifier
from cfgan_torch.train.builders import build_mnist_countergan
from cfgan_torch.train.loop import make_epoch_runner
from cfgan_torch.train.loop import train_countergan_loop

from test_torch_step import _configs, _jax_trees, assert_trees_close

B, STEPS, N = 16, 4, 80


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU run shares its cores with other test workers: one torch
    thread keeps this file's many small eager ops from oversubscribing
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (N, 28, 28, 1)).astype(np.float32),
            rng.randint(0, 10, N).astype(np.int32))


def jax_draws(key, steps, batch):
    """The JAX step's target and patch-mask draws at steps 0..steps-1
    (`k_t, k_m, _ = split(fold_in(key, step), 3)`)."""
    targets, scores = [], []
    for i in range(steps):
        k_t, k_m, _ = jax.random.split(jax.random.fold_in(key, i), 3)
        targets.append(np.asarray(jax.random.randint(k_t, (batch,), 0, 10)))
        scores.append(np.asarray(jax.random.uniform(k_m, (batch, 16))))
    return {"targets": torch.tensor(np.stack(targets)).long(),
            "mask": torch.tensor(np.stack(scores))}


@pytest.fixture(scope="module")
def epoch_pair():
    jcfg, pcfg = _configs(ema_decay=0.9)
    clf_model = JaxClassifier()
    clf_vars = jax.tree_util.tree_map(np.asarray, dict(clf_model.init(
        jax.random.key(1), jnp.zeros((2, 28, 28, 1)), train=False)))
    bundle = jax_build(jcfg, clf_model,
                       JaxNetState.create(clf_vars, jax_adam(1e-3)), seed=7)
    port = build_mnist_countergan(
        pcfg, state_dict_from_flax(CNNClassifier(), clf_vars), device="cpu")
    load_gan_state(port.state, _jax_trees(bundle.state))
    x, y = _data()
    perm = np.random.RandomState(1).permutation(N)[:STEPS * B].reshape(
        STEPS, B)
    key = jax.random.key(3)
    state, traces = jax_epoch_runner(bundle.step_fn, donate=False,
                                     reduce=False)(
        bundle.state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(perm), key)
    got = make_epoch_runner(port.step_from_draws, reduce=False)(
        port.state, torch.from_numpy(x), torch.from_numpy(y).long(),
        torch.from_numpy(perm), jax_draws(key, STEPS, B))
    return ({k: np.asarray(v) for k, v in traces.items()}, _jax_trees(state),
            got, gan_state_to_flax(port.state), port.state.step)


def test_epoch_step_metrics_match_jax(epoch_pair):
    want, _, got, _, _ = epoch_pair
    assert got.keys() == want.keys()
    for name, trace in want.items():
        assert got[name].shape == (STEPS,)
        bar = {"d_loss": 1e-4, "g_loss": 3e-4}.get(name, 1e-4)
        assert np.abs(got[name] - trace).max() <= bar, name
        assert abs(got[name].mean() - trace.mean()) <= bar, name


def test_epoch_state_matches_jax(epoch_pair):
    _, want, _, got, step = epoch_pair
    assert step == STEPS
    for net in ("g", "d"):
        assert_trees_close(got[net]["params"], want[net]["params"], 1e-4)
    assert_trees_close(got["g"]["batch_stats"], want["g"]["batch_stats"],
                       1e-4)
    assert_trees_close(got["g_ema"], want["g_ema"], 1e-4)


def test_reduced_epoch_returns_the_means_of_the_traces():
    _, pcfg = _configs(ema_decay=0.999)
    x, y = (torch.from_numpy(a) for a in _data(2))
    perm = torch.randperm(N, generator=torch.Generator().manual_seed(0))[
        :STEPS * B].reshape(STEPS, B)
    clf = CNNClassifier(generator=torch.Generator().manual_seed(2))
    out = []
    for reduce in (False, True):
        b = build_mnist_countergan(pcfg, clf.state_dict(), seed=3,
                                   device="cpu")
        draws = b.draw_fn(torch.Generator().manual_seed(5), (STEPS, B))
        runner = b.epoch_fn if reduce else make_epoch_runner(
            b.step_from_draws, reduce=False)
        out.append(runner(b.state, x, y.long(), perm, draws))
        assert b.state.step == STEPS
    traces, means = out
    assert means.keys() == traces.keys()
    for k, v in traces.items():
        assert means[k] == pytest.approx(float(np.mean(v)), rel=1e-6,
                                         abs=1e-7)


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _tree_equal(a[k], b[k])
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_resumed_loop_equals_the_uninterrupted_run(tmp_path):
    _, pcfg = _configs(ema_decay=0.999)
    x, y = _data(4)
    clf = CNNClassifier(generator=torch.Generator().manual_seed(2))

    def loop(epochs, ckpt_dir):
        b = build_mnist_countergan(pcfg, clf.state_dict(), seed=9,
                                   device="cpu")
        state, hist = train_countergan_loop(
            b, x, y, epochs=epochs, batch_size=B, seed=11, log=lambda s: None,
            checkpoint_dir=str(ckpt_dir), checkpoint_every=1)
        hist.pop("wall_time_s")
        return train_state_to_flax(state), hist

    whole, whole_hist = loop(2, tmp_path / "a")
    first, _ = loop(1, tmp_path / "b")
    resumed, resumed_hist = loop(2, tmp_path / "b")
    assert int(first["step"]) == N // B and int(whole["step"]) == 2 * (N // B)
    _tree_equal(resumed, whole)
    assert resumed_hist == whole_hist
    with pytest.raises(AssertionError):
        _tree_equal(first, whole)
