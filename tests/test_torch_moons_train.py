"""The port's moons CounteRGAN training against the JAX package's, on the
CPU: the full-batch classifier regime (`train_classifier` with `steps`),
the train step of `build_moons_countergan` on the same draws, the epoch
runner, and resuming the committed `results/moons_countergan/train_state/`
in either package.

The shipped moons preset at its full width (hidden 32, critic widths 32,
16, 16, batch 64, float32, no clamp: the epilogue's bounds are -1e30 and
1e30).  Both packages start from one state (JAX's initial weights carried
over by `cfgan_torch.convert`); the targets and feature masks are
re-derived from the JAX step's key (`k_t, k_m, _ = split(fold_in(key,
step), 3)`) and handed to the port.

Tolerances (TF32 does not apply on the CPU): 3e-5 on a step's losses,
diagnostics, parameters, BatchNorm statistics and the critic's `u`, with
the house step tests' exceptions for gradients that are zero in exact
arithmetic.  Here those are the biases of the generator's three Linear
layers that a BatchNorm follows, and the critic's last hidden biases
(`sn2/bias`) of units active on every row under the Wasserstein loss:
float32 noise for a gradient, which Adam turns into moves of up to lr a
step, in each package its own.  Those leaves are held within 2 lr a step,
a BatchNorm running mean within 3e-5 plus the drift of the bias before
it, and the four numbers read through the critic's score (g_adv, g_loss,
d_real_p, d_fake_p) within 3e-5 plus the 2-norm of `sn2/bias`'s drift.
Adam's first moments hold the gradients within 5e-5 of their 2-norm
(1e-6 absolute in the noise leaves).  The full-batch classifier at lr
1e-2: each loss within 3e-5, every parameter within 3e-5 after 5 steps
(see the test for 20).
"""
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from cfgan.core import checkpoint as jck
from cfgan.core.config import ClassifierConfig as JaxClassifierConfig
from cfgan.experiments import presets as jax_presets
from cfgan.masks.feature import random_feature_mask as jax_feature_mask
from cfgan.models.classifiers import MLPClassifier as JaxMLP
from cfgan.train.builders import build_moons_countergan as jax_build
from cfgan.train.classifier import train_classifier as jax_train_classifier
from cfgan.train.countergan import make_epoch_runner as jax_epoch_runner
from cfgan.train.countergan import sample_targets as jax_sample_targets
from cfgan.train.state import NetState as JaxNetState
from cfgan.train.state import adam_like_torch as jax_adam
from cfgan_torch.convert import (
    adam_moments_to_flax,
    flax_from_state_dict,
    gan_state_to_flax,
    load_gan_state,
    state_dict_from_flax,
    train_state_to_flax,
)
from cfgan_torch.core import checkpoint as ck
from cfgan_torch.core import config as C
from cfgan_torch.core.config import ClassifierConfig
from cfgan_torch.data.moons import load_moons3
from cfgan_torch.models.classifiers import MLPClassifier
from cfgan_torch.train.builders import build_moons_countergan
from cfgan_torch.train.classifier import train_classifier
from cfgan_torch.train.loop import make_epoch_runner

from test_torch_step import assert_moments_close, assert_trees_close, leaves

B, STEPS, ATOL = 64, 3, 3e-5
NOISE_LEAVES = ("Linear_0/bias", "Linear_1/bias", "Linear_2/bias",
                "sn2/bias")
NOISE_MU = 1e-6  # a noise leaf's first-moment 2-norm: measured 2.3e-7
CRITIC_READ = ("g_adv", "g_loss", "d_real_p", "d_fake_p")
DIAGNOSTICS = ("g_adv", "g_cls", "reg_l1", "reg_l2", "mask_penalty",
               "d_real_p", "d_fake_p", "residual_mean", "flip_rate",
               "pred_gain")
RUN_DIR = Path(__file__).resolve().parent.parent / "results" / \
    "moons_countergan"
PRESETS = {"shipped": (jax_presets.MOONS_COUNTERGAN.countergan,
                       C.MOONS_COUNTERGAN),
           "reference": (jax_presets.MOONS_COUNTERGAN_REFERENCE.countergan,
                         C.MOONS_COUNTERGAN_REFERENCE)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    (xtr, ytr), _, _ = load_moons3()
    return xtr, ytr


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_trees(state):
    return _np({"g": state.g.variables(), "d": state.d.variables(),
                "g_ema": state.g_ema})


def _flat(tree):
    return dict(leaves(tree)) if tree is not None else {}


@pytest.mark.parametrize("steps", [5, 20])
def test_full_batch_classifier_matches_jax(data, steps):
    """Full-batch Adam steps of the moons classifier from JAX's initial
    weights: every step's loss and the final parameters.  After 20 steps
    at lr 1e-2 a few elements whose gradient passes near zero have taken
    Adam steps of their own size in each package (3 of 1,251 measured
    over 3e-5, the largest 4.6e-5): at most 0.5% of the elements may
    exceed 3e-5, and none 1e-4."""
    xtr, ytr = data
    jcfg = JaxClassifierConfig(lr=1e-2, steps=steps, hidden_dim=32)
    jstate, jhist = jax_train_classifier(JaxMLP(), jcfg, (xtr, ytr), seed=42)
    k_init, _ = jax.random.split(jax.random.key(42))
    init = _np(dict(JaxMLP().init({"params": k_init, "dropout": k_init},
                                  jnp.asarray(xtr[:2]), train=False)))
    model = MLPClassifier()
    model.load_state_dict(state_dict_from_flax(model, init))
    ns, hist = train_classifier(model, ClassifierConfig(lr=1e-2, steps=steps),
                                (xtr, ytr), device="cpu")
    assert hist["val_acc"] == [] and len(hist["loss"]) == steps
    np.testing.assert_allclose(hist["loss"], np.asarray(jhist["loss"]),
                               rtol=0, atol=ATOL)
    assert hist["loss"][-1] < hist["loss"][0]
    assert ns.model is model and not model.training
    got = _flat(flax_from_state_dict(model, model.state_dict()))
    want = _flat(_np(jstate.variables()))
    assert got.keys() == want.keys()
    err = np.concatenate([np.abs(got[k] - w).ravel()
                          for k, w in want.items()])
    if steps == 5:
        assert err.max() <= ATOL
    else:
        assert (err > ATOL).mean() <= 5e-3 and err.max() <= 1e-4


def build_pair(preset="shipped", **overrides):
    """(JAX cfg, JAX bundle, port bundle) of a moons preset at full width,
    the port loaded with the JAX initial state; a random frozen
    classifier."""
    jcfg, pcfg = PRESETS[preset]
    jcfg, pcfg = replace(jcfg, **overrides), replace(pcfg, **overrides)
    clf_vars = _np(dict(JaxMLP().init(jax.random.key(1), jnp.zeros((2, 2)))))
    bundle = jax_build(jcfg, JaxMLP(),
                       JaxNetState.create(clf_vars, jax_adam(1e-2)), seed=7)
    port = build_moons_countergan(
        pcfg, state_dict_from_flax(MLPClassifier(), clf_vars), device="cpu")
    load_gan_state(port.state, _jax_trees(bundle.state))
    return jcfg, bundle, port


def jax_step_draws(key, step, y, resample=True):
    """The JAX step's targets and feature mask at `step`, as numpy."""
    k_t, k_m, _ = jax.random.split(jax.random.fold_in(key, step), 3)
    t = jax_sample_targets(k_t, jnp.asarray(y), 3, resample)
    return np.array(t), np.array(jax_feature_mask(k_m, len(y), 2))


def run_pair(preset, data, steps=STEPS):
    xtr, ytr = data
    jcfg, bundle, port = build_pair(preset)
    step = jax.jit(bundle.step_fn)
    key = jax.random.key(3)
    state, out = bundle.state, []
    for i in range(steps):
        x, y = xtr[i * B:(i + 1) * B], ytr[i * B:(i + 1) * B]
        t, mask = jax_step_draws(key, i, y)
        state, jm = step(state, jnp.asarray(x), jnp.asarray(y), key)
        pm = port.step_with_draws(
            port.state, torch.from_numpy(x), torch.from_numpy(y).long(),
            torch.from_numpy(t).long(), torch.from_numpy(mask))
        mu = _np({net: getattr(state, net).opt_state[0].mu
                  for net in ("g", "d")})
        out.append(({k: float(v) for k, v in jm.items()},
                    {k: float(v) for k, v in pm.items()},
                    {**_jax_trees(state), "adam_mu": mu},
                    {**gan_state_to_flax(port.state),
                     "adam_mu": adam_moments_to_flax(port.state)}))
    assert port.state.step == steps
    return jcfg, out


@pytest.fixture(scope="module", params=sorted(PRESETS))
def trajectory(request, data):
    return run_pair(request.param, data)


def assert_params_close(got, want, steps, lr):
    """Elementwise within ATOL, the NOISE_LEAVES within 2 lr a step.
    Returns those leaves' drift |got - want|, by leaf."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    drift = {}
    for k, w in want.items():
        err = np.abs(got[k] - w)
        if k.endswith(NOISE_LEAVES):
            assert err.max() <= 2 * lr * steps, k
            drift[k] = err
        else:
            assert err.max() <= ATOL, (k, err.max())
    return drift


def assert_state_close(pt, jt, steps, lr_g, lr_d):
    """Both nets' parameters, the critic's `u` and the generator's
    BatchNorm statistics; returns the critic's noise-leaf drift."""
    assert_params_close(pt["g"]["params"], jt["g"]["params"], steps, lr_g)
    d_drift = assert_params_close(pt["d"]["params"], jt["d"]["params"],
                                  steps, lr_d)
    g_drift = {k: np.abs(v - _flat(jt["g"]["params"])[k])
               for k, v in _flat(pt["g"]["params"]).items()}
    assert_trees_close(pt["d"]["spectral_stats"], jt["d"]["spectral_stats"],
                       ATOL)
    stats, want = _flat(pt["g"]["batch_stats"]), _flat(jt["g"]["batch_stats"])
    assert stats.keys() == want.keys() and len(want) == 6
    for k, w in want.items():
        bar = ATOL
        if k.endswith("mean"):  # BatchNorm_i/mean follows Linear_i/bias
            bar += g_drift[k.replace("BatchNorm", "Linear").replace(
                "/mean", "/bias")].max()
        assert np.abs(stats[k] - w).max() <= bar, k
    return d_drift


@pytest.mark.parametrize("at", [0, STEPS - 1], ids=["step1", "step3"])
def test_step_matches_jax(trajectory, at):
    """Metrics, parameters, BatchNorm statistics and `u` after one step
    and after three."""
    jcfg, traj = trajectory
    jm, pm, jt, pt = traj[at]
    assert pm.keys() == jm.keys() == {"d_loss", "g_loss", *DIAGNOSTICS}
    drift = assert_state_close(pt, jt, at + 1, jcfg.lr_g, jcfg.lr_d)
    offset = float(np.linalg.norm(drift["sn2/bias"]))
    for name in jm:
        bar = ATOL + (offset if name in CRITIC_READ else 0.0)
        assert abs(pm[name] - jm[name]) <= bar, (name, pm[name], jm[name])
    assert pt["g_ema"] is None and jt["g_ema"] is None


@pytest.mark.parametrize("net", ["g", "d"])
def test_gradients_match_jax(trajectory, net):
    """Adam's first moments after the first step: 0.1 x the gradient."""
    _, traj = trajectory
    _, _, jt, pt = traj[0]
    noise_leaf = lambda k: k.endswith(NOISE_LEAVES)  # noqa: E731
    assert_moments_close(pt["adam_mu"][net], jt["adam_mu"][net],
                         skip=noise_leaf)
    assert_moments_close(pt["adam_mu"][net], jt["adam_mu"][net],
                         atol=NOISE_MU, skip=lambda k: not noise_leaf(k))


def _spectral_iteration(w, u, eps=1e-12):
    v = u @ w
    v = v / (v.norm() + eps)
    u = w @ v
    return u / (u.norm() + eps)


def test_u_advances_once_a_step(data):
    """Each critic layer's `u` is one power iteration from its start on
    the weights before the D update: the D phase advanced it, the G phase
    (train=False) not again."""
    xtr, ytr = data
    port = build_moons_countergan(C.MOONS_COUNTERGAN,
                                  MLPClassifier().state_dict(), device="cpu")
    layers = dict(port.state.d.model.named_children())
    assert list(layers) == ["sn0", "sn1", "sn2", "sn_out"]
    assert [m.weight.shape[0] for m in layers.values()] == [32, 16, 16, 1]
    before = {n: (m.weight.detach().clone(), m.u.clone())
              for n, m in layers.items()}
    port.step_fn(port.state, torch.from_numpy(xtr[:B]),
                 torch.from_numpy(ytr[:B]).long(),
                 torch.Generator().manual_seed(0))
    for name, m in layers.items():
        w, u = before[name]
        assert torch.allclose(m.u, _spectral_iteration(w, u), atol=1e-6,
                              rtol=0), name


def test_step_runs_the_epilogue_once_unclamped(monkeypatch, data):
    """One epilogue forward and one backward a step, at (64, 2) with the
    bounds -1e30 and 1e30 of `clamp_cf=None` (on the card: the 4-byte
    variant)."""
    from cfgan_torch.ops import epilogue as tep

    xtr, ytr = data
    calls = []

    def spy(fn, name):
        def wrapped(*args):
            calls.append((name, tuple(args[0].shape), args[-2], args[-1]))
            return fn(*args)
        return wrapped

    monkeypatch.setattr(tep, "cf_epilogue_fwd",
                        spy(tep.cf_epilogue_fwd_plain, "fwd"))
    monkeypatch.setattr(tep, "cf_epilogue_bwd",
                        spy(tep.cf_epilogue_bwd_plain, "bwd"))
    port = build_moons_countergan(C.MOONS_COUNTERGAN,
                                  MLPClassifier().state_dict(), device="cpu")
    port.step_fn(port.state, torch.from_numpy(xtr[:B]),
                 torch.from_numpy(ytr[:B]).long(),
                 torch.Generator().manual_seed(0))
    assert calls == [("fwd", (B, 2), -1e30, 1e30),
                     ("bwd", (B, 2), -1e30, 1e30)]


def test_draws_and_serving_masks(data):
    """`draw_fn` draws targets and 0/1 feature masks; the serving
    `cf_fn` leaves x where the mask is 0 and does not clamp."""
    port = build_moons_countergan(C.MOONS_COUNTERGAN,
                                  MLPClassifier().state_dict(), device="cpu")
    draws = port.draw_fn(torch.Generator().manual_seed(0), (3, B))
    assert set(draws) == {"targets", "mask"}
    assert draws["targets"].shape == (3, B) and draws["mask"].shape == (3, B, 2)
    assert int(draws["targets"].max()) <= 2
    g_vars = port.state.g.model.state_dict()
    x = torch.from_numpy(data[0][:8]) * 50  # far outside [0, 1]
    t = torch.arange(8) % 3
    for row in ((1.0, 0.0), (0.0, 0.0)):
        mask = torch.tensor(row).expand(8, 2)
        x_cf, raw, masked = port.cf_fn(g_vars, x, t, mask)
        assert torch.equal(x_cf[:, 1], x[:, 1])
        assert torch.equal(x_cf, x + masked)
        assert torch.equal(masked, raw * mask)


EPOCH_STEPS = 4


def test_epoch_matches_jax_epoch_runner(data):
    """An epoch of the shipped preset through the port's runner (eager on
    the CPU) against `make_epoch_runner(reduce=False)`: every step's
    d_loss and the diagnostics not read through the critic, then the
    whole state."""
    xtr, ytr = data
    jcfg, bundle, port = build_pair("shipped")
    perm = np.random.RandomState(1).permutation(len(ytr))[:EPOCH_STEPS * B]
    perm = perm.reshape(EPOCH_STEPS, B)
    key = jax.random.key(3)
    state, traces = jax_epoch_runner(bundle.step_fn, donate=False,
                                     reduce=False)(
        bundle.state, jnp.asarray(xtr), jnp.asarray(ytr), jnp.asarray(perm),
        key)
    draws = {"targets": [], "mask": []}
    for i in range(EPOCH_STEPS):
        k_t, k_m, _ = jax.random.split(jax.random.fold_in(key, i), 3)
        draws["targets"].append(np.asarray(jax.random.randint(k_t, (B,), 0,
                                                              3)))
        draws["mask"].append(np.asarray(jax.random.randint(k_m, (B, 2), 0,
                                                           2)))
    got = make_epoch_runner(port.step_from_draws, reduce=False)(
        port.state, torch.from_numpy(xtr), torch.from_numpy(ytr).long(),
        torch.from_numpy(perm),
        {k: torch.from_numpy(np.stack(v)) for k, v in draws.items()})
    for name in ("d_loss", *DIAGNOSTICS):
        if name not in CRITIC_READ:
            np.testing.assert_allclose(got[name], np.asarray(traces[name]),
                                       rtol=0, atol=ATOL, err_msg=name)
    assert_state_close(gan_state_to_flax(port.state), _jax_trees(state),
                       EPOCH_STEPS, jcfg.lr_g, jcfg.lr_d)
    assert port.state.step == EPOCH_STEPS


def assert_equal_trees(got, want):
    """The same leaves (None where the other has None), bit for bit."""
    got, want = _flat(got), _flat(_np(want))
    assert got.keys() == want.keys()
    for k, w in want.items():
        if w is None or got[k] is None:
            assert w is None and got[k] is None, k
        else:
            assert np.array_equal(np.asarray(got[k]), w), k


@pytest.fixture(scope="module")
def committed():
    """The committed run dir's classifier (as flax variables) and a JAX
    bundle of the shipped preset on it."""
    template = JaxMLP().init(jax.random.key(0), jnp.zeros((2, 2)))
    clf_vars = _np(jck.restore(str(RUN_DIR / "classifier"), dict(template)))
    bundle = jax_build(jax_presets.MOONS_COUNTERGAN.countergan, JaxMLP(),
                       JaxNetState.create(clf_vars, jax_adam(1e-2)))
    return clf_vars, bundle


def test_committed_train_state_resumes_in_the_port(committed, data):
    """The port restores the JAX run's end-of-training state (epoch 500,
    Adam's count and moments included, `u`, BatchNorm statistics) and
    two more steps from it match the JAX package's on the same draws."""
    clf_vars, bundle = committed
    state, epoch, hist = jck.restore_train_state(
        str(RUN_DIR / "train_state"), bundle.state)
    port = build_moons_countergan(
        C.MOONS_COUNTERGAN,
        state_dict_from_flax(MLPClassifier(), clf_vars), device="cpu")
    got_epoch, got_hist = ck.restore_train_state(str(RUN_DIR / "train_state"),
                                                 port.state)
    assert got_epoch == epoch == 500 and got_hist == hist
    assert port.state.step == int(state.step) == 7500
    tree = train_state_to_flax(port.state)
    assert int(tree["d"]["opt_state"]["0"]["count"]) == 7500
    assert_equal_trees(tree, serialization.to_state_dict(state))
    xtr, ytr = data
    step, key = jax.jit(bundle.step_fn), jax.random.key(11)
    for i in range(2):
        x, y = xtr[i * B:(i + 1) * B], ytr[i * B:(i + 1) * B]
        t, mask = jax_step_draws(key, int(state.step), y)
        state, jm = step(state, jnp.asarray(x), jnp.asarray(y), key)
        pm = port.step_with_draws(
            port.state, torch.from_numpy(x), torch.from_numpy(y).long(),
            torch.from_numpy(t).long(), torch.from_numpy(mask))
    cfg = C.MOONS_COUNTERGAN
    drift = assert_state_close(gan_state_to_flax(port.state),
                               _jax_trees(state), 2, cfg.lr_g, cfg.lr_d)
    offset = float(np.linalg.norm(drift["sn2/bias"]))
    for name in jm:
        bar = ATOL + (offset if name in CRITIC_READ else 0.0)
        assert abs(float(pm[name]) - float(jm[name])) <= bar, name


def test_port_train_state_restores_in_jax(committed, data, tmp_path):
    """The port's train state after an epoch from the committed one,
    saved by the port, restores in the JAX package bit for bit."""
    clf_vars, bundle = committed
    port = build_moons_countergan(
        C.MOONS_COUNTERGAN,
        state_dict_from_flax(MLPClassifier(), clf_vars), device="cpu")
    ck.restore_train_state(str(RUN_DIR / "train_state"), port.state)
    xtr, ytr = data
    gen = torch.Generator().manual_seed(0)
    perm = torch.randperm(len(ytr), generator=gen)[:15 * B].reshape(15, B)
    port.epoch_fn(port.state, torch.from_numpy(xtr),
                  torch.from_numpy(ytr).long(), perm,
                  port.draw_fn(gen, (15, B)))
    ck.save_train_state(str(tmp_path / "ts"), port.state, epoch=500,
                        history={"d_loss": [0.0]})
    state, epoch, hist = jck.restore_train_state(str(tmp_path / "ts"),
                                                 bundle.state)
    assert epoch == 501 and hist == {"d_loss": [0.0]}
    assert int(state.step) == 7515
    assert_equal_trees(train_state_to_flax(port.state),
                       serialization.to_state_dict(state))
