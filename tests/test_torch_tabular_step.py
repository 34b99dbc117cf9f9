"""The port's King County house CounteRGAN train step
(`cfgan_torch.train.builders.build_tabular_countergan`) against the JAX
package's `build_tabular_countergan(explicit_gumbel=True)`, on the CPU,
from the same initial state (carried across by cfgan_torch.convert) and
the same draws: the targets, feature masks and Gumbel noise are
re-derived from the JAX step's key (`k_t, k_m, k_g = split(fold_in(key,
step), 3)`; the noise is `derive_gumbel_noise(k_g, ...)`) and handed to
the port's `step_with_draws`.

Width 8, two FiLM blocks, batch 16, the real 17-feature schema with the
synthetic table's stats, float32, both house presets: the shipped one
(clamp [0, 1], lambda_range 10, EMA) and the reference one (no clamp).

Some parameter elements have a gradient that is exactly zero in exact
arithmetic: the biases of the Linear layers a BatchNorm follows, and the
critic's last hidden biases of units active on every row (the
Wasserstein loss cancels them).  Their computed gradients are float32
rounding noise (~1e-9) in either package, and Adam, which divides by the
gradient's own scale, turns that noise into moves of up to lr a step, in
each package its own.  So:

- Adam's first moments (the gradients: lr alone moves each parameter by
  about lr whatever the gradient) agree leaf by leaf within 5e-5 of their
  2-norm plus 1e-8 (`tests/test_torch_step.py::assert_moments_close`),
  plus 1e-7 in the three bias leaves below, whose noise moments are of
  that size;
- every parameter and EMA element, the critic's `u` and the BatchNorm
  variances agree within 3e-5 after one step and after five, but those
  biases (a critic unit's bias moves on noise on the steps where the
  unit is active on every row, and on its gradient on the others):
  those within 2 lr a step; a BatchNorm running mean within 3e-5 plus
  the drift of the bias before it (the mean carries it);
- every loss and diagnostic agrees within 3e-5, but the four read
  through the critic's score (g_adv, g_loss, d_real_p, d_fake_p), which
  the noise-moved last hidden biases shift by the same amount on every
  row (d_loss cancels it): by at most the 2-norm of their drift, since
  the output layer's weight divided by its spectral norm is a unit
  vector.  Those four are held within 3e-5 plus that 2-norm.

Also: one epilogue forward and one backward a step; the G phase leaves
the critic's `u` where the D phase's power iteration put it; and the
epoch runner (eager on the CPU) equals the JAX `make_epoch_runner` over
an epoch.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgan.data.kc_house import KC_SCHEMA as JAX_SCHEMA
from cfgan.data.transforms import NormStats as JaxNormStats
from cfgan.experiments import presets as jax_presets
from cfgan.masks.feature import random_feature_mask as jax_feature_mask
from cfgan.models.classifiers import TabularClassifier as JaxClassifier
from cfgan.models.tabular import derive_gumbel_noise as jax_noise
from cfgan.train.builders import build_tabular_countergan as jax_build
from cfgan.train.countergan import make_epoch_runner as jax_epoch_runner
from cfgan.train.countergan import sample_targets as jax_sample_targets
from cfgan.train.state import NetState as JaxNetState
from cfgan.train.state import adam_like_torch as jax_adam
from cfgan_torch.convert import (
    adam_moments_to_flax,
    gan_state_to_flax,
    load_gan_state,
    state_dict_from_flax,
)
from cfgan_torch.core import config as C
from cfgan_torch.data.kc_house import KC_SCHEMA, load_kc_house
from cfgan_torch.models.classifiers import TabularClassifier
from cfgan_torch.train.builders import build_tabular_countergan
from cfgan_torch.train.loop import make_epoch_runner

from test_torch_step import assert_moments_close, assert_trees_close, leaves

B, STEPS, ATOL = 16, 5, 3e-5
# leaves that hold elements whose exact gradient is zero: the biases a
# BatchNorm follows, and the critic's last hidden biases
NOISE_LEAVES = ("fc1/bias", "fc2/bias", "sn2/bias")
NOISE_MU = 1e-7  # |Adam first moment| of noise: measured up to 2e-8
CRITIC_READ = ("g_adv", "g_loss", "d_real_p", "d_fake_p")
WIDTH = dict(hidden_dim=8, num_res_blocks=2)
PRESETS = {"shipped": (jax_presets.HOUSE_COUNTERGAN.countergan,
                       C.HOUSE_COUNTERGAN),
           "reference": (jax_presets.HOUSE_COUNTERGAN_REFERENCE.countergan,
                         C.HOUSE_COUNTERGAN_REFERENCE)}
DIAGNOSTICS = ("g_adv", "g_cls", "reg_l1", "reg_l2", "mask_penalty",
               "d_real_p", "d_fake_p", "residual_mean", "flip_rate",
               "pred_gain")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU run shares its cores with other test workers: one torch
    thread keeps this file's many small eager ops from oversubscribing
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    (xtr, ytr), _, stats, _, _ = load_kc_house()
    return xtr, ytr, stats


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_trees(state):
    return _np({"g": state.g.variables(), "d": state.d.variables(),
                "g_ema": state.g_ema})


def build_pair(preset: str, stats, **overrides):
    """(JAX bundle, port bundle) of a house preset at the test width, the
    port loaded with the JAX initial state; a random frozen classifier."""
    jcfg, pcfg = PRESETS[preset]
    jcfg = replace(jcfg, **WIDTH, **overrides)
    pcfg = replace(pcfg, **WIDTH, **overrides)
    clf_model = JaxClassifier(num_classes=4)
    clf_vars = _np(dict(clf_model.init(jax.random.key(1),
                                       jnp.zeros((2, 17)), train=False)))
    bundle = jax_build(jcfg, clf_model,
                       JaxNetState.create(clf_vars, jax_adam(1e-3)),
                       JAX_SCHEMA, JaxNormStats(*stats), num_classes=4,
                       seed=7, explicit_gumbel=True)
    port = build_tabular_countergan(
        pcfg, state_dict_from_flax(TabularClassifier(), clf_vars),
        KC_SCHEMA, stats, device="cpu")
    load_gan_state(port.state, _jax_trees(bundle.state))
    return jcfg, bundle, port


def jax_step_draws(key, step, y):
    """The JAX step's targets (resampled to differ from y), feature mask
    and Gumbel noise at `step`, as numpy arrays."""
    k_t, k_m, k_g = jax.random.split(jax.random.fold_in(key, step), 3)
    t = jax_sample_targets(k_t, jnp.asarray(y), 4, True)
    mask = jax_feature_mask(k_m, len(y), 17, JAX_SCHEMA.immutable_idx)
    noise = jax_noise(k_g, len(y), JAX_SCHEMA.categorical_info)
    return (np.asarray(t), np.asarray(mask),
            {i: np.asarray(v) for i, v in noise.items()})


def run_pair(preset, data, steps=STEPS):
    """`steps` steps of both packages on the same batches and draws; per
    step (jax metrics, port metrics, jax trees, port trees)."""
    xtr, ytr, stats = data
    jcfg, bundle, port = build_pair(preset, stats)
    step = jax.jit(bundle.step_fn)
    key = jax.random.key(3)
    state, out = bundle.state, []
    for i in range(steps):
        x, y = xtr[i * B:(i + 1) * B], ytr[i * B:(i + 1) * B]
        t, mask, noise = jax_step_draws(key, i, y)
        state, jm = step(state, jnp.asarray(x), jnp.asarray(y), key)
        pm = port.step_with_draws(
            port.state, torch.from_numpy(x), torch.from_numpy(y).long(),
            torch.from_numpy(t).long(), torch.from_numpy(mask),
            {k: torch.from_numpy(v) for k, v in noise.items()})
        mu = _np({net: getattr(state, net).opt_state[0].mu
                  for net in ("g", "d")})
        out.append(({k: float(v) for k, v in jm.items()},
                    {k: float(v) for k, v in pm.items()},
                    {**_jax_trees(state), "adam_mu": mu},
                    {**gan_state_to_flax(port.state),
                     "adam_mu": adam_moments_to_flax(port.state)}))
    assert port.state.step == steps
    return out


@pytest.fixture(scope="module", params=sorted(PRESETS))
def trajectory(request, data):
    return request.param, run_pair(request.param, data)


def _flat(tree):
    return dict(leaves(tree)) if tree is not None else {}


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


@pytest.mark.parametrize("at", [0, STEPS - 1], ids=["step1", "step5"])
def test_losses_and_diagnostics_match_jax(trajectory, at):
    preset, traj = trajectory
    jm, pm, jt, pt = traj[at]
    assert pm.keys() == jm.keys() == {"d_loss", "g_loss", *DIAGNOSTICS}
    drift = assert_params_close(pt["d"]["params"], jt["d"]["params"],
                                at + 1, PRESETS[preset][1].lr_d)
    offset = float(np.linalg.norm(drift["sn2/bias"]))
    for name in jm:
        bar = ATOL + (offset if name in CRITIC_READ else 0.0)
        assert abs(pm[name] - jm[name]) <= bar, (name, offset)


@pytest.mark.parametrize("at", [0, STEPS - 1], ids=["step1", "step5"])
def test_state_matches_jax(trajectory, at):
    """Parameters of both nets and, in the shipped preset, the EMA; the
    critic's spectral-norm `u`; the generator's BatchNorm statistics."""
    preset, traj = trajectory
    _, _, jt, pt = traj[at]
    lr = PRESETS[preset][1].lr_g
    drift = {}
    for net in ("g", "d"):
        drift[net] = assert_params_close(pt[net]["params"],
                                         jt[net]["params"], at + 1, lr)
    assert_trees_close(pt["d"]["spectral_stats"], jt["d"]["spectral_stats"],
                       ATOL)
    stats, want = _flat(pt["g"]["batch_stats"]), _flat(jt["g"]["batch_stats"])
    for k, w in want.items():
        bar = ATOL
        if k.endswith("mean"):  # block{i}/bn{j}/mean follows block{i}/fc{j}
            bar += drift["g"][k.replace("/bn", "/fc").replace(
                "/mean", "/bias")].max()
        assert np.abs(stats[k] - w).max() <= bar, k
    assert (pt["g_ema"] is None) == (jt["g_ema"] is None) == (
        preset == "reference")
    if preset == "shipped":
        assert_params_close(pt["g_ema"], jt["g_ema"], at + 1, lr)


@pytest.mark.parametrize("at", [0, STEPS - 1], ids=["step1", "step5"])
@pytest.mark.parametrize("net", ["g", "d"])
def test_gradients_match_jax(trajectory, at, net):
    """Adam's first moments, 0.1 x the gradient after the first step."""
    _, traj = trajectory
    _, _, jt, pt = traj[at]
    noise_leaf = lambda k: k.endswith(NOISE_LEAVES)  # noqa: E731
    assert_moments_close(pt["adam_mu"][net], jt["adam_mu"][net],
                         skip=noise_leaf)
    assert_moments_close(pt["adam_mu"][net], jt["adam_mu"][net],
                         atol=NOISE_MU, skip=lambda k: not noise_leaf(k))


def test_ema_moves_visibly_within_the_bar(data):
    """EMA decay 0.9 (the preset's 0.999 moves the EMA by ~1e-6 a step,
    under the bar): the EMA after two steps still matches."""
    xtr, ytr, stats = data
    jcfg, bundle, port = build_pair("shipped", stats, ema_decay=0.9)
    state, key = bundle.state, jax.random.key(5)
    for i in range(2):
        x, y = xtr[i * B:(i + 1) * B], ytr[i * B:(i + 1) * B]
        t, mask, noise = jax_step_draws(key, i, y)
        state, _ = bundle.step_fn(state, jnp.asarray(x), jnp.asarray(y), key)
        port.step_with_draws(
            port.state, torch.from_numpy(x), torch.from_numpy(y).long(),
            torch.from_numpy(t).long(), torch.from_numpy(mask),
            {k: torch.from_numpy(v) for k, v in noise.items()})
    pt = gan_state_to_flax(port.state)
    jt = _jax_trees(state)
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree_util.tree_leaves(jt["g_ema"]),
        jax.tree_util.tree_leaves(jt["g"]["params"])))
    assert moved > 10 * ATOL
    assert_params_close(pt["g_ema"], jt["g_ema"], 2, jcfg.lr_g)


def _spectral_iteration(w, u, eps=1e-12):
    """One plain power iteration on a torch (out, in) weight."""
    v = u @ w
    v = v / (v.norm() + eps)
    u = w @ v
    return u / (u.norm() + eps)


def test_g_phase_leaves_u_where_the_d_phase_put_it(data):
    """After a step each critic layer's `u` is one power iteration from
    its start on the weights before the D update: the D phase advanced it
    once and the G phase (train=False) not again."""
    xtr, ytr, stats = data
    _, pcfg = PRESETS["shipped"]
    port = build_tabular_countergan(replace(pcfg, **WIDTH),
                                    TabularClassifier().state_dict(),
                                    KC_SCHEMA, stats, device="cpu")
    layers = {n: m for n, m in port.state.d.model.named_children()}
    before = {n: (m.weight.detach().clone(), m.u.clone())
              for n, m in layers.items()}
    port.step_fn(port.state, torch.from_numpy(xtr[:B]),
                 torch.from_numpy(ytr[:B]).long(),
                 torch.Generator().manual_seed(0))
    for name, m in layers.items():
        w, u = before[name]
        want = _spectral_iteration(w, u)
        assert torch.allclose(m.u, want, atol=1e-6, rtol=0), name
        if len(want) > 1:  # a 1-wide u is +-1 whatever the iterations
            assert not torch.allclose(
                _spectral_iteration(m.weight.detach(), want), want,
                atol=1e-6, rtol=0), f"{name}: a second iteration would not show"


def _counting(fn, calls, key):
    def spy(*args):
        calls[key] += 1
        return fn(*args)

    return spy


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_step_runs_the_epilogue_forward_and_backward_once(monkeypatch, data,
                                                          preset):
    """One epilogue forward and one backward a step (on the card, one
    launch of each kernel, at (B, 17): the 4-byte variant)."""
    from cfgan_torch.ops import epilogue as tep

    xtr, ytr, stats = data
    calls = {"fwd": 0, "bwd": 0}
    monkeypatch.setattr(tep, "cf_epilogue_fwd", _counting(
        tep.cf_epilogue_fwd_plain, calls, "fwd"))
    monkeypatch.setattr(tep, "cf_epilogue_bwd", _counting(
        tep.cf_epilogue_bwd_plain, calls, "bwd"))
    _, pcfg = PRESETS[preset]
    port = build_tabular_countergan(replace(pcfg, **WIDTH),
                                    TabularClassifier().state_dict(),
                                    KC_SCHEMA, stats, device="cpu")
    draws = torch.Generator().manual_seed(0)
    for i in range(2):
        port.step_fn(port.state, torch.from_numpy(xtr[:B]),
                     torch.from_numpy(ytr[:B]).long(), draws)
        assert calls == {"fwd": i + 1, "bwd": i + 1}


def test_draws_hold_the_generator_noise(data):
    """`draw_fn` draws the epoch's Gumbel noise with the targets and the
    masks: (steps, B, 70) for the 70 categories of the seven heads."""
    _, _, stats = data
    _, pcfg = PRESETS["shipped"]
    port = build_tabular_countergan(replace(pcfg, **WIDTH),
                                    TabularClassifier().state_dict(),
                                    KC_SCHEMA, stats, device="cpu")
    draws = port.draw_fn(torch.Generator().manual_seed(0), (3, B))
    assert draws["gumbel"].shape == (3, B, 70)
    assert draws["mask"].shape == (3, B, 17)
    assert draws["targets"].shape == (3, B)
    assert bool(torch.isfinite(draws["gumbel"]).all())


EPOCH_STEPS, N = 4, 96


def _jax_epoch_draws(key, y_batches):
    out = {"targets": [], "mask": [], "gumbel": []}
    for i, y in enumerate(y_batches):
        k_t, k_m, k_g = jax.random.split(jax.random.fold_in(key, i), 3)
        out["targets"].append(np.asarray(jax.random.randint(k_t, (B,), 0, 4)))
        out["mask"].append(np.asarray(jax.random.randint(k_m, (B, 17), 0, 2)))
        noise = jax_noise(k_g, B, JAX_SCHEMA.categorical_info)
        out["gumbel"].append(np.concatenate(
            [np.asarray(noise[i]) for i in sorted(noise)], 1))
    return {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}


def test_epoch_matches_jax_epoch_runner(data):
    """An epoch of the shipped preset through the port's runner (eager on
    the CPU) against `make_epoch_runner(reduce=False)`: every step's
    d_loss and generator-side diagnostics, then the whole state."""
    xtr, ytr, stats = data
    _, bundle, port = build_pair("shipped", stats)
    x, y = xtr[:N], ytr[:N]
    perm = np.random.RandomState(1).permutation(N)[:EPOCH_STEPS * B]
    perm = perm.reshape(EPOCH_STEPS, B)
    key = jax.random.key(3)
    state, traces = jax_epoch_runner(bundle.step_fn, donate=False,
                                     reduce=False)(
        bundle.state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(perm), key)
    got = make_epoch_runner(port.step_from_draws, reduce=False)(
        port.state, torch.from_numpy(x), torch.from_numpy(y).long(),
        torch.from_numpy(perm), _jax_epoch_draws(key, y[perm]))
    for name in ("d_loss", *DIAGNOSTICS):
        if name not in CRITIC_READ:  # those are held step by step above
            np.testing.assert_allclose(got[name], np.asarray(traces[name]),
                                       rtol=0, atol=ATOL, err_msg=name)
    jt, pt = _jax_trees(state), gan_state_to_flax(port.state)
    for net in ("g", "d"):
        assert_params_close(pt[net]["params"], jt[net]["params"],
                            EPOCH_STEPS, 1e-3)
    assert_trees_close(pt["d"]["spectral_stats"], jt["d"]["spectral_stats"],
                       ATOL)
    assert_params_close(pt["g_ema"], jt["g_ema"], EPOCH_STEPS, 1e-3)
    assert port.state.step == EPOCH_STEPS
