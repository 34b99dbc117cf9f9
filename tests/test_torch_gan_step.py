"""The port's plain-generation train step (`cfgan_torch.train.gan_builders.
build_gan`) against the JAX package's, on the CPU, for each of the five
families at small widths (MLP hidden 8, WGAN-GP sizes 16, DCGAN hidden 8
at 64x64, latent 8, batch 8), with the presets' optimizers and schedules.

Both packages start from one state (JAX's initial weights carried over by
`cfgan_torch.convert`); the step's draws are re-derived from the JAX
step's own keys, `k_z, k_c, k_gp, k_z2 = split(fold_in(key, step), 4)`,
and handed to the port.  Checked after each step: the four metrics, both
networks' parameters, the BatchNorm statistics, and the gradients
through the optimizers' first moments after the first step.

Bars (float32; TF32 does not apply on the CPU): 3e-5 on metrics,
parameters and statistics; the JAX package's own oracle bars where they
are the looser (DCGAN: d_loss and g_loss 1e-4; WGAN-GP: d_loss 3e-4,
g_loss 5e-5, parameters 5e-5, `tests/test_step_parity_dcgan.py`,
`tests/test_step_parity_wgan.py`).  Leaves whose gradient is zero in
exact arithmetic get float32 noise for a gradient, which Adam turns into
moves of up to lr a step in each package its own way (ROADMAP Queue C):
the biases a BatchNorm or InstanceNorm follows, and the WGAN-GP critic's
output bias (the Wasserstein loss cancels it; the penalty does not see
it).  Those are held within 2 lr a step.  First moments: within 5e-5 of
their 2-norm (1e-4 under the penalty's double backward).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgan.experiments import presets as jax_presets
from cfgan.losses.gan import gradient_penalty as jax_gp
from cfgan.models.discriminators import WGANCritic as JaxCritic
from cfgan.train.countergan import make_epoch_runner as jax_epoch_runner
from cfgan.train.gan_builders import build_gan as jax_build
from cfgan_torch.convert import (
    adam_moments_to_flax,
    flax_from_state_dict,
    gan_state_to_flax,
    load_gan_state,
    state_dict_from_flax,
)
from cfgan_torch.experiments import presets
from cfgan_torch.losses.gan import gradient_penalty
from cfgan_torch.models.discriminators import WGANCritic
from cfgan_torch.train.loop import make_epoch_runner
from cfgan_torch.train.gan_builders import build_gan

from test_torch_step import assert_moments_close, leaves

B, LD = 8, 8
ATOL = 3e-5
# family -> (preset, width overrides, classes, sample shape, steps)
FAMILIES = {
    "simple_mlp": ("SIMPLE_GAN_MOONS", {"hidden_dim": 8}, 2, (2,), 2),
    "mlp_image": ("SIMPLE_GAN_MNIST", {}, 10, (28, 28, 1), 2),
    "cgan_mlp": ("CGAN_MOONS", {"hidden_dim": 8}, 2, (2,), 2),
    "dcgan": ("DCGAN_MNIST", {"hidden_dim": 8}, 10, (64, 64, 1), 2),
    "wgan_gp": ("WGAN_GP_MNIST", {"hidden_dim": 16}, 10, (28, 28, 1), 6),
}
# the JAX oracle tests' bars where looser than ATOL
METRIC_BARS = {"dcgan": {"d_loss": 1e-4, "g_loss": 1e-4},
               "wgan_gp": {"d_loss": 3e-4, "g_loss": 5e-5}}
PARAM_BARS = {"wgan_gp": 5e-5}
MU_RTOL = {"wgan_gp": 1e-4}
# leaves whose gradient is zero in exact arithmetic, by family and net
NOISE_LEAVES = {
    ("mlp_image", "g"): ("Linear_1/bias", "Linear_2/bias", "Linear_3/bias"),
    ("wgan_gp", "g"): ("tconv0/ConvTranspose_0/bias",
                       "tconv1/ConvTranspose_0/bias",
                       "tconv2/ConvTranspose_0/bias"),
    ("wgan_gp", "d"): ("conv0/Conv_0/bias", "conv1/Conv_0/bias",
                       "conv2/Conv_0/bias", "fc_out/bias"),
}
KEY = 11


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def configs(family, **extra):
    """(JAX GANConfig, port GANConfig) of the family's preset at test
    width, with `extra` fields set in both."""
    name, widths, _, _, _ = FAMILIES[family]
    over = {"latent_dim": LD, **widths, **extra}
    return (replace(getattr(jax_presets, name).gan, **over),
            replace(getattr(presets, name).gan, **over))


def build_pair(family, seed=3, **extra):
    """(JAX bundle, port bundle) from one initial state."""
    jcfg, pcfg = configs(family, **extra)
    nc = FAMILIES[family][2]
    jb = jax_build(jcfg, num_classes=nc, seed=seed)
    pb = build_gan(pcfg, num_classes=nc, seed=seed, device="cpu")
    load_gan_state(pb.state, {"g": _np(jb.state.g.variables()),
                              "d": _np(jb.state.d.variables()),
                              "g_ema": None})
    return jb, pb


def batches(family, n, seed=0):
    shape, nc = FAMILIES[family][3], FAMILIES[family][2]
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, B, *shape)).astype(np.float32)
    return x, rng.randint(0, nc, (n, B)).astype(np.int32)


def jax_draws(family, key, step, x_ndim):
    """The JAX step's z, t, gp_eps and z2 at global step `step`."""
    n_cond = FAMILIES[family][2] if family in ("cgan_mlp", "wgan_gp") else 0
    k_z, k_c, k_gp, k_z2 = jax.random.split(jax.random.fold_in(key, step), 4)
    return {"z": np.asarray(jax.random.normal(k_z, (B, LD))),
            "t": np.asarray(jax.random.randint(k_c, (B,), 0,
                                               max(n_cond, 1))),
            "gp_eps": np.asarray(jax.random.uniform(
                k_gp, (B,) + (1,) * (x_ndim - 1))),
            "z2": np.asarray(jax.random.normal(k_z2, (B, LD)))}


def _torch_draws(d):
    out = {k: torch.tensor(v) for k, v in d.items()}
    out["t"] = out["t"].long()
    return out


def _state_trees(jstate, pstate):
    jt = _np({"g": jstate.g.variables(), "d": jstate.d.variables()})
    pt = gan_state_to_flax(pstate)
    return jt, {"g": pt["g"], "d": pt["d"]}


def _jax_mu(jstate):
    return _np({net: getattr(jstate, net).opt_state[0].mu
                for net in ("g", "d")})


def run_pair(family, steps=None, **extra):
    """Both packages' trajectories of FAMILIES[family]'s steps (or
    `steps`) on the same batches and draws."""
    jb, pb = build_pair(family, **extra)
    steps = steps or FAMILIES[family][4]
    xs, ys = batches(family, steps)
    key = jax.random.key(KEY)
    step = jax.jit(jb.step_fn)
    jstate, out = jb.state, []
    for i in range(steps):
        d = jax_draws(family, key, i, xs.ndim - 1)
        jstate, jm = step(jstate, jnp.asarray(xs[i]), jnp.asarray(ys[i]), key)
        td = _torch_draws(d)
        pm = pb.step_with_draws(pb.state, torch.from_numpy(xs[i]),
                                torch.from_numpy(ys[i]).long(), td["z"],
                                td["t"], td["gp_eps"], td["z2"])
        jt, pt = _state_trees(jstate, pb.state)
        out.append({"jm": {k: float(v) for k, v in jm.items()},
                    "pm": {k: float(v) for k, v in pm.items()},
                    "jt": jt, "pt": pt, "jmu": _jax_mu(jstate),
                    "pmu": adam_moments_to_flax(pb.state),
                    "g_count": int(jstate.g.opt_state[0].count),
                    "d_count": int(jstate.d.opt_state[0].count)})
    return jb, pb, out


@pytest.fixture(scope="module")
def runs():
    """Each family's run_pair, made once for the module."""
    cache = {}

    def get(family):
        if family not in cache:
            cache[family] = run_pair(family)
        return cache[family]

    return get


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def trajectory(request, runs):
    return request.param, runs(request.param)


def assert_params_close(family, net, got, want, steps, lr):
    bar = PARAM_BARS.get(family, ATOL)
    noise = NOISE_LEAVES.get((family, net), ())
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        assert err <= (2 * lr * steps if k in noise else bar), (k, err)


def test_step_metrics_match_jax(trajectory):
    family, (_, _, traj) = trajectory
    bars = METRIC_BARS.get(family, {})
    for i, row in enumerate(traj):
        assert row["pm"].keys() == row["jm"].keys() == {
            "d_loss", "g_loss", "d_real", "d_fake"}
        for k, v in row["jm"].items():
            assert abs(row["pm"][k] - v) <= bars.get(k, ATOL), (i, k,
                                                                 row["pm"][k],
                                                                 v)


def test_step_parameters_and_stats_match_jax(trajectory):
    family, (_, pb, traj) = trajectory
    cfg = pb.cfg
    for i, row in enumerate(traj):
        for net, lr in (("g", cfg.lr_g), ("d", cfg.lr_d)):
            assert_params_close(family, net, row["pt"][net]["params"],
                                row["jt"][net]["params"], i + 1, lr)
            got = dict(leaves(row["pt"][net].get("batch_stats", {})))
            want = dict(leaves(row["jt"][net].get("batch_stats", {})))
            assert got.keys() == want.keys()
            for k, w in want.items():
                # a running mean follows the bias before its BatchNorm
                bar = ATOL + (2 * cfg.lr_g * (i + 1) if family == "wgan_gp"
                              and net == "g" and k.endswith("mean") else 0.0)
                assert np.abs(got[k] - w).max() <= bar, (i, net, k)
    want_nets = {"simple_mlp": (0, 0), "cgan_mlp": (0, 0), "mlp_image": (3, 0),
                 "dcgan": (4, 3), "wgan_gp": (3, 0)}[family]
    got_nets = tuple(len(row["pt"][n].get("batch_stats", {}))
                     for n in ("g", "d"))
    assert got_nets == want_nets


@pytest.mark.parametrize("net", ["g", "d"])
def test_gradients_match_jax(trajectory, net):
    """The optimizers' first moments after the first step: (1 - beta1)
    times the gradient."""
    family, (_, _, traj) = trajectory
    noise = NOISE_LEAVES.get((family, net), ())
    row = traj[0]
    assert_moments_close(row["pmu"][net], row["jmu"][net],
                         rtol=MU_RTOL.get(family, 5e-5),
                         skip=lambda k: k in noise)


@pytest.fixture(scope="module")
def wgan(runs):
    return runs("wgan_gp")


def test_wgan_generator_updates_on_every_fifth_step(wgan):
    """n_critic = 5: G's parameters and its AdamW count move on the steps
    whose global index is a multiple of 5 (0 and 5 of six), the critic's
    on every step; G's BatchNorm statistics advance twice on those steps
    and once on the others, as JAX's do; g_loss is 0 on the others."""
    _, pb, traj = wgan
    assert pb.schedule is not None and pb.cfg.n_critic == 5
    g_params = [dict(leaves(row["pt"]["g"]["params"])) for row in traj]
    for i, row in enumerate(traj):
        g_turn = i % 5 == 0
        assert row["g_count"] == 1 + (i >= 5) and row["d_count"] == i + 1
        assert (row["pm"]["g_loss"] != 0.0) == g_turn, i
        if i:
            moved = any(not np.array_equal(g_params[i][k], g_params[i - 1][k])
                        for k in g_params[i])
            assert moved == g_turn, i
    opt = pb.state.g.opt
    assert {int(opt.state[p]["step"]) for p in pb.g_model.parameters()} == {2}
    assert {int(pb.state.d.opt.state[p]["step"])
            for p in pb.d_model.parameters()} == {6}


def test_wgan_batchnorm_advances_twice_on_generator_steps():
    """Two train-mode generator forwards on a G step (the critic's fakes
    and the G phase's own), one on a critic-only step: each G BatchNorm
    updates its running statistics once a forward (their values are held
    against JAX's above)."""
    _, pb = build_pair("wgan_gp")
    xs, ys = batches("wgan_gp", 6, seed=5)
    calls = []
    for name in ("bn_tconv0", "bn_tconv1", "bn_tconv2"):
        getattr(pb.g_model, name).register_forward_hook(
            lambda m, args, out, name=name: calls.append(name))
    per_step = []
    draws = pb.draw_fn(torch.Generator().manual_seed(0), (6, B))
    for i in range(6):
        before = len(calls)
        pb.step_from_draws(pb.state, torch.from_numpy(xs[i]),
                           torch.from_numpy(ys[i]).long(),
                           {k: v[i] for k, v in draws.items()})
        per_step.append((len(calls) - before) // 3)
    assert per_step == [2, 1, 1, 1, 1, 2]


def test_gradient_penalty_matches_jax():
    """The penalty alone and its gradient with respect to the critic's
    parameters, on JAX's interpolation draws."""
    rng = np.random.RandomState(7)
    real = rng.uniform(-1, 1, (B, 28, 28, 1)).astype(np.float32)
    fake = rng.uniform(-1, 1, (B, 28, 28, 1)).astype(np.float32)
    cond = np.eye(10, dtype=np.float32)[rng.randint(0, 10, B)]
    jmod = JaxCritic(critic_size=16, hidden_size=16, num_classes=10)
    variables = _np(dict(jax.jit(jmod.init)(
        jax.random.key(0), jnp.asarray(real), jnp.asarray(cond))))
    key = jax.random.key(4)

    def jax_value(params):
        return jax_gp(lambda x, c: jmod.apply({"params": params}, x, c), key,
                      jnp.asarray(real), jnp.asarray(fake),
                      jnp.asarray(cond))

    want, want_grads = jax.jit(jax.value_and_grad(jax_value))(
        variables["params"])
    eps = np.asarray(jax.random.uniform(key, (B, 1, 1, 1)))
    critic = WGANCritic(16, 16, 10)
    critic.load_state_dict(state_dict_from_flax(critic, variables))
    got = gradient_penalty(critic, torch.from_numpy(real),
                           torch.from_numpy(fake), torch.tensor(eps),
                           torch.from_numpy(cond))
    got.backward()
    assert abs(got.item() - float(want)) <= ATOL * max(1.0, float(want))
    # the output bias does not reach the penalty: no gradient, JAX's zeros
    grads = flax_from_state_dict(critic, {
        n: torch.zeros_like(p) if p.grad is None else p.grad
        for n, p in critic.named_parameters()})
    noise = NOISE_LEAVES["wgan_gp", "d"]  # biases an InstanceNorm follows
    assert_moments_close(grads["params"], _np(want_grads), rtol=1e-4,
                         skip=lambda k: k in noise)
    assert_moments_close(grads["params"], _np(want_grads), atol=1e-5,
                         skip=lambda k: k not in noise)


EPOCH_STEPS = 6


def _epoch_inputs(family, seed=2):
    shape, nc = FAMILIES[family][3], FAMILIES[family][2]
    rng = np.random.RandomState(seed)
    n = EPOCH_STEPS * B + 5
    x = rng.uniform(-1, 1, (n, *shape)).astype(np.float32)
    y = rng.randint(0, nc, n).astype(np.int32)
    perm = rng.permutation(n)[:EPOCH_STEPS * B].reshape(EPOCH_STEPS, B)
    return x, y, perm


def test_epoch_matches_jax_epoch_runner():
    """An epoch of the conditional moons family through the port's runner
    (eager on the CPU) against `make_epoch_runner(reduce=False)`: every
    step's metrics, then both networks' parameters."""
    jb, pb = build_pair("cgan_mlp")
    x, y, perm = _epoch_inputs("cgan_mlp")
    key = jax.random.key(KEY)
    jstate, traces = jax_epoch_runner(jb.step_fn, donate=False, reduce=False)(
        jb.state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(perm), key)
    draws = [jax_draws("cgan_mlp", key, i, 2) for i in range(EPOCH_STEPS)]
    got = make_epoch_runner(pb.step_from_draws, reduce=False,
                            schedule=pb.schedule)(
        pb.state, torch.from_numpy(x), torch.from_numpy(y).long(),
        torch.from_numpy(perm),
        {k: torch.from_numpy(np.stack([d[k] for d in draws]))
         for k in ("z", "t")})
    for name in ("d_loss", "g_loss", "d_real", "d_fake"):
        np.testing.assert_allclose(got[name], np.asarray(traces[name]),
                                   rtol=0, atol=ATOL, err_msg=name)
    jt, pt = _state_trees(jstate, pb.state)
    for net, lr in (("g", pb.cfg.lr_g), ("d", pb.cfg.lr_d)):
        assert_params_close("cgan_mlp", net, pt[net]["params"],
                            jt[net]["params"], EPOCH_STEPS, lr)
    assert pb.state.step == EPOCH_STEPS


def test_wgan_epoch_runner_follows_the_schedule(wgan):
    """The WGAN-GP schedule through the epoch runner on the CPU (eager):
    six steps of one epoch on the trajectory's batches and draws give the
    JAX step's metrics at each global step, G updated at 0 and 5."""
    _, pb = build_pair("wgan_gp")
    _, _, traj = wgan
    xs, ys = batches("wgan_gp", 6)
    x, y = xs.reshape(-1, *xs.shape[2:]), ys.reshape(-1)
    perm = np.arange(6 * B).reshape(6, B)
    key = jax.random.key(KEY)
    draws = [jax_draws("wgan_gp", key, i, 4) for i in range(6)]
    runner = make_epoch_runner(pb.step_from_draws, reduce=False,
                               schedule=pb.schedule)
    assert [runner.schedule(i) for i in range(6)] == [True] + [False] * 4 + [
        True]
    got = runner(pb.state, torch.from_numpy(x), torch.from_numpy(y).long(),
                 torch.from_numpy(perm),
                 {k: torch.from_numpy(np.stack([d[k] for d in draws]))
                  for k in ("z", "t", "gp_eps", "z2")})
    for i, row in enumerate(traj):
        for k, bar in (("d_loss", 3e-4), ("g_loss", 5e-5),
                       ("d_real", ATOL), ("d_fake", ATOL)):
            assert abs(got[k][i] - row["jm"][k]) <= bar, (i, k)
    assert pb.state.step == 6
    assert {int(pb.state.g.opt.state[p]["step"])
            for p in pb.g_model.parameters()} == {2}


def test_draw_fn_draws_what_each_family_needs():
    for family in FAMILIES:
        _, pb = build_pair(family)
        draws = pb.draw_fn(torch.Generator().manual_seed(0), (3, B))
        want = {"z"} | ({"t"} if family in ("cgan_mlp", "wgan_gp") else set())
        want |= {"gp_eps", "z2"} if family == "wgan_gp" else set()
        assert set(draws) == want, family
        assert draws["z"].shape == (3, B, LD)
        if "t" in draws:
            assert int(draws["t"].max()) < FAMILIES[family][2]
