"""Data-parallel narrow MNIST CounteRGAN steps and a WGAN-GP epoch in the
port against the JAX package, on the CPU, in worlds of 2 and 4 ranks
joined by gloo, one CPU device a rank (tests/torch_world.py).

Every rank starts from the JAX initial state and gets the same global
batches and JAX's draws; each trains on its rows.

- Two narrow MNIST steps (width 8, one block, batch 16, the reference
  recipe; tests/test_torch_step.py's harness) with `remat` and with
  `g_microbatch=2` through the step-level API: every metric at the JAX
  package's sharded bar, `rtol=2e-4, atol=1e-5` (tests/test_sharding.py:
  63-67), and the gradients (Adam's first moments after the first step)
  leaf by leaf within 5e-5 of their 2-norm, the bar of the single-process
  step.  Under `g_microbatch` each rank's k-th chunk is its share of the
  global k-th chunk, whose BatchNorm statistics JAX takes over the
  chunk's rows: the same world on the batch reordered so that its
  chunk-major rows are each rank's contiguous block (what a contiguous
  split would train on) misses the gradient bar, while its losses still
  pass theirs.
- A WGAN-GP epoch (hidden 16, batch 8, six steps: critic-only steps and
  generator steps, the penalty's double backward through a generator
  whose BatchNorms are synchronised), per step at JAX's own WGAN-GP
  sharded bar, `rtol=2e-4, atol=1e-4` (tests/test_sharding.py:145-148).

Every rank holds rank 0's state bit for bit after each job and reports
its metrics.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_gan_step as gan_h
import test_torch_step as mnist_h
import torch_world
from cfgan.masks.patch import random_patch_mask as jax_patch_mask
from cfgan.train.countergan import make_epoch_runner as jax_epoch_runner
from cfgan.train.countergan import sample_targets as jax_sample_targets
from cfgan.train.state import NetState as JaxNetState
from cfgan.train.state import adam_like_torch as jax_adam
from cfgan_torch.convert import load_gan_state, state_dict_from_flax
from cfgan_torch.models.classifiers import CNNClassifier
from cfgan_torch.parallel import spawn_world
from cfgan_torch.train.builders import build_mnist_countergan

RTOL, ATOL = 2e-4, 1e-5  # the JAX package's sharded bar
WGAN_ATOL = 1e-4  # its WGAN-GP sharded bar
TIMEOUT = 300
MNIST_STEPS = 2
MNIST_CASES = {"remat": {"remat": True}, "micro2": {"g_microbatch": 2}}
WGAN_STEPS = 6
WORLDS = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def contiguous_order(b, world, k):
    """The order of a global batch of `b` rows whose chunk-major rows (k
    chunks over `world` ranks) are each rank's contiguous block of the
    batch as it was."""
    m = b // (world * k)
    order = np.empty(b, np.int64)
    for r in range(world):
        for c in range(k):
            start = c * (b // k) + r * m
            order[start:start + m] = np.arange(m) + r * (b // world) + c * m
    return order


def _mnist(d, name, overrides):
    """The narrow MNIST pair with `overrides`: the port's initial state
    and the global batches and draws (as they are, and by world in the
    contiguous order) into .npz files; returns (port config, the JAX
    steps' thunk)."""
    jcfg, pcfg = mnist_h._configs(**overrides)
    clf_model = mnist_h.JaxClassifier()
    clf_vars = _np(dict(clf_model.init(jax.random.key(1),
                                       jnp.zeros((2, 28, 28, 1)),
                                       train=False)))
    bundle = mnist_h.jax_build(jcfg, clf_model,
                               JaxNetState.create(clf_vars, jax_adam(1e-3)),
                               seed=7)
    clf_sd = state_dict_from_flax(CNNClassifier(), clf_vars)
    port = build_mnist_countergan(pcfg, clf_sd, device="cpu")
    load_gan_state(port.state, mnist_h._jax_trees(bundle.state))
    key = jax.random.key(3)
    steps = {}
    for i in range(MNIST_STEPS):
        x, y = mnist_h._batch(i)
        k_t, k_m, _ = jax.random.split(jax.random.fold_in(key, i), 3)
        t = jax_sample_targets(k_t, jnp.asarray(y), 10, jcfg.resample_target)
        mask = jax_patch_mask(k_m, mnist_h.B, (28, 28), 7, 10, channels=1)
        steps[str(i)] = {"x": x, "y": y, "t": np.asarray(t),
                         "mask": np.asarray(mask)}
    base = {"g": port.state.g.model.state_dict(),
            "d": port.state.d.model.state_dict(), "clf": clf_sd}
    torch_world.save_npz(d / f"{name}.npz", {**base, "steps": steps})
    for world in WORLDS:
        order = contiguous_order(mnist_h.B, world, 2)
        torch_world.save_npz(d / f"{name}-contig{world}.npz", {
            **base, "steps": {i: {k: v[order] for k, v in s.items()}
                              for i, s in steps.items()}})

    def run():
        step = jax.jit(bundle.step_fn)
        state, metrics, mu = bundle.state, [], None
        for i in range(MNIST_STEPS):
            s = steps[str(i)]
            state, jm = step(state, jnp.asarray(s["x"]), jnp.asarray(s["y"]),
                             key)
            metrics.append({k: float(v) for k, v in jm.items()})
            if i == 0:
                mu = mnist_h._jax_adam_mu(state)
        return metrics, mu

    return pcfg, run


def _wgan(d):
    """tests/test_torch_gan_step.py's WGAN-GP pair, six steps of one
    epoch on its batches and JAX's draws."""
    jb, pb = gan_h.build_pair("wgan_gp")
    xs, ys = gan_h.batches("wgan_gp", WGAN_STEPS)
    x, y = xs.reshape(-1, *xs.shape[2:]), ys.reshape(-1)
    perm = np.arange(WGAN_STEPS * gan_h.B).reshape(WGAN_STEPS, gan_h.B)
    key = jax.random.key(gan_h.KEY)
    draws = [gan_h.jax_draws("wgan_gp", key, i, 4) for i in range(WGAN_STEPS)]
    torch_world.save_npz(d / "wgan.npz", {
        "g": pb.state.g.model.state_dict(), "d": pb.state.d.model.state_dict(),
        "x": x, "y": y, "perm": perm,
        "draws": {k: np.stack([s[k] for s in draws]).astype(
            np.int64 if k == "t" else np.float32)
            for k in ("z", "t", "gp_eps", "z2")}})

    def run():
        _, traces = jax_epoch_runner(jb.step_fn, donate=False, reduce=False)(
            jb.state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(perm), key)
        return {k: np.asarray(v, np.float64) for k, v in traces.items()}

    return gan_h.configs("wgan_gp")[1], run


def _jobs(d, cfgs, world):
    jobs = [dict(name=n, family="mnist", cfg=cfgs[n], npz=str(d / f"{n}.npz"),
                 kind="steps") for n in MNIST_CASES]
    jobs.append(dict(name="micro2-contig", family="mnist",
                     cfg=cfgs["micro2"],
                     npz=str(d / f"micro2-contig{world}.npz"), kind="steps"))
    jobs.append(dict(name="wgan", family="wgan", cfg=cfgs["wgan"],
                     npz=str(d / "wgan.npz"), kind="epoch"))
    return jobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's side by job, each world's results by rank): the worlds run
    in a thread while JAX compiles."""
    d = tmp_path_factory.mktemp("sharded_steps")
    cfgs, thunks = {}, {}
    for name, over in MNIST_CASES.items():
        cfgs[name], thunks[name] = _mnist(d, name, over)
    cfgs["wgan"], thunks["wgan"] = _wgan(d)
    with ThreadPoolExecutor(1) as pool:
        worlds = {w: pool.submit(spawn_world, torch_world.train, w,
                                 (_jobs(d, cfgs, w),), timeout=TIMEOUT)
                  for w in WORLDS}
        want = {name: thunk() for name, thunk in thunks.items()}
        got = {w: f.result() for w, f in worlds.items()}
    return want, got


def _same_on_every_rank(outs, name):
    for out in outs:
        assert out[name]["equal"], f"{name}: replicas differ"
        np.testing.assert_equal(out[name]["metrics"],
                                outs[0][name]["metrics"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(MNIST_CASES))
def test_sharded_mnist_steps_match_jax(runs, world, case):
    """Two narrow MNIST steps with `remat` or `g_microbatch=2` on the
    global batch: the metrics of each, and the gradients of the first."""
    want, got = runs
    jm, jmu = want[case]
    res = got[world][0][case]
    for step, (pm, m) in enumerate(zip(res["metrics"], jm)):
        assert pm.keys() == m.keys()
        for k in m:
            assert abs(pm[k] - m[k]) <= ATOL + RTOL * abs(m[k]), (step, k)
    for net in ("g", "d"):
        mnist_h.assert_moments_close(res["moments"][net], jmu[net])
    _same_on_every_rank(got[world], case)
    assert res["step"] == MNIST_STEPS


@pytest.mark.parametrize("world", WORLDS)
def test_contiguous_rows_would_miss_jax(runs, world):
    """Under `g_microbatch=2` the world on the batch reordered to give each
    rank its contiguous block trains the chunks on other rows: its
    generator gradients miss the bar the chunk-major rows hold (above)."""
    want, got = runs
    res = got[world][0]["micro2-contig"]
    with pytest.raises(AssertionError):
        mnist_h.assert_moments_close(res["moments"]["g"],
                                     want["micro2"][1]["g"])
    _same_on_every_rank(got[world], "micro2-contig")


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_wgan_gp_epoch_matches_jax(runs, world):
    """The WGAN-GP epoch's per-step metrics against JAX's epoch."""
    want, got = runs
    res = got[world][0]["wgan"]
    assert res["metrics"].keys() == want["wgan"].keys()
    for k, v in want["wgan"].items():
        np.testing.assert_allclose(res["metrics"][k], v, rtol=RTOL,
                                   atol=WGAN_ATOL, err_msg=k)
    _same_on_every_rank(got[world], "wgan")
    assert res["step"] == WGAN_STEPS
