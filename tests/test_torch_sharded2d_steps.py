"""Steps on the 2-D ("data", "model") mesh in the port against the JAX
package's 2-D step, on the CPU: a (2, 2) world of 4 ranks joined by gloo,
one CPU device a rank (tests/torch_world.py), with the generator's
parameters and Adam moments channel-sharded over "model"
(`channel_sharding_spec`, `shard_leaves`), against JAX's step jitted on a
(2, 2) mesh of its virtual CPU devices with `g.params` and `g.opt_state`
sharded the same way (`__graft_entry__.py:219-249`).

Every rank starts from the JAX initial state and gets the same global
batches and JAX's draws; rank (d, m) trains on block 2 d + m of each
batch.  Two steps of each case:

- narrow MNIST (tests/test_torch_step.py's harness: width 8, one block,
  batch 16, the reference recipe), f32, and the same with `remat=True,
  g_microbatch=2`;
- house (the shipped preset at width 8, batch 16; tests/test_torch_
  tabular_step.py's harness, JAX's explicit Gumbel noise);
- DCGAN at hidden 8, batch 8 (tests/test_torch_gan_step.py's harness),
  whose `ConvTranspose` kernels split along their "in" dimension.

Bars, those of tests/test_torch_sharded_steps.py and of the single-process
harnesses: MNIST metrics at the JAX package's sharded bar `rtol=2e-4,
atol=1e-5` (tests/test_sharding.py:63-67), house and DCGAN metrics at
their harnesses' bars (house's critic-read metrics plus the drift of
`sn2/bias`); the gradients through Adam's first moments after the first
step, leaf by leaf in the 2-norm; the parameters after the last step at
each harness's bar.  The port's 2-D step is also held against its own
1-D world of 4 at JAX's `rtol=1e-4` (the graft's bar), and every rank's
layout is checked: each split parameter and both its moments at 1/M of
the whole along the split dimension, Adam's step count whole.

A channel-sharded state written by `save_sharded` is byte for byte the
file of the same state replicated, and restored in a fresh (2, 2) world it
takes the second step bit for bit as the uninterrupted run did.

The worlds run in a thread while JAX compiles its four steps.
"""
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import test_torch_gan_step as gan_h
import test_torch_step as mnist_h
import test_torch_tabular_step as house_h
import torch_world
from cfgan.masks.patch import random_patch_mask as jax_patch_mask
from cfgan.parallel.mesh import create_mesh as jax_create_mesh
from cfgan.parallel.sharding import channel_sharding_spec as jax_spec
from cfgan.parallel.sharding import replicate as jax_replicate
from cfgan.parallel.sharding import shard_batch as jax_shard_batch
from cfgan.parallel.sharding import shard_leaves as jax_shard_leaves
from cfgan.train.countergan import sample_targets as jax_sample_targets
from cfgan.train.state import NetState as JaxNetState
from cfgan.train.state import adam_like_torch as jax_adam
from cfgan_torch.convert import load_gan_state, state_dict_from_flax
from cfgan_torch.data.kc_house import load_kc_house
from cfgan_torch.models.classifiers import CNNClassifier, TabularClassifier
from cfgan_torch.parallel import spawn_world
from cfgan_torch.train.builders import build_mnist_countergan

SHAPE = (2, 2)
WORLD = 4
STEPS = 2
RTOL, ATOL = 2e-4, 1e-5  # the JAX package's sharded bar
GRAFT_RTOL = 1e-4  # __graft_entry__.py: the 2-D step against the 1-D one
TIMEOUT = 300
MNIST_CASES = {"mnist": {}, "mnist-remat-micro2": {"remat": True,
                                                   "g_microbatch": 2}}
CASES = (*MNIST_CASES, "house", "dcgan")
# the MNIST generator's (10, 784) class embedding: JAX's 2-D step on the
# CPU computes g_adv (and under g_microbatch the generator's gradients)
# otherwise than its single-device step when this leaf is split over
# "model" (test_jax_split_embedding_departs_from_its_single_device_step);
# the reference keeps it whole and splits every other leaf of JAX's spec
EMBED = ("embed",)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_2d(bundle, batches, key, whole=()):
    """JAX's step on a (2, 2) mesh of its CPU devices, the generator's
    params and Adam state channel-sharded over "model" as the graft lays
    them out (the leaves whose path names one of `whole` kept whole), on
    `batches`: the metrics by step, Adam's first moments after the first
    step and the trees after the last."""
    mesh = jax_create_mesh(SHAPE, ("data", "model"),
                           devices=jax.devices()[:WORLD])
    keep = NamedSharding(mesh, P())

    def spec(tree):
        return jax.tree_util.tree_map_with_path(
            lambda path, sh: keep if any(
                w in jax.tree_util.keystr(path) for w in whole) else sh,
            jax_spec(mesh, tree))

    st = jax_replicate(mesh, bundle.state)
    st = st.replace(g=st.g.replace(
        params=jax_shard_leaves(st.g.params, spec(st.g.params)),
        opt_state=jax_shard_leaves(st.g.opt_state, spec(st.g.opt_state))))
    step = jax.jit(bundle.step_fn)
    metrics, mu = [], None
    for i, (x, y) in enumerate(batches):
        xs, ys = jax_shard_batch(mesh, (x, y))
        st, m = step(st, xs, ys, key)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            mu = _np({net: getattr(st, net).opt_state[0].mu
                      for net in ("g", "d")})
    trees = _np({"g": st.g.variables(), "d": st.d.variables(),
                 "g_ema": st.g_ema})
    return metrics, mu, trees


def _save(path, port_state, steps, clf=None):
    base = {"g": port_state.g.model.state_dict(),
            "d": port_state.d.model.state_dict()}
    if port_state.g_ema is not None:
        base["g_ema"] = port_state.g_ema
    if clf is not None:
        base["clf"] = clf
    torch_world.save_npz(path, {**base, "steps": {
        str(i): s for i, s in enumerate(steps)}})


def _mnist(path, overrides):
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
    steps, batches = [], []
    for i in range(STEPS):
        x, y = mnist_h._batch(i)
        k_t, k_m, _ = jax.random.split(jax.random.fold_in(key, i), 3)
        t = jax_sample_targets(k_t, jnp.asarray(y), 10, jcfg.resample_target)
        mask = jax_patch_mask(k_m, mnist_h.B, (28, 28), 7, 10, channels=1)
        steps.append({"x": x, "y": y, "t": np.asarray(t),
                      "mask": np.asarray(mask)})
        batches.append((x, y))
    _save(path, port.state, steps, clf_sd)

    def run():
        out = {"ref": _jax_2d(bundle, batches, key, whole=EMBED)}
        if not overrides:
            out["split_embed"] = _jax_2d(bundle, batches, key)[0]
        return out

    return pcfg, run


def _house(path):
    (xtr, ytr), _, stats, _, _ = load_kc_house()
    _, bundle, port = house_h.build_pair("shipped", stats)
    b = house_h.B
    xs = xtr[:STEPS * b].reshape(STEPS, b, -1)
    ys = ytr[:STEPS * b].reshape(STEPS, b)
    key = jax.random.key(3)
    draws = {k: v.numpy() for k, v in
             house_h._jax_epoch_draws(key, ys).items()}
    clf_vars = _np(dict(house_h.JaxClassifier(num_classes=4).init(
        jax.random.key(1), jnp.zeros((2, 17)), train=False)))
    steps = [{"x": xs[i], "y": ys[i],
              "draws": {k: v[i] for k, v in draws.items()}}
             for i in range(STEPS)]
    _save(path, port.state, steps,
          state_dict_from_flax(TabularClassifier(), clf_vars))
    cfg = replace(house_h.PRESETS["shipped"][1], **house_h.WIDTH)
    return cfg, lambda: {"ref": _jax_2d(bundle, list(zip(xs, ys)), key)}


def _dcgan(path):
    jb, pb = gan_h.build_pair("dcgan")
    xs, ys = gan_h.batches("dcgan", STEPS)
    key = jax.random.key(gan_h.KEY)
    steps = []
    for i in range(STEPS):
        d = gan_h.jax_draws("dcgan", key, i, xs.ndim - 1)
        steps.append({"x": xs[i], "y": ys[i], "draws": {
            k: v.astype(np.int64 if k == "t" else np.float32)
            for k, v in d.items()}})
    _save(path, pb.state, steps)
    return (gan_h.configs("dcgan")[1],
            lambda: {"ref": _jax_2d(jb, list(zip(xs, ys)), key)})


def _jobs(d: Path, cfgs: dict, mesh) -> list[dict]:
    jobs = [dict(name=case, family={"house": "tabular"}.get(
                     case, "mnist" if case.startswith("mnist") else case),
                 cfg=cfgs[case], npz=str(d / f"{case}.npz"), mesh=mesh)
            for case in CASES]
    if mesh is not None:
        jobs[0]["save"] = str(d / "ckpt")
    return jobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's 2-D steps by case, the 2-D world's results by rank, the 1-D
    world's, the inputs' directory and the port configs)."""
    d = tmp_path_factory.mktemp("sharded2d")
    cfgs, thunks = {}, {}
    for case, over in MNIST_CASES.items():
        cfgs[case], thunks[case] = _mnist(d / f"{case}.npz", over)
    cfgs["house"], thunks["house"] = _house(d / "house.npz")
    cfgs["dcgan"], thunks["dcgan"] = _dcgan(d / "dcgan.npz")
    with ThreadPoolExecutor(1) as pool:
        worlds = {m: pool.submit(spawn_world, torch_world.train2d, WORLD,
                                 (_jobs(d, cfgs, m),), timeout=TIMEOUT)
                  for m in (SHAPE, None)}
        want = {case: thunk() for case, thunk in thunks.items()}
        got = {m: f.result() for m, f in worlds.items()}
    return want, got[SHAPE], got[None], d, cfgs


def _metrics_bar(case, name, jax_d=None, port_d=None) -> tuple:
    """(rtol, atol) of metric `name` of `case` against JAX."""
    if case == "house":
        drift = float(np.linalg.norm(port_d["sn2"]["bias"]
                                     - jax_d["sn2"]["bias"]))
        return 0.0, house_h.ATOL + (drift if name in house_h.CRITIC_READ
                                    else 0.0)
    if case == "dcgan":
        return 0.0, gan_h.METRIC_BARS["dcgan"].get(name, gan_h.ATOL)
    return RTOL, ATOL


@pytest.mark.parametrize("case", CASES)
def test_2d_steps_match_jax(runs, case):
    """Each step's metrics, every rank the same and the ranks one state."""
    want, got, _, _, _ = runs
    jm, _, jt = want[case]["ref"]
    res = got[0][case]
    for step, (pm, m) in enumerate(zip(res["metrics"], jm)):
        assert pm.keys() == m.keys()
        for k in m:
            rtol, atol = _metrics_bar(case, k, jt["d"]["params"],
                                      res["state"]["d"]["params"])
            assert abs(pm[k] - m[k]) <= atol + rtol * abs(m[k]), (
                step, k, pm[k], m[k])
    for out in got:
        assert out[case]["equal"], f"{case}: the ranks' states differ"
        np.testing.assert_equal(out[case]["metrics"], res["metrics"])
        assert out[case]["step"] == STEPS


def _assert_moments(case, got, want):
    """Adam's first moments leaf by leaf at the single-process harness's
    bar; house's leaves of zero exact gradient at its noise bar."""
    if case == "house":
        noise = lambda k: k.endswith(house_h.NOISE_LEAVES)  # noqa: E731
        mnist_h.assert_moments_close(got, want, skip=noise)
        mnist_h.assert_moments_close(got, want, atol=house_h.NOISE_MU,
                                     skip=lambda k: not noise(k))
    else:
        mnist_h.assert_moments_close(got, want)


@pytest.mark.parametrize("net", ["g", "d"])
@pytest.mark.parametrize("case", CASES)
def test_2d_gradients_match_jax(runs, case, net):
    """Adam's first moments after the first step (0.1 x the gradient),
    gathered whole from the slices, against optax's `mu`."""
    want, got, _, _, _ = runs
    _assert_moments(case, got[0][case]["moments"][net],
                    want[case]["ref"][1][net])


@pytest.mark.parametrize("case", CASES)
def test_2d_parameters_match_jax(runs, case):
    """Both nets' parameters after the last step, and the EMA where the
    preset keeps one."""
    want, got, _, _, cfgs = runs
    jt = want[case]["ref"][2]
    pt = got[0][case]["state"]
    cfg = cfgs[case]
    for net, lr in (("g", cfg.lr_g), ("d", cfg.lr_d)):
        if case == "house":
            house_h.assert_params_close(pt[net]["params"], jt[net]["params"],
                                        STEPS, lr)
        elif case == "dcgan":
            gan_h.assert_params_close("dcgan", net, pt[net]["params"],
                                      jt[net]["params"], STEPS, lr)
        else:
            mnist_h.assert_trees_close(pt[net]["params"], jt[net]["params"],
                                       1e-4)
    assert (pt["g_ema"] is None) == (jt["g_ema"] is None)
    if case == "house":
        house_h.assert_params_close(pt["g_ema"], jt["g_ema"], STEPS,
                                    cfg.lr_g)


@pytest.mark.parametrize("case", CASES)
def test_2d_steps_match_the_1d_world(runs, case):
    """The (2, 2) world against the port's 1-D world of 4 on the same
    batches: every metric of every step at the graft's `rtol=1e-4`, and
    both nets' gradients (Adam's first moments after the first step) at
    the harness's bar."""
    _, got, flat, _, _ = runs
    for pm, fm in zip(got[0][case]["metrics"], flat[0][case]["metrics"]):
        assert pm.keys() == fm.keys()
        for k, v in fm.items():
            assert abs(pm[k] - v) <= GRAFT_RTOL * abs(v) + 1e-7, (k, pm[k], v)
    for net in ("g", "d"):
        _assert_moments(case, got[0][case]["moments"][net],
                        flat[0][case]["moments"][net])


def test_jax_split_embedding_departs_from_its_single_device_step(runs):
    """JAX's own 2-D step with the generator's class embedding split over
    "model" (its full spec) moves g_adv off its step with the embedding
    whole, which is its single-device step's, by more than the sharded
    bar; the port's 2-D step, on the full spec, stays within it.  (A fault
    of the JAX reference on the CPU, which this file's MNIST reference
    keeps out by holding that one leaf whole.)"""
    want, got, _, _, _ = runs
    ref = want["mnist"]["ref"][0][0]["g_adv"]
    split = want["mnist"]["split_embed"][0]["g_adv"]
    port = got[0]["mnist"]["metrics"][0]["g_adv"]
    bar = ATOL + RTOL * abs(ref)
    assert abs(split - ref) > bar
    assert abs(port - ref) <= bar
    assert got[0]["mnist"]["layout"]["embed.weight"]["split"]


@pytest.mark.parametrize("case", CASES)
def test_each_rank_holds_its_slices(runs, case):
    """After `shard_leaves` each rank holds 1/2 of every split generator
    parameter along one dimension and of both its Adam moments, Adam's
    step count whole; the replicated leaves whole.  The state's bytes on
    a rank fall by the generator's split half."""
    _, got, flat, _, _ = runs
    split = 0
    for out in got:
        for name, f in out[case]["layout"].items():
            whole, held = f["whole"], f["held"]
            if f["split"]:
                split += 1
                diff = [i for i, (a, b) in enumerate(zip(whole, held))
                        if a != b]
                assert len(diff) == 1 and whole[diff[0]] == 2 * held[
                    diff[0]], (name, whole, held)
            else:
                assert held == whole, name
            assert f["moments"] == (held, held) and f["step"] == (), name
    assert split > 0
    halved = sum(np.prod(f["whole"]) // 2 for f in
                 got[0][case]["layout"].values() if f["split"])
    assert (flat[0][case]["g_opt_bytes"] - got[0][case]["g_opt_bytes"]
            == 2 * 4 * halved)
    assert (flat[0][case]["state_bytes"] - got[0][case]["state_bytes"]
            == 3 * 4 * halved)


def test_sharded_checkpoint_is_the_replicated_file(runs):
    """`save_sharded` of the channel-sharded MNIST state after its first
    step writes the bytes a replicated state of the same values writes."""
    d = runs[3]
    files = sorted(p.name for p in (d / "ckpt").iterdir())
    assert files == sorted(p.name for p in (d / "ckpt-replicated").iterdir())
    for f in files:
        assert ((d / "ckpt" / f).read_bytes()
                == (d / "ckpt-replicated" / f).read_bytes()), f


def test_sharded_checkpoint_resumes_in_a_fresh_world(runs):
    """A fresh (2, 2) world restores the checkpoint into a fresh
    channel-sharded state and takes the second step: its metrics and
    whole state equal the uninterrupted run's bit for bit."""
    _, got, _, d, cfgs = runs
    job = dict(name="mnist", family="mnist", cfg=cfgs["mnist"],
               npz=str(d / "mnist.npz"), mesh=SHAPE, restore=str(d / "ckpt"))
    restored = spawn_world(torch_world.train2d, WORLD, ([job],),
                           timeout=TIMEOUT)
    for r, s in zip(restored, got):
        assert r["mnist"]["metrics"] == s["mnist"]["metrics"][1:]
        assert r["mnist"]["equal"]
        a, b = (dict(mnist_h.leaves(x["mnist"]["state"])) for x in (r, s))
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
