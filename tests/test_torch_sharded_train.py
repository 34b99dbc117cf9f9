"""Data-parallel CounteRGAN epochs in the port (`cfgan_torch.parallel`, the
step of `cfgan_torch.train.countergan`, the epoch runner, the loop and the
sharded checkpoints) against the JAX package, on the CPU, in worlds of 2
and 4 ranks joined by gloo, one CPU device a rank (tests/torch_world.py).

Every rank starts from the JAX initial state (carried across by
`cfgan_torch.convert`) and gets the same global batches and JAX's draws;
each trains on its rows.  An epoch of the moons CounteRGAN (the JAX
sharding test's config, 4 steps of 64 rows) and of the house CounteRGAN
(the shipped preset at width 8, 4 steps of 16 rows) through the epoch
runner, step by step against JAX's single-device epoch and JAX's epoch
sharded over its 8-device mesh, at the JAX package's sharded bar
`rtol=2e-4, atol=1e-5` (tests/test_sharding.py:63-67), with two
exceptions that the single-process parity tests of these families hold
too (tests/test_torch_moons_train.py, test_torch_tabular_step.py):

- house: `atol=3e-5`, the repo's torch-oracle bar for the port against
  JAX (its d_loss, a difference of two means near 0, sits 1-2e-5 from
  JAX's in either layout);
- the four numbers read through the critic's score (g_adv, g_loss,
  d_real_p, d_fake_p): plus the 2-norm of the drift of the critic's last
  hidden biases (`sn2/bias`) from JAX's at the epoch's end.  Their exact
  gradient is zero where a unit is active on every row (the Wasserstein
  loss cancels it); the computed one is float32 noise, whose sum the
  sharded step takes in another order, and Adam turns that noise into
  moves of up to lr a step.

Every rank's state is bit for bit rank 0's after each job, and every rank
reports the same metrics.  `train_countergan_loop(mesh=)` logs on rank 0
alone and equals the single-process loop at the sharded bar; a checkpoint
written by `save_sharded` in one world and read by `restore_sharded` in a
fresh one resumes bit for bit (tests/test_multihost.py's story).

A world takes seconds to start: each runs every job in one spawn, while
the parent compiles JAX's epochs.
"""
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_moons_train as moons_h
import test_torch_tabular_step as house_h
import torch_world
from cfgan.core.config import CounterGANConfig as JaxConfig
from cfgan.data.pipeline import epoch_perm as jax_epoch_perm
from cfgan.models.classifiers import MLPClassifier as JaxMLP
from cfgan.parallel.mesh import create_mesh as jax_create_mesh
from cfgan.parallel.sharding import replicate as jax_replicate
from cfgan.parallel.sharding import shard_batch as jax_shard_batch
from cfgan.train.builders import build_moons_countergan as jax_build_moons
from cfgan.train.countergan import make_epoch_runner as jax_epoch_runner
from cfgan.train.state import NetState as JaxNetState
from cfgan.train.state import adam_like_torch as jax_adam
from cfgan_torch.convert import load_gan_state, state_dict_from_flax
from cfgan_torch.core import config as C
from cfgan_torch.data.kc_house import load_kc_house
from cfgan_torch.data.moons import load_moons3
from cfgan_torch.models.classifiers import MLPClassifier, TabularClassifier
from cfgan_torch.parallel import spawn_world
from cfgan_torch.train.builders import build_moons_countergan
from cfgan_torch.train.loop import train_countergan_loop

RTOL = 2e-4  # the JAX package's sharded bar
ATOL = {"moons": 1e-5, "house": 3e-5}
CRITIC_READ = ("g_adv", "g_loss", "d_real_p", "d_fake_p")
TIMEOUT = 300
MOONS_N, MOONS_B = 256, 64
HOUSE_N = 64
WORLDS = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _state(port) -> dict:
    s = port.state
    out = {"g": s.g.model.state_dict(), "d": s.d.model.state_dict()}
    if s.g_ema is not None:
        out["g_ema"] = s.g_ema
    return out


def _traces(metrics) -> dict:
    return {k: np.asarray(v, np.float64) for k, v in metrics.items()}


def _jax_epochs(bundle, x, y, perm, key):
    """JAX's epoch on one device and sharded over its 8-device mesh, as
    per-step traces, and the single-device run's critic parameters."""
    run = jax_epoch_runner(bundle.step_fn, donate=False, reduce=False)
    state, single = run(bundle.state, jnp.asarray(x), jnp.asarray(y),
                        jnp.asarray(perm), key)
    mesh = jax_create_mesh()
    xs, ys = jax_shard_batch(mesh, (np.asarray(x), np.asarray(y)))
    _, sharded = run(jax_replicate(mesh, bundle.state), xs, ys,
                     jnp.asarray(perm), key)
    return (_traces(single), _traces(sharded),
            _np(state.d.variables()["params"]))


def _moons(path):
    """The moons CounteRGAN of tests/test_sharding.py (the default config,
    seed 7) on a random frozen classifier; two epochs' perms and draws.
    Returns (port config, the JAX epochs' thunk)."""
    (xtr, ytr), _, _ = load_moons3()
    x, y = xtr[:MOONS_N], ytr[:MOONS_N]
    clf_vars = _np(dict(JaxMLP().init(jax.random.key(1), jnp.zeros((2, 2)))))
    bundle = jax_build_moons(JaxConfig(), JaxMLP(),
                             JaxNetState.create(clf_vars, jax_adam(1e-2)),
                             seed=7)
    cfg = C.CounterGANConfig()
    clf_sd = state_dict_from_flax(MLPClassifier(), clf_vars)
    port = build_moons_countergan(cfg, clf_sd, device="cpu")
    load_gan_state(port.state, moons_h._jax_trees(bundle.state))
    epochs = []
    for k in (3, 5):
        perm = np.asarray(jax_epoch_perm(jax.random.key(k), MOONS_N,
                                         MOONS_B))
        key = jax.random.key(k + 1)
        draws = {"targets": [], "mask": []}
        for i in range(perm.shape[0]):
            k_t, k_m, _ = jax.random.split(jax.random.fold_in(key, i), 3)
            draws["targets"].append(np.asarray(jax.random.randint(
                k_t, (MOONS_B,), 0, 3)))
            draws["mask"].append(np.asarray(jax.random.randint(
                k_m, (MOONS_B, 2), 0, 2)))
        epochs.append((perm, key, {n: np.stack(v) for n, v in draws.items()}))
    (perm, key, draws), (perm2, _, draws2) = epochs
    torch_world.save_npz(path, {
        **_state(port), "clf": clf_sd, "x": x, "y": y, "perm": perm,
        "draws": draws, "perm2": perm2, "draws2": draws2})
    return cfg, lambda: _jax_epochs(bundle, x, y, perm, key)


def _house(path):
    """The shipped house CounteRGAN at width 8 (tests/test_torch_tabular_
    step.py's pair: JAX's explicit Gumbel noise, a random classifier), an
    epoch of 4 steps."""
    (xtr, ytr), _, stats, _, _ = load_kc_house()
    x, y = xtr[:HOUSE_N], ytr[:HOUSE_N]
    _, bundle, port = house_h.build_pair("shipped", stats)
    perm = np.random.RandomState(1).permutation(HOUSE_N).reshape(
        -1, house_h.B)
    key = jax.random.key(3)
    draws = {k: v.numpy() for k, v in
             house_h._jax_epoch_draws(key, y[perm]).items()}
    clf_vars = _np(dict(house_h.JaxClassifier(num_classes=4).init(
        jax.random.key(1), jnp.zeros((2, 17)), train=False)))
    torch_world.save_npz(path, {
        **_state(port),
        "clf": state_dict_from_flax(TabularClassifier(), clf_vars),
        "x": x, "y": y, "perm": perm, "draws": draws})
    cfg = replace(house_h.PRESETS["shipped"][1], **house_h.WIDTH)
    return cfg, lambda: _jax_epochs(bundle, x, y, perm, key)


def _jobs(d, cfgs, world):
    jobs = [dict(name=fam, family="tabular" if fam == "house" else fam,
                 cfg=cfgs[fam], npz=str(d / f"{fam}.npz"), kind="epoch")
            for fam in ("moons", "house")]
    if world == 2:
        moons = dict(family="moons", cfg=cfgs["moons"],
                     npz=str(d / "moons.npz"))
        jobs += [dict(name="loop", kind="loop", batch=MOONS_B, **moons),
                 dict(name="save", kind="save", dir=str(d / "ckpt"),
                      **moons)]
    return jobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's epochs by family, each world's results by rank, the inputs'
    directory and the port configs): the worlds run in a thread while
    JAX compiles."""
    d = tmp_path_factory.mktemp("sharded_train")
    cfgs, thunks = {}, {}
    for fam, make in (("moons", _moons), ("house", _house)):
        cfgs[fam], thunks[fam] = make(d / f"{fam}.npz")
    with ThreadPoolExecutor(1) as pool:
        worlds = {w: pool.submit(spawn_world, torch_world.train, w,
                                 (_jobs(d, cfgs, w),), timeout=TIMEOUT)
                  for w in WORLDS}
        want = {fam: thunk() for fam, thunk in thunks.items()}
        got = {w: f.result() for w, f in worlds.items()}
    return want, got, d, cfgs


def _critic_drift(got_params, want_params) -> float:
    return float(np.linalg.norm(np.asarray(got_params["sn2"]["bias"])
                                - want_params["sn2"]["bias"]))


def assert_epoch_close(got: dict, want: dict, atol: float, offset: float,
                       what: str):
    assert got.keys() == want.keys(), what
    for k in want:
        bar = atol + (offset if k in CRITIC_READ else 0.0)
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=bar,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("family", ["moons", "house"])
def test_sharded_epoch_matches_jax(runs, world, family):
    """The sharded epoch's per-step metrics against JAX's single-device
    epoch and JAX's sharded epoch; every rank the same state and
    metrics."""
    want, got, _, _ = runs
    single, sharded, jax_d = want[family]
    outs = got[world]
    res = outs[0][family]
    offset = _critic_drift(res["d_params"], jax_d)
    for ref, what in ((single, "JAX single"), (sharded, "JAX sharded")):
        assert_epoch_close(res["metrics"], ref, ATOL[family], offset,
                           f"{family} at {world} vs {what}")
    for out in outs:
        assert out[family]["equal"] and out[family]["step"] == 4
        np.testing.assert_equal(out[family]["metrics"], res["metrics"])


def test_train_loop_mesh_option(runs):
    """`train_countergan_loop(mesh=)` at world 2: every rank's history is
    the global means, equal on both ranks and to the single-process
    loop's at the sharded bar (the critic-read numbers plus the drift of
    `sn2/bias`, as above); rank 0 alone logs; the replicas equal."""
    from cfgan_torch.convert import gan_state_to_flax

    _, got, d, cfgs = runs
    outs = got[2]
    inputs = torch_world.load_npz(d / "moons.npz")
    port = torch_world.build("moons", cfgs["moons"], inputs)
    lines = []
    state, want = train_countergan_loop(port, inputs["x"], inputs["y"],
                                        epochs=2, batch_size=MOONS_B,
                                        seed=0, log=lines.append)
    want.pop("wall_time_s")
    hist = outs[0]["loop"]["history"]
    offset = _critic_drift(outs[0]["loop"]["d_params"],
                           _np(gan_state_to_flax(state)["d"]["params"]))
    assert_epoch_close({k: np.asarray(v) for k, v in hist.items()},
                       {k: np.asarray(v) for k, v in want.items()},
                       ATOL["moons"], offset, "loop")
    assert outs[1]["loop"]["history"] == hist
    assert len(outs[0]["loop"]["lines"]) == len(lines) == 2
    assert outs[1]["loop"]["lines"] == []
    assert all(o["loop"]["equal"] for o in outs)


def test_sharded_checkpoint_resumes_in_a_fresh_world(runs):
    """`save_sharded` after an epoch at world 2, then `restore_sharded` in
    a fresh world of 2 into a fresh state: every rank holds the saved
    state, and the next epoch's metrics are the uninterrupted run's, bit
    for bit."""
    _, got, d, cfgs = runs
    saved = got[2]
    job = dict(name="restore", family="moons", cfg=cfgs["moons"],
               npz=str(d / "moons.npz"), kind="restore", dir=str(d / "ckpt"))
    restored = spawn_world(torch_world.train, 2, ([job],), timeout=TIMEOUT)
    for s, r in zip(saved, restored):
        assert len(s["save"]["saved"]) == len(r["restore"]["saved"])
        for a, b in zip(s["save"]["saved"], r["restore"]["saved"]):
            assert torch.equal(a, b)
        assert r["restore"]["post"] == s["save"]["post"]
        assert r["restore"]["equal"] and s["save"]["equal"]
    assert restored[0]["restore"]["post"] == restored[1]["restore"]["post"]
