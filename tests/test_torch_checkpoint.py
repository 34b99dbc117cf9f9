"""The port's run-dir checkpoints (cfgan_torch.core.checkpoint, with its
own msgpack codec) against the JAX package's flax-msgpack ones, on the
CPU.  Bars: exact (the same bytes and arrays), and 1e-5 for served
counterfactuals.

- The codec decodes what flax writes and writes what flax decodes; the
  committed checkpoints re-encode to their own bytes.
- The port's classifier, generator and train-state dirs restore in
  `cfgan.core.checkpoint.restore` / `restore_train_state`, leaf for leaf,
  Adam's count and moments included; the JAX package's restore in the
  port, in place.
- Every `checkpoint.msgpack` of `results/mnist_countergan_seed43/`
  (classifier, generator, train_state) loads into the port's full-width
  models with the right shapes, and the seed-43 generator serves the
  same counterfactuals from both packages (float32, 1e-5).
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
from cfgan.models.classifiers import CNNClassifier as JaxClassifier
from cfgan.models.generators import ImageResidualGenerator as JaxGenerator
from cfgan.train.builders import build_mnist_countergan as jax_build
from cfgan.train.state import NetState as JaxNetState
from cfgan.train.state import adam_like_torch as jax_adam
from cfgan_torch.convert import (
    flax_from_state_dict,
    load_gan_state,
    state_dict_from_flax,
    train_state_to_flax,
)
from cfgan_torch.core import checkpoint as ck
from cfgan_torch.core.config import MNIST_COUNTERGAN
from cfgan_torch.models.classifiers import CNNClassifier
from cfgan_torch.train.builders import build_mnist_countergan, mnist_models

from test_torch_step import _configs, _jax_trees


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU run shares its cores with other test workers: one torch
    thread keeps this file's many small eager ops from oversubscribing
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parent.parent
SEED43 = ROOT / "results" / "mnist_countergan_seed43"
FIXTURE = ROOT / "tests" / "fixtures" / "mnist_idx"


def _equal(a, b, where=""):
    """Same keys at every level, equal arrays (and dtypes) at the leaves."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), where
        for k in b:
            _equal(a[k], b[k], f"{where}/{k}")
    elif b is None:
        assert a is None, where
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_codec_round_trips_what_flax_writes():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.int32(5), "d": np.array(7, np.int64), "e": {}},
            "f": np.ones((2, 2), jnp.bfloat16), "g": None,
            "h": [1, -3, 300, -70000, 2 ** 40, 1.5, "x" * 40, True]}
    blob = serialization.msgpack_serialize(tree)
    got = ck.unpackb(blob)
    assert got["f"].dtype == torch.bfloat16
    assert torch.equal(got["f"], torch.ones((2, 2), dtype=torch.bfloat16))
    got["f"] = np.ones((2, 2), jnp.bfloat16)
    _equal({k: got[k] for k in "abf"}, {k: tree[k] for k in "abf"})
    assert got["g"] is None and got["h"] == tree["h"]
    assert ck.packb(ck.unpackb(blob)) == blob
    back = serialization.msgpack_restore(ck.packb(
        {**tree, "f": torch.ones((2, 2), dtype=torch.bfloat16)}))
    assert back["f"].dtype == jnp.bfloat16
    _equal({k: back[k] for k in "ab"}, {k: tree[k] for k in "ab"})


@pytest.mark.parametrize("name", ["classifier", "generator", "train_state"])
def test_committed_checkpoints_decode_as_flax_and_reencode_to_their_bytes(
        name):
    blob = (SEED43 / name / ck.FILE).read_bytes()
    got = ck.unpackb(blob)
    _equal(got, serialization.msgpack_restore(blob))
    assert ck.packb(got) == blob


@pytest.fixture(scope="module")
def trained_pair(tmp_path_factory):
    """A JAX bundle and the port's, from one state; the port trained one
    epoch (so Adam's moments and count are not at their start) and wrote
    its run dirs."""
    jcfg, pcfg = _configs(ema_decay=0.999)
    clf_model = JaxClassifier()
    clf_vars = _np(dict(clf_model.init(jax.random.key(1),
                                       jnp.zeros((2, 28, 28, 1)))))
    bundle = jax_build(jcfg, clf_model,
                       JaxNetState.create(clf_vars, jax_adam(1e-3)), seed=7)
    clf = CNNClassifier()
    clf.load_state_dict(state_dict_from_flax(clf, clf_vars))
    port = build_mnist_countergan(pcfg, clf.state_dict(), device="cpu")
    load_gan_state(port.state, _jax_trees(bundle.state))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (48, 28, 28, 1)).astype(
        np.float32))
    y = torch.from_numpy(rng.randint(0, 10, 48)).long()
    perm = torch.randperm(48, generator=torch.Generator().manual_seed(0))
    port.epoch_fn(port.state, x, y, perm.reshape(3, 16),
                  port.draw_fn(torch.Generator().manual_seed(1), (3, 16)))
    out = tmp_path_factory.mktemp("run")
    ck.save_train_state(str(out / "train_state"), port.state, epoch=0,
                        history={"d_loss": [0.5]})
    g = port.state.g.model
    ck.save(str(out / "generator"), flax_from_state_dict(g, g.state_dict()),
            metadata={"serving_selection": {"candidate": "live"}})
    ck.save(str(out / "classifier"), flax_from_state_dict(clf,
                                                          clf.state_dict()))
    return bundle, clf_model, port, clf, out


def test_port_run_dirs_restore_in_jax(trained_pair):
    bundle, clf_model, port, clf, out = trained_pair
    template = clf_model.init(jax.random.key(0), jnp.zeros((2, 28, 28, 1)))
    _equal(_np(jck.restore(str(out / "classifier"), dict(template))),
           flax_from_state_dict(clf, clf.state_dict()))
    g = port.state.g.model
    _equal(_np(jck.restore(str(out / "generator"),
                           dict(bundle.state.g.variables()))),
           flax_from_state_dict(g, g.state_dict()))
    assert jck.load_metadata(str(out / "generator")) == {
        "serving_selection": {"candidate": "live"}}
    state, epoch, hist = jck.restore_train_state(str(out / "train_state"),
                                                 bundle.state)
    assert epoch == 1 and hist == {"d_loss": [0.5]}
    want = train_state_to_flax(port.state)
    assert int(want["step"]) == 3
    assert int(want["g"]["opt_state"]["0"]["count"]) == 3
    _equal(_np(serialization.to_state_dict(state)), want)


def test_jax_train_state_restores_in_the_port_in_place(trained_pair,
                                                       tmp_path):
    bundle, _, _, clf, _ = trained_pair
    step = jax.jit(bundle.step_fn)
    rng = np.random.RandomState(2)
    state = bundle.state
    for i in range(2):
        state, _ = step(state, jnp.asarray(rng.uniform(
            -1, 1, (16, 28, 28, 1)).astype(np.float32)),
            jnp.asarray(rng.randint(0, 10, 16)), jax.random.key(i))
    jck.save_train_state(str(tmp_path / "ts"), state, epoch=4)
    _, pcfg = _configs(ema_decay=0.999)
    port = build_mnist_countergan(pcfg, clf.state_dict(), device="cpu")
    g = port.state.g.model
    addresses = [t.data_ptr() for t in (*g.parameters(), *g.buffers(),
                                        *port.state.g_ema.values())]
    epoch, _ = ck.restore_train_state(str(tmp_path / "ts"), port.state)
    assert epoch == 5 and port.state.step == 2
    _equal(train_state_to_flax(port.state),
           _np(serialization.to_state_dict(state)))
    assert addresses == [t.data_ptr() for t in (
        *g.parameters(), *g.buffers(), *port.state.g_ema.values())]
    first = next(g.parameters())
    exp_avg = port.state.g.opt.state[first]["exp_avg"]
    ck.restore_train_state(str(tmp_path / "ts"), port.state)
    assert port.state.g.opt.state[first]["exp_avg"] is exp_avg


def test_restore_checks_leaf_shapes(trained_pair, tmp_path):
    _, _, port, _, out = trained_pair
    wide = build_mnist_countergan(
        replace(_configs(ema_decay=0.999)[1], hidden_dim=16),
        CNNClassifier().state_dict(), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ck.restore_train_state(str(out / "train_state"), wide.state)


@pytest.fixture(scope="module")
def seed43():
    cfg = replace(MNIST_COUNTERGAN, compute_dtype="float32")
    g_model, clf = mnist_models(cfg)
    return cfg, g_model, clf


@pytest.mark.parametrize("name", ["classifier", "generator", "train_state"])
def test_seed43_checkpoints_load_into_the_port(seed43, name):
    cfg, g_model, clf = seed43
    path = str(SEED43 / name)
    if name == "classifier":
        tree = ck.restore(path, flax_from_state_dict(clf, clf.state_dict()))
        clf.load_state_dict(state_dict_from_flax(clf, tree))
        assert clf.Linear_0.weight.shape == (256, 128 * 7 * 7)
    elif name == "generator":
        tree = ck.restore(path, flax_from_state_dict(g_model,
                                                     g_model.state_dict()))
        g_model.load_state_dict(state_dict_from_flax(g_model, tree))
        assert g_model.res5.conv2.weight.shape == (64, 64, 3, 3)
        meta = ck.load_metadata(path)["serving_selection"]
        assert meta["candidate"] == "snapshot_e10_live"
    else:
        bundle = build_mnist_countergan(cfg, clf.state_dict(), device="cpu")
        epoch, hist = ck.restore_train_state(path, bundle.state)
        assert epoch == 20 and len(hist["d_loss"]) == 20
        assert bundle.state.step == 8420
        p = bundle.state.g.model.conv_mid.weight
        assert bundle.state.g.opt.state[p]["exp_avg"].shape == p.shape
        assert int(bundle.state.g.opt.state[p]["step"]) == 8420


def test_seed43_generator_serves_the_same_counterfactuals(seed43):
    from cfgan_torch.data.mnist import load_mnist
    from cfgan_torch.train.builders import build_mnist_serving

    cfg, g_model, clf = seed43
    g_tree = ck.load(str(SEED43 / "generator"))
    clf_tree = ck.load(str(SEED43 / "classifier"))
    serving = build_mnist_serving(
        cfg, state_dict_from_flax(g_model, g_tree),
        state_dict_from_flax(clf, clf_tree), device="cpu")
    _, _, (xte, _) = load_mnist(path=str(FIXTURE), valid_fraction=0.0)
    x = xte[:10]
    t = np.arange(10)
    mask = np.ones_like(x)
    raw, masked = JaxGenerator().apply(g_tree, jnp.asarray(x), jnp.asarray(t),
                                       jnp.asarray(mask), train=False)
    want = np.clip(x + np.asarray(masked), -1.0, 1.0)
    got, _, _ = serving.cf_fn(torch.from_numpy(x), torch.from_numpy(t),
                              torch.from_numpy(mask))
    assert np.abs(got.numpy() - want).max() <= 1e-5
    assert np.abs(want - x).max() > 0.05  # the generator changes the images
