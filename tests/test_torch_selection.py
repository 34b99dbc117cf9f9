"""The port's BatchNorm recalibration, per-target metrics and serving
selection (cfgan_torch.train.builders, .selection, cfgan_torch.eval.
metrics) against the JAX package's, on the CPU.

Width 8, one residual block, float32, the reference recipe with the
generator EMA; EMA parameters made distinct from the live ones.

- `recal_fn` under both mask modes, 6 steps at batch 16 on the draws
  re-derived from the JAX recalibrator's key (per step `ki, kt, km, kg =
  split(k, 4)`): the recalibrated running statistics within 1e-5.
- `per_target_metrics` (all-ones masks, a ragged last batch) on the same
  generator variables and classifier: every column within 1e-5.
- `lex_margins` and `SnapshotSelector` on scripted scores: the same
  ladder and the same chosen snapshot.
- Recalibration leaves the live generator's parameters and statistics
  untouched, and EMA parameters are never served with live statistics.
- Served variables are copies: an engine serves the same after a further
  train step, and the variables handed out stay as they were.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgan.eval.metrics import make_per_target_sweep as jax_sweep
from cfgan.eval.metrics import per_target_metrics as jax_ptm
from cfgan.models.classifiers import CNNClassifier as JaxClassifier
from cfgan.train.builders import build_mnist_countergan as jax_build
from cfgan.train.selection import SnapshotSelector as JaxSelector
from cfgan.train.selection import lex_margins as jax_lex_margins
from cfgan.train.state import NetState as JaxNetState
from cfgan.train.state import adam_like_torch as jax_adam
from cfgan_torch.convert import (
    flax_from_state_dict,
    load_gan_state,
    state_dict_from_flax,
)
from cfgan_torch.eval.metrics import make_per_target_sweep, per_target_metrics
from cfgan_torch.models.classifiers import CNNClassifier
from cfgan_torch.train.builders import (
    build_mnist_countergan,
    g_serving_variables,
    live_g_variables,
    mnist_engine,
    select_g_serving_variables,
    serving_candidates,
)
from cfgan_torch.train.selection import SnapshotSelector, lex_margins

from test_torch_step import _configs, _jax_trees, assert_trees_close

N, RECAL_STEPS, RECAL_B = 40, 6, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU run shares its cores with other test workers: one torch
    thread keeps this file's many small eager ops from oversubscribing
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(seed=0, n=N):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (n, 28, 28, 1)).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int32))


@pytest.fixture(scope="module")
def pair():
    """(JAX bundle and its state with a distinct EMA, classifier
    variables; the port bundle on the same state, its classifier)."""
    jcfg, pcfg = _configs(ema_decay=0.999)
    clf_model = JaxClassifier()
    clf_vars = jax.tree_util.tree_map(np.asarray, dict(clf_model.init(
        jax.random.key(1), jnp.zeros((2, 28, 28, 1)), train=False)))
    bundle = jax_build(jcfg, clf_model,
                       JaxNetState.create(clf_vars, jax_adam(1e-3)), seed=7)
    ema = jax.tree_util.tree_map(lambda p: p * 1.1 + 0.01,
                                 bundle.state.g.params)
    state = bundle.state.replace(g_ema=ema)
    clf = CNNClassifier()
    clf.load_state_dict(state_dict_from_flax(clf, clf_vars))
    port = build_mnist_countergan(pcfg, clf.state_dict(), device="cpu")
    load_gan_state(port.state, _jax_trees(state))
    return bundle, state, clf_model, clf_vars, port, clf.eval()


def _recal_draws(key, n, mask_mode):
    idx, targets, scores = [], [], []
    for k in jax.random.split(key, RECAL_STEPS):
        ki, kt, km, _ = jax.random.split(k, 4)
        idx.append(np.asarray(jax.random.randint(ki, (RECAL_B,), 0, n)))
        targets.append(np.asarray(jax.random.randint(kt, (RECAL_B,), 0, 10)))
        scores.append(np.asarray(jax.random.uniform(km, (RECAL_B, 16))))
    return {"idx": torch.tensor(np.stack(idx)).long(),
            "targets": torch.tensor(np.stack(targets)).long(),
            "mask": torch.tensor(np.stack(scores))}


@pytest.mark.parametrize("mask_mode", ["train", "ones"])
def test_recal_fn_matches_jax_on_its_draws(pair, mask_mode):
    bundle, state, _, _, port, _ = pair
    x, _ = _x(1)
    key = jax.random.key(9)
    want = bundle.recal_fn(state.g_ema, dict(state.g.stats), jnp.asarray(x),
                           key, steps=RECAL_STEPS, batch_size=RECAL_B,
                           mask_mode=mask_mode)
    g = port.state.g.model
    live = {k: v.clone() for k, v in g.state_dict().items()}
    stats = dict(g.named_buffers())
    got = port.recal_fn(port.state.g_ema, stats, torch.from_numpy(x),
                        draws=_recal_draws(key, N, mask_mode),
                        mask_mode=mask_mode)
    assert got.keys() == stats.keys()
    got_tree = flax_from_state_dict(g, got)["batch_stats"]
    want_tree = jax.tree_util.tree_map(np.asarray, dict(want)["batch_stats"])
    assert_trees_close(got_tree, want_tree, 1e-5)
    # they moved: the EMA parameters' statistics are not the live ones
    assert_trees_close(got_tree, jax.tree_util.tree_map(
        lambda a: a + 1.0, want_tree), 2.0)
    assert any(not torch.equal(got[k], live[k]) for k in got)
    # the live generator is untouched
    for k, v in g.state_dict().items():
        assert torch.equal(v, live[k]), k


def test_per_target_metrics_match_jax(pair):
    bundle, state, clf_model, clf_vars, port, clf = pair
    x, y = _x(2)
    gv_jax = {"params": state.g_ema, **state.g.stats}
    jsweep = jax_sweep(
        bundle.cf_fn, lambda a: clf_model.apply(clf_vars, a, train=False),
        10, exclude_same_class=False,
        pred_gain_mode="cf_target_minus_cf_true",
        actionability_mode="x_cf_minus_x")
    want = jax_ptm(jsweep, gv_jax, x, y,
                   mask_fn=lambda b: jnp.ones((b, 28, 28, 1), jnp.float32),
                   key=jax.random.key(0), num_classes=10, batch_size=16)
    psweep = make_per_target_sweep(
        port.cf_fn, clf, 10, exclude_same_class=False,
        pred_gain_mode="cf_target_minus_cf_true",
        actionability_mode="x_cf_minus_x")
    gv = {**port.state.g_ema, **dict(port.state.g.model.named_buffers())}
    got = per_target_metrics(psweep, gv, x, y,
                             mask_fn=lambda b: torch.ones((b, 28, 28, 1)),
                             num_classes=10, batch_size=16)
    assert list(got) == list(want.columns)
    for col in want.columns:
        np.testing.assert_allclose(got[col], want[col].to_numpy(),
                                   atol=1e-5, rtol=0, err_msg=col)


def test_lex_margins_match_jax():
    rng = np.random.RandomState(0)
    for _ in range(5):
        flips, ref = rng.uniform(size=10), rng.uniform(size=10)
        assert lex_margins(flips, ref) == jax_lex_margins(flips, ref)
    # the worst margin decides first
    assert lex_margins([1.0, 0.5], [1.0, 1.0]) < lex_margins([0.9, 0.9],
                                                             [1.0, 1.0])


def test_snapshot_selector_matches_jax_on_scripted_scores(pair, monkeypatch):
    """Rungs every 2 of 5 epochs (2, 4 and the last, 5), three candidates
    a rung; the scripted scores make the EMA candidate of epoch 4 the
    best, ties with a later rung keep the earlier one.  The scores ignore
    the candidates, so both recalibrations run 4 steps at batch 16."""
    from dataclasses import replace as dc_replace
    from functools import partial

    import cfgan_torch.train.builders as pbuilders

    bundle, state, _, _, port, _ = pair
    bundle = dc_replace(bundle, recal_fn=partial(bundle.recal_fn, steps=4,
                                                 batch_size=16))
    monkeypatch.setattr(pbuilders, "RECAL_STEPS", 4)
    monkeypatch.setattr(pbuilders, "RECAL_BATCH", 16)
    scores = [(0.2, 0.5), (0.3, 0.1), (0.1, 0.9),
              (0.6, 0.2), (0.6, 0.7), (0.5, 0.9),
              (0.6, 0.7), (0.1, 0.1), (0.0, 0.0)]
    x, _ = _x(3)

    def scripted():
        it = iter(scores)
        return lambda gv: next(it)

    jsel = JaxSelector(bundle, score_fn=scripted(), every=2, total_epochs=5,
                       x_recal=x, recal_key=jax.random.key(2))
    psel = SnapshotSelector(port, score_fn=scripted(), every=2,
                            total_epochs=5, x_recal=torch.from_numpy(x),
                            recal_seed=2)
    for epoch in range(1, 6):
        jsel.epoch_cb(epoch, state)
        psel.epoch_cb(epoch, port.state)
    _, jinfo = jsel.best()
    gv, pinfo = psel.best()
    assert pinfo == jinfo
    assert pinfo["candidate"] == "snapshot_e4_ema_recal_train"
    assert [r["epoch"] for r in pinfo["ladder"]] == [2] * 3 + [4] * 3 + [5] * 3
    # the kept snapshot holds the EMA parameters, as a copy
    assert all(torch.equal(gv[k], v) for k, v in port.state.g_ema.items())
    assert all(gv[k] is not v for k, v in port.state.g_ema.items())


def test_selector_without_recal_data_scores_the_live_generator_only(pair):
    _, _, _, _, port, _ = pair
    calls = itertools.count()
    sel = SnapshotSelector(port, score_fn=lambda gv: (next(calls),),
                           every=1, total_epochs=2)
    sel.epoch_cb(1, port.state)
    sel.epoch_cb(2, port.state)
    _, info = sel.best()
    assert [r["candidate"] for r in info["ladder"]] == ["live", "live"]
    assert info["candidate"] == "snapshot_e2_live"


def test_ema_parameters_never_serve_with_live_statistics(pair):
    _, _, _, _, port, clf = pair
    with pytest.raises(ValueError, match="EMA"):
        mnist_engine(port, clf, device="cpu")
    x, y = _x(4)
    gen = torch.Generator().manual_seed(0)
    gv = g_serving_variables(port, port.state, torch.from_numpy(x), gen)
    live = live_g_variables(port.state)
    assert gv.keys() == live.keys()
    assert all(torch.equal(gv[k], v) for k, v in port.state.g_ema.items())
    assert any(not torch.equal(gv[k], live[k]) for k in gv
               if "running" in k)
    res = mnist_engine(port, clf, g_variables=gv, device="cpu").generate(
        x[:3], [1, 2, 3])
    assert res.x_cf.shape == (3, 28, 28, 1) and np.isfinite(res.x_cf).all()


def test_select_g_serving_variables_takes_the_best_candidate(pair):
    _, _, _, _, port, clf = pair
    x, y = _x(5)
    gv, info = select_g_serving_variables(
        port, port.state, torch.from_numpy(x), 3, x[:20], y[:20], clf)
    assert set(info["scores"]) == {"live", "ema_recal_train",
                                   "ema_recal_ones"}
    best = max(info["scores"], key=lambda n: (info["scores"][n]["worst_flip"],
                                              info["scores"][n]["mean_flip"]))
    assert info["candidate"] == best
    params = dict(port.state.g.model.named_parameters())
    want = port.state.g_ema if best != "live" else params
    assert all(torch.equal(gv[k], want[k]) for k in params)


@pytest.mark.parametrize("ema", [False, True], ids=["live", "ema"])
def test_served_variables_do_not_follow_further_training(ema):
    """Serve, take one `step_fn`, serve again: the engine serves what it
    served before.  The step updates the parameters (Adam), the BatchNorm
    statistics and the EMA in place; the variables handed to an engine, a
    selector or a checkpoint are copies, as the JAX package's immutable
    arrays are."""
    _, pcfg = _configs(ema_decay=0.9 if ema else 0.0)
    clf = CNNClassifier(generator=torch.Generator().manual_seed(1)).eval()
    port = build_mnist_countergan(pcfg, clf.state_dict(), device="cpu")
    x, y = _x(6, n=16)
    xt = torch.from_numpy(x)
    gv = (g_serving_variables(port, port.state, xt,
                              torch.Generator().manual_seed(0))
          if ema else None)
    engine = mnist_engine(port, clf, g_variables=gv, device="cpu")
    handed = {"live": live_g_variables(port.state),
              **dict(serving_candidates(port, port.state, xt, 3))}
    kept = {n: {k: v.clone() for k, v in vs.items()}
            for n, vs in handed.items()}
    before = engine.generate(x[:4], [1, 2, 3, 4])
    port.step_fn(port.state, xt, torch.from_numpy(y).long(),
                 torch.Generator().manual_seed(1))
    after = engine.generate(x[:4], [1, 2, 3, 4])
    np.testing.assert_array_equal(after.x_cf, before.x_cf)
    np.testing.assert_array_equal(after.probs, before.probs)
    for name, vs in handed.items():
        assert all(torch.equal(v, kept[name][k]) for k, v in vs.items()), name
    # the step did move what the engine was built from
    live_now = live_g_variables(port.state)
    assert any(not torch.equal(live_now[k], kept["live"][k])
               for k in live_now)
    if ema:
        assert any(not torch.equal(v, gv[k])
                   for k, v in port.state.g_ema.items())
