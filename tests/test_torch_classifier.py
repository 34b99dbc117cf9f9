"""The port's classifier pretrain and evaluation (cfgan_torch.train.
classifier, cfgan_torch.eval.classifier) against the JAX package's, on
the CPU.

- One train step of the CNN classifier from the same weights and batch,
  on JAX's dropout masks (read from the flax model's captured `Dropout_0`
  and `Dropout_1` outputs: both follow a ReLU, so where an output is 0
  the mask changes neither the value nor the gradient).  Bars (f32): loss
  1e-5 abs; Adam's first moments (0.1 x the gradient) leaf by leaf within
  5e-5 of their 2-norm plus 1e-9; parameters 2e-6 abs after the step
  where the gradient exceeds 1e-6, and within the step's lr elsewhere:
  there the gradient is within a few hundred times Adam's eps (1e-8) and
  its float32 rounding moves the first update (measured up to 1.7e-5).
  Adam moves each parameter by about lr = 1e-3, so the parameter bar
  alone would pass any gradient; the moments carry that check.
- The epoch regime's bookkeeping on a scripted validation-accuracy
  sequence against `train_classifier`: the same accuracies logged, the
  plateau and early-stop lines at the same epochs, and the same best
  epoch snapshotted.
- Accuracy, confusion matrix and per-class report against scikit-learn,
  and the CSV and report files against the JAX package's.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfgan.train.classifier as jcl
import cfgan_torch.train.classifier as pcl
from cfgan.core.config import ClassifierConfig as JaxClfConfig
from cfgan.eval.classifier import evaluate_classifier as jax_evaluate
from cfgan.models.classifiers import CNNClassifier as JaxCNN
from cfgan.train.state import NetState as JaxNetState
from cfgan.train.state import adam_like_torch as jax_adam
from cfgan_torch.convert import flax_from_state_dict, state_dict_from_flax
from cfgan_torch.core.config import ClassifierConfig
from cfgan_torch.eval.classifier import evaluate_classifier
from cfgan_torch.models.classifiers import CNNClassifier
from cfgan_torch.train.state import NetState


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU run shares its cores with other test workers: one torch
    thread keeps this file's many small eager ops from oversubscribing
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B = 16


def _batch(seed=0, n=B):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (n, 28, 28, 1)).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int32))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


@pytest.fixture(scope="module")
def jax_step():
    model = JaxCNN()
    variables = jax.tree_util.tree_map(np.asarray, dict(
        model.init(jax.random.key(1), jnp.zeros((2, 28, 28, 1)))))
    tx = jax_adam(1e-3)
    return model, variables, tx, jax.jit(jcl.make_classifier_step(model, tx))


@pytest.mark.parametrize("lr_scale", [1.0, 0.1])
def test_classifier_step_matches_jax_on_its_dropout_masks(jax_step,
                                                          lr_scale):
    model, variables, tx, step = jax_step
    x, y = _batch()
    key = jax.random.key(5)
    _, inter = model.apply(variables, jnp.asarray(x), train=True,
                           rngs={"dropout": key}, capture_intermediates=True,
                           mutable=["intermediates"])
    out2d = np.asarray(inter["intermediates"]["Dropout_0"]["__call__"][0])
    out = np.asarray(inter["intermediates"]["Dropout_1"]["__call__"][0])
    keep = (torch.from_numpy((out2d != 0).any(axis=(1, 2), keepdims=True)),
            torch.from_numpy(out != 0))
    state, loss = step(JaxNetState.create(variables, tx), jnp.asarray(x),
                       jnp.asarray(y), key, lr_scale)

    port = CNNClassifier()
    port.load_state_dict(state_dict_from_flax(port, variables))
    ns = NetState.create(port, 1e-3)
    got = pcl.make_classifier_step(ns)(
        torch.from_numpy(x), torch.from_numpy(y).long(), keep=keep,
        lr_scale=lr_scale)
    assert abs(float(got) - float(loss)) <= 1e-5
    mu = {name: ns.opt.state[p]["exp_avg"]
          for name, p in port.named_parameters()}
    got_mu = dict(_leaves(flax_from_state_dict(port, mu)["params"]))
    want_mu = dict(_leaves(state.opt_state[0].mu))
    assert got_mu.keys() == want_mu.keys()
    for k, w in want_mu.items():
        err = np.linalg.norm(got_mu[k] - w)
        assert err <= 5e-5 * np.linalg.norm(w) + 1e-9, (k, err)
    got_p = dict(_leaves(flax_from_state_dict(port, port.state_dict())))
    for k, w in _leaves({"params": state.params}):
        err = np.abs(got_p[k] - w)
        small = np.abs(want_mu[k.replace("params/", "", 1)]) <= 1e-7
        assert err[~small].max(initial=0.0) <= 2e-6, k
        assert err[small].max(initial=0.0) <= 1e-3 * lr_scale, k


def test_dropout_draws_come_from_the_generator():
    """Train mode without keep masks draws from the generator: the same
    seed gives the same logits, another seed others."""
    x, _ = _batch(1)
    m = CNNClassifier(generator=torch.Generator().manual_seed(0)).train()

    def logits(seed):
        return m(torch.from_numpy(x), torch.Generator().manual_seed(seed))

    assert torch.equal(logits(3), logits(3))
    assert not torch.equal(logits(3), logits(4))
    with pytest.raises(ValueError):
        m(torch.from_numpy(x))


SCRIPTS = {
    # improves at epoch 2, then ten flat epochs (the plateau at epoch 12)
    # and two more: early stop at epoch 14 (patience 12)
    "plateau_then_stop": [0.5, 0.7] + [0.6] * 13,
    # improves at epochs 1, 3 and 5; ties do not count as improvements
    "late_best": [0.5, 0.4, 0.6, 0.6, 0.7, 0.7],
}


def _scripted(values, seen):
    it = iter(values)

    def accuracy(*args):
        seen.append(args)
        return next(it)

    return accuracy


def _strip_losses(lines):
    return [re.sub(r"loss \d+\.\d+", "loss L", ln) for ln in lines]


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_epoch_bookkeeping_matches_jax_on_scripted_accuracies(monkeypatch,
                                                              script):
    values = SCRIPTS[script]
    fields = dict(arch="cnn", lr=1e-3, epochs=len(values), batch_size=32,
                  lr_plateau=True, early_stop_patience=12)
    x, y = _batch(2, 64)
    valid = _batch(3, 8)

    jax_seen, jax_log = [], []
    scripted = _scripted(values, [])

    def jax_accuracy(state, xv, yv):
        # the next epoch donates this state: keep a host copy
        jax_seen.append(jax.tree_util.tree_map(np.asarray, state.params))
        return scripted(xv, yv)

    monkeypatch.setattr(jcl, "make_eval_fn", lambda model: (
        None, jax_accuracy))
    jax_best, jax_hist = jcl.train_classifier(
        JaxCNN(), JaxClfConfig(**fields), (x, y), valid, seed=0,
        num_classes=10, log=jax_log.append)
    # which epoch's state did JAX keep?
    jax_best_epoch = [all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(s),
        jax.tree_util.tree_leaves(jax_best.params)))
        for s in jax_seen].index(True) + 1

    port_log, port_snaps = [], []

    def port_eval_fn(model):
        scripted = _scripted(values, [])

        def accuracy(xv, yv):
            port_snaps.append({k: v.clone()
                               for k, v in model.state_dict().items()})
            return scripted(xv, yv)

        return None, accuracy

    monkeypatch.setattr(pcl, "make_eval_fn", port_eval_fn)
    model = CNNClassifier(generator=torch.Generator().manual_seed(0))
    ns, port_hist = pcl.train_classifier(
        model, ClassifierConfig(**fields), (x, y), valid, seed=0,
        num_classes=10, log=port_log.append, device="cpu")
    port_best_epoch = [all(torch.equal(v, model.state_dict()[k])
                           for k, v in s.items())
                       for s in port_snaps].index(True) + 1

    assert _strip_losses(port_log) == _strip_losses(jax_log)
    assert port_hist["val_acc"] == jax_hist["val_acc"]
    assert len(port_hist["loss"]) == len(jax_hist["loss"])
    assert port_best_epoch == jax_best_epoch
    plateaued = any("plateau" in ln for ln in port_log)
    assert ns.opt.param_groups[0]["lr"] == pytest.approx(
        1e-4 if plateaued else 1e-3)


def test_evaluate_classifier_matches_sklearn_and_jax_files(tmp_path):
    from sklearn.metrics import classification_report, confusion_matrix

    rng = np.random.RandomState(4)
    n = 300
    x = rng.randn(n, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 10, n)
    logits = rng.randn(n, 10).astype(np.float32)
    logits[np.arange(n), y] += rng.uniform(0, 3, n).astype(np.float32)
    table = torch.from_numpy(logits)

    def port_logits(xb):  # rows of x are told apart by their first pixel
        idx = torch.as_tensor(np.searchsorted(np.sort(x[:, 0, 0, 0]),
                                              xb[:, 0, 0, 0].numpy()))
        return table[torch.as_tensor(np.argsort(x[:, 0, 0, 0]))[idx]]

    got = evaluate_classifier(port_logits, x, y, out_dir=str(tmp_path / "p"),
                              device="cpu")
    preds = logits.argmax(1)
    assert got["accuracy"] == float((preds == y).mean())
    assert np.array_equal(got["confusion"], confusion_matrix(y, preds))
    assert got["report"] == classification_report(
        y, preds, output_dict=True, zero_division=0)

    class State:
        params, stats = None, None

    want = jax_evaluate(lambda p, s, xb: jnp.asarray(logits), State(), x, y,
                        out_dir=str(tmp_path / "j"))
    assert want["accuracy"] == got["accuracy"]
    for name in ("confusion_matrix.csv", "classifier_report.txt"):
        assert ((tmp_path / "p" / name).read_text()
                == (tmp_path / "j" / name).read_text()), name


def test_train_classifier_is_reproducible_and_learns():
    """Same seed, same weights (the permutation and the dropout draws come
    from seeded generators); the loss falls on a learnable toy set."""
    x, y = _batch(5, 64)
    x[np.arange(64), y, 0, 0] = 3.0  # the label written into the image
    cfg = ClassifierConfig(arch="cnn", lr=3e-3, epochs=4, batch_size=16)

    def train():
        model = CNNClassifier(generator=torch.Generator().manual_seed(0))
        _, hist = pcl.train_classifier(model, cfg, (x, y), (x, y), seed=1,
                                       log=lambda s: None, device="cpu")
        return model, hist

    (m1, h1), (m2, h2) = train(), train()
    assert h1 == h2
    for a, b in zip(m1.state_dict().values(), m2.state_dict().values()):
        assert torch.equal(a, b)
    assert h1["loss"][-1] < h1["loss"][0]
