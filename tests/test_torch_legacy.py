"""The legacy MNIST stack on the port against the JAX package, on the CPU:
`max_pool2d`, `LegacyCNNClassifier`, `ConvDiscriminator` and
`DeltaImageGenerator` against the flax modules on the same weights
(carried across by cfgan_torch.convert, both ways); one legacy step of
`build_mnist_countergan(legacy_delta=True)` against JAX's; the
experiment's `run(legacy_delta=True)` and `mnist_countergan2.main` at
width 8 on the 120-image IDX fixture, whose run dirs the JAX package
restores and which restore JAX's; the PNG grids against JAX's
`to_uint8_grid`.

Width 8, batch 8, float32, inputs from numpy seeds.  Bars: module
outputs and BatchNorm statistics 3e-5 abs (the two sum in other orders);
the step as tests/test_torch_step.py holds the residual family's (d_loss
and every diagnostic 3e-5, g_loss 3e-4: a sum of five terms of up to
~10 in float32; parameters 3e-5; the gradients through Adam's first
moments, leaf by leaf within 5e-5 of their 2-norm plus 1e-8).
"""
import json
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgan.core import checkpoint as jck
from cfgan.eval.samples import to_uint8_grid as jax_to_uint8_grid
from cfgan.experiments import presets as jax_presets
from cfgan.models.classifiers import LegacyCNNClassifier as JaxLegacyCNN
from cfgan.models.discriminators import ConvDiscriminator as JaxConvD
from cfgan.models.generators import DeltaImageGenerator as JaxDeltaG
from cfgan.nn.layers import max_pool2d as jax_max_pool2d
from cfgan.train.builders import build_mnist_countergan as jax_build
from cfgan.train.state import NetState as JaxNetState
from cfgan.train.state import adam_like_torch as jax_adam
import cfgan_torch.experiments.mnist_countergan as exp
import cfgan_torch.experiments.mnist_countergan2 as exp2
from cfgan_torch.convert import (
    adam_moments_to_flax,
    flax_from_state_dict,
    gan_state_to_flax,
    load_gan_state,
    state_dict_from_flax,
)
from cfgan_torch.experiments.presets import (
    MNIST_COUNTERGAN2,
    MNIST_COUNTERGAN_LEGACY,
)
from cfgan_torch.models.classifiers import LegacyCNNClassifier
from cfgan_torch.models.discriminators import ConvDiscriminator
from cfgan_torch.models.generators import DeltaImageGenerator
from cfgan_torch.nn.layers import max_pool2d
from cfgan_torch.ops.epilogue import cf_epilogue
from cfgan_torch.train.builders import build_mnist_countergan

from test_torch_figure import figure_set, jax_figure_set
from test_torch_step import (
    MU_ATOL,
    MU_RTOL,
    assert_moments_close,
    assert_trees_close,
    leaves,
)

B, WIDTH, ATOL = 8, 8, 3e-5
FIXTURE = str(Path(__file__).resolve().parent / "fixtures" / "mnist_idx")
DIAGNOSTICS = ("g_adv", "g_cls", "reg_l1", "reg_l2", "mask_penalty",
               "d_real_p", "d_fake_p", "residual_mean", "flip_rate",
               "pred_gain")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU run shares its cores with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(seed, b=B, hw=(28, 28)):
    rng = np.random.RandomState(seed)
    return rng.uniform(-1, 1, (b, *hw, 1)).astype(np.float32)


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def _with_random_stats(variables, seed):
    """`variables` with random BatchNorm running statistics, so that eval
    mode reads something other than the init's zeros and ones."""
    rng = np.random.RandomState(seed)
    out = _np(dict(variables))
    out["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        out["batch_stats"])
    return out


@pytest.mark.parametrize("shape", [(2, 28, 28, 3), (3, 7, 9, 2),
                                   (1, 14, 14, 5)])
def test_max_pool2d_matches_jax(shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = jax_max_pool2d(jnp.asarray(x))
    got = max_pool2d(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_legacy_classifier_matches_flax():
    flax_model = JaxLegacyCNN()
    x = _images(1)
    variables = _np(dict(flax_model.init(jax.random.key(0), jnp.asarray(x))))
    model = LegacyCNNClassifier()
    model.load_state_dict(state_dict_from_flax(model, variables))
    want = flax_model.apply(variables, jnp.asarray(x), train=False)
    model.eval()
    _close(model(torch.from_numpy(x)), want)
    # no dropout: train mode, with the classifier trainer's arguments,
    # gives the same logits
    model.train()
    _close(model(torch.from_numpy(x), torch.Generator(), None), want)


def test_conv_discriminator_matches_flax():
    flax_model = JaxConvD(d_hidden=WIDTH)
    x = _images(2)
    t = jnp.arange(B) % 10
    variables = _np(dict(flax_model.init(jax.random.key(0), jnp.asarray(x),
                                         t)))
    model = ConvDiscriminator(WIDTH)
    model.load_state_dict(state_dict_from_flax(model, variables))
    want = flax_model.apply(variables, jnp.asarray(x), t)
    got = model(torch.from_numpy(x), torch.from_numpy(np.asarray(t)))
    assert got.shape == (B, 1)
    _close(got, want)
    # the condition is ignored
    _close(model(torch.from_numpy(x)), want)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_delta_generator_matches_flax(train):
    flax_model = JaxDeltaG(base_ch=WIDTH)
    x = _images(3)
    t = jnp.asarray(np.random.RandomState(3).randint(0, 10, B))
    variables = _with_random_stats(flax_model.init(
        jax.random.key(0), jnp.asarray(x), t, jnp.ones_like(x)), 4)
    model = DeltaImageGenerator(base_ch=WIDTH)
    model.load_state_dict(state_dict_from_flax(model, variables))
    model.train(train)
    mask = torch.from_numpy(
        (np.random.RandomState(5).rand(*x.shape) > 0.5).astype(np.float32))
    delta, masked = model(torch.from_numpy(x), torch.from_numpy(
        np.asarray(t)).long(), mask)
    if train:
        (want, want_masked), new = flax_model.apply(
            variables, jnp.asarray(x), t, jnp.asarray(mask.numpy()),
            train=True, mutable=["batch_stats"])
        got_stats = flax_from_state_dict(model, dict(model.named_buffers()))
        assert_trees_close(got_stats["batch_stats"],
                           _np(new["batch_stats"]), ATOL)
    else:
        want, want_masked = flax_model.apply(
            variables, jnp.asarray(x), t, jnp.asarray(mask.numpy()),
            train=False)
    _close(delta, want)
    # no mask in this family: the masked output is the raw delta
    assert masked is delta
    np.testing.assert_array_equal(np.asarray(want_masked), np.asarray(want))


@pytest.mark.parametrize("which", ["classifier", "discriminator",
                                   "generator"])
def test_weights_carry_both_ways(which):
    x = jnp.asarray(_images(6))
    t = jnp.arange(B) % 10
    flax_model, module, args = {
        "classifier": (JaxLegacyCNN(), LegacyCNNClassifier(), (x,)),
        "discriminator": (JaxConvD(d_hidden=WIDTH), ConvDiscriminator(WIDTH),
                          (x, t)),
        "generator": (JaxDeltaG(base_ch=WIDTH),
                      DeltaImageGenerator(base_ch=WIDTH), (x, t, x)),
    }[which]
    variables = _np(dict(flax_model.init(jax.random.key(9), *args)))
    sd = state_dict_from_flax(module, variables)
    assert all(v.is_contiguous() for v in sd.values())
    module.load_state_dict(sd)
    back = flax_from_state_dict(module, module.state_dict())
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ the step
def _legacy_configs():
    jcfg = replace(jax_presets.MNIST_COUNTERGAN_LEGACY.countergan,
                   hidden_dim=WIDTH)
    pcfg = replace(MNIST_COUNTERGAN_LEGACY.countergan, hidden_dim=WIDTH)
    return jcfg, pcfg


def _jax_d_moments(d_vars, x, x_cf, beta1):
    """Adam's first moments after one step of the legacy D update from
    `d_vars` on the real batch `x` and the fakes `x_cf`: (1 - beta1) times
    the gradient of the clipped-log loss, real and fake in one pass."""
    from cfgan.losses import gan as jax_gan_losses

    jd = JaxConvD(d_hidden=WIDTH)
    xx = jnp.concatenate([jnp.asarray(x), jnp.asarray(x_cf)])

    def loss(params):
        real, fake = jnp.split(jd.apply({"params": params}, xx), 2)
        return jax_gan_losses.d_loss_nonsaturating(
            jax.nn.sigmoid(real), jax.nn.sigmoid(fake), eps=1e-6)

    grad = jax.grad(loss)(d_vars["params"])
    return _np(jax.tree_util.tree_map(lambda g: (1 - beta1) * g, grad))


@pytest.fixture(scope="module")
def legacy_step():
    """One step of both packages' legacy builders from one JAX initial
    state on one batch; the port's draws come from its own `draw_fn`
    (fixed target, all-ones mask: nothing random reaches the step).

    Also JAX's D moments of that step recomputed at each package's
    counterfactuals of the step, from the initial D: "at_jax_cf" (JAX's
    generator) and "at_port_cf" (the port's, the step's generator forward
    run on its own before the step)."""
    jcfg, pcfg = _legacy_configs()
    clf_model = JaxLegacyCNN()
    clf_vars = _np(dict(clf_model.init(jax.random.key(1),
                                       jnp.zeros((2, 28, 28, 1)))))
    bundle = jax_build(jcfg, clf_model,
                       JaxNetState.create(clf_vars, jax_adam(1e-3)), seed=7,
                       legacy_delta=True)
    port = build_mnist_countergan(
        pcfg, state_dict_from_flax(LegacyCNNClassifier(), clf_vars),
        device="cpu", legacy_delta=True)
    load_gan_state(port.state, _np({"g": bundle.state.g.variables(),
                                    "d": bundle.state.d.variables(),
                                    "g_ema": bundle.state.g_ema}))
    x = _images(11)
    y = np.random.RandomState(11).randint(0, 10, B).astype(np.int32)
    lo, hi = pcfg.clamp_cf
    t = np.full((B,), pcfg.fixed_target)
    (delta, _), _ = JaxDeltaG(base_ch=WIDTH).apply(
        bundle.state.g.variables(), jnp.asarray(x), jnp.asarray(t), None,
        train=True, mutable=["batch_stats"])
    with torch.no_grad():
        raw, _ = port.state.g.model(torch.from_numpy(x), torch.from_numpy(t),
                                    update_stats=False)
        port_cf = cf_epilogue(torch.from_numpy(x), raw, torch.ones_like(raw),
                              lo, hi)[0]
    d0 = _np(bundle.state.d.variables())
    beta1 = port.state.d.opt.param_groups[0]["betas"][0]
    witness = {"at_jax_cf": _jax_d_moments(d0, x, jnp.clip(x + delta, lo, hi),
                                           beta1),
               "at_port_cf": _jax_d_moments(d0, x, port_cf.numpy(), beta1)}
    state, jm = jax.jit(bundle.step_fn)(bundle.state, jnp.asarray(x),
                                        jnp.asarray(y), jax.random.key(3))
    draws = port.draw_fn(torch.Generator().manual_seed(0), (B,))
    pm = port.step_from_draws(port.state, torch.from_numpy(x),
                              torch.from_numpy(y).long(), draws)
    jt = _np({"g": state.g.variables(), "d": state.d.variables(),
              "adam_mu": {n: getattr(state, n).opt_state[0].mu
                          for n in ("g", "d")}})
    pt = {**gan_state_to_flax(port.state),
          "adam_mu": adam_moments_to_flax(port.state)}
    return ({k: float(v) for k, v in jm.items()},
            {k: float(v) for k, v in pm.items()}, jt, pt, draws, witness)


def test_legacy_draws_hold_no_mask(legacy_step):
    *_, draws, _ = legacy_step
    assert set(draws) == {"targets"}


def test_legacy_step_losses_and_diagnostics_match_jax(legacy_step):
    jm, pm, *_ = legacy_step
    assert pm.keys() == jm.keys() == {"d_loss", "g_loss", *DIAGNOSTICS}
    assert abs(pm["g_loss"] - jm["g_loss"]) <= 3e-4
    for name in ("d_loss", *DIAGNOSTICS):
        assert abs(pm[name] - jm[name]) <= ATOL, name
    # the fixed target: every counterfactual aims at class 5; no mask term
    assert pm["mask_penalty"] == 0.0


# D's first conv reads the counterfactuals themselves, and its gradient
# is the small difference of the real and the fake batches' (~5e-3 of
# its norm): the two packages' deltas differ by float32 rounding (3.6e-6
# at most, through the generator's BatchNorms), and that moves this
# leaf's gradient by ~1% in JAX's own D as well.  So its bar is that
# shift (JAX's moments at the port's counterfactuals against JAX's at
# its own) plus the usual one; at the same counterfactuals every leaf,
# this one too, is held at the usual bar
# (test_legacy_step_d_moments_at_the_port_counterfactuals).
FIRST_CONV = "conv0/"


@pytest.mark.parametrize("net", ["g", "d"])
def test_legacy_step_parameters_and_gradients_match_jax(legacy_step, net):
    _, _, jt, pt, _, witness = legacy_step
    assert_trees_close(pt[net]["params"], jt[net]["params"], ATOL)
    first = (lambda k: net == "d" and k.startswith(FIRST_CONV))  # noqa: E731
    assert_moments_close(pt["adam_mu"][net], jt["adam_mu"][net], skip=first)
    if net == "d":
        got, want = (dict(leaves(pt["adam_mu"]["d"])),
                     dict(leaves(jt["adam_mu"]["d"])))
        at_jax, at_port = (dict(leaves(witness["at_jax_cf"])),
                           dict(leaves(witness["at_port_cf"])))
        firsts = [k for k in want if first(k)]
        assert len(firsts) == 2
        for k in firsts:
            # the shift itself is rounding-sized (measured ~1%), so the
            # bar cannot grow past what rounding explains
            shift = np.linalg.norm(at_port[k] - at_jax[k])
            assert shift <= 0.05 * np.linalg.norm(want[k]), k
            assert (np.linalg.norm(got[k] - want[k])
                    <= shift + MU_RTOL * np.linalg.norm(want[k]) + MU_ATOL), k


def test_legacy_step_d_moments_at_the_port_counterfactuals(legacy_step):
    """The port step's D moments equal JAX's D moments at the port step's
    counterfactuals, every leaf at the usual bar: what sets the first
    conv apart above is the counterfactuals' rounding, not the D phase.
    JAX's moments recomputed at its own counterfactuals are its step's."""
    _, _, jt, pt, _, witness = legacy_step
    assert_moments_close(witness["at_jax_cf"], jt["adam_mu"]["d"])
    assert_moments_close(pt["adam_mu"]["d"], witness["at_port_cf"])


def test_legacy_d_gradient_at_jax_counterfactuals():
    """The legacy D update's gradient (clipped-log loss on real and fake
    in one pass) at JAX's counterfactuals equals JAX's, every leaf."""
    from cfgan.losses import gan as jax_gan_losses

    from cfgan_torch.losses import gan as gan_losses

    x = _images(13)
    t = jnp.full((B,), 5)
    g_vars = _np(dict(JaxDeltaG(base_ch=WIDTH).init(
        jax.random.key(2), jnp.asarray(x), t, None)))
    (delta, _), _ = JaxDeltaG(base_ch=WIDTH).apply(
        g_vars, jnp.asarray(x), t, None, train=True, mutable=["batch_stats"])
    x_cf = jnp.clip(jnp.asarray(x) + delta, -1.0, 1.0)
    xx = jnp.concatenate([jnp.asarray(x), x_cf])
    jd = JaxConvD(d_hidden=WIDTH)
    d_vars = _np(dict(jd.init(jax.random.key(3), xx)))

    def loss(params):
        real, fake = jnp.split(jd.apply({"params": params}, xx), 2)
        return jax_gan_losses.d_loss_nonsaturating(
            jax.nn.sigmoid(real), jax.nn.sigmoid(fake), eps=1e-6)

    want = _np(jax.grad(loss)(d_vars["params"]))
    d = ConvDiscriminator(WIDTH)
    d.load_state_dict(state_dict_from_flax(d, d_vars))
    real, fake = d(torch.from_numpy(np.asarray(xx))).chunk(2)
    gan_losses.d_loss_nonsaturating(torch.sigmoid(real), torch.sigmoid(fake),
                                    eps=1e-6).backward()
    got = flax_from_state_dict(d, {k: p.grad for k, p in
                                   d.named_parameters()})["params"]
    assert len(dict(leaves(got))) == 8
    assert_moments_close(got, want)


def test_legacy_step_batch_stats_match_jax(legacy_step):
    _, _, jt, pt, *_ = legacy_step
    assert_trees_close(pt["g"]["batch_stats"], jt["g"]["batch_stats"], 1e-5)


def test_legacy_serving_ignores_the_mask():
    _, pcfg = _legacy_configs()
    clf = LegacyCNNClassifier()
    port = build_mnist_countergan(pcfg, clf.state_dict(), device="cpu",
                                  legacy_delta=True)
    g_vars = port.state.g.model.state_dict()
    x = torch.from_numpy(_images(12))
    t = torch.full((B,), 5)
    ones = port.cf_fn(g_vars, x, t, torch.ones_like(x))
    zeros = port.cf_fn(g_vars, x, t, torch.zeros_like(x))
    for a, b in zip(ones, zeros):
        assert torch.equal(a, b)
    x_cf, raw, masked = ones
    assert torch.equal(raw, masked)
    assert torch.equal(x_cf, torch.clamp(x + raw, -1.0, 1.0))


# ------------------------------------------------------ the experiment
SMALL = dict(epochs=2, hidden_dim=WIDTH)


def _small(preset):
    return preset.replace(
        data=replace(preset.data, path=FIXTURE, batch_size=16),
        classifier=replace(preset.classifier, epochs=1, batch_size=32),
        countergan=replace(preset.countergan, **SMALL))


@pytest.fixture(scope="module")
def legacy_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("legacy")
    cfg = _small(MNIST_COUNTERGAN_LEGACY)
    first = exp.run(cfg, out_dir=str(out), device="cpu", log=lambda s: None,
                    legacy_delta=True)
    lines = []
    second = exp.run(cfg, out_dir=str(out), device="cpu", log=lines.append,
                     legacy_delta=True)
    return out, first, second, lines


def test_legacy_run_writes_the_run_dir(legacy_runs):
    out, first, _, _ = legacy_runs
    for f in ("classifier/checkpoint.msgpack", "generator/checkpoint.msgpack",
              "train_state/checkpoint.msgpack", "countergan_metrics.csv",
              "countergan_metrics_per_class.csv", "masked_metrics.csv",
              "patch_budget_curve.csv", "run_provenance.json"):
        assert (out / f).is_file(), f
    bundle = first["bundle"]
    assert isinstance(bundle.state.g.model, DeltaImageGenerator)
    assert isinstance(bundle.state.d.model, ConvDiscriminator)
    assert first["serving_selection"]["candidate"] == "live"
    assert len(first["history"]["d_loss"]) == 2
    prov = json.loads((out / "run_provenance.json").read_text())
    assert prov["preset"] == "mnist_countergan_legacy"


def test_legacy_rerun_loads_every_stage(legacy_runs):
    out, first, second, lines = legacy_runs
    assert any(ln.startswith("Loaded classifier") for ln in lines)
    assert any(ln.startswith("Loaded generator") for ln in lines)
    assert second["history"] == {}
    for k, v in first["g_vars"].items():
        assert torch.equal(second["g_vars"][k], v), k


def test_legacy_run_dir_restores_in_jax(legacy_runs):
    out, first, _, _ = legacy_runs
    x = jnp.zeros((2, 28, 28, 1))
    t = jnp.zeros((2,), jnp.int32)
    clf_template = JaxLegacyCNN().init(jax.random.key(0), x)
    clf = _np(jck.restore(str(out / "classifier"), dict(clf_template)))
    g_template = JaxDeltaG(base_ch=WIDTH).init(jax.random.key(0), x, t, x)
    g_vars = _np(jck.restore(str(out / "generator"), dict(g_template)))
    model = first["bundle"].state.g.model
    want = flax_from_state_dict(model, first["g_vars"])
    for a, b in zip(jax.tree_util.tree_leaves(g_vars),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree_util.tree_structure(clf) == \
        jax.tree_util.tree_structure(_np(dict(clf_template)))


def test_jax_legacy_run_dir_restores_in_the_port(tmp_path):
    """Checkpoints the JAX package writes for the legacy stack (its
    classifier's and delta generator's variables, with random BatchNorm
    statistics) load through the port's `run`, which trains nothing."""
    x = jnp.zeros((2, 28, 28, 1))
    t = jnp.zeros((2,), jnp.int32)
    clf_vars = _np(dict(JaxLegacyCNN().init(jax.random.key(4), x)))
    g_vars = _with_random_stats(JaxDeltaG(base_ch=WIDTH).init(
        jax.random.key(5), x, t, x), 6)
    jck.save(str(tmp_path / "classifier"), clf_vars)
    jck.save(str(tmp_path / "generator"), g_vars,
             metadata={"serving_selection": {"candidate": "live"}})
    lines = []
    res = exp.run(_small(MNIST_COUNTERGAN_LEGACY), out_dir=str(tmp_path),
                  device="cpu", log=lines.append, legacy_delta=True)
    assert not any("[CounteRGAN] epoch" in ln or "[Classifier]" in ln
                   for ln in lines)
    got = flax_from_state_dict(res["bundle"].state.g.model, res["g_vars"])
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(g_vars)):
        np.testing.assert_array_equal(a, b)


def test_main_legacy_flag_selects_the_legacy_preset(monkeypatch):
    seen = {}
    monkeypatch.setattr(exp, "run", lambda cfg, **kw: seen.update(cfg=cfg,
                                                                  **kw))
    exp.main(["--legacy", "--epochs", "3", "--device", "cpu"])
    assert seen["legacy_delta"] is True
    assert seen["cfg"].name == "mnist_countergan_legacy"
    assert seen["cfg"].countergan.epochs == 3
    assert seen["cfg"].countergan.fixed_target == 5


# ------------------------------------------------- mnist_countergan2
@pytest.fixture(scope="module")
def countergan2_run(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(exp2, "MNIST_COUNTERGAN2", _small(MNIST_COUNTERGAN2))
    mp.setenv("CFGAN_DATA_DIR", FIXTURE)
    out = tmp_path_factory.mktemp("countergan2")
    try:
        res = exp2.main(["--target", "5", "--out-dir", str(out),
                         "--device", "cpu"])
        lines = []
        rerun = exp2.main(["--target", "5", "--out-dir", str(out),
                           "--device", "cpu"], log=lines.append)
    finally:
        mp.undo()
    return out, res, rerun, lines


def test_countergan2_runs_the_legacy_stack_at_its_target(countergan2_run):
    out, res, rerun, lines = countergan2_run
    bundle = res["bundle"]
    assert isinstance(bundle.state.g.model, DeltaImageGenerator)
    assert bundle.cfg.fixed_target == 5
    # the rerun loads the checkpoints
    assert rerun["history"] == {}
    assert any(ln.startswith("Loaded generator") for ln in lines)
    for name in exp2.GRIDS:
        assert (out / name).is_file(), name


def test_countergan2_grids_are_jax_to_uint8_grid(countergan2_run):
    """The PNGs decode (PIL) to JAX's
    `to_uint8_grid` of the test images, of the counterfactuals and of
    half the deltas, 4 a row; the counterfactuals the port drew equal
    those JAX's delta generator draws from the same restored weights
    within 3e-5, so their grids agree within one level."""
    from PIL import Image

    from cfgan.data.mnist import load_mnist as jax_load_mnist

    out, res, _, _ = countergan2_run
    mp = pytest.MonkeyPatch()
    mp.setenv("CFGAN_DATA_DIR", FIXTURE)
    try:
        _, _, (xte, _) = jax_load_mnist()
    finally:
        mp.undo()
    x = xte[:16]
    x_t = torch.from_numpy(x)
    t = torch.full((16,), 5)
    x_cf, delta, _ = res["bundle"].cf_fn(res["g_vars"], x_t, t,
                                         torch.ones_like(x_t))
    g_template = JaxDeltaG(base_ch=WIDTH).init(
        jax.random.key(0), jnp.asarray(x), jnp.asarray(t.numpy()),
        jnp.asarray(x))
    g_vars = jck.restore(str(out / "generator"), dict(g_template))
    j_delta, _ = JaxDeltaG(base_ch=WIDTH).apply(
        g_vars, jnp.asarray(x), jnp.asarray(t.numpy()), None, train=False)
    j_cf = jnp.clip(jnp.asarray(x) + j_delta, -1.0, 1.0)
    _close(x_cf, j_cf)
    for name, mine, theirs in (("original.png", x, x),
                               ("counterfactual.png", x_cf.numpy(), j_cf),
                               ("delta.png", delta.numpy() * 0.5,
                                np.asarray(j_delta) * 0.5)):
        pixels = np.asarray(Image.open(out / name))
        assert pixels.dtype == np.uint8
        np.testing.assert_array_equal(pixels, jax_to_uint8_grid(mine,
                                                                nrow=4))
        gap = np.abs(pixels.astype(int)
                     - jax_to_uint8_grid(np.asarray(theirs), nrow=4))
        assert gap.max() <= 1, name
        assert pixels.shape == (4 * 30 + 2, 4 * 30 + 2)


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 1), (4, 6, 3), (3, 2, 4)])
def test_png_writer_decodes_to_its_pixels(shape, tmp_path):
    """Gray, RGB and RGBA through PIL's decoder, and a JAX grid of
    signed images (the uint8 raster `save_image_grid` writes)."""
    from PIL import Image

    from cfgan_torch.eval.samples import save_image_grid, write_png

    a = np.random.RandomState(len(shape)).randint(0, 256, shape).astype(
        np.uint8)
    got = np.asarray(Image.open(write_png(str(tmp_path / "a.png"), a)))
    np.testing.assert_array_equal(got, a.reshape(got.shape))
    images = np.random.RandomState(1).uniform(-1, 1, (5, *shape[:2], 1))
    path = save_image_grid(images, str(tmp_path / "sub" / "grid.png"), nrow=2)
    np.testing.assert_array_equal(np.asarray(Image.open(path)),
                                  jax_to_uint8_grid(images, nrow=2))


def test_png_writer_rejects_what_png_cannot_hold():
    from cfgan_torch.eval.samples import png_bytes

    with pytest.raises(ValueError, match="uint8"):
        png_bytes(np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError, match="shape"):
        png_bytes(np.zeros((2, 2, 2), np.uint8))


def test_countergan2_requires_a_target_in_range():
    with pytest.raises(SystemExit):
        exp2.main(["--device", "cpu"])
    with pytest.raises(SystemExit):
        exp2.main(["--target", "10", "--device", "cpu"])


def test_countergan2_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp2.main(["--target", "3"])


def test_legacy_run_dirs_hold_the_jax_figures(legacy_runs, countergan2_run):
    """The legacy run draws the MNIST run dir's figures; mnist_countergan2
    adds its three grids."""
    want = jax_figure_set("mnist_countergan_seed43")
    assert figure_set(legacy_runs[0]) == want
    assert figure_set(countergan2_run[0]) == want | set(exp2.GRIDS)
