"""The port's MNIST CounteRGAN train step (cfgan_torch.train) against the
JAX package's `build_mnist_countergan` step, on the CPU, from the same
initial state (carried across by cfgan_torch.convert) and the same draws:
the targets and masks are re-derived from the JAX step's key
(`fold_in(key, step)`, as tests/test_step_parity_mnist.py does) and handed
to the port's `step_with_draws`.

Width 8, one residual block, batch 16, float32, the reference recipe.
Bars (f32): after one step d_loss 3e-5 and g_loss 3e-4 abs, every
parameter 3e-5, BatchNorm running statistics 1e-5 and the diagnostics
3e-5 (the repo's torch-oracle bars, PARITY.md); after three steps every
parameter 1e-4.  The two compute the same float32 functions in other
summation orders, so their gradients differ by float32 rounding, and
Adam's first steps move each parameter by about lr whatever the
gradient's size: with lr_d = 1e-5 the parameter bars alone cannot tell a
right gradient from a wrong one.  So the gradients themselves are held
against JAX through the optimizers' first moments after one step (torch's
`exp_avg` and optax's `mu`, both 0.1 * grad), leaf by leaf:
|mu_port - mu_jax| <= MU_RTOL * |mu_jax| + MU_ATOL in the 2-norm of the
leaf.  Measured worst relative error 4.8e-6 (summation order); MU_ATOL
covers the conv biases that a BatchNorm follows, whose true gradient is
zero and whose moments are rounding noise of ~4e-10.

One JAX step compiles in about 30 s here, so each configuration builds its
JAX bundle and runs its trajectory once, in a module-scoped fixture; the
variants (the pallas conv route, bf16) are in test_torch_step_options.py.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgan.core.config import CounterGANConfig as JaxConfig
from cfgan.core.config import MaskConfig as JaxMaskConfig
from cfgan.masks.patch import random_patch_mask as jax_patch_mask
from cfgan.models.classifiers import CNNClassifier as JaxClassifier
from cfgan.train.builders import build_mnist_countergan as jax_build
from cfgan.train.countergan import sample_targets as jax_sample_targets
from cfgan.train.state import NetState as JaxNetState
from cfgan.train.state import adam_like_torch as jax_adam
from cfgan_torch.convert import (
    adam_moments_to_flax,
    gan_state_to_flax,
    load_gan_state,
    state_dict_from_flax,
)
from cfgan_torch.core.config import (
    MNIST_COUNTERGAN_REFERENCE,
    CounterGANConfig,
    MaskConfig,
)
from cfgan_torch.models.classifiers import CNNClassifier
from cfgan_torch.train.builders import build_mnist_countergan

B = 16
# the reference recipe's training fields (presets.py
# MNIST_COUNTERGAN_REFERENCE) at a small width
RECIPE = dict(lr_g=5e-5, lr_d=1e-5, lambda_adv=1.0, lambda_cls=1.0,
              lambda_reg_l1=2.5, lambda_reg_l2=0.0, lambda_mask=2.0,
              adv_loss="bce", reg_reduction="mean_abs", clamp_cf=(-1.0, 1.0),
              resample_target=False, hidden_dim=8, num_res_blocks=1)
MASK = dict(kind="patch", patch_size=7, num_modifiable_patches=10)
DIAGNOSTICS = ("g_adv", "g_cls", "reg_l1", "reg_l2", "mask_penalty",
               "d_real_p", "d_fake_p", "residual_mean", "flip_rate",
               "pred_gain")


def _configs(**overrides):
    fields = {**RECIPE, **overrides}
    return (JaxConfig(**fields, mask=JaxMaskConfig(**MASK)),
            CounterGANConfig(**fields, mask=MaskConfig(**MASK)))


def _batch(step, seed=0):
    rng = np.random.RandomState(seed + step)
    x = rng.uniform(-1, 1, (B, 28, 28, 1)).astype(np.float32)
    y = rng.randint(0, 10, B).astype(np.int32)
    return x, y


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def run_pair(overrides, steps, conv_impl=(None, None)):
    """Build both packages' steps from one JAX initial state and run
    `steps` steps on the same batches and draws.  Returns a list, per step,
    of (jax metrics, port metrics, jax state trees, port state trees)."""
    jcfg, pcfg = _configs(**overrides)
    jcfg = replace(jcfg, conv_impl=conv_impl[0])
    pcfg = replace(pcfg, conv_impl=conv_impl[1])
    clf_model = JaxClassifier()
    clf_vars = _np(dict(clf_model.init(jax.random.key(1),
                                       jnp.zeros((2, 28, 28, 1)),
                                       train=False)))
    bundle = jax_build(jcfg, clf_model,
                       JaxNetState.create(clf_vars, jax_adam(1e-3)), seed=7)
    port = build_mnist_countergan(
        pcfg, state_dict_from_flax(CNNClassifier(), clf_vars),
        device="cpu")
    load_gan_state(port.state, _jax_trees(bundle.state))
    step = jax.jit(bundle.step_fn)
    key = jax.random.key(3)
    state, out = bundle.state, []
    for i in range(steps):
        x, y = _batch(i)
        k_t, k_m, _ = jax.random.split(jax.random.fold_in(key, i), 3)
        t = jax_sample_targets(k_t, jnp.asarray(y), 10, jcfg.resample_target)
        mask = jax_patch_mask(k_m, B, (28, 28), 7, 10, channels=1)
        state, jm = step(state, jnp.asarray(x), jnp.asarray(y), key)
        pm = port.step_with_draws(
            port.state, torch.from_numpy(x), torch.from_numpy(y).long(),
            torch.tensor(np.asarray(t)).long(),
            torch.tensor(np.asarray(mask)))
        out.append(({k: float(v) for k, v in jm.items()},
                    {k: float(v) for k, v in pm.items()},
                    {**_jax_trees(state), "adam_mu": _jax_adam_mu(state)},
                    {**gan_state_to_flax(port.state),
                     "adam_mu": adam_moments_to_flax(port.state)}))
    assert port.state.step == steps
    return out


def _jax_trees(state):
    return _np({"g": state.g.variables(), "d": state.d.variables(),
                "g_ema": state.g_ema})


def _jax_adam_mu(state):
    """optax.adam's first moments, `{"g": params tree, "d": ...}`."""
    return _np({net: getattr(state, net).opt_state[0].mu
                for net in ("g", "d")})


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


MU_RTOL, MU_ATOL = 5e-5, 1e-8


def assert_moments_close(got, want, rtol=MU_RTOL, atol=MU_ATOL,
                         skip=lambda name: False):
    """Same leaves; every leaf not `skip`ped has |got - want| <= rtol *
    |want| + atol in the 2-norm.  Names the worst leaf on failure."""
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    errs = {k: (float(np.linalg.norm(got[k] - want[k])),
                float(np.linalg.norm(want[k])))
            for k in want if not skip(k)}
    over = {k: d - (rtol * n + atol) for k, (d, n) in errs.items()}
    worst = max(over, key=over.get)
    assert over[worst] <= 0, (worst, errs[worst], rtol, atol)


def assert_trees_close(got, want, atol):
    """Same leaves, each within `atol`; names the worst leaf on failure."""
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    errs = {k: float(np.max(np.abs(got[k] - want[k]))) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= atol, (worst, errs[worst], atol)


@pytest.fixture(scope="module")
def reference_run():
    return run_pair({}, steps=3)


def test_one_step_losses_match_jax(reference_run):
    jm, pm, _, _ = reference_run[0]
    assert abs(pm["d_loss"] - jm["d_loss"]) <= 3e-5
    assert abs(pm["g_loss"] - jm["g_loss"]) <= 3e-4


def test_one_step_diagnostics_match_jax(reference_run):
    jm, pm, _, _ = reference_run[0]
    assert pm.keys() == jm.keys() == {"d_loss", "g_loss", *DIAGNOSTICS}
    for name in DIAGNOSTICS:
        assert abs(pm[name] - jm[name]) <= 3e-5, name


@pytest.mark.parametrize("net", ["g", "d"])
def test_one_step_parameters_match_jax(reference_run, net):
    _, _, jt, pt = reference_run[0]
    assert_trees_close(pt[net]["params"], jt[net]["params"], 3e-5)


@pytest.mark.parametrize("net", ["g", "d"])
def test_one_step_gradients_match_jax(reference_run, net):
    """Adam's first moment after one step is 0.1 * the step's gradient."""
    _, _, jt, pt = reference_run[0]
    assert_moments_close(pt["adam_mu"][net], jt["adam_mu"][net])


def test_one_step_batch_stats_match_jax(reference_run):
    _, _, jt, pt = reference_run[0]
    assert_trees_close(pt["g"]["batch_stats"], jt["g"]["batch_stats"], 1e-5)
    assert "batch_stats" not in pt["d"]


def test_three_steps_parameters_match_jax(reference_run):
    _, _, jt, pt = reference_run[2]
    for net in ("g", "d"):
        assert_trees_close(pt[net]["params"], jt[net]["params"], 1e-4)
    assert_trees_close(pt["g"]["batch_stats"], jt["g"]["batch_stats"], 1e-4)


def test_three_steps_losses_match_jax(reference_run):
    for jm, pm, _, _ in reference_run:
        assert abs(pm["d_loss"] - jm["d_loss"]) <= 1e-4
        assert abs(pm["g_loss"] - jm["g_loss"]) <= 3e-4


@pytest.fixture(scope="module")
def ema_range_run():
    return run_pair({"ema_decay": 0.9, "lambda_range": 0.5}, steps=1)


def test_ema_and_lambda_range_step_matches_jax(ema_range_run):
    """EMA decay 0.9 (a larger move than the preset's 0.999, so the EMA's
    step is visible at the bar) and the out-of-range penalty on."""
    jm, pm, jt, pt = ema_range_run[0]
    assert abs(pm["d_loss"] - jm["d_loss"]) <= 3e-5
    assert abs(pm["g_loss"] - jm["g_loss"]) <= 3e-4
    assert_trees_close(pt["g"]["params"], jt["g"]["params"], 3e-5)
    assert_trees_close(pt["g_ema"], jt["g_ema"], 3e-5)
    for net in ("g", "d"):
        assert_moments_close(pt["adam_mu"][net], jt["adam_mu"][net])


def test_ema_starts_at_the_initial_parameters():
    _, pcfg = _configs(ema_decay=0.999)
    port = build_mnist_countergan(pcfg, CNNClassifier().state_dict(),
                                  device="cpu")
    trees = gan_state_to_flax(port.state)
    assert_trees_close(trees["g_ema"], trees["g"]["params"], 0.0)
    assert build_mnist_countergan(
        _configs()[1], CNNClassifier().state_dict(),
        device="cpu").state.g_ema is None


def test_reference_preset_matches_the_jax_preset():
    from cfgan.experiments.presets import MNIST_COUNTERGAN_REFERENCE as REF

    want = REF.countergan
    for field in (*RECIPE, "residual_scaling", "compute_dtype", "conv_impl",
                  "ema_decay", "lambda_range", "fixed_target"):
        if field not in ("hidden_dim", "num_res_blocks"):
            assert getattr(MNIST_COUNTERGAN_REFERENCE, field) == getattr(
                want, field), field
    assert MNIST_COUNTERGAN_REFERENCE.hidden_dim == want.hidden_dim == 64
    for field in MASK:
        assert getattr(MNIST_COUNTERGAN_REFERENCE.mask, field) == getattr(
            want.mask, field)


def _counting(fn, calls, key):
    def spy(*args):
        calls[key] += 1
        return fn(*args)

    return spy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("conv_impl", [None, "pallas"],
                         ids=["cudnn_conv", "pallas_conv"])
def test_step_runs_the_epilogue_forward_and_backward_once(monkeypatch, dtype,
                                                          conv_impl):
    """Each step calls the epilogue's forward once and its backward once
    (on the card, one launch of each kernel), in both compute dtypes and
    with either conv route (width 16 routes the resblock convs to the
    conv kernel's Function).  Counting wrappers around the plain versions
    stand in for the wrappers of the kernels."""
    from cfgan_torch.ops import epilogue as tep

    calls = {"fwd": 0, "bwd": 0}
    monkeypatch.setattr(tep, "cf_epilogue_fwd", _counting(
        tep.cf_epilogue_fwd_plain, calls, "fwd"))
    monkeypatch.setattr(tep, "cf_epilogue_bwd", _counting(
        tep.cf_epilogue_bwd_plain, calls, "bwd"))
    _, pcfg = _configs(hidden_dim=16, compute_dtype=dtype,
                       conv_impl=conv_impl, ema_decay=0.999)
    bundle = build_mnist_countergan(pcfg, CNNClassifier().state_dict(),
                                    device="cpu")
    draws = torch.Generator().manual_seed(0)
    for i in range(2):
        x, y = _batch(i)
        bundle.step_fn(bundle.state, torch.from_numpy(x)[:4],
                       torch.from_numpy(y).long()[:4], draws)
        assert calls == {"fwd": i + 1, "bwd": i + 1}


def _two_forward_step(cfg, state, clf_model):
    """The step with two epilogue forwards, as the JAX package runs it: a
    forward-only epilogue on the detached raw residual for the D update,
    then the epilogue again for the G loss.  Built from the
    parts `build_mnist_countergan` builds its step from, for the recipe's
    BCE loss and clamp, without EMA, `lambda_range` or diagnostics."""
    from cfgan_torch.losses import countergan as cg_losses
    from cfgan_torch.losses import gan as gan_losses
    from cfgan_torch.ops.epilogue import cf_epilogue, epilogue_terms
    from cfgan_torch.train.builders import (
        clf_forward_fn,
        make_mixed_precision,
    )

    g_forward = make_mixed_precision(state.g.model, cfg.compute_dtype)
    d_forward = make_mixed_precision(state.d.model, cfg.compute_dtype)
    clf_forward = clf_forward_fn(clf_model, cfg.compute_dtype)
    lo, hi = cfg.clamp_cf

    def step(x, y, t, mask):
        raw, _ = g_forward(x, t, mask)
        with torch.no_grad():
            x_cf = cf_epilogue(x, raw.detach(), mask, lo, hi)[0]
        d_real, d_fake = d_forward(torch.cat([x, x_cf]),
                                   torch.cat([y, t])).chunk(2)
        d_loss = gan_losses.d_loss_bce(d_real, d_fake)
        state.d.opt.zero_grad(set_to_none=True)
        d_loss.backward()
        state.d.opt.step()
        cf, l1s, l2s, pens = cf_epilogue(x, raw, mask, lo, hi)
        adv = gan_losses.g_loss_bce(d_forward(cf, t, detach=True))
        cls = cg_losses.classifier_ce(clf_forward(cf), t)
        l1, _, pen = epilogue_terms(l1s, l2s, pens, x[0].numel(),
                                    cfg.reg_reduction)
        l2 = torch.zeros(())
        total = (cfg.lambda_adv * adv + cfg.lambda_cls * cls
                 + cfg.lambda_reg_l1 * l1 + cfg.lambda_reg_l2 * l2
                 + cfg.lambda_mask * pen)
        state.g.opt.zero_grad(set_to_none=True)
        total.backward()
        state.g.opt.step()
        return {"d_loss": d_loss.detach(), "g_loss": total.detach()}

    return step


def test_one_forward_step_equals_the_two_forward_step_bit_for_bit():
    """The D update changes none of the epilogue's inputs, so computing
    its forward once per step gives what computing it twice gave: the
    same metrics at every step, and the same parameters, BatchNorm
    statistics and Adam moments after three, bit for bit in float32."""
    _, pcfg = _configs()
    assert pcfg.lambda_reg_l2 == 0 and not pcfg.ema_decay
    clf = CNNClassifier(generator=torch.Generator().manual_seed(1))
    ours, ref = (build_mnist_countergan(pcfg, clf.state_dict(), seed=5,
                                        device="cpu", diagnostics=False)
                 for _ in range(2))
    two_forward = _two_forward_step(pcfg, ref.state, clf)
    rng = np.random.RandomState(9)
    for i in range(3):
        x, y = (torch.from_numpy(a) for a in _batch(i))
        y = y.long()
        t = torch.from_numpy(rng.randint(0, 10, B)).long()
        mask = torch.from_numpy(
            (rng.uniform(size=(B, 28, 28, 1)) > 0.5).astype(np.float32))
        got = ours.step_with_draws(ours.state, x, y, t, mask)
        want = two_forward(x, y, t, mask)
        assert got.keys() == want.keys()
        for name in want:
            assert torch.equal(got[name], want[name]), (i, name)
    for net in ("g", "d"):
        a, b = getattr(ours.state, net), getattr(ref.state, net)
        for (name, p), q in zip(a.model.state_dict().items(),
                                b.model.state_dict().values()):
            assert torch.equal(p, q), (net, name)
        for p, q in zip(a.model.parameters(), b.model.parameters()):
            sa, sb = a.opt.state[p], b.opt.state[q]
            assert torch.equal(sa["exp_avg"], sb["exp_avg"])
            assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
