"""The CounteRGAN step's memory options, `CounterGANConfig.remat` and
`g_microbatch`, on the port against the JAX package's step with the same
options, on the CPU, for the three families: MNIST (the residual
generator, tests/test_torch_step.py's harness: width 8, one residual
block, batch 16, the reference recipe), moons (the shipped preset at full
width, batch 64, tests/test_torch_moons_train.py's harness) and house (the
shipped preset at width 8, batch 16, tests/test_torch_tabular_step.py's
harness), from one initial state and on the JAX step's draws.  The house
chunks take JAX's per-chunk Gumbel noise, `derive_gumbel_noise(fold_in(
k_g, chunk))`, not a slice of the D phase's.

Bars: those of the harness each family's own step is held to (MNIST:
d_loss and the diagnostics 3e-5, g_loss 3e-4, parameters 3e-5, BatchNorm
statistics 1e-5, Adam's first moments leaf by leaf within 5e-5 of their
2-norm; moons and house: the same 3e-5, with the leaves whose exact
gradient is zero, the biases a BatchNorm follows and the critic's last
hidden biases, within 2 lr a step, as those files explain).

Then the port against itself: the remat step equals the plain step bit
for bit, BatchNorm statistics included (they move once a step); a
micro-batched step's statistics equal the one-forward step's (the D
phase's full-batch forward alone updates them); the epilogue runs K + 1
times forward and K times backward a micro step; K must divide the batch.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_moons_train as moons_h
import test_torch_step as mnist_h
import test_torch_tabular_step as house_h
from cfgan.data.kc_house import KC_SCHEMA as JAX_SCHEMA
from cfgan.models.tabular import derive_gumbel_noise as jax_noise
from cfgan_torch.core.config import MNIST_COUNTERGAN_REFERENCE
from cfgan_torch.convert import adam_moments_to_flax, gan_state_to_flax
from cfgan_torch.data.kc_house import KC_SCHEMA
from cfgan_torch.models.classifiers import CNNClassifier, TabularClassifier
from cfgan_torch.ops import epilogue as tep
from cfgan_torch.train.builders import (
    build_mnist_countergan,
    build_tabular_countergan,
)

ATOL = 3e-5
MNIST_CASES = {"micro2": {"g_microbatch": 2}, "micro4": {"g_microbatch": 4},
               "remat": {"remat": True},
               "remat_micro2": {"remat": True, "g_microbatch": 2}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU run shares its cores with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------- MNIST
@pytest.fixture(scope="module", params=sorted(MNIST_CASES))
def mnist_step(request):
    return request.param, mnist_h.run_pair(MNIST_CASES[request.param],
                                           steps=1)[0]


def test_mnist_losses_and_diagnostics_match_jax(mnist_step):
    _, (jm, pm, _, _) = mnist_step
    assert pm.keys() == jm.keys() == {"d_loss", "g_loss",
                                      *mnist_h.DIAGNOSTICS}
    assert abs(pm["g_loss"] - jm["g_loss"]) <= 3e-4
    for name in ("d_loss", *mnist_h.DIAGNOSTICS):
        assert abs(pm[name] - jm[name]) <= ATOL, name


@pytest.mark.parametrize("net", ["g", "d"])
def test_mnist_parameters_and_gradients_match_jax(mnist_step, net):
    _, (_, _, jt, pt) = mnist_step
    mnist_h.assert_trees_close(pt[net]["params"], jt[net]["params"], ATOL)
    mnist_h.assert_moments_close(pt["adam_mu"][net], jt["adam_mu"][net])


def test_mnist_batch_stats_match_jax(mnist_step):
    _, (_, _, jt, pt) = mnist_step
    mnist_h.assert_trees_close(pt["g"]["batch_stats"],
                               jt["g"]["batch_stats"], 1e-5)


# ----------------------------------------------------------------- moons
@pytest.fixture(scope="module")
def moons_data():
    from cfgan_torch.data.moons import load_moons3

    (xtr, ytr), _, _ = load_moons3()
    return xtr, ytr


def _moons_run(k, data, steps=2):
    xtr, ytr = data
    jcfg, bundle, port = moons_h.build_pair("shipped", g_microbatch=k)
    step = jax.jit(bundle.step_fn)
    key = jax.random.key(3)
    state, out, b = bundle.state, [], moons_h.B
    for i in range(steps):
        x, y = xtr[i * b:(i + 1) * b], ytr[i * b:(i + 1) * b]
        t, mask = moons_h.jax_step_draws(key, i, y)
        state, jm = step(state, jnp.asarray(x), jnp.asarray(y), key)
        pm = port.step_with_draws(
            port.state, torch.from_numpy(x), torch.from_numpy(y).long(),
            torch.from_numpy(t).long(), torch.from_numpy(mask))
        out.append(({k_: float(v) for k_, v in jm.items()},
                    {k_: float(v) for k_, v in pm.items()},
                    {**moons_h._jax_trees(state), "adam_mu": moons_h._np(
                        {n: getattr(state, n).opt_state[0].mu
                         for n in ("g", "d")})},
                    {**gan_state_to_flax(port.state),
                     "adam_mu": adam_moments_to_flax(port.state)}))
    return jcfg, out


@pytest.mark.parametrize("k", [2, 4])
def test_moons_micro_steps_match_jax(moons_data, k):
    """Two micro-batched steps: metrics, both nets' parameters, `u`, the
    BatchNorm statistics after each, and the gradients of the first."""
    jcfg, traj = _moons_run(k, moons_data)
    for at, (jm, pm, jt, pt) in enumerate(traj):
        drift = moons_h.assert_state_close(pt, jt, at + 1, jcfg.lr_g,
                                           jcfg.lr_d)
        offset = float(np.linalg.norm(drift["sn2/bias"]))
        assert pm.keys() == jm.keys()
        for name in jm:
            bar = ATOL + (offset if name in moons_h.CRITIC_READ else 0.0)
            assert abs(pm[name] - jm[name]) <= bar, (k, at, name)
    _, _, jt, pt = traj[0]
    noise = lambda n: n.endswith(moons_h.NOISE_LEAVES)  # noqa: E731
    for net in ("g", "d"):
        mnist_h.assert_moments_close(pt["adam_mu"][net], jt["adam_mu"][net],
                                     skip=noise)
        mnist_h.assert_moments_close(pt["adam_mu"][net], jt["adam_mu"][net],
                                     atol=moons_h.NOISE_MU,
                                     skip=lambda n: not noise(n))


# ----------------------------------------------------------------- house
@pytest.fixture(scope="module")
def house_data():
    from cfgan_torch.data.kc_house import load_kc_house

    (xtr, ytr), _, stats, _, _ = load_kc_house()
    return xtr, ytr, stats


def _chunk_noise(key, step, k, rows):
    """JAX's per-chunk Gumbel noise of a micro step: chunk i draws from
    fold_in(k_g, i), k_g the step key's third split."""
    _, _, k_g = jax.random.split(jax.random.fold_in(key, step), 3)
    return [{f: torch.from_numpy(np.asarray(v)) for f, v in jax_noise(
        jax.random.fold_in(k_g, i), rows,
        JAX_SCHEMA.categorical_info).items()} for i in range(k)]


def _house_run(k, data, steps=2):
    xtr, ytr, stats = data
    jcfg, bundle, port = house_h.build_pair("shipped", stats,
                                            g_microbatch=k)
    step = jax.jit(bundle.step_fn)
    key = jax.random.key(3)
    state, out, b = bundle.state, [], house_h.B
    for i in range(steps):
        x, y = xtr[i * b:(i + 1) * b], ytr[i * b:(i + 1) * b]
        t, mask, noise = house_h.jax_step_draws(key, i, y)
        state, jm = step(state, jnp.asarray(x), jnp.asarray(y), key)
        pm = port.step_with_draws(
            port.state, torch.from_numpy(x), torch.from_numpy(y).long(),
            torch.from_numpy(t).long(), torch.from_numpy(mask),
            {f: torch.from_numpy(v) for f, v in noise.items()},
            chunk_noise=_chunk_noise(key, i, k, b // k))
        out.append(({k_: float(v) for k_, v in jm.items()},
                    {k_: float(v) for k_, v in pm.items()},
                    {**house_h._jax_trees(state), "adam_mu": house_h._np(
                        {n: getattr(state, n).opt_state[0].mu
                         for n in ("g", "d")})},
                    {**gan_state_to_flax(port.state),
                     "adam_mu": adam_moments_to_flax(port.state)}))
    return jcfg, out


# the first moments' relative bar by K: at K = 4 the chunks hold 4 rows,
# and each FiLM block's BatchNorm divides by the spread of 4 values,
# which magnifies the two packages' float32 rounding (measured 5.7e-5 in
# block0/film/gamma/kernel, 1.1x the 8-row chunks' bar); the leaves whose
# exact gradient is zero sum K chunks' rounding noise, each through a
# 4-row BatchNorm (measured 1.2e-7 in block0/fc2/bias, over the harness's
# 1e-7)
HOUSE_MU_RTOL = {2: mnist_h.MU_RTOL, 4: 1e-4}
HOUSE_NOISE_MU = {2: house_h.NOISE_MU, 4: 5e-7}


@pytest.mark.parametrize("k", [2, 4])
def test_house_micro_steps_match_jax(house_data, k):
    """Two micro-batched steps of the shipped house preset (clamp, the
    range penalty, EMA) on JAX's chunk noise: metrics, parameters, EMA,
    `u`, and the gradients of the first step."""
    jcfg, traj = _house_run(k, house_data)
    for at, (jm, pm, jt, pt) in enumerate(traj):
        drift = house_h.assert_params_close(pt["d"]["params"],
                                            jt["d"]["params"], at + 1,
                                            jcfg.lr_d)
        house_h.assert_params_close(pt["g"]["params"], jt["g"]["params"],
                                    at + 1, jcfg.lr_g)
        house_h.assert_params_close(pt["g_ema"], jt["g_ema"], at + 1,
                                    jcfg.lr_g)
        mnist_h.assert_trees_close(pt["d"]["spectral_stats"],
                                   jt["d"]["spectral_stats"], ATOL)
        offset = float(np.linalg.norm(drift["sn2/bias"]))
        assert pm.keys() == jm.keys()
        for name in jm:
            bar = ATOL + (offset if name in house_h.CRITIC_READ else 0.0)
            assert abs(pm[name] - jm[name]) <= bar, (k, at, name)
    _, _, jt, pt = traj[0]
    noise = lambda n: n.endswith(house_h.NOISE_LEAVES)  # noqa: E731
    for net in ("g", "d"):
        mnist_h.assert_moments_close(pt["adam_mu"][net], jt["adam_mu"][net],
                                     rtol=HOUSE_MU_RTOL[k], skip=noise)
        mnist_h.assert_moments_close(pt["adam_mu"][net], jt["adam_mu"][net],
                                     atol=HOUSE_NOISE_MU[k],
                                     skip=lambda n: not noise(n))


def test_house_draws_hold_each_chunks_noise(house_data):
    _, _, stats = house_data
    cfg = replace(house_h.PRESETS["shipped"][1], **house_h.WIDTH,
                  g_microbatch=4)
    port = build_tabular_countergan(cfg, TabularClassifier().state_dict(),
                                    KC_SCHEMA, stats, device="cpu")
    gen = torch.Generator().manual_seed(0)
    n = port.draw_fn(gen, (16,))["gumbel"].shape[-1]
    assert port.draw_fn(gen, (16,))["gumbel_chunks"].shape == (4, 4, n)
    assert port.draw_fn(gen, (3, 16))["gumbel_chunks"].shape == (3, 4, 4, n)
    # a batch K does not divide gets no chunk noise, and the step raises
    draws = port.draw_fn(gen, (10,))
    assert "gumbel_chunks" not in draws
    x = torch.rand((10, 17))
    with pytest.raises(ValueError, match="must divide the batch size 10"):
        port.step_from_draws(port.state, x, torch.zeros(10, dtype=torch.long),
                             draws)


# ------------------------------------------------- the port against itself
def _mnist_bundles(**overrides):
    cfg = replace(MNIST_COUNTERGAN_REFERENCE,
                  **{"hidden_dim": 8, "num_res_blocks": 1, **overrides})
    clf = CNNClassifier(generator=torch.Generator().manual_seed(1))
    return build_mnist_countergan(cfg, clf.state_dict(), seed=3,
                                  device="cpu")


def _batch(step, b=16):
    gen = torch.Generator().manual_seed(100 + step)
    x = torch.rand((b, 28, 28, 1), generator=gen) * 2 - 1
    y = torch.randint(0, 10, (b,), generator=gen)
    return x, y


def _run(bundle, steps=2, b=16):
    out = []
    for i in range(steps):
        x, y = _batch(i, b)
        draws = bundle.draw_fn(torch.Generator().manual_seed(i), (b,))
        out.append(bundle.step_from_draws(bundle.state, x, y, draws))
    return out


def _state_tensors(bundle):
    s = bundle.state
    out = {f"{n}.{k}": v for n in ("g", "d")
           for k, v in getattr(s, n).model.state_dict().items()}
    for n in ("g", "d"):
        ns = getattr(s, n)
        for name, p in ns.model.named_parameters():
            for key in ("exp_avg", "exp_avg_sq"):
                out[f"{n}.{name}.{key}"] = ns.opt.state[p][key]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_step_equals_the_plain_step_bit_for_bit(dtype):
    """Two steps with `remat` against two without, from one initial
    state on the same draws: every metric, parameter, BatchNorm
    statistic and Adam moment equal.  Equal running statistics mean the
    recomputation in the backward did not update them a second time.  In
    bf16 the blocks run on `make_mixed_precision`'s casts of the
    parameters, which the recomputation must take again."""
    kw = dict(num_res_blocks=2, compute_dtype=dtype)
    plain, remat = _mnist_bundles(**kw), _mnist_bundles(remat=True, **kw)
    start = {k: v.clone() for k, v in
             plain.state.g.model.named_buffers()}
    for mp, mr in zip(_run(plain), _run(remat)):
        for k in mp:
            assert torch.equal(mp[k], mr[k]), k
    got, want = _state_tensors(remat), _state_tensors(plain)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    moved = [k for k, v in plain.state.g.model.named_buffers()
             if not torch.equal(v, start[k])]
    assert len(moved) == len(start)


def test_house_remat_step_equals_the_plain_step_bit_for_bit(house_data):
    """The tabular generator's FiLM blocks under `remat`: two steps on
    the same draws equal the plain steps', statistics included."""
    _, _, stats = house_data
    cfg = replace(house_h.PRESETS["shipped"][1], **house_h.WIDTH)
    clf = TabularClassifier().state_dict()

    def bundle(remat):
        return build_tabular_countergan(replace(cfg, remat=remat), clf,
                                        KC_SCHEMA, stats, seed=3,
                                        device="cpu")

    plain, remat = bundle(False), bundle(True)
    for i in range(2):
        gen = torch.Generator().manual_seed(100 + i)
        x, y = torch.rand((16, 17), generator=gen), torch.arange(16) % 2
        draws = plain.draw_fn(torch.Generator().manual_seed(i), (16,))
        mp = plain.step_from_draws(plain.state, x, y, draws)
        mr = remat.step_from_draws(remat.state, x, y, draws)
        for k in mp:
            assert torch.equal(mp[k], mr[k]), (i, k)
    got, want = _state_tensors(remat), _state_tensors(plain)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _saved_bytes(g, *args) -> int:
    """Bytes of the tensors autograd saves for the backward in a forward
    of `g` in train mode (the blocks' activations under `remat` are saved
    by the checkpoint, which keeps none of them)."""
    nbytes = 0

    def pack(t):
        nonlocal nbytes
        nbytes += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        g(*args)[0].sum().backward()
    return nbytes


def test_remat_keeps_no_block_activations():
    """With `remat` each residual block leaves in the graph its input and
    its parameters (the checkpoint's inputs) and none of its activations,
    which the backward remakes one block at a time; without it each block
    leaves several activations of its input's size."""
    from cfgan_torch.models.generators import ImageResidualGenerator

    gen = torch.Generator().manual_seed(1)
    x = torch.rand((4, 28, 28, 1), generator=gen) * 2 - 1
    args = (x, torch.arange(4), torch.ones_like(x))

    def saved(n, remat):
        g = ImageResidualGenerator(base_ch=8, n_resblocks=n, remat=remat,
                                   generator=torch.Generator().manual_seed(0))
        return _saved_bytes(g.train(), *args)

    g = ImageResidualGenerator(base_ch=8, n_resblocks=1)
    kept = x.numel() * 8 * 4 + sum(p.numel() * 4
                                   for p in g.res0.parameters())
    none = saved(0, False)
    assert saved(1, True) == none + kept
    assert saved(3, True) == none + 3 * kept
    block = saved(2, False) - saved(1, False)
    assert block >= 8 * kept
    assert saved(3, False) == none + 3 * block


def test_micro_step_updates_batch_stats_once_from_the_full_batch():
    """After one step the BatchNorm running statistics of a K = 2 and a
    K = 4 micro step equal the one-forward step's, bit for bit: the D
    phase's full-batch forward updates them, the chunks do not."""
    plain = _mnist_bundles()
    _run(plain, steps=1)
    want = dict(plain.state.g.model.named_buffers())
    for k in (2, 4):
        micro = _mnist_bundles(g_microbatch=k)
        _run(micro, steps=1)
        for name, v in micro.state.g.model.named_buffers():
            assert torch.equal(v, want[name]), (k, name)


@pytest.mark.parametrize("k", [2, 4])
def test_micro_step_runs_the_epilogue_k_plus_one_times(monkeypatch, k):
    calls = {"fwd": 0, "bwd": 0}

    def spy(fn, name):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(tep, "cf_epilogue_fwd",
                        spy(tep.cf_epilogue_fwd_plain, "fwd"))
    monkeypatch.setattr(tep, "cf_epilogue_bwd",
                        spy(tep.cf_epilogue_bwd_plain, "bwd"))
    _run(_mnist_bundles(g_microbatch=k), steps=1)
    assert calls == {"fwd": k + 1, "bwd": k}
    calls.update(fwd=0, bwd=0)
    _run(_mnist_bundles(remat=True), steps=1)
    assert calls == {"fwd": 1, "bwd": 1}


def test_micro_step_rejects_a_batch_k_does_not_divide():
    bundle = _mnist_bundles(g_microbatch=3)
    with pytest.raises(ValueError, match="g_microbatch=3 must divide the "
                                         "batch size 16"):
        _run(bundle, steps=1)
    assert bundle.state.step == 0
