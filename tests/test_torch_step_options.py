"""Variants of the train-step parity of test_torch_step.py (same harness,
same batches and draws), each in its own JAX configuration:

- width 16, where the port's `conv_impl="pallas"` routes the resblock
  convs and conv_mid through `conv3x3_same_pallas` (on the CPU its
  autograd.Function runs the kernel's plain version, forward and dx, and
  the dK product), against the JAX package at `conv_impl="matmul"`,
  whose VJP is the same arithmetic: the f32 bars of test_torch_step.py,
  the gradients (Adam's first moments) included;
- bf16 compute with float32 parameters.  Tolerances: d_loss and g_loss
  abs <= 2e-3 (means of bf16 values that XLA and PyTorch round at
  different places; measured 2e-6 and 1e-4); every parameter within
  2 * lr + 1e-6, because Adam's first step moves each parameter by at
  most lr whatever its gradient, so a gradient component near zero whose
  bf16 sign differs between the two moves them at most 2 * lr apart; the
  BatchNorm running statistics within 4e-3, i.e. momentum 0.1 times two
  bf16 ulps of batch statistics up to 8 in magnitude.  Those bars pass
  any gradient, so the gradients are held against JAX through Adam's
  first moments (0.1 * grad) leaf by leaf, relative to the leaf's 2-norm:
  the weight leaves (kernels, embeddings, BatchNorm scales) within
  BF16_MU_RTOL of their net, the measured worst leaf plus 20% (G: 0.583,
  a BatchNorm scale, whose gradient sums over the batch what bf16
  E[x^2] - E[x]^2 statistics give; D: 0.0498, a conv kernel); a D that
  takes no step, or sees half the batch, puts its kernels at 0.98 to 1.0.
  The bias leaves are left out in bf16: their gradients are sums over
  batch and space that cancel to a few percent of their terms, so a bf16
  rounding anywhere moves them by their own size (measured up to 1.5 on
  D's one-element head bias).

That gap between the two bf16 steps is rounding, not a fault of the port:
each package's bf16 first moments sit from its own f32 step's (same
initial state, batches and draws) at a distance, per weight leaf, and the
port's is never more than BF16_F32_MARGIN beyond JAX's (measured: G's
leaves 0.008-0.096 against JAX's 0.012-0.38, JAX farther on every leaf,
most on the BatchNorm scales; D's 0.0098-0.068 against 0.0086-0.067, the
largest ratio 1.15 on the head's kernel).  So the bf16 bars above measure
where the two frameworks round, which is mostly JAX's G.
"""
import numpy as np
import pytest

from test_torch_step import (
    assert_moments_close,
    assert_trees_close,
    leaves,
    run_pair,
)

BF16_MU_RTOL = {"g": 0.70, "d": 0.06}
BF16_F32_MARGIN = 0.25

PALLAS_WIDTH = 16


@pytest.fixture(scope="module")
def pallas_run():
    return run_pair({"hidden_dim": PALLAS_WIDTH}, steps=1,
                    conv_impl=("matmul", "pallas"))


def test_pallas_route_step_losses_match_jax_matmul(pallas_run):
    jm, pm, _, _ = pallas_run[0]
    assert abs(pm["d_loss"] - jm["d_loss"]) <= 3e-5
    assert abs(pm["g_loss"] - jm["g_loss"]) <= 3e-4
    for name in jm:
        assert abs(pm[name] - jm[name]) <= 3e-4, name


@pytest.mark.parametrize("net", ["g", "d"])
def test_pallas_route_step_parameters_match_jax_matmul(pallas_run, net):
    _, _, jt, pt = pallas_run[0]
    assert_trees_close(pt[net]["params"], jt[net]["params"], 3e-5)
    assert_moments_close(pt["adam_mu"][net], jt["adam_mu"][net])
    if net == "g":
        assert_trees_close(pt["g"]["batch_stats"], jt["g"]["batch_stats"],
                           1e-5)


def test_pallas_route_takes_the_kernel_layers():
    """The parity above runs through the Function: at width 16 the
    resblock convs and conv_mid are routed to it, conv_in and conv_out
    (Cin 3, Cout 1) stay on F.conv2d."""
    from cfgan_torch.models.generators import ImageResidualGenerator
    from cfgan_torch.nn.layers import Conv

    g = ImageResidualGenerator(base_ch=PALLAS_WIDTH, n_resblocks=1,
                               conv_impl="pallas")
    routed = sorted(n for n, m in g.named_modules()
                    if isinstance(m, Conv) and m.impl == "pallas")
    assert routed == ["conv_mid", "res0.conv1", "res0.conv2"]


@pytest.fixture(scope="module")
def bf16_run():
    return run_pair({"compute_dtype": "bfloat16"}, steps=1)


def test_bf16_step_losses_match_jax(bf16_run):
    jm, pm, _, _ = bf16_run[0]
    assert abs(pm["d_loss"] - jm["d_loss"]) <= 2e-3
    assert abs(pm["g_loss"] - jm["g_loss"]) <= 2e-3


@pytest.mark.parametrize("net,lr", [("g", 5e-5), ("d", 1e-5)])
def test_bf16_step_parameters_match_jax(bf16_run, net, lr):
    _, _, jt, pt = bf16_run[0]
    assert_trees_close(pt[net]["params"], jt[net]["params"], 2 * lr + 1e-6)


@pytest.mark.parametrize("net", ["g", "d"])
def test_bf16_step_gradients_match_jax(bf16_run, net):
    _, _, jt, pt = bf16_run[0]
    assert_moments_close(pt["adam_mu"][net], jt["adam_mu"][net],
                         rtol=BF16_MU_RTOL[net], atol=0.0,
                         skip=lambda name: name.endswith("bias"))


def test_bf16_step_batch_stats_match_jax(bf16_run):
    _, _, jt, pt = bf16_run[0]
    assert_trees_close(pt["g"]["batch_stats"], jt["g"]["batch_stats"], 4e-3)


@pytest.fixture(scope="module")
def f32_run():
    """The f32 step on bf16_run's initial state, batches and draws."""
    return run_pair({}, steps=1)


def _weight_moments(tree):
    return {k: v for k, v in leaves(tree) if not k.endswith("bias")}


@pytest.mark.parametrize("net", ["g", "d"])
def test_bf16_step_sits_no_farther_from_f32_than_jax(bf16_run, f32_run,
                                                     net):
    """Per weight leaf, the 2-norm distance of the port's bf16 first
    moments from the port's f32 ones, relative to the f32 leaf, is at most
    JAX's same distance times 1 + BF16_F32_MARGIN."""
    _, _, jb, pb = bf16_run[0]
    _, _, jf, pf = f32_run[0]
    dist = {}
    for who, bf, f in (("port", pb, pf), ("jax", jb, jf)):
        b16, f32 = (_weight_moments(t["adam_mu"][net]) for t in (bf, f))
        assert b16.keys() == f32.keys() and b16
        dist[who] = {k: float(np.linalg.norm(b16[k] - f32[k])
                              / np.linalg.norm(f32[k])) for k in f32}
    ratio = {k: dist["port"][k] / dist["jax"][k] for k in dist["jax"]}
    worst = max(ratio, key=ratio.get)
    assert ratio[worst] <= 1 + BF16_F32_MARGIN, (
        worst, dist["port"][worst], dist["jax"][worst])
