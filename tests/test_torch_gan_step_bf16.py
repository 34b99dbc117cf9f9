"""The plain-generation train step at `compute_dtype="bfloat16"` (both
networks' forwards and backwards in bf16 through `make_mixed_precision`,
float32 parameters, optimizer state, losses and the gradient penalty's
norm) against the JAX package's bf16 step, for each of the five families,
with the harness of test_torch_gan_step.py: one step from one state, on
the JAX step's draws.

Bars, as test_torch_step_options.py sets them for the CounteRGAN's bf16
step:

- the metrics within 5e-3 (means of bf16 values that XLA and PyTorch
  round at different places; measured up to 3.3e-3, the simple MNIST
  GAN's d_loss), but WGAN-GP's d_loss: its gradient penalty squares
  (|grad_x D| - 1) per sample, and a sample whose input gradient is large
  (norm ~2 at width 16) moves 5-15% under bf16 rounding in either package,
  so the two bf16 d_loss values lie ~1 apart (JAX 4.18, the port 5.17,
  float32 5.27).  It is held, like every metric, to sit no farther from
  the package's own float32 step than JAX's does, plus the 5e-3;
- every parameter within 2 lr + 1e-6: Adam's first step moves each by
  at most lr whatever its gradient;
- the BatchNorm running statistics within 4e-3 (momentum 0.1 times two
  bf16 ulps of batch statistics up to 8 in magnitude; measured 3.4e-4);
- the gradients through Adam's first moments: per net, the root mean
  square over the weight leaves of each leaf's distance between the bf16
  and float32 moments (relative to the float32 leaf) sits no farther for
  the port than for JAX, times 1 + BF16_F32_MARGIN (measured: the port's
  over JAX's 0.35-1.12, the largest WGAN-GP's generator, 0.223 against
  0.200).  The leaves differ between the two bf16 steps by 10-40% of
  their norm at these widths and batch 8, as much as each package's bf16
  step differs from its own float32 one, so a leaf-by-leaf bar would pass
  anything.  Biases are left out, as in test_torch_step_options.py: sums
  over batch and space that cancel, so a bf16 rounding moves them by
  their own size.
"""
import numpy as np
import pytest
import torch

from cfgan_torch.losses.gan import gradient_penalty
from cfgan_torch.models.discriminators import WGANCritic
from cfgan_torch.train.builders import make_mixed_precision

from test_torch_gan_step import FAMILIES, run_pair
from test_torch_step import assert_trees_close, leaves

METRIC_ATOL = 5e-3
STATS_ATOL = 4e-3
BF16_F32_MARGIN = 0.25


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """Each family's (bf16 step, float32 step) from one state, on one batch
    and one set of draws, made once for the module."""
    cache = {}

    def get(family):
        if family not in cache:
            _, pb, bf16 = run_pair(family, steps=1, compute_dtype="bfloat16")
            _, _, f32 = run_pair(family, steps=1)
            cache[family] = (pb, bf16[0], f32[0])
        return cache[family]

    return get


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def pair(request, runs):
    return request.param, runs(request.param)


def test_bf16_step_metrics_match_jax(pair):
    family, (pb, bf16, _) = pair
    assert pb.cfg.compute_dtype == "bfloat16"
    for k, v in bf16["jm"].items():
        if family == "wgan_gp" and k == "d_loss":
            continue  # the penalty's rounding: held below
        assert abs(bf16["pm"][k] - v) <= METRIC_ATOL, (k, bf16["pm"][k], v)


def test_bf16_step_metrics_sit_no_farther_from_f32_than_jax(pair):
    _, (_, bf16, f32) = pair
    for k in bf16["jm"]:
        port = abs(bf16["pm"][k] - f32["pm"][k])
        jax = abs(bf16["jm"][k] - f32["jm"][k])
        assert port <= jax + METRIC_ATOL, (k, port, jax)


@pytest.mark.parametrize("net", ["g", "d"])
def test_bf16_step_parameters_match_jax(pair, net):
    _, (pb, bf16, _) = pair
    lr = pb.cfg.lr_g if net == "g" else pb.cfg.lr_d
    assert_trees_close(bf16["pt"][net]["params"], bf16["jt"][net]["params"],
                       2 * lr + 1e-6)


def test_bf16_step_batch_stats_match_jax(pair):
    _, (_, bf16, _) = pair
    for net in ("g", "d"):
        want = bf16["jt"][net].get("batch_stats", {})
        if want:
            assert_trees_close(bf16["pt"][net]["batch_stats"], want,
                               STATS_ATOL)


def _rms_distance(b16, f32):
    b16 = {k: v for k, v in leaves(b16) if not k.endswith("bias")}
    f32 = {k: v for k, v in leaves(f32) if not k.endswith("bias")}
    assert b16.keys() == f32.keys() and b16
    rel = [float(np.linalg.norm(b16[k] - f32[k]) / np.linalg.norm(f32[k]))
           for k in f32]
    return float(np.sqrt(np.mean(np.square(rel))))


@pytest.mark.parametrize("net", ["g", "d"])
def test_bf16_gradients_sit_no_farther_from_f32_than_jax(pair, net):
    _, (_, bf16, f32) = pair
    port = _rms_distance(bf16["pmu"][net], f32["pmu"][net])
    jax = _rms_distance(bf16["jmu"][net], f32["jmu"][net])
    assert port <= jax * (1 + BF16_F32_MARGIN), (port, jax)


def test_bf16_penalty_norm_and_gradients_stay_float32():
    """Under the bf16 critic the penalty's input gradient, its norm and the
    penalty are float32, and its double backward gives the float32 master
    parameters float32 gradients."""
    torch.manual_seed(0)
    critic = WGANCritic(16, 16, 10)
    apply = make_mixed_precision(critic, "bfloat16")
    real, fake = torch.rand(4, 28, 28, 1) * 2 - 1, torch.rand(4, 28, 28, 1)
    cond = torch.eye(10)[torch.tensor([1, 3, 5, 7])]
    seen = []

    def critic_fn(x, c):
        scores = apply(x, c)
        seen.append(scores.dtype)
        return scores

    gp = gradient_penalty(critic_fn, real, fake, torch.rand(4), cond)
    assert gp.dtype == torch.float32 and seen == [torch.float32]
    assert torch.isfinite(gp)
    gp.backward()
    grads = [p.grad for p in critic.parameters() if p.grad is not None]
    assert grads and all(g.dtype == torch.float32 for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)
