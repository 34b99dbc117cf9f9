"""The port's MNIST generator and classifier against the JAX package's,
on weights carried across by cfgan_torch.convert, and the port's routing
of convs to the 3x3 kernel against the JAX package's gate.

Tolerances: float32 abs <= 1e-5 (same arithmetic, other summation
orders).  bfloat16 abs <= 4e-3 on outputs of magnitude ~0.2, i.e. four
bf16 ulps there: XLA keeps float32 intermediates inside its fused
elementwise ops and rounds to bf16 at fusion boundaries, while PyTorch
rounds after every op, so the two round at different places through
fifteen layers.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgan.models.classifiers import CNNClassifier as JaxClassifier
from cfgan.models.generators import ImageResidualGenerator as JaxGenerator
from cfgan.nn.layers import _Conv3x3Matmul
from cfgan_torch.convert import state_dict_from_flax
from cfgan_torch.models.classifiers import CNNClassifier
from cfgan_torch.models.generators import ImageResidualGenerator
from cfgan_torch.nn.layers import Conv

BF16_ATOL = 4e-3


def _batch(b=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (b, 28, 28, 1)).astype(np.float32)
    t = rng.integers(0, 10, b).astype(np.int32)
    m = (rng.uniform(size=(b, 28, 28, 1)) > 0.5).astype(np.float32)
    return x, t, m


def _generator_pair(impl, base_ch=16, n_res=2, seed=0):
    x, t, m = _batch()
    jg = JaxGenerator(base_ch=base_ch, n_resblocks=n_res, conv_impl=impl)
    v = jax.tree_util.tree_map(
        np.asarray, dict(jg.init(jax.random.key(seed), x, t, m,
                                 train=False)))
    rng = np.random.default_rng(seed + 1)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        v["batch_stats"])
    tg = ImageResidualGenerator(base_ch=base_ch, n_resblocks=n_res,
                                conv_impl=impl)
    tg.load_state_dict(state_dict_from_flax(tg, v))
    return jg, v, tg.eval()


@pytest.mark.parametrize("impl", ["pallas", None, "matmul"])
def test_generator_matches_jax_f32(impl):
    jg, v, tg = _generator_pair(impl)
    x, t, m = _batch()
    j_raw, j_masked = jg.apply(v, x, t, m, train=False)
    with torch.no_grad():
        raw, masked = tg(torch.from_numpy(x), torch.from_numpy(t).long(),
                         torch.from_numpy(m))
    np.testing.assert_allclose(raw.numpy(), np.asarray(j_raw), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(masked.numpy(), np.asarray(j_masked),
                               atol=1e-5, rtol=0)


def test_generator_matches_jax_bf16():
    """Everything cast to bf16, as the JAX serving `cf_fn` casts it."""
    jg, v, tg = _generator_pair("pallas")
    x, t, m = _batch()
    vb = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), v)
    j_raw, _ = jg.apply(vb, jnp.asarray(x, jnp.bfloat16), t,
                        jnp.asarray(m, jnp.bfloat16), train=False)
    tg = tg.to(torch.bfloat16)
    with torch.no_grad():
        raw, _ = tg(torch.from_numpy(x).bfloat16(),
                    torch.from_numpy(t).long(),
                    torch.from_numpy(m).bfloat16())
    assert raw.dtype == torch.bfloat16
    np.testing.assert_allclose(raw.float().numpy(),
                               np.asarray(j_raw, np.float32),
                               atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_classifier_matches_jax(dtype):
    x, _, _ = _batch(seed=2)
    jc = JaxClassifier()
    v = jax.tree_util.tree_map(np.asarray,
                               dict(jc.init(jax.random.key(1), x)))
    tc = CNNClassifier()
    tc.load_state_dict(state_dict_from_flax(tc, v))
    tc.eval()
    jd = jnp.dtype(dtype)
    want = jc.apply(jax.tree_util.tree_map(lambda a: jnp.asarray(a, jd), v),
                    jnp.asarray(x, jd), train=False)
    with torch.no_grad():
        got = tc.to(getattr(torch, dtype))(
            torch.from_numpy(x).to(getattr(torch, dtype)))
    atol = 1e-5 if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _jax_kernel_layers(jg, v, x, t, m):
    """Scope paths of the JAX layers that call the Pallas kernel."""
    routed = []

    def record(next_fun, args, kwargs, context):
        mod = context.module
        if (isinstance(mod, _Conv3x3Matmul) and mod.variant == "pallas"
                and context.method_name == "__call__"):
            routed.append(".".join(mod.scope.path[:-1]))  # drop Conv_0
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(record):
        jax.eval_shape(lambda vv: jg.apply(vv, x, t, m, train=False), v)
    return sorted(routed)


@pytest.mark.parametrize("base_ch,n_res,n_kernel", [(64, 6, 13), (16, 2, 5),
                                                    (8, 1, 0)])
def test_kernel_routing_matches_the_jax_gate(base_ch, n_res, n_kernel):
    """At full width 13 of the generator's 15 convs (12 resblock convs and
    conv_mid) take the kernel; conv_in (Cin = 3) and conv_out (Cout = 1)
    stay on cuDNN.  Below 16 channels nothing is routed."""
    x, t, m = _batch(b=2)
    jg = JaxGenerator(base_ch=base_ch, n_resblocks=n_res,
                      conv_impl="pallas")
    v = jax.eval_shape(lambda: jg.init(jax.random.key(0), x, t, m,
                                       train=False))
    tg = ImageResidualGenerator(base_ch=base_ch, n_resblocks=n_res,
                                conv_impl="pallas")
    ours = sorted(name for name, mod in tg.named_modules()
                  if isinstance(mod, Conv) and mod.impl == "pallas")
    assert ours == _jax_kernel_layers(jg, v, x, t, m)
    assert len(ours) == n_kernel
