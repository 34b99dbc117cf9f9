"""cfgan_torch.convert: flax variables -> the port's state dicts."""
import copy

import jax
import numpy as np
import pytest
import torch

from cfgan.models.classifiers import CNNClassifier as JaxClassifier
from cfgan.models.generators import ImageResidualGenerator as JaxGenerator
from cfgan_torch.convert import state_dict_from_flax
from cfgan_torch.models.classifiers import CNNClassifier
from cfgan_torch.models.generators import ImageResidualGenerator


@pytest.fixture(scope="module")
def generator_vars():
    """Random numpy variables in the shapes of the JAX generator's."""
    x = np.zeros((2, 28, 28, 1), np.float32)
    t = np.zeros((2,), np.int32)
    jg = JaxGenerator(base_ch=16, n_resblocks=1, conv_impl="pallas")
    shapes = jax.eval_shape(
        lambda: jg.init(jax.random.key(0), x, t, x, train=False))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        dict(shapes))


def _port(impl="pallas"):
    return ImageResidualGenerator(base_ch=16, n_resblocks=1, conv_impl=impl)


def test_layouts(generator_vars):
    v = generator_vars
    sd = state_dict_from_flax(_port(), v)
    # routed to the kernel: HWIO as in flax
    np.testing.assert_array_equal(
        sd["res0.conv1.kernel"].numpy(), v["params"]["res0"]["conv1"][
            "Conv_0"]["kernel"])
    # on cuDNN: OIHW
    np.testing.assert_array_equal(
        sd["conv_in.weight"].numpy(),
        v["params"]["conv_in"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["res0.bn1.running_var"].numpy(),
                                  v["batch_stats"]["res0"]["bn1"]["var"])
    np.testing.assert_array_equal(sd["res0.bn2.weight"].numpy(),
                                  v["params"]["res0"]["bn2"]["scale"])
    np.testing.assert_array_equal(sd["embed.weight"].numpy(),
                                  v["params"]["embed"]["embedding"])


def test_layouts_follow_the_target_impl(generator_vars):
    sd = state_dict_from_flax(_port(None), generator_vars)
    assert sd["res0.conv1.weight"].shape == (16, 16, 3, 3)
    assert "res0.conv1.kernel" not in sd


def test_linear_kernels_are_transposed():
    jc = JaxClassifier()
    v = jax.tree_util.tree_map(np.asarray, dict(jc.init(
        jax.random.key(0), np.zeros((1, 28, 28, 1), np.float32))))
    sd = state_dict_from_flax(CNNClassifier(), v)
    np.testing.assert_array_equal(sd["Linear_0.weight"].numpy(),
                                  v["params"]["Linear_0"]["kernel"].T)
    assert sd["Conv_1.weight"].shape == (64, 32, 3, 3)


def test_rejects_a_missing_key(generator_vars):
    v = copy.deepcopy(generator_vars)
    del v["batch_stats"]["res0"]["bn2"]["mean"]
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_flax(_port(), v)


@pytest.mark.parametrize("where", ["unknown_module", "unknown_leaf",
                                   "unknown_collection"])
def test_rejects_an_extra_key(generator_vars, where):
    v = copy.deepcopy(generator_vars)
    extra = np.zeros(3, np.float32)
    if where == "unknown_module":
        v["params"]["res7"] = {"conv1": {"Conv_0": {"kernel": extra}}}
    elif where == "unknown_leaf":
        v["params"]["conv_mid"]["Conv_0"]["scale"] = extra
    else:
        v["spectral_stats"] = {"conv_mid": {"u": extra}}
    with pytest.raises(KeyError, match="extra"):
        state_dict_from_flax(_port(), v)


def test_rejects_a_wrong_shape(generator_vars):
    v = copy.deepcopy(generator_vars)
    v["params"]["conv_mid"]["Conv_0"]["bias"] = np.zeros(8, np.float32)
    with pytest.raises(ValueError, match="conv_mid.bias"):
        state_dict_from_flax(_port(), v)


def test_loads_strictly(generator_vars):
    m = _port()
    m.load_state_dict(state_dict_from_flax(m, generator_vars), strict=True)
    assert torch.equal(m.conv_out.bias, torch.from_numpy(
        generator_vars["params"]["conv_out"]["Conv_0"]["bias"]))
