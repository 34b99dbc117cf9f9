"""The port's 2-D ("data", "model") mesh and channel-sharded layout
(`cfgan_torch.parallel`) against the JAX package's (`cfgan/parallel/
mesh.py:22-44`, `cfgan/parallel/sharding.py:40-64`), on the CPU:

- `channel_sharding_spec` leaf by leaf against JAX's for every family's
  generator at its shipped widths (MNIST on both conv routes, legacy,
  house, moons and the five generation presets), at "model" sizes 2 and
  4; JAX's shapes from `jax.eval_shape`, the port's dimensions mapped to
  flax's through `cfgan_torch.convert`'s layouts;
- a (4, 2) mesh over 8 CPU devices in one process against JAX's over its
  8 virtual devices: shape, names, each device's coordinates, and
  `shard_batch` along either axis against JAX's device shards;
- a (2, 2) world of 4 ranks joined by gloo (tests/torch_world.py): each
  rank's coordinates (row-major), the ranks of its "data" and "model"
  groups, and its blocks of a batch along either axis against JAX's
  device shards on a (2, 2) mesh;
- the engine sharded on the (4, 2) mesh along each axis against JAX's
  `engine.shard(mesh, axis)` on the committed moons run dir, at the
  sharded serving bar `atol=1e-6` (tests/test_sharding.py:193-209).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world
from cfgan.data.kc_house import KC_SCHEMA as JAX_SCHEMA
from cfgan.experiments import presets as jp
from cfgan.models import generators as jg
from cfgan.parallel.mesh import create_mesh as jax_create_mesh
from cfgan.parallel.sharding import channel_sharding_spec as jax_spec
from cfgan.parallel.sharding import shard_batch as jax_shard_batch
from cfgan.serve import launch as jlaunch
from cfgan_torch.convert import flax_axes, flax_from_state_dict
from cfgan_torch.data.kc_house import KC_SCHEMA, load_kc_house
from cfgan_torch.experiments import presets as pp
from cfgan_torch.models.classifiers import TabularClassifier
from cfgan_torch.parallel import (
    channel_sharding_spec,
    create_mesh,
    shard_batch,
    spawn_world,
)
from cfgan_torch.serve import launch
from cfgan_torch.train.builders import (
    build_tabular_countergan,
    mnist_models,
    moons_models,
)
from cfgan_torch.train.gan_builders import gan_models

TIMEOUT = 180  # seconds a world may take before the test fails
SERVE_ATOL = 1e-6  # tests/test_sharding.py:193-209
MODEL_SIZES = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ spec
def _image_inputs():
    x0 = jnp.zeros((2, 28, 28, 1))
    return x0, jnp.zeros((2,), jnp.int32), x0


def _mnist_pair(conv_impl=None):
    cfg = pp.MNIST_COUNTERGAN.countergan
    if conv_impl:
        from dataclasses import replace

        cfg = replace(cfg, conv_impl=conv_impl)
    j = jg.ImageResidualGenerator(
        image_hw=(28, 28), num_classes=10, base_ch=cfg.hidden_dim,
        n_resblocks=cfg.num_res_blocks,
        residual_scaling=cfg.residual_scaling)
    return j, _image_inputs(), mnist_models(cfg)[0]


def _legacy_pair():
    cfg = pp.MNIST_COUNTERGAN_LEGACY.countergan
    j = jg.DeltaImageGenerator(num_classes=10, base_ch=cfg.hidden_dim)
    return j, _image_inputs(), mnist_models(cfg, legacy_delta=True)[0]


def _house_pair():
    jcfg, cfg = jp.HOUSE_COUNTERGAN.countergan, pp.HOUSE_COUNTERGAN.countergan
    j = jg.TabularResidualGenerator(
        input_dim=17, hidden_dim=jcfg.hidden_dim, num_classes=4,
        continuous_idx=JAX_SCHEMA.continuous_idx,
        categorical_info=JAX_SCHEMA.categorical_info,
        n_blocks=jcfg.num_res_blocks, residual_scaling=jcfg.residual_scaling,
        tau=jcfg.gumbel_tau, cat_head_f32=jcfg.cat_head_f32)
    x0 = jnp.zeros((2, 17))
    port = build_tabular_countergan(
        cfg, TabularClassifier(4, 17).state_dict(), KC_SCHEMA,
        load_kc_house()[2], device="cpu").state.g.model
    return j, (x0, jnp.zeros((2, 4)), x0), port


def _moons_pair():
    cfg = pp.MOONS_COUNTERGAN.countergan
    j = jg.MoonsResidualGenerator(input_dim=2, hidden_dim=cfg.hidden_dim)
    x0 = jnp.zeros((2, 2))
    return j, (x0, jnp.zeros((2, 3)), x0), moons_models(cfg)[0]


def _gan_pair(name, nc):
    cfg = getattr(pp, name).gan
    ld, h = cfg.latent_dim, cfg.hidden_dim
    z0, oh0 = jnp.zeros((2, ld)), jnp.zeros((2, nc))
    j, inputs = {
        "simple_mlp": (lambda: jg.MLPGenerator(out_dim=2, hidden_dim=h),
                       (z0,)),
        "mlp_image": (lambda: jg.MLPImageGenerator(), (z0,)),
        "cgan_mlp": (lambda: jg.ConditionalMLPGenerator(out_dim=2,
                                                        hidden_dim=h),
                     (z0, oh0)),
        "dcgan": (lambda: jg.DCGANGenerator(g_hidden=h), (z0,)),
        "wgan_gp": (lambda: jg.WGANGenerator(generator_size=h,
                                             num_classes=nc), (z0, oh0)),
    }[cfg.family]
    return j(), inputs, gan_models(cfg, nc)[0]


FAMILIES = {
    "mnist": _mnist_pair,
    "mnist-kernel": lambda: _mnist_pair("pallas"),
    "legacy": _legacy_pair,
    "house": _house_pair,
    "moons": _moons_pair,
    "simple_gan_moons": lambda: _gan_pair("SIMPLE_GAN_MOONS", 3),
    "simple_gan_mnist": lambda: _gan_pair("SIMPLE_GAN_MNIST", 10),
    "cgan_moons": lambda: _gan_pair("CGAN_MOONS", 3),
    "wgan_gp_mnist": lambda: _gan_pair("WGAN_GP_MNIST", 10),
    "dcgan_mnist": lambda: _gan_pair("DCGAN_MNIST", 10),
}


def _jax_params(model, inputs):
    """The generator's params as shapes, by `jax.eval_shape`."""
    key = jax.random.key(0)

    def init():
        try:
            return model.init({"params": key, "gumbel": key}, *inputs,
                              train=False)["params"]
        except TypeError:  # a generator without a train flag
            return model.init(key, *inputs)["params"]

    return jax.eval_shape(init)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _port_spec_in_flax_layout(module, spec):
    """The port's spec as {flax path: the mesh axis of each flax
    dimension}, through `convert`'s names and layouts."""
    out = {}
    for name, p in module.named_parameters():
        (path, _), = _flat(flax_from_state_dict(module, {name: p})["params"])
        axes = flax_axes(module, name, p.ndim)
        dims = spec[name].spec + (None,) * (p.ndim - len(spec[name].spec))
        out[path] = tuple(dims[a] for a in axes)
    return out


@pytest.mark.parametrize("size", MODEL_SIZES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_channel_sharding_spec_is_jax_leaf_by_leaf(family, size):
    """Every generator leaf is split over "model" on the same dimension as
    JAX splits it, or kept whole where JAX keeps it whole."""
    jmodel, inputs, port = FAMILIES[family]()
    jmesh = jax_create_mesh((8 // size, size), ("data", "model"))
    mesh = create_mesh((8 // size, size), ("data", "model"),
                       devices=["cpu"] * 8)
    shapes = _jax_params(jmodel, inputs)
    ndims = {path: len(x.shape) for path, x in _flat(dict(shapes))}
    want = {path: tuple(sh.spec) + (None,) * (ndims[path] - len(sh.spec))
            for path, sh in _flat(dict(jax_spec(jmesh, shapes)))}
    spec = channel_sharding_spec(mesh, port, axis="model")
    got = _port_spec_in_flax_layout(port, spec)
    assert got == want
    split = sum(not s.is_fully_replicated for s in spec.values())
    assert split == sum(any(a is not None for a in v) for v in want.values())
    assert split > 0


def test_mnist_spec_splits_all_but_conv_out():
    """The shipped MNIST generator at "model" size 2: every leaf but
    `conv_out`'s kernel and bias is split; the embedding on its 784."""
    _, _, port = _mnist_pair()
    mesh = create_mesh((4, 2), ("data", "model"), devices=["cpu"] * 8)
    spec = channel_sharding_spec(mesh, port)
    whole = sorted(n for n, s in spec.items() if s.is_fully_replicated)
    assert whole == ["conv_out.bias", "conv_out.weight"]
    assert spec["embed.weight"].spec == (None, "model")
    params = dict(port.named_parameters())
    split = sum(params[n].numel() for n, s in spec.items()
                if not s.is_fully_replicated)
    assert split == sum(p.numel() for p in params.values()) - 64 * 9 - 1


# ------------------------------------------------------------------ mesh
def _jax_device_shards(arr, mesh):
    """{device id: the block of `arr` on it}."""
    return {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}


def test_2d_mesh_in_one_process_is_jax_mesh():
    """(4, 2) over 8 CPU devices: JAX's shape and names, each device at
    its row-major coordinates, and each device's block of a batch along
    either axis JAX's device shard."""
    mesh = create_mesh((4, 2), ("data", "model"), devices=["cpu"] * 8)
    jmesh = jax_create_mesh((4, 2), ("data", "model"))
    assert mesh.shape == tuple(jmesh.devices.shape) == (4, 2)
    assert mesh.axis_names == jmesh.axis_names == ("data", "model")
    assert mesh.size == jmesh.size == 8
    assert mesh.axis_size("model") == jmesh.shape["model"] == 2
    ids = [d.id for d in jax.devices()]
    for j in range(8):
        coords = tuple(int(c) for c in np.argwhere(
            jmesh.device_ids == ids[j])[0])
        assert mesh.device_coords(j) == coords
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    for axis in ("data", "model"):
        (xj,) = jax_shard_batch(jmesh, (x,), axis=axis)
        want = _jax_device_shards(xj, jmesh)
        (got,) = shard_batch(mesh, (x,), axis=axis)
        assert len(got) == 8
        for j, block in enumerate(got):
            np.testing.assert_array_equal(block.numpy(), want[ids[j]])


@pytest.mark.parametrize("shape,names", [((4,), ("data",)),
                                         ((8,), ("data", "model")),
                                         ((4, 4), ("data", "model")),
                                         ((2, 2, 2), ("data", "model",
                                                      "data"))])
def test_2d_mesh_shape_must_fit(shape, names):
    """A shape that does not hold the devices, does not name its axes or
    repeats a name raises."""
    with pytest.raises(ValueError):
        create_mesh(shape, names, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def world():
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    return x, spawn_world(torch_world.mesh2d_facts, 4, ((2, 2), x),
                          timeout=TIMEOUT)


def test_2d_world_coordinates_and_groups(world):
    """Rank r of a (2, 2) world sits at divmod(r, 2); its "data" group is
    the ranks of its column, its "model" group those of its row, every
    rank of a group in the same group."""
    _, outs = world
    for r, out in enumerate(outs):
        d, m = divmod(r, 2)
        assert out["rank"] == r and out["world"] == 4
        assert out["shape"] == (2, 2) and out["names"] == ("data", "model")
        assert out["coords"] == (d, m)
        assert out["groups"]["data"] == [m, 2 + m]
        assert out["groups"]["model"] == [2 * d, 2 * d + 1]


def test_2d_world_blocks_are_jax_device_shards(world):
    """Each rank's block along "data" and along "model" is the data of
    JAX's shard on the device at the rank's coordinates of a (2, 2)
    mesh."""
    x, outs = world
    jmesh = jax_create_mesh((2, 2), ("data", "model"),
                            devices=jax.devices()[:4])
    for axis in ("data", "model"):
        (xj,) = jax_shard_batch(jmesh, (x,), axis=axis)
        want = _jax_device_shards(xj, jmesh)
        for r, out in enumerate(outs):
            dev = jmesh.devices[divmod(r, 2)]
            np.testing.assert_array_equal(out["blocks"][axis], want[dev.id])


def test_2d_mesh_over_processes_of_several_devices_is_refused(world):
    """Over 4 processes of two devices each, a mesh with two axes larger
    than 1 raises on every rank, kept on purpose: such a mesh takes one
    device a process.  The 1-D mesh of those 8 devices, and (8, 1), are
    made."""
    _, outs = world
    for out in outs:
        got = out["refusals"]
        for shape in ("(4, 2)", "(2, 4)"):
            assert got[shape] == (
                f"mesh_shape {shape} over 4 processes of 2 devices each: a "
                "mesh with more than one axis larger than 1 takes one "
                "device a process")
        assert got["(8,)"] is None and got["(8, 1)"] is None


# --------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def engines():
    run_dir = "results/moons_countergan"
    jmesh = jax_create_mesh((4, 2), ("data", "model"))
    mesh = create_mesh((4, 2), ("data", "model"), devices=["cpu"] * 8)
    plain, _, xte, _ = launch.setup_moons(run_dir, device="cpu")
    out = {}
    for axis in ("data", "model"):
        out[axis] = (jlaunch.setup_moons(run_dir)[0].shard(jmesh, axis),
                     launch.setup_moons(run_dir, device="cpu")[0].shard(
                         mesh, axis))
    return plain, out, xte


def _assert_close(got, want):
    for name in ("x_cf", "residual", "probs", "probs_orig", "confidence"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   atol=SERVE_ATOL, rtol=0, err_msg=name)
    np.testing.assert_array_equal(got.pred, want.pred)
    np.testing.assert_array_equal(got.flipped, want.flipped)


@pytest.mark.parametrize("b", (1, 5, 100))
@pytest.mark.parametrize("axis", ("data", "model"))
def test_engine_on_2d_mesh_matches_jax(engines, axis, b):
    """The engine sharded on (4, 2) along `axis` serves as many shards as
    the axis has entries, equal to the unsharded engine and to JAX's
    engine sharded along the same axis."""
    plain, by_axis, xte = engines
    jeng, eng = by_axis[axis]
    assert len(eng._shards) == {"data": 4, "model": 2}[axis]
    got = eng.generate(xte[:b], 1)
    _assert_close(got, plain.generate(xte[:b], 1))
    _assert_close(got, jeng.generate(xte[:b], target=1))
