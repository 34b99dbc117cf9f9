"""The port's mesh and sharding layer (`cfgan_torch.parallel`) against the
JAX package's (`cfgan.parallel`), on the CPU: the mesh's shape, names and
size; each rank's rows of a batch against JAX's device shards of it;
`replicate` broadcasting rank 0; and the BatchNorm bound to a mesh against
`cfgan.nn.layers.BatchNorm(axis_name="data")` under `jax.shard_map` over 4
of the 8 virtual CPU devices, within 3e-5.

Worlds of ranks are spawned processes joined by gloo on the loopback
(`cfgan_torch.parallel.spawn_world`), one CPU device a rank; they import no
JAX (tests/torch_world.py).  Each world joins with a timeout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

import torch_world
from cfgan.nn.layers import BatchNorm as JaxBatchNorm
from cfgan.parallel.mesh import create_mesh as jax_create_mesh
from cfgan.parallel.sharding import shard_batch as jax_shard_batch
from cfgan_torch.parallel import (
    batch_sharding,
    create_mesh,
    replicate_sharding,
    shard_batch,
    spawn_world,
)
from cfgan_torch.parallel.sharding import shard_rows

TIMEOUT = 180  # seconds a world may take before the test fails
BN_ATOL = 3e-5


def test_mesh_has_8_devices():
    """`create_mesh` over 8 CPU shards in one process, as JAX's over its 8
    virtual devices (tests/test_sharding.py::test_mesh_has_8_devices)."""
    mesh = create_mesh(devices=["cpu"] * 8)
    jmesh = jax_create_mesh()
    assert mesh.size == jmesh.devices.size == 8
    assert mesh.axis_names == jmesh.axis_names == ("data",)
    assert mesh.shape == (8,)
    assert mesh.world_size == 1 and mesh.rank == 0 and mesh.group is None
    assert mesh.devices == (torch.device("cpu"),) * 8
    two = create_mesh((8, 1), ("data", "model"), devices=["cpu"] * 8)
    assert two.shape == (8, 1)
    assert batch_sharding(mesh, "data", 3).spec == ("data", None, None)
    assert not batch_sharding(mesh).is_fully_replicated
    assert replicate_sharding(mesh).is_fully_replicated


@pytest.mark.parametrize("shape,names", [((4,), ("data",)),
                                         ((4, 2), ("data", "model")),
                                         ((8,), ("data", "model"))])
def test_mesh_shape_must_fit(shape, names):
    """A shape that does not hold the devices, or does not name its axes,
    raises; the ("data", "model") shape (4, 2) that holds them is JAX's
    mesh: its shape, axis names and each device's coordinates."""
    if len(shape) != len(names) or np.prod(shape) != 8:
        with pytest.raises(ValueError):
            create_mesh(shape, names, devices=["cpu"] * 8)
        return
    mesh = create_mesh(shape, names, devices=["cpu"] * 8)
    jmesh = jax_create_mesh(shape, names)
    assert mesh.shape == tuple(jmesh.devices.shape) == shape
    assert mesh.axis_names == jmesh.axis_names == names
    ids = [d.id for d in jax.devices()]
    for j in range(8):
        where = np.argwhere(jmesh.device_ids == ids[j])[0]
        assert mesh.device_coords(j) == tuple(int(c) for c in where)


def test_sharding_config_is_the_jax_one():
    """`ShardingConfig`'s fields and defaults are the JAX package's;
    `sync_batch_norm=False`, for which neither package has a path,
    raises."""
    from dataclasses import asdict

    from cfgan.core.config import ShardingConfig as JaxShardingConfig
    from cfgan_torch.core.config import ExperimentConfig, ShardingConfig

    assert asdict(ShardingConfig()) == asdict(JaxShardingConfig())
    assert ExperimentConfig().sharding == ShardingConfig()
    with pytest.raises(ValueError):
        ShardingConfig(sync_batch_norm=False)


def test_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError):
        create_mesh()


def test_single_process_shards_are_jax_device_shards():
    """One process with 8 CPU shards: `shard_batch` gives one block a
    device, each JAX's device shard of the same index."""
    x = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    (xj,) = jax_shard_batch(jax_create_mesh(), (x,))
    (blocks,) = shard_batch(create_mesh(devices=["cpu"] * 8), (x,))
    want = sorted(xj.addressable_shards, key=lambda s: s.index[0].start)
    assert len(blocks) == len(want) == 8
    for got, shard in zip(blocks, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))


def _jax_rows(x, world):
    mesh = JaxMesh(np.asarray(jax.devices()[:world]), ("data",))
    (xj,) = jax_shard_batch(mesh, (x,))
    return [np.asarray(s.data) for s in
            sorted(xj.addressable_shards, key=lambda s: s.index[0].start)]


BN_CASES = [(layout, update) for layout in ("nhwc", "rows")
            for update in (True, False)]


def _bn_case(layout):
    """The inputs of a BatchNorm case, and JAX's
    `BatchNorm(axis_name="data")` under `jax.shard_map` over 4 devices on
    them: the output, the input gradient and the parameter gradients of
    sum(y * w), and the updated running statistics."""
    rng = np.random.RandomState(0)
    shape = (8, 3, 3, 5) if layout == "nhwc" else (16, 5)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    w = rng.randn(*shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bias = rng.randn(5).astype(np.float32)

    mesh = JaxMesh(np.asarray(jax.devices()[:4]), ("data",))
    bn = JaxBatchNorm(axis_name="data")
    stats = {"mean": jnp.zeros(5), "var": jnp.ones(5)}

    def local(params, xs, ws):
        y, upd = bn.apply({"params": params, "batch_stats": stats}, xs,
                          use_running_average=False,
                          mutable=["batch_stats"])
        return jax.lax.psum(jnp.sum(y * ws), "data"), (y, upd["batch_stats"])

    f = jax.shard_map(local, mesh=mesh, in_specs=(P(), P("data"), P("data")),
                      out_specs=(P(), (P("data"), P())), check_vma=False)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    (_, (y, new_stats)), (dparams, dx) = jax.jit(jax.value_and_grad(
        lambda p, xs: f(p, xs, w), argnums=(0, 1), has_aux=True))(params, x)
    inputs = {"x": x, "w": w, "scale": scale, "bias": bias}
    want = {"y": y, "dx": dx, "dscale": dparams["scale"],
            "dbias": dparams["bias"], "mean": new_stats["mean"],
            "var": new_stats["var"]}
    return inputs, {k: np.asarray(v) for k, v in want.items()}


WORLD = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One world of 4 ranks for the rows, the replicas and every
    BatchNorm case (a world takes seconds to start)."""
    x = np.arange(48 * 5, dtype=np.float32).reshape(48, 5)
    cases, want = [], {}
    for layout in ("nhwc", "rows"):
        inputs, want[layout] = _bn_case(layout)
        for update in (True, False):
            npz = tmp_path_factory.mktemp("bn") / f"{layout}-{update}.npz"
            torch_world.save_npz(npz, {**inputs,
                                       "update_stats": np.asarray(update)})
            cases.append((f"{layout}-{update}", str(npz)))
    return WORLD, x, want, spawn_world(torch_world.rows_and_replicas, WORLD,
                                       (x, cases), timeout=TIMEOUT)


def test_rank_rows_are_jax_device_shards(world):
    """Rank r's rows are the data of JAX's device shard r on a mesh of as
    many devices."""
    n, x, _, outs = world
    for r, (out, want) in enumerate(zip(outs, _jax_rows(x, n))):
        assert (out["rank"], out["world"], out["size"]) == (r, n, n)
        np.testing.assert_array_equal(out["rows"], want)


def test_replicate_broadcasts_rank_0(world):
    """Trees and a train state made different on each rank hold rank 0's
    values after `replicate`; the state's BatchNorms and the state are
    bound to the mesh, and `states_equal` says so."""
    n, _, _, outs = world
    for out in outs:
        np.testing.assert_array_equal(out["a"], np.full(3, 1.0, np.float32))
        np.testing.assert_array_equal(out["b"], np.arange(4))
        assert len(out["bound"]) == 3 and all(out["bound"])
        assert out["state_mesh"] and out["equal"]
        for got, want in zip(out["state"], outs[0]["state"]):
            assert torch.equal(got, want)


def test_shard_rows_chunk_major():
    """With K chunks a rank holds its block of every chunk, chunk after
    chunk (a mesh of 2 ranks, made by hand)."""
    from cfgan_torch.parallel.mesh import Mesh

    class FakeMesh(Mesh):
        world_size, rank = 2, 1

    mesh = FakeMesh(("data",), (2,), (torch.device("cpu"),))
    a = torch.arange(16)
    assert shard_rows(mesh, a).tolist() == list(range(8, 16))
    assert shard_rows(mesh, a, chunks=2).tolist() == [4, 5, 6, 7, 12, 13,
                                                      14, 15]
    with pytest.raises(ValueError):
        shard_rows(mesh, torch.arange(6), chunks=2)


@pytest.mark.parametrize("layout,update_stats", BN_CASES)
def test_sync_batch_norm_matches_jax_shard_map(world, layout, update_stats):
    """The BatchNorm bound to a mesh of 4 ranks against JAX's
    `BatchNorm(axis_name="data")` under `jax.shard_map` over 4 devices,
    on the same 4 shards: the output, the input gradient and the
    parameter gradients of sum(y * w), and the running statistics (left
    as they were with `update_stats=False`)."""
    _, _, want, outs = world
    want = want[layout]
    got = [o["bn"][f"{layout}-{update_stats}"] for o in outs]
    for key in ("y", "dx"):
        np.testing.assert_allclose(np.concatenate([g[key] for g in got]),
                                   want[key], rtol=0, atol=BN_ATOL,
                                   err_msg=key)
    for g in got:
        for key in ("dscale", "dbias"):
            np.testing.assert_allclose(g[key], want[key], rtol=0,
                                       atol=BN_ATOL, err_msg=key)
        if update_stats:
            for key in ("mean", "var"):
                np.testing.assert_allclose(g[key], want[key], rtol=0,
                                           atol=BN_ATOL, err_msg=key)
        else:
            np.testing.assert_array_equal(g["mean"], np.zeros(5, np.float32))
            np.testing.assert_array_equal(g["var"], np.ones(5, np.float32))


# ------------------------------------ one process a device, kept on purpose
def _moons_bundle(seed: int):
    from cfgan_torch.core.config import MOONS_COUNTERGAN
    from cfgan_torch.models.classifiers import MLPClassifier
    from cfgan_torch.train.builders import build_moons_countergan

    clf = MLPClassifier(generator=torch.Generator().manual_seed(0))
    return build_moons_countergan(MOONS_COUNTERGAN, clf.state_dict(),
                                  seed=seed, device="cpu")


def _state_tensors(state) -> list:
    return [t.detach().clone() for net in (state.g, state.d)
            for t in net.model.state_dict().values()]


def test_loop_refuses_a_one_process_mesh_of_several_devices(tmp_path):
    """JAX trains over every local device from one process
    (`train_countergan_loop(mesh=create_mesh())`); the port trains one
    process a device (`spawn_world`, `torchrun`).  The loop given a mesh of
    two CPU devices in this process raises ValueError before any step and
    before it restores the checkpoint it was pointed at: the state is as
    it was, unbound to the mesh."""
    from cfgan_torch.core.checkpoint import save_train_state
    from cfgan_torch.train.loop import train_countergan_loop

    save_train_state(str(tmp_path / "ck"), _moons_bundle(1).state, epoch=0)
    bundle = _moons_bundle(2)
    before = _state_tensors(bundle.state)
    x = np.zeros((64, 2), np.float32)
    y = np.arange(64) % 3
    mesh = create_mesh(devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="spawn_world") as err:
        train_countergan_loop(bundle, x, y, epochs=1, batch_size=32,
                              mesh=mesh, log=lambda s: None,
                              checkpoint_dir=str(tmp_path / "ck"))
    assert "torchrun" in str(err.value)
    assert "one device a process, not 2" in str(err.value)
    assert bundle.state.step == 0 and bundle.state.mesh is None
    for got, want in zip(_state_tensors(bundle.state), before):
        assert torch.equal(got, want)


def test_replicate_refuses_a_one_process_mesh_of_several_devices():
    from cfgan_torch.parallel import replicate

    bundle = _moons_bundle(2)
    with pytest.raises(ValueError, match="spawn_world, torchrun"):
        replicate(create_mesh(devices=["cpu"] * 2), bundle.state)
