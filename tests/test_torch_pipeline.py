"""The port's host pipeline against the JAX package's, on the CPU:
`HostIterator` batch for batch, bit for bit, over two epochs;
`num_steps`; `DevicePrefetcher` on the CPU (values, order, length and how
far it reads ahead) across buffer sizes; `device_put_dataset` on a
one-device mesh; and in gloo worlds of two ranks (a data axis) and four
(a 2x2 ("data", "model") mesh), the prefetcher's rows under a batch
sharding against JAX's device shards.  No JAX step is compiled here."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import torch_world
from cfgan.data.pipeline import DevicePrefetcher as JaxDevicePrefetcher
from cfgan.data.pipeline import HostIterator as JaxHostIterator
from cfgan.data.pipeline import device_put_dataset as jax_device_put_dataset
from cfgan.data.pipeline import num_steps as jax_num_steps
from cfgan_torch.data.pipeline import (
    DevicePrefetcher,
    HostIterator,
    device_put_dataset,
    num_steps,
)
from cfgan_torch.parallel import create_mesh, spawn_world
from cfgan_torch.parallel.sharding import (
    Sharding,
    batch_sharding,
    replicate_sharding,
)

N = 23


def _arrays(n=N, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((n, 3)).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int32),
            rng.randint(0, 256, (n, 2, 2)).astype(np.uint8))


def _epochs(it, epochs=2):
    return [[tuple(np.asarray(a) for a in b) for b in it]
            for _ in range(epochs)]


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)


@pytest.mark.parametrize("batch_size", [1, 4, 5, 7, 23, 30])
@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_host_iterator_is_jax_batch_for_batch(shuffle, drop_last, seed,
                                              batch_size):
    """Two epochs of the same iterator (the shuffle's state carries over)
    give JAX's batches bit for bit; `len` and `num_steps` are JAX's."""
    arrays = _arrays(seed=seed)
    ours = HostIterator(arrays, batch_size, shuffle, seed, drop_last)
    theirs = JaxHostIterator(arrays, batch_size, shuffle, seed, drop_last)
    got, want = _epochs(ours), _epochs(theirs)
    for g, w in zip(got, want):
        _same_batches(g, w)
    assert len(ours) == len(theirs) == len(got[0])
    assert num_steps(N, batch_size) == jax_num_steps(N, batch_size)
    if shuffle and batch_size < N:
        assert not np.array_equal(got[0][0][0], got[1][0][0])


class _Counted:
    """A host iterator that counts the batches drawn from it."""

    def __init__(self, it):
        self.it, self.drawn = it, 0

    def __iter__(self):
        for b in self.it:
            self.drawn += 1
            yield b

    def __len__(self):
        return len(self.it)


@pytest.mark.parametrize("n,batch_size", [(N, 4), (5, 2), (1, 3)],
                         ids=["long", "shorter-than-buffers", "one-batch"])
@pytest.mark.parametrize("buffer_size", [0, 1, 2, 5])
def test_prefetcher_on_the_cpu_is_jax(buffer_size, n, batch_size):
    """`device="cpu"`: the values, order and `len` of JAX's prefetcher on
    its CPU device, drawing as far ahead of the consumer as JAX's does."""
    arrays = _arrays(n)[:2]  # float32 and int32: JAX keeps both dtypes
    ours = _Counted(HostIterator(arrays, batch_size, True, 3))
    theirs = _Counted(JaxHostIterator(arrays, batch_size, True, 3))
    feed = DevicePrefetcher(ours, buffer_size, device="cpu")
    jax_feed = JaxDevicePrefetcher(theirs, buffer_size)
    assert len(feed) == len(jax_feed) == len(ours)
    it, jit = iter(feed), iter(jax_feed)
    first, jax_first = next(it), next(jit)
    assert ours.drawn == theirs.drawn == min(max(1, buffer_size) + 1,
                                             len(ours))
    got = [first] + list(it)
    want = [jax_first] + list(jit)
    assert all(t.device.type == "cpu" and isinstance(t, torch.Tensor)
               for b in got for t in b)
    _same_batches([tuple(t.numpy() for t in b) for b in got],
                  [tuple(np.asarray(a) for a in b) for b in want])


def test_prefetcher_on_the_cpu_copies_the_host_batch():
    """A yielded tensor does not share the host batch's memory (JAX's
    `device_put` copies too), and read-only host arrays are taken."""
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    x.flags.writeable = False
    batch = next(iter(DevicePrefetcher([(x,)], device="cpu")))[0]
    assert np.array_equal(batch.numpy(), x)
    batch += 1
    assert x[0, 0] == 0


def test_prefetcher_defaults_to_the_card():
    """Without a device or a sharding the prefetcher resolves to the card:
    on a host without one it raises, and runs on the CPU only when
    asked."""
    if torch.cuda.is_available():
        pytest.skip("the host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePrefetcher(HostIterator(_arrays(), 4))


@pytest.mark.parametrize("replicated", [False, True])
def test_prefetcher_with_a_sharding_on_one_device(replicated):
    """On a one-process mesh of the CPU, a batch sharding and a replicated
    one both yield the whole batch on the mesh's device, as JAX's
    `NamedSharding` over one CPU device gives."""
    arrays = _arrays()[:2]
    mesh = create_mesh(devices=["cpu"])
    sharding = (replicate_sharding(mesh) if replicated
                else batch_sharding(mesh))
    jmesh = JaxMesh(np.asarray(jax.devices()[:1]), ("data",))
    jsharding = NamedSharding(jmesh, P() if replicated else P("data"))
    feed = DevicePrefetcher(HostIterator(arrays, 5), 2, sharding)
    jax_feed = JaxDevicePrefetcher(JaxHostIterator(arrays, 5), 2, jsharding)
    assert feed.device == torch.device("cpu")
    _same_batches([tuple(t.numpy() for t in b) for b in feed],
                  [tuple(np.asarray(a) for a in b) for b in jax_feed])


def test_prefetcher_refuses_shardings_it_cannot_yield():
    """One tensor an array a batch: a mesh of several devices in one
    process, or a split past the rows, raises."""
    host = HostIterator(_arrays()[:2], 4)
    mesh = create_mesh(devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="one device a process"):
        DevicePrefetcher(host, 2, batch_sharding(mesh))
    one = create_mesh(devices=["cpu"])
    with pytest.raises(ValueError, match="rows only"):
        DevicePrefetcher(host, 2, Sharding(one, (None, "data")))


def test_device_put_dataset_on_a_one_device_mesh():
    """Each array whole on the mesh's device, of its dtype, with JAX's
    values."""
    arrays = _arrays()
    mesh = create_mesh(devices=["cpu"])
    jmesh = JaxMesh(np.asarray(jax.devices()[:1]), ("data",))
    got = device_put_dataset(mesh, *arrays)
    want = jax_device_put_dataset(jmesh, *arrays)
    assert isinstance(got, tuple) and len(got) == len(want) == 3
    for g, w, a in zip(got, want, arrays):
        assert g.device.type == "cpu"
        assert g.numpy().dtype == a.dtype
        assert np.array_equal(g.numpy(), np.asarray(w))


WORLD = 2


@pytest.fixture(scope="module")
def world():
    x, y = _arrays(24)[:2]
    return x, y, spawn_world(torch_world.prefetched_rows, WORLD, (x, y, 8),
                             timeout=300)


def _jax_shards(a, world):
    mesh = JaxMesh(np.asarray(jax.devices()[:world]), ("data",))
    placed = jax.device_put(a, NamedSharding(mesh, P("data")))
    return [np.asarray(s.data) for s in
            sorted(placed.addressable_shards, key=lambda s: s.index[0].start)]


def test_prefetcher_yields_a_ranks_rows_of_each_batch(world):
    """Under a batch sharding rank r gets JAX's device shard r of every
    batch; under a replicated one, the whole batch."""
    x, y, outs = world
    batches = list(JaxHostIterator((x, y), 8))
    for r, out in enumerate(outs):
        assert out["rank"] == r
        assert out["rows_device"] == "cpu"
        assert len(out["rows"]) == len(batches) == 3
        for (gx, gy), (bx, by) in zip(out["rows"], batches):
            np.testing.assert_array_equal(gx, _jax_shards(bx, WORLD)[r])
            np.testing.assert_array_equal(gy, _jax_shards(by, WORLD)[r])
        for (gx, gy), (bx, by) in zip(out["whole"], batches):
            np.testing.assert_array_equal(gx, bx)
            np.testing.assert_array_equal(gy, by)


def test_device_put_dataset_gives_every_rank_the_dataset(world):
    x, y, outs = world
    for out in outs:
        assert out["placed_equal"]
        np.testing.assert_array_equal(out["placed"][0], x)
        np.testing.assert_array_equal(out["placed"][1], y)


MESH2D = (2, 2)


@pytest.fixture(scope="module")
def world2d():
    x, y = _arrays(24)[:2]
    return x, y, spawn_world(torch_world.prefetched_rows, 4,
                             (x, y, 8, MESH2D), timeout=300)


def _jax_shard_on(a, spec, coords):
    """JAX's shard of `a` on the device at `coords` of a 2x2 ("data",
    "model") mesh under `PartitionSpec(spec)`."""
    mesh = JaxMesh(np.asarray(jax.devices()[:4]).reshape(MESH2D),
                   ("data", "model"))
    placed = jax.device_put(a, NamedSharding(mesh, P(spec)))
    shards = {s.device: np.asarray(s.data)
              for s in placed.addressable_shards}
    return shards[mesh.devices[coords]]


def test_prefetcher_on_a_2d_mesh_yields_jax_shards(world2d):
    """On a 2x2 ("data", "model") mesh rank (d, m) gets block d of each
    batch split over "data" and block m of one split over "model", the
    shards JAX's `NamedSharding` puts on the device at (d, m); a
    replicated sharding gives the whole batch."""
    x, y, outs = world2d
    batches = list(JaxHostIterator((x, y), 8))
    for r, out in enumerate(outs):
        assert out["rank"] == r
        coords = out["coords"]
        assert coords == (r // 2, r % 2)
        for name, spec in (("rows", "data"), ("rows_model", "model")):
            assert len(out[name]) == len(batches) == 3
            for got, batch in zip(out[name], batches):
                for g, b in zip(got, batch):
                    np.testing.assert_array_equal(
                        g, _jax_shard_on(b, spec, coords))
        for got, batch in zip(out["whole"], batches):
            for g, b in zip(got, batch):
                np.testing.assert_array_equal(g, b)
        assert out["placed_equal"]
