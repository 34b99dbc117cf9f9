"""Sharded serving (`CounterfactualEngine.shard`) and the launcher's
`--shard` against the JAX package's, on the CPU: the committed moons and
house run dirs (`results/moons_countergan/`, `results/house_countergan/`)
through both packages' `setup_*`, each engine sharded over 8 shards (JAX's
8 virtual CPU devices; the port's `create_mesh(devices=["cpu"] * 8)`), at
b = 1, 5, 16, 100 and in bulk chunks of 16 (tests/test_sharding.py:
173-257).

Bar: the JAX package's, `atol=1e-6` (tests/test_sharding.py:193-209), on
x_cf, the residual and both probabilities, predictions equal, for the
sharded engine against the same engine unsharded and against JAX's
sharded engine (measured: at most 6e-7 from JAX's).
"""
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cfgan.parallel.mesh import create_mesh as jax_create_mesh
from cfgan.serve import launch as jlaunch
from cfgan_torch.models.tabular import jax_key
from cfgan_torch.parallel import create_mesh
from cfgan_torch.parallel.mesh import Mesh
from cfgan_torch.serve import launch
from cfgan_torch.serve.client import CFClient

ROOT = Path(__file__).resolve().parent.parent
RESULTS = ROOT / "results"
ATOL = 1e-6  # tests/test_sharding.py:193-209
SIZES = (1, 5, 16, 100)


def _mesh():
    return create_mesh(devices=["cpu"] * 8)


def _assert_close(got, want):
    for name in ("x_cf", "residual", "probs", "probs_orig", "confidence"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   atol=ATOL, rtol=0, err_msg=name)
    np.testing.assert_array_equal(got.pred, want.pred)
    np.testing.assert_array_equal(got.flipped, want.flipped)


@pytest.fixture(scope="module")
def moons():
    run_dir = str(RESULTS / "moons_countergan")
    jeng = jlaunch.setup_moons(run_dir)[0].shard(jax_create_mesh())
    plain, _, xte, _ = launch.setup_moons(run_dir, device="cpu")
    sharded = launch.setup_moons(run_dir, device="cpu")[0].shard(_mesh())
    return jeng, plain, sharded, xte


@pytest.fixture(scope="module")
def house():
    run_dir = str(RESULTS / "house_countergan")
    jeng = jlaunch.setup_house(run_dir)[0].shard(jax_create_mesh())
    plain, xte = launch.setup_house(run_dir, device="cpu")[:2]
    sharded = launch.setup_house(run_dir, device="cpu")[0].shard(_mesh())
    return jeng, plain, sharded, xte


@pytest.mark.parametrize("b", SIZES)
def test_sharded_moons_generate_matches(moons, b):
    jeng, plain, sharded, xte = moons
    x = xte[:b]
    got = sharded.generate(x, 1)
    _assert_close(got, plain.generate(x, 1))
    _assert_close(got, jeng.generate(x, target=1))


@pytest.mark.parametrize("b", SIZES)
def test_sharded_house_generate_matches(house, b):
    """Each shard's Gumbel noise is its rows' of the whole request, so a
    row's counterfactual does not depend on the shard it lands in."""
    jeng, plain, sharded, xte = house
    x, t = xte[:b], np.arange(b) % 4
    got = sharded.generate(x, t, key=jax_key(5))
    _assert_close(got, plain.generate(x, t, key=jax_key(5)))
    _assert_close(got, jeng.generate(x, t, key=jax.random.key(5)))


@pytest.mark.parametrize("app", ["moons", "house"])
def test_sharded_bulk_matches(moons, house, app):
    """`generate_bulk` with chunk 16: each chunk split over the 8 shards."""
    jeng, plain, sharded, xte = {"moons": moons, "house": house}[app]
    x = xte[:100]
    got = sharded.generate_bulk(x, 2, key=jax_key(1), chunk=16)
    _assert_close(got, plain.generate_bulk(x, 2, key=jax_key(1), chunk=16))
    _assert_close(got, jeng.generate_bulk(x, 2, key=jax.random.key(1),
                                          chunk=16))


def test_bulk_chunk_must_split_over_the_shards(moons):
    jeng, _, sharded, xte = moons
    with pytest.raises(ValueError):
        jeng.generate_bulk(xte[:100], 2, chunk=12)
    with pytest.raises(ValueError, match="multiple of the mesh"):
        sharded.generate_bulk(xte[:100], 2, chunk=12)


def test_shard_after_the_first_request_raises():
    """Construct-then-serve: `shard` after a served request raises, as the
    JAX engine's does."""
    run_dir = str(RESULTS / "moons_countergan")
    engine, _, xte, _ = launch.setup_moons(run_dir, device="cpu")
    engine.generate(xte[:2], 0)
    with pytest.raises(RuntimeError, match="already served"):
        engine.shard(_mesh())
    jeng = jlaunch.setup_moons(run_dir)[0]
    jeng.generate(xte[:2], 0)
    with pytest.raises(RuntimeError):
        jeng.shard(jax_create_mesh())


def test_a_mesh_over_processes_or_another_axis_is_rejected(moons):
    """The engine serves its own process's devices: a mesh over two
    processes is refused.  Along the "model" axis of a (4, 2) mesh it
    serves 2 shards, as JAX's engine sharded along that axis does, and
    within the bar of it; an axis the mesh does not have is refused."""
    run_dir = str(RESULTS / "moons_countergan")
    engine = launch.setup_moons(run_dir, device="cpu")[0]

    class TwoProcesses(Mesh):
        world_size = 2

    with pytest.raises(ValueError, match="processes"):
        engine.shard(TwoProcesses(("data",), (2,), (torch.device("cpu"),)))
    mesh = create_mesh((4, 2), ("data", "model"), devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="no axis"):
        engine.shard(mesh, axis="pipe")
    engine.shard(mesh, axis="model")
    assert len(engine._shards) == 2
    jeng = jlaunch.setup_moons(run_dir)[0].shard(
        jax_create_mesh((4, 2), ("data", "model")), "model")
    _, plain, _, xte = moons
    got = engine.generate(xte[:37], 2)
    _assert_close(got, plain.generate(xte[:37], 2))
    _assert_close(got, jeng.generate(xte[:37], target=2))


def test_replicas_on_other_devices():
    """A device other than the engine's serves through `replica_fn` (here
    the devices cpu:1 and cpu:2, which torch keeps on the CPU): one
    replica a device, results equal to the unsharded engine's; an engine
    without a `replica_fn` refuses such a mesh."""
    run_dir = str(RESULTS / "moons_countergan")
    plain, _, xte, _ = launch.setup_moons(run_dir, device="cpu")
    engine = launch.setup_moons(run_dir, device="cpu")[0]
    made = []
    replica_fn = engine.replica_fn
    engine.replica_fn = lambda dev: made.append(dev) or replica_fn(dev)
    engine.shard(create_mesh(devices=["cpu", "cpu:1", "cpu:2", "cpu:1"]))
    assert made == [torch.device("cpu", 1), torch.device("cpu", 2)]
    got = engine.generate(xte[:37], 2)
    _assert_close(got, plain.generate(xte[:37], 2))
    bare = launch.setup_moons(run_dir, device="cpu")[0]
    bare.replica_fn = None
    with pytest.raises(ValueError, match="replica_fn"):
        bare.shard(create_mesh(devices=["cpu", "cpu:1"]))


def test_shard_needs_api():
    with pytest.raises(SystemExit):
        launch.main(["--app", "moons", "--shard", "--device", "cpu"])


def test_main_serves_sharded_in_a_subprocess(tmp_path):
    """`--api --shard --device cpu`: the launcher shards its engine over
    the named device and serves what the in-process engine does."""
    out, err = tmp_path / "out.txt", tmp_path / "err.txt"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    with open(out, "w") as fo, open(err, "w") as fe:
        proc = subprocess.Popen(
            [sys.executable, "-m", "cfgan_torch.serve.launch", "--app",
             "moons", "--api", "--shard", "--port", "0", "--device", "cpu"],
            cwd=ROOT, env=env, stdout=fo, stderr=fe)
    try:
        deadline, base = time.monotonic() + 120, None
        while base is None and time.monotonic() < deadline:
            m = re.search(r"listening on (http://\S+)", out.read_text())
            if m:
                base = m.group(1)
            elif proc.poll() is not None:
                break
            time.sleep(0.2)
        assert base, f"no address printed (exit {proc.poll()}): " \
                     f"{err.read_text()[-2000:]}"
        engine, _, xte, _ = launch.setup_moons(
            str(RESULTS / "moons_countergan"), device="cpu")
        c = CFClient(base, wire="npz")
        got = c.counterfactual(xte[:60], [0, 1, 2] * 20)
        want = engine.generate(xte[:60], np.asarray([0, 1, 2] * 20))
        _assert_close(got, want)
        c.close()
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0, err.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
