"""`cfgan_torch.serve.launch` against `cfgan.serve.launch`, and its `main`,
on the CPU.

- `setup_mnist`, `setup_house` and `setup_moons` with `device="cpu"` on
  the committed run dirs (`results/mnist_countergan_seed43/`,
  `results/house_countergan/`, `results/moons_countergan/`) against the
  JAX package's `setup_*`: the same test split, bit for bit, and engines
  that serve the same counterfactuals.  MNIST reads the IDX fixture
  (`CFGAN_DATA_DIR`), so no synthetic corpus is generated.  Tolerances:
  float32 abs <= 1e-5 (other summation orders) with equal predictions.
  The MNIST preset computes its generator in bf16, where the two packages
  round at other places; on the trained weights the residuals reach
  ~3.5, where one bf16 ulp (2**-6) is over the random-weight serving bar
  of 2**-7.  So each of the port's bf16 routes (cuDNN, and
  `conv_impl="pallas"`, the kernel's plain version on the CPU) is held to
  sit no farther from the float32 result than JAX's bf16 does (max abs +
  2**-7, mean abs), with probabilities within 1e-2 of JAX's; the float32
  engines of both packages on the same run dir agree within 1e-5.
- `main()` in a subprocess with `--api --port 0 --device cpu`: it prints
  the bound address, serves the in-process engine's answers bit for bit,
  and exits 0 on SIGINT.
- `main()` without `--device` raises on a host without a card; without
  `--api` and without gradio it exits non-zero with the ImportError's
  message; its defaults are the JAX launcher's.
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

from cfgan.serve import launch as jlaunch
from cfgan_torch.__main__ import main as port_listing
from cfgan_torch.experiments.presets import PRESETS
from cfgan_torch.models.tabular import jax_key
from cfgan_torch.serve import CFClient
from cfgan_torch.serve import api as papi
from cfgan_torch.serve import launch

ROOT = Path(__file__).resolve().parent.parent
RESULTS = ROOT / "results"
FIXTURE = ROOT / "tests" / "fixtures" / "mnist_idx"
TOL = 1e-5
PROBS_TOL = 1e-2
PALLAS_CF_TOL = 2.0 ** -7


def _assert_close(got, want, atol, p_atol, preds=True):
    for name in ("x_cf", "residual"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   atol=atol, rtol=0, err_msg=name)
    for name in ("probs", "probs_orig", "confidence"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   atol=p_atol, rtol=0, err_msg=name)
    if preds:
        np.testing.assert_array_equal(got.pred, want.pred)
        np.testing.assert_array_equal(got.flipped, want.flipped)


# ---------------------------------------------------------------- setup
def _jax_mnist_float32(run_dir):
    """`cfgan.serve.launch.setup_mnist`'s engine with the preset's
    compute dtype set to float32."""
    import dataclasses

    import jax.numpy as jnp

    from cfgan.experiments.presets import MNIST_COUNTERGAN as cfg
    from cfgan.models.classifiers import CNNClassifier
    from cfgan.serve.engine import CounterfactualEngine as JaxEngine
    from cfgan.train.builders import build_mnist_countergan

    clf_model = CNNClassifier()
    clf_state = jlaunch._load_net(
        os.path.join(run_dir, "classifier"),
        clf_model.init(jax.random.key(0), jnp.zeros((2, 28, 28, 1))))
    bundle = build_mnist_countergan(
        dataclasses.replace(cfg.countergan, compute_dtype="float32"),
        clf_model, clf_state)
    g_state = jlaunch._load_net(os.path.join(run_dir, "generator"),
                                bundle.state.g.variables())
    bundle.state = bundle.state.replace(g=g_state, g_ema=None)
    return JaxEngine.from_bundle(bundle, clf_model, clf_state, patch_size=7)


def _port_mnist_float32(run_dir):
    from dataclasses import replace

    from cfgan_torch.serve.engine import CounterfactualEngine
    from cfgan_torch.train.builders import build_mnist_serving, mnist_models

    cfg = replace(PRESETS["mnist_countergan"].countergan,
                  compute_dtype="float32")
    g, c = mnist_models(cfg)
    s = build_mnist_serving(
        cfg, launch.restore_state_dict(g, os.path.join(run_dir, "generator")),
        launch.restore_state_dict(c, os.path.join(run_dir, "classifier")),
        device="cpu")
    return CounterfactualEngine(s.cf_fn, s.clf_fn, 10, patch_size=7,
                                device="cpu")


@pytest.fixture(scope="module")
def mnist():
    """The preset's engines (bf16 generator) from both packages, the
    port's with `conv_impl="pallas"`, and both packages' float32
    engines on the same run dir."""
    old = os.environ.get("CFGAN_DATA_DIR")
    os.environ["CFGAN_DATA_DIR"] = str(FIXTURE)
    run_dir = str(RESULTS / "mnist_countergan_seed43")
    try:
        jeng, jxte, jyte, jps = jlaunch.setup_mnist(run_dir)
        peng, xte, yte, ps = launch.setup_mnist(run_dir, device="cpu")
        kernel = launch.setup_mnist(run_dir, device="cpu",
                                    conv_impl="pallas")[0]
    finally:
        if old is None:
            del os.environ["CFGAN_DATA_DIR"]
        else:
            os.environ["CFGAN_DATA_DIR"] = old
    assert np.array_equal(xte, jxte) and np.array_equal(yte, jyte)
    assert ps == jps == 7 and len(xte) == 20
    return {"jax": jeng, "cudnn": peng, "pallas": kernel,
            "jax_f32": _jax_mnist_float32(run_dir),
            "port_f32": _port_mnist_float32(run_dir), "x": xte, "y": yte}


MNIST_TARGETS = {"next": lambda y: (y + 1) % 10,
                 "far": lambda y: (y + 5) % 10,
                 "zero": np.zeros_like}


@pytest.mark.parametrize("target", MNIST_TARGETS)
def test_setup_mnist_restores_the_jax_weights(mnist, target):
    """In float32 the two packages' engines on the run dir agree within
    1e-5, with equal predictions."""
    t = MNIST_TARGETS[target](mnist["y"])
    _assert_close(mnist["port_f32"].generate(mnist["x"], t),
                  mnist["jax_f32"].generate(mnist["x"], t), TOL, TOL)


@pytest.mark.parametrize("route", ["cudnn", "pallas"])
@pytest.mark.parametrize("target", MNIST_TARGETS)
def test_setup_mnist_bf16_sits_no_farther_from_f32_than_jax(mnist, route,
                                                            target):
    """The preset's bf16 generator at full width on trained weights
    (residuals up to ~3.5, where a bf16 ulp is 2**-6): either route of
    the port's (cuDNN, and the conv kernel's plain version here) sits no
    farther from the float32 result than the JAX package's bf16 does (max
    abs + 2**-7, mean abs), and its probabilities within 1e-2 of JAX's
    bf16 ones."""
    x, t = mnist["x"], MNIST_TARGETS[target](mnist["y"])
    ref = mnist["port_f32"].generate(x, t).x_cf
    got, want = mnist[route].generate(x, t), mnist["jax"].generate(x, t)
    ours, theirs = np.abs(got.x_cf - ref), np.abs(want.x_cf - ref)
    assert ours.max() <= theirs.max() + PALLAS_CF_TOL
    assert ours.mean() <= theirs.mean()
    for name in ("probs", "probs_orig", "confidence"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   atol=PROBS_TOL, rtol=0, err_msg=name)


def test_setup_mnist_patch_masks_and_bulk_match_jax(mnist):
    """The port's patch mask is JAX's, and leaves every pixel outside its
    patches as it was, bit for bit (bf16 preset, generate and bulk); in
    float32 both packages serve it within 1e-5, through the bulk path
    too."""
    jeng, peng, x = mnist["jax"], mnist["cudnn"], mnist["x"]
    mask = peng.mask_from_patches([0, 5, 10, 15], len(x), (28, 28))
    jmask = np.asarray(jeng.mask_from_patches([0, 5, 10, 15], len(x),
                                              (28, 28)))
    np.testing.assert_array_equal(mask.numpy(), jmask)
    outside = jmask == 0
    for res in (peng.generate(x, 4, mask=mask),
                peng.generate_bulk(x, 4, mask=mask, chunk=8),
                jeng.generate(x, 4, mask=jmask)):
        assert np.array_equal(res.x_cf[outside], x[outside])
    _assert_close(mnist["port_f32"].generate(x, 4, mask=mask),
                  mnist["jax_f32"].generate(x, 4, mask=jmask), TOL, TOL)
    _assert_close(mnist["port_f32"].generate_bulk(x, 4, mask=mask, chunk=8),
                  mnist["jax_f32"].generate_bulk(x, 4, mask=jmask, chunk=8),
                  TOL, TOL)


def test_setup_mnist_classifier_matches_jax(mnist):
    """The classifier serves in float32: within 1e-5, equal argmax."""
    got = mnist["cudnn"].classify(mnist["x"])
    want = mnist["jax"].classify(mnist["x"])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


@pytest.fixture(scope="module")
def house():
    run_dir = str(RESULTS / "house_countergan")
    jeng, jxte, jyte, jschema, jstats, jbins = jlaunch.setup_house(run_dir)
    peng, xte, yte, schema, stats, bins = launch.setup_house(run_dir,
                                                             device="cpu")
    assert np.array_equal(xte, jxte) and np.array_equal(yte, jyte)
    assert schema.feature_names == jschema.feature_names
    assert np.array_equal(stats.data_min, jstats.data_min)
    assert np.array_equal(np.asarray(bins), np.asarray(jbins))
    return jeng, peng, xte


@pytest.mark.parametrize("seed", [0, 17])
def test_setup_house_serves_the_jax_counterfactuals(house, seed):
    jeng, peng, xte = house
    x, t = xte[:200], np.arange(200) % 4
    want = jeng.generate(x, t, key=jax.random.key(seed))
    _assert_close(peng.generate(x, t, key=jax_key(seed)), want, TOL, TOL)


def test_setup_house_default_mask_keeps_the_immutable_features(house):
    jeng, peng, xte = house
    got = peng.generate_bulk(xte[:300], 2, key=jax_key(1), chunk=64)
    want = jeng.generate_bulk(xte[:300], 2, key=jax.random.key(1), chunk=64)
    _assert_close(got, want, TOL, TOL)
    imm = list(peng.schema.immutable_idx)
    assert np.array_equal(got.x_cf[:, imm], xte[:300, imm])


def test_setup_moons_matches_jax():
    run_dir = str(RESULTS / "moons_countergan")
    jeng, jclf, jxte, jyte = jlaunch.setup_moons(run_dir)
    peng, clf_fn, xte, yte = launch.setup_moons(run_dir, device="cpu")
    assert np.array_equal(xte, jxte) and np.array_equal(yte, jyte)
    np.testing.assert_allclose(clf_fn(torch.from_numpy(xte)).numpy(),
                               np.asarray(jclf(xte)), atol=TOL, rtol=0)
    t = (yte + 1) % 3
    _assert_close(peng.generate(xte, t), jeng.generate(xte, t), TOL, TOL)
    assert peng.patch_size is None and peng.schema is None


# ----------------------------------------------------------------- main
def _wait_for_address(proc, out: Path, deadline: float) -> str:
    while time.monotonic() < deadline:
        m = re.search(r"listening on (http://\S+)", out.read_text())
        if m:
            return m.group(1)
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    raise AssertionError(f"no address printed (exit {proc.poll()})")


def test_main_serves_the_api_in_a_subprocess(tmp_path):
    out, err = tmp_path / "out.txt", tmp_path / "err.txt"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    with open(out, "w") as fo, open(err, "w") as fe:
        proc = subprocess.Popen(
            [sys.executable, "-m", "cfgan_torch.serve.launch", "--app",
             "moons", "--api", "--port", "0", "--device", "cpu"],
            cwd=ROOT, env=env, stdout=fo, stderr=fe)
    try:
        base = _wait_for_address(proc, out, time.monotonic() + 120)
        engine, _, xte, _ = launch.setup_moons(
            str(RESULTS / "moons_countergan"), device="cpu")
        for wire in ("npz", "json"):
            c = CFClient(base, wire=wire)
            assert c.health() == {"status": "ok", "num_classes": 3,
                                  "kind": "generic"}
            got = c.counterfactual(xte, [0, 1, 2] * 80)
            want = engine.generate(xte, np.asarray([0, 1, 2] * 80))
            for name in ("x_cf", "residual", "probs", "probs_orig"):
                assert np.array_equal(getattr(got, name),
                                      getattr(want, name)), (wire, name)
            assert np.array_equal(got.pred, want.pred)
            c.close()
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0, err.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture
def keep_tf32(monkeypatch):
    """`main` switches TF32 off; the test process gets its flags back."""
    for mod in (torch.backends.cudnn, torch.backends.cuda.matmul):
        monkeypatch.setattr(mod, "allow_tf32", mod.allow_tf32)


def test_main_without_device_raises_on_a_host_without_a_card(keep_tf32):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--app", "moons", "--api", "--port", "0"])


def test_main_without_api_exits_with_its_message(monkeypatch, keep_tf32):
    """Without `--api`, `main` serves the gradio app; with no gradio it
    exits non-zero with the ImportError's message before loading
    anything, and never serves the API in its place."""
    monkeypatch.setitem(sys.modules, "gradio", None)
    monkeypatch.setitem(launch.SETUPS, "house", lambda *a, **k: pytest.fail(
        "loaded a run dir"))
    monkeypatch.setattr(papi, "serve", lambda *a: pytest.fail("served"))
    with pytest.raises(SystemExit) as ei:
        launch.main(["--app", "house"])
    assert "gradio is not installed" in str(ei.value.code)


class _Engine:
    def __init__(self):
        self.calls = []

    def generate(self, x, target):
        self.calls.append(("generate", x.shape, target))

    def classify(self, x):
        self.calls.append(("classify", x.shape))


@pytest.mark.parametrize("app", ["mnist", "house", "moons"])
@pytest.mark.parametrize("env_host", [None, "0.0.0.0"])
def test_main_takes_the_jax_launchers_defaults(monkeypatch, keep_tf32, app,
                                               env_host):
    """Default run dir results/<app>_countergan, port 8000, host from
    CFGAN_SERVE_HOST or loopback; one warm-up request on a test sample
    before `serve`."""
    engine, seen = _Engine(), {}
    x = np.zeros((3, 2), np.float32)
    ret = {"mnist": (engine, x, None, 7),
           "house": (engine, x, None, None, None, None),
           "moons": (engine, None, x, None)}[app]

    def setup(results, device=None):
        seen.update(results=results, device=device)
        return ret

    monkeypatch.setitem(launch.SETUPS, app, setup)
    monkeypatch.setattr(papi, "serve", lambda e, host, port: seen.update(
        engine=e, host=host, port=port, warm=list(e.calls)))
    if env_host is None:
        monkeypatch.delenv("CFGAN_SERVE_HOST", raising=False)
    else:
        monkeypatch.setenv("CFGAN_SERVE_HOST", env_host)
    launch.main(["--app", app, "--api", "--device", "cpu"])
    assert seen == {"results": f"results/{app}_countergan", "device": "cpu",
                    "engine": engine, "host": env_host or "127.0.0.1",
                    "port": 8000,
                    "warm": [("generate", (1, 2), 0), ("classify", (1, 2))]}
    assert launch.DEFAULT_RESULTS == {
        "mnist": "results/mnist_countergan",
        "house": "results/house_countergan",
        "moons": "results/moons_countergan"}


def test_main_passes_results_host_and_port(monkeypatch, keep_tf32):
    seen = {}
    monkeypatch.setitem(launch.SETUPS, "moons", lambda r, device=None: (
        seen.update(results=r, device=device) or
        (_Engine(), None, np.zeros((2, 2), np.float32), None)))
    monkeypatch.setattr(papi, "serve", lambda e, host, port: seen.update(
        host=host, port=port))
    launch.main(["--app", "moons", "--api", "--results", "d", "--host",
                 "::1", "--port", "0"])
    assert seen == {"results": "d", "device": None, "host": "::1",
                    "port": 0}


def test_port_listing_names_its_entry_points_and_presets(capsys):
    port_listing()
    out = capsys.readouterr().out
    assert ("python -m cfgan_torch.serve.launch --app mnist|house|moons "
            "--api") in out
    for exp in ("moons_countergan", "mnist_countergan", "house_countergan"):
        assert f"python -m cfgan_torch.experiments.{exp}" in out
    for name in PRESETS:
        assert f"  {name}\n" in out
