"""The port's plain-generation experiment (`cfgan_torch.experiments.
generation`) and what it stands on, against the JAX package, on the CPU:
the five presets field for field, `load_dataset`, the 28 -> 64 bilinear
resize against `jax.image.resize`, `to_uint8_grid`, `run()` of every
preset at width 8 (MNIST on the 120-image IDX fixture, batch 16, two
epochs) whose `generator/` the JAX package restores and samples within
1e-5 of the port's samples, the committed `results/simple_gan_moons/` and
`results/cgan_moons/` generators sampled by both packages within 1e-6,
and `main()` as the entry point.
"""
import re
from dataclasses import asdict, fields, is_dataclass, replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cfgan.core import checkpoint as jck
from cfgan.core.config import DataConfig as JaxDataConfig
from cfgan.data.registry import load_dataset as jax_load_dataset
from cfgan.eval.samples import to_uint8_grid as jax_grid
from cfgan.experiments import presets as jax_presets
from cfgan.train.gan_builders import build_gan as jax_build
from cfgan_torch.core.config import DataConfig
from cfgan_torch.data.registry import load_dataset
from cfgan_torch.eval.samples import to_uint8_grid
from cfgan_torch.experiments import generation as gen
from cfgan_torch.experiments import presets
from cfgan_torch.train.gan_builders import build_gan

from test_torch_figure import figure_set, jax_figure_set

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = str(ROOT / "tests" / "fixtures" / "mnist_idx")
NAMES = ("SIMPLE_GAN_MOONS", "SIMPLE_GAN_MNIST", "CGAN_MOONS",
         "WGAN_GP_MNIST", "DCGAN_MNIST")
WIDTH, EPOCHS = 8, 2
SAMPLE_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(obj, prefix=""):
    out = {}
    for f in fields(obj):
        v = getattr(obj, f.name)
        out.update(_fields(v, f"{prefix}{f.name}.") if is_dataclass(v)
                   else {f"{prefix}{f.name}": v})
    return out


@pytest.mark.parametrize("name", NAMES)
def test_presets_equal_the_jax_presets(name):
    """Every field of the port's preset equals the JAX preset's; the JAX
    fields the port has no counterpart for (`sharding`) are at
    their defaults there, but for `gan.sample_every`, which neither
    package reads and the port leaves out."""
    from cfgan.core.config import ExperimentConfig as JaxExperiment

    got, want = (_fields(getattr(m, name)) for m in (presets, jax_presets))
    defaults = _fields(JaxExperiment(gan=None))
    assert got.keys() <= want.keys()
    assert "gan.sample_every" in want and "gan.sample_every" not in got
    for key, value in want.items():
        if key == "gan.sample_every":
            continue
        if key in got:
            assert got[key] == value, key
        else:
            assert value == defaults.get(key), key
    assert presets.PRESETS[getattr(presets, name).name] is getattr(presets,
                                                                   name)
    assert gen.GENERATION_PRESETS == tuple(getattr(presets, n).name
                                           for n in NAMES)


@pytest.mark.parametrize("name,valid", [("moons2", 0.0), ("moons", 0.0),
                                        ("mnist", 0.0), ("mnist", 0.1),
                                        ("kc_house", 0.0)])
def test_load_dataset_matches_jax(name, valid):
    """The same arrays and keys as the JAX registry (MNIST on the IDX
    fixture; `valid_fraction` 0, the simple MNIST GAN's, gives no valid
    split)."""
    path = FIXTURE if name == "mnist" else None
    got = load_dataset(DataConfig(name=name, path=path,
                                  valid_fraction=valid), limit=100)
    want = jax_load_dataset(JaxDataConfig(name=name, path=path,
                                          valid_fraction=valid), limit=100)
    assert got.keys() == want.keys()
    assert got["num_classes"] == want["num_classes"]
    for split in ("train", "valid", "test"):
        if split in want:
            for a, b in zip(got[split], want[split]):
                if b is None:
                    assert a is None
                else:
                    assert np.array_equal(a, np.asarray(b)), split
    if name == "mnist" and valid == 0.0:
        assert got["valid"] == (None, None)


def test_resize_matches_jax_image_resize():
    """28 -> 64 bilinear (the DCGAN preset's input) within 1e-6, on random
    images and on the fixture's digits."""
    rng = np.random.RandomState(0)
    digits = load_dataset(DataConfig(name="mnist", path=FIXTURE))["train"][0]
    for x in (rng.uniform(-1, 1, (5, 28, 28, 1)).astype(np.float32),
              digits[:16]):
        want = np.asarray(jax.image.resize(jnp.asarray(x),
                                           (x.shape[0], 64, 64, 1),
                                           "bilinear"))
        got = gen.resize_images(torch.from_numpy(x), 64).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,nrow,c", [(64, 8, 1), (20, 10, 1), (7, 4, 3)])
def test_uint8_grid_matches_jax(n, nrow, c):
    x = np.random.RandomState(n).uniform(-1.3, 1.3, (n, 9, 7, c))
    got = to_uint8_grid(x.astype(np.float32), nrow=nrow)
    want = jax_grid(x.astype(np.float32), nrow=nrow)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def _small(name):
    """(port preset, JAX preset) at test width: hidden 8 (WGAN-GP sizes 8,
    DCGAN hidden 8; the simple MNIST GAN's widths are fixed), MNIST on the
    fixture with batch 16."""
    pcfg, jcfg = getattr(presets, name), getattr(jax_presets, name)
    out = []
    for cfg in (pcfg, jcfg):
        data = cfg.data
        if data.name == "mnist":
            data = replace(data, path=FIXTURE, batch_size=16)
        out.append(cfg.replace(data=data, gan=replace(
            cfg.gan, hidden_dim=WIDTH, epochs=EPOCHS)))
    return out


@pytest.fixture(scope="module", params=NAMES)
def small_run(request, tmp_path_factory):
    name = request.param
    pcfg, jcfg = _small(name)
    out = tmp_path_factory.mktemp(pcfg.name)
    lines = []
    result = gen.run(pcfg, out_dir=str(out), device="cpu", log=lines.append)
    return name, pcfg, jcfg, out, result, lines


def test_run_writes_a_generator_jax_restores(small_run):
    """`generator/` restores in the JAX package, whose eval-mode generator
    gives the port's final samples on the same fixed noise."""
    name, pcfg, jcfg, out, result, _ = small_run
    nc = result["bundle"].num_classes
    jb = jax_build(jcfg.gan, num_classes=pcfg.num_classes, seed=0)
    assert jb.num_classes == nc
    template = jax.tree_util.tree_map(np.asarray, jb.state.g.variables())
    restored = jck.restore(str(out / "generator"), template)
    z, oh, _ = result["fixed_noise"]
    want = np.asarray(jb.sample_fn(restored, jnp.asarray(z.numpy()),
                                   None if oh is None
                                   else jnp.asarray(oh.numpy())))
    got = result["samples"]
    assert got.shape == want.shape == (
        (8 * nc if nc else 64),
        *((2,) if pcfg.data.name == "moons2" else
          (64, 64, 1) if pcfg.data.resize_to else (28, 28, 1)))
    np.testing.assert_allclose(got, want, rtol=0, atol=SAMPLE_ATOL)
    # the port restores it to the same samples
    again = result["bundle"].sample_fn(
        gen.load_generator(str(out / "generator"), result["bundle"]),
        z, oh).numpy()
    assert np.array_equal(again, got)


def test_run_history_and_lines_are_the_jax_runs(small_run):
    """The history has the JAX run's keys, one mean an epoch; the printed
    line is the JAX run's; image presets keep one uint8 frame a sampled
    epoch; the run dir holds `generator/` and the JAX run's figures."""
    name, pcfg, _, out, result, lines = small_run
    hist = result["history"]
    assert set(hist) == {"d_loss", "g_loss", "d_real", "d_fake",
                         "wall_time_s"}
    assert all(len(hist[k]) == EPOCHS for k in hist if k != "wall_time_s")
    assert all(np.isfinite(hist[k]).all() for k in hist)
    line = re.compile(rf"\[{pcfg.name}\] epoch (\d+)/{EPOCHS} :: "
                      r"d_loss=-?\d+\.\d{4}, g_loss=-?\d+\.\d{4}, "
                      r"d_real=-?\d+\.\d{4}, d_fake=-?\d+\.\d{4}$")
    epochs = [int(m.group(1)) for m in map(line.match, lines) if m]
    assert epochs == list(range(1, EPOCHS + 1))
    assert lines[-1].startswith(f"[{pcfg.name}] done in ")
    frames = result["frames"]
    if pcfg.data.name == "moons2":
        assert frames == []
    else:
        side = 64 if pcfg.data.resize_to else 28
        rows = len(result["samples"]) // 8  # 64 samples, or 8 a class
        assert len(frames) == EPOCHS
        assert frames[0].dtype == np.uint8
        assert frames[0].shape == (rows * (side + 2) + 2, 8 * (side + 2) + 2)
    assert sorted(p.name for p in out.iterdir()) == sorted(
        ["generator", *jax_figure_set(pcfg.name)])


@pytest.mark.parametrize("name", ["simple_gan_moons", "cgan_moons"])
def test_committed_moons_generators_sample_as_in_jax(name):
    """The committed run dirs' generators, restored by each package and
    sampled on the same noise, within 1e-6."""
    run_dir = ROOT / "results" / name / "generator"
    pcfg = presets.PRESETS[name]
    bundle = build_gan(pcfg.gan, num_classes=pcfg.num_classes, device="cpu")
    g_vars = gen.load_generator(str(run_dir), bundle)
    jb = jax_build(jax_presets.PRESETS[name].gan,
                   num_classes=pcfg.num_classes)
    template = jax.tree_util.tree_map(np.asarray, jb.state.g.variables())
    restored = jck.restore(str(run_dir), template)
    z, oh, labels = gen.fixed_noise(bundle, "cpu")
    got = bundle.sample_fn(g_vars, z, oh).numpy()
    want = np.asarray(jb.sample_fn(restored, jnp.asarray(z.numpy()),
                                   None if oh is None
                                   else jnp.asarray(oh.numpy())))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got.shape == (64 if oh is None else 16, 2)
    if labels is not None:
        assert labels.tolist() == [0, 1] * 8


def test_main_is_the_entry_point(monkeypatch, tmp_path, capsys):
    """`--preset` with the JAX CLI's choices and the port's `--device`;
    without `--device` the entry point asks for the card, and raises
    where there is none."""
    seen = {}
    monkeypatch.setattr(gen, "run", lambda preset, **kw: seen.update(
        preset=preset, **kw))
    gen.main(["--preset", "cgan_moons", "--epochs", "3", "--limit", "40",
              "--out-dir", str(tmp_path), "--seed", "5", "--device", "cpu"])
    assert seen == {"preset": "cgan_moons", "epochs": 3, "limit": 40,
                    "out_dir": str(tmp_path), "seed": 5, "device": "cpu"}
    with pytest.raises(SystemExit):
        gen.main(["--preset", "mnist_countergan"])
    capsys.readouterr()
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gen.main(["--preset", "cgan_moons", "--epochs", "1",
                      "--out-dir", str(tmp_path)])


def test_main_runs_a_preset_on_the_cpu(tmp_path, capsys):
    gen.main(["--preset", "simple_gan_moons", "--epochs", "2", "--out-dir",
              str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[simple_gan_moons] epoch 2/2 :: d_loss=" in out
    assert (tmp_path / "generator" / "checkpoint.msgpack").is_file()


def test_gan_and_countergan_sections_of_the_experiment_config():
    """A generation preset has `gan` and no `countergan`; the CounteRGAN
    presets the reverse."""
    for p in presets.PRESETS.values():
        assert (p.gan is None) != (p.countergan is None), p.name
    assert asdict(presets.WGAN_GP_MNIST.gan)["n_critic"] == 5


def test_sample_fn_runs_under_deterministic_cudnn(monkeypatch):
    """`sample_fn` asks cuDNN for its deterministic algorithms while it
    samples (a restored generator's transposed convs then give the run's
    bits on the card) and gives the previous settings back; training runs
    under whatever the caller set."""
    from cfgan_torch.train import gan_builders

    cudnn = torch.backends.cudnn
    seen = []
    call = gan_builders.functional_call

    def spy(*args):
        seen.append((cudnn.deterministic, cudnn.benchmark))
        return call(*args)

    monkeypatch.setattr(gan_builders, "functional_call", spy)
    bundle = build_gan(presets.DCGAN_MNIST.gan, num_classes=10, seed=0,
                       device="cpu")
    saved = cudnn.deterministic, cudnn.benchmark
    try:
        cudnn.deterministic, cudnn.benchmark = False, True
        z = torch.zeros(2, bundle.latent_dim)
        out = bundle.sample_fn(bundle.g_model.state_dict(), z)
        assert out.shape == (2, 64, 64, 1)
        assert seen == [(True, False)]
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def test_run_dir_holds_the_jax_run_dirs_figures(small_run):
    """The committed JAX run dir's figures, by name and folder: the loss
    plot, and the image presets' sample grids and GIF (two sampled
    epochs, two frames) or the moons presets' scatter."""
    _, pcfg, _, out, result, _ = small_run
    assert figure_set(out) == jax_figure_set(pcfg.name)
    if len(result["frames"]) > 1:
        gif = Image.open(out / "training_animation.gif")
        assert gif.n_frames == len(result["frames"])
        for i, frame in enumerate(result["frames"]):
            gif.seek(i)
            np.testing.assert_array_equal(np.asarray(gif.convert("L")), frame)
