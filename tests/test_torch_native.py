"""The port's C++ data library (`cfgan_torch.native`) and its compile cache
(`cfgan_torch.core.logging.setup_compile_cache`) against the JAX package,
on the CPU: `read_idx` and `normalize_u8` bit for bit against
`cfgan.native` and the Python paths (the IDX fixture, all 256 byte
values, arrays above the threading threshold), the inputs both decline,
a broken compiler, where the libraries are built, and the cache
directory's resolution and its one directory a process."""
import gzip
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cfgan import native as jax_native
from cfgan.data import mnist as jax_mnist
from cfgan_torch import native
from cfgan_torch.core import logging as clog
from cfgan_torch.data import mnist
from cfgan_torch.ops import _build

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "mnist_idx"
IDX_FILES = sorted(p.name for p in FIXTURE.iterdir())
THREADED = 1 << 20  # idx_loader.cpp splits arrays this long over threads


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.fixture
def fresh_cache(tmp_path, monkeypatch):
    """A compile cache of this test's own, with no library loaded in it;
    the process's state is put back afterwards."""
    monkeypatch.setattr(clog, "_cache_dir", None)
    monkeypatch.setattr(clog, "_pinned", None)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_build, "_library", None)
    monkeypatch.delenv(clog.CACHE_ENV, raising=False)
    cache = tmp_path / "cache"
    clog.setup_compile_cache(cache)
    return cache


# ------------------------------------------------------------ the decoder
@pytest.mark.parametrize("name", IDX_FILES)
def test_read_idx_is_jax_and_python(name):
    path = str(FIXTURE / name)
    got = native.read_idx(path)
    assert got.dtype == np.uint8
    for want in (jax_native.read_idx(path), mnist._read_idx_plain(path),
                 jax_mnist._read_idx(path)):
        assert want.shape == got.shape and np.array_equal(got, want)
    assert np.array_equal(mnist._read_idx(path), got)


def _idx_bytes(dtype=0x08, dims=(3, 2), payload=None) -> bytes:
    head = bytes([0, 0, dtype, len(dims)])
    head += b"".join(int(d).to_bytes(4, "big") for d in dims)
    n = int(np.prod(dims)) if dims else 0
    body = bytes(range(n)) if payload is None else payload
    return head + body


DECLINED = {
    "gz": None,  # written gzipped below
    "missing": None,
    "empty": b"",
    "short header": b"\x00\x00",
    "magic": b"\x01" + _idx_bytes()[1:],
    "dtype float": _idx_bytes(dtype=0x0D),
    "no dims": _idx_bytes(dims=()),
    "nine dims": _idx_bytes(dims=(1,) * 9),
    "truncated": _idx_bytes(payload=b"\x01\x02"),
    "dims short": b"\x00\x00\x08\x03" + (3).to_bytes(4, "big"),
}


@pytest.mark.parametrize("case", sorted(DECLINED))
def test_declined_inputs_are_jax(case, tmp_path):
    """`read_idx` returns None where JAX's does, and the loader's
    `_read_idx` then takes the Python decoder as JAX's does."""
    path = tmp_path / "f-idx1-ubyte"
    if case == "gz":
        path = tmp_path / "f-idx1-ubyte.gz"
        path.write_bytes(gzip.compress(_idx_bytes()))
    elif DECLINED[case] is not None:
        path.write_bytes(DECLINED[case])
    assert jax_native.read_idx(str(path)) is None
    assert native.read_idx(str(path)) is None
    if case == "gz":
        assert np.array_equal(mnist._read_idx(str(path)),
                              jax_mnist._read_idx(str(path)))
        assert mnist._read_idx(str(path)).shape == (3, 2)


def test_a_well_formed_file_of_any_rank(tmp_path):
    for dims in [(7,), (2, 3, 4), (1,) * 8]:
        path = tmp_path / f"r{len(dims)}"
        path.write_bytes(_idx_bytes(dims=dims))
        got = native.read_idx(path)
        assert got.shape == dims
        assert np.array_equal(got, jax_native.read_idx(str(path)))


# --------------------------------------------------------- the normaliser
@pytest.mark.parametrize("mean,std", [(0.5, 0.5), (0.1307, 0.3081),
                                      (0.0, 1.0)])
def test_normalize_u8_on_every_byte_is_jax_and_numpy(mean, std):
    x = np.arange(256, dtype=np.uint8).reshape(16, 16)
    got = native.normalize_u8(x, mean, std)
    plain = ((x.astype(np.float32) / 255.0) - np.float32(mean)) / np.float32(
        std)
    assert got.dtype == np.float32 and got.shape == x.shape
    assert np.array_equal(_bits(got), _bits(plain))
    assert np.array_equal(_bits(got),
                          _bits(jax_native.normalize_u8(x, mean, std)))


@pytest.mark.parametrize("n", [THREADED - 1, THREADED, 3 * THREADED + 17])
def test_normalize_u8_above_the_threading_threshold(n):
    x = np.random.RandomState(n).randint(0, 256, n).astype(np.uint8)
    got = native.normalize_u8(x, 0.5, 0.5)
    assert np.array_equal(_bits(got), _bits(jax_native.normalize_u8(
        x, 0.5, 0.5)))
    assert np.array_equal(_bits(got), _bits(mnist._LUT[x]))


def test_mnist_normalize_is_the_lut_and_jax():
    """The loader's `normalize` (native) against `normalize_plain` (the
    table) on the fixture's images and on a batch above the threshold,
    and the JAX loader's images from the same fixture."""
    x = mnist._read_idx(str(FIXTURE / "train-images-idx3-ubyte"))
    big = np.random.RandomState(0).randint(0, 256, (1400, 28, 28)).astype(
        np.uint8)
    for a in (x, big, x[::-1]):
        got = mnist.normalize(a)
        assert got.shape == (len(a), 28, 28, 1)
        assert np.array_equal(_bits(got), _bits(mnist.normalize_plain(a)))


def test_loader_is_jax_on_the_fixture(monkeypatch):
    monkeypatch.setenv("CFGAN_DATA_DIR", str(FIXTURE))
    got = mnist.load_mnist(valid_fraction=0.0)
    want = jax_mnist.load_mnist(valid_fraction=0.0)
    for (gx, gy), (wx, wy) in zip((got[0], got[2]), (want[0], want[2])):
        assert np.array_equal(_bits(gx), _bits(np.asarray(wx)))
        assert np.array_equal(gy, np.asarray(wy))


def test_normalize_u8_takes_only_uint8():
    with pytest.raises(TypeError, match="uint8"):
        native.normalize_u8(np.zeros(3, np.float32), 0.5, 0.5)


def test_normalize_u8_of_a_strided_view():
    x = np.arange(512, dtype=np.int64).astype(np.uint8).reshape(32, 16)
    view = x[::3, 1::2]
    assert np.array_equal(_bits(native.normalize_u8(view, 0.5, 0.5)),
                          _bits(mnist._LUT[view]))


# ------------------------------------------------------------- the build
def test_the_library_lands_in_the_compile_cache(fresh_cache):
    lib = native.lib()
    assert (fresh_cache / native.LIBRARY).is_file()
    assert lib is native.lib()
    assert not list((ROOT / "cfgan_torch" / "native").glob("*.so"))
    assert clog.compile_cache_dir() == fresh_cache


def test_a_broken_compiler_raises_with_its_output(fresh_cache, tmp_path,
                                                  monkeypatch):
    """With PATH pointed at a g++ that fails, `lib()` raises (the JAX
    package's returns None) with the compiler's output, and leaves no
    library behind."""
    stub = tmp_path / "bin"
    stub.mkdir()
    gxx = stub / "g++"
    gxx.write_text("#!/bin/sh\necho 'stub compiler: refusing' >&2\n"
                   "exit 1\n")
    gxx.chmod(0o755)
    monkeypatch.setenv("PATH", str(stub))
    with pytest.raises(RuntimeError, match="stub compiler: refusing"):
        native.lib()
    with pytest.raises(RuntimeError, match=r"\(1\)"):
        mnist.normalize(np.zeros((1, 28, 28), np.uint8))
    assert native._lib is None
    assert not list(fresh_cache.glob("*.so"))
    assert clog._pinned is None


def test_a_missing_compiler_raises(fresh_cache, tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "nothing"))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.read_idx(str(FIXTURE / "train-labels-idx1-ubyte"))


# ------------------------------------------------------ the compile cache
def test_cache_resolution_order(fresh_cache, tmp_path, monkeypatch):
    """The argument, then CFGAN_TORCH_CACHE, then build/cfgan_torch/ in
    the checkout; each created and returned."""
    assert clog.DEFAULT_CACHE_DIR == ROOT / "build" / "cfgan_torch"
    assert clog.setup_compile_cache() == str(clog.DEFAULT_CACHE_DIR)
    assert clog.compile_cache_dir() == clog.DEFAULT_CACHE_DIR
    env = tmp_path / "from-env"
    monkeypatch.setenv(clog.CACHE_ENV, str(env))
    assert clog.setup_compile_cache() == str(env) and env.is_dir()
    arg = tmp_path / "from-arg"
    assert clog.setup_compile_cache(arg) == str(arg) and arg.is_dir()
    assert clog.compile_cache_dir() == arg
    assert clog.setup_compile_cache(str(arg)) == str(arg)


def test_without_setup_the_cache_resolves_from_the_environment(
        fresh_cache, tmp_path, monkeypatch):
    monkeypatch.setattr(clog, "_cache_dir", None)
    monkeypatch.setenv(clog.CACHE_ENV, str(tmp_path / "env"))
    assert clog.compile_cache_dir() == tmp_path / "env"
    monkeypatch.delenv(clog.CACHE_ENV)
    assert clog.compile_cache_dir() == clog.DEFAULT_CACHE_DIR


def test_another_directory_after_a_load_raises(fresh_cache, tmp_path):
    native.lib()
    assert clog.setup_compile_cache(fresh_cache) == str(fresh_cache)
    with pytest.raises(RuntimeError, match="cannot switch"):
        clog.setup_compile_cache(tmp_path / "other")
    assert clog.compile_cache_dir() == fresh_cache


STUB_NVCC = """#!{python}
import subprocess, sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "-c" in args:
    open(out, "w").close()
else:
    subprocess.run(["g++", "-shared", "-fPIC", "-x", "c", {src!r}, "-o",
                    out], check=True)
"""


def _stub_kernel_source(path: Path) -> Path:
    """A C file defining every entry point the kernel library binds."""
    path.write_text("".join(f"int {name}(void) {{ return 0; }}\n"
                            for name in _build.SIGNATURES))
    return path


def test_kernel_library_builds_in_the_cache_and_pins_it(fresh_cache,
                                                        tmp_path,
                                                        monkeypatch):
    """`load_library` (on a stub nvcc whose link step builds a stub
    library of every entry point) builds into the chosen cache; after the
    load another directory is refused, here and for the data library."""
    src = _stub_kernel_source(tmp_path / "stub.c")
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text(STUB_NVCC.format(python=sys.executable, src=str(src)))
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(cuda))
    lib = _build.load_library()
    assert lib.path == fresh_cache / "libcfgan_kernels.so"
    assert lib.path.is_file() and not list(fresh_cache.glob(".*"))
    with pytest.raises(RuntimeError, match="cannot switch"):
        clog.setup_compile_cache(tmp_path / "other")
    clog._cache_dir = tmp_path / "other"  # as if chosen before the load
    assert clog.compile_cache_dir() == fresh_cache
    native.lib()
    assert (fresh_cache / native.LIBRARY).is_file()


def test_a_library_built_elsewhere_pins_its_directory(fresh_cache,
                                                      tmp_path):
    """A sharded worker loads the library its parent built
    (`load_library(built=...)`): that directory is then this process's
    cache, and loading from a second one raises."""
    other = tmp_path / "parent-build"
    other.mkdir()
    so = other / "libcfgan_kernels.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-x", "c",
                    str(_stub_kernel_source(tmp_path / "stub.c")), "-o",
                    str(so)], check=True)
    assert _build.load_library(built=so).path == so
    assert clog.compile_cache_dir() == other
    with pytest.raises(RuntimeError, match="second compile cache"):
        clog.pin_compile_cache(fresh_cache)
    with pytest.raises(RuntimeError, match="cannot switch"):
        clog.setup_compile_cache(fresh_cache)


# --------------------------------------------------------------- imports
def test_importing_builds_nothing_and_binds_jax_names():
    """A fresh interpreter imports the library's module and the MNIST
    loader without JAX or the JAX package and without running g++; the
    module binds the names `cfgan.native` binds."""
    code = ("import json, sys\n"
            "import cfgan_torch.native as n, cfgan_torch.data.mnist\n"
            "print(json.dumps({'loaded': n._lib is not None, 'foreign': "
            "sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'cfgan'))}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PATH"] = ""  # any g++ run would fail
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1]) == {"loaded": False,
                                                      "foreign": []}
    want = {n for n, v in vars(jax_native).items()
            if callable(v) and not n.startswith("_")
            and getattr(v, "__module__", None) == "cfgan.native"}
    assert want == {"lib", "read_idx", "normalize_u8"}
    for name in want:
        assert getattr(native, name).__module__ == "cfgan_torch.native"


def test_no_library_beside_the_source():
    """The data library is built into the compile cache, never beside
    `idx_loader.cpp` as JAX's is."""
    native.lib()
    assert shutil.which("g++")
    assert not [p for p in (ROOT / "cfgan_torch").rglob("*.so")]
