"""The port stands alone: no file of cfgan_torch/, not chip_smoke.py and
not the port's examples (examples/torch_*.py) imports JAX, its libraries, the JAX package, or scikit-learn, pandas,
matplotlib, imageio or PIL (the card's machine has none of them), no CUDA source includes
PyTorch's headers, and chip_smoke.py refuses to run without a card or
without the port beside it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "orbax", "cfgan",
             "sklearn", "pandas", "matplotlib", "imageio", "PIL"}
PORT_FILES = sorted((ROOT / "cfgan_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("torch_*.py"))


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and (
                getattr(node.func, "id", None) == "__import__"
                or getattr(node.func, "attr", None) == "import_module"):
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                roots.add(arg.value.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_the_guard_sees_every_import_form(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\nfrom cfgan.ops import conv\n"
                   "import jax.numpy as jnp\n__import__('flax')\n"
                   "import importlib\nimportlib.import_module('optax.x')\n"
                   "from . import sibling\n")
    assert _imported_roots(src) == {"os", "cfgan", "jax", "flax",
                                    "importlib", "optax"}


def test_cuda_sources_include_no_torch_header():
    sources = sorted((ROOT / "cfgan_torch").rglob("*.cu*"))
    assert sources
    for src in sources:
        text = src.read_text()
        assert "torch/extension.h" not in text
        assert "#include <torch" not in text


def _run_smoke(cwd: Path) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_card():
    """Here torch has no CUDA: the smoke exits non-zero, prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_parallel_imports_only_torch_and_the_port():
    """`cfgan_torch.parallel` is torch.distributed and the port: no other
    package beside the standard library."""
    files = sorted((ROOT / "cfgan_torch" / "parallel").glob("*.py"))
    assert [f.name for f in files] == ["__init__.py", "mesh.py",
                                       "sharding.py"]
    for path in files:
        third = _imported_roots(path) - set(sys.stdlib_module_names)
        assert third <= {"torch", "cfgan_torch"}, (path.name, third)
