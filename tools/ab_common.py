"""What the kernel A/B harnesses (`tools/conv_ab.py`, `tools/dkernel_ab.py`,
`tools/conv_f32_probe.py`) share: the card's name, the JSON lines they
print, the build of one CUDA source from two checkouts (or from edited
copies of one), a build's SASS, and the timed turns.

Each checkout's source (with its `sm90.cuh`) is built alone, one `nvcc`
each, started together; the libraries export the same C entry points, so
each is linked with `-Bsymbolic` (a call inside one library never lands in
the other) and loaded with ctypes.  Imports no JAX.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
from pathlib import Path
from typing import Callable


def card_name() -> str:
    """The card's name and power limit, as `nvidia-smi` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


class Lines:
    """Prints one JSON object a line, each with the card, and also writes
    it to `out` where given."""

    def __init__(self, card: str, out: Path | None = None):
        self.card = card
        self.sink = open(out, "w") if out else None

    def __call__(self, obj: dict) -> None:
        line = json.dumps({"card": self.card, **obj})
        print(line, flush=True)
        if self.sink:
            self.sink.write(line + "\n")
            self.sink.flush()


def build(trees: dict[str, Path], source: str, out_dir: Path,
          entries: tuple[str, ...]) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Each tree's `cfgan_torch/csrc/<source>` into its own shared library
    under `out_dir`, the `nvcc`s started together; {name: (library, nvcc's
    report)}, with `entries` bound where a library has them (an older
    tree may lack a newer entry point)."""
    from cfgan_torch.ops import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, tree in trees.items():
        src = tree / "cfgan_torch" / "csrc" / source
        lib = out_dir / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-Xlinker",
               "-Bsymbolic", "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(path))
        for entry in entries:
            if hasattr(lib, entry):
                fn = getattr(lib, entry)
                fn.argtypes = _build.SIGNATURES[entry]
                fn.restype = ctypes.c_int
        libs[name] = (lib, log)
    return libs


def sass(library: Path, names: str) -> dict[str, list[str]]:
    """The SASS (`cuobjdump -sass`) of each kernel of `library` whose name
    matches the regular expression `names`, keyed by its name with the
    anonymous namespace's per-file tag taken out, as lines without
    addresses and encodings, branch labels renumbered in order: two builds
    of the same code compare equal."""
    from cfgan_torch.ops import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    out, lines = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = re.sub(r"\d+_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}",
                          "", m.group(1))
            lines = (out.setdefault(name, [])
                     if re.search(names, m.group(1)) else None)
            continue
        code = re.sub(r"/\*[^*]*\*/", "", ln).strip()
        if lines is not None and code:
            lines.append(code)
    for name, lines in out.items():
        labels = {}
        out[name] = [re.sub(r"\.L_x_\d+", lambda m: labels.setdefault(
            m.group(0), f".L{len(labels)}"), ln) for ln in lines]
    return out


def turns(fns: dict[str, Callable], rounds: int,
          timer: Callable[[Callable], tuple[float, str, dict]],
          emit: Lines, **tags) -> dict[str, list[float]]:
    """`rounds` rounds of parent, change, the library call, change, parent
    (the keys "parent", "change" and one more of `fns`), each timed by
    `timer` (ms, how it was timed, more keys for its line); one line a
    reading, tagged with `tags`.  Returns each one's readings."""
    lib = next(k for k in fns if k not in ("parent", "change"))
    order = ["parent", "change", lib, "change", "parent"] * rounds
    times = {name: [] for name in fns}
    for who in order:
        ms, how, extra = timer(fns[who])
        times[who].append(ms)
        emit({"time": who, **tags, "ms": ms, "timed_by": how, **extra})
    return times
