#!/usr/bin/env python3
"""Probes behind the float32 (3xTF32) dK's TMA body
(`cfgan_torch/csrc/conv3x3_dkernel.cu`, `f32::conv3x3_dkernel_tf32_ws_kernel`),
on one CUDA card.

    python3 tools/dkernel_f32_probe.py [--parent DIR] [--parts chain,ablate]
                                       [--out FILE]

Parts (both by default):
- `chain`: how many tf32 products the tensor cores sum into one fresh
  accumulator before the CUDA cores add it into the tap's sum.  Copies of
  the source whose consumers start a fresh accumulator every k8 step (3
  products), every two (6: the kernel's own), every stage (3 D / 8) or
  never (one accumulator a block), at the step's shape and the 20x20
  preset's: the largest tap's 2-norm error against the plain dK on the
  card tests' inputs, the max abs and tap error against the float64 dK on
  their cancelling inputs (`tests/test_torch_gpu.py::_cancelling_dk_inputs`),
  and the device ms a call (profiler, the reduction included).  With
  `--parent`, the parent's kernel on the same inputs.
- `ablate`: copies each without one piece of the kernel's work (ABLATIONS:
  g's transform, the split of x's words, the cluster's sum of partials;
  wrong results), timed at the same shapes beside the kernel: what lies on
  the critical path.

Every variant is an edited copy of this checkout's `cfgan_torch/csrc` under
`build/dkernel_f32_probe/`, built alone; an edit whose text is not found
exactly once stops the probe.

One JSON line a measurement, each with the card's `nvidia-smi` name and
power limit; the last line is {"ok": true}.  Needs one card and nvcc;
imports no JAX.
"""
from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

SOURCE = "conv3x3_dkernel.cu"
SHAPES = ((128, 28, 28, 64, 64), (128, 20, 20, 64, 64))
Edits = list[tuple[str, str]]

# the consumers' turns as the kernel has them, from the first to the
# last line before the stage's slots are released
TURNS_START = "    int s = 0;\n#pragma unroll 1\n    for (; s + 4 <= nsteps; s += 4) {\n"
TURNS_END = "    // the stage's slots are read (every lane arrives)\n"


def turns(policy: str) -> str:
    """The consumers' turns with a fresh accumulator every k8 step
    ("step"), every two (the kernel's "chain"), every stage ("stage") or
    never ("never"): the same groups and waits; a step's group of a tap
    starts fresh (after adding the tap's last chain, whose groups the
    wait<2> before it has seen done) or adds onto the last."""
    def grp(t: int, step: str, fresh: bool, pad: str) -> str:
        keep = "1"
        if fresh:
            keep = {"step": "0", "chain": "0", "stage": "s > 0",
                    "never": "j > 0 || s > 0"}[policy]
        return f"{pad}group(T{t}{{}}, xs, gs, {step}, {keep});\n"

    def add_all(pad: str) -> str:
        return f"{pad}add();\n" if policy in ("step", "chain") else ""

    def turn(steps: int, pad: str) -> str:
        notes = {(1, 0): "  // the step before's group of this tap is done",
                 (2, 0): "  // tap 0's chain is done"} if steps == 4 else {}
        out = ""
        for i in range(steps):
            step = "s" if i == 0 else f"s + {i}"
            for t in range(3):
                if i > 0:
                    note = notes.get((i, t), "")
                    out += f"{pad}sm90::wgmma_wait<2>();{note}\n"
                # a chain of two steps in the kernel; in "stage" and
                # "never" only a turn's first step may start afresh
                fresh = i % 2 == 0 if policy in ("step", "chain") else i == 0
                if i > 0 and (policy == "step" or (policy == "chain" and fresh)):
                    out += f"{pad}add_tap(T{t}{{}});\n"
                out += grp(t, step, fresh or policy == "step", pad)
        out += f"{pad}sm90::wgmma_wait<0>();\n" + add_all(pad)
        return out

    text = TURNS_START + turn(4, "      ") + "    }\n"
    text += "    if (s + 2 <= nsteps) {\n" + turn(2, "      ") + "    }\n"
    text += "    if (nsteps & 1) {  // an odd last step: a chain of three products a tap\n"
    odd = "".join(grp(t, "nsteps - 1", True, "      ") for t in range(3))
    if policy == "stage":
        odd = odd.replace("s > 0", "nsteps > 1")
    if policy == "never":
        odd = odd.replace("j > 0 || s > 0", "j > 0 || nsteps > 1")
    text += odd + "      sm90::wgmma_wait<0>();\n" + add_all("      ") + "    }\n"
    if policy == "stage":
        text += "    add();\n"
    if policy == "never":
        text += "    if (j == nst - 1) add();\n"
    return text


def chain_edits(policy: str, source: str) -> Edits:
    """The edit that gives the consumers `policy`'s turns (none for the
    kernel's own, whose text `turns("chain")` must match)."""
    start = source.index(TURNS_START)
    old = source[start:source.index(TURNS_END, start)]
    new = turns(policy)
    return [] if new == old else [(old, new)]


CHAINS = {"step": 3, "chain": 6, "stage": None, "never": None}
ABLATIONS = {
    # g's tile never split and transposed (the slots hold stale words)
    "no_transform": [("            sm90::tf32_split(__float_as_uint(v), "
                      "big[e], small[e]);\n",
                      "            big[e] = small[e] = __float_as_uint(v);\n"),
                     ("          sts_u4(at, big[0], big[1], big[2], big[3]);\n"
                      "          sts_u4(at + small_off, small[0], small[1], "
                      "small[2], small[3]);\n",
                      "          if (v_never(big[0])) sts_u4(at, big[0], "
                      "big[1], big[2], big[3]);\n")],
    # x's small parts taken as zero
    "no_split": [("      small[dx][e] =\n          __float_as_uint(sm90::"
                  "tf32_rest(__uint_as_float(a[dx][e])));\n",
                  "      small[dx][e] = 0u;\n")],
    # every block writes nothing: no cluster sum of partials
    "no_cluster_sum": [("  sm90::cluster_sync();  // every block of the "
                        "cluster has staged its tile\n  switch",
                        "  sm90::cluster_sync();\n  sm90::cluster_arrive();\n"
                        "  sm90::cluster_wait();\n  if (p.spb < 0) switch")],
}
# a helper the transform ablation needs: false for every word
V_NEVER = ("__device__ __forceinline__ void sts_u4(",
           "__device__ __forceinline__ bool v_never(uint32_t w) {\n"
           "  return w == 0x7fc00001u;\n}\n"
           "__device__ __forceinline__ void sts_u4(")


def edited_tree(out_dir: Path, name: str, edits: Edits) -> Path:
    """A copy of this checkout's sources under `out_dir/trees/name` with
    `edits` made to conv3x3_dkernel.cu, each old text found exactly once."""
    tree = out_dir / "trees" / name
    csrc = tree / "cfgan_torch" / "csrc"
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "cfgan_torch" / "csrc", csrc)
    text = (csrc / SOURCE).read_text()
    for old, new in edits:
        if text.count(old) != 1:
            sys.exit(f"dkernel_f32_probe: an edit of {name} does not apply: "
                     f"{old[:60]!r}")
        text = text.replace(old, new)
    (csrc / SOURCE).write_text(text)
    return tree


def variants(parts: set[str]) -> dict[str, Edits]:
    """{name: edits} of the parts asked for."""
    source = (ROOT / "cfgan_torch" / "csrc" / SOURCE).read_text()
    out = {}
    if "chain" in parts:
        out.update({f"chain_{p}": chain_edits(p, source) for p in CHAINS})
    if "ablate" in parts:
        out["kernel"] = []
        out.update({name: edits + ([V_NEVER] if name == "no_transform"
                                   else [])
                    for name, edits in ABLATIONS.items()})
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout of this repository")
    ap.add_argument("--parts", default="chain,ablate")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    parts = set(args.parts.split(","))

    import torch

    import chip_smoke as cs
    from cfgan_torch.ops.conv import conv3x3_same_dkernel_plain
    from test_torch_gpu import _cancelling_dk_inputs, _dk_errors, _dkernel_f64
    from tools import ab_common as ab
    from tools.dkernel_ab import ENTRY_POINTS, caller

    if not torch.cuda.is_available():
        sys.exit("dkernel_f32_probe: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit = ab.Lines(ab.card_name(), args.out)
    out_dir = ROOT / "build" / "dkernel_f32_probe"
    trees = {name: edited_tree(out_dir, name, edits)
             for name, edits in variants(parts).items()}
    if args.parent is not None and "chain" in parts:
        trees["parent"] = args.parent.resolve()
    built = ab.build(trees, SOURCE, out_dir / "libs", ENTRY_POINTS)
    for name, (_, log) in built.items():
        emit({"build": name, "ptxas": cs.kernel_ptxas(
            log, r"conv3x3_dkernel_tf32_ws_kernel")})
    dev = torch.device("cuda")
    for shape in SHAPES:
        gen = torch.Generator().manual_seed(cs.SEED)
        x, _ = cs.make_conv_inputs(gen, dev, *shape, torch.float32)
        g, _ = cs.make_conv_inputs(gen, dev, *shape[:3], shape[4], shape[4],
                                   torch.float32)
        ref = conv3x3_same_dkernel_plain(x, g)
        xc, gc = _cancelling_dk_inputs(shape, dev)
        refc = _dkernel_f64(xc, gc)
        for name, (lib, _) in built.items():
            call = caller(lib, x, g)
            got, again = call().clone(), call().clone()
            rel = ((got - ref).reshape(9, -1).norm(dim=1)
                   / ref.reshape(9, -1).norm(dim=1)).max().item()
            cabs, ctap = _dk_errors(caller(lib, xc, gc)().clone(), refc)
            ms, how = cs.kernel_ms(call)
            chain = CHAINS.get(name.removeprefix("chain_"), "n/a")
            if name.startswith("chain_stage"):
                chain = f"3 x (a stage's k8 steps)"
            emit({"variant": name, "shape": shape,
                  "products_a_fresh_accumulator": chain,
                  "max_tap_rel_err": rel,
                  "two_calls_equal_bits": torch.equal(got, again),
                  "cancelling_max_abs_err": cabs,
                  "cancelling_max_tap_rel_err": ctap,
                  "ms": ms, "timed_by": how})
    emit({"ok": True})


if __name__ == "__main__":
    main()
