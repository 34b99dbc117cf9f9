"""The port's 3x3 conv (cfgan_torch.ops.conv) against the JAX package's
Pallas kernel (interpret mode on the CPU) and its matmul decomposition.

f32 tolerance: abs <= 1e-5.  The three compute the same nine-tap sum in
float32 in different orders; at these sizes the reordering moves the
result by a few float32 ulps of values of order 1.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfgan.ops.conv import (
    conv3x3_same_matmul,
    conv_flops as jax_conv_flops,
    make_conv3x3_same_pallas,
)
from cfgan_torch.ops import _build
from cfgan_torch.ops import conv as tconv

# (B, H, W, Cin, Cout): B not a multiple of the Pallas tile of 8, W != H,
# Cin != Cout, and the serving layer's channel count
SHAPES = [(5, 9, 7, 16, 24), (3, 6, 10, 8, 4), (2, 28, 28, 64, 64)]


def _inputs(shape, seed=0):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout))
         / np.sqrt(9 * cin)).astype(np.float32)
    return x, k


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("reference", ["pallas_interpret", "matmul"])
def test_plain_conv_matches_jax_f32(shape, reference):
    x, k = _inputs(shape)
    if reference == "pallas_interpret":
        want = make_conv3x3_same_pallas(interpret=True)(jnp.asarray(x),
                                                        jnp.asarray(k))
    else:
        want = conv3x3_same_matmul(jnp.asarray(x), jnp.asarray(k))
    got = tconv.conv3x3_same_plain(torch.from_numpy(x), torch.from_numpy(k))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_plain_conv_bf16_rounds_once_like_jax():
    """bf16 in, f32 accumulation, one rounding: within one bf16 ulp of
    the JAX matmul decomposition, plus the f32 tolerance (the f32 sums
    differ in order, so a sum near a rounding boundary may round the
    other way)."""
    x, k = _inputs((3, 9, 11, 16, 24), seed=1)
    xb, kb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)
    want = np.asarray(conv3x3_same_matmul(xb, kb).astype(jnp.float32))
    got = tconv.conv3x3_same_plain(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(k).bfloat16())
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    assert np.all(np.abs(got.float().numpy() - want) <= ulp + 1e-5)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    x, k = _inputs(SHAPES[0])
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    before = tconv.conv3x3_same.launches
    got = tconv.conv3x3_same(xt, kt)
    assert tconv.conv3x3_same.launches == before
    assert torch.equal(got, tconv.conv3x3_same_plain(xt, kt))


def test_wrapper_does_not_fall_back_when_the_build_fails(monkeypatch):
    """Off the CPU the wrapper launches the kernel or raises: with the
    loader failing, a non-CPU tensor gets the loader's error, not the
    plain version."""
    class BuildFailed(RuntimeError):
        pass

    def fail():
        raise BuildFailed("nvcc failed")

    monkeypatch.setattr(_build, "load_library", fail)
    x = torch.empty((2, 8, 8, 16), device="meta")
    k = torch.empty((3, 3, 16, 16), device="meta")
    with pytest.raises(BuildFailed):
        tconv.conv3x3_same(x, k)


def test_plain_conv_rejects_a_mismatched_kernel():
    with pytest.raises(ValueError):
        tconv.conv3x3_same_plain(torch.zeros(1, 4, 4, 8),
                                 torch.zeros(3, 3, 4, 8))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_conv_flops_matches_jax(shape):
    b, h, w, cin, cout = shape
    assert tconv.conv_flops(b, (h, w), cin, cout) == jax_conv_flops(
        b, (h, w), cin, cout)


def test_nvcc_command_targets_hopper_without_torch_headers():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-Xptxas -v" in flags
    assert "-shared" in " ".join(_build.LINK_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.LINK_FLAGS)
    assert [p.name for p in _build.SOURCES] == [
        "conv3x3.cu", "epilogue.cu", "conv3x3_dkernel.cu"]
    headers = sorted(_build.SOURCES[0].parent.glob("*.cuh"))
    assert [p.name for p in headers] == ["sm90.cuh"]
    for path in (*_build.SOURCES, *headers):
        src = path.read_text()
        assert "#include <torch" not in src and "extension.h" not in src


def test_build_binds_the_dkernel_entry_points():
    """Each pointer and the stream are c_void_p (a pointer passed as a
    32-bit int would be cut); the bf16 conv takes its tap-order flag."""
    import ctypes

    p, i = ctypes.c_void_p, ctypes.c_int
    assert _build.SIGNATURES["cfgan_conv3x3_bf16"] == [p] * 3 + [i] * 6 + [p]
    assert _build.SIGNATURES["cfgan_conv3x3_dkernel_blocks"] == [i] * 6
    assert _build.SIGNATURES["cfgan_conv3x3_dkernel_bf16"] == (
        [p] * 4 + [i] * 6 + [p])
    src = _build.SOURCES[2].read_text()
    for name in ("cfgan_conv3x3_dkernel_blocks", "cfgan_conv3x3_dkernel_bf16"):
        assert f"int {name}(" in src
    assert "wgmma" in src and "atomicAdd" not in src


def test_build_binds_the_dkernel_plan_and_its_clusters():
    """The plan's entry point takes the shape, the dtype flag and a
    pointer to its six ints; the bf16 kernel is launched in clusters
    (the cluster attribute, the card's cluster occupancy) and sums a
    cluster's partials through distributed shared memory, in a fixed
    order: no float atomics."""
    import ctypes

    p, i = ctypes.c_void_p, ctypes.c_int
    assert _build.SIGNATURES["cfgan_conv3x3_dkernel_plan"] == [i] * 6 + [p]
    src = _build.SOURCES[2].read_text()
    assert ("int cfgan_conv3x3_dkernel_plan(int B, int H, int W, int Cin, "
            "int Cout,\n                               int f32, int* out)"
            ) in src
    assert "cudaLaunchAttributeClusterDimension" in src
    helpers = (_build.SOURCES[0].parent / "sm90.cuh").read_text()
    assert "cudaOccupancyMaxActiveClusters" in helpers
    assert "mapa.shared::cluster" in helpers
    assert "ld.shared::cluster" in helpers
    for text in (src, helpers):
        assert "atomicAdd" not in text
        assert not re.search(r"\b(red|atom)\.", text)


def test_dkernel_plan_asks_the_kernel_library(monkeypatch):
    """The launch plan comes from the built library's plan entry point,
    read into its six named ints; with the loader failing it raises the
    loader's error."""
    import ctypes

    class Lib:
        @staticmethod
        def cfgan_conv3x3_dkernel_plan(b, h, w, cin, cout, f32, out):
            assert (b, h, w, cin, cout, f32) == (128, 28, 28, 64, 64, 0)
            for k, v in enumerate((132, 2, 66, 768, 4, 1)):
                ctypes.cast(out, ctypes.POINTER(ctypes.c_int))[k] = v
            return 0

    monkeypatch.setattr(_build, "load_library",
                        lambda: type("Built", (), {"lib": Lib})())
    assert tconv.dkernel_plan(128, 28, 28, 64, 64) == {
        "blocks": 132, "cluster": 2, "partials": 66,
        "pixels_per_block": 768, "ring": 4, "tma": 1}

    class BuildFailed(RuntimeError):
        pass

    def fail():
        raise BuildFailed("nvcc failed")

    monkeypatch.setattr(_build, "load_library", fail)
    with pytest.raises(BuildFailed):
        tconv.dkernel_plan(128, 28, 28, 64, 64)


def test_build_binds_the_conv_plan_and_its_clusters():
    """The bf16 conv's plan entry point takes the shape, the dx flag and
    a pointer to its seven ints.  Its TMA body is launched in clusters
    (the cluster attribute, the card's cluster occupancy), loads K by a
    TMA multicast over the cluster and its halos by 4-D TMA boxes,
    multiplies with both operands in shared memory (m64n128k16), stores
    its output tiles transposed (stmatrix) and by TMA, moves registers
    from its producer to its consumers, and has no float atomics: two
    calls give the same bits."""
    import ctypes

    p, i = ctypes.c_void_p, ctypes.c_int
    assert _build.SIGNATURES["cfgan_conv3x3_plan"] == [i] * 6 + [p]
    src = _build.SOURCES[0].read_text()
    assert ("int cfgan_conv3x3_plan(int B, int H, int W, int Cin, int Cout, "
            "int flip,\n                       int* out)") in src
    assert "cudaLaunchAttributeClusterDimension" in src
    assert "cudaLaunchKernelEx(" in src and "sm90::max_clusters(" in src
    for call in ("tma_load_3d_multicast(", "tma_store_4d(", "tma_load_4d(",
                 "setmaxnreg_dec<", "setmaxnreg_inc<", "named_sync(",
                 "mbar_arrive_cluster(", "wgmma_ss_n128<", "stmatrix_x4_trans("):
        assert f"sm90::{call}" in src, call
    helpers = (_build.SOURCES[0].parent / "sm90.cuh").read_text()
    assert ".multicast::cluster" in helpers
    assert "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group" in helpers
    assert "setmaxnreg.inc.sync.aligned.u32" in helpers
    for text in (src, helpers):
        assert "atomicAdd" not in text
        assert not re.search(r"\b(red|atom)\.", text)


@pytest.mark.parametrize("transposed", [False, True], ids=["fwd", "dx"])
def test_conv_plan_asks_the_kernel_library(monkeypatch, transposed):
    """The bf16 conv's launch plan comes from the built library's plan
    entry point, read into its seven named ints; with the loader failing
    it raises the loader's error."""
    import ctypes

    class Lib:
        @staticmethod
        def cfgan_conv3x3_plan(b, h, w, cin, cout, flip, out):
            assert (b, h, w, cin, cout, flip) == (128, 28, 28, 64, 64,
                                                  int(transposed))
            for k, v in enumerate((1, 2, 2, 896, 132, 4, 64)):
                ctypes.cast(out, ctypes.POINTER(ctypes.c_int))[k] = v
            return 0

    monkeypatch.setattr(_build, "load_library",
                        lambda: type("Built", (), {"lib": Lib})())
    assert tconv.conv_plan(128, 28, 28, 64, 64, transposed=transposed) == {
        "tma": 1, "cluster": 2, "consumers": 2, "units": 896, "grid": 132,
        "stages": 4, "cout_tile": 64}

    class BuildFailed(RuntimeError):
        pass

    def fail():
        raise BuildFailed("nvcc failed")

    monkeypatch.setattr(_build, "load_library", fail)
    with pytest.raises(BuildFailed):
        tconv.conv_plan(128, 28, 28, 64, 64, transposed=transposed)


def test_conv_plan_raises_the_librarys_error(monkeypatch):
    """A plan the library refuses (a cudaError) raises, naming it."""

    class Lib:
        @staticmethod
        def cfgan_conv3x3_plan(b, h, w, cin, cout, flip, out):
            return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(_build, "load_library",
                        lambda: type("Built", (), {"lib": Lib})())
    with pytest.raises(RuntimeError, match="cudaError 1"):
        tconv.conv_plan(0, 28, 28, 64, 64)


def test_build_binds_the_f32_conv_plan():
    """The float32 conv's plan entry point takes the shape (its body reads
    K flipped or not alike) and a pointer to its eight ints."""
    import ctypes

    p, i = ctypes.c_void_p, ctypes.c_int
    assert _build.SIGNATURES["cfgan_conv3x3_f32_plan"] == [i] * 5 + [p]
    src = _build.SOURCES[0].read_text()
    assert ("int cfgan_conv3x3_f32_plan(int B, int H, int W, int Cin, "
            "int Cout, int* out)") in src


@pytest.mark.parametrize("transposed", [False, True], ids=["fwd", "dx"])
def test_f32_conv_plan_asks_the_kernel_library(monkeypatch, transposed):
    """In float32, `conv_plan` reads the float32 plan entry point's eight
    named ints (the bf16 entry point is not asked); with the loader
    failing it raises the loader's error."""
    import ctypes

    class Lib:
        @staticmethod
        def cfgan_conv3x3_f32_plan(b, h, w, cin, cout, out):
            assert (b, h, w, cin, cout) == (128, 28, 28, 64, 96)
            for k, v in enumerate((1, 2, 2, 1792, 132, 3, 64, 12)):
                ctypes.cast(out, ctypes.POINTER(ctypes.c_int))[k] = v
            return 0

        @staticmethod
        def cfgan_conv3x3_plan(*args):
            raise AssertionError("the bf16 plan was asked for float32")

    monkeypatch.setattr(_build, "load_library",
                        lambda: type("Built", (), {"lib": Lib})())
    assert tconv.conv_plan(128, 28, 28, 64, 96, transposed=transposed,
                           dtype=torch.float32) == {
        "tma": 1, "cluster": 2, "consumers": 2, "units": 1792, "grid": 132,
        "stages": 3, "cout_tile": 64, "chain": 12}

    class BuildFailed(RuntimeError):
        pass

    def fail():
        raise BuildFailed("nvcc failed")

    monkeypatch.setattr(_build, "load_library", fail)
    with pytest.raises(BuildFailed):
        tconv.conv_plan(128, 28, 28, 64, 96, transposed=transposed,
                        dtype=torch.float32)


def test_f32_conv_plan_raises_the_librarys_error(monkeypatch):
    """A float32 plan the library refuses (a cudaError) raises, naming
    it."""

    class Lib:
        @staticmethod
        def cfgan_conv3x3_f32_plan(b, h, w, cin, cout, out):
            return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(_build, "load_library",
                        lambda: type("Built", (), {"lib": Lib})())
    with pytest.raises(RuntimeError, match="cudaError 1"):
        tconv.conv_plan(0, 28, 28, 64, 64, dtype=torch.float32)


def test_f32_dkernel_plan_asks_the_kernel_library(monkeypatch):
    """The float32 plan comes from the same entry point with the dtype flag
    set, read into its nine named ints (the bf16 plan's six, then the TMA
    body's rows a stage, positions a stage and products a fresh
    accumulator takes)."""
    import ctypes

    class Lib:
        @staticmethod
        def cfgan_conv3x3_dkernel_plan(b, h, w, cin, cout, f32, out):
            assert (b, h, w, cin, cout, f32) == (128, 28, 28, 64, 64, 1)
            for k, v in enumerate((64, 2, 32, 1568, 2, 1, 4, 120, 6)):
                ctypes.cast(out, ctypes.POINTER(ctypes.c_int))[k] = v
            return 0

    monkeypatch.setattr(_build, "load_library",
                        lambda: type("Built", (), {"lib": Lib})())
    assert tconv.dkernel_plan(128, 28, 28, 64, 64, torch.float32) == {
        "blocks": 64, "cluster": 2, "partials": 32,
        "pixels_per_block": 1568, "ring": 2, "tma": 1, "rows": 4,
        "depth": 120, "chain": 6}


def test_f32_dkernel_body_streams_by_tma_in_clusters_without_atomics():
    """The float32 dK's TMA body: x's halo and g's tile by 4-D TMA boxes on
    mbarriers, a producer warpgroup whose registers go to the consumers,
    g split once a stage (rna big, exact small) and x's small part made
    beside the landed word, m64n32k8 tf32 products with A in registers,
    clusters whose partials are summed through distributed shared memory;
    no float atomics, no build switch; the cp.async body kept for the
    shapes the plan gives it."""
    src = _build.SOURCES[2].read_text()
    body = src[src.index("// ------------------------------------------- "
                         "float32, the TMA body"):
               src.index("}  // namespace f32")]
    for call in ("tma_load_4d(", "mbar_wait(", "mbar_expect_tx(",
                 "mbar_arrive(", "setmaxnreg_dec<", "setmaxnreg_inc<",
                 "wgmma_3xtf32_n32(", "tf32_rest(", "tf32_split(",
                 "cluster_sync("):
        assert f"sm90::{call}" in body, call
    assert "reduce_share<kWsN" in body
    assert "conv3x3_dkernel_tf32_ws_kernel" in body
    assert "conv3x3_dkernel_tf32_kernel" in src  # the cp.async body
    assert "plan_f32_cp_async(" in src and "plan_f32_tma(" in src
    assert not re.search(r"#\s*if(?:n?def)?\s+CFGAN_", src)
    for text in (body, src):
        assert "atomicAdd" not in text
        assert not re.search(r"\b(red|atom)\.", text)


def test_f32_dkernel_probe_variants_are_edits_of_one_design(tmp_path):
    """The float32 dK's probe builds its chain variants and ablations from
    edited copies of the one source (tools/dkernel_f32_probe.py): the
    kernel's own turns are what its generator writes for six products a
    fresh accumulator, and every other edit finds its text exactly once
    and changes it."""
    from tools import dkernel_f32_probe as probe

    src = _build.SOURCES[2].read_text()
    assert probe.chain_edits("chain", src) == []
    assert "out[8] = f32::kWsChain;" in src
    assert "constexpr int kWsChain = 6;" in src
    for name, edits in probe.variants({"chain", "ablate"}).items():
        tree = probe.edited_tree(tmp_path, name, edits)
        text = (tree / "cfgan_torch" / "csrc" / probe.SOURCE).read_text()
        assert (text == src) == (not edits), name


def test_f32_body_streams_halos_and_k_by_tma_without_float_atomics():
    """The float32 conv's TMA body: its halos come by 4-D TMA boxes and K's
    taps by a TMA multicast over the cluster, on mbarriers (empty slots
    released across the cluster), from producer threads whose registers
    go to the consumers; each halo element is split once (a - trunc(a)
    beside the landed word) and the products are m64n128k8 tf32 with both
    operands in shared memory; it is launched in clusters and has no
    float atomics: two calls give the same bits."""
    src = _build.SOURCES[0].read_text()
    body = src[src.index("namespace f32 {"):src.index("}  // namespace f32")]
    for call in ("tma_load_4d(", "tma_load_2d_multicast(", "mbar_wait(",
                 "mbar_expect_tx(", "mbar_arrive_cluster(", "setmaxnreg_dec<",
                 "setmaxnreg_inc<", "wgmma_tf32_ss_n128(", "tf32_rest("):
        assert f"sm90::{call}" in body, call
    # the cluster is chosen by the file's helper, which both TMA bodies share
    assert "cudaLaunchKernelEx(" in body and "choose_cluster(" in body
    assert "sm90::max_clusters(" in src[:src.index("namespace f32 {")]
    assert "conv3x3_tf32_ws_kernel" in body
    helpers = (_build.SOURCES[0].parent / "sm90.cuh").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32" in helpers
    assert "cp.async.bulk.tensor.2d.shared::cluster" in helpers
    for text in (body, helpers):
        assert "atomicAdd" not in text
        assert not re.search(r"\b(red|atom)\.", text)


def test_f32_probe_variants_are_edits_of_one_design(tmp_path):
    """The float32 conv's source holds one design and no build switches;
    the probe's variants (chain lengths, rounding, halo stages, clusters,
    the forced TMA body), its laps and its ablations are edited copies of
    it (tools/conv_f32_probe.py), and each edit still finds its text
    exactly once and changes it."""
    from tools import conv_f32_probe as probe

    src = _build.SOURCES[0].read_text()
    assert not re.search(r"#\s*if(?:n?def)?\s+CFGAN_", src)
    sets = {f"chain{n}": probe.chain_edits(n) for n in probe.CHAINS}
    sets["rna"] = probe.RNA_EDITS
    sets["forced"] = probe.FORCED_EDITS
    for name, edits in probe.VARIANTS.items():
        sets[name] = edits
        sets[f"{name}_laps"] = edits + probe.LAPS_EDITS
    sets.update(probe.ABLATIONS)
    for name, edits in sets.items():
        tree = probe.edited_tree(tmp_path, name, edits)
        text = (tree / "cfgan_torch" / "csrc" / "conv3x3.cu").read_text()
        assert (text == src) == (not edits), name
    # the kernel's own chain (a tap, 4 k8 steps) is what the plan reports
    assert "pl.chain = 12;" in src


def test_build_binds_the_f32_entry_points():
    """The float32 conv takes the tap-order flag (dx reads K flipped, no
    copy) and a workspace for K's tf32 parts, sized by its own entry
    point; the float32 dK has the bf16 one's arguments; the plan of
    partial-sum blocks takes the dtype."""
    import ctypes

    p, i = ctypes.c_void_p, ctypes.c_int
    assert _build.SIGNATURES["cfgan_conv3x3_f32"] == [p] * 4 + [i] * 7 + [p]
    assert _build.SIGNATURES["cfgan_conv3x3_f32_workspace"] == [i] * 2
    assert _build.SIGNATURES["cfgan_conv3x3_dkernel_f32"] == (
        [p] * 4 + [i] * 6 + [p])
    conv_src = _build.SOURCES[0].read_text()
    assert ("int cfgan_conv3x3_f32(const void* x, const void* k, void* y, "
            "void* ws,\n                      int B, int H, int W, int Cin, "
            "int Cout, int flip,") in conv_src
    assert "int cfgan_conv3x3_f32_workspace(int Cin, int Cout)" in conv_src
    dk_src = _build.SOURCES[2].read_text()
    assert "int cfgan_conv3x3_dkernel_f32(" in dk_src
    assert "int Cout,\n                                 int f32)" in dk_src
    for src in (conv_src, dk_src):
        assert "cvt.rna.tf32.f32" not in src  # one split, in sm90.cuh
    helpers = (_build.SOURCES[0].parent / "sm90.cuh").read_text()
    assert "cvt.rna.tf32.f32" in helpers and ".tf32.tf32" in helpers


def test_dkernel_on_cpu_is_the_plain_version_and_launches_nothing():
    x, _ = _inputs((2, 6, 5, 20, 24), seed=5)
    g = np.random.default_rng(6).standard_normal((2, 6, 5, 24)).astype(
        np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        xt, gt = torch.from_numpy(x).to(dtype), torch.from_numpy(g).to(dtype)
        before = tconv.conv3x3_same_dkernel.launches
        got = tconv.conv3x3_same_dkernel(xt, gt)
        assert tconv.conv3x3_same_dkernel.launches == before
        assert got.dtype == torch.float32 and got.shape == (3, 3, 20, 24)
        assert torch.equal(got, tconv.conv3x3_same_dkernel_plain(xt, gt))


def test_dkernel_does_not_fall_back_when_the_build_fails(monkeypatch):
    class BuildFailed(RuntimeError):
        pass

    def fail():
        raise BuildFailed("nvcc failed")

    monkeypatch.setattr(_build, "load_library", fail)
    x = torch.empty((2, 8, 8, 16), device="meta", dtype=torch.bfloat16)
    g = torch.empty((2, 8, 8, 16), device="meta", dtype=torch.bfloat16)
    with pytest.raises(BuildFailed):
        tconv.conv3x3_same_dkernel(x, g)


def test_f32_dkernel_does_not_fall_back_when_the_build_fails(monkeypatch):
    """A float32 pair off the CPU goes to the kernel too: with the loader
    failing it gets the loader's error, not the plain version."""
    class BuildFailed(RuntimeError):
        pass

    def fail():
        raise BuildFailed("nvcc failed")

    monkeypatch.setattr(_build, "load_library", fail)
    x = torch.empty((2, 8, 8, 16), device="meta")
    g = torch.empty((2, 8, 8, 24), device="meta")
    with pytest.raises(BuildFailed):
        tconv.conv3x3_same_dkernel(x, g)


@pytest.mark.parametrize("shape", [(3, 9, 11, 16, 24), (2, 7, 5, 20, 40)],
                         ids=str)
def test_plain_dkernel_f32_matches_jax_pallas_vjp(shape):
    """float32 x and cotangent: the plain dK (one float32 product over the
    stacked taps, the yardstick of the 3xTF32 kernel on the card) against
    the dK of `jax.vjp` of `make_conv3x3_same_pallas(interpret=True)`:
    abs <= 1e-5 of the largest |dK| (float32 sums of up to B*H*W = 297
    products; measured equal)."""
    import jax

    b, h, w, _, cout = shape
    x, k = _inputs(shape, seed=7)
    g = np.random.default_rng(8).standard_normal((b, h, w, cout)).astype(
        np.float32)
    _, vjp = jax.vjp(make_conv3x3_same_pallas(interpret=True),
                     jnp.asarray(x), jnp.asarray(k))
    want = np.asarray(vjp(jnp.asarray(g))[1])
    got = tconv.conv3x3_same_dkernel_plain(torch.from_numpy(x),
                                           torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("shape", [(3, 9, 11, 16, 24), (2, 7, 5, 20, 40),
                                   (1, 5, 5, 64, 64)], ids=str)
def test_plain_dkernel_bf16_matches_jax_pallas_vjp(shape):
    """bf16 x and cotangent: the plain dK (float32 products over the
    stacked taps) rounded to bf16 against `jax.vjp` of
    `make_conv3x3_same_pallas(interpret=True)`'s bf16 dK, which rounds its
    float32 products once.  Tolerance: one bf16 ulp of JAX's value, plus
    1e-5 of the largest |dK| for the float32 sums' order, which decides
    the rounding where a sum lies near a boundary."""
    import jax

    b, h, w, _, cout = shape
    x, k = _inputs(shape, seed=7)
    g = np.random.default_rng(8).standard_normal((b, h, w, cout)).astype(
        np.float32)
    xb, kb, gb = (jnp.asarray(a, jnp.bfloat16) for a in (x, k, g))
    _, vjp = jax.vjp(make_conv3x3_same_pallas(interpret=True), xb, kb)
    want = np.asarray(vjp(gb)[1].astype(jnp.float32))
    got = tconv.conv3x3_same_dkernel_plain(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16())
    got = got.bfloat16().float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    assert np.all(np.abs(got - want) <= ulp + 1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape", SHAPES[:2], ids=str)
def test_transposed_conv_is_the_jax_vjp_dx(shape):
    """`conv3x3_same(g, K, transposed=True)` on the CPU (K read flipped and
    channel-transposed) against the dx of `make_conv3x3_same_pallas`'s
    VJP: f32 abs <= 1e-5."""
    import jax

    b, h, w, _, cout = shape
    x, k = _inputs(shape, seed=9)
    g = np.random.default_rng(10).standard_normal((b, h, w, cout)).astype(
        np.float32)
    _, vjp = jax.vjp(make_conv3x3_same_pallas(interpret=True),
                     jnp.asarray(x), jnp.asarray(k))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = tconv.conv3x3_same(torch.from_numpy(g), torch.from_numpy(k),
                             transposed=True)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        tconv.conv3x3_same(torch.from_numpy(x), torch.from_numpy(k),
                           transposed=True)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_f32_transposed_wrapper_is_the_plain_conv_with_the_flipped_kernel(
        shape):
    """`transposed=True` on float32 (the kernel's flip = 1 on the card)
    computes the plain conv with K flipped in both spatial axes and its
    channels transposed: on the CPU, bit for bit."""
    b, h, w, _, cout = shape
    _, k = _inputs(shape, seed=11)
    g = np.random.default_rng(12).standard_normal((b, h, w, cout)).astype(
        np.float32)
    kt = torch.from_numpy(k)
    got = tconv.conv3x3_same(torch.from_numpy(g), kt, transposed=True)
    want = tconv.conv3x3_same_plain(
        torch.from_numpy(g), kt.flip(0, 1).transpose(2, 3).contiguous())
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_takes_dk_through_the_kernel_wrapper(monkeypatch, dtype):
    """In both dtypes the Function's dK goes through `conv3x3_same_dkernel`
    (on the card, the kernel; here its plain version)."""
    calls = []
    wrapper = tconv.conv3x3_same_dkernel

    def counted(x, g):
        calls.append((x.dtype, g.dtype))
        return wrapper(x, g)

    monkeypatch.setattr(tconv, "conv3x3_same_dkernel", counted)
    x, k = _inputs((2, 6, 5, 16, 16), seed=13)
    xt = torch.tensor(x).to(dtype).requires_grad_(True)
    kt = torch.tensor(k).to(dtype).requires_grad_(True)
    tconv.conv3x3_same_pallas(xt, kt).float().sum().backward()
    assert calls == [(dtype, dtype)]
    assert kt.grad.dtype == dtype


@pytest.mark.parametrize("shape", SHAPES[:2], ids=str)
def test_conv_vjp_matches_jax_pallas_interpret(shape):
    """The Function's backward on the CPU (dx through the plain version
    with the flipped, channel-transposed kernel; dK as one f32 product
    over the nine stacked taps) against `make_conv3x3_same_pallas(interpret=True)`'s custom
    VJP, under a random cotangent: f32 abs <= 1e-5."""
    import jax

    x, k = _inputs(shape, seed=2)
    b, h, w, _, cout = shape
    g = np.random.default_rng(3).standard_normal((b, h, w, cout)).astype(
        np.float32)
    y, vjp = jax.vjp(make_conv3x3_same_pallas(interpret=True),
                     jnp.asarray(x), jnp.asarray(k))
    want_dx, want_dk = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    kt = torch.tensor(k, requires_grad=True)
    got = tconv.conv3x3_same_pallas(xt, kt)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(want_dk),
                               atol=1e-5, rtol=0)


def test_conv_vjp_bf16_grads_keep_their_dtypes():
    """bf16 in: dx comes back bf16 from the conv of the cotangent, dK bf16
    from the float32 products, as the JAX VJP casts them."""
    x, k = _inputs((2, 6, 5, 16, 16), seed=4)
    xt = torch.tensor(x).bfloat16().requires_grad_(True)
    kt = torch.tensor(k).bfloat16().requires_grad_(True)
    tconv.conv3x3_same_pallas(xt, kt).float().sum().backward()
    assert xt.grad.dtype == kt.grad.dtype == torch.bfloat16
    ref_k = tconv.conv3x3_same_dkernel(
        xt.detach(), torch.ones(2, 6, 5, 16, dtype=torch.bfloat16))
    assert torch.equal(kt.grad, ref_k.bfloat16())

