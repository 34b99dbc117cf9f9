#!/usr/bin/env python3
"""Probes behind the float32 (3xTF32) conv's TMA body
(`cfgan_torch/csrc/conv3x3.cu`, `f32::conv3x3_tf32_ws_kernel`), on one
CUDA card.

    python3 tools/conv_f32_probe.py [--parent DIR] [--parts rate,chain,...]
                                    [--out FILE]

Parts (all by default):
- `rate`: the product's rate.  A small kernel of its own (built with this
  checkout's `sm90.cuh`) issues a tight loop of tf32 `wgmma` from one,
  two or three warpgroups a block, one block an SM: m64n128k8 with both
  operands in shared memory, K-major, 128-byte swizzled (the TMA body's
  product), and m64n32k8 with A in registers (the cp.async body's).  Each
  line gives the SM cycles a product against the tensor cores' 64 (or
  16) and the rate against the TF32 peak.
- `chain`: the accumulation chain.  Copies of `conv3x3.cu` whose TMA
  body sums n k8 steps of three products into one fresh accumulator
  (`chain_edits`; the kernel's own is n = 4, a tap; 0: one accumulator
  for the whole tile) and whose halo's big part is the float32 word as
  TMA landed it, which the tensor cores truncate (the kernel's own), or
  rounded to nearest (`RNA_EDITS`), at the step's shape (128, 28, 28, 64
  -> 64), forward and dx: the worst row error and abs error against the
  plain version (float32, TF32 off) and against the float64 conv, on the
  card tests' inputs and on their cancelling inputs
  (`tests/test_torch_gpu.py::_cancelling_inputs`), and the device ms a
  call (profiler).  With `--parent`, the parent's kernel on the same
  inputs.
- `laps`: each of VARIANTS with `LAPS_EDITS` (%globaltimer laps of the
  consumers' phases, read by a C entry of the copy's own): the
  consumers' time waiting for K, for halos, splitting, issuing, waiting
  for products, in epilogues and idle rounds (mean and max over the
  blocks' consumers, us), at B = 128 and 32.
- `variants`: copies of the sources with each of VARIANTS (halo stages,
  the largest cluster) and the parent at TIME_SHAPES, timed, with their
  errors.
- `ablate`: copies of the sources each without one piece of the TMA
  body's consumer work (ABLATIONS: the epilogue, the split, the
  accumulators' adds; wrong results), timed, for what lies on the
  critical path.
- `small`: this checkout's TMA body forced at every shape (`FORCED_EDITS`)
  against the default plan and the parent at the small batches, for
  where the plan's threshold lies.

Every variant is an edited copy of this checkout's `cfgan_torch/csrc`
under `build/conv_f32_probe/`, built alone; an edit whose text is not
found exactly once stops the probe.

One JSON line a measurement, each with the card's `nvidia-smi` name and
power limit; the last line is {"ok": true}.  Needs one card and nvcc;
imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

STEP = (128, 28, 28, 64, 64)
ENTRY_POINTS = ("cfgan_conv3x3_f32", "cfgan_conv3x3_f32_workspace",
                "cfgan_conv3x3_f32_plan")
CHAINS = (1, 4, 8, 12, 36, 0)
SMALL_SHAPES = ((1, 28, 28, 64, 64), (8, 28, 28, 64, 64),
                (16, 28, 28, 64, 64), (32, 28, 28, 64, 64))

RATE_SOURCE = r'''
#include "sm90.cuh"
// one block an SM; warpgroups [0, active) issue `iters` rounds of 12
// products (four k8 steps of three), one commit group a round, at most
// one group in flight; clock64 a block into out[block]
extern "C" __global__ void __launch_bounds__(384, 1)
rate_ss_n128(int iters, int active, long long* out) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  for (int i = threadIdx.x; i < (16384 + 32768) / 4; i += blockDim.x)
    reinterpret_cast<float*>(smem)[i] = 0.f;
  sm90::fence_proxy_async();
  __syncthreads();
  const int wg = threadIdx.x / 128;
  long long t0 = clock64();
  if (wg < active) {
    float d[64];
#pragma unroll
    for (int r = 0; r < 64; ++r) d[r] = 0.f;
    const uint32_t a = sm90::smem_u32(smem), b = a + 16384;
    for (int it = 0; it < iters; ++it) {
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_tf32_ss_n128(d, sm90::make_desc_sw128(a + 8192 + kk * 32),
                                 sm90::make_desc_sw128(b + kk * 32), 1);
        sm90::wgmma_tf32_ss_n128(d, sm90::make_desc_sw128(a + kk * 32),
                                 sm90::make_desc_sw128(b + 16384 + kk * 32),
                                 1);
        sm90::wgmma_tf32_ss_n128(d, sm90::make_desc_sw128(a + kk * 32),
                                 sm90::make_desc_sw128(b + kk * 32), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
    }
    sm90::wgmma_wait<0>();
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < 64; ++r) s += d[r];
    if (s == 1.f) out[gridDim.x] = 1;  // keeps the products
  }
  __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = clock64() - t0;
}

extern "C" __global__ void __launch_bounds__(384, 1)
rate_rs_n32(int iters, int active, long long* out) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  for (int i = threadIdx.x; i < 16384 / 4; i += blockDim.x)
    reinterpret_cast<float*>(smem)[i] = 0.f;
  sm90::fence_proxy_async();
  __syncthreads();
  const int wg = threadIdx.x / 128;
  long long t0 = clock64();
  if (wg < active) {
    float d[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) d[r] = 0.f;
    uint32_t big[4] = {threadIdx.x, 1u, 2u, 3u}, small[4] = {0u, 0u, 0u, 0u};
    const uint32_t b = sm90::smem_u32(smem);
    for (int it = 0; it < iters; ++it) {
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_3xtf32_n32(d, big, small,
                               sm90::make_desc(b + kk * 256, 128, 2048),
                               sm90::make_desc(b + 8192 + kk * 256, 128, 2048),
                               1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
    }
    sm90::wgmma_wait<0>();
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) s += d[r];
    if (s == 1.f) out[gridDim.x] = 1;
  }
  __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = clock64() - t0;
}

// kernel 0 (ss_n128) or 1 (rs_n32) on `grid` blocks of 384 threads
extern "C" int run_rate(int which, int grid, int iters, int active,
                        long long* out, void* stream) {
  const int smem = 64 * 1024;
  const void* fn = which == 0 ? (const void*)rate_ss_n128
                              : (const void*)rate_rs_n32;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (which == 0)
    rate_ss_n128<<<grid, 384, smem, (cudaStream_t)stream>>>(iters, active,
                                                            out);
  else
    rate_rs_n32<<<grid, 384, smem, (cudaStream_t)stream>>>(iters, active,
                                                           out);
  return (int)cudaGetLastError();
}
'''


def rate_part(emit, out_dir: Path) -> None:
    """The product-rate probe: cycles a product and the share of the TF32
    peak, by product shape and warpgroups issuing."""
    import torch

    from cfgan_torch.ops import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "rate.cu"
    src.write_text(RATE_SOURCE)
    lib_path = out_dir / "librate.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I",
         str(ROOT / "cfgan_torch" / "csrc"), "-shared", "-o", str(lib_path),
         str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"conv_f32_probe: the rate probe does not build:\n"
                 f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.run_rate.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.run_rate.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 2000

    def launch(which, active, out):
        err = lib.run_rate(which, sms, iters, active, out.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
        if err != 0:
            sys.exit(f"conv_f32_probe: rate probe launch: cudaError {err}")
    for which, name, cycles_ideal, fmas in (
            (0, "ss_n128", 64, 64 * 128 * 8), (1, "rs_n32", 16, 64 * 32 * 8)):
        for active in (1, 2, 3):
            out = torch.zeros(sms + 1, dtype=torch.int64, device="cuda")
            launch(which, active, out)
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            launch(which, active, out)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            products = iters * 12 * active
            cycles = out[:sms].double().median().item()
            tflops = 2 * fmas * products * sms / ms / 1e9
            emit({"part": "rate", "product": name, "warpgroups": active,
                  "cycles_a_product": cycles / products,
                  "tensor_core_cycles": cycles_ideal,
                  "share_of_peak_by_cycles": cycles_ideal * products / cycles,
                  "ms": ms, "tflops": tflops,
                  "share_of_tf32_peak": tflops / 494.7})


# Text edits of conv3x3.cu, (old, new) pairs, that make the variants.
Edits = list[tuple[str, str]]


def edited_tree(out_dir: Path, name: str, edits: Edits) -> Path:
    """A copy of this checkout's sources under `out_dir/trees/name` with
    `edits` made to conv3x3.cu, each old text found exactly once."""
    tree = out_dir / "trees" / name
    csrc = tree / "cfgan_torch" / "csrc"
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "cfgan_torch" / "csrc", csrc)
    text = (csrc / "conv3x3.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            sys.exit(f"conv_f32_probe: an edit of {name} does not apply: "
                     f"{old[:60]!r}")
        text = text.replace(old, new)
    (csrc / "conv3x3.cu").write_text(text)
    return tree


# the TMA body's tap as the kernel has it (a fresh accumulator a tap)
TAP_START = "    auto tap = [&](auto tap_index, int st, uint32_t hb) {\n"
TAP_END = "        release_k(ks);\n      }\n    };\n"
# the same tap, its products summed into a fresh accumulator every
# CHAIN k8 steps: 1 or 2 (within a tap, each chain waited for), a multiple
# of 4 (whole taps, the last chain of a stage ending at its ninth tap), or
# 0 (one accumulator for the whole tile)
TAP_CHAIN = """    auto tap = [&](auto tap_index, int st, uint32_t hb) {
      constexpr int kChain = CHAIN;
      constexpr int t = decltype(tap_index)::value;
      const int ks = st * 9 + t, kslot = ks % p.kring, s = st % p.nslices;
      sm90::mbar_wait(kfull + 8 * kslot, (ks / p.kring) & 1);
      const uint32_t shift =
          (uint32_t)(((t / 3) * row + t % 3 - 1) * kWsSlice * 4);
      const uint32_t ka = kbase + kslot * kKStage;
      sm90::wgmma_fence();
      if constexpr (kChain == 0) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          k8(acc, ka + kk * 32, hb, shift + kk * 32,
             s > 0 || t > 0 || kk > 0);
        sm90::wgmma_commit();
        if constexpr (t > 0) {
          sm90::wgmma_wait<1>();
          release_k(ks - 1);
        }
        if constexpr (t == 8) {
          sm90::wgmma_wait<0>();
          release_k(ks);
        }
      } else if constexpr (kChain < 4) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int g = 4 * t + kk;
          k8(tmp0, ka + kk * 32, hb, shift + kk * 32, g % kChain != 0);
          if (g % kChain == kChain - 1) {
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
#pragma unroll
            for (int r = 0; r < 64; ++r) acc[r] += tmp0[r];
            sm90::wgmma_fence();
          }
        }
        release_k(ks);
      } else {
        constexpr int per = kChain / 4;  // taps a chain
        constexpr int chain = t / per;
        float(&d)[64] = chain % 2 ? tmp1 : tmp0;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          k8(d, ka + kk * 32, hb, shift + kk * 32, t % per != 0 || kk > 0);
        sm90::wgmma_commit();
        if constexpr (t > 0) {
          sm90::wgmma_wait<1>();
          if constexpr (t % per == 0) {
            float(&e)[64] = chain % 2 ? tmp0 : tmp1;
#pragma unroll
            for (int r = 0; r < 64; ++r) acc[r] += e[r];
          }
          release_k(ks - 1);
        }
        if constexpr (t == 8) {
          sm90::wgmma_wait<0>();
#pragma unroll
          for (int r = 0; r < 64; ++r) acc[r] += d[r];
          release_k(ks);
        }
      }
    };
"""


def chain_edits(chain: int) -> Edits:
    """The tap replaced by TAP_CHAIN at `chain` k8 steps a chain."""
    text = (ROOT / "cfgan_torch" / "csrc" / "conv3x3.cu").read_text()
    start = text.index(TAP_START)
    end = text.index(TAP_END, start) + len(TAP_END)
    return [(text[start:end], TAP_CHAIN.replace("CHAIN", str(chain), 1))]


# the halo's big part rounded to nearest (cvt.rna, written in place)
# and small = a - big
RNA_EDITS = [
    ("  const float4* src = reinterpret_cast<const float4*>(raw);\n",
     "  float4* src = reinterpret_cast<float4*>(const_cast<unsigned char*>"
     "(raw));\n"),
    ("    dst[i] = make_float4(sm90::tf32_rest(v.x), sm90::tf32_rest(v.y),\n"
     "                         sm90::tf32_rest(v.z), sm90::tf32_rest(v.w));\n",
     "    float4 b;\n"
     "    b.x = __uint_as_float(sm90::tf32_rna(v.x));\n"
     "    b.y = __uint_as_float(sm90::tf32_rna(v.y));\n"
     "    b.z = __uint_as_float(sm90::tf32_rna(v.z));\n"
     "    b.w = __uint_as_float(sm90::tf32_rna(v.w));\n"
     "    src[i] = b;\n"
     "    dst[i] = make_float4(v.x - b.x, v.y - b.y, v.z - b.z, v.w - b.w);\n"),
]
# the TMA body at every shape its other limits allow
FORCED_EDITS = [
    ("  if (tiles < sms) {  // the cp.async body where it takes one round",
     "  if (tiles < 1) {"),
]


def ring_edits(stages: int) -> Edits:
    return [("constexpr int kHaloRing = 3;", f"constexpr int kHaloRing = {stages};")]


def cluster_edits(largest: int) -> Edits:
    return [("constexpr int kMaxCluster = 4;",
             f"constexpr int kMaxCluster = {largest};")]


LAP_NAMES = ("k_wait", "halo_wait", "split", "issue", "product_wait",
             "epilogue", "idle_rounds", "other", "total", "first_k_wait",
             "step_k_wait")
# The consumers' phase laps: each consumer thread adds the %globaltimer
# nanoseconds between its marks into its own sums (in LAP_NAMES' order),
# and thread 0 of each consumer writes them to f32_laps[block][consumer],
# read by cfgan_conv3x3_f32_laps
LAPS_EDITS = [
    ("constexpr int kMaxCluster = ",
     """enum { kLapK, kLapHalo, kLapSplit, kLapIssue, kLapProducts, kLapEpilogue,
       kLapIdle, kLapOther, kLapTotal, kLapStart, kLapK0, kLaps };
__device__ long long f32_laps[2048 * 2 * kLaps];
__device__ __forceinline__ long long globaltimer() {
  long long v;
  asm volatile("mov.u64 %0, %%globaltimer;\\n" : "=l"(v));
  return v;
}
#define F32_LAP(i)                     \\
  do {                                 \\
    const long long v = globaltimer(); \\
    lap_sum[i] += v - lap_t;           \\
    lap_t = v;                         \\
  } while (0)
constexpr int kMaxCluster = """),
    ("    // the products of tap T of step st on halo stage hb",
     "    long long lap_sum[kLaps] = {}, lap_t0 = globaltimer();\n"
     "    long long lap_t = lap_t0;\n"
     "    // the products of tap T of step st on halo stage hb"),
    ("      sm90::mbar_wait(kfull + 8 * kslot, (ks / p.kring) & 1);\n",
     "      sm90::mbar_wait(kfull + 8 * kslot, (ks / p.kring) & 1);\n"
     "      if constexpr (t > 0)\n        F32_LAP(kLapK);\n"
     "      else if (st > 0)\n        F32_LAP(kLapK0);\n"
     "      else\n        F32_LAP(kLapStart);\n"),
    ("      sm90::wgmma_commit();\n      if constexpr (t > 0) {\n"
     "        sm90::wgmma_wait<1>();  // tap t - 1 is done\n",
     "      sm90::wgmma_commit();\n      F32_LAP(kLapIssue);\n"
     "      if constexpr (t > 0) {\n"
     "        sm90::wgmma_wait<1>();  // tap t - 1 is done\n"
     "        F32_LAP(kLapProducts);\n"),
    ("      if constexpr (t == 8) {\n        sm90::wgmma_wait<0>();\n",
     "      if constexpr (t == 8) {\n        sm90::wgmma_wait<0>();\n"
     "        F32_LAP(kLapProducts);\n"),
    (TAP_END, TAP_END[:-len("    };\n")] + "      F32_LAP(kLapOther);\n"
     "    };\n"),
    ("        }\n        continue;\n      }\n",
     "        }\n        F32_LAP(kLapIdle);\n        continue;\n      }\n"),
    ("        sm90::named_sync(1 + c, kWarpgroup);\n"
     "        sm90::mbar_wait(hfull + 8 * hslot, (hs / p.hring) & 1);\n",
     "        sm90::named_sync(1 + c, kWarpgroup);\n"
     "        F32_LAP(kLapOther);\n"
     "        sm90::mbar_wait(hfull + 8 * hslot, (hs / p.hring) & 1);\n"
     "        F32_LAP(kLapHalo);\n"),
    ("          for (int r = 0; r < 64; ++r) acc[r] = 0.f;\n        }\n"
     "        const uint32_t hb = hbase0",
     "          for (int r = 0; r < 64; ++r) acc[r] = 0.f;\n        }\n"
     "        F32_LAP(kLapSplit);\n        const uint32_t hb = hbase0"),
    ("      epilogue(acc, tile);\n    }\n",
     "      epilogue(acc, tile);\n      F32_LAP(kLapEpilogue);\n    }\n"
     "    lap_sum[kLapTotal] = globaltimer() - lap_t0;\n"
     "    if (ctid == 0 && blockIdx.y * gridDim.x + blockIdx.x < 2048)\n"
     "      for (int i = 0; i < kLaps; ++i)\n"
     "        f32_laps[((blockIdx.y * gridDim.x + blockIdx.x) * 2 + c) * "
     "kLaps + i] = lap_sum[i];\n"),
    ("}  // extern \"C\"\n",
     "int cfgan_conv3x3_f32_laps(long long* out, int n) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, f32::f32_laps,\n"
     "                                   n * sizeof(long long));\n"
     "}\n\n}  // extern \"C\"\n"),
]


def f32_caller(lib, x, k, transposed: bool):
    """A call of `lib`'s float32 conv, workspace allocated once."""
    import torch

    b, h, w, cin = x.shape
    cout = k.shape[2] if transposed else k.shape[3]
    y = torch.empty((b, h, w, cout), dtype=torch.float32, device=x.device)
    floats = lib.cfgan_conv3x3_f32_workspace(cin, cout)
    ws = torch.empty(floats, dtype=torch.float32, device=x.device)

    def call():
        err = lib.cfgan_conv3x3_f32(x.data_ptr(), k.data_ptr(), y.data_ptr(),
                                    ws.data_ptr(), b, h, w, cin, cout,
                                    int(transposed), floats,
                                    torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return y
    return call


def plan_of(lib, shape) -> dict | None:
    from cfgan_torch.ops.conv import _CONV_F32_PLAN_KEYS

    if not hasattr(lib, "cfgan_conv3x3_f32_plan"):
        return None
    out = (ctypes.c_int * len(_CONV_F32_PLAN_KEYS))()
    err = lib.cfgan_conv3x3_f32_plan(*shape, out)
    return dict(zip(_CONV_F32_PLAN_KEYS, out)) if err == 0 else {"error": err}


def errors(call, x, k, transposed: bool) -> dict:
    """The call's errors against the plain version (float32, TF32 off) and
    the float64 conv, and whether two calls give the same bits."""
    import torch

    import chip_smoke as cs
    from cfgan_torch.ops.conv import conv3x3_same_plain
    from test_torch_gpu import _conv_f64

    got = call().clone()
    again = call().clone()
    kk = k.flip(0, 1).transpose(2, 3).contiguous() if transposed else k
    ref = conv3x3_same_plain(x, kk)
    ref64 = _conv_f64(x, k, transposed)
    torch.cuda.synchronize()
    return {"max_abs_err": (got - ref).abs().max().item(),
            "max_row_rel_err": cs.row_rel_err(got, ref),
            "f64_max_abs_err": (got.double() - ref64).abs().max().item(),
            "f64_max_row_rel_err": cs.row_rel_err(got.double(), ref64),
            "finite": bool(torch.isfinite(got).all()),
            "two_calls_equal_bits": torch.equal(got, again)}


def chain_part(emit, trees: dict, out_dir: Path) -> None:
    import torch

    import chip_smoke as cs
    from test_torch_gpu import _cancelling_inputs
    from tools import ab_common as ab

    # the plan reports the kernel's own chain: a variant's is its name's
    specs, chains = {}, {}
    for n in CHAINS:
        for rna in (0, 1):
            name = f"chain{n}_rna{rna}"
            specs[name] = edited_tree(out_dir, name, chain_edits(n) + (
                RNA_EDITS if rna else []))
            chains[name] = n
    if "parent" in trees:
        specs["parent"] = trees["parent"]
    built = ab.build(specs, "conv3x3.cu", out_dir, ENTRY_POINTS)
    emit({"part": "chain", "build": {
        name: [ln.strip() for ln in log.splitlines()
               if "tf32" in ln or "registers" in ln or "spill" in ln
               or "error" in ln]
        for name, (_, log) in built.items()}})
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED)
    b, h, w, cin, cout = STEP
    x, k = cs.make_conv_inputs(gen, dev, *STEP, torch.float32)
    g, _ = cs.make_conv_inputs(gen, dev, b, h, w, cout, cout, torch.float32)
    inputs = {"random": {False: (x, k), True: (g, k)},
              "cancelling": {t: _cancelling_inputs(STEP, t, dev)
                             for t in (False, True)}}
    ops = cs.conv_bound(*STEP, "float32")[3]
    floor = cs._bound(0, ops, "float32")[0]
    for name, (lib, _) in built.items():
        for kind, pairs in inputs.items():
            for transposed, (xi, ki) in pairs.items():
                call = f32_caller(lib, xi, ki, transposed)
                line = {"part": "chain", "variant": name, "inputs": kind,
                        "k8_steps_a_chain": chains.get(name),
                        "direction": "dx" if transposed else "fwd",
                        **errors(call, xi, ki, transposed)}
                if kind == "random":
                    line["ms"], line["timed_by"] = cs.kernel_ms(
                        call, floor_ms=floor)
                    line["plan"] = plan_of(lib, STEP)
                emit(line)


def small_part(emit, trees: dict, out_dir: Path) -> None:
    import torch

    import chip_smoke as cs
    from tools import ab_common as ab

    specs = {"forced": edited_tree(out_dir, "forced", FORCED_EDITS),
             "change": ROOT}
    if "parent" in trees:
        specs["parent"] = trees["parent"]
    built = ab.build(specs, "conv3x3.cu", out_dir, ENTRY_POINTS)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED)
    for shape in SMALL_SHAPES + (STEP,):
        x, k = cs.make_conv_inputs(gen, dev, *shape, torch.float32)
        ops = cs.conv_bound(*shape, "float32")[3]
        floor = cs._bound(0, ops, "float32")[0]
        for name, (lib, _) in built.items():
            call = f32_caller(lib, x, k, False)
            err = errors(call, x, k, False)
            ms, how = cs.kernel_ms(call, floor_ms=floor)
            emit({"part": "small", "variant": name, "shape": shape, "ms": ms,
                  "timed_by": how, "plan": plan_of(lib, shape), **err})
    # the card tests' shapes, forward and dx, through the default plan and
    # through the TMA body at every shape
    from test_torch_gpu import SHAPES

    for shape in SHAPES:
        b, h, w, cin, cout = shape
        for transposed in (False, True):
            _, k = cs.make_conv_inputs(gen, dev, *shape, torch.float32)
            x, _ = cs.make_conv_inputs(gen, dev, b, h, w,
                                       cout if transposed else cin, 1,
                                       torch.float32)
            for name in ("change", "forced"):
                lib = built[name][0]
                err = errors(f32_caller(lib, x, k, transposed), x, k,
                             transposed)
                ok = (err["max_abs_err"] <= cs.F32_ATOL
                      and err["max_row_rel_err"] <= cs.F32_ROW_RTOL
                      and err["two_calls_equal_bits"] and err["finite"])
                emit({"part": "edges", "variant": name, "shape": shape,
                      "direction": "dx" if transposed else "fwd",
                      "plan": plan_of(lib, (b, h, w, cout, cin) if transposed
                                      else shape), "ok": ok, **err})


# the variants the `variants` and `laps` parts build
VARIANTS = {"default": [],
            "halo_ring4": ring_edits(4),
            "halo_ring2": ring_edits(2),
            "cluster1": cluster_edits(1),
            "cluster2": cluster_edits(2)}
TIME_SHAPES = (STEP, (64, 28, 28, 64, 64), (32, 28, 28, 64, 64),
               (100, 28, 28, 64, 64), (512, 28, 28, 64, 64),
               (128, 20, 20, 64, 64), (64, 20, 20, 64, 64))


def laps_part(emit, out_dir: Path, shapes=(STEP, (32, 28, 28, 64, 64))
              ) -> None:
    """Each of VARIANTS with LAPS_EDITS (its consumers' phase laps,
    %globaltimer): each lap's mean and max over the blocks' consumers, in
    us, after the last of three launches."""
    import torch

    import chip_smoke as cs
    from tools import ab_common as ab

    built = ab.build({name: edited_tree(out_dir, name, edits + LAPS_EDITS)
                      for name, edits in VARIANTS.items()}, "conv3x3.cu",
                     out_dir, ENTRY_POINTS)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED)
    for shape in shapes:
        x, k = cs.make_conv_inputs(gen, dev, *shape, torch.float32)
        for name, (lib, log) in built.items():
            lib.cfgan_conv3x3_f32_laps.argtypes = [ctypes.c_void_p,
                                                   ctypes.c_int]
            call = f32_caller(lib, x, k, False)
            plan = plan_of(lib, shape)
            n = 2048 * 2 * len(LAP_NAMES)
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * n)()
            err = lib.cfgan_conv3x3_f32_laps(buf, n)
            if err != 0:
                sys.exit(f"conv_f32_probe: laps read: cudaError {err}")
            rows = torch.tensor(list(buf), dtype=torch.float64).reshape(
                2048, 2, len(LAP_NAMES))[:plan["grid"]].reshape(
                -1, len(LAP_NAMES)) / 1e3
            emit({"part": "laps", "variant": name, "shape": shape,
                  "plan": plan,
                  "mean_us": dict(zip(LAP_NAMES, rows.mean(0).tolist())),
                  "max_us": dict(zip(LAP_NAMES, rows.max(0).values.tolist())),
                  "ptxas": [ln.strip() for ln in log.splitlines()
                            if "tf32_ws" in ln or "Performance" in ln][:4]})


def variants_part(emit, trees: dict, out_dir: Path) -> None:
    """Each of VARIANTS, and the parent, at TIME_SHAPES (forward): device
    ms a call (profiler) and the errors against the plain version."""
    import torch

    import chip_smoke as cs
    from tools import ab_common as ab

    specs = {name: edited_tree(out_dir, name, edits)
             for name, edits in VARIANTS.items()}
    if "parent" in trees:
        specs["parent"] = trees["parent"]
    built = ab.build(specs, "conv3x3.cu", out_dir, ENTRY_POINTS)
    emit({"part": "variants", "build": {
        name: [ln.strip() for ln in log.splitlines()
               if "tf32_ws" in ln or "Performance" in ln or "error" in ln]
        for name, (_, log) in built.items()}})
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED)
    for shape in TIME_SHAPES:
        x, k = cs.make_conv_inputs(gen, dev, *shape, torch.float32)
        floor = cs._bound(0, cs.conv_bound(*shape, "float32")[3],
                          "float32")[0]
        for name, (lib, _) in built.items():
            call = f32_caller(lib, x, k, False)
            err = errors(call, x, k, False)
            ms, how = cs.kernel_ms(call, floor_ms=floor)
            emit({"part": "variants", "variant": name, "shape": shape,
                  "ms": ms, "timed_by": how, "plan": plan_of(lib, shape),
                  **err})


# ablations: text edits of conv3x3.cu that drop one piece of the TMA
# body's consumer work (their results are wrong; only their times count),
# for what lies on the kernel's critical path
ABLATIONS = {
    "no_epilogue": [("      epilogue(acc, tile);\n", "")],
    "no_split": [("        split_halo(halo + hslot * p.halo_bytes, mine, "
                  "p.box_bytes, ctid);\n", "")],
    "no_adds": [("        for (int r = 0; r < 64; ++r) acc[r] += e[r];\n",
                 ""),
                ("        for (int r = 0; r < 64; ++r) acc[r] += d[r];\n",
                 "")],
}


def ablate_part(emit, out_dir: Path, shapes=(STEP, (32, 28, 28, 64, 64))
                ) -> None:
    """This checkout's TMA body and each of ABLATIONS (a copy of the
    sources with the edit, built alone), timed at `shapes`."""
    import torch

    import chip_smoke as cs
    from tools import ab_common as ab

    trees = {"default": ROOT}
    for name, edits in ABLATIONS.items():
        trees[name] = edited_tree(out_dir, name, edits)
    built = ab.build(trees, "conv3x3.cu", out_dir, ENTRY_POINTS)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(cs.SEED)
    for shape in shapes:
        x, k = cs.make_conv_inputs(gen, dev, *shape, torch.float32)
        floor = cs._bound(0, cs.conv_bound(*shape, "float32")[3],
                          "float32")[0]
        for name, (lib, _) in built.items():
            ms, how = cs.kernel_ms(f32_caller(lib, x, k, False),
                                   floor_ms=floor)
            emit({"part": "ablate", "variant": name, "shape": shape,
                  "ms": ms, "timed_by": how})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout of this repository")
    ap.add_argument("--parts",
                    default="rate,chain,variants,laps,ablate,small")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the lines to this file")
    args = ap.parse_args()

    import torch

    from tools import ab_common as ab

    sys.path.insert(0, str(ROOT / "tests"))
    if not torch.cuda.is_available():
        sys.exit("conv_f32_probe: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit = ab.Lines(ab.card_name(), args.out)
    trees = {} if args.parent is None else {"parent": args.parent.resolve()}
    out_dir = ROOT / "build" / "conv_f32_probe"
    parts = args.parts.split(",")
    if "rate" in parts:
        rate_part(emit, out_dir / "rate")
    if "chain" in parts:
        chain_part(emit, trees, out_dir / "chain")
    if "ablate" in parts:
        ablate_part(emit, out_dir / "ablate")
    if "variants" in parts:
        variants_part(emit, trees, out_dir / "variants")
    if "laps" in parts:
        laps_part(emit, out_dir / "laps")
    if "small" in parts:
        small_part(emit, trees, out_dir / "small")
    emit({"ok": True})


if __name__ == "__main__":
    main()
