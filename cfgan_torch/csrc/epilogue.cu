// The fused counterfactual epilogue of the CounteRGAN train step, forward
// and backward, for Hopper.
//
// Replaces the Pallas TPU kernels of cfgan/ops/epilogue.py:
//   forward   _fwd_kernel (launched by _pallas_fwd)
//   backward  _bwd_kernel (launched by _pallas_bwd, the custom VJP)
// Both work on rows: x, raw, mask are (B, N) float32, one row per sample,
// with N the flattened sample (784 for MNIST).
//
// Forward, per row:
//   masked = raw * mask
//   x_cf   = clip(x + masked, lo, hi)
//   l1     = sum |masked|,  l2 = sum masked^2,  pen = sum |raw * (1 - mask)|
// Backward, per element, from the three saved inputs and the cotangents
// gcf (B, N) and gl1, gl2, gpen (B,):
//   u    = x + masked;  inr = (lo <= u <= hi), inclusive at both ends
//   dx   = gcf * inr
//   draw = (dx + gl1 * sign(masked) + 2 * gl2 * masked) * mask
//          + gpen * sign(raw * (1 - mask)) * (1 - mask)
// with sign(0) = 0.  lo, hi = -1e30, 1e30 is the no-clamp mode: every
// finite u is in range.
//
// Bound on an H100 SXM (3.35 TB/s) at the MNIST step's shape (128, 784) f32:
//   forward   reads 3 x 401,408 B, writes 401,408 B + 3 x 512 B
//             = 1.607 MB -> 0.48 us
//   backward  reads 4 x 401,408 B + 3 x 512 B, writes 2 x 401,408 B
//             = 2.410 MB -> 0.72 us
// A few operations per byte: both are bound by bytes, and at this size by
// memory latency and the launch: a row is 3 KB, and the whole input is a
// few round trips' worth of bytes in flight.  The design moves each byte
// once (the forward writes x_cf and takes the three row sums in the same
// pass; the backward recomputes masked, u and the signs from x, raw and
// mask instead of reading saved indicator tensors, as the Pallas kernels
// do) and makes a row ONE memory round trip.
//
// Design.  One block per row; each thread takes one group of four
// consecutive elements ("quad") a trip, so that neighbouring threads read
// neighbouring 16 bytes.  The host sizes the block to the row: ceil(N / 4)
// threads rounded up to a warp, at most kMaxThreads (N = 784: 196 quads, a
// 224-thread block, one trip); a longer row takes more trips.  A thread
// issues every load of its trip before any arithmetic, so the row's bytes
// are all in flight at once.  Where N % 4 == 0 and every row pointer is
// 16-byte aligned, a quad is one 16-byte access (ld.global.nc.v4 /
// st.global.v4); otherwise (kVec = false) the same layout reads and writes
// four 4-byte words, masked at the row's end.  The forward's three
// row sums: warp shuffles, then one shared-memory exchange across the at
// most 8 warps, summed by three lanes of warp 0 in warp order; no atomics,
// so every run gives the same bits.  The backward is purely elementwise in
// the same layout; each thread reads its row's three cotangent scalars
// with its loads.  Any B >= 1 and N >= 1 work with no padding (the Pallas
// version needs batch tiles that divide B).  Only float32 is built: it is
// the only type the step gives.  Products and sums whose result is rounded
// before the next operation use the _rn intrinsics, which the compiler
// does not contract into FMAs: the kernels then round exactly where the
// plain version does, and the in-range test of the backward sees the same
// u.

#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

__device__ __forceinline__ float sign_of(float v) {
  return (float)((v > 0.0f) - (v < 0.0f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Elements 4q .. 4q+3 of a row of n; past its end a word reads as 0, which
// adds nothing to any row sum.
template <bool kVec>
__device__ __forceinline__ float4 load_quad(const float* __restrict__ p,
                                            int q, int n) {
  if (kVec) return __ldg(reinterpret_cast<const float4*>(p) + q);
  const int j = 4 * q;
  return make_float4(__ldg(p + j), j + 1 < n ? __ldg(p + j + 1) : 0.0f,
                     j + 2 < n ? __ldg(p + j + 2) : 0.0f,
                     j + 3 < n ? __ldg(p + j + 3) : 0.0f);
}

template <bool kVec>
__device__ __forceinline__ void store_quad(float* __restrict__ p, int q,
                                           int n, float4 v) {
  if (kVec) {
    reinterpret_cast<float4*>(p)[q] = v;
    return;
  }
  const int j = 4 * q;
  p[j] = v.x;
  if (j + 1 < n) p[j + 1] = v.y;
  if (j + 2 < n) p[j + 2] = v.z;
  if (j + 3 < n) p[j + 3] = v.w;
}

// One element of the forward: its x_cf, added into the three row sums.
__device__ __forceinline__ float fwd_one(float x, float r, float m, float lo,
                                         float hi, float& s1, float& s2,
                                         float& s3) {
  const float masked = __fmul_rn(r, m);
  const float u = __fadd_rn(x, masked);
  s1 += fabsf(masked);
  s2 += masked * masked;
  s3 += fabsf(__fmul_rn(r, 1.0f - m));
  return u < lo ? lo : (u > hi ? hi : u);  // a NaN passes, as in clamp
}

// One element of the backward: du (= dx) and draw.
__device__ __forceinline__ void bwd_one(float x, float r, float m, float g,
                                        float g1, float g2, float gp,
                                        float lo, float hi, float& du,
                                        float& dr) {
  const float masked = __fmul_rn(r, m);
  const float u = __fadd_rn(x, masked);
  du = __fmul_rn(g, (u >= lo && u <= hi) ? 1.0f : 0.0f);
  // (du + g1 * sign(masked)) + (2 * g2) * masked, as the plain version
  const float dmasked = __fadd_rn(
      __fadd_rn(du, __fmul_rn(g1, sign_of(masked))),
      __fmul_rn(__fmul_rn(2.0f, g2), masked));
  const float inv = 1.0f - m;
  dr = __fadd_rn(__fmul_rn(dmasked, m),
                 __fmul_rn(__fmul_rn(gp, sign_of(__fmul_rn(r, inv))), inv));
}

// sums: (3, B), the rows' l1, l2 and pen.
template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
epilogue_fwd_kernel(const float* __restrict__ x, const float* __restrict__ raw,
                    const float* __restrict__ mask, float* __restrict__ cf,
                    float* __restrict__ sums, int B, int N, float lo,
                    float hi) {
  const size_t row = (size_t)blockIdx.x * (size_t)N;
  x += row;
  raw += row;
  mask += row;
  cf += row;
  const int quads = (N + 3) >> 2;
  float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  for (int q = threadIdx.x; q < quads; q += blockDim.x) {
    const float4 vr = load_quad<kVec>(raw, q, N);
    const float4 vm = load_quad<kVec>(mask, q, N);
    const float4 vx = load_quad<kVec>(x, q, N);
    float4 c;
    c.x = fwd_one(vx.x, vr.x, vm.x, lo, hi, s1, s2, s3);
    c.y = fwd_one(vx.y, vr.y, vm.y, lo, hi, s1, s2, s3);
    c.z = fwd_one(vx.z, vr.z, vm.z, lo, hi, s1, s2, s3);
    c.w = fwd_one(vx.w, vr.w, vm.w, lo, hi, s1, s2, s3);
    store_quad<kVec>(cf, q, N, c);
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  s3 = warp_sum(s3);
  __shared__ float part[3][kMaxWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    part[0][warp] = s1;
    part[1][warp] = s2;
    part[2][warp] = s3;
  }
  __syncthreads();
  if (warp == 0 && lane < 3) {  // lane k sums the warps' partials of sum k
    const int warps = blockDim.x >> 5;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kMaxWarps; ++w)
      if (w < warps) s += part[lane][w];
    sums[(size_t)lane * B + blockIdx.x] = s;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
epilogue_bwd_kernel(const float* __restrict__ x, const float* __restrict__ raw,
                    const float* __restrict__ mask,
                    const float* __restrict__ gcf,
                    const float* __restrict__ gl1,
                    const float* __restrict__ gl2,
                    const float* __restrict__ gpen, float* __restrict__ dx,
                    float* __restrict__ draw, int N, float lo, float hi) {
  const size_t row = (size_t)blockIdx.x * (size_t)N;
  x += row;
  raw += row;
  mask += row;
  gcf += row;
  dx += row;
  draw += row;
  const float g1 = __ldg(gl1 + blockIdx.x);
  const float g2 = __ldg(gl2 + blockIdx.x);
  const float gp = __ldg(gpen + blockIdx.x);
  const int quads = (N + 3) >> 2;
  for (int q = threadIdx.x; q < quads; q += blockDim.x) {
    const float4 vr = load_quad<kVec>(raw, q, N);
    const float4 vm = load_quad<kVec>(mask, q, N);
    const float4 vx = load_quad<kVec>(x, q, N);
    const float4 vg = load_quad<kVec>(gcf, q, N);
    float4 d, r;
    bwd_one(vx.x, vr.x, vm.x, vg.x, g1, g2, gp, lo, hi, d.x, r.x);
    bwd_one(vx.y, vr.y, vm.y, vg.y, g1, g2, gp, lo, hi, d.y, r.y);
    bwd_one(vx.z, vr.z, vm.z, vg.z, g1, g2, gp, lo, hi, d.z, r.z);
    bwd_one(vx.w, vr.w, vm.w, vg.w, g1, g2, gp, lo, hi, d.w, r.w);
    store_quad<kVec>(dx, q, N, d);
    store_quad<kVec>(draw, q, N, r);
  }
}

// The block for a row of n: one quad a thread, at most kMaxThreads.
int threads_for(int n) {
  const int warps = ((n + 3) / 4 + 31) / 32;
  return warps < kMaxWarps ? 32 * warps : kMaxThreads;
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  std::uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<std::uintptr_t>(p);
  return (bits & 15u) == 0;
}

}  // namespace

extern "C" {

// x, raw, mask, cf: (B, N); sums: (3, B), the rows' l1, l2, pen.  All
// float32, contiguous.  vec != 0 takes the 16-byte variant, which needs
// N % 4 == 0 and 16-byte aligned pointers (else cudaErrorInvalidValue).
int cfgan_epilogue_fwd_f32(const void* x, const void* raw, const void* mask,
                           void* cf, void* sums, int B, int N, float lo,
                           float hi, int vec, void* stream) {
  if (B < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (vec && (N % 4 != 0 || !aligned16({x, raw, mask, cf})))
    return (int)cudaErrorInvalidValue;
  auto kernel = vec ? epilogue_fwd_kernel<true> : epilogue_fwd_kernel<false>;
  kernel<<<B, threads_for(N), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(raw),
      static_cast<const float*>(mask), static_cast<float*>(cf),
      static_cast<float*>(sums), B, N, lo, hi);
  return (int)cudaGetLastError();
}

// x, raw, mask, gcf, dx, draw: (B, N); gl1, gl2, gpen: (B,).  All float32,
// contiguous.  vec as for the forward (over x, raw, mask, gcf, dx, draw).
int cfgan_epilogue_bwd_f32(const void* x, const void* raw, const void* mask,
                           const void* gcf, const void* gl1, const void* gl2,
                           const void* gpen, void* dx, void* draw, int B,
                           int N, float lo, float hi, int vec, void* stream) {
  if (B < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (vec && (N % 4 != 0 || !aligned16({x, raw, mask, gcf, dx, draw})))
    return (int)cudaErrorInvalidValue;
  auto kernel = vec ? epilogue_bwd_kernel<true> : epilogue_bwd_kernel<false>;
  kernel<<<B, threads_for(N), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(raw),
      static_cast<const float*>(mask), static_cast<const float*>(gcf),
      static_cast<const float*>(gl1), static_cast<const float*>(gl2),
      static_cast<const float*>(gpen), static_cast<float*>(dx),
      static_cast<float*>(draw), N, lo, hi);
  return (int)cudaGetLastError();
}

}  // extern "C"
