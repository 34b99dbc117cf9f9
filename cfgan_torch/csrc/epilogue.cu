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
// the launch itself (a few microseconds).  The design moves each byte once:
// the forward writes x_cf and takes the three row sums in the same pass,
// and the backward recomputes masked, u and the signs from x, raw and mask
// instead of reading saved indicator tensors, as the Pallas kernels do.
//
// Design.  Forward: one block of 256 threads per row.  The threads walk
// the row with a stride of 256 (neighbouring threads on neighbouring
// words, the ragged end masked), write x_cf and keep three float32 partial
// sums; warp shuffles reduce them within each warp, shared memory across
// the 8 warps.  Backward: the same row layout, purely elementwise; each
// block reads its row's three cotangent scalars once.  Any B >= 1 and
// N >= 1 work with no padding (the Pallas version needs batch tiles that
// divide B).  Only float32 is built: it is the only type the step gives.
// Products and sums whose result is rounded before the next operation use
// the _rn intrinsics, which the compiler does not contract into FMAs: the
// kernels then round exactly where the plain version does, and the
// in-range test of the backward sees the same u.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float sign_of(float v) {
  return (float)((v > 0.0f) - (v < 0.0f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
epilogue_fwd_kernel(const float* __restrict__ x, const float* __restrict__ raw,
                    const float* __restrict__ mask, float* __restrict__ cf,
                    float* __restrict__ l1, float* __restrict__ l2,
                    float* __restrict__ pen, int N, float lo, float hi) {
  const size_t row = (size_t)blockIdx.x * (size_t)N;
  float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  for (int j = threadIdx.x; j < N; j += kThreads) {
    const float r = __ldg(raw + row + j);
    const float m = __ldg(mask + row + j);
    const float masked = __fmul_rn(r, m);
    const float u = __fadd_rn(__ldg(x + row + j), masked);
    cf[row + j] = u < lo ? lo : (u > hi ? hi : u);  // a NaN passes, as in clamp
    s1 += fabsf(masked);
    s2 += masked * masked;
    s3 += fabsf(__fmul_rn(r, 1.0f - m));
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  s3 = warp_sum(s3);
  __shared__ float part[3][kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    part[0][warp] = s1;
    part[1][warp] = s2;
    part[2][warp] = s3;
  }
  __syncthreads();
  if (warp == 0) {
    s1 = lane < kWarps ? part[0][lane] : 0.0f;
    s2 = lane < kWarps ? part[1][lane] : 0.0f;
    s3 = lane < kWarps ? part[2][lane] : 0.0f;
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    s3 = warp_sum(s3);
    if (lane == 0) {
      l1[blockIdx.x] = s1;
      l2[blockIdx.x] = s2;
      pen[blockIdx.x] = s3;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
epilogue_bwd_kernel(const float* __restrict__ x, const float* __restrict__ raw,
                    const float* __restrict__ mask,
                    const float* __restrict__ gcf,
                    const float* __restrict__ gl1,
                    const float* __restrict__ gl2,
                    const float* __restrict__ gpen, float* __restrict__ dx,
                    float* __restrict__ draw, int N, float lo, float hi) {
  const size_t row = (size_t)blockIdx.x * (size_t)N;
  const float g1 = __ldg(gl1 + blockIdx.x);
  const float g2 = __ldg(gl2 + blockIdx.x);
  const float gp = __ldg(gpen + blockIdx.x);
  for (int j = threadIdx.x; j < N; j += kThreads) {
    const float r = __ldg(raw + row + j);
    const float m = __ldg(mask + row + j);
    const float masked = __fmul_rn(r, m);
    const float u = __fadd_rn(__ldg(x + row + j), masked);
    const float inr = (u >= lo && u <= hi) ? 1.0f : 0.0f;
    const float du = __fmul_rn(__ldg(gcf + row + j), inr);
    // (du + g1 * sign(masked)) + (2 * g2) * masked, as the plain version
    const float dmasked = __fadd_rn(
        __fadd_rn(du, __fmul_rn(g1, sign_of(masked))),
        __fmul_rn(__fmul_rn(2.0f, g2), masked));
    const float inv = 1.0f - m;
    dx[row + j] = du;
    draw[row + j] = __fadd_rn(
        __fmul_rn(dmasked, m),
        __fmul_rn(__fmul_rn(gp, sign_of(__fmul_rn(r, inv))), inv));
  }
}

}  // namespace

extern "C" {

// x, raw, mask, cf: (B, N); l1, l2, pen: (B,).  All float32, contiguous.
int cfgan_epilogue_fwd_f32(const void* x, const void* raw, const void* mask,
                           void* cf, void* l1, void* l2, void* pen, int B,
                           int N, float lo, float hi, void* stream) {
  if (B < 1 || N < 1) return (int)cudaErrorInvalidValue;
  epilogue_fwd_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(raw),
      static_cast<const float*>(mask), static_cast<float*>(cf),
      static_cast<float*>(l1), static_cast<float*>(l2),
      static_cast<float*>(pen), N, lo, hi);
  return (int)cudaGetLastError();
}

// x, raw, mask, gcf, dx, draw: (B, N); gl1, gl2, gpen: (B,).  All float32,
// contiguous.
int cfgan_epilogue_bwd_f32(const void* x, const void* raw, const void* mask,
                           const void* gcf, const void* gl1, const void* gl2,
                           const void* gpen, void* dx, void* draw, int B,
                           int N, float lo, float hi, void* stream) {
  if (B < 1 || N < 1) return (int)cudaErrorInvalidValue;
  epilogue_bwd_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(raw),
      static_cast<const float*>(mask), static_cast<const float*>(gcf),
      static_cast<const float*>(gl1), static_cast<const float*>(gl2),
      static_cast<const float*>(gpen), static_cast<float*>(dx),
      static_cast<float*>(draw), N, lo, hi);
  return (int)cudaGetLastError();
}

}  // extern "C"
