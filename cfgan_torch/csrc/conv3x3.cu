// SAME-padded, stride-1 3x3 convolution over NHWC activations, for Hopper.
//
// Replaces the Pallas TPU kernel cfgan/ops/conv.py::_pallas_conv3x3_kernel
// (launched by _conv3x3_pallas_fwd through make_conv3x3_same_pallas).  It
// computes the same function: y[n,h,w,o] = sum_{dy,dx,c} x[n,h+dy-1,w+dx-1,c]
// * K[dy,dx,c,o] with zeros outside the image, accumulated in float32 and
// rounded once to the output type at the store.  No bias: the caller adds it,
// as cfgan/nn/layers.py::_Conv3x3Matmul does.
//
//   x  (B, H, W, Cin)     contiguous, float or bf16
//   K  (3, 3, Cin, Cout)  contiguous, same type (HWIO, the JAX layout)
//   y  (B, H, W, Cout)    contiguous, same type
//
// Any B, H, W, Cin and Cout work: the SAME padding and every ragged edge are
// bounds checks inside the kernel (no padded copy of x, no batch padding).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 tensor, 67 TFLOP/s f32
// outside the tensor cores) at the serving shape B=128, 28x28, 64->64:
//   operations  2*B*H*W*Cin*Cout*9 = 7.40 GFLOP
//   bf16: 25.8 MB of x + y + K -> 7.7 us at 3.35 TB/s (memory-bound; the
//         operations alone take 7.5 us at 989 TFLOP/s)
//   f32:  51.5 MB -> 15.4 us, but 110 us at 67 TFLOP/s (operations-bound)
// This first version runs on the CUDA cores in float32 and is far from the
// bf16 bound on purpose: it is the simple, correct design.  A tensor-core
// (wgmma) implicit GEMM fed by TMA is later work, as is a finer split for
// small batches (one 28x28 image gives 7 blocks per 64 output channels).
// chip_smoke.py measures it on the card; PERF.md keeps the numbers.
//
// Design: one block of 256 threads per (image, tile of up to 128 output
// pixels, tile of 64 output channels).  For each slice of 16 input channels
// the block stages the tile's input halo, (TH+2) x (TW+2) pixels with zeros
// outside the image, and the matching 9 x 16 x 64 slice of K in shared
// memory as float32.  The halo is stored channel-major so that the 16
// pixel lanes of a warp read neighbouring words.  Each thread accumulates
// 8 pixels x 4 output channels in registers over 9 taps x 16 channels per
// slice: 8 scalar and 1 vector shared-memory loads per 32 FMAs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixLanes = 16;                  // threads along output pixels
constexpr int kPixPer = 8;                     // pixels per thread
constexpr int kPixTile = kPixLanes * kPixPer;  // 128 output pixels per block
constexpr int kCoPer = 4;                      // output channels per thread
constexpr int kCoGroups = kThreads / kPixLanes;
constexpr int kCoTile = kCoGroups * kCoPer;    // 64 output channels per block
constexpr int kCiTile = 16;                    // input channels per stage
constexpr int kMaxTileW = 32;
// The halo is largest for a one-pixel-wide tile: (128 + 2) x (1 + 2).
constexpr int kMaxHalo = (kPixTile + 2) * 3;
constexpr int kMaxSmemBytes =
    (kCiTile * kMaxHalo + 9 * kCiTile * kCoTile) * int(sizeof(float));

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_same_kernel(const T* __restrict__ x, const T* __restrict__ k,
                    T* __restrict__ y, int H, int W, int Cin, int Cout,
                    int TH, int TW, int tiles_w, int tiles_per_image) {
  extern __shared__ __align__(16) float smem[];
  const int halo_w = TW + 2;
  const int halo = (TH + 2) * halo_w;
  float* xs = smem;                  // [kCiTile][halo]
  float* ks = smem + kCiTile * halo; // [9][kCiTile][kCoTile]; 16-byte aligned

  const int n = blockIdx.x / tiles_per_image;
  const int t = blockIdx.x - n * tiles_per_image;
  const int y0 = (t / tiles_w) * TH;
  const int x0 = (t % tiles_w) * TW;
  const int c0 = blockIdx.y * kCoTile;
  const int lane = threadIdx.x % kPixLanes;
  const int cg = threadIdx.x / kPixLanes;

  // halo offset of each pixel's top-left tap; a pixel outside the tile or
  // the image reads slot 0 and is never stored (bit p of `live` is clear)
  int hoff[kPixPer];
  unsigned live = 0;
#pragma unroll
  for (int p = 0; p < kPixPer; ++p) {
    const int pix = lane + p * kPixLanes;
    const int py = pix / TW, px = pix - py * TW;
    const bool ok = pix < TH * TW && y0 + py < H && x0 + px < W;
    hoff[p] = ok ? py * halo_w + px : 0;
    live |= unsigned(ok) << p;
  }

  float acc[kPixPer][kCoPer];
#pragma unroll
  for (int p = 0; p < kPixPer; ++p)
#pragma unroll
    for (int j = 0; j < kCoPer; ++j) acc[p][j] = 0.f;

  const long long img = (long long)n * H * W;
  for (int ci0 = 0; ci0 < Cin; ci0 += kCiTile) {
    // stage the input halo, channel fastest in global memory
    for (int i = threadIdx.x; i < kCiTile * halo; i += kThreads) {
      const int ci = i % kCiTile, hp = i / kCiTile;
      const int gy = y0 + hp / halo_w - 1, gx = x0 + hp % halo_w - 1;
      const int c = ci0 + ci;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin)
        v = load_f32(x + (img + (long long)gy * W + gx) * Cin + c);
      xs[ci * halo + hp] = v;
    }
    // stage K[:, :, ci0:ci0+16, c0:c0+64], output channel fastest
    for (int i = threadIdx.x; i < 9 * kCiTile * kCoTile; i += kThreads) {
      const int co = i % kCoTile, r = i / kCoTile;
      const int ci = r % kCiTile, tap = r / kCiTile;
      const int c = ci0 + ci, o = c0 + co;
      float v = 0.f;
      if (c < Cin && o < Cout)
        v = load_f32(k + ((long long)tap * Cin + c) * Cout + o);
      ks[i] = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int ci = 0; ci < kCiTile; ++ci) {
      const float* xc = xs + ci * halo;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 kv = *reinterpret_cast<const float4*>(
              ks + ((dy * 3 + dx) * kCiTile + ci) * kCoTile + cg * kCoPer);
          const int off = dy * halo_w + dx;
#pragma unroll
          for (int p = 0; p < kPixPer; ++p) {
            const float a = xc[hoff[p] + off];
            acc[p][0] = fmaf(a, kv.x, acc[p][0]);
            acc[p][1] = fmaf(a, kv.y, acc[p][1]);
            acc[p][2] = fmaf(a, kv.z, acc[p][2]);
            acc[p][3] = fmaf(a, kv.w, acc[p][3]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < kPixPer; ++p) {
    if (!(live >> p & 1u)) continue;
    const int pix = lane + p * kPixLanes;
    const int gy = y0 + pix / TW, gx = x0 + pix % TW;
    T* out = y + (img + (long long)gy * W + gx) * Cout;
#pragma unroll
    for (int j = 0; j < kCoPer; ++j) {
      const int o = c0 + cg * kCoPer + j;
      if (o < Cout) store(out + o, acc[p][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const T* x, const T* k, T* y, int B, int H, int W,
                   int Cin, int Cout, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return cudaErrorInvalidValue;
  // Raise the dynamic shared-memory cap once, to the most any tile needs.
  static cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_same_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmemBytes);
  if (attr != cudaSuccess) return attr;
  const int TW = W < kMaxTileW ? W : kMaxTileW;
  int TH = kPixTile / TW;
  if (TH > H) TH = H;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_per_image = tiles_w * ((H + TH - 1) / TH);
  const long long blocks = (long long)B * tiles_per_image;
  const int co_tiles = (Cout + kCoTile - 1) / kCoTile;
  if (blocks > 0x7fffffffLL || co_tiles > 65535) return cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(kCiTile * (TH + 2) * (TW + 2) + 9 * kCiTile * kCoTile) *
      sizeof(float);
  conv3x3_same_kernel<T><<<dim3((unsigned)blocks, co_tiles), kThreads, smem,
                           stream>>>(x, k, y, H, W, Cin, Cout, TH, TW,
                                     tiles_w, tiles_per_image);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int cfgan_conv3x3_f32(const void* x, const void* k, void* y, int B, int H,
                      int W, int Cin, int Cout, void* stream) {
  return (int)launch(static_cast<const float*>(x),
                     static_cast<const float*>(k), static_cast<float*>(y), B,
                     H, W, Cin, Cout, static_cast<cudaStream_t>(stream));
}

int cfgan_conv3x3_bf16(const void* x, const void* k, void* y, int B, int H,
                       int W, int Cin, int Cout, void* stream) {
  return (int)launch(static_cast<const __nv_bfloat16*>(x),
                     static_cast<const __nv_bfloat16*>(k),
                     static_cast<__nv_bfloat16*>(y), B, H, W, Cin, Cout,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
