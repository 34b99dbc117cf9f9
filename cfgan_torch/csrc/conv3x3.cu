// SAME-padded, stride-1 3x3 convolution over NHWC activations, for Hopper.
//
// Replaces the Pallas TPU kernel cfgan/ops/conv.py::_pallas_conv3x3_kernel
// (cfgan/ops/conv.py:71, launched by _conv3x3_pallas_fwd through
// make_conv3x3_same_pallas).  It computes the same function:
//   y[n,h,w,o] = sum_{dy,dx,c} x[n,h+dy-1,w+dx-1,c] * K[dy,dx,c,o]
// with zeros outside the image, accumulated in float32 and rounded once to
// the output type at the store.  No bias: the caller adds it, as
// cfgan/nn/layers.py::_Conv3x3Matmul does.
//
//   x  (B, H, W, Cin)     contiguous, float or bf16
//   K  (3, 3, Cin, Cout)  contiguous, same type (HWIO, the JAX layout)
//   y  (B, H, W, Cout)    contiguous, same type
//
// Any B, H, W, Cin and Cout work: the SAME padding and every ragged edge are
// handled inside the kernels (no padded copy of x, no batch padding).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 and 494.7 TFLOP/s tf32
// on the tensor cores, dense) at the serving shape B=128, 28x28, 64->64:
//   operations  2*B*H*W*Cin*Cout*9 = 7.40 GFLOP
//   bf16: 25.8 MB of x + y + K -> 0.0077 ms at 3.35 TB/s, against 0.0075 ms
//         of operations at 989 TFLOP/s: both near the ridge
//   f32:  51.5 MB -> 0.0154 ms, against three tf32 products (3xTF32, below)
//         3 x 7.40 GFLOP at 494.7 TFLOP/s = 0.0449 ms: operations (on the
//         CUDA cores, 67 TFLOP/s, it was 0.110 ms)
//
// bf16: an implicit GEMM on the tensor cores (conv3x3_wgmma_kernel).
//   M = B*H*W output pixels, N = Cout, depth 9*Cin.  A block of 1-4
//   warpgroups owns a tile of 64 pixels per warpgroup (consecutive in the
//   flattened (n, h, w) order) and a 64- or 32-wide slice of Cout, and is
//   persistent: one block an SM walks over tiles, so K is loaded into
//   shared memory once per block (9 x 64 x 64 bf16 = 72 KB), not per tile.
//   - The taps.  wgmma reads a shared-memory operand only in its canonical
//     layout, and a shifted window of pixels is not such a tile.  So A (the
//     pixels) comes from registers: the tile's input halo is staged once in
//     shared memory (cp.async, 16 bytes a thread), and each tap's A
//     fragments are loaded from it with ldmatrix, whose 32 row addresses are
//     free: a tap is a shift of the row address, and a row outside the image
//     points at 16 zero bytes.  B (K) is read by wgmma from shared memory.
//   - The halo of a tile of TM pixels starting at p0 holds, for each dy, the
//     pixels p0 + (dy-1)*W - 1 ... + TM + 1: one window of TM + 2W + 2
//     pixels where W <= TM + 2, else three windows of TM + 2, so its size
//     never depends on W.  Pixels are 128 bytes (64 channels; a slice of
//     Cin past its end is zero); the 16-byte chunk j of halo pixel s is
//     stored at chunk j ^ (s % 8), so the 8 rows of an ldmatrix hit 8
//     distinct bank groups.
//   - K by TMA (64 x 64 tiles of one tap, 128-byte swizzle, zeros past Cin
//     and Cout) where its rows are 16-byte multiples, else by cp.async.
//     Every SM reads all of K at the same moment, which the L2 serves
//     slowly: with cp.async the wait for K was the largest part of a
//     launch's first tile, TMA cut it to a fraction.  K comes in three
//     rows of taps on three mbarriers, and each block starts its products
//     on its own row (blockIdx % 3) while the other two are in flight.
//   - Double-buffered: the next tile's halo is in flight (cp.async) while
//     the current one runs its 36 products m64nNk16 (A from registers).
//   - dx: the same kernel with a flag that reads K as K[2-dy, 2-dx, o, c]
//     while staging it, so the backward needs no flipped copy of K.
//   - Cin > 64 is walked in 64-channel slices (K restaged per slice);
//     Cout in 64-wide tiles; at small batch, 32-wide tiles and one
//     warpgroup per block, so B=1 at 28x28, 64->64 launches 26 blocks.
//   - Epilogue: the f32 accumulators are rounded once (__float2bfloat16_rn)
//     into a per-warp tile in shared memory, then stored 16 bytes a thread.
//   ptxas (sm_90a, CUDA 12.9): 128 registers (the cap of 512 threads),
//   0 spills, for all four instantiations (BN 64/32, flip 0/1).
//
// float32: 3xTF32 on the tensor cores (f32::conv3x3_tf32_kernel).  One
// tf32 product keeps about 3 decimal digits, which the port's float32 bars
// (1e-4 against the plain version, 3e-5 single-step parity) do not allow.
// So each operand is split as a = big + small, big = tf32(a) rounded to
// nearest (cvt.rna: the tensor cores would truncate) and small = a - big
// (sm90::tf32_split), and each product is big*big + big*small +
// small*big (small*small is below float32's rounding), accumulated in f32
// registers.
// The structure is the bf16 kernel's: a persistent implicit GEMM over
// pixels in (n, h, w) order, the halo staged once per tile (16-byte chunks
// XOR-swizzled by pixel), a tap a shift of ldmatrix's row addresses, which
// deliver tf32 A fragments as they are (each 32-bit word one element).  A
// is split in registers one k8 step at a time, double-buffered, so that
// the next step loads while the last one's products run.
//   - B must be K-major: wgmma has no transpose for 32-bit types, and K
//     (HWIO) has Cout contiguous.  So a small kernel per call
//     (conv3x3_tf32_split_kernel) writes K's big and small parts, already
//     flipped for dx, in wgmma's K-major layout, each (Cin slice, tap, 8
//     output channels) a contiguous 2 KB image of shared memory, into a
//     workspace the caller allocates; the main kernel loads it with the
//     bulk copy engine, a row of taps on each of three mbarriers.  It is
//     one extra launch (K read once, 147 KB at 64->64, and 295 KB
//     written), and it takes B's split out of the main loop.
//   - Shared memory: both parts of K for a 64-wide Cout tile would be
//     9 x 64 x 64 x 4 B x 2 = 295 KB, more than a block's 227 KB.  So Cout
//     comes in 32-wide tiles (147 KB, loaded once for the block's life),
//     one block an SM.  Beside K there is room for one float32 halo of
//     three warpgroups' 192 pixels ((192 + 2W + 2) x 256 B, 64 KB at
//     W = 28), or two of one warpgroup's 64: three warpgroups take turns
//     on the tensor cores while the others load and split their A, which
//     beat hiding the halo's load behind one warpgroup's products.  Fewer
//     warpgroups where three would leave SMs without a tile, or where
//     their halo does not fit (W over 68 for three, 100 for two).
//     Streaming K by rows of taps through a ring would let 64-wide tiles
//     in, but every tile would then read all of K from the L2 again.
//   - B = 1 at 28x28, 64->64: 13 tiles of 64 pixels x 2 Cout tiles = 26
//     blocks of one warpgroup.
//   - The tensor cores add each product into the accumulator with
//     truncation; the 216 products of a tile would take the error past
//     the float32 bar, so each k8 step's three products sum into fresh
//     registers that the CUDA cores add into the tile's sum
//     (sm90::wgmma_3xtf32_n32).
//   - Epilogue: float32 straight from the accumulators, two values a
//     thread; a pixel's 8 columns of one group are one 32-byte sector.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "sm90.cuh"

// ---------------------------------------------- float32 on the tensor cores
namespace f32 {
namespace {

constexpr int kWarpgroup = 128;
constexpr int kTileRows = 64;             // wgmma M: pixels per warpgroup
constexpr int kBN = 32;                   // wgmma N: output channels a tile
constexpr int kSlice = 64;                // input channels per stage
constexpr int kChunks = kSlice / 4;       // 16-byte chunks per halo pixel
constexpr int kPixelBytes = kSlice * 4;
constexpr int kSteps = kSlice / 8;        // k8 products per tap
constexpr int kGroupBytes = 8 * kSlice * 4;       // 8 rows of N, one slice
constexpr int kTapBytes = kBN / 8 * kGroupBytes;  // a tap's tile, one part
constexpr int kKBytes = 2 * 9 * kTapBytes;        // big and small, 9 taps
constexpr int kSmemLimit = 232448;
constexpr int kMaxWarpgroups = 3;

struct Params {
  const float* x;
  const float* ws;  // K split by conv3x3_tf32_split_kernel
  float* y;
  long long P;      // B * H * W
  int H, W, CI, CO;
  int vec;          // x's pixels start 16-byte aligned: stage with cp.async
  int yvec;         // y's rows start 8-byte aligned and CO is even
  int TM, S, nslots, mtiles, ntiles, nslices, ngroups, nbuf, halo_bytes;
  long long part;   // floats of one part of ws
};

// chunk c of the halo (pixel c / 16, 16-byte chunk c % 16) lives at this
// chunk: 8 consecutive pixels of one chunk fall on 8 distinct bank groups
__device__ __forceinline__ uint32_t swz(uint32_t c) {
  return c ^ ((c >> 4) & 7);
}

// K (3, 3, CI, CO), or flipped K[8 - t][o][c] from (3, 3, CO, CI), as
// 3xTF32 parts in wgmma's K-major canonical layout without swizzle, each
// (slice, tap, group of 8 output channels) a contiguous 2 KB image of
// shared memory: (n, k) at (n % 8) * 16 + (k / 4) * 128 + (k % 4) * 4,
// LBO = 128 (along the depth), SBO = 2048 (along N).  Part 1 (small) lies
// `part` floats after part 0 (big); zeros past CI and CO.
__global__ void conv3x3_tf32_split_kernel(const float* __restrict__ k,
                                          float* __restrict__ ws, int CI,
                                          int CO, int ngroups, int flip,
                                          long long part) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < part; i += (long long)gridDim.x * blockDim.x) {
    const int e = (int)(i % 4), r = (int)(i / 4 % 8), kc = (int)(i / 32 % 16);
    const long long q = i / 512;
    const int ng = (int)(q % ngroups), t = (int)(q / ngroups % 9);
    const int s = (int)(q / ngroups / 9);
    const int n = ng * 8 + r, c = s * kSlice + kc * 4 + e;
    float v = 0.f;
    if (c < CI && n < CO)
      v = flip ? k[((long long)(8 - t) * CO + n) * CI + c]
               : k[((long long)t * CI + c) * CO + n];
    uint32_t big, small;
    sm90::tf32_split(__float_as_uint(v), big, small);
    ws[i] = __uint_as_float(big);
    ws[part + i] = __uint_as_float(small);
  }
}

long long split_floats(int CI, int CO) {
  return (long long)((CI + kSlice - 1) / kSlice) * 9 *
         ((CO + kBN - 1) / kBN) * (kBN / 8) * (kGroupBytes / 4);
}

// halo pixels [p0 + (dy-1)*W - 1, ... + TM + 2) for each dy, input channels
// [c0, c0 + 64), float32; zeros past the tensor or past CI
__device__ __forceinline__ void stage_halo(const Params& p, unsigned char* buf,
                                           long long p0, int c0) {
  const int total = p.nslots * kChunks;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int s = i / kChunks, j = i % kChunks;
    int dy = s / p.S;
    if (dy > 2) dy = 2;
    const long long q = p0 + (long long)(dy - 1) * p.W - 1 + (s - dy * p.S);
    const int c = c0 + 4 * j;
    const int avail = q >= 0 && q < p.P ? p.CI - c : 0;
    sm90::copy16_f32(buf + swz(i) * 16,
                     p.x + (avail > 0 ? q * p.CI + c : 0), avail, p.vec);
  }
}

__global__ void __launch_bounds__(kWarpgroup * kMaxWarpgroups, 1)
conv3x3_tf32_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ks = smem;                  // big taps, then small taps
  unsigned char* zero16 = smem + kKBytes;    // + 3 mbarriers at 64, 72, 80
  unsigned char* halo = zero16 + 128;
  const int tid = threadIdx.x;
  const int wg = tid / kWarpgroup, warp = (tid / 32) % 4, lane = tid % 32;
  if (tid < 4) reinterpret_cast<uint32_t*>(zero16)[tid] = 0u;
  const uint32_t kbar = sm90::smem_u32(zero16 + 64);  // one per row of taps
  if (tid == 0) {
    for (int g = 0; g < 3; ++g) sm90::mbar_init(kbar + 8 * g, 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();
  int kphase = 0;

  const int units = p.mtiles * p.ntiles;
  const int mine = (int)blockIdx.x < units
                       ? (units - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int stages = mine * p.nslices;
  auto unit_of = [&](int i) {
    return (int)blockIdx.x + (i / p.nslices) * (int)gridDim.x;
  };
  auto issue_halo = [&](int i) {
    if (i < stages) {
      const int u = unit_of(i);
      stage_halo(p, halo + (i % p.nbuf) * p.halo_bytes,
                 (long long)(u % p.mtiles) * p.TM, (i % p.nslices) * kSlice);
    }
    sm90::cp_async_commit();
  };

  // this lane's ldmatrix row: pixel rel of the tile, 16-byte chunk half jh
  const int rel =
      wg * kTileRows + warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int jh = lane >> 4;
  const uint32_t zaddr = sm90::smem_u32(zero16);
  const uint32_t kbase = sm90::smem_u32(ks);

  float acc[kBN / 2];
  int k_key = -1;
  const int dy0 = blockIdx.x % 3;  // the first row of taps this block takes
  issue_halo(0);
  for (int i = 0; i < stages; ++i) {
    const int u = unit_of(i), s = i % p.nslices;
    const int ntile = u / p.mtiles;
    const long long p0 = (long long)(u % p.mtiles) * p.TM;
    const int n0 = ntile * kBN;
    if (s == 0) {
#pragma unroll
      for (int r = 0; r < kBN / 2; ++r) acc[r] = 0.f;
    }
    // K changes only between the slices of CI or the tiles of CO; the last
    // stage's products are done with it (the barrier that ends it).  One
    // thread asks the bulk copy engine for the split taps, a row of taps
    // (its big and small parts) on each mbarrier; the products start on the
    // block's own row while the other two are in flight.
    const bool fresh = ntile * p.nslices + s != k_key;
    if (fresh) {
      if (tid == 0) {
        for (int j = 0; j < 3; ++j) {
          const int g = (dy0 + j) % 3;
          sm90::mbar_expect_tx(kbar + 8 * g, 2 * 3 * kTapBytes);
          for (int t = 3 * g; t < 3 * g + 3; ++t)
            for (int h = 0; h < 2; ++h)
              sm90::bulk_load(
                  kbase + (h * 9 + t) * kTapBytes,
                  p.ws + h * p.part +
                      (((long long)s * 9 + t) * p.ngroups + ntile * (kBN / 8)) *
                          (kGroupBytes / 4),
                  kTapBytes, kbar + 8 * g);
        }
      }
      k_key = ntile * p.nslices + s;
      sm90::cp_async_wait<0>();  // this stage's halo
      sm90::mbar_wait(kbar + 8 * dy0, kphase);
    } else {
      sm90::cp_async_wait<0>();  // this stage's halo
    }
    __syncthreads();
    // the next halo streams in while this one is multiplied
    if (p.nbuf == 2 && !fresh) issue_halo(i + 1);

    const uint32_t hbase = sm90::smem_u32(halo + (i % p.nbuf) * p.halo_bytes);
    const long long pix = p0 + rel;
    const bool live = pix < p.P;
    const int h = live ? (int)((pix / p.W) % p.H) : 0;
    const int w = live ? (int)(pix % p.W) : 0;
    // A group is one k8 step of one tap: A's fragment (ldmatrix) split
    // into its tf32 parts while the last group's products run (two
    // buffers), its three products summed into a fresh tmp, which the CUDA
    // cores add into acc once the group is done (sm90::wgmma_3xtf32_n32)
    uint32_t big[2][4], small[2][4];
    float tmp[2][kBN / 2];
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const int dy = (dy0 + j / 3) % 3, dx = j % 3, t = dy * 3 + dx;
      if (fresh && (j == 3 || j == 6)) {  // the next row of K's taps
        sm90::mbar_wait(kbar + 8 * dy, kphase);
        if (j == 6 && p.nbuf == 2) issue_halo(i + 1);
      }
      const bool ok = live && (unsigned)(h + dy - 1) < (unsigned)p.H &&
                      (unsigned)(w + dx - 1) < (unsigned)p.W;
      const uint32_t c = (uint32_t)(dy * p.S + rel + dx) * kChunks + jh;
#pragma unroll
      for (int kc = 0; kc < kSteps; ++kc) {
        const int b = kc % 2;  // kSteps is even: group j * kSteps + kc
        if (j > 0 || kc >= 2) {
          sm90::wgmma_wait<1>();  // the group two back is done
#pragma unroll
          for (int r = 0; r < kBN / 2; ++r) acc[r] += tmp[b][r];
        }
        uint32_t a[4];
        sm90::ldmatrix_x4(a, ok ? hbase + swz(c + 2 * kc) * 16 : zaddr);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sm90::tf32_split(a[e], big[b][e], small[b][e]);
        sm90::wgmma_fence();
        const uint32_t off = t * kTapBytes + kc * 2 * 128;
        sm90::wgmma_3xtf32_n32(
            tmp[b], big[b], small[b],
            sm90::make_desc(kbase + off, 128, kGroupBytes),
            sm90::make_desc(kbase + 9 * kTapBytes + off, 128, kGroupBytes),
            0);
        sm90::wgmma_commit();
      }
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < kBN / 2; ++r) {
      acc[r] += tmp[0][r];
      acc[r] += tmp[1][r];
    }
    if (fresh) kphase ^= 1;
    __syncthreads();  // the halo buffer and K are free again
    if (p.nbuf == 1) issue_halo(i + 1);

    if (s == p.nslices - 1) {
      // f32 straight from the accumulators: a row's 8 columns of one
      // 8-wide group are 32 contiguous bytes, one sector
      const int g = lane / 4, tq = lane % 4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long q = p0 + wg * kTileRows + warp * 16 + g + 8 * half;
        if (q >= p.P) continue;
        float* dst = p.y + q * p.CO;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int o = n0 + 8 * j + 2 * tq;
          const float v0 = acc[4 * j + 2 * half];
          const float v1 = acc[4 * j + 2 * half + 1];
          if (p.yvec && o < p.CO) {
            *reinterpret_cast<float2*>(dst + o) = make_float2(v0, v1);
          } else {
            if (o < p.CO) dst[o] = v0;
            if (o + 1 < p.CO) dst[o + 1] = v1;
          }
        }
      }
    }
  }
  sm90::cp_async_wait<0>();
}

}  // namespace

// floats of the workspace (both parts), or 0 where it would not fit an int
int workspace_floats(int CI, int CO) {
  if (CI <= 0 || CO <= 0) return 0;
  const long long n = 2 * split_floats(CI, CO);
  return n > 0x7fffffffLL ? 0 : (int)n;
}

cudaError_t conv3x3_f32(const float* x, const float* k, float* ws, float* y,
                        int B, int H, int W, int CI, int CO, int flip,
                        int ws_floats, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || CI <= 0 || CO <= 0 ||
      ws_floats <= 0 || ws_floats != workspace_floats(CI, CO))
    return cudaErrorInvalidValue;
  Params p{};
  p.x = x;
  p.ws = ws;
  p.y = y;
  p.P = (long long)B * H * W;
  p.H = H;
  p.W = W;
  p.CI = CI;
  p.CO = CO;
  p.vec = CI % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.yvec = CO % 2 == 0 && reinterpret_cast<uintptr_t>(y) % 8 == 0;
  p.ntiles = (CO + kBN - 1) / kBN;
  p.nslices = (CI + kSlice - 1) / kSlice;
  p.ngroups = p.ntiles * (kBN / 8);
  int sms = 0;
  cudaError_t err = sm90::sm_count(sms);
  if (err != cudaSuccess) return err;
  // the most warpgroups a block (up to three, with one buffer of halo
  // beside K) whose tiles still give every SM one and whose halo fits;
  // one warpgroup has two buffers
  const int fixed = kKBytes + 128;
  int warpgroups = kMaxWarpgroups;
  for (;; --warpgroups) {
    p.TM = kTileRows * warpgroups;
    p.S = p.W < p.TM + 2 ? p.W : p.TM + 2;
    p.nslots = 2 * p.S + p.TM + 2;
    p.mtiles = (int)((p.P + p.TM - 1) / p.TM);
    p.halo_bytes = p.nslots * kPixelBytes;
    if (warpgroups == 1 ||
        ((long long)p.mtiles * p.ntiles >= sms &&
         fixed + p.halo_bytes <= kSmemLimit))
      break;
  }
  p.nbuf = fixed + 2 * p.halo_bytes <= kSmemLimit ? 2 : 1;
  const int smem = fixed + p.nbuf * p.halo_bytes;
  const void* fn = reinterpret_cast<const void*>(conv3x3_tf32_kernel);
  int per_sm = 0;
  err = sm90::occupancy(fn, kWarpgroup * warpgroups, smem, kSmemLimit, sms,
                        per_sm);
  if (err != cudaSuccess) return err;
  const long long units = (long long)p.mtiles * p.ntiles;
  if (units * p.nslices > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.part = split_floats(CI, CO);
  long long sblocks = (p.part + 255) / 256;
  if (sblocks > 4LL * sms) sblocks = 4LL * sms;
  conv3x3_tf32_split_kernel<<<(unsigned)sblocks, 256, 0, stream>>>(
      k, ws, CI, CO, p.ngroups, flip, p.part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long most = (long long)sms * per_sm;
  const int grid = (int)(units < most ? units : most);
  conv3x3_tf32_kernel<<<grid, kWarpgroup * warpgroups, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace f32

// ------------------------------------------------- bf16 on the tensor cores
namespace tc {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kWarpgroup = 128;
constexpr int kMaxWarpgroups = 4;
constexpr int kTileRows = 64;        // wgmma M: pixels per warpgroup
constexpr int kSlice = 64;           // input channels per stage
constexpr int kChunks = kSlice / 8;  // 16-byte chunks per halo pixel
constexpr int kPixelBytes = kSlice * 2;
constexpr int kDepthSteps = kSlice / 16;  // k16 products per tap
constexpr int kSmemLimit = 232448;   // an H100 block's shared memory

struct Params {
  const bf16* x;
  const bf16* k;
  bf16* y;
  long long P;  // B * H * W
  int H, W, CI, CO;
  int vec;      // x's pixels start 16-byte aligned: stage with cp.async
  int kvec;     // K's rows along its last axis start 16-byte aligned
  int yvec;     // y's pixels start 16-byte aligned: 16-byte stores
  int TM;       // pixels per tile, 64 per warpgroup
  int S;        // halo offset between the dy windows: min(W, TM + 2)
  int nslots;   // halo pixels: 2 * S + TM + 2
  int mtiles, ntiles, nslices, nbuf;
  int halo_bytes, k_bytes, out_bytes;
  int ktma;     // K comes by TMA (tensor map kmap), 128-byte swizzled
};

// chunk c of a 128-byte-row buffer (row c / 8, 16-byte chunk c % 8) lives
// at this chunk: 8 consecutive rows of one column fall on 8 distinct bank
// groups
__device__ __forceinline__ uint32_t swz(uint32_t c) { return c ^ ((c >> 3) & 7); }

// 16 bytes from src (8 elements, those at or past `avail` zero) to shared
// memory: cp.async where the row is aligned, else element-wise
__device__ __forceinline__ void copy16(unsigned char* dst, const bf16* src,
                                       int avail, bool vec,
                                       const bf16* any) {
  if (vec) {
    sm90::cp_async16(sm90::smem_u32(dst), avail > 0 ? src : any,
                     avail > 0 ? 16 : 0);
  } else {
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = e < avail ? src[e] : __float2bfloat16_rn(0.f);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  }
}

// halo pixels [p0 + (dy-1)*W - 1, ... + TM + 2) for each dy, input channels
// [c0, c0 + 64); zeros past the tensor or past Cin
__device__ __forceinline__ void stage_halo(const Params& p, unsigned char* buf,
                                           long long p0, int c0) {
  const int total = p.nslots * kChunks;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int s = i / kChunks, j = i % kChunks;
    int dy = s / p.S;
    if (dy > 2) dy = 2;
    const long long q = p0 + (long long)(dy - 1) * p.W - 1 + (s - dy * p.S);
    const int c = c0 + 8 * j;
    const bool in = q >= 0 && q < p.P;
    copy16(buf + swz(i) * 16, p.x + (in ? q : 0) * p.CI + c,
           in ? p.CI - c : 0, p.vec, p.x);
  }
}

// K's taps [t0, t0 + 3) for input channels [c0, c0 + 64) and output
// channels [n0, n0 + BN), into the 9 x 4 slabs of 16 (depth) x BN in
// wgmma's canonical layouts without swizzle, each 16-byte chunk straight
// from a row of K:
//   FLIP 0, K[t][c][o], o contiguous: N-major core matrices, (k, n) at
//     (k/8)*BN*16 + (n/8)*128 + (k%8)*16 + (n%8)*2: LBO = BN*16, SBO = 128;
//   FLIP 1, K[8-t][o][c], c contiguous: depth-major core matrices, (k, n)
//     at (n/8)*256 + (k/8)*128 + (n%8)*16 + (k%8)*2: LBO = 128, SBO = 256.
template <int BN, int FLIP>
__device__ __forceinline__ void stage_k(const Params& p, unsigned char* ks,
                                        int t0, int c0, int n0) {
  // 3 taps x 4 slabs x 2*BN chunks, walked in shared-memory order so that
  // a warp's copies land on distinct banks
  constexpr int kSlabChunks = 2 * BN, kTotal = 3 * kDepthSteps * kSlabChunks;
  for (int ii = threadIdx.x; ii < kTotal; ii += blockDim.x) {
    // blocks start at other chunks, so that the SMs do not all ask the L2
    // for the same lines at once
    const int i = (ii + blockIdx.x * 37) % kTotal;
    const int slab = t0 * kDepthSteps + i / kSlabChunks, q = i % kSlabChunks;
    const int t = slab / kDepthSteps, k16 = (slab % kDepthSteps) * 16;
    unsigned char* dst = ks + slab * BN * 32 + q * 16;
    if (FLIP) {  // q = (n/8)*16 + (k%16/8)*8 + n%8: 8 depth rows of column n
      const int n = (q / 16) * 8 + q % 8, c = c0 + k16 + ((q / 8) % 2) * 8;
      const int o = n0 + n;
      const bool in = o < p.CO;
      copy16(dst, p.k + ((long long)(8 - t) * p.CO + (in ? o : 0)) * p.CI + c,
             in ? p.CI - c : 0, p.kvec, p.k);
    } else {  // q = (k%16/8)*BN + (n/8)*8 + k%8: 8 columns of depth row k
      const int c = c0 + k16 + (q / BN) * 8 + q % 8;
      const int o = n0 + ((q % BN) / 8) * 8;
      const bool in = c < p.CI;
      copy16(dst, p.k + ((long long)t * p.CI + (in ? c : 0)) * p.CO + o,
             in ? p.CO - o : 0, p.kvec, p.k);
    }
  }
}

template <int BN, int FLIP>
__global__ void __launch_bounds__(kWarpgroup * kMaxWarpgroups)
conv3x3_wgmma_kernel(const Params p,
                     const __grid_constant__ CUtensorMap kmap) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // K's TMA tiles are 128-byte swizzled, which wants 1024-byte alignment
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ks = smem;
  unsigned char* zero16 = smem + p.k_bytes;  // + 3 mbarriers at 64, 72, 80
  unsigned char* outs = zero16 + 128;  // 16 x BN bf16 a warp
  unsigned char* halo = outs + p.out_bytes;
  const int tid = threadIdx.x;
  const int wg = tid / kWarpgroup, warp = (tid / 32) % 4, lane = tid % 32;
  unsigned char* my_out = outs + (tid / 32) * 16 * BN * 2;
  if (tid < 4) reinterpret_cast<uint32_t*>(zero16)[tid] = 0u;
  const uint32_t kbar = sm90::smem_u32(zero16 + 64);  // one per row of taps
  if (tid == 0) {
    for (int g = 0; g < 3; ++g) sm90::mbar_init(kbar + 8 * g, 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();
  int kphase = 0;

  const int units = p.mtiles * p.ntiles;
  const int mine = (int)blockIdx.x < units
                       ? (units - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int stages = mine * p.nslices;
  auto unit_of = [&](int i) {
    return (int)blockIdx.x + (i / p.nslices) * (int)gridDim.x;
  };
  auto issue_halo = [&](int i) {
    if (i < stages) {
      const int u = unit_of(i);
      stage_halo(p, halo + (i % p.nbuf) * p.halo_bytes,
                 (long long)(u % p.mtiles) * p.TM, (i % p.nslices) * kSlice);
    }
    sm90::cp_async_commit();
  };

  // this lane's ldmatrix row: pixel rel of the tile, 16-byte chunk half jh
  const int rel =
      wg * kTileRows + warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int jh = lane >> 4;
  const uint32_t zaddr = sm90::smem_u32(zero16);
  const uint32_t kbase = sm90::smem_u32(ks);

  float acc[BN / 2];
  int k_key = -1;
  const int dy0 = blockIdx.x % 3;  // the first row of taps this block takes
  issue_halo(0);
  for (int i = 0; i < stages; ++i) {
    const int u = unit_of(i), s = i % p.nslices;
    const int ntile = u / p.mtiles;
    const long long p0 = (long long)(u % p.mtiles) * p.TM;
    const int n0 = ntile * BN;
    if (s == 0) {
#pragma unroll
      for (int r = 0; r < BN / 2; ++r) acc[r] = 0.f;
    }
    // K changes only between the slices of Cin or the tiles of Cout; the
    // last stage's products are done with it (the barrier that ends it).
    // Loading it takes longer than the halo (every SM reads all of it, and
    // the L2 serves a line to all SMs at once slowly), so it comes in three
    // groups of taps (rows dy), and the products of the first group start
    // while the others are in flight; each block starts at its own group.
    // With TMA, one thread asks for each tap's 64 x 64 tile of K (zeros
    // past Cin and Cout) and the block waits on the row's mbarrier.
    const bool fresh = ntile * p.nslices + s != k_key;
    if (fresh) {
      for (int j = 0; j < 3; ++j) {
        const int g = (dy0 + j) % 3;
        if (p.ktma) {
          if (tid == 0) {
            sm90::mbar_expect_tx(kbar + 8 * g, 3 * 64 * 64 * 2);
            for (int t = 3 * g; t < 3 * g + 3; ++t)
              sm90::tma_load_3d(sm90::smem_u32(ks + t * 64 * 64 * 2), &kmap,
                                FLIP ? s * kSlice : n0, FLIP ? n0 : s * kSlice,
                                FLIP ? 8 - t : t, kbar + 8 * g);
          }
        } else {
          stage_k<BN, FLIP>(p, ks, 3 * g, s * kSlice, n0);
          sm90::cp_async_commit();
        }
      }
      k_key = ntile * p.nslices + s;
      if (p.ktma) {
        sm90::cp_async_wait<0>();  // this stage's halo
        sm90::mbar_wait(kbar + 8 * dy0, kphase);
      } else {
        sm90::cp_async_wait<2>();  // this stage's halo and K's first row
      }
    } else {
      sm90::cp_async_wait<0>();  // this stage's halo
    }
    sm90::fence_proxy_async();  // K, written by cp.async, read by wgmma
    __syncthreads();
    // the next halo streams in while this one is multiplied
    if (p.nbuf == 2 && !fresh) issue_halo(i + 1);

    const uint32_t hbase = sm90::smem_u32(halo + (i % p.nbuf) * p.halo_bytes);
    const long long pix = p0 + rel;
    const bool live = pix < p.P;
    const int h = live ? (int)((pix / p.W) % p.H) : 0;
    const int w = live ? (int)(pix % p.W) : 0;
    uint32_t a[kDepthSteps][4];
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const int dy = (dy0 + j / 3) % 3, dx = j % 3, t = dy * 3 + dx;
      if (j >= 1) sm90::wgmma_wait<0>();  // the last tap has read a
      if (fresh && (j == 3 || j == 6)) {  // the next row of K's taps
        if (p.ktma) {
          sm90::mbar_wait(kbar + 8 * dy, kphase);
        } else {
          if (j == 3)
            sm90::cp_async_wait<1>();
          else
            sm90::cp_async_wait<0>();
          sm90::fence_proxy_async();
          __syncthreads();
        }
        if (j == 6 && p.nbuf == 2) issue_halo(i + 1);
      }
      const bool ok = live && (unsigned)(h + dy - 1) < (unsigned)p.H &&
                      (unsigned)(w + dx - 1) < (unsigned)p.W;
      const uint32_t c = (uint32_t)(dy * p.S + rel + dx) * kChunks + jh;
#pragma unroll
      for (int kc = 0; kc < kDepthSteps; ++kc)
        sm90::ldmatrix_x4(a[kc],
                          ok ? hbase + swz(c + 2 * kc) * 16 : zaddr);
      sm90::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kDepthSteps; ++kc) {
        // TMA: a tap's 64 x 64 tile, rows of 128 swizzled bytes (depth rows
        // unflipped, N-major; columns flipped, depth-major)
        const uint64_t desc =
            p.ktma ? sm90::make_desc_sw128(kbase + t * 64 * 64 * 2 +
                                           kc * (FLIP ? 32 : 2048))
            : FLIP ? sm90::make_desc(kbase + (t * kDepthSteps + kc) * BN * 32,
                                     128, 256)
                   : sm90::make_desc(kbase + (t * kDepthSteps + kc) * BN * 32,
                                     BN * 16, 128);
        sm90::Wgmma<BN, FLIP ? 0 : 1>::run(acc, a[kc], desc);
      }
      sm90::wgmma_commit();
    }
    sm90::wgmma_wait<0>();
    if (fresh) kphase ^= 1;
    __syncthreads();  // the halo buffer and K are free again
    if (p.nbuf == 1) issue_halo(i + 1);

    if (s == p.nslices - 1) {
      // round once to bf16 into the warp's 16 x BN tile (16-byte chunks
      // swizzled by row), then store it a pixel row of 16-byte chunks at a
      // time
      const int g = lane / 4, tq = lane % 4;
      constexpr int kRowChunks = BN / 8;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = g + 8 * half;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          __nv_bfloat162 v;
          v.x = __float2bfloat16_rn(acc[4 * j + 2 * half]);
          v.y = __float2bfloat16_rn(acc[4 * j + 2 * half + 1]);
          *reinterpret_cast<__nv_bfloat162*>(
              my_out + (row * kRowChunks + (j ^ (row % kRowChunks))) * 16 +
              tq * 4) = v;
        }
      }
      __syncwarp();
      const long long q0 = p0 + wg * kTileRows + warp * 16;
#pragma unroll
      for (int it = 0; it < 16 * kRowChunks / 32; ++it) {
        const int e = it * 32 + lane;
        const int row = e / kRowChunks, j = e % kRowChunks;
        const long long q = q0 + row;
        const int o = n0 + 8 * j;
        if (q >= p.P || o >= p.CO) continue;
        const unsigned char* src =
            my_out + (row * kRowChunks + (j ^ (row % kRowChunks))) * 16;
        bf16* dst = p.y + q * p.CO + o;
        if (p.yvec) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          const bf16* v = reinterpret_cast<const bf16*>(src);
          for (int m = 0; m < 8 && o + m < p.CO; ++m) dst[m] = v[m];
        }
      }
      __syncwarp();
    }
  }
  sm90::cp_async_wait<0>();
}

// K as a 3-D tensor for TMA, 64 x 64 boxes of one tap, 128-byte swizzle:
// (Cout, Cin, 9), or flipped (Cin, Cout, 9) with the layout (3, 3, Cout, Cin)
bool k_tensor_map(CUtensorMap& map, const bf16* k, int CI, int CO, int flip) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t inner = flip ? CI : CO, outer = flip ? CO : CI;
  const cuuint64_t dims[3] = {inner, outer, 9};
  const cuuint64_t strides[2] = {inner * 2, inner * outer * 2};
  const cuuint32_t box[3] = {64, 64, 1}, step[3] = {1, 1, 1};
  return encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<bf16*>(k), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int FLIP>
cudaError_t launch(Params p, int warpgroups, cudaStream_t stream) {
  p.TM = kTileRows * warpgroups;
  p.S = p.W < p.TM + 2 ? p.W : p.TM + 2;
  p.nslots = 2 * p.S + p.TM + 2;
  p.mtiles = (int)((p.P + p.TM - 1) / p.TM);
  p.ntiles = (p.CO + BN - 1) / BN;
  p.nslices = (p.CI + kSlice - 1) / kSlice;
  p.halo_bytes = p.nslots * kPixelBytes;
  p.k_bytes = 9 * kSlice * BN * 2;
  p.out_bytes = 4 * warpgroups * 16 * BN * 2;
  CUtensorMap kmap{};
  p.ktma = BN == 64 && p.kvec && k_tensor_map(kmap, p.k, p.CI, p.CO, FLIP);
  // + 1024: the kernel aligns K to 1024 bytes
  const int fixed = 1024 + p.k_bytes + 128 + p.out_bytes;
  p.nbuf = fixed + 2 * p.halo_bytes <= kSmemLimit ? 2 : 1;
  const int smem = fixed + p.nbuf * p.halo_bytes;
  const int threads = kWarpgroup * warpgroups;
  const void* fn = reinterpret_cast<const void*>(conv3x3_wgmma_kernel<BN, FLIP>);
  int sms = 0, per_sm = 0;
  cudaError_t err = sm90::occupancy(fn, threads, smem, kSmemLimit, sms,
                                    per_sm);
  if (err != cudaSuccess) return err;
  const long long units = (long long)p.mtiles * p.ntiles;
  if (units * p.nslices > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long most = (long long)sms * per_sm;
  const int grid = (int)(units < most ? units : most);
  conv3x3_wgmma_kernel<BN, FLIP><<<grid, threads, smem, stream>>>(p, kmap);
  return cudaGetLastError();
}

}  // namespace

cudaError_t conv3x3_bf16(const bf16* x, const bf16* k, bf16* y, int B, int H,
                         int W, int CI, int CO, int flip,
                         cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || CI <= 0 || CO <= 0)
    return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = sm90::sm_count(sms);
  if (err != cudaSuccess) return err;
  Params p{};
  p.x = x;
  p.k = k;
  p.y = y;
  p.P = (long long)B * H * W;
  p.H = H;
  p.W = W;
  p.CI = CI;
  p.CO = CO;
  p.vec = CI % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.kvec = (flip ? CI : CO) % 8 == 0 &&
           reinterpret_cast<uintptr_t>(k) % 16 == 0;
  p.yvec = CO % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  // the most warpgroups a block whose tiles still give every SM one; at
  // small batch 32-wide Cout tiles double the blocks
  const int ntiles64 = (CO + 63) / 64;
  int warpgroups = kMaxWarpgroups;
  while (warpgroups > 1 &&
         (p.P + kTileRows * warpgroups - 1) / (kTileRows * warpgroups) *
                 ntiles64 < sms)
    --warpgroups;
  const bool narrow = CO <= 32 ||
                      (warpgroups == 1 &&
                       (p.P + kTileRows - 1) / kTileRows * ntiles64 < sms);
  if (narrow)
    return flip ? launch<32, 1>(p, warpgroups, stream)
                : launch<32, 0>(p, warpgroups, stream);
  return flip ? launch<64, 1>(p, warpgroups, stream)
              : launch<64, 0>(p, warpgroups, stream);
}

}  // namespace tc

extern "C" {

// flip = 0: y = conv(x, K) with K (3, 3, Cin, Cout).  flip = 1: y =
// conv(x, K flipped in both spatial axes, channels transposed) with K
// (3, 3, Cout, Cin): the dx of a conv with K, from its cotangent x.

// The float32 workspace cfgan_conv3x3_f32 takes at these channel counts,
// in floats (K's 3xTF32 parts in the kernel's layout); 0: too large
int cfgan_conv3x3_f32_workspace(int Cin, int Cout) {
  return f32::workspace_floats(Cin, Cout);
}

int cfgan_conv3x3_f32(const void* x, const void* k, void* y, void* ws,
                      int B, int H, int W, int Cin, int Cout, int flip,
                      int ws_floats, void* stream) {
  return (int)f32::conv3x3_f32(static_cast<const float*>(x),
                               static_cast<const float*>(k),
                               static_cast<float*>(ws), static_cast<float*>(y),
                               B, H, W, Cin, Cout, flip, ws_floats,
                               static_cast<cudaStream_t>(stream));
}

int cfgan_conv3x3_bf16(const void* x, const void* k, void* y, int B, int H,
                       int W, int Cin, int Cout, int flip, void* stream) {
  return (int)tc::conv3x3_bf16(static_cast<const __nv_bfloat16*>(x),
                               static_cast<const __nv_bfloat16*>(k),
                               static_cast<__nv_bfloat16*>(y), B, H, W, Cin,
                               Cout, flip, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
