// Weight gradient of the SAME-padded, stride-1 3x3 NHWC convolution, bf16 or
// float32 in, float32 out, on Hopper's tensor cores:
//
//   dK[dy,dx,c,o] = sum_{n,h,w} x[n,h+dy-1,w+dx-1,c] * g[n,h,w,o]
//
// with zeros outside the image, accumulated in float32.  It is the dK of
// make_conv3x3_same_pallas's VJP (cfgan/ops/conv.py:165-176: nine tap
// products with preferred_element_type=float32), which the JAX package
// computes outside its Pallas kernel; here it replaces the port's stacked-tap
// product, which copied the nine taps of x (a 9x copy) into device memory and
// ran one f32 SIMT GEMM.
//
//   x  (B, H, W, Cin)    contiguous bf16 or float32
//   g  (B, H, W, Cout)   contiguous, x's type (the conv's output cotangent)
//   dK (3, 3, Cin, Cout) float32
//
// Bound on an H100 SXM at B=128, 28x28, 64->64: bf16, 12.8 MB of x + 12.8 MB
// of g + 0.15 MB of dK -> 0.0077 ms at 3.35 TB/s; 7.40 GFLOP -> 0.0075 ms at
// 989 TFLOP/s.  float32 (3xTF32, f32::conv3x3_dkernel_tf32_kernel): 51.5 MB
// -> 0.0154 ms; three tf32 products, 3 x 7.40 GFLOP at 494.7 TFLOP/s ->
// 0.0449 ms (operations).
//
// bf16 (conv3x3_dkernel_wgmma_kernel).
// Design.  The product is M = Cin (64 a block), N = Cout (a 64- or 32-wide
// tile) over a depth of B*H*W pixels, for nine taps.
// - The taps are read where x lies.  A block walks over stages of 128
//   pixels; each stage's input halo (the pixels p - W - 1 ... p + 128 + W,
//   or three windows of 130 where W > 130) and cotangent tile are staged in
//   shared memory, double-buffered: by TMA (2-D boxes, 128-byte swizzle,
//   one mbarrier a buffer) where the rows are 16-byte multiples, the halo
//   is one window and the tile 64 wide, else by cp.async.  A = x_tap^T
//   (rows c, depth pixels) is loaded from the halo with ldmatrix.trans,
//   whose row addresses are free: a tap is a shift of the row address, and
//   a pixel outside the image points at 16 zero bytes.  B = the cotangent
//   tile (pixels x o), which wgmma reads from shared memory, N-major.
// - Three warpgroups, one per dy, each holds the f32 accumulators of its
//   three taps (3 x 64 x 64 over 128 threads: 96 registers a thread).
// - Filling the card: the pixels are split into one contiguous range per
//   block, so that the blocks of all (Cin slice, Cout tile) pairs fill the
//   SMs once.  Each block writes its f32 partial dK, staged in shared
//   memory and stored 16 bytes a thread (4-byte stores straight from the
//   accumulators were far slower); a second kernel sums the partials in
//   block order.  No atomics: two calls give the same bits.
// - The halo holds 64 channels a pixel (128 bytes); chunk j of halo pixel s
//   is stored at chunk j ^ (s % 8) (TMA's 128-byte swizzle), so the 8 rows
//   of an ldmatrix fall on distinct bank groups.  Channels past Cin are
//   zeros, and so are the rows of A past the block's range, so ragged Cin,
//   Cout, W and B need no padded copy.
// ptxas (sm_90a, CUDA 12.9): 153 registers (BN 64) and 103 (BN 32), no
// spills; 384 threads, one block an SM.
//
// float32: the same plan (three warpgroups, one per dy; a pixel range per
// block; per-block partials summed in block order by the same reduction
// kernel, so two calls give the same bits) with 3xTF32 products, as the
// conv's float32 kernel (conv3x3.cu) makes them, and 32-wide Cout tiles;
// how its operands reach wgmma is told at the kernel.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kWarpgroups = 3;  // one per dy
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kTP = 128;        // pixels per stage
constexpr int kSteps = kTP / 16;
constexpr int kSlice = 64;      // input channels per block: wgmma M
constexpr int kChunks = kSlice / 8;
constexpr int kSmemLimit = 232448;

struct Params {
  const bf16* x;
  const bf16* g;
  float* part;  // (blocks, 9, Cin, Cout) partial sums
  long long P;  // B * H * W
  int H, W, CI, CO;
  int vec_x, vec_g;  // rows start 16-byte aligned: stage with cp.async
  int S;             // halo offset between the dy windows: min(W, kTP + 2)
  int nslots;        // halo pixels: 2 * S + kTP + 2
  int stages;        // stages of kTP pixels per block
  int halo_bytes, g_bytes, nbuf;
  int tma;           // halo and cotangent tile by TMA (xmap, gmap)
};

__device__ __forceinline__ uint32_t swz(uint32_t c) { return c ^ ((c >> 3) & 7); }

// x's halo for the stage at pixel pa (channels [c0, c0 + 64)) and g's tile
// (pixels [pa, pa + kTP) below pb, channels [n0, n0 + BN)); zeros elsewhere.
// g's tile is 8 slabs of 16 pixels x BN, each in wgmma's N-major canonical
// layout: (k, n) at (k/8)*BN*16 + (n/8)*128 + (k%8)*16 + (n%8)*2, so
// LBO = BN * 16 and SBO = 128
template <int BN>
__device__ __forceinline__ void stage(const Params& p, unsigned char* hbuf,
                                      unsigned char* gbuf, long long pa,
                                      long long pb, int c0, int n0) {
  const uint32_t hbase = sm90::smem_u32(hbuf), gbase = sm90::smem_u32(gbuf);
  const int hal = p.nslots * kChunks;
  const int total = hal + kTP * (BN / 8);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const bf16* src;
    long long row;
    int c, limit, vec;
    uint32_t dst;
    unsigned char* gen;
    if (i < hal) {
      const int s = i / kChunks, j = i % kChunks;
      int dy = s / p.S;
      if (dy > 2) dy = 2;
      row = pa + (long long)(dy - 1) * p.W - 1 + (s - dy * p.S);
      c = c0 + 8 * j;
      const bool ok = row >= 0 && row < p.P;
      limit = ok ? p.CI : 0;
      src = p.x + (ok ? row : 0) * p.CI;
      vec = p.vec_x;
      dst = hbase + swz(i) * 16;
      gen = hbuf + swz(i) * 16;
    } else {
      // in shared-memory order, r = ((pp/8)*(BN/8) + ng)*8 + pp%8, so that
      // a warp's copies land on distinct banks
      const int r = i - hal, ng = (r / 8) % (BN / 8);
      const int pp = (r / BN) * 8 + r % 8;
      row = pa + pp;
      c = n0 + 8 * ng;
      const bool ok = row < pb;
      limit = ok ? p.CO : 0;
      src = p.g + (ok ? row : 0) * p.CO;
      vec = p.vec_g;
      const int off = r * 16;
      dst = gbase + off;
      gen = gbuf + off;
    }
    if (vec) {
      const bool ok = c < limit;
      sm90::cp_async16(dst, ok ? src + c : p.x, ok ? 16 : 0);
    } else {
      __align__(16) bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = c + e < limit ? src[c + e] : __float2bfloat16_rn(0.f);
      *reinterpret_cast<uint4*>(gen) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_dkernel_wgmma_kernel(const Params p,
                             const __grid_constant__ CUtensorMap xmap,
                             const __grid_constant__ CUtensorMap gmap) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // TMA's 128-byte swizzle wants 1024-byte aligned tiles
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* zero16 = smem;  // + 2 mbarriers at 64 and 72
  unsigned char* bufs = smem + 1024;
  const int tid = threadIdx.x;
  const int dy = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  if (tid < 4) reinterpret_cast<uint32_t*>(zero16)[tid] = 0u;
  const uint32_t bar = sm90::smem_u32(zero16 + 64);  // one per buffer
  if (tid == 0) {
    sm90::mbar_init(bar, 1);
    sm90::mbar_init(bar + 8, 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();

  const int c0 = blockIdx.y * kSlice, n0 = blockIdx.z * BN;
  const long long first = (long long)blockIdx.x * p.stages * kTP;
  long long pb = first + (long long)p.stages * kTP;
  if (pb > p.P) pb = p.P;
  const int nst = (int)((pb - first + kTP - 1) / kTP);
  const int buf_bytes = p.halo_bytes + p.g_bytes;
  auto issue = [&](int j) {
    if (j >= nst) return;
    unsigned char* b = bufs + (j % p.nbuf) * buf_bytes;
    const long long pa = first + (long long)j * kTP;
    if (p.tma) {  // one thread: the halo in boxes of 64 pixels, g's tile
      if (tid == 0) {
        sm90::fence_proxy_async();  // the buffer's last reads came first
        const uint32_t full = bar + 8 * (j % p.nbuf);
        const int boxes = p.halo_bytes / (64 * kSlice * 2);
        sm90::mbar_expect_tx(full, p.halo_bytes + p.g_bytes);
        for (int q = 0; q < boxes; ++q)
          sm90::tma_load_2d(sm90::smem_u32(b) + q * 64 * kSlice * 2, &xmap,
                            c0, (int)(pa - p.W - 1) + 64 * q, full);
        sm90::tma_load_2d(sm90::smem_u32(b) + p.halo_bytes, &gmap, n0,
                          (int)pa, full);
      }
    } else {
      stage<BN>(p, b, b + p.halo_bytes, pa, pb, c0, n0);
    }
  };

  // this lane's ldmatrix row: pixel kl of a 16-pixel step, channel chunk jc
  const int kl = (lane & 7) + 8 * (lane >> 4);
  const int jc = 2 * warp + ((lane >> 3) & 1);
  const uint32_t zaddr = sm90::smem_u32(zero16);

  float acc[3][BN / 2];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) acc[d][r] = 0.f;

  if (p.nbuf == 2) {
    issue(0);
    sm90::cp_async_commit();
  }
  for (int j = 0; j < nst; ++j) {
    issue(p.nbuf == 2 ? j + 1 : j);
    sm90::cp_async_commit();
    if (p.tma) {
      sm90::mbar_wait(bar + 8 * (j % p.nbuf), (j / p.nbuf) & 1);
    } else {
      if (p.nbuf == 2)
        sm90::cp_async_wait<1>();
      else
        sm90::cp_async_wait<0>();
      sm90::fence_proxy_async();  // g's tile, by cp.async, read by wgmma
    }
    __syncthreads();

    unsigned char* b = bufs + (j % p.nbuf) * buf_bytes;
    const uint32_t hbase = sm90::smem_u32(b);
    const uint32_t gbase = hbase + p.halo_bytes;
    const long long pa = first + (long long)j * kTP;
    // (h, w) of this lane's pixel at step 0, advanced by 16 pixels a step
    int w = (int)((pa + kl) % p.W);
    int h = (int)(((pa + kl) / p.W) % p.H);
    uint32_t a[2][3][4];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int kk = 16 * s + kl;
      const bool live = pa + kk < pb;
      if (s >= 2) sm90::wgmma_wait<1>();  // step s-2 has read a[s & 1]
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const bool ok = live && (unsigned)(h + dy - 1) < (unsigned)p.H &&
                        (unsigned)(w + dx - 1) < (unsigned)p.W;
        const uint32_t c = (uint32_t)(dy * p.S + kk + dx) * kChunks + jc;
        sm90::ldmatrix_x4_trans(a[s & 1][dx], ok ? hbase + swz(c) * 16 : zaddr);
      }
      sm90::wgmma_fence();
      // TMA: rows of 128 swizzled bytes, 16 pixels a step
      const uint64_t desc =
          p.tma ? sm90::make_desc_sw128(gbase + s * 2048)
                : sm90::make_desc(gbase + s * BN * 32, BN * 16, 128);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        sm90::Wgmma<BN, 1>::run(acc[dx], a[s & 1][dx], desc);
      sm90::wgmma_commit();
      w += 16;
      h = (h + w / p.W) % p.H;
      w %= p.W;
    }
    sm90::wgmma_wait<0>();
    __syncthreads();  // the buffer is free again
  }
  sm90::cp_async_wait<0>();

  // this block's partial dK, one column dx of taps at a time: each
  // warpgroup's 64 x BN tile of tap (dy, dx) through shared memory, then
  // out in 16-byte stores
  constexpr int kRow = BN + 4;  // floats a row: spreads a warp's banks
  float* tile = reinterpret_cast<float*>(bufs);
  const int gq = lane / 4, tq = lane % 4;
  const size_t plane = (size_t)p.CI * p.CO;
  const bool vec = p.CO % 4 == 0 && n0 + BN <= p.CO;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    float* mine = tile + dy * 64 * kRow;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + gq + 8 * half;
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn)
        *reinterpret_cast<float2*>(mine + r * kRow + 8 * jn + 2 * tq) =
            make_float2(acc[dx][4 * jn + 2 * half],
                        acc[dx][4 * jn + 2 * half + 1]);
    }
    __syncthreads();
    for (int i = tid; i < 3 * 64 * (BN / 4); i += kThreads) {
      const int t3 = i / (64 * (BN / 4)), r = (i / (BN / 4)) % 64;
      const int o4 = 4 * (i % (BN / 4));
      const int c = c0 + r, o = n0 + o4;
      if (c >= p.CI || o >= p.CO) continue;
      const float* src = tile + (t3 * 64 + r) * kRow + o4;
      float* out = p.part + ((size_t)blockIdx.x * 9 + t3 * 3 + dx) * plane +
                   (size_t)c * p.CO + o;
      if (vec) {
        *reinterpret_cast<float4*>(out) =
            *reinterpret_cast<const float4*>(src);
      } else {
        for (int m = 0; m < 4 && o + m < p.CO; ++m) out[m] = src[m];
      }
    }
    __syncthreads();
  }
}

// ----------------------------------------------- float32, 3xTF32
namespace f32 {

constexpr int kBN = 32;               // wgmma N: output channels a tile
constexpr int kChunks = kSlice / 4;   // 16-byte chunks per halo pixel
constexpr int kPixelBytes = kSlice * 4;
constexpr int kK8 = kTP / 8;          // k8 steps per stage
constexpr int kGBytes = kTP * kBN * 4;  // the cotangent tile, one copy

struct Params {
  const float* x;
  const float* g;
  float* part;  // (blocks, 9, Cin, Cout) partial sums
  long long P;  // B * H * W
  int H, W, CI, CO;
  int vec_x, vec_g;  // rows start 16-byte aligned: stage with cp.async
  int S;             // halo offset between the dy windows: min(W, kTP + 2)
  int nslots;        // halo pixels: 2 * S + kTP + 2
  int stages;        // stages of kTP pixels per block
  int halo_bytes, nbuf;
};

// byte offset of channel c of halo pixel s: 16-byte chunk c / 4 stored at
// chunk (c / 4) ^ ((s % 4) * 2), so that the 4 pixels x 2 chunks a warp
// reads for one A fragment fall on 8 distinct bank groups
__device__ __forceinline__ uint32_t hoff(int s, int c) {
  return (uint32_t)(s * kChunks + ((c >> 2) ^ ((s & 3) << 1))) * 16 +
         (c & 3) * 4;
}

// x's halo for the stage at pixel pa (channels [c0, c0 + 64)) and g's tile
// as it lies (pixels [pa, pa + kTP) below pb, channels [n0, n0 + 32), a
// pixel's 128 bytes a row); zeros elsewhere
__device__ __forceinline__ void stage(const Params& p, unsigned char* hbuf,
                                      unsigned char* graw, long long pa,
                                      long long pb, int c0, int n0) {
  const int hal = p.nslots * kChunks;
  const int total = hal + kTP * (kBN / 4);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    if (i < hal) {
      const int s = i / kChunks, j = i % kChunks;
      int dy = s / p.S;
      if (dy > 2) dy = 2;
      const long long row = pa + (long long)(dy - 1) * p.W - 1 + (s - dy * p.S);
      const int c = c0 + 4 * j;
      const bool ok = row >= 0 && row < p.P && c < p.CI;
      sm90::copy16_f32(hbuf + hoff(s, 4 * j),
                       p.x + (ok ? row * p.CI + c : 0), ok ? p.CI - c : 0,
                       p.vec_x);
    } else {
      const int r = i - hal, pp = r / (kBN / 4), j = r % (kBN / 4);
      const long long row = pa + pp;
      const int c = n0 + 4 * j;
      const bool ok = row < pb && c < p.CO;
      sm90::copy16_f32(graw + r * 16, p.g + (ok ? row * p.CO + c : 0),
                       ok ? p.CO - c : 0, p.vec_g);
    }
  }
}

// dK from float32 x and cotangent, 3xTF32 on the tensor cores.  The depth
// of these products is the pixel axis, and both x and g lie pixel-major
// (channels contiguous): MN-major for both operands, which tf32 wgmma
// does not take (no transpose for 32-bit types, and ldmatrix.trans moves
// 16-bit elements).  So A = x_tap^T (rows c, depth pixels) comes from
// registers, each element by its own ld.shared from the halo (a tap is a
// shift of the pixel index), split into its tf32 parts there; and B = the
// cotangent tile is staged once a stage as it lies, then split and
// transposed by the block into a K-major tile per part (8 output channels
// x 4 pixels a core matrix: LBO = 128, SBO = kTP * 32), which wgmma reads
// from shared memory.  Three warpgroups, one per dy, each with the
// accumulators of its three taps (3 x 64 x 32 over 128 threads: 48
// registers a thread).  The tensor cores sum each group of three products
// (one tap, 8 pixels) into fresh registers, which the CUDA cores add into
// the accumulators: the tensor cores' truncation touches 3 products, not
// the thousands of a block's range.
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_dkernel_tf32_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* gt = smem;                  // big, then small: 2 x kGBytes
  unsigned char* bufs = smem + 2 * kGBytes;  // nbuf x (halo, raw g tile)
  const int tid = threadIdx.x;
  const int dy = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int c0 = blockIdx.y * kSlice, n0 = blockIdx.z * kBN;
  const long long first = (long long)blockIdx.x * p.stages * kTP;
  long long pb = first + (long long)p.stages * kTP;
  if (pb > p.P) pb = p.P;
  const int nst = (int)((pb - first + kTP - 1) / kTP);
  const int buf_bytes = p.halo_bytes + kGBytes;
  auto issue = [&](int j) {
    if (j < nst) {
      unsigned char* b = bufs + (j % p.nbuf) * buf_bytes;
      stage(p, b, b + p.halo_bytes, first + (long long)j * kTP, pb, c0, n0);
    }
    sm90::cp_async_commit();
  };

  // this thread's rows of A (channels cl, cl + 8 of the slice) and depth
  // columns (pixels t and t + 4 of each k8 step)
  const int gq = lane / 4, tq = lane % 4;
  const int cl = warp * 16 + gq;
  const uint32_t gbig = sm90::smem_u32(gt), gsmall = gbig + kGBytes;

  float acc[3][kBN / 2];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int r = 0; r < kBN / 2; ++r) acc[d][r] = 0.f;

  if (p.nbuf == 2) issue(0);
  for (int j = 0; j < nst; ++j) {
    if (p.nbuf == 1) {
      __syncthreads();  // every warp is done with the buffer's last stage
      issue(j);
    }
    sm90::cp_async_wait<0>();
    __syncthreads();  // stage j is in; the last stage's products are done
    unsigned char* b = bufs + (j % p.nbuf) * buf_bytes;
    {
      // the cotangent tile, split and transposed: (pixel k, channel n) at
      // (n / 8) * kTP * 32 + (k / 4) * 128 + (n % 8) * 16 + (k % 4) * 4
      const float4* raw = reinterpret_cast<const float4*>(b + p.halo_bytes);
      for (int i = tid; i < kTP * kBN / 4; i += kThreads) {
        const int k = i / (kBN / 4), n = 4 * (i % (kBN / 4));
        const float4 v = raw[i];
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int nn = n + m;
          const uint32_t off = (nn / 8) * kTP * 32 + (k / 4) * 128 +
                               (nn % 8) * 16 + (k % 4) * 4;
          uint32_t big, small;
          sm90::tf32_split(__float_as_uint(e[m]), big, small);
          *reinterpret_cast<uint32_t*>(gt + off) = big;
          *reinterpret_cast<uint32_t*>(gt + kGBytes + off) = small;
        }
      }
    }
    sm90::fence_proxy_async();  // the split tile, read by wgmma
    __syncthreads();
    // the next stage streams in while this one is multiplied
    if (p.nbuf == 2) issue(j + 1);

    const unsigned char* hb = b;
    const long long pa = first + (long long)j * kTP;
    // (h, w) of this thread's two depth pixels at step 0, advanced by 8
    int w0 = (int)((pa + tq) % p.W), h0 = (int)((pa + tq) / p.W % p.H);
    int w1 = (int)((pa + tq + 4) % p.W);
    int h1 = (int)((pa + tq + 4) / p.W % p.H);
    // a group is one tap dx of one k8 step: A's four values loaded and
    // split while the last group's products run (double-buffered), its
    // three products summed into a fresh tmp, which the CUDA cores add
    // into acc[dx] once the group is done
    uint32_t big[2][4], small[2][4];
    float tmp[2][kBN / 2];
    auto group = [&](int s, int dx, int b) {
      const int k0 = 8 * s + tq;
      const bool ok0 = pa + k0 < pb &&
                       (unsigned)(h0 + dy - 1) < (unsigned)p.H &&
                       (unsigned)(w0 + dx - 1) < (unsigned)p.W;
      const bool ok1 = pa + k0 + 4 < pb &&
                       (unsigned)(h1 + dy - 1) < (unsigned)p.H &&
                       (unsigned)(w1 + dx - 1) < (unsigned)p.W;
      const int s0 = dy * p.S + k0 + dx, s1 = s0 + 4;
      const float v[4] = {
          ok0 ? *reinterpret_cast<const float*>(hb + hoff(s0, cl)) : 0.f,
          ok0 ? *reinterpret_cast<const float*>(hb + hoff(s0, cl + 8)) : 0.f,
          ok1 ? *reinterpret_cast<const float*>(hb + hoff(s1, cl)) : 0.f,
          ok1 ? *reinterpret_cast<const float*>(hb + hoff(s1, cl + 8)) : 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sm90::tf32_split(__float_as_uint(v[e]), big[b][e], small[b][e]);
      sm90::wgmma_fence();
      sm90::wgmma_3xtf32_n32(
          tmp[b], big[b], small[b],
          sm90::make_desc(gbig + s * 256, 128, kTP * 32),
          sm90::make_desc(gsmall + s * 256, 128, kTP * 32), 0);
      sm90::wgmma_commit();
    };
    auto promote = [&](int dx, int b) {  // the group in b is done
#pragma unroll
      for (int r = 0; r < kBN / 2; ++r) acc[dx][r] += tmp[b][r];
    };
    auto advance = [&]() {  // the two depth pixels, 8 further
      w0 += 8;
      h0 = (h0 + w0 / p.W) % p.H;
      w0 %= p.W;
      w1 += 8;
      h1 = (h1 + w1 / p.W) % p.H;
      w1 %= p.W;
    };
    // Two k8 steps (six groups) a turn of the loop, which is not unrolled
    // further (registers), and drains the products at its end: ptxas
    // serializes wgmma where a group's registers are read across a turn
#pragma unroll 1
    for (int s = 0; s < kK8; s += 2) {
#pragma unroll
      for (int i = 0; i < 6; ++i) {  // group i: step s + i / 3, tap i % 3
        if (i >= 2) {  // the group two back is done
          sm90::wgmma_wait<1>();
          promote((i - 2) % 3, i % 2);
        }
        group(s + i / 3, i % 3, i % 2);
        if (i % 3 == 2) advance();
      }
      sm90::wgmma_wait<0>();
      promote(1, 0);
      promote(2, 1);
    }
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // the buffers are free for the partials

  // this block's partial dK, one column dx of taps at a time, through
  // shared memory, then out in 16-byte stores
  constexpr int kRow = kBN + 4;  // floats a row: spreads a warp's banks
  float* tile = reinterpret_cast<float*>(bufs);
  const size_t plane = (size_t)p.CI * p.CO;
  const bool vec = p.CO % 4 == 0 && n0 + kBN <= p.CO;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    float* mine = tile + dy * 64 * kRow;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + gq + 8 * half;
#pragma unroll
      for (int jn = 0; jn < kBN / 8; ++jn)
        *reinterpret_cast<float2*>(mine + r * kRow + 8 * jn + 2 * tq) =
            make_float2(acc[dx][4 * jn + 2 * half],
                        acc[dx][4 * jn + 2 * half + 1]);
    }
    __syncthreads();
    for (int i = tid; i < 3 * 64 * (kBN / 4); i += kThreads) {
      const int t3 = i / (64 * (kBN / 4)), r = (i / (kBN / 4)) % 64;
      const int o4 = 4 * (i % (kBN / 4));
      const int c = c0 + r, o = n0 + o4;
      if (c >= p.CI || o >= p.CO) continue;
      const float* src = tile + (t3 * 64 + r) * kRow + o4;
      float* out = p.part + ((size_t)blockIdx.x * 9 + t3 * 3 + dx) * plane +
                   (size_t)c * p.CO + o;
      if (vec) {
        *reinterpret_cast<float4*>(out) = *reinterpret_cast<const float4*>(src);
      } else {
        for (int m = 0; m < 4 && o + m < p.CO; ++m) out[m] = src[m];
      }
    }
    __syncthreads();
  }
}

}  // namespace f32

// dK = the sum of the blocks' partials, in block order
__global__ void dkernel_reduce_kernel(const float* __restrict__ part,
                                      float* __restrict__ dk, int blocks,
                                      long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += part[b * n + i];
    dk[i] = s;
  }
}

struct Plan {
  Params p;      // bf16
  f32::Params q; // float32
  int f32, bn, blocks, smem, slices, tiles;
};

// one wave: the pixel ranges of every (slice, tile) pair fill the SMs
cudaError_t fill(Plan& pl, const void* fn, int threads, long long P,
                 int& stages) {
  int sms = 0, per_sm = 0;
  cudaError_t err = sm90::occupancy(fn, threads, pl.smem, kSmemLimit, sms,
                                    per_sm);
  if (err != cudaSuccess) return err;
  const long long total = (P + kTP - 1) / kTP;
  long long want =
      (long long)sms * per_sm / ((long long)pl.slices * pl.tiles);
  if (want < 1) want = 1;
  stages = (int)((total + want - 1) / want);
  pl.blocks = (int)((total + stages - 1) / stages);
  return cudaSuccess;
}

template <int BN>
cudaError_t plan_for(Plan& pl) {
  Params& p = pl.p;
  p.S = p.W < kTP + 2 ? p.W : kTP + 2;
  p.nslots = 2 * p.S + kTP + 2;
  // whole TMA boxes of 64 pixels, whichever way the halo comes
  p.halo_bytes = (p.nslots + 63) / 64 * 64 * kSlice * 2;
  p.g_bytes = kTP * BN * 2;
  const int buf = p.halo_bytes + p.g_bytes;
  const int tile = 3 * 64 * (BN + 4) * 4;  // the partials' staging tile
  p.nbuf = 2048 + 2 * buf <= kSmemLimit ? 2 : 1;
  pl.smem = 2048 + (p.nbuf * buf > tile ? p.nbuf * buf : tile);
  pl.bn = BN;
  pl.slices = (p.CI + kSlice - 1) / kSlice;
  pl.tiles = (p.CO + BN - 1) / BN;
  if (pl.slices > 65535 || pl.tiles > 65535) return cudaErrorInvalidValue;
  return fill(pl,
              reinterpret_cast<const void*>(conv3x3_dkernel_wgmma_kernel<BN>),
              kThreads, p.P, p.stages);
}

cudaError_t plan_f32(Plan& pl) {
  f32::Params& q = pl.q;
  q.S = q.W < kTP + 2 ? q.W : kTP + 2;
  q.nslots = 2 * q.S + kTP + 2;
  q.halo_bytes = q.nslots * f32::kPixelBytes;
  const int buf = q.halo_bytes + f32::kGBytes;
  const int fixed = 2 * f32::kGBytes;  // the split, transposed tile
  q.nbuf = fixed + 2 * buf <= kSmemLimit ? 2 : 1;
  // the partials' staging tile (3 x 64 x 36 floats) fits in one buffer
  pl.smem = fixed + q.nbuf * buf;
  pl.bn = f32::kBN;
  pl.slices = (q.CI + kSlice - 1) / kSlice;
  pl.tiles = (q.CO + f32::kBN - 1) / f32::kBN;
  if (pl.slices > 65535 || pl.tiles > 65535) return cudaErrorInvalidValue;
  return fill(pl,
              reinterpret_cast<const void*>(f32::conv3x3_dkernel_tf32_kernel),
              kThreads, q.P, q.stages);
}

cudaError_t make_plan(Plan& pl, int B, int H, int W, int CI, int CO,
                      int f32) {
  if (B <= 0 || H <= 0 || W <= 0 || CI <= 0 || CO <= 0)
    return cudaErrorInvalidValue;
  pl = Plan{};
  pl.f32 = f32;
  if (f32) {
    pl.q.P = (long long)B * H * W;
    pl.q.H = H;
    pl.q.W = W;
    pl.q.CI = CI;
    pl.q.CO = CO;
    return plan_f32(pl);
  }
  pl.p.P = (long long)B * H * W;
  pl.p.H = H;
  pl.p.W = W;
  pl.p.CI = CI;
  pl.p.CO = CO;
  return CO <= 32 ? plan_for<32>(pl) : plan_for<64>(pl);
}

// dK = the sum of the partials, in block order
cudaError_t reduce(const float* part, float* dk, int blocks, int CI, int CO,
                   cudaStream_t st) {
  const long long n = 9LL * CI * CO;
  long long rb = (n + 255) / 256;
  if (rb > 4096) rb = 4096;
  dkernel_reduce_kernel<<<(unsigned)rb, 256, 0, st>>>(part, dk, blocks, n);
  return cudaGetLastError();
}

// a (P, C) bf16 matrix for TMA: boxes of 64 channels x `rows` pixels,
// 128-byte swizzle, zeros outside
bool tensor_map(CUtensorMap& map, const bf16* a, long long P, int C,
                int rows) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)P};
  const cuuint64_t strides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)rows}, step[2] = {1, 1};
  return encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<bf16*>(a), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// The number of partial-sum blocks a call at this shape uses (f32 = 1: the
// float32 kernel, 0: bf16): the caller allocates blocks * 9 * Cin * Cout
// floats of workspace.  Negative: a cudaError_t.
int cfgan_conv3x3_dkernel_blocks(int B, int H, int W, int Cin, int Cout,
                                 int f32) {
  Plan pl;
  cudaError_t err = make_plan(pl, B, H, W, Cin, Cout, f32);
  return err == cudaSuccess ? pl.blocks : -(int)err;
}

// dk (3, 3, Cin, Cout) float32 from x (B, H, W, Cin) and g (B, H, W, Cout)
// bf16; part holds blocks * 9 * Cin * Cout floats
int cfgan_conv3x3_dkernel_bf16(const void* x, const void* g, void* part,
                               void* dk, int B, int H, int W, int Cin,
                               int Cout, int blocks, void* stream) {
  Plan pl;
  cudaError_t err = make_plan(pl, B, H, W, Cin, Cout, 0);
  if (err != cudaSuccess) return (int)err;
  if (blocks != pl.blocks) return (int)cudaErrorInvalidValue;
  Params& p = pl.p;
  p.x = static_cast<const bf16*>(x);
  p.g = static_cast<const bf16*>(g);
  p.part = static_cast<float*>(part);
  p.vec_x = Cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.vec_g = Cout % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  // TMA where the halo is one window of pixels and the tile 64 wide
  CUtensorMap xmap{}, gmap{};
  p.tma = pl.bn == 64 && p.vec_x && p.vec_g && p.S == W &&
          p.P + kTP + 2LL * W < 0x7fffffffLL &&
          tensor_map(xmap, p.x, p.P, Cin, 64) &&
          tensor_map(gmap, p.g, p.P, Cout, kTP);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(pl.blocks, pl.slices, pl.tiles);
  if (pl.bn == 32)
    conv3x3_dkernel_wgmma_kernel<32><<<grid, kThreads, pl.smem, st>>>(
        p, xmap, gmap);
  else
    conv3x3_dkernel_wgmma_kernel<64><<<grid, kThreads, pl.smem, st>>>(
        p, xmap, gmap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce(p.part, static_cast<float*>(dk), pl.blocks, Cin, Cout,
                     st);
}

// the same from float32 x and g, 3xTF32
int cfgan_conv3x3_dkernel_f32(const void* x, const void* g, void* part,
                              void* dk, int B, int H, int W, int Cin,
                              int Cout, int blocks, void* stream) {
  Plan pl;
  cudaError_t err = make_plan(pl, B, H, W, Cin, Cout, 1);
  if (err != cudaSuccess) return (int)err;
  if (blocks != pl.blocks) return (int)cudaErrorInvalidValue;
  f32::Params& q = pl.q;
  q.x = static_cast<const float*>(x);
  q.g = static_cast<const float*>(g);
  q.part = static_cast<float*>(part);
  q.vec_x = Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  q.vec_g = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(pl.blocks, pl.slices, pl.tiles);
  f32::conv3x3_dkernel_tf32_kernel<<<grid, kThreads, pl.smem, st>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce(q.part, static_cast<float*>(dk), pl.blocks, Cin, Cout,
                     st);
}

}  // extern "C"
