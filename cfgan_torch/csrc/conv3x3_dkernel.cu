// Weight gradient of the SAME-padded, stride-1 3x3 NHWC convolution, bf16 or
// float32 in, float32 out, on Hopper's tensor cores:
//
//   dK[dy,dx,c,o] = sum_{n,h,w} x[n,h+dy-1,w+dx-1,c] * g[n,h,w,o]
//
// with zeros outside the image, accumulated in float32.  It is the dK of
// make_conv3x3_same_pallas's VJP (cfgan/ops/conv.py:165-177: nine tap
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
// 989 TFLOP/s.  float32 (3xTF32): 51.5 MB
// -> 0.0154 ms; three tf32 products, 3 x 7.40 GFLOP at 494.7 TFLOP/s ->
// 0.0449 ms (operations).
//
// bf16 (conv3x3_dkernel_wgmma_kernel).
// Design.  The product is M = Cin (64 a block), N = Cout (a 64- or 32-wide
// tile) over a depth of B*H*W pixels, for nine taps.
// - The taps are read where x lies.  A block walks over stages of up to 128
//   pixels; each stage's input halo (the pixels p - W - 1 ... p + 128 + W,
//   or three windows of 130 where W > 130) and cotangent tile are staged in
//   shared memory.  A = x_tap^T (rows c, depth pixels) is loaded from the
//   halo with ldmatrix.trans, whose row addresses are free: a tap is a shift
//   of the row address, and a pixel outside the image points at 16 zero
//   bytes.  B = the cotangent tile (pixels x o), which wgmma reads from
//   shared memory, N-major.
// - Three warpgroups, one per dy, each holds the f32 accumulators of its
//   three taps (3 x 64 x 64 over 128 threads: 96 registers a thread).
// - Loads (the TMA path: the rows are 16-byte multiples, the halo one
//   window, the tile 64 wide): a ring of up to kRing = 4 stages, each slot
//   with a full and an empty mbarrier.  Thread 0 issues a stage's TMA boxes
//   (64 pixels, the 128-byte swizzle; only the boxes the stage's pixels
//   reach) once every warp has released the slot; a warp releases it by
//   one arrival once its wgmma have read it.  Up to three stages are in
//   flight while one is multiplied, and no __syncthreads fences a stage.
//   Other shapes take cp.async into two buffers (stage()), fenced by
//   __syncthreads.
// - Filling the card: the pixels are split into equal ranges of 16-pixel
//   steps, one range a block; a stage past a range's end runs only the
//   steps it holds.
// - Split-K partials, reduced in thread block clusters: the ranges' blocks
//   are launched in clusters of 2, 4 or 8 along the pixel axis
//   (cudaLaunchKernelEx), as many as cudaOccupancyMaxActiveClusters says
//   the card holds at once, the size and the range chosen by a cost model
//   (cluster_fill).  After its pixel loop a block stages its 9 x 64 x BN
//   float32 tile in its own shared memory (the ring is free by then);
//   after a cluster barrier each block sums 1/cluster of the tile's entries
//   over the cluster's blocks, in rank order, through distributed shared
//   memory (mapa + ld.shared::cluster), and writes that share of the
//   cluster's partial with 16-byte stores.  A second kernel sums the
//   clusters' partials in a fixed order.  No atomics: two calls give the
//   same bits.
// - The halo holds 64 channels a pixel (128 bytes); chunk j of halo pixel s
//   is stored at chunk j ^ (s % 8) (TMA's 128-byte swizzle), so the 8 rows
//   of an ldmatrix fall on distinct bank groups.  Channels past Cin are
//   zeros, and so are the rows of A past the block's range, so ragged Cin,
//   Cout, W and B need no padded copy.
// - 384 threads, one block an SM, within the 168 registers a thread that
//   allows and no spills (the smoke's build line prints ptxas's counts).
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py): at
// B=128, 28x28, 64->64 the kernel and its reduction take 0.0257 ms against
// the bound's 0.0077 (30%) and cuDNN's wgrad 0.0278, in 66 clusters of 2:
// 66 partials, 9.7 MB.  What holds it back (PERF.md): a block's loop of
// 16-pixel steps takes ~470 cycles a step where the tensor cores need
// 288, bound by issue and latency, not by its loads (a loop that loads
// nothing after its first stages runs as fast); and every block sends its
// 147 KB float32 partial off its SM, through the cluster and to device
// memory, at ~17 bytes a cycle whatever the cluster size (~4.9 us of the
// ~23 us kernel).
//
// float32, 3xTF32 products as the conv's float32 kernels (conv3x3.cu) make
// them.  Two bodies, chosen by the plan from the shape (dkernel_plan's
// `tma`), never on a failure:
// - the TMA body (f32::conv3x3_dkernel_tf32_ws_kernel; Cin and Cout
//   multiples of 4, W + 2 <= 128, x and g 16-byte aligned at the launch):
//   warp-specialised, x's halo and g's tile by TMA, g split once a stage,
//   partials summed within clusters; its design is told at the kernel.
//   Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (tools/dkernel_ab.py):
//   at B=128, 28x28, 64->64 the kernel and its reduction take ~0.090 ms
//   against the bound's 0.0449 (~50%), the cp.async body's 0.179 and
//   cuDNN's wgrad (TF32 off) 0.338; B=1 0.0094 against cuDNN's 0.0157.
// - the cp.async body (f32::conv3x3_dkernel_tf32_kernel; the other shapes,
//   and a misaligned x or g on the TMA plan's workspace): three
//   warpgroups, one per dy; a pixel range of whole stages per block,
//   double-buffered by cp.async; each block writes its own partial, which
//   the same reduction kernel sums in a fixed order, so two calls give the
//   same bits; 32-wide Cout tiles; how its operands reach wgmma is told at
//   the kernel.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kWarpgroups = 3;  // one per dy
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kWarps = kThreads / 32;
constexpr int kTP = 128;        // pixels per stage
constexpr int kStep = 16;       // pixels per k16 step; ranges are multiples
constexpr int kSteps = kTP / kStep;
constexpr int kSlice = 64;      // input channels per block: wgmma M
constexpr int kChunks = kSlice / 8;
constexpr int kSmemLimit = 232448;
constexpr int kBox = 64;                   // pixels a TMA box
constexpr int kBoxBytes = kBox * kSlice * 2;  // 64 pixels x 64 bf16
constexpr int kRing = 4;        // TMA stages (fewer where a stage is wide)
constexpr int kMaxCluster = 8;  // blocks a cluster: the portable maximum

struct Params {
  const bf16* x;
  const bf16* g;
  float* part;     // (partials, 9, Cin, Cout): one a cluster
  long long P;     // B * H * W
  long long span;  // pixels a block: a multiple of kStep
  int H, W, CI, CO;
  int vec_x, vec_g;  // rows start 16-byte aligned: stage with cp.async
  int S;             // halo offset between the dy windows: min(W, kTP + 2)
  int nslots;        // halo pixels: 2 * S + kTP + 2
  int halo_bytes, g_bytes, nbuf;
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

// The products of one stage (pixels [pa, min(pa + kTP, pb))) into acc:
// only the k16 steps that hold a pixel of the range run.  Returns with
// every wgmma of the stage done (its buffer may be released).
//
// A lane's ldmatrix row for tap dx at step s is halo pixel dy * S + kl +
// dx + 16 s, whose swizzled chunk (jc ^ (pixel % 8)) does not depend on s:
// its address is one base a tap, advanced by 2048 bytes a step.
template <int BN, bool TMA>
__device__ __forceinline__ void multiply(const Params& p,
                                         float (&acc)[3][BN / 2],
                                         uint32_t hbase, uint32_t gbase,
                                         long long pa, long long pb, int dy,
                                         int kl, int jc, uint32_t zaddr) {
  const int rem = (int)(pb - pa < kTP ? pb - pa : kTP);
  uint32_t base[3];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    const uint32_t pix = (uint32_t)(dy * p.S + kl + dx);
    base[dx] = hbase + pix * 128 + ((jc ^ (pix & 7)) << 4);
  }
  // (h, w) of this lane's pixel at step 0, advanced by 16 pixels a step
  int w = (int)((pa + kl) % p.W);
  int h = (int)(((pa + kl) / p.W) % p.H);
  const bool wide = p.W >= kStep;  // a step crosses at most one row end
  uint32_t a[2][3][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    if (kStep * s >= rem) break;
    const bool row =
        kStep * s + kl < rem && (unsigned)(h + dy - 1) < (unsigned)p.H;
    if (s >= 2) sm90::wgmma_wait<1>();  // step s-2 has read a[s & 1]
    sm90::ldmatrix_x4_trans(a[s & 1][0], row && w > 0 ? base[0] : zaddr);
    sm90::ldmatrix_x4_trans(a[s & 1][1], row ? base[1] : zaddr);
    sm90::ldmatrix_x4_trans(a[s & 1][2], row && w + 1 < p.W ? base[2] : zaddr);
    sm90::wgmma_fence();
    // TMA: rows of 128 swizzled bytes, 16 pixels a step
    const uint64_t desc = TMA ? sm90::make_desc_sw128(gbase + s * 2048)
                              : sm90::make_desc(gbase + s * BN * 32, BN * 16,
                                                128);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      sm90::Wgmma<BN, 1>::run(acc[dx], a[s & 1][dx], desc);
    sm90::wgmma_commit();
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) base[dx] += kStep * 128;
    w += kStep;
    if (wide) {
      if (w >= p.W) {
        w -= p.W;
        h = h + 1 == p.H ? 0 : h + 1;
      }
    } else {
      while (w >= p.W) {
        w -= p.W;
        if (++h == p.H) h = 0;
      }
    }
  }
  sm90::wgmma_wait<0>();
}

// floats a row of a block's staged partial: a warp's float2 stores of 8
// rows take 2 wavefronts
template <int BN>
constexpr int kTileRow = BN + 8;

// This block's share of its cluster's partial dK: entries [rank, rank + 1)
// * 1/C of the 9 x 64 x BN staged tile, each the sum over the cluster's C
// tiles in rank order, read through distributed shared memory and written
// with 16-byte stores.  A thread keeps 16 loads in flight (16 / C entries a
// round), those of its own tile plain shared-memory loads.  After its last
// round's loads it arrives on the cluster's barrier (it reads no other
// tile from there on) and stores its sums while the others finish; it
// waits on the barrier last, so that no block leaves while another still
// reads its tile.
// Threads: the block's threads that take part (threadIdx.x below it); the
// float32 kernel's producer warpgroup only arrives and waits.
template <int BN, int C, int Threads = kThreads, typename P = Params>
__device__ __forceinline__ void reduce_share(const P& p,
                                             const float* tile, int c0,
                                             int n0) {
  constexpr int kShare = 9 * 64 * (BN / 4) / C;
  constexpr int kAtOnce = 16 / C;
  constexpr int kRounds = (kShare + Threads * kAtOnce - 1) /
                          (Threads * kAtOnce);
  const uint32_t rank = sm90::cluster_rank();
  const int lo = (int)rank * kShare;
  const uint32_t tbase = sm90::smem_u32(tile);
  const size_t plane = (size_t)p.CI * p.CO;
  float* out = p.part + (size_t)(blockIdx.x / C) * 9 * plane;
  const bool vec = p.CO % 4 == 0 && n0 + BN <= p.CO;
  // entry i of the share: tap t9, channel row r, output quad o4
  auto where = [&](int i, int& t9, int& r, int& o4) {
    t9 = (lo + i) / (64 * (BN / 4));
    r = ((lo + i) / (BN / 4)) % 64;
    o4 = 4 * ((lo + i) % (BN / 4));
  };
#pragma unroll 1
  for (int round = 0; round < kRounds; ++round) {
    const int first = round * Threads * kAtOnce + (int)threadIdx.x;
    float4 v[kAtOnce][C];
    uint32_t live = 0;  // bit e: entry e lies in the share, Cin and Cout
#pragma unroll
    for (int e = 0; e < kAtOnce; ++e) {
      int t9, r, o4;
      where(first + e * Threads, t9, r, o4);
      if (first + e * Threads >= kShare || c0 + r >= p.CI ||
          n0 + o4 >= p.CO)
        continue;
      live |= 1u << e;
      const uint32_t off =
          (uint32_t)(((t9 * 64 + r) * kTileRow<BN> + o4) * 4);
#pragma unroll
      for (int q = 0; q < C; ++q)  // this block's own tile: a plain load
        v[e][q] = q == (int)rank
                      ? *reinterpret_cast<const float4*>(
                            reinterpret_cast<const char*>(tile) + off)
                      : sm90::ld_cluster_f4(sm90::cluster_map(tbase + off, q));
    }
    if (round == kRounds - 1) sm90::cluster_arrive();
#pragma unroll
    for (int e = 0; e < kAtOnce; ++e) {
      if (!(live >> e & 1)) continue;
      float4 sum = v[e][0];
#pragma unroll
      for (int q = 1; q < C; ++q) {
        sum.x += v[e][q].x;
        sum.y += v[e][q].y;
        sum.z += v[e][q].z;
        sum.w += v[e][q].w;
      }
      int t9, r, o4;
      where(first + e * Threads, t9, r, o4);
      const int o = n0 + o4;
      float* dst = out + t9 * plane + (size_t)(c0 + r) * p.CO + o;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = sum;
      } else {
        const float f[4] = {sum.x, sum.y, sum.z, sum.w};
        for (int m = 0; m < 4 && o + m < p.CO; ++m) dst[m] = f[m];
      }
    }
  }
  sm90::cluster_wait();  // every block is done reading this one's tile
}

template <int BN, bool TMA>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_dkernel_wgmma_kernel(const Params p,
                             const __grid_constant__ CUtensorMap xmap,
                             const __grid_constant__ CUtensorMap gmap) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // TMA's 128-byte swizzle wants 1024-byte aligned tiles
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* zero16 = smem;  // + the ring's mbarriers from byte 64
  unsigned char* bufs = smem + 1024;
  const int tid = threadIdx.x;
  const int dy = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  if (tid < 4) reinterpret_cast<uint32_t*>(zero16)[tid] = 0u;
  // TMA: full[i] (the stage's bytes are in) and empty[i] (every warp has
  // read it) of slot i
  const uint32_t full = sm90::smem_u32(zero16 + 64);
  const uint32_t empty = full + 8 * kRing;
  if (TMA && tid == 0) {
    sm90::prefetch_tensormap(&xmap);
    sm90::prefetch_tensormap(&gmap);
    for (int i = 0; i < p.nbuf; ++i) {
      sm90::mbar_init(full + 8 * i, 1);
      sm90::mbar_init(empty + 8 * i, kWarps);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  const int c0 = blockIdx.y * kSlice, n0 = blockIdx.z * BN;
  const long long first = (long long)blockIdx.x * p.span;
  long long pb = first + p.span;
  if (pb > p.P) pb = p.P;
  // blocks past the pixels (a cluster's padding) add zeros
  const int nst = pb > first ? (int)((pb - first + kTP - 1) / kTP) : 0;
  const int buf_bytes = p.halo_bytes + p.g_bytes;

  // this lane's ldmatrix row: pixel kl of a 16-pixel step, channel chunk jc
  const int kl = (lane & 7) + 8 * (lane >> 4);
  const int jc = 2 * warp + ((lane >> 3) & 1);
  const uint32_t zaddr = sm90::smem_u32(zero16);

  float acc[3][BN / 2];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) acc[d][r] = 0.f;

  if constexpr (TMA) {
    // stage j into slot j % nbuf: the halo's boxes of 64 pixels and g's
    // that the stage's pixels reach (thread 0)
    auto issue = [&](int j) {
      const uint32_t b = sm90::smem_u32(bufs + (j % p.nbuf) * buf_bytes);
      const long long pa = first + (long long)j * kTP;
      const int len = (int)(pb - pa < kTP ? pb - pa : kTP);
      const int hboxes = (len + 2 * p.S + 2 + kBox - 1) / kBox;
      const int gboxes = (len + kBox - 1) / kBox;
      const uint32_t bar = full + 8 * (j % p.nbuf);
      sm90::mbar_expect_tx(bar, (hboxes + gboxes) * kBoxBytes);
      for (int q = 0; q < hboxes; ++q)
        sm90::tma_load_2d(b + q * kBoxBytes, &xmap, c0,
                          (int)(pa - p.W - 1) + kBox * q, bar);
      for (int q = 0; q < gboxes; ++q)
        sm90::tma_load_2d(b + p.halo_bytes + q * kBoxBytes, &gmap, n0,
                          (int)pa + kBox * q, bar);
    };
    if (tid == 0)
      for (int j = 0; j < p.nbuf && j < nst; ++j) issue(j);
    for (int j = 0; j < nst; ++j) {
      // refill the slot of stage j - 1 once every warp has released it
      if (tid == 0 && j >= 1 && j - 1 + p.nbuf < nst) {
        const int r = j - 1;
        sm90::mbar_wait(empty + 8 * (r % p.nbuf), (r / p.nbuf) & 1);
        sm90::fence_proxy_async();  // the slot's last reads came first
        issue(r + p.nbuf);
      }
      sm90::mbar_wait(full + 8 * (j % p.nbuf), (j / p.nbuf) & 1);
      const uint32_t hbase = sm90::smem_u32(bufs + (j % p.nbuf) * buf_bytes);
      multiply<BN, true>(p, acc, hbase, hbase + p.halo_bytes,
                         first + (long long)j * kTP, pb, dy, kl, jc, zaddr);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty + 8 * (j % p.nbuf));
    }
  } else {
    auto issue = [&](int j) {
      if (j >= nst) return;
      unsigned char* b = bufs + (j % p.nbuf) * buf_bytes;
      stage<BN>(p, b, b + p.halo_bytes, first + (long long)j * kTP, pb, c0,
                n0);
    };
    if (p.nbuf == 2) {
      issue(0);
      sm90::cp_async_commit();
    }
    for (int j = 0; j < nst; ++j) {
      issue(p.nbuf == 2 ? j + 1 : j);
      sm90::cp_async_commit();
      if (p.nbuf == 2)
        sm90::cp_async_wait<1>();
      else
        sm90::cp_async_wait<0>();
      sm90::fence_proxy_async();  // g's tile, by cp.async, read by wgmma
      __syncthreads();
      const uint32_t hbase = sm90::smem_u32(bufs + (j % p.nbuf) * buf_bytes);
      multiply<BN, false>(p, acc, hbase, hbase + p.halo_bytes,
                          first + (long long)j * kTP, pb, dy, kl, jc, zaddr);
      __syncthreads();  // the buffer is free again
    }
    sm90::cp_async_wait<0>();
  }
  __syncthreads();  // every warp is done with the ring

  // this block's 9 taps x 64 x BN partial, staged in its shared memory
  float* tile = reinterpret_cast<float*>(bufs);
  {
    const int gq = lane / 4, tq = lane % 4;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = (dy * 3 + dx) * 64 + warp * 16 + gq + 8 * half;
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn)
          *reinterpret_cast<float2*>(tile + r * kTileRow<BN> + 8 * jn + 2 * tq) =
              make_float2(acc[dx][4 * jn + 2 * half],
                          acc[dx][4 * jn + 2 * half + 1]);
      }
  }
  sm90::cluster_sync();  // every block of the cluster has staged its tile

  // this block's share of the cluster's partial
  switch (sm90::cluster_size()) {
    case 8:
      reduce_share<BN, 8>(p, tile, c0, n0);
      break;
    case 4:
      reduce_share<BN, 4>(p, tile, c0, n0);
      break;
    default:
      reduce_share<BN, 2>(p, tile, c0, n0);
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


// ------------------------------------------- float32, the TMA body
constexpr int kWsN = 32;              // wgmma N: output channels a tile
constexpr int kWsBox = 32;            // channels a halo box (128 bytes)
constexpr int kWsMaxDepth = 128;      // padded positions a stage
constexpr int kWsThreads = 512;       // three consumers, one producer
constexpr int kWsConsumers = 3 * 128;
constexpr int kWsTransformers = 96;   // the producer's warps 1-3
constexpr int kWsGRing = 3;           // g slots (x's ring has two)
constexpr int kWsProducerRegs = 56, kWsConsumerRegs = 152;
constexpr int kWsChain = 6;           // tf32 products a fresh accumulator takes
constexpr int kWsTileBytes = 9 * 64 * kTileRow<kWsN> * 4;  // the partial

struct WsParams {
  const float* g;
  float* part;        // (partials, 9, Cin, Cout): one a cluster
  int H, W, CI, CO;
  int R;              // image rows a stage
  int D;              // padded positions a stage: R (W + 2) rounded to 8
  int hrows;          // 128-byte rows of a halo box's region
  int rblocks;        // stages an image: ceil(H / R)
  int stages;         // B * rblocks
  int spb;            // stages a block
  int xslot, rslot, gslot;  // bytes of a halo slot (two boxes), a slot
                            // of g's tile as it lands, a split g slot
};

__device__ __forceinline__ void lds_f2(uint32_t addr, uint32_t& a,
                                       uint32_t& b) {
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n"
               : "=r"(a), "=r"(b)
               : "r"(addr));
}
__device__ __forceinline__ float lds_f1(uint32_t addr) {
  float a;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(a) : "r"(addr));
  return a;
}
__device__ __forceinline__ void sts_u4(uint32_t addr, uint32_t a, uint32_t b,
                                       uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// The float32 TMA body.  M = 64 input channels (a slice, blockIdx.y), N =
// 32 output channels (a tile, blockIdx.z), the depth a stage's padded
// positions: R image rows of one image, W + 2 positions a row, of which
// the last two are zeros of g's tile (2/30 more products at 28x28, 2/22 at
// 20x20; the other choice, mapping pixel k to k + 2 floor(k / W) with a
// table, was not built: the padded frame lets g come by TMA as x does).
// Tap (dy, dx) of position q reads halo position q + dy (W + 2) + dx, a
// fixed shift, no mask.  Designed by probes on an H100
// (tools/dkernel_f32_probe.py builds its chain variants and ablations
// from edited copies of this file; PERF.md).
//
// - Loads.  One thread of the producer warpgroup asks TMA, once a slot is
//   free, for a stage's halo (rows h0 - 1 ... h0 + R, columns -1 ... W,
//   one 4-D box a 32 input channels, 128 bytes a position, 128-byte
//   swizzled, zeros outside the image and past Cin) and g's tile (rows h0
//   ... h0 + R - 1, columns 0 ... W + 1: zeros on the padding and past H
//   and Cout), both into a ring of two slots on one full mbarrier.  No
//   __syncthreads in the loop.
// - g split once a stage.  The producer's warps 1-3 read g's landed tile
//   and write it split (rna big, exact small) and transposed into K-major
//   tiles for wgmma's B (core matrices of 8 channels x 4 positions, LBO
//   128, SBO 256, a k8 step 1 KB), into a ring of three slots.  Read from
//   device memory instead, the transform's latency set the pace.
// - A from registers.  A tap is a shift of one position, and a K-major
//   operand can start only every 4 tf32 positions, so A = x_tap^T is
//   loaded from the halo: the thread of row g holds channels 2g and 2g + 1
//   (rows g and g + 8 of its warp's 16), and depth t of a k8 step holds
//   position perm(t) = {0, 1, 4, 5, 2, 3, 6, 7}[t] (g's tiles in the same
//   order), so that a fragment is two 8-byte loads a tap and the four
//   positions of one load fall two on each half of the banks.  Its big
//   part is the word as TMA landed it (the tensor cores read its top 19
//   bits), its small part a - trunc(a), made in registers.
// - Chains.  The tensor cores truncate as they add: a fresh accumulator a
//   stage read 10x the cp.async body's error on cancelling sums, twelve
//   products 1.6-2.4x, six 1.5x.  Each tap's k8 step is a commit group of
//   three m64n32k8 products; two steps of a tap (six products) go into a
//   fresh accumulator, which the CUDA cores add into the tap's sum.
// - Registers.  Three consumer warpgroups, one per dy, at 152 registers
//   (setmaxnreg; the producer 56): the three taps' sums, a fresh
//   accumulator each and their A fragments, so that a warpgroup keeps
//   three groups in flight.  At N = 64 the sums alone take 96 registers
//   and one fresh accumulator leaves one group in flight: 0.10-0.115 ms at
//   B=128 against ~0.090 here.  A turn of four k8 steps drains its groups
//   at its end: ptxas serializes the products where an accumulator of a
//   group in flight is read across a loop turn, and spills where a
//   branch guards a group, so an odd last step or two take turns of their
//   own.  Every lane arrives on the empty barriers; no branch on the lane
//   while products are in flight.
// - Fill and partials.  A block takes a contiguous range of stages; the
//   plan (plan_f32_tma) picks the rows a stage and the cluster by a cost
//   model, so that B=1 at 28x28 spreads over 28 blocks of one row.  Blocks
//   come in clusters of 2-8 along x; after its stages a block stages its
//   9 x 64 x 32 partial in its shared memory and the cluster sums them
//   through distributed shared memory (reduce_share), one partial a
//   cluster, which dkernel_reduce_kernel sums in a fixed order: no
//   atomics, two calls give the same bits.
__global__ void __launch_bounds__(kWsThreads, 1)
conv3x3_dkernel_tf32_ws_kernel(const WsParams p,
                               const __grid_constant__ CUtensorMap xmap,
                               const __grid_constant__ CUtensorMap gmap) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  // two halo slots, two slots of g's tile as TMA lands it, then the g
  // slots split and transposed
  unsigned char* ring = smem + 1024;
  const uint32_t bars = sm90::smem_u32(smem);
  const uint32_t xfull = bars, xempty = bars + 16, gfull = bars + 32,
                 gempty = bars + 32 + 8 * kWsGRing;
  const int tid = threadIdx.x, wg = tid / 128;
  const int c0 = blockIdx.y * 64, n0 = blockIdx.z * kWsN;
  const int nbox = p.CI - c0 > kWsBox ? 2 : 1;
  const int row = p.W + 2;
  const int boxrows = (p.R + 2) * row;
  const int first = blockIdx.x * p.spb;
  // this block's stages, worked out after each role's setmaxnreg (a value
  // live across it is spilled)
  auto stages = [&]() {
    const int n = p.stages - first;
    return n < 0 ? 0 : (n > p.spb ? p.spb : n);
  };

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(xfull + 8 * i, 1);
      sm90::mbar_init(xempty + 8 * i, kWsConsumers);
    }
    for (int i = 0; i < kWsGRing; ++i) {
      sm90::mbar_init(gfull + 8 * i, kWsTransformers);
      sm90::mbar_init(gempty + 8 * i, kWsConsumers);
    }
    sm90::fence_mbar_init();
  }
  // zeros where no box lands: the halo regions' rows past the box, a
  // second box's region where the slice has one
  for (int slot = 0; slot < 2; ++slot)
    for (int b = 0; b < 2; ++b) {
      const int from = b < nbox ? boxrows : 0;
      float4* reg = reinterpret_cast<float4*>(
          ring + slot * p.xslot + b * p.hrows * 128);
      for (int i = from * 8 + tid; i < p.hrows * 8; i += kWsThreads)
        reg[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  __syncthreads();

  const uint32_t xbase = sm90::smem_u32(ring);
  const uint32_t rbase = xbase + 2 * p.xslot;  // g as it lands
  const uint32_t gbase = rbase + 2 * p.rslot;
  const int gbox = p.R * row;  // positions g's box brings
  const int small_off = p.D * 128;  // the small tile after the big one

  if (wg == 3) {
    // ------------------------------------------------------- producer
    sm90::setmaxnreg_dec<kWsProducerRegs>();
    const int ptid = tid - kWsConsumers, nst = stages();
    if (ptid == 0) {
      sm90::prefetch_tensormap(&xmap);
      sm90::prefetch_tensormap(&gmap);
      // stage j's halo and g's tile (rows h0 ... h0 + R - 1, columns 0 ...
      // W + 1: zeros on the two padding columns and past H) into slot
      // j % 2, once the consumers are done with its last stage (the
      // transformers are done with g's tile by then)
      for (int j = 0; j < nst; ++j) {
        const int slot = j & 1, st = first + j;
        const int n = st / p.rblocks, h0 = (st - n * p.rblocks) * p.R;
        sm90::mbar_wait(xempty + 8 * slot, ((j >> 1) & 1) ^ 1);
        sm90::fence_proxy_async();  // the slot's last reads came first
        sm90::mbar_expect_tx(xfull + 8 * slot, (nbox * boxrows + gbox) * 128);
        for (int b = 0; b < nbox; ++b)
          sm90::tma_load_4d(xbase + slot * p.xslot + b * p.hrows * 128,
                            &xmap, c0 + kWsBox * b, -1, h0 - 1, n,
                            xfull + 8 * slot);
        sm90::tma_load_4d(rbase + slot * p.rslot, &gmap, n0, 0, h0, n,
                          xfull + 8 * slot);
      }
    } else if (ptid >= 32) {
      // g's tile a stage, split and transposed: item it is output channel
      // it % 32 at the four positions of depth 4 kg ... 4 kg + 3 of k8
      // step s (pq = 2 s + kg), read from the landed tile (position q's
      // 16-byte chunk c at c ^ (q % 8))
      const int t = ptid - 32;
      const int items = 8 * p.D;
      for (int j = 0; j < nst; ++j) {
        const int slot = j % kWsGRing;
        const uint32_t gs = gbase + slot * p.gslot;
        const uint32_t raw = rbase + (j & 1) * p.rslot;
        sm90::mbar_wait(xfull + 8 * (j & 1), (j >> 1) & 1);
        sm90::mbar_wait(gempty + 8 * slot, ((j / kWsGRing) & 1) ^ 1);
        for (int i = t; i < items; i += kWsTransformers) {
          const int o = i & 31, pq = i >> 5;
          const int q0 = 8 * (pq >> 1) + 2 * (pq & 1);
          uint32_t big[4], small[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = q0 + (e & 1) + 4 * (e >> 1);
            const float v =
                q < gbox ? lds_f1(raw + q * 128 + (((o >> 2) ^ (q & 7)) << 4) +
                                  (o & 3) * 4)
                         : 0.f;
            sm90::tf32_split(__float_as_uint(v), big[e], small[e]);
          }
          const uint32_t at = gs + (pq >> 1) * 1024 + (pq & 1) * 128 +
                              (o >> 3) * 256 + (o & 7) * 16;
          sts_u4(at, big[0], big[1], big[2], big[3]);
          sts_u4(at + small_off, small[0], small[1], small[2], small[3]);
        }
        sm90::fence_proxy_async();  // read by wgmma
        sm90::mbar_arrive(gfull + 8 * slot);
      }
    }
    __syncthreads();  // the consumers are done with the ring
    sm90::cluster_sync();  // every block has staged its partial
    sm90::cluster_arrive();  // reduce_share's two halves
    sm90::cluster_wait();
    return;
  }

  // --------------------------------------------------------- consumers
  sm90::setmaxnreg_inc<kWsConsumerRegs>();
  const int nst = stages();
  const int dy = wg, warp = (tid / 32) % 4, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  // this thread's A: channels 16 warp + 2 gq, + 1 of the slice, in box
  // warp / 2 at 16-byte chunk ch of a position, bytes lo of it
  const uint32_t boff = (uint32_t)((warp >> 1) * p.hrows * 128 +
                                   (gq & 1) * 8);
  const int ch = 4 * (warp & 1) + (gq >> 1);
  const int perm0 = (tq & 1) + 4 * (tq >> 1);
  const int nsteps = p.D / 8;

  // acc: the taps' sums; tmp: each tap's fresh accumulator; a, small: the
  // A fragment of each tap's k8 step in flight (big, as landed, and its
  // rest)
  float acc[3][kWsN / 2], tmp[3][kWsN / 2];
  uint32_t a[3][4], small[3][4];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int r = 0; r < kWsN / 2; ++r) acc[d][r] = 0.f;

  // tap dx's three products of k8 step s into tmp[dx] (a fresh sum where
  // keep is 0), one commit group; its A loaded and split first
  auto group = [&](auto tap, uint32_t xs, uint32_t gs, int s, int keep) {
    constexpr int dx = decltype(tap)::value;
    // positions q0 (depth t) and q0 + 2 (depth t + 4) of step s; the
    // swizzle of a position (its row % 8) is the same every step
    const int q0 = perm0 + dy * row + dx + 8 * s, q1 = q0 + 2;
    lds_f2(xs + q0 * 128 + ((ch ^ (q0 & 7)) << 4), a[dx][0], a[dx][1]);
    lds_f2(xs + q1 * 128 + ((ch ^ (q1 & 7)) << 4), a[dx][2], a[dx][3]);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      small[dx][e] =
          __float_as_uint(sm90::tf32_rest(__uint_as_float(a[dx][e])));
    sm90::wgmma_fence();
    const uint32_t b = gs + s * (8 * kWsN * 4);
    sm90::wgmma_3xtf32_n32(tmp[dx], a[dx], small[dx],
                           sm90::make_desc(b, 128, 256),
                           sm90::make_desc(b + small_off, 128, 256), keep);
    sm90::wgmma_commit();
  };
  auto add_tap = [&](auto tap) {  // tap dx's chain is done: into its sum
    constexpr int dx = decltype(tap)::value;
#pragma unroll
    for (int r = 0; r < kWsN / 2; ++r) acc[dx][r] += tmp[dx][r];
  };
  using T0 = std::integral_constant<int, 0>;
  using T1 = std::integral_constant<int, 1>;
  using T2 = std::integral_constant<int, 2>;
  auto add = [&]() {  // every group is done: the chains into the sums
    add_tap(T0{});
    add_tap(T1{});
    add_tap(T2{});
  };

#pragma unroll 1
  for (int j = 0; j < nst; ++j) {
    const int slot = j & 1, gslot = j % kWsGRing;
    sm90::mbar_wait(xfull + 8 * slot, (j >> 1) & 1);
    sm90::mbar_wait(gfull + 8 * gslot, (j / kWsGRing) & 1);
    const uint32_t xs = xbase + slot * p.xslot + boff;
    const uint32_t gs = gbase + gslot * p.gslot;
    // a turn: four k8 steps, each tap's two chains of six products (two
    // commit groups each) in a fresh accumulator, at most three groups in
    // flight; a chain goes into the tap's sum once its groups are done,
    // and the turn drains at its end, so that no group is in flight across
    // the loop, and no branch guards a group (ptxas serializes or spills
    // otherwise).  Two steps left take a turn of two, one a chain of three
    // products.
    int s = 0;
#pragma unroll 1
    for (; s + 4 <= nsteps; s += 4) {
      group(T0{}, xs, gs, s, 0);
      group(T1{}, xs, gs, s, 0);
      group(T2{}, xs, gs, s, 0);
      sm90::wgmma_wait<2>();  // the step before's group of this tap is done
      group(T0{}, xs, gs, s + 1, 1);
      sm90::wgmma_wait<2>();
      group(T1{}, xs, gs, s + 1, 1);
      sm90::wgmma_wait<2>();
      group(T2{}, xs, gs, s + 1, 1);
      sm90::wgmma_wait<2>();  // tap 0's chain is done
      add_tap(T0{});
      group(T0{}, xs, gs, s + 2, 0);
      sm90::wgmma_wait<2>();
      add_tap(T1{});
      group(T1{}, xs, gs, s + 2, 0);
      sm90::wgmma_wait<2>();
      add_tap(T2{});
      group(T2{}, xs, gs, s + 2, 0);
      sm90::wgmma_wait<2>();
      group(T0{}, xs, gs, s + 3, 1);
      sm90::wgmma_wait<2>();
      group(T1{}, xs, gs, s + 3, 1);
      sm90::wgmma_wait<2>();
      group(T2{}, xs, gs, s + 3, 1);
      sm90::wgmma_wait<0>();
      add();
    }
    if (s + 2 <= nsteps) {
      group(T0{}, xs, gs, s, 0);
      group(T1{}, xs, gs, s, 0);
      group(T2{}, xs, gs, s, 0);
      sm90::wgmma_wait<2>();
      group(T0{}, xs, gs, s + 1, 1);
      sm90::wgmma_wait<2>();
      group(T1{}, xs, gs, s + 1, 1);
      sm90::wgmma_wait<2>();
      group(T2{}, xs, gs, s + 1, 1);
      sm90::wgmma_wait<0>();
      add();
    }
    if (nsteps & 1) {  // an odd last step: a chain of three products a tap
      group(T0{}, xs, gs, nsteps - 1, 0);
      group(T1{}, xs, gs, nsteps - 1, 0);
      group(T2{}, xs, gs, nsteps - 1, 0);
      sm90::wgmma_wait<0>();
      add();
    }
    // the stage's slots are read (every lane arrives)
    sm90::mbar_arrive(xempty + 8 * slot);
    sm90::mbar_arrive(gempty + 8 * gslot);
  }
  __syncthreads();  // every warpgroup is done with the ring

  // this block's 9 taps x 64 x 64 partial, a channel a row
  float* tile = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = (dy * 3 + dx) * 64 + warp * 16 + 2 * gq + half;
#pragma unroll
      for (int jn = 0; jn < kWsN / 8; ++jn)
        *reinterpret_cast<float2*>(tile + r * kTileRow<kWsN> + 8 * jn +
                                   2 * tq) =
            make_float2(acc[dx][4 * jn + 2 * half],
                        acc[dx][4 * jn + 2 * half + 1]);
    }
  sm90::cluster_sync();  // every block of the cluster has staged its tile
  switch (sm90::cluster_size()) {
    case 8:
      reduce_share<kWsN, 8, kWsConsumers>(p, tile, c0, n0);
      break;
    case 4:
      reduce_share<kWsN, 4, kWsConsumers>(p, tile, c0, n0);
      break;
    default:
      reduce_share<kWsN, 2, kWsConsumers>(p, tile, c0, n0);
  }
}

}  // namespace f32

// dK = the sum of the partials (one a cluster in bf16, one a block in
// float32) in a fixed order: a block takes 32 entries (16 bytes each where
// the entry count allows); warp k sums partials k, k + 8, k + 16, ... of
// them, then the eight warps' sums are added in warp order
constexpr int kReduceGroups = 8;
__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
template <int V>
__global__ void __launch_bounds__(32 * kReduceGroups)
dkernel_reduce_kernel(const float* __restrict__ part, float* __restrict__ dk,
                      int slabs, long long n) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  __shared__ Vec sums[kReduceGroups][32];
  const long long m = n / V;
  const Vec* src = reinterpret_cast<const Vec*>(part);
  const int e = threadIdx.x % 32, k = threadIdx.x / 32;
  const long long i = blockIdx.x * 32LL + e;
  Vec s{};
  if (i < m) {
#pragma unroll 4
    for (int b = k; b < slabs; b += kReduceGroups) add_to(s, src[b * m + i]);
  }
  sums[k][e] = s;
  __syncthreads();
  if (k != 0 || i >= m) return;
  Vec t = sums[0][e];
  for (int g = 1; g < kReduceGroups; ++g) add_to(t, sums[g][e]);
  reinterpret_cast<Vec*>(dk)[i] = t;
}

struct Plan {
  Params p;         // bf16
  f32::Params q;    // float32, the cp.async body
  f32::WsParams w;  // float32, the TMA body
  int f32, bn, smem, slices, tiles;
  int blocks;     // along the pixels (the grid's x)
  int cluster;    // blocks a cluster (1 in the float32 cp.async body)
  int partials;   // partial dKs: one a cluster (one a block in the
                  // float32 cp.async body)
  int tma;        // the shape takes the TMA body (bf16: the TMA ring)
};

// float32, the cp.async body: one wave; the pixel ranges of every (slice,
// tile) pair fill the SMs, in whole stages, in at most `most` blocks along
// the pixels (0: no cap)
cudaError_t fill(Plan& pl, const void* fn, int threads, long long P,
                 int& stages, long long most) {
  int sms = 0, per_sm = 0;
  cudaError_t err = sm90::occupancy(fn, threads, pl.smem, kSmemLimit, sms,
                                    per_sm);
  if (err != cudaSuccess) return err;
  const long long total = (P + kTP - 1) / kTP;
  long long want =
      (long long)sms * per_sm / ((long long)pl.slices * pl.tiles);
  if (want < 1) want = 1;
  if (most > 0 && want > most) want = most;
  stages = (int)((total + want - 1) / want);
  pl.blocks = (int)((total + stages - 1) / stages);
  pl.cluster = 1;
  pl.partials = pl.blocks;
  return cudaSuccess;
}

// bf16: the plan that costs least.  For each cluster size (8, 4, 2), the
// clusters the card holds at once bound the blocks of one wave and so the
// shortest range (in 16-pixel steps) a block can take; longer ranges, in
// fewer blocks, are tried too.  The cost is counted in steps of a block's
// range (a step, 16 pixels x 9 taps x 64 x 64 products, takes about
// 0.27 us on an H100):
//
//   span + blocks / 8 + partials / 32 + (cluster - 1) / 8
//
// every block sends its 9 x 64 x BN float32 partial out of its SM, through
// the cluster and to device memory, on links the blocks share (~0.03 us a
// block); the reduction reads each cluster's partial (~0.01 us); and each
// further block of a cluster adds distributed-shared-memory loads and a
// wait at the cluster's barriers (~0.03 us) -- constants fitted to the dK's
// times on an H100 over cluster sizes 2-8 and batches 1-256 (PERF.md).
// No cluster of one block: each block would write a whole partial to
// device memory, which measured 20-30% slower at every batch.
cudaError_t cluster_fill(Plan& pl, const void* fn) {
  Params& p = pl.p;
  const long long steps = (p.P + kStep - 1) / kStep;
  const long long pairs = (long long)pl.slices * pl.tiles;
  long long best = -1;
  for (int c = kMaxCluster; c >= 2; c /= 2) {
    int clusters = 0;
    cudaError_t err =
        sm90::max_clusters(fn, kThreads, pl.smem, kSmemLimit, c, clusters);
    if (err != cudaSuccess) return err;
    if (clusters < 1) continue;
    long long per_pair = clusters / pairs;
    if (per_pair < 1) per_pair = 1;
    const long long shortest = (steps + per_pair * c - 1) / (per_pair * c);
    long long longest = 2;  // past the optimum, about sqrt(steps / 8)
    while (longest * longest < steps / 3) ++longest;
    longest += 2;
    if (longest < shortest) longest = shortest;
    for (long long span = shortest; span <= longest && span <= steps;
         ++span) {
      const long long used = (steps + span - 1) / span;
      const long long blocks = (used + c - 1) / c * c;
      const long long cost =
          96 * span + 12 * blocks + 3 * (blocks / c) + 12 * (c - 1);
      if (best >= 0 && cost >= best) continue;
      if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
      best = cost;
      p.span = span * kStep;
      pl.blocks = (int)blocks;
      pl.cluster = c;
      pl.partials = (int)(blocks / c);
    }
  }
  return best < 0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// the ring's depth and the shared memory of the TMA or the cp.async body
void layout(Plan& pl, bool tma) {
  Params& p = pl.p;
  const int buf = p.halo_bytes + p.g_bytes;
  // the partial's staging tile
  const int tile = 9 * 64 * (pl.bn == 32 ? kTileRow<32> : kTileRow<64>) * 4;
  if (tma) {
    p.nbuf = (kSmemLimit - 2048) / buf;
    if (p.nbuf > kRing) p.nbuf = kRing;
  } else {
    p.nbuf = 2048 + 2 * buf <= kSmemLimit ? 2 : 1;
  }
  pl.smem = 2048 + (p.nbuf * buf > tile ? p.nbuf * buf : tile);
}

template <int BN, bool TMA>
const void* bf16_kernel() {
  return reinterpret_cast<const void*>(conv3x3_dkernel_wgmma_kernel<BN, TMA>);
}

template <int BN>
cudaError_t plan_for(Plan& pl) {
  Params& p = pl.p;
  p.S = p.W < kTP + 2 ? p.W : kTP + 2;
  p.nslots = 2 * p.S + kTP + 2;
  // whole TMA boxes of 64 pixels, whichever way the halo comes
  p.halo_bytes = (p.nslots + kBox - 1) / kBox * kBoxBytes;
  p.g_bytes = kTP * BN * 2;
  pl.bn = BN;
  pl.slices = (p.CI + kSlice - 1) / kSlice;
  pl.tiles = (p.CO + BN - 1) / BN;
  if (pl.slices > 65535 || pl.tiles > 65535) return cudaErrorInvalidValue;
  // TMA where the halo is one window of pixels and the tile 64 wide (and,
  // at the launch, the pointers 16-byte aligned)
  pl.tma = BN == 64 && p.CI % 8 == 0 && p.CO % 8 == 0 && p.S == p.W &&
           p.P + kTP + 2LL * p.W < 0x7fffffffLL;
  layout(pl, pl.tma);
  return cluster_fill(pl, pl.tma ? bf16_kernel<64, true>()
                                 : bf16_kernel<BN, false>());
}

// the float32 cp.async body's plan (the shapes the TMA body does not
// take; a misaligned x at the launch, in at most `most` blocks)
cudaError_t plan_f32_cp_async(Plan& pl, long long most) {
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
  pl.tma = 0;
  return fill(pl,
              reinterpret_cast<const void*>(f32::conv3x3_dkernel_tf32_kernel),
              kThreads, q.P, q.stages, most);
}

// The float32 TMA body's plan, where the shape takes it (Cin a multiple of
// 4, so that x's rows suit TMA; a stage of one row within 128 padded
// positions and the ring within shared memory): the rows a stage, the
// cluster and the blocks that cost least.  For each stage height R and
// cluster size (8, 4, 2), the clusters the card holds at once bound the
// blocks of one wave; the cost, in tenths of a k8 step of a stage (27
// products of 64 x 32), is
//
//   10 * stages_a_block * (D / 8 + 1) + partials + 3 * (cluster - 1)
//
// a stage's products and its turn-around, the reduction's read of a
// partial (147 KB), and each further block's share of the cluster's sums.
// Returns cudaSuccess with pl.tma 0 where the shape does not take it.
cudaError_t plan_f32_tma(Plan& pl, int B) {
  f32::WsParams& w = pl.w;
  pl.tma = 0;
  const int row = w.W + 2;
  if (w.CI % 4 != 0 || w.CO % 4 != 0 || row > f32::kWsMaxDepth)
    return cudaSuccess;
  const long long pairs = (long long)pl.slices * pl.tiles;
  const void* fn =
      reinterpret_cast<const void*>(f32::conv3x3_dkernel_tf32_ws_kernel);
  long long best = -1;
  for (int R = f32::kWsMaxDepth / row < w.H ? f32::kWsMaxDepth / row : w.H;
       R >= 1; --R) {
    const int D = (R * row + 7) / 8 * 8;
    const int hrows = (D + 2 * row + 2 + 7) / 8 * 8;
    const int xslot = 2 * hrows * 128, gslot = 2 * D * f32::kWsN * 4;
    const int rslot = (R * row * 128 + 1023) / 1024 * 1024;
    const int ring = 2 * xslot + 2 * rslot + f32::kWsGRing * gslot;
    const int smem = 2048 + (ring > f32::kWsTileBytes ? ring : f32::kWsTileBytes);
    if (D > f32::kWsMaxDepth || smem > kSmemLimit) continue;
    const long long rblocks = (w.H + R - 1) / R;
    const long long stages = (long long)B * rblocks;
    if (stages > 0x7fffffffLL) return cudaSuccess;
    for (int c = kMaxCluster; c >= 2; c /= 2) {
      // a block of 512 threads takes every register of its SM, so one
      // query a cluster size serves every stage height
      int clusters = 0;
      cudaError_t err = sm90::max_clusters(fn, f32::kWsThreads, kSmemLimit,
                                           kSmemLimit, c, clusters);
      if (err != cudaSuccess) return err;
      if (clusters < 1) continue;
      long long per_pair = clusters / pairs;
      if (per_pair < 1) per_pair = 1;
      const long long spb = (stages + per_pair * c - 1) / (per_pair * c);
      const long long used = (stages + spb - 1) / spb;
      const long long blocks = (used + c - 1) / c * c;
      const long long cost =
          10 * spb * (D / 8 + 1) + blocks / c + 3 * (c - 1);
      if (best >= 0 && cost >= best) continue;
      if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
      best = cost;
      pl.tma = 1;
      pl.smem = smem;
      pl.blocks = (int)blocks;
      pl.cluster = c;
      pl.partials = (int)(blocks / c);
      w.R = R;
      w.D = D;
      w.hrows = hrows;
      w.xslot = xslot;
      w.rslot = rslot;
      w.gslot = gslot;
      w.rblocks = (int)rblocks;
      w.stages = (int)stages;
      w.spb = (int)spb;
    }
  }
  return cudaSuccess;
}

cudaError_t plan_f32(Plan& pl, int B) {
  pl.bn = f32::kWsN;
  pl.slices = (pl.w.CI + kSlice - 1) / kSlice;
  pl.tiles = (pl.w.CO + f32::kWsN - 1) / f32::kWsN;
  if (pl.slices > 65535 || pl.tiles > 65535) return cudaErrorInvalidValue;
  cudaError_t err = plan_f32_tma(pl, B);
  if (err != cudaSuccess || pl.tma) return err;
  return plan_f32_cp_async(pl, 0);
}

cudaError_t make_plan(Plan& pl, int B, int H, int W, int CI, int CO,
                      int f32) {
  if (B <= 0 || H <= 0 || W <= 0 || CI <= 0 || CO <= 0)
    return cudaErrorInvalidValue;
  pl = Plan{};
  pl.f32 = f32;
  if (f32) {
    pl.q.P = (long long)B * H * W;
    pl.q.H = pl.w.H = H;
    pl.q.W = pl.w.W = W;
    pl.q.CI = pl.w.CI = CI;
    pl.q.CO = pl.w.CO = CO;
    return plan_f32(pl, B);
  }
  pl.p.P = (long long)B * H * W;
  pl.p.H = H;
  pl.p.W = W;
  pl.p.CI = CI;
  pl.p.CO = CO;
  return CO <= 32 ? plan_for<32>(pl) : plan_for<64>(pl);
}

// dK = the sum of the partials, in their order
cudaError_t reduce(const float* part, float* dk, int slabs, int CI, int CO,
                   cudaStream_t st) {
  const long long n = 9LL * CI * CO;
  const bool v4 = n % 4 == 0 && reinterpret_cast<uintptr_t>(part) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(dk) % 16 == 0;
  const long long rb = (n / (v4 ? 4 : 1) + 31) / 32;
  if (rb > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (v4)
    dkernel_reduce_kernel<4><<<(unsigned)rb, 32 * kReduceGroups, 0, st>>>(
        part, dk, slabs, n);
  else
    dkernel_reduce_kernel<1><<<(unsigned)rb, 32 * kReduceGroups, 0, st>>>(
        part, dk, slabs, n);
  return cudaGetLastError();
}

// a (P, C) bf16 matrix for TMA: boxes of 64 channels x 64 pixels, 128-byte
// swizzle, zeros outside
bool tensor_map(CUtensorMap& map, const bf16* a, long long P, int C) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)P};
  const cuuint64_t strides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)kBox}, step[2] = {1, 1};
  return encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<bf16*>(a), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool TMA>
cudaError_t launch_bf16(const Plan& pl, cudaStream_t st,
                        const CUtensorMap& xmap, const CUtensorMap& gmap) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.blocks, pl.slices, pl.tiles);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, conv3x3_dkernel_wgmma_kernel<BN, TMA>, pl.p,
                            xmap, gmap);
}

}  // namespace

extern "C" {

// The number of partial dKs a call at this shape sums (f32 = 1: float32,
// 0: bf16; one a cluster of blocks, one a block in the float32 cp.async
// body): the caller allocates partials * 9 * Cin * Cout floats of
// workspace.
// Negative: a cudaError_t.
int cfgan_conv3x3_dkernel_blocks(int B, int H, int W, int Cin, int Cout,
                                 int f32) {
  Plan pl;
  cudaError_t err = make_plan(pl, B, H, W, Cin, Cout, f32);
  return err == cudaSuccess ? pl.partials : -(int)err;
}

// The launch plan at this shape, into out[0..5]: blocks along the pixels,
// blocks a cluster, partial dKs, pixels a block, stages in the ring, and 1
// where the shape takes the TMA body (bf16: the TMA ring); float32 also
// out[6..8]: image rows a stage of the TMA body (0: the cp.async body),
// the positions a stage multiplies (padded rows; 128 pixels in the
// cp.async body) and the tf32 products a fresh accumulator takes.
// Returns a cudaError_t.
int cfgan_conv3x3_dkernel_plan(int B, int H, int W, int Cin, int Cout,
                               int f32, int* out) {
  Plan pl;
  cudaError_t err = make_plan(pl, B, H, W, Cin, Cout, f32);
  if (err != cudaSuccess) return (int)err;
  out[0] = pl.blocks;
  out[1] = pl.cluster;
  out[2] = pl.partials;
  out[5] = pl.tma;
  if (!f32) {
    out[3] = (int)pl.p.span;
    out[4] = pl.p.nbuf;
  } else if (pl.tma) {
    out[3] = pl.w.spb * pl.w.R * W;
    out[4] = 2;
    out[6] = pl.w.R;
    out[7] = pl.w.D;
    out[8] = f32::kWsChain;
  } else {
    out[3] = pl.q.stages * kTP;
    out[4] = pl.q.nbuf;
    out[6] = 0;
    out[7] = kTP;
    out[8] = 3;
  }
  return 0;
}

// dk (3, 3, Cin, Cout) float32 from x (B, H, W, Cin) and g (B, H, W, Cout)
// bf16; part holds partials * 9 * Cin * Cout floats
int cfgan_conv3x3_dkernel_bf16(const void* x, const void* g, void* part,
                               void* dk, int B, int H, int W, int Cin,
                               int Cout, int partials, void* stream) {
  Plan pl;
  cudaError_t err = make_plan(pl, B, H, W, Cin, Cout, 0);
  if (err != cudaSuccess) return (int)err;
  if (partials != pl.partials) return (int)cudaErrorInvalidValue;
  Params& p = pl.p;
  p.x = static_cast<const bf16*>(x);
  p.g = static_cast<const bf16*>(g);
  p.part = static_cast<float*>(part);
  p.vec_x = Cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.vec_g = Cout % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  CUtensorMap xmap{}, gmap{};
  const bool tma = pl.tma && p.vec_x && p.vec_g &&
                   tensor_map(xmap, p.x, p.P, Cin) &&
                   tensor_map(gmap, p.g, p.P, Cout);
  // misaligned pointers take the cp.async body on the same grid
  if (pl.tma && !tma) {
    layout(pl, false);
    int clusters = 0;  // sets the kernel's shared-memory cap, once
    err = sm90::max_clusters(bf16_kernel<64, false>(), kThreads, pl.smem,
                             kSmemLimit, pl.cluster, clusters);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tma)
    err = launch_bf16<64, true>(pl, st, xmap, gmap);
  else if (pl.bn == 32)
    err = launch_bf16<32, false>(pl, st, xmap, gmap);
  else
    err = launch_bf16<64, false>(pl, st, xmap, gmap);
  if (err != cudaSuccess) return (int)err;
  return (int)reduce(p.part, static_cast<float*>(dk), pl.partials, Cin, Cout,
                     st);
}

// the same from float32 x and g, 3xTF32
int cfgan_conv3x3_dkernel_f32(const void* x, const void* g, void* part,
                              void* dk, int B, int H, int W, int Cin,
                              int Cout, int blocks, void* stream) {
  Plan pl;
  cudaError_t err = make_plan(pl, B, H, W, Cin, Cout, 1);
  if (err != cudaSuccess) return (int)err;
  if (blocks != pl.partials) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(g) % 16 == 0;
  if (pl.tma && aligned) {
    f32::WsParams& w = pl.w;
    w.g = static_cast<const float*>(g);
    w.part = static_cast<float*>(part);
    CUtensorMap xmap{}, gmap{};
    // x's halo boxes (R + 2 rows from h0 - 1, columns -1 ... W) and g's
    // (R rows, columns 0 ... W + 1), 32 channels each
    if (!sm90::image_map(xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, B, H,
                         W, Cin, f32::kWsBox, W + 2, w.R + 2,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B) ||
        !sm90::image_map(gmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, w.g, B, H,
                         W, Cout, f32::kWsBox, W + 2, w.R,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B))
      return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(pl.blocks, pl.slices, pl.tiles);
    cfg.blockDim = dim3(f32::kWsThreads, 1, 1);
    cfg.dynamicSmemBytes = pl.smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = pl.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, f32::conv3x3_dkernel_tf32_ws_kernel, w,
                             xmap, gmap);
    if (err != cudaSuccess) return (int)err;
    return (int)reduce(w.part, static_cast<float*>(dk), pl.partials, Cin,
                       Cout, st);
  }
  // the cp.async body: the shapes the TMA body does not take, and a
  // misaligned x or g on the TMA plan's workspace (no more blocks than its
  // partials)
  if (pl.tma) {
    err = plan_f32_cp_async(pl, pl.partials);
    if (err != cudaSuccess) return (int)err;
  }
  f32::Params& q = pl.q;
  q.x = static_cast<const float*>(x);
  q.g = static_cast<const float*>(g);
  q.part = static_cast<float*>(part);
  q.vec_x = Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  q.vec_g = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const dim3 grid(pl.blocks, pl.slices, pl.tiles);
  f32::conv3x3_dkernel_tf32_kernel<<<grid, kThreads, pl.smem, st>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce(q.part, static_cast<float*>(dk), pl.blocks, Cin, Cout,
                     st);
}

}  // extern "C"
