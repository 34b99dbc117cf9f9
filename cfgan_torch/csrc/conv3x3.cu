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
// bf16, the TMA body (conv3x3_wgmma_ws_kernel; Cin and Cout multiples of
// 8, W <= 126, 16-byte aligned tensors): a warp-specialised, persistent
// implicit GEMM, turned around so that the pixels are wgmma's N.
//   - What bounds it.  A product of M = 64 pixels by N = Cout = 64, A from
//     registers (the design before, kept below as the cp.async body)
//     issues m64n64k16 wgmma, which ran at ~80 cycles where the tensor
//     cores need 32, with one, two or four warpgroups an SM alike
//     (clock64 and %globaltimer probes on an H100: a 64x64x576 unit took
//     ~1.6 us an SM at B=128 whatever the number of warpgroups), so that
//     a faster schedule around it could not pass the old kernel.  Turned
//     around, A = K's tap (64 output channels x 16 input channels) and B
//     = 128 pixel positions x 16 input channels, both read from shared
//     memory: m64n128k16, ~70 cycles a product against 64 (two consumer
//     warpgroups issuing at once, probes), so the products are near the
//     tensor cores' rate and the kernel is bound by what surrounds them.
//   - Tiles and halos.  A tile is R rows of one image (R (W + 2) <= 128:
//     4 rows at 28x28, 5 at 20x20), W + 2 positions a row, a zero column
//     each side.  Its halo, the rows h0 - 1 ... h0 + R with their zero
//     columns, is one TMA box of a 4-D view of x: TMA fills zeros past
//     the image's edges and past Cin, so a tap (dy, dx) is a shift of B's
//     start address by dy (W + 2) + dx - 1 positions, with no mask.  The
//     zero columns are computed too (2/30 at 28x28) and dropped.  Positions
//     are 128-byte rows, 128-byte swizzled by TMA; wgmma's descriptor
//     finds a shifted tile's swizzle from the address bits (base offset
//     0: setting it to the row's place in the pattern read wrong rows).
//   - Warp specialisation.  A producer warpgroup (one thread issues every
//     copy, 56 registers a thread by setmaxnreg) and two consumer
//     warpgroups (224 registers).  The producer keeps up to four halo
//     stages in flight on full/empty mbarriers; a round is two tiles, one
//     a consumer, whose 36 products each issue at once: one consumer's
//     chain alone ran at about half the tensor cores' rate (probes), two
//     at ~90%.  A consumer then waits for its products, frees its halo
//     stage and stores its tile while the other consumer's products run.
//     Tried and dropped (probes, H100): consumers taking turns on the
//     tensor cores through named barriers (41 us at B=128 against 28.7
//     without, in the m64n64 design); two accumulators a consumer, a
//     round's products issued before the last round's tile is stored
//     (slower at every batch, and it spilled).
//   - K once a cluster.  Blocks come in clusters (cudaLaunchKernelEx) of 4
//     where the card places enough of them (no block gets more tiles),
//     else of 2; each block asks TMA for its share of K's nine 64 x 64
//     taps (t % cluster == rank) with .multicast::cluster, so one L2 read
//     feeds the cluster.  A tap a mbarrier, in the order the consumers
//     take them.  Cin > 64: K's slices are reloaded every round, once
//     every consumer warp of the cluster has arrived on each block's
//     empty mbarrier.  K's first tap still takes ~2-3.5 us to come at the
//     step's batch (probes), the largest cost outside the products.
//   - The epilogue rounds the f32 sums once to bf16 and writes them
//     transposed (stmatrix .trans) into a 128-byte swizzled tile of R x W
//     pixels; one thread stores it by TMA, and waits for the store to
//     have read the tile before it is written again.  The store's box
//     starts inside y and may overhang its end: TMA writes nothing past H
//     (the last tile where R does not divide H) or past Cout (a last
//     Cout tile under 64 wide), held on an H100 at 13x11 and Cout 40, 72
//     and 96 (tests/test_torch_gpu.py::SHAPES).
//   - Balanced work.  A block owns an equal, contiguous share of the tiles
//     (no block more than ceil(tiles / blocks)); as many blocks as the
//     card holds at once (one an SM), Cout tiles along blockIdx.y.  Where
//     tiles of 128 positions would not give every SM one, but tiles of 64
//     give at least half the SMs one and no block two (B = 5-9 at 28x28),
//     a block's one tile has its nine taps split over its two consumers
//     (five and four), which add their sums through shared memory: the
//     chain of products a call waits for is halved.  Smaller problems
//     take the cp.async body, whose start-up is shorter.
//   - No atomics; each output is one block's fixed sequence of products:
//     two calls give the same bits.
//   ptxas (sm_90a): 168 registers at launch, no spill.
//
// bf16, the cp.async body (conv3x3_wgmma_kernel; the shapes and pointers the
// TMA body does not take): an implicit GEMM over M = B*H*W output pixels,
//   N = Cout, depth 9*Cin.  A block of 1-4 warpgroups owns a tile of 64
//   pixels per warpgroup and a 64- or 32-wide slice of Cout, and is
//   persistent: one block an SM walks over tiles, K loaded once per block.
//   - The taps.  A (the pixels) comes from registers: the tile's input halo
//     is staged once in shared memory (cp.async, 16 bytes a thread), and
//     each tap's A fragments are loaded from it with ldmatrix, whose 32 row
//     addresses are free: a tap is a shift of the row address, and a row
//     outside the image points at 16 zero bytes.  B (K) is read by wgmma
//     from shared memory.  The halo of a tile of TM pixels starting at p0
//     holds, for each dy, the pixels p0 + (dy-1)*W - 1 ... + TM + 1; its
//     16-byte chunk j of pixel s is stored at chunk j ^ (s % 8).
//   - K by TMA (64 x 64 tiles) where its rows are 16-byte multiples, else
//     by cp.async; three rows of taps on three mbarriers.  The next tile's
//     halo is in flight while the current one runs its products.
//   - Cin > 64 in 64-channel slices; Cout in 64-wide tiles, at small batch
//     32-wide tiles and one warpgroup per block.
//   - Epilogue: rounded once into a per-warp tile, stored 16 bytes a
//     thread.  ptxas: 128 registers, 0 spills.
//
// Both bf16 bodies, dx: the same kernel with a flag that reads K as
// K[2-dy, 2-dx, o, c], so the backward needs no flipped copy of K.
//
// float32: 3xTF32 on the tensor cores.  One tf32 product keeps about 3
// decimal digits, which the port's float32 bars (1e-4 against the plain
// version, each output pixel's row within 1e-5) do not allow.  So each
// operand is split as a = big + small and each product is big*big +
// big*small + small*big (small*small is below float32's rounding), three
// tf32 products summed in float32.  Two bodies.
//
// float32, the TMA body (f32::conv3x3_tf32_ws_kernel; Cin and Cout
// multiples of 4, W <= 126, x and y 16-byte aligned, problems that fill the
// card): warp-specialised and turned around as the bf16 TMA body is, the
// design chosen by probes on an H100 (tools/conv_f32_probe.py, which builds
// its chain, rounding, halo-stage, cluster and threshold variants, laps
// and ablations from edited copies of this file):
//   - The product.  A = K's tap (64 output channels x k8, tf32, K-major),
//     B = 128 padded pixel positions x k8, both 128-byte-swizzled rows in
//     shared memory: m64n128k8.  A tight loop of it ran at 64.0 cycles a
//     product, the tensor cores' rate, from one, two or three warpgroups
//     (rate probe); m64n32k8 with A in registers, the cp.async body's,
//     took 19.2 cycles a product from one warpgroup against 16.
//   - K.  A small kernel a call (conv3x3_tf32_ksplit_kernel) writes K's
//     big (rounded to nearest) and small parts, flipped for dx, as blocks
//     of 64 output channels x 32 input channels, K-major: a tap-slice's
//     two parts are one 16 KB TMA box.  Both parts of K at 64 -> 64 are
//     295 KB, more than a block holds, so the nine taps of each 32-channel
//     slice stream through a ring of K stages (4-6), each asked for by
//     one block of a cluster (2 or 4) and multicast into all; a slot is
//     loaded again once every consumer warp of the cluster has arrived on
//     its empty mbarrier (each lane arrives on block lane % cluster: no
//     branch while products are in flight, which made ptxas serialize
//     them).  Clusters of 1, 2 and 4 timed alike (within the 1-3% by
//     which two builds of one plan differ).
//   - Halos.  A tile is R image rows (R (W + 2) <= 128) with a zero column
//     each side; its halo at one 32-channel slice is one TMA box of a 4-D
//     view of x (TMA fills the padding and past Cin), and a tap is a shift
//     of B's start.  A producer thread of its own keeps three halo stages
//     in flight (two where they leave fewer than three K stages), apart
//     from the thread that issues K, so that a halo slot's wait never
//     holds K back.  Three halo stages leave room for six K stages at
//     28x28 (four with four halo stages), which timed 2-4% faster than
//     four halo stages and 10% faster than two at B = 128.
//   - Each halo element split once.  The big part is the float32 word as
//     TMA landed it (the tensor cores read its top 19 bits); before a
//     stage's products its consumer writes small = a - trunc(a), exact,
//     into a buffer of its own.  Rounding big to nearest instead (cvt.rna
//     in place) was 3% slower for errors 10-30% smaller, both well inside
//     the bars.
//   - Chains.  The tensor cores truncate as they add, so a chain of
//     products into one accumulator loses accuracy with its length.  A
//     tap's twelve products (four k8 steps) go into a fresh accumulator,
//     two in turn, each tap a commit group: the tap before is waited for
//     while this one runs, and the CUDA cores add it into the tile's sum.
//     At the step's shape the worst row error against the plain version
//     is 5.9e-7 (3 products a chain: 4.8e-7; 36: 1.1e-6; 108: 3.2e-6; one
//     accumulator a tile: 5.8e-6); on sums that nearly cancel
//     (tests/test_torch_gpu.py::test_f32_kernel_holds_cancelling_sums) a
//     tap keeps the error within 1.5x of the cp.async body's, where 24 or
//     36 products a chain passed twice it.
//   - Work.  Two consumer warpgroups, a tile each a round, and a producer
//     warpgroup (56 registers a thread by setmaxnreg, consumers 224); a
//     block owns an equal, contiguous share of the tiles, blockIdx.y the
//     Cout tile, and every block of a cluster walks the same rounds (a
//     consumer without a tile still releases K).
//   - The epilogue stores the sums straight from the accumulators, a
//     pixel's 8 channels of one row group a 32-byte sector, each
//     position's pixel carried from the last without a branch.  Timed
//     against it (B = 128): the same walk with a divergent loop and 64-bit
//     addresses, 11% slower; a TMA store from a swizzled shared tile, as
//     slow as that; lanes trading values by shuffles for 16-byte stores,
//     15% slower; the stores put off until the next tile's first tap is
//     issued, 13% slower (its products wait for them).
//   - Where the time goes (B = 128, 77-78 us; tools/conv_f32_probe.py's
//     laps and ablations): the products alone would take ~55 us (1,512
//     products a block at 64 cycles, 1.76 GHz).  A consumer spends the
//     rest waiting for K (~8 us), in epilogues, adding its accumulators,
//     splitting (~7 us), in a round without a tile (~6 us: seven tiles a
//     block, four rounds) and waiting for halos (~4 us); the two
//     consumers, tied by the K ring, mostly wait at the same time.
//   - No atomics; each output is one block's fixed sequence of products
//     and sums: two calls give the same bits.
//
// float32, the cp.async body (f32::conv3x3_tf32_kernel; the other shapes
// and pointers, and problems the card does not fill where it takes one
// round: B = 1 at 28x28): the bf16 cp.async body's structure, a persistent
// implicit GEMM over pixels with the halo staged once per tile and a tap a
// shift of ldmatrix's row addresses; A (the pixels) split in registers one
// k8 step at a time, each step's three products into fresh registers that
// the CUDA cores add into the tile's sum; B = K's parts from a split
// kernel (conv3x3_tf32_split_kernel) in 32-wide Cout tiles (147 KB, loaded
// once a block), one to three warpgroups a block.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <array>
#include <cstdint>
#include <mutex>
#include <utility>

#include "sm90.cuh"

// ------------------------------------------ host code of both element types
namespace {

// make(pl), remembered per device and key (the shape, and the flip where
// it changes the plan): an eager train step makes 26 calls at one shape,
// and its host time is the step's (the last 64 keys, replaced in turn).
// One cache a Plan and Make type, so a type's plans are made in one place.
template <typename Plan, typename Make>
cudaError_t remembered_plan(Plan& pl, const std::array<int, 6>& key,
                            Make make) {
  struct Entry {
    int dev;
    std::array<int, 6> key;
    Plan pl;
  };
  static std::mutex mutex;
  static Entry entries[64];
  static int n = 0, next = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(mutex);
    for (int i = 0; i < n; ++i) {
      const Entry& e = entries[i];
      if (e.dev == dev && e.key == key) {
        pl = e.pl;
        return cudaSuccess;
      }
    }
  }
  err = make(pl);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mutex);
  entries[next] = Entry{dev, key, pl};
  next = (next + 1) % 64;
  if (n < 64) ++n;
  return cudaSuccess;
}

// A TMA body's cluster and blocks along its `tiles`: as many blocks as the
// card holds at once for each of the `ntiles` Cout tiles, no more than the
// tiles, a multiple of the cluster size; a block's tiles are an equal
// split, so none has more than `most` = ceil(tiles / blocks).  Clusters
// from `largest` down to `smallest` by halves, a smaller one only where it
// gives a block fewer tiles (the card places fewer blocks in larger
// clusters).  cudaErrorInvalidConfiguration where none fits.
cudaError_t choose_cluster(const void* kernel, int threads, int smem,
                           int smem_cap, int largest, int smallest,
                           int ntiles, long long tiles, int& cluster,
                           int& gx, long long& most) {
  most = -1;
  for (int cl = largest; cl >= smallest; cl /= 2) {
    int clusters = 0;
    const cudaError_t err = sm90::max_clusters(kernel, threads, smem,
                                               smem_cap, cl, clusters);
    if (err != cudaSuccess) return err;
    if (clusters < 1) continue;
    long long per_tile = (long long)clusters / ntiles * cl;
    if (per_tile < cl) per_tile = cl;
    long long g = tiles < per_tile ? tiles : per_tile;
    g = (g + cl - 1) / cl * cl;
    const long long m = (tiles + g - 1) / g;  // tiles a block
    if (most >= 0 && m >= most) continue;
    most = m;
    cluster = cl;
    gx = (int)g;
  }
  return most < 0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

}  // namespace

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


// ------------------------------------ the TMA body: warp-specialised
constexpr int kWsSlice = 32;          // input channels a halo stage (128 B)
constexpr int kWsPositions = 128;     // wgmma N: padded positions a tile
constexpr int kWsCout = 64;           // wgmma M: output channels a tile
constexpr int kWsConsumers = 2;       // consumer warpgroups, a tile each
constexpr int kWsThreads = kWarpgroup * (kWsConsumers + 1);
constexpr int kKPart = kWsCout * kWsSlice * 4;  // one part of a tap-slice
constexpr int kKStage = 2 * kKPart;             // its big and small parts
constexpr int kMaxHaloRing = 4;       // the most halo stages
constexpr int kMaxKRing = 8;          // the most K stages
constexpr int kProducerRegs = 56, kConsumerRegs = 224;

constexpr int kHaloRing = 3;         // halo stages (2 where three leave
                                     // fewer than three K stages)
constexpr int kMaxCluster = 4;       // the largest cluster

struct WsParams {
  float* y;
  int H, W, CO;
  int R;           // image rows a tile: R (W + 2) <= 128
  int rblocks;     // tiles an image: ceil(H / R)
  int tiles;       // B * rblocks
  int nslices;     // 32-channel slices of Cin
  int halo_bytes;  // a halo stage's buffer, a multiple of 1024
  int box_bytes;   // what its TMA box brings
  int hring, kring;
  int rounds;      // rounds every block of a cluster walks
};

// the nine taps of a stage, each tap's index a compile-time constant
template <typename F, int... T>
__device__ __forceinline__ void each_tap(F& f, int st, uint32_t hb,
                                         std::integer_sequence<int, T...>) {
  (f(std::integral_constant<int, T>{}, st, hb), ...);
}

// a consumer's split of a halo stage: small = a - trunc(a) beside the
// landed word, which is the big part as it is
__device__ __forceinline__ void split_halo(const unsigned char* raw,
                                           unsigned char* small, int bytes,
                                           int ctid) {
  const float4* src = reinterpret_cast<const float4*>(raw);
  float4* dst = reinterpret_cast<float4*>(small);
  for (int i = ctid; i < bytes / 16; i += kWarpgroup) {
    const float4 v = src[i];
    dst[i] = make_float4(sm90::tf32_rest(v.x), sm90::tf32_rest(v.y),
                         sm90::tf32_rest(v.z), sm90::tf32_rest(v.w));
  }
}

// K (3, 3, CI, CO), or flipped K[8 - t][o][c] from (3, 3, CO, CI), as the
// TMA body's 3xTF32 parts: for each 64-wide Cout tile, 32-channel slice
// of CI and tap, a block of two parts (big = rna(k), small = k - big) of
// 64 rows (output channels) x 32 floats (input channels), K-major, which
// one TMA box brings, 128-byte swizzled; zeros past CI and CO
__global__ void conv3x3_tf32_ksplit_kernel(const float* __restrict__ k,
                                           float* __restrict__ ws, int CI,
                                           int CO, int nslices, int flip,
                                           long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const int e = (int)(i % kWsSlice), r = (int)(i / kWsSlice % kWsCout);
    const long long blk = i / (kWsSlice * kWsCout);
    const int t = (int)(blk % 9), s = (int)(blk / 9 % nslices);
    const int o = (int)(blk / 9 / nslices) * kWsCout + r;
    const int c = s * kWsSlice + e;
    float v = 0.f;
    if (c < CI && o < CO)
      v = flip ? k[((long long)(8 - t) * CO + o) * CI + c]
               : k[((long long)t * CI + c) * CO + o];
    uint32_t big, small;
    sm90::tf32_split(__float_as_uint(v), big, small);
    float* dst = ws + blk * 2 * kWsCout * kWsSlice + r * kWsSlice + e;
    dst[0] = __uint_as_float(big);
    dst[kWsCout * kWsSlice] = __uint_as_float(small);
  }
}

// floats of the TMA body's split K
long long ws_split_floats(int CI, int CO) {
  return (long long)((CO + kWsCout - 1) / kWsCout) *
         ((CI + kWsSlice - 1) / kWsSlice) * 9 * 2 * kWsCout * kWsSlice;
}

// The TMA body.  The product is turned around: A = K's tap (64 output
// channels x 8 input channels, tf32) and B = 128 padded pixel positions x
// 8 input channels, both K-major in shared memory (m64n128k8).  A tile is
// R image rows of one image, W + 2 positions a row (a zero column each
// side); its halo at one 32-channel slice, rows h0 - 1 ... h0 + R with
// their zero columns, is one TMA box of a 4-D view of x (zeros outside
// the image and past Cin), 128 bytes a position, 128-byte swizzled.  Tap
// (dy, dx) of output position q reads halo position q + dy (W + 2) + dx
// - 1: a shift of B's start, no mask.  The zero columns and positions
// past R (W + 2) are computed and dropped by the epilogue.
//
// Blocks of two consumer warpgroups and a producer warpgroup, launched in
// clusters along the tiles; blockIdx.y is the Cout tile.  A block owns a
// contiguous range of tiles (an equal split over gridDim.x) and walks it
// in rounds of two tiles, one a consumer; a round walks Cin's slices, and
// each slice K's nine taps, which stream through a ring of K stages (a
// tap-slice's two parts, 16 KB), each asked for by one block of the
// cluster and multicast into all of them.  Every block of a cluster walks
// the same p.rounds rounds, so that each K stage is released by every
// consumer of the cluster before it is loaded again.
//
// Shared memory: the K ring, the halo ring (two stages a round's slice),
// a buffer a consumer (its halo's small part, then its output tile), the
// mbarriers.
__global__ void __launch_bounds__(kWsThreads, 1)
conv3x3_tf32_ws_kernel(const WsParams p,
                       const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap kmap) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // TMA's swizzled tiles want 1024-byte alignment
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* kring = smem;
  unsigned char* halo = kring + p.kring * kKStage;
  unsigned char* side = halo + p.hring * p.halo_bytes;
  unsigned char* misc = side + kWsConsumers * p.halo_bytes;
  const uint32_t kfull = sm90::smem_u32(misc);   // a K stage each
  const uint32_t kempty = kfull + 8 * kMaxKRing;  // every consumer warp of
                                                  // the cluster has read it
  const uint32_t hfull = kempty + 8 * kMaxKRing;  // a halo stage each
  const uint32_t hempty = hfull + 8 * kMaxHaloRing;
  const int tid = threadIdx.x, wg = tid / kWarpgroup;
  const uint32_t csize = sm90::cluster_size();
  if (tid == 0) {
    for (int i = 0; i < p.kring; ++i) {
      sm90::mbar_init(kfull + 8 * i, 1);
      sm90::mbar_init(kempty + 8 * i, kWsConsumers * kWarpgroup);
    }
    for (int i = 0; i < p.hring; ++i) {
      sm90::mbar_init(hfull + 8 * i, 1);
      sm90::mbar_init(hempty + 8 * i, 4);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();
  // the peers' mbarriers are ready before a multicast or an arrival
  sm90::cluster_sync();

  const int nt = blockIdx.y, n0 = nt * kWsCout;
  const int lo = (int)((long long)p.tiles * blockIdx.x / gridDim.x);
  const int hi = (int)((long long)p.tiles * (blockIdx.x + 1) / gridDim.x);
  // a step: one slice of one round, for both consumers
  const int steps = p.rounds * p.nslices;

  if (wg == kWsConsumers) {
    // ------------------------------------------------------- producer
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid == kWsConsumers * kWarpgroup) {
      sm90::prefetch_tensormap(&xmap);
      sm90::prefetch_tensormap(&kmap);
      // K's stages in the consumers' order: stage ks, tap ks % 9 of slice
      // ks / 9 % nslices, once every consumer of the cluster has released
      // its slot; block ks % cluster asks for it, multicast into all
      const uint32_t rank = sm90::cluster_rank();
      const uint16_t mask = (uint16_t)((1u << csize) - 1);
      const uint32_t kbase = sm90::smem_u32(kring);
      for (int st = 0; st < steps; ++st) {
        const int s = st % p.nslices;
        for (int t = 0; t < 9; ++t) {
          const int ks = st * 9 + t, slot = ks % p.kring;
          sm90::mbar_wait(kempty + 8 * slot, ((ks / p.kring) & 1) ^ 1);
          sm90::mbar_expect_tx(kfull + 8 * slot, kKStage);
          if (ks % (int)csize == (int)rank)
            sm90::tma_load_2d_multicast(
                kbase + slot * kKStage, &kmap, 0,
                ((nt * p.nslices + s) * 9 + t) * 2 * kWsCout,
                kfull + 8 * slot, mask);
        }
      }
    } else if (tid == kWsConsumers * kWarpgroup + 32) {
      // the halos, in the consumers' order: stage 2 st + c, consumer c's
      // tile of round st / nslices at slice st % nslices (past the block's
      // tiles, an arrival alone), once its slot is free.  A thread of its
      // own, so that a halo slot's wait never holds K back: with three
      // stages, consumer 1's next halo waits for consumer 0's last one,
      // and consumer 1 runs a little behind consumer 0.
      const uint32_t hbase = sm90::smem_u32(halo);
      for (int st = 0; st < steps; ++st) {
        const int k = st / p.nslices, s = st % p.nslices;
        for (int c = 0; c < kWsConsumers; ++c) {
          const int hs = 2 * st + c, slot = hs % p.hring;
          const int tile = lo + 2 * k + c;
          sm90::mbar_wait(hempty + 8 * slot, ((hs / p.hring) & 1) ^ 1);
          const uint32_t bar = hfull + 8 * slot;
          if (tile < hi) {
            sm90::fence_proxy_async();  // the slot's last reads came first
            sm90::mbar_expect_tx(bar, p.box_bytes);
            sm90::tma_load_4d(hbase + slot * p.halo_bytes, &xmap,
                              s * kWsSlice, -1, (tile % p.rblocks) * p.R - 1,
                              tile / p.rblocks, bar);
          } else {
            sm90::mbar_arrive(bar);
          }
        }
      }
    }
    __syncwarp();
    sm90::cluster_arrive();
    sm90::cluster_wait();
  } else {
    // ------------------------------------------------------- consumers
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int c = wg, ctid = tid % kWarpgroup;
    const int warp = ctid / 32, lane = tid % 32;
    unsigned char* mine = side + c * p.halo_bytes;
    const uint32_t kbase = sm90::smem_u32(kring), hbase0 = sm90::smem_u32(halo);
    const uint32_t sbase = sm90::smem_u32(mine);
    const int row = p.W + 2;  // positions a padded row

    // K stage ks read: each lane arrives on its empty mbarrier in block
    // lane % cluster, so that every block of the cluster counts 32 arrivals
    // a consumer warp (no branch while products are in flight, which
    // would make ptxas serialize them)
    auto release_k = [&](int ks) {
      sm90::mbar_arrive_cluster(kempty + 8 * (ks % p.kring), lane % csize);
    };
    // the tile's sums straight from the accumulators: a pixel's 8
    // channels of one row group are one 32-byte sector.  This thread's
    // positions are 8 j + 2 tq + i; each one's padded row and column are
    // carried from the last without a branch (a position wraps into the
    // next row at most once in 8 where W + 2 > 8, else it is divided)
    auto epilogue = [&](const float(&acc)[64], int tile) {
      const int g = lane / 4, tq = lane % 4;
      const int h0 = (tile % p.rblocks) * p.R, img = tile / p.rblocks;
      const int o = n0 + 16 * warp + g;  // this thread's channels o, o + 8
      const bool lo_ok = o < p.CO, hi_ok = o + 8 < p.CO;
      float* base = p.y + ((long long)img * p.H + h0) * p.W * p.CO + o;
      const int rows = p.H - h0 < p.R ? p.H - h0 : p.R;  // rows inside y
      const bool wide = row > 8;
      int r = 2 * tq / row, col = 2 * tq - r * row;
#pragma unroll
      for (int j = 0; j < kWsPositions / 8; ++j) {
        if (j > 0) {
          if (wide) {
            col += 8;
            const bool wrap = col >= row;
            col -= wrap ? row : 0;
            r += wrap ? 1 : 0;
          } else {
            r = (8 * j + 2 * tq) / row;
            col = 8 * j + 2 * tq - r * row;
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const bool wrap = col + i == row;
          const int ri = r + (wrap ? 1 : 0), ci = wrap ? 0 : col + i;
          // a real pixel of the tile inside y: its offset in floats
          const bool real = ri < rows && (unsigned)(ci - 1) < (unsigned)p.W;
          const int at = (ri * p.W + ci - 1) * p.CO;
          if (real && lo_ok) base[at] = acc[4 * j + i];
          if (real && hi_ok) base[at + 8] = acc[4 * j + 2 + i];
        }
      }
    };

    float acc[64], tmp0[64], tmp1[64];
    // a k8 step's three products into d, K's parts at a, the halo's at
    // offset off of hb (big) and sbase (small); d's old value dropped
    // where keep is 0
    auto k8 = [&](float(&d)[64], uint32_t a, uint32_t hb, uint32_t off,
                  int keep) {
      sm90::wgmma_tf32_ss_n128(d, sm90::make_desc_sw128(a + kKPart),
                               sm90::make_desc_sw128(hb + off), keep);
      sm90::wgmma_tf32_ss_n128(d, sm90::make_desc_sw128(a),
                               sm90::make_desc_sw128(sbase + off), 1);
      sm90::wgmma_tf32_ss_n128(d, sm90::make_desc_sw128(a),
                               sm90::make_desc_sw128(hb + off), 1);
    };
    // the products of tap T of step st on halo stage hb, four k8 steps
    // (twelve products), into a fresh accumulator (tmp0 and tmp1 in turn)
    // that the CUDA cores add into acc once the tap is done: each tap is a
    // commit group, the tap before waited for while this one runs, and
    // each K stage released once read
    auto tap = [&](auto tap_index, int st, uint32_t hb) {
      constexpr int t = decltype(tap_index)::value;
      const int ks = st * 9 + t, kslot = ks % p.kring;
      sm90::mbar_wait(kfull + 8 * kslot, (ks / p.kring) & 1);
      // B: the tile's positions shifted by the tap (may start one
      // position before the buffer: only dropped columns read it)
      const uint32_t shift =
          (uint32_t)(((t / 3) * row + t % 3 - 1) * kWsSlice * 4);
      const uint32_t ka = kbase + kslot * kKStage;
      float(&d)[64] = t % 2 ? tmp1 : tmp0;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        k8(d, ka + kk * 32, hb, shift + kk * 32, kk > 0);
      sm90::wgmma_commit();
      if constexpr (t > 0) {
        sm90::wgmma_wait<1>();  // tap t - 1 is done
        float(&e)[64] = t % 2 ? tmp0 : tmp1;
#pragma unroll
        for (int r = 0; r < 64; ++r) acc[r] += e[r];
        release_k(ks - 1);
      }
      if constexpr (t == 8) {
        sm90::wgmma_wait<0>();
#pragma unroll
        for (int r = 0; r < 64; ++r) acc[r] += d[r];
        release_k(ks);
      }
    };

    for (int k = 0; k < p.rounds; ++k) {
      const int tile = lo + 2 * k + c;
      if (tile >= hi) {
        // a round without a tile: its stages' phases are waited for all
        // the same, so that this consumer's arrivals count
        for (int s = 0; s < p.nslices; ++s) {
          const int st = k * p.nslices + s, hs = 2 * st + c;
          sm90::mbar_wait(hfull + 8 * (hs % p.hring), (hs / p.hring) & 1);
          for (int t = 0; t < 9; ++t) {
            const int ks = st * 9 + t;
            sm90::mbar_wait(kfull + 8 * (ks % p.kring), (ks / p.kring) & 1);
            release_k(ks);
          }
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(hempty + 8 * (hs % p.hring));
        }
        continue;
      }
      for (int s = 0; s < p.nslices; ++s) {
        const int st = k * p.nslices + s, hs = 2 * st + c;
        const int hslot = hs % p.hring;
        // every warp's products of the last stage, which read `mine`, are
        // done
        sm90::named_sync(1 + c, kWarpgroup);
        sm90::mbar_wait(hfull + 8 * hslot, (hs / p.hring) & 1);
        // each halo element split once, before the stage's products
        split_halo(halo + hslot * p.halo_bytes, mine, p.box_bytes, ctid);
        sm90::fence_proxy_async();  // read by wgmma
        sm90::named_sync(1 + c, kWarpgroup);
        if (s == 0) {
#pragma unroll
          for (int r = 0; r < 64; ++r) acc[r] = 0.f;
        }
        const uint32_t hb = hbase0 + hslot * p.halo_bytes;
        each_tap(tap, st, hb, std::make_integer_sequence<int, 9>{});
        // the stage's halo (every warp's products on it are done)
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(hempty + 8 * hslot);
      }
      epilogue(acc, tile);
    }
    __syncwarp();
    sm90::cluster_arrive();  // no block leaves while a peer may arrive on
    sm90::cluster_wait();    // its mbarriers
  }
}

// the split K as rows of 32 floats, a K stage one box of 128 rows (its
// two parts)
bool ksplit_map(CUtensorMap& map, const float* ws, int CI, int CO) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {kWsSlice,
                              (cuuint64_t)(ws_split_floats(CI, CO) / kWsSlice)};
  const cuuint64_t strides[1] = {kWsSlice * 4};
  const cuuint32_t box[2] = {kWsSlice, 2 * kWsCout}, step[2] = {1, 1};
  return encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(ws), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// x's halo boxes (32 channels x W + 2 pixels x R + 2 rows: a zero column
// each side, TMA's fill past the image and past Cin) and the split K's
bool ws_maps(CUtensorMap& xmap, CUtensorMap& kmap, const float* x,
             const float* ws, int B, int H, int W, int CI, int CO, int R) {
  return sm90::image_map(xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, B, H, W,
                         CI, kWsSlice, W + 2, R + 2,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B) &&
         ksplit_map(kmap, ws, CI, CO);
}

// A call's launch plan: the body, its grid and its shared memory.
struct Plan {
  int tma;        // the shape takes the TMA body
  int cluster;    // blocks a cluster (1 for the cp.async body)
  int consumers;  // warpgroups that multiply, a block
  int units;      // tiles of pixels x Cout tiles
  int grid;       // blocks
  int ring;       // halo stages in shared memory
  int bn;         // Cout tile
  int chain;      // tf32 products summed into one fresh accumulator
  int smem;
  int gx, ntiles;  // TMA body: blocks along the tiles, Cout tiles
  WsParams q;      // TMA body
  Params p;        // cp.async body
};

// The cp.async body's plan (conv3x3_tf32_kernel): the most warpgroups a
// block (up to three, with one buffer of halo beside K) whose tiles still
// give every SM one and whose halo fits; one warpgroup has two buffers
cudaError_t plan_cp_async(Plan& pl) {
  Params& p = pl.p;
  p.ntiles = (p.CO + kBN - 1) / kBN;
  p.nslices = (p.CI + kSlice - 1) / kSlice;
  p.ngroups = p.ntiles * (kBN / 8);
  int sms = 0;
  cudaError_t err = sm90::sm_count(sms);
  if (err != cudaSuccess) return err;
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
  pl.smem = fixed + p.nbuf * p.halo_bytes;
  int per_sm = 0;
  err = sm90::occupancy(reinterpret_cast<const void*>(conv3x3_tf32_kernel),
                        kWarpgroup * warpgroups, pl.smem, kSmemLimit, sms,
                        per_sm);
  if (err != cudaSuccess) return err;
  const long long units = (long long)p.mtiles * p.ntiles;
  if (units * p.nslices > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.part = split_floats(p.CI, p.CO);
  const long long most = (long long)sms * per_sm;
  pl.tma = 0;
  pl.cluster = 1;
  pl.consumers = warpgroups;
  pl.units = (int)units;
  pl.grid = (int)(units < most ? units : most);
  pl.ring = p.nbuf;
  pl.bn = kBN;
  pl.chain = 3;
  return cudaSuccess;
}

// The TMA body's plan.  A tile is R image rows, as many as 128 padded
// positions hold (R (W + 2) <= 128), spread evenly over the image's rows.
// Shared memory holds a consumer's buffer each, three halo stages (two
// where three leave no room for three K stages) and as many K stages as
// fit, up to kMaxKRing.  Clusters of up to 4 blocks (choose_cluster).
// cudaErrorNotSupported where the buffers do not fit.
cudaError_t plan_ws(Plan& pl, int B) {
  WsParams& q = pl.q;
  const int row = q.W + 2;
  int R = kWsPositions / row;
  if (R > q.H) R = q.H;
  q.rblocks = (q.H + R - 1) / R;
  q.R = (q.H + q.rblocks - 1) / q.rblocks;
  const long long tiles = (long long)B * q.rblocks;
  q.box_bytes = (q.R + 2) * row * kWsSlice * 4;
  // the positions a tile's products read: up to 128 + 2 (W + 2)
  q.halo_bytes =
      ((kWsPositions + 2 * row + 8) * kWsSlice * 4 + 1023) / 1024 * 1024;
  // + 1024: the alignment; + 512: the mbarriers
  const int fixed = 1024 + kWsConsumers * q.halo_bytes + 512;
  q.hring = kHaloRing;
  q.kring = (kSmemLimit - fixed - q.hring * q.halo_bytes) / kKStage;
  if (q.kring < 3) {
    q.hring = 2;
    q.kring = (kSmemLimit - fixed - q.hring * q.halo_bytes) / kKStage;
  }
  if (q.kring < 2) return cudaErrorNotSupported;
  if (q.kring > kMaxKRing) q.kring = kMaxKRing;
  pl.smem = fixed + q.hring * q.halo_bytes + q.kring * kKStage;
  pl.ntiles = (q.CO + kWsCout - 1) / kWsCout;
  if (pl.ntiles > 65535 || tiles > 0x7fffffffLL ||
      (long long)pl.ntiles * q.nslices * 9 * 2 * kWsCout > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  q.tiles = (int)tiles;
  long long best = -1;
  const cudaError_t err = choose_cluster(
      reinterpret_cast<const void*>(conv3x3_tf32_ws_kernel), kWsThreads,
      pl.smem, kSmemLimit, kMaxCluster, 1, pl.ntiles, tiles, pl.cluster,
      pl.gx, best);
  if (err != cudaSuccess) return err;
  q.rounds = (int)((best + 1) / 2);
  const long long units = tiles * pl.ntiles;
  if (units > 0x7fffffffLL || (long long)pl.gx * pl.ntiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  pl.tma = 1;
  pl.consumers = kWsConsumers;
  pl.units = (int)units;
  pl.grid = pl.gx * pl.ntiles;
  pl.ring = q.hring;
  pl.bn = kWsCout;
  pl.chain = 12;  // a tap's four k8 steps of three products
  return cudaSuccess;
}

// The plan at a shape.  The TMA body takes Cin and Cout multiples of 4
// (the tensor maps' rows are then 16-byte multiples), images whose padded
// row fits a tile (W + 2 <= 128) and whose buffers fit, and problems whose
// tiles of 128 positions give every SM one or on which the cp.async body
// would take more than one round of its units; at the launch, x and y must also start
// 16-byte aligned.  Other shapes and pointers take the cp.async body.  On
// an H100 at 28x28, 64 -> 64: B = 1 takes the cp.async body (13.5 us
// against the TMA body's 16.9: one tile of 128 positions a block is a
// chain of 216 products on one consumer), B = 8 the TMA body (17.2 us
// against 23.0, where the cp.async body takes two rounds).
cudaError_t make_plan(Plan& pl, int B, int H, int W, int CI, int CO) {
  if (B <= 0 || H <= 0 || W <= 0 || CI <= 0 || CO <= 0)
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm90::sm_count(sms);
  if (err != cudaSuccess) return err;
  pl = Plan{};
  Params& p = pl.p;
  p.P = (long long)B * H * W;
  p.H = H;
  p.W = W;
  p.CI = CI;
  p.CO = CO;
  WsParams& q = pl.q;
  q.H = H;
  q.W = W;
  q.CO = CO;
  q.nslices = (CI + kWsSlice - 1) / kWsSlice;
  const int ntiles = (CO + kWsCout - 1) / kWsCout;
  const int R = kWsPositions / (W + 2) < H ? kWsPositions / (W + 2) : H;
  const long long tiles = R < 1 ? 0 : (long long)B * ((H + R - 1) / R) * ntiles;
  if (CI % 4 != 0 || CO % 4 != 0 || W + 2 > kWsPositions ||
      sm90::encode_tiled() == nullptr)
    return plan_cp_async(pl);
  if (tiles < sms) {  // the cp.async body where it takes one round
    err = plan_cp_async(pl);
    if (err != cudaSuccess || pl.units <= pl.grid) return err;
  }
  err = plan_ws(pl, B);
  if (err == cudaErrorNotSupported) return plan_cp_async(pl);
  if (err != cudaSuccess) return err;
  // the tensor maps at this shape (any 1024-byte aligned address stands
  // in for the tensors'): where one is refused, cp.async
  CUtensorMap a, b;
  const float* any = reinterpret_cast<const float*>(uintptr_t{1} << 20);
  if (ws_maps(a, b, any, any, B, H, W, CI, CO, q.R))
    return cudaSuccess;
  return plan_cp_async(pl);
}

// make_plan, remembered per device and shape
cudaError_t cached_plan(Plan& pl, int B, int H, int W, int CI, int CO) {
  return remembered_plan(pl, {B, H, W, CI, CO, 0}, [&](Plan& made) {
    return make_plan(made, B, H, W, CI, CO);
  });
}

// K's split (a small kernel a call), then the body
cudaError_t launch_ws(const Plan& pl, const float* x, const float* k,
                      float* ws, float* y, int B, int flip,
                      cudaStream_t stream) {
  WsParams q = pl.q;
  q.y = y;
  int sms = 0;
  cudaError_t err = sm90::sm_count(sms);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap{}, kmap{};
  if (!ws_maps(xmap, kmap, x, ws, B, q.H, q.W, pl.p.CI, q.CO, q.R))
    return cudaErrorInvalidValue;
  const long long n = ws_split_floats(pl.p.CI, q.CO) / 2;
  long long sblocks = (n + 255) / 256;
  if (sblocks > 4LL * sms) sblocks = 4LL * sms;
  conv3x3_tf32_ksplit_kernel<<<(unsigned)sblocks, 256, 0, stream>>>(
      k, ws, pl.p.CI, q.CO, q.nslices, flip, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.gx, pl.ntiles, 1);
  cfg.blockDim = dim3(kWsThreads, 1, 1);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, conv3x3_tf32_ws_kernel, q, xmap, kmap);
}

// K's split into the cp.async body's layout, then the body
cudaError_t launch_cp_async(const Plan& pl, const float* k, int flip,
                            cudaStream_t stream) {
  const Params& p = pl.p;
  int sms = 0;
  cudaError_t err = sm90::sm_count(sms);
  if (err != cudaSuccess) return err;
  long long sblocks = (p.part + 255) / 256;
  if (sblocks > 4LL * sms) sblocks = 4LL * sms;
  conv3x3_tf32_split_kernel<<<(unsigned)sblocks, 256, 0, stream>>>(
      k, const_cast<float*>(p.ws), p.CI, p.CO, p.ngroups, flip, p.part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  conv3x3_tf32_kernel<<<pl.grid, kWarpgroup * pl.consumers, pl.smem,
                        stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// floats of the workspace, the larger of the two bodies' split K, or 0
// where it would not fit an int
int workspace_floats(int CI, int CO) {
  if (CI <= 0 || CO <= 0) return 0;
  const long long a = 2 * split_floats(CI, CO), b = ws_split_floats(CI, CO);
  const long long n = a > b ? a : b;
  return n > 0x7fffffffLL ? 0 : (int)n;
}

cudaError_t conv3x3_f32(const float* x, const float* k, float* ws, float* y,
                        int B, int H, int W, int CI, int CO, int flip,
                        int ws_floats, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || CI <= 0 || CO <= 0 ||
      ws_floats <= 0 || ws_floats != workspace_floats(CI, CO))
    return cudaErrorInvalidValue;
  Plan pl;
  cudaError_t err = cached_plan(pl, B, H, W, CI, CO);
  if (err != cudaSuccess) return err;
  if (pl.tma && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(ws) % 16 == 0)
    return launch_ws(pl, x, k, ws, y, B, flip, stream);
  if (pl.tma) {  // misaligned pointers: the cp.async body at this shape
    err = plan_cp_async(pl);
    if (err != cudaSuccess) return err;
  }
  Params& p = pl.p;
  p.x = x;
  p.ws = ws;
  p.y = y;
  p.vec = CI % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.yvec = CO % 2 == 0 && reinterpret_cast<uintptr_t>(y) % 8 == 0;
  return launch_cp_async(pl, k, flip, stream);
}

// the launch plan at a shape, into out[0..7]: 1 where it takes the TMA
// body, blocks a cluster, consumer warpgroups a block, units (tiles of
// pixels x Cout tiles), blocks, halo stages, the Cout tile's width, tf32
// products a chain
cudaError_t conv3x3_f32_plan(int B, int H, int W, int CI, int CO, int* out) {
  Plan pl;
  const cudaError_t err = cached_plan(pl, B, H, W, CI, CO);
  if (err != cudaSuccess) return err;
  const int v[8] = {pl.tma, pl.cluster, pl.consumers, pl.units, pl.grid,
                    pl.ring, pl.bn, pl.chain};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return cudaSuccess;
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

// ------------------------------------ the TMA body: warp-specialised
constexpr int kConsumers = 2;  // consumer warpgroups, a tile each a round
constexpr int kWsThreads = kWarpgroup * (kConsumers + 1);
constexpr int kCoutTile = 64;  // wgmma M: output channels a tile
constexpr int kMaxRing = 4;    // halo stages
constexpr int kTapBytes = 64 * kPixelBytes;          // a tap's 64 x 64 of K
// launched with 168 registers a thread (384 threads, one block an SM)
constexpr int kProducerRegs = 56, kConsumerRegs = 224;

struct WsParams {
  int H, W;
  int R;             // image rows a tile: R * (W + 2) <= TN
  int rblocks;       // tiles an image: ceil(H / R)
  int tiles;         // B * rblocks
  int nslices;       // 64-channel slices of Cin
  int halo_bytes;    // a stage's buffer, a multiple of 1024
  int box_bytes;     // what its TMA box brings
  int ring;          // halo stages in flight
  int rounds;        // rounds every block walks where K changes (Cin > 64)
};

// The TMA body.  The product is turned around: A = K's tap (64 output
// channels x 16 input channels) and B = TN padded pixel positions x 16
// input channels, both read by wgmma from shared memory (m64nTNk16).
// A tile is R image rows of one image, W + 2 positions a row (a zero
// column each side); its halo, rows h0 - 1 ... h0 + R with their zero
// columns, is one TMA box of a 4-D view of x (zeros outside the image
// and past Cin), 128 bytes a position, 128-byte swizzled.  Tap (dy, dx)
// of output position q reads halo position q + dy (W + 2) + dx - 1: a
// shift of B's start address, no mask.  The zero columns and positions
// past R (W + 2) are computed and dropped by the epilogue.
//
// Blocks of two consumer warpgroups and a producer warpgroup, launched in
// clusters along the tiles; blockIdx.y is the Cout tile.  A block owns a
// contiguous range of tiles (an equal split over gridDim.x) and walks it
// in rounds of two tiles, one a consumer; with Cin > 64 each slice of a
// tile is a round of its own.  TN = 64 (small batch): one tile a block,
// its taps split over the two consumers.
//
// Shared memory: K's nine taps (one slice), an output tile a consumer,
// the ring of halo stages (two a round), the mbarriers, a scratch line.
template <int FLIP, int TN>
__global__ void __launch_bounds__(kWsThreads, 1)
conv3x3_wgmma_ws_kernel(const WsParams p,
                        const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap ymap) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // TMA's swizzled tiles want 1024-byte alignment
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int kOut = TN * kPixelBytes;  // an output tile
  // tiles of 64 positions come one a block, their taps split over the
  // two consumers (small batch); tiles of 128, two a round
  constexpr bool kSplit = TN == 64;
  unsigned char* ks = smem;
  unsigned char* outs = ks + 9 * kTapBytes;
  unsigned char* halo = outs + kConsumers * kOut;
  unsigned char* misc = halo + p.ring * p.halo_bytes;
  const uint32_t kfull = sm90::smem_u32(misc);  // a tap of K each
  const uint32_t kempty = kfull + 72;           // every consumer warp of
                                                // the cluster has read K
  const uint32_t hfull = kempty + 8;            // a halo stage each
  const uint32_t hempty = hfull + 8 * kMaxRing;
  const int tid = threadIdx.x, wg = tid / kWarpgroup;
  const uint32_t csize = sm90::cluster_size();
  if (tid == 0) {
    for (int t = 0; t < 9; ++t) sm90::mbar_init(kfull + 8 * t, 1);
    sm90::mbar_init(kempty, 4 * kConsumers * csize);
    for (int i = 0; i < p.ring; ++i) {
      sm90::mbar_init(hfull + 8 * i, 1);
      sm90::mbar_init(hempty + 8 * i, 4);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();
  // the peers' mbarriers are ready before a multicast or an arrival
  sm90::cluster_sync();

  const int n0 = blockIdx.y * kCoutTile;
  const int lo = (int)((long long)p.tiles * blockIdx.x / gridDim.x);
  const int hi = (int)((long long)p.tiles * (blockIdx.x + 1) / gridDim.x);
  // a round: two tiles (one a consumer) at one slice of Cin
  const int my_rounds = (hi - lo + 1) / 2 * p.nslices;
  // K is loaded once; with Cin > 64 once a round, every block of the
  // cluster walking the same p.rounds rounds
  const int kloads = p.nslices > 1 ? p.rounds : 1;
  const int walk = kSplit ? 1 : p.nslices > 1 ? p.rounds : my_rounds;
  // the first row of taps, the same within a cluster
  const int dy0 = (int)((blockIdx.x / csize + blockIdx.y) % 3);

  if (wg == kConsumers) {
    // ------------------------------------------------------- producer
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers * kWarpgroup) {
      sm90::prefetch_tensormap(&xmap);
      sm90::prefetch_tensormap(&kmap);
      sm90::prefetch_tensormap(&ymap);
      const uint32_t rank = sm90::cluster_rank();
      const uint16_t mask = (uint16_t)((1u << csize) - 1);
      const uint32_t kbase = sm90::smem_u32(ks), hbase = sm90::smem_u32(halo);
      for (int k = 0; k < (walk > kloads ? walk : kloads); ++k) {
        const int s = k % p.nslices;
        if (k < kloads) {
          // K's slice s, a tap on each mbarrier, in the consumers' order:
          // each block of the cluster asks for its share of the taps
          // (t % cluster == rank), written into every block
          if (k > 0) sm90::mbar_wait(kempty, (k - 1) & 1);
          for (int j = 0; j < 9; ++j) {
            const int t = (dy0 + j / 3) % 3 * 3 + j % 3;
            sm90::mbar_expect_tx(kfull + 8 * t, kTapBytes);
            if (t % (int)csize == (int)rank)
              sm90::tma_load_3d_multicast(
                  kbase + t * kTapBytes, &kmap, FLIP ? s * kSlice : n0,
                  FLIP ? n0 : s * kSlice, FLIP ? 8 - t : t, kfull + 8 * t,
                  mask);
          }
        }
        if (k >= walk) continue;
        if constexpr (kSplit) {  // the block's one tile, for both consumers
          if (lo < hi) {
            sm90::mbar_expect_tx(hfull, p.box_bytes);
            sm90::tma_load_4d(hbase, &xmap, 0, -1, (lo % p.rblocks) * p.R - 1,
                              lo / p.rblocks, hfull);
          }
          continue;
        }
        for (int c = 0; c < kConsumers; ++c) {
          // stage 2k + c: the halo of consumer c's tile this round (or,
          // past the block's tiles, an arrival alone)
          const int st = 2 * k + c, slot = st % p.ring;
          const int tile = lo + 2 * (k / p.nslices) + c;
          sm90::mbar_wait(hempty + 8 * slot, ((st / p.ring) & 1) ^ 1);
          const uint32_t bar = hfull + 8 * slot;
          if (tile < hi) {
            sm90::fence_proxy_async();  // the slot's last reads came first
            sm90::mbar_expect_tx(bar, p.box_bytes);
            sm90::tma_load_4d(hbase + slot * p.halo_bytes, &xmap, s * kSlice,
                              -1, (tile % p.rblocks) * p.R - 1,
                              tile / p.rblocks, bar);
          } else {
            sm90::mbar_arrive(bar);
          }
        }
      }
      // every multicast into this block has landed before it leaves
      for (int t = 0; t < 9; ++t)
        sm90::mbar_wait(kfull + 8 * t, (kloads - 1) & 1);
    }
    __syncwarp();
    sm90::cluster_arrive();
    sm90::cluster_wait();
  } else {
    // ------------------------------------------------------- consumers
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int c = wg, ctid = tid % kWarpgroup;
    const int warp = ctid / 32, lane = tid % 32;
    const uint32_t kbase = sm90::smem_u32(ks), hbase0 = sm90::smem_u32(halo);
    const uint32_t out = sm90::smem_u32(outs + c * kOut);
    const uint32_t scratch = kfull + 256;  // 128 bytes nobody reads
    const int row = p.W + 2;  // positions a padded row
    // this lane's first stmatrix row: position 8 (lane / 16) + lane % 8,
    // at padded row r0, column col0 of the tile
    const int r0 = (8 * (lane / 16) + lane % 8) / row;
    const int col0 = 8 * (lane / 16) + lane % 8 - r0 * row;
    const int chunk = 2 * warp + (lane / 8) % 2;  // its 8 channels

    // the products of round k (stage slot) into acc: taps [j0, j1) of the
    // nine, four k16 steps each, one commit group
    auto products = [&](float(&acc)[TN / 2], int k, int slot, bool first,
                        int j0, int j1) {
      const uint32_t hb = hbase0 + slot * p.halo_bytes;
      sm90::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        if (j < j0 || j >= j1) continue;
        const int dy = (dy0 + j / 3) % 3, dx = j % 3, t = dy * 3 + dx;
        if (k < kloads) sm90::mbar_wait(kfull + 8 * t, k & 1);
        // B: the tile's positions shifted by the tap, 128 swizzled bytes
        // each; the first product of a tile drops acc's old value
        const uint32_t b0 = hb + (uint32_t)(dy * row + dx - 1) * kPixelBytes;
#pragma unroll
        for (int kc = 0; kc < kDepthSteps; ++kc) {
          // A: the tap's tile of K, rows of 128 swizzled bytes (output
          // channels contiguous unflipped, input channels flipped)
          const uint64_t da = sm90::make_desc_sw128(
              kbase + t * kTapBytes + kc * (FLIP ? 32 : 2048));
          const uint64_t db = sm90::make_desc_sw128(b0 + kc * 32);
          const int keep = !first || j > j0 || kc > 0;
          if constexpr (TN == 128)
            sm90::wgmma_ss_n128<FLIP ? 0 : 1, 0>(acc, da, db, keep);
          else
            sm90::wgmma_ss_n64<FLIP ? 0 : 1, 0>(acc, da, db, keep);
        }
      }
      sm90::wgmma_commit();
    };
    // a round without a tile: where K changes, its phase is waited for
    // all the same, so that this warp's arrival counts for this round
    auto idle = [&](int k) {
      if (k < kloads && p.nslices > 1)
        for (int t = 0; t < 9; ++t) sm90::mbar_wait(kfull + 8 * t, k & 1);
    };
    // release round k's halo stage (each warp once) and, where K changes
    // between rounds, K in every block of the cluster
    auto release = [&](int k) {
      __syncwarp();
      if (lane == 0) {
        sm90::mbar_arrive(hempty + 8 * ((2 * k + c) % p.ring));
        if (p.nslices > 1)
          for (uint32_t r = 0; r < csize; ++r)
            sm90::mbar_arrive_cluster(kempty, r);
      }
    };
    // the tile's sums rounded once to bf16 and stored transposed
    // (stmatrix) into the output tile, a pixel's 64 channels a 128-byte
    // row, R rows of W pixels, swizzled as the store's TMA box reads it
    // (zero columns and positions past the tile's rows go to a scratch
    // line); the store writes nothing past H or Cout.  The tile is
    // written again once that store has read it.
    auto epilogue = [&](float(&acc)[TN / 2], int tile) {
      if (ctid == 0) sm90::bulk_wait_read<0>();
      sm90::named_sync(1 + c, kWarpgroup);
      int r = r0, col = col0;
#pragma unroll
      for (int j = 0; j < TN / 8; j += 2) {
        // matrix m of the four: positions 8 (j + m / 2) ..., channels
        // 16 warp + 8 (m % 2) ...; this lane gives matrix lane / 8's row
        // lane % 8, position 8 (j + lane / 16) + lane % 8
        uint32_t v[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int e = 4 * (j + m / 2) + 2 * (m % 2);
          __nv_bfloat162 h2;
          h2.x = __float2bfloat16_rn(acc[e]);
          h2.y = __float2bfloat16_rn(acc[e + 1]);
          v[m] = *reinterpret_cast<uint32_t*>(&h2);
        }
        const int o = r * p.W + col - 1;
        const bool real = r < p.R && col >= 1 && col <= p.W;
        sm90::stmatrix_x4_trans(
            real ? out + o * kPixelBytes + ((chunk ^ (o & 7)) << 4)
                 : scratch + (chunk << 4),
            v[0], v[1], v[2], v[3]);
        col += 16;  // the next pair of n-blocks
        while (col >= row) {
          col -= row;
          ++r;
        }
      }
      sm90::fence_proxy_async();  // the tile, read by TMA
      sm90::named_sync(1 + c, kWarpgroup);
      if (ctid == 0) {
        sm90::tma_store_4d(&ymap, out, n0, 0, (tile % p.rblocks) * p.R,
                           tile / p.rblocks);
        sm90::bulk_commit();
      }
    };

    if constexpr (kSplit) {
      // one tile a block (small batch): both consumers multiply it, the
      // first five taps and the last four; the second hands its sums to
      // the first through shared memory (the ring's second stage, in the
      // accumulators' own layout) and the first stores the tile
      float acc[TN / 2];
      if (lo < hi) {
        sm90::mbar_wait(hfull, 0);
        products(acc, 0, 0, true, c == 0 ? 0 : 5, c == 0 ? 5 : 9);
        sm90::wgmma_wait<0>();
        float4* part = reinterpret_cast<float4*>(halo + p.halo_bytes) +
                       ctid * (TN / 8);
        if (c == 1) {
#pragma unroll
          for (int r = 0; r < TN / 8; ++r)
            part[r] = make_float4(acc[4 * r], acc[4 * r + 1],
                                  acc[4 * r + 2], acc[4 * r + 3]);
          sm90::named_arrive(3, 2 * kWarpgroup);
        } else {
          sm90::named_sync(3, 2 * kWarpgroup);
#pragma unroll
          for (int r = 0; r < TN / 8; ++r) {
            const float4 v = part[r];
            acc[4 * r] += v.x;
            acc[4 * r + 1] += v.y;
            acc[4 * r + 2] += v.z;
            acc[4 * r + 3] += v.w;
          }
          epilogue(acc, lo);
        }
      }
    } else {
      // round k: the products of the consumer's tile (with Cin > 64, of a
      // slice of it; a tile's slices accumulate in acc) while the other
      // consumer's run; every round ends with its products done, its
      // halo stage free (and K, which may then change) and, at a tile's
      // last slice, the tile stored
      float acc[TN / 2];
      for (int k = 0; k < walk; ++k) {
        const int s = k % p.nslices, st = 2 * k + c;
        const int tile = lo + 2 * (k / p.nslices) + c;
        sm90::mbar_wait(hfull + 8 * (st % p.ring), (st / p.ring) & 1);
        if (tile < hi) {
          products(acc, k, st % p.ring, s == 0, 0, 9);
          sm90::wgmma_wait<0>();
        } else {
          idle(k);
        }
        release(k);
        if (tile < hi && s == p.nslices - 1) epilogue(acc, tile);
      }
    }
    if (ctid == 0) sm90::bulk_wait<0>();
    __syncwarp();
    sm90::cluster_arrive();  // no block leaves while a peer may arrive on
    sm90::cluster_wait();    // its mbarriers
  }
}

// the TMA body's three tensor maps at this shape (false where
// cuTensorMapEncodeTiled refuses one)
bool ws_maps(CUtensorMap& xmap, CUtensorMap& kmap, CUtensorMap& ymap,
             const bf16* x, const bf16* k, const bf16* y, int B, int H,
             int W, int CI, int CO, int flip, int R);

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

// A call's launch plan: the body, its grid and its shared memory.
struct Plan {
  int tma;        // the shape takes the TMA body
  int bn;         // Cout tile
  int cluster;    // blocks a cluster (TMA body; 1 for cp.async)
  int consumers;  // warpgroups that multiply, a block
  int units;      // tiles of pixels x Cout tiles
  int grid;       // blocks
  int ring;       // halo stages in shared memory
  int smem;
  int tn;          // TMA body: positions a tile (wgmma N)
  int gx, ntiles;  // TMA body: blocks along the tiles, Cout tiles
  WsParams q;      // TMA body
  Params p;        // cp.async body
};

// The TMA body's plan at a tile of TN positions: 128, or 64 with one tile
// a block and its taps split over the consumers.  A tile is R image rows,
// as many as TN padded positions hold (R (W + 2) <= TN), spread evenly
// over the image's rows; the block's shared memory holds as many halo
// stages as fit, up to kMaxRing.  Clusters of 4 or 2 blocks
// (choose_cluster).  Returns cudaErrorNotSupported where tiles of 64
// would give a block two.
template <int FLIP, int TN>
cudaError_t plan_ws(Plan& pl, int B) {
  WsParams& q = pl.q;
  const int row = q.W + 2;
  int R = TN / row;
  if (R > q.H) R = q.H;
  q.rblocks = (q.H + R - 1) / R;
  q.R = (q.H + q.rblocks - 1) / q.rblocks;
  const long long tiles = (long long)B * q.rblocks;
  // the positions a tile's products read: up to TN + 2 (W + 2) + 1
  q.box_bytes = (q.R + 2) * row * kPixelBytes;
  q.halo_bytes = ((TN + 2 * row + 8) * kPixelBytes + 1023) / 1024 * 1024;
  // + 1024: the alignment; + 512: the mbarriers and a scratch line
  const int fixed =
      1024 + 9 * kTapBytes + kConsumers * TN * kPixelBytes + 512;
  q.ring = (kSmemLimit - fixed) / q.halo_bytes;
  if (q.ring > kMaxRing) q.ring = kMaxRing;
  if (q.ring < 2) return cudaErrorInvalidValue;
  pl.smem = fixed + q.ring * q.halo_bytes;
  pl.bn = kCoutTile;
  pl.tn = TN;
  pl.consumers = kConsumers;
  pl.ring = q.ring;
  pl.ntiles = (pl.p.CO + kCoutTile - 1) / kCoutTile;
  if (pl.ntiles > 65535 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  q.tiles = (int)tiles;
  long long best = -1;
  const cudaError_t err = choose_cluster(
      reinterpret_cast<const void*>(conv3x3_wgmma_ws_kernel<FLIP, TN>),
      kWsThreads, pl.smem, kSmemLimit, 4, 2, pl.ntiles, tiles, pl.cluster,
      pl.gx, best);
  if (err != cudaSuccess) return err;
  if (TN == 64 && best > 1) return cudaErrorNotSupported;
  q.rounds = (int)((best + 1) / 2 * q.nslices);
  const long long units = tiles * pl.ntiles;
  if (units > 0x7fffffffLL || (long long)pl.gx * pl.ntiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  pl.units = (int)units;
  pl.grid = pl.gx * pl.ntiles;
  return cudaSuccess;
}

// The cp.async body's plan (conv3x3_wgmma_kernel): the most warpgroups a
// block whose tiles still give every SM one; at small batch 32-wide Cout
// tiles double the blocks; a block an SM walks the tiles.
template <int BN, int FLIP>
cudaError_t plan_cp_async_for(Plan& pl, int warpgroups) {
  Params& p = pl.p;
  p.TM = kTileRows * warpgroups;
  p.S = p.W < p.TM + 2 ? p.W : p.TM + 2;
  p.nslots = 2 * p.S + p.TM + 2;
  p.mtiles = (int)((p.P + p.TM - 1) / p.TM);
  p.ntiles = (p.CO + BN - 1) / BN;
  p.nslices = (p.CI + kSlice - 1) / kSlice;
  p.halo_bytes = p.nslots * kPixelBytes;
  p.k_bytes = 9 * kSlice * BN * 2;
  p.out_bytes = 4 * warpgroups * 16 * BN * 2;
  // + 1024: the kernel aligns K to 1024 bytes
  const int fixed = 1024 + p.k_bytes + 128 + p.out_bytes;
  p.nbuf = fixed + 2 * p.halo_bytes <= kSmemLimit ? 2 : 1;
  pl.smem = fixed + p.nbuf * p.halo_bytes;
  int sms = 0, per_sm = 0;
  cudaError_t err = sm90::occupancy(
      reinterpret_cast<const void*>(conv3x3_wgmma_kernel<BN, FLIP>),
      kWarpgroup * warpgroups, pl.smem, kSmemLimit, sms, per_sm);
  if (err != cudaSuccess) return err;
  const long long units = (long long)p.mtiles * p.ntiles;
  if (units * p.nslices > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long most = (long long)sms * per_sm;
  pl.tma = 0;
  pl.bn = BN;
  pl.cluster = 1;
  pl.consumers = warpgroups;
  pl.units = (int)units;
  pl.grid = (int)(units < most ? units : most);
  pl.ring = p.nbuf;
  return cudaSuccess;
}

cudaError_t plan_cp_async(Plan& pl, int flip, int sms) {
  const Params& p = pl.p;
  const int ntiles64 = (p.CO + 63) / 64;
  int warpgroups = kMaxWarpgroups;
  while (warpgroups > 1 &&
         (p.P + kTileRows * warpgroups - 1) / (kTileRows * warpgroups) *
                 ntiles64 < sms)
    --warpgroups;
  const bool narrow = p.CO <= 32 ||
                      (warpgroups == 1 &&
                       (p.P + kTileRows - 1) / kTileRows * ntiles64 < sms);
  if (narrow)
    return flip ? plan_cp_async_for<32, 1>(pl, warpgroups)
                : plan_cp_async_for<32, 0>(pl, warpgroups);
  return flip ? plan_cp_async_for<64, 1>(pl, warpgroups)
              : plan_cp_async_for<64, 0>(pl, warpgroups);
}

// The plan at a shape.  The TMA body takes Cin and Cout multiples of 8 (the
// tensor maps' rows are then 16-byte multiples) and images whose padded
// row fits a tile (W + 2 <= 128); at the launch, x, K and y must also start
// 16-byte aligned.  Other shapes and pointers take the cp.async body.
// Tiles of 128 positions where they give every SM one.  Below that, where
// tiles of 64 positions give at least half the SMs one and no block two,
// one tile a block with its taps split over the two consumers (the chain
// of products a call waits for halved: small batches such as B = 8 at
// 28x28); else the cp.async body, whose start-up measured shorter on an
// H100 at such sizes (B = 1, 4 and 16 at 28x28).
cudaError_t make_plan(Plan& pl, int B, int H, int W, int CI, int CO,
                      int flip) {
  if (B <= 0 || H <= 0 || W <= 0 || CI <= 0 || CO <= 0)
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm90::sm_count(sms);
  if (err != cudaSuccess) return err;
  pl = Plan{};
  Params& p = pl.p;
  p.P = (long long)B * H * W;
  p.H = H;
  p.W = W;
  p.CI = CI;
  p.CO = CO;
  pl.tma = CI % 8 == 0 && CO % 8 == 0 && W + 2 <= 128 &&
           sm90::encode_tiled() != nullptr;
  if (!pl.tma) return plan_cp_async(pl, flip, sms);
  WsParams& q = pl.q;
  q.H = H;
  q.W = W;
  q.nslices = (CI + kSlice - 1) / kSlice;
  const int ntiles = (CO + kCoutTile - 1) / kCoutTile;
  auto tiles_at = [&](int tn) {
    const int R = tn / (W + 2) < H ? tn / (W + 2) : H;
    return (long long)B * ((H + R - 1) / R) * ntiles;
  };
  if (tiles_at(128) >= sms)
    err = flip ? plan_ws<1, 128>(pl, B) : plan_ws<0, 128>(pl, B);
  else if (q.nslices == 1 && W + 2 <= 64 && 2 * tiles_at(64) >= sms)
    err = flip ? plan_ws<1, 64>(pl, B) : plan_ws<0, 64>(pl, B);
  else
    err = cudaErrorNotSupported;
  if (err == cudaErrorNotSupported) {
    pl.tma = 0;
    return plan_cp_async(pl, flip, sms);
  }
  if (err != cudaSuccess) return err;
  // the tensor maps at this shape (any 1024-byte aligned address stands
  // in for the tensors'): where one is refused, cp.async
  CUtensorMap a, b, c;
  const bf16* any = reinterpret_cast<const bf16*>(uintptr_t{1} << 20);
  if (ws_maps(a, b, c, any, any, any, B, H, W, CI, CO, flip, q.R))
    return cudaSuccess;
  pl.tma = 0;
  return plan_cp_async(pl, flip, sms);
}

bool ws_maps(CUtensorMap& xmap, CUtensorMap& kmap, CUtensorMap& ymap,
             const bf16* x, const bf16* k, const bf16* y, int B, int H,
             int W, int CI, int CO, int flip, int R) {
  // the halo box takes a zero column each side (TMA's fill past the
  // image); the store's box, the tile's pixels
  return sm90::image_map(xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, B, H, W,
                         CI, 64, W + 2, R + 2,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B) &&
         k_tensor_map(kmap, k, CI, CO, flip) &&
         sm90::image_map(ymap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, y, B, H, W,
                         CO, 64, W, R, CU_TENSOR_MAP_L2_PROMOTION_NONE);
}

// make_plan, remembered per device, shape and flip
cudaError_t cached_plan(Plan& pl, int B, int H, int W, int CI, int CO,
                        int flip) {
  return remembered_plan(pl, {B, H, W, CI, CO, flip}, [&](Plan& made) {
    return make_plan(made, B, H, W, CI, CO, flip);
  });
}

template <int FLIP, int TN>
cudaError_t launch_ws(const Plan& pl, const CUtensorMap& xmap,
                      const CUtensorMap& kmap, const CUtensorMap& ymap,
                      cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.gx, pl.ntiles, 1);
  cfg.blockDim = dim3(kWsThreads, 1, 1);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, conv3x3_wgmma_ws_kernel<FLIP, TN>, pl.q,
                            xmap, kmap, ymap);
}

template <int BN, int FLIP>
cudaError_t launch_cp_async(const Plan& pl, cudaStream_t stream) {
  Params p = pl.p;
  CUtensorMap kmap{};
  p.ktma = BN == 64 && p.kvec && k_tensor_map(kmap, p.k, p.CI, p.CO, FLIP);
  conv3x3_wgmma_kernel<BN, FLIP>
      <<<pl.grid, kWarpgroup * pl.consumers, pl.smem, stream>>>(p, kmap);
  return cudaGetLastError();
}

}  // namespace

cudaError_t conv3x3_bf16(const bf16* x, const bf16* k, bf16* y, int B, int H,
                         int W, int CI, int CO, int flip,
                         cudaStream_t stream) {
  Plan pl;
  cudaError_t err = cached_plan(pl, B, H, W, CI, CO, flip);
  if (err != cudaSuccess) return err;
  Params& p = pl.p;
  p.x = x;
  p.k = k;
  p.y = y;
  p.vec = CI % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.kvec = (flip ? CI : CO) % 8 == 0 &&
           reinterpret_cast<uintptr_t>(k) % 16 == 0;
  p.yvec = CO % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (pl.tma && p.vec && p.kvec && p.yvec) {
    CUtensorMap xmap{}, kmap{}, ymap{};
    if (ws_maps(xmap, kmap, ymap, x, k, y, B, H, W, CI, CO, flip, pl.q.R))
    {
      if (pl.tn == 64)
        return flip ? launch_ws<1, 64>(pl, xmap, kmap, ymap, stream)
                    : launch_ws<0, 64>(pl, xmap, kmap, ymap, stream);
      return flip ? launch_ws<1, 128>(pl, xmap, kmap, ymap, stream)
                  : launch_ws<0, 128>(pl, xmap, kmap, ymap, stream);
    }
  }
  if (pl.tma) {  // misaligned pointers: the cp.async body at this shape
    int sms = 0;
    err = sm90::sm_count(sms);
    if (err == cudaSuccess) err = plan_cp_async(pl, flip, sms);
    if (err != cudaSuccess) return err;
  }
  if (pl.bn == 32)
    return flip ? launch_cp_async<32, 1>(pl, stream)
                : launch_cp_async<32, 0>(pl, stream);
  return flip ? launch_cp_async<64, 1>(pl, stream)
              : launch_cp_async<64, 0>(pl, stream);
}

// the launch plan at a shape, into out[0..6]: 1 where it takes the TMA
// body, blocks a cluster, consumer warpgroups a block, units (tiles of
// pixels x Cout tiles), blocks, halo stages, the Cout tile's width
cudaError_t conv3x3_bf16_plan(int B, int H, int W, int CI, int CO, int flip,
                              int* out) {
  Plan pl;
  const cudaError_t err = cached_plan(pl, B, H, W, CI, CO, flip);
  if (err != cudaSuccess) return err;
  const int v[7] = {pl.tma, pl.cluster, pl.consumers, pl.units, pl.grid,
                    pl.ring, pl.bn};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return cudaSuccess;
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

// The float32 launch plan at this shape, into out[0..7]: 1 where the shape
// takes the TMA body (0: cp.async), blocks a cluster, consumer warpgroups a
// block, units, blocks, halo stages, the Cout tile's width and the tf32
// products summed into one fresh accumulator.  Returns a cudaError_t.
int cfgan_conv3x3_f32_plan(int B, int H, int W, int Cin, int Cout, int* out) {
  return (int)f32::conv3x3_f32_plan(B, H, W, Cin, Cout, out);
}

int cfgan_conv3x3_bf16(const void* x, const void* k, void* y, int B, int H,
                       int W, int Cin, int Cout, int flip, void* stream) {
  return (int)tc::conv3x3_bf16(static_cast<const __nv_bfloat16*>(x),
                               static_cast<const __nv_bfloat16*>(k),
                               static_cast<__nv_bfloat16*>(y), B, H, W, Cin,
                               Cout, flip, static_cast<cudaStream_t>(stream));
}

// The bf16 launch plan at this shape, into out[0..6]: 1 where the shape
// takes the TMA body (0: cp.async), blocks a cluster, consumer warpgroups a
// block, units, blocks, halo stages and the Cout tile's width.  Returns a
// cudaError_t.
int cfgan_conv3x3_plan(int B, int H, int W, int Cin, int Cout, int flip,
                       int* out) {
  return (int)tc::conv3x3_bf16_plan(B, H, W, Cin, Cout, flip, out);
}

}  // extern "C"
