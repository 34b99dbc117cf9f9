// Hopper (sm_90a) building blocks shared by the tensor-core kernels, as
// inline PTX: cp.async with zero fill, ldmatrix, mbarriers (also arrivals
// from another block of the cluster), TMA and bulk loads (multicast over a
// cluster) and TMA stores, named barriers, setmaxnreg, thread block
// clusters and their distributed shared memory, and
// wgmma (bf16, and tf32 for the float32 kernels' 3xTF32 products) with
// the A operand in registers or in shared memory and B read from shared
// memory through a matrix descriptor.
//
// B's shared-memory layout is either the canonical one without swizzle:
// "core matrices" of 8 rows x 16 bytes, each 128 contiguous bytes, where the
// descriptor gives the byte stride between core matrices along the depth of
// the product (LBO) and along N (SBO); or rows of 128 bytes with the
// 128-byte swizzle, as TMA writes them (make_desc_sw128).
//
// A register fragment of a wgmma m64nNk16 is the mma.sync m16n8k16 A
// fragment of the warp's 16 rows (warp w of the warpgroup: rows 16w..16w+15):
// a0 (row g, depth 2t..2t+1), a1 (row g+8), a2 (row g, depth 2t+8..),
// a3 (row g+8, depth 2t+8..) with g = lane / 4, t = lane % 4.  ldmatrix.x4
// gives it from four 8x8 matrices whose 32 row addresses are free, which is
// what lets a shifted 3x3 tap be read in place.
//
// Accumulator layout (f32, N/2 registers a thread): d[4j + i] holds row
// 16w + g + 8 * (i / 2), column 8j + 2t + (i % 2).
//
// tf32 (m64nNk8): A's register fragment is the mma.sync m16n8k8 tf32 one,
// a0 (row g, depth t), a1 (row g+8), a2 (row g, depth t+4), a3 (row g+8,
// depth t+4), which ldmatrix.x4 (b16) delivers from rows of f32 values
// with the same row addresses as a bf16 k16 step: each 32-bit word is one
// element.  B must be K-major (no transpose for tf32): core matrices of 8
// rows of N x 16 bytes (4 depth values), LBO the stride between core
// matrices along the depth, SBO along N, as for bf16.  The tensor cores
// read only the top 19 bits of each word, truncating; tf32_rna rounds to
// nearest instead.  One tf32 product keeps about 3 decimal digits; the
// 3xTF32 products big*big + big*small + small*big (big = tf32(a),
// small = a - big; small*small is below float32's rounding) keep
// float32's accuracy.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes to shared memory visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// four 8x8 b16 matrices (each thread's fragment the mma layout's: row
// lane / 4, columns 2 (lane % 4), + 1) stored transposed: lanes 8i ..
// 8i + 7 give the addresses of matrix i's transposed rows, 16 bytes each
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0,
                                                  uint32_t r1, uint32_t r2,
                                                  uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};"
      "\n" ::"r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// matrix descriptor, no swizzle (layout type 0), base offset 0
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// matrix descriptor for a tile whose rows are 128 bytes with the 128-byte
// swizzle (layout type 1), as TMA writes it: 8-row groups 1024 bytes apart
// (SBO); a k16 step is +32 bytes of start address in a depth-major tile and
// +2048 (16 rows) in an N-major one.  The swizzle follows the address bits,
// so a tile may start at any 128-byte row of a region aligned to 1024 bytes
// with the base offset left 0 (setting it to the row's place in the 8-row
// pattern reads wrong rows: measured on an H100)
__device__ __forceinline__ uint64_t make_desc_sw128(uint32_t addr) {
  return make_desc(addr, 16, 1024) | (1ull << 62);
}

// mbarriers and TMA
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// wait until the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// fetch a TMA descriptor (a __grid_constant__ parameter) ahead of its
// first use
__device__ __forceinline__ void prefetch_tensormap(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            int x, int y, int z,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}
// the same box, written at shared address `dst` of every block of the
// cluster whose bit is set in `mask`, each completing on its own mbarrier
// at address `bar`: one read of the L2 feeds them all
__device__ __forceinline__ void tma_load_3d_multicast(uint32_t dst,
                                                      const void* map, int x,
                                                      int y, int z,
                                                      uint32_t bar,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar),
      "h"(mask)
      : "memory");
}
// the 2-D box at (x, y), multicast as tma_load_3d_multicast
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst,
                                                      const void* map, int x,
                                                      int y, uint32_t bar,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar), "h"(mask)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            int x, int y, int z, int w,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(w),
      "r"(bar)
      : "memory");
}
// a box of shared memory to global memory by TMA (elements outside the
// tensor are not written), in the thread's current bulk group
__device__ __forceinline__ void tma_store_4d(const void* map, uint32_t src,
                                             int x, int y, int z, int w) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(x), "r"(y), "r"(z), "r"(w)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// at most N of this thread's bulk groups still read their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// at most N of this thread's bulk groups are not complete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// an arrival on the mbarrier at this block's shared address `bar` in block
// `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

// named barriers (ids 1-15; 0 is __syncthreads): sync waits until `count`
// threads have arrived or synced on `id`, arrive does not wait
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// a warpgroup's registers a thread, raised or lowered (all four warps)
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// thread block clusters: this block's rank and the cluster's size, a
// barrier over the cluster's threads (arrive releases, wait acquires:
// shared-memory accesses before a block's arrival are seen by every block
// of the cluster after its wait), and loads from another block's shared
// memory (distributed shared memory)
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
// the address in block `rank` of the cluster of this block's shared
// address `addr`
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x N, f32) += A (64 x 16, bf16, registers) * B (16 x N, bf16,
// shared memory).  TransB = 0: B is stored depth-major within each core
// matrix (the 8 depth values of one column contiguous); 1: N-major.
template <int N, int TransB>
struct Wgmma;

template <int TransB>
struct Wgmma<64, TransB> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
          "n"(TransB));
  }
};

template <int TransB>
struct Wgmma<32, TransB> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
          "n"(TransB));
  }
};

// d (64 x 128, f32) (+)= A (64 x 16, bf16) * B (16 x 128, bf16), both read
// from shared memory through their descriptors; TA / TB: the operand is
// stored MN-major (transposed); d's old value is dropped where scale_d is 0
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// the same with N = 64
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// 16 bytes (4 floats) from src to shared memory, those at or past `avail`
// zero: cp.async where vec (src 16-byte aligned), else element-wise
__device__ __forceinline__ void copy16_f32(unsigned char* dst,
                                           const float* src, int avail,
                                           bool vec) {
  if (vec) {
    cp_async16(smem_u32(dst), src, avail > 0 ? 16 : 0);
  } else {
    float4 v;
    v.x = avail > 0 ? src[0] : 0.f;
    v.y = avail > 1 ? src[1] : 0.f;
    v.z = avail > 2 ? src[2] : 0.f;
    v.w = avail > 3 ? src[3] : 0.f;
    *reinterpret_cast<float4*>(dst) = v;
  }
}

// the float32 value a rounded to tf32 (nearest, ties away), low 13 bits 0
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

// a = big + small, the split of 3xTF32: big = a rounded to tf32, small =
// a - big exactly.  small is left for the tensor cores to truncate to
// tf32: it has at most 13 significant bits and loses at most 2, at most
// 2^-22 of a, the size of a second rounding's own error (the conv's row
// errors read the same with and without it, and the split is the
// float32 kernels' costliest ALU work)
__device__ __forceinline__ void tf32_split(uint32_t a, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(__uint_as_float(a));
  small = __float_as_uint(__uint_as_float(a) - __uint_as_float(big));
}

// a - trunc(a): what the tensor cores drop when they read the float32 word
// a as tf32 (its low 13 mantissa bits), exactly; with a itself as the big
// part, big*big + big*small + small*big is a 3xTF32 product
__device__ __forceinline__ float tf32_rest(float a) {
  return a - __uint_as_float(__float_as_uint(a) & 0xffffe000u);
}

// `bytes` (a multiple of 16) from global to shared memory by the bulk copy
// engine, completing on the mbarrier's transaction count
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// d (64 x 32, f32) = A (64 x 8, tf32, registers) * B (8 x 32, tf32,
// shared memory, K-major), + d unless scale_d is 0
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d (+)= the 3xTF32 product of A = big + small and B = its big and small
// tiles: big*small and small*big first, then big*big; d's old value is
// dropped where scale_d is 0.
//
// The tensor cores add each product into d with truncation, so d's error
// grows with the number of products it takes: over the 216 products of a
// 576-deep conv, past the float32 bar of 1e-5 per output row.  The float32
// kernels therefore start a fresh d every few products and add it into
// their running sum on the CUDA cores, which round to nearest.
__device__ __forceinline__ void wgmma_3xtf32_n32(float (&d)[16],
                                                 const uint32_t (&big)[4],
                                                 const uint32_t (&small)[4],
                                                 uint64_t bbig,
                                                 uint64_t bsmall,
                                                 int scale_d) {
  wgmma_tf32_n32(d, small, bbig, scale_d);
  wgmma_tf32_n32(d, big, bsmall, 1);
  wgmma_tf32_n32(d, big, bbig, 1);
}

// d (64 x 128, f32) (+)= A (64 x 8, tf32) * B (8 x 128, tf32), both read
// from shared memory through their descriptors, both K-major (tf32 has no
// transpose); d's old value is dropped where scale_d is 0
__device__ __forceinline__ void wgmma_tf32_ss_n128(float (&d)[64],
                                                   uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------- host
// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// library links no libcuda); null where the driver has none
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// a (B, H, W, C), NHWC, of `bytes`-byte elements as a 4-D tensor for TMA,
// boxes of `channels` (128 bytes) x `cols` pixels x `rows` rows of one
// image, 128-byte swizzle; zeros outside (loads), nothing written outside
// (stores)
inline bool image_map(CUtensorMap& map, CUtensorMapDataType type, int bytes,
                      const void* a, int B, int H, int W, int C, int channels,
                      int cols, int rows, CUtensorMapL2promotion promotion) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * bytes,
                                 (cuuint64_t)W * C * bytes,
                                 (cuuint64_t)H * W * C * bytes};
  const cuuint32_t box[4] = {(cuuint32_t)channels, (cuuint32_t)cols,
                             (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(&map, type, 4, const_cast<void*>(a), dims, strides, box,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, promotion,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the current device's SM count, queried once a device
inline cudaError_t sm_count(int& sms) {
  static std::mutex mutex;
  static int counts[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mutex);
  if (counts[dev] == 0) {
    err = cudaDeviceGetAttribute(&counts[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  sms = counts[dev];
  return cudaSuccess;
}

// The SM count and how many blocks of `threads` threads and `smem` bytes
// of dynamic shared memory an SM holds for kernel `fn`, with its cap
// raised to `smem_cap` first; cached per (device, kernel, shared memory),
// since the queries cost microseconds and a served request makes 13
// launches.
inline cudaError_t occupancy(const void* fn, int threads, int smem,
                             int smem_cap, int& sms, int& per_sm) {
  struct Entry {
    int dev;
    const void* fn;
    int threads, smem, per_sm;
  };
  static std::mutex mutex;
  static Entry entries[64];
  static int n = 0;
  cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mutex);
  for (int i = 0; i < n; ++i)
    if (entries[i].dev == dev && entries[i].fn == fn &&
        entries[i].threads == threads && entries[i].smem == smem) {
      per_sm = entries[i].per_sm;
      return cudaSuccess;
    }
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_cap);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                        smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  if (n < 64) entries[n++] = Entry{dev, fn, threads, smem, per_sm};
  return cudaSuccess;
}

// How many clusters of `cluster` blocks (along x) of kernel `fn`, each of
// `threads` threads and `smem` bytes of dynamic shared memory, the card
// holds at once (cudaOccupancyMaxActiveClusters: clusters are placed
// within a GPC, so blocks of one an SM may not fill every SM); 0 where
// none fits.  Cached per (device, kernel, shared memory, cluster size).
inline cudaError_t max_clusters(const void* fn, int threads, int smem,
                                int smem_cap, int cluster, int& clusters) {
  struct Entry {
    int dev;
    const void* fn;
    int threads, smem, cluster, clusters;
  };
  static std::mutex mutex;
  static Entry entries[64];
  static int n = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mutex);
  for (int i = 0; i < n; ++i)
    if (entries[i].dev == dev && entries[i].fn == fn &&
        entries[i].threads == threads && entries[i].smem == smem &&
        entries[i].cluster == cluster) {
      clusters = entries[i].clusters;
      return cudaSuccess;
    }
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_cap);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) return err;
  if (n < 64) entries[n++] = Entry{dev, fn, threads, smem, cluster, clusters};
  return cudaSuccess;
}

}  // namespace sm90
