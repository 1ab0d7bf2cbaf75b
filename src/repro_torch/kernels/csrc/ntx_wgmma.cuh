// Hopper (sm_90a) helpers: warpgroup products (wgmma), the Tensor Memory
// Accelerator (TMA) and the mbarriers that report its copies, register
// hand-over between warpgroups (setmaxnreg), and the shared-memory matrix
// descriptors of tiles that TMA wrote with the 128-byte swizzle.
//
// Tiles. A tile of R rows of D bf16 (D = 64, 128 or 192) is stored as D / 64
// panels, panel p holding columns 64p..64p+63 of every row, 128 bytes a
// row, so panel p starts at p * R * 128 bytes. TMA writes each panel with
// CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c of row r lands at chunk
// c ^ (r % 8) of its 128-byte line. Every tile starts on a 1024-byte
// boundary, so the swizzle's 8-row atoms line up with the descriptors'.
//
// Accumulators of wgmma.m64nNk16 (fp32), with w = warp % 4, g = lane / 4,
// q = lane % 4: acc[j][0..1] = C[16w + g][8j + 2q .. +1], acc[j][2..3] =
// C[16w + g + 8][8j + 2q .. +1], j < N / 8 (mma.sync's C fragments, warp
// w taking rows 16w..16w+15). The A operand from registers takes the
// same rows: for k-step kk, a[0] = A[16w+g][16kk+2q..], a[1] =
// A[16w+g+8][16kk+2q..], a[2] = A[16w+g][16kk+8+2q..], a[3] =
// A[16w+g+8][16kk+8+2q..], two bf16 a register (lower index in the lower
// half), so an accumulator of one product packs into the A operand of the
// next (pack_a).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ntx {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// One arrival that also tells the barrier to wait for `bytes` of copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// Wait until the phase of parity `parity` has completed (a barrier starts
// in phase 0, so parity 1 passes at once). No trap on a long wait: ptxas
// (12.9) then no longer gives a branch the registers of its setmaxnreg.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// A 4-D box (coordinates innermost first) of the tensor map at `map` (a
// __grid_constant__ parameter) into shared memory at dst, completing on
// bar. Boxes past the tensor's edge are filled with zeros, and their bytes
// count in full towards the barrier's transaction count.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// src into shared dst, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------
// Register hand-over between warpgroups: every warp of the warpgroup
// executes it, in a branch the warpgroup never leaves.
// ---------------------------------------------------------------------
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ---------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------
// Descriptor of a 128-byte-swizzled operand at shared address addr: lbo
// and sbo in bytes (the leading and stride byte offsets).
//  * K-major (rows of the operand's M or N, K contiguous): addr is the
//    panel holding the k-step, plus the row offset (128 bytes a row) and
//    32 bytes a k-step within the 128-byte line; sbo 1024 (8 rows), lbo
//    unused.
//  * MN-major (the transposed B: rows are K, N contiguous): addr is the
//    k-step's first row (16 rows, 2048 bytes a step); lbo the panel
//    stride (from N columns 0-63 to 64-127), sbo 1024 (8 rows of K).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes, so the
// compiler neither reads them before a wgmma_wait nor reuses them while a
// product is in flight.
template <int NT>
__device__ __forceinline__ void fence_regs(float (&a)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(a[j][e]) :: "memory");
}
template <int NK>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[NK][4]) {
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e]) :: "memory");
}

// acc (NT n-chunks of 8) packed to bf16 A operands of NT / 2 k-steps.
template <int NT>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NT / 2][4],
                                       const float (&acc)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    __nv_bfloat162 v0 = __floats2bfloat162_rn(acc[2 * kk][0], acc[2 * kk][1]);
    __nv_bfloat162 v1 = __floats2bfloat162_rn(acc[2 * kk][2], acc[2 * kk][3]);
    __nv_bfloat162 v2 =
        __floats2bfloat162_rn(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
    __nv_bfloat162 v3 =
        __floats2bfloat162_rn(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
    a[kk][0] = *reinterpret_cast<uint32_t*>(&v0);
    a[kk][1] = *reinterpret_cast<uint32_t*>(&v1);
    a[kk][2] = *reinterpret_cast<uint32_t*>(&v2);
    a[kk][3] = *reinterpret_cast<uint32_t*>(&v3);
  }
}

#define NTX_ACC4(a, j) \
  "+f"(a[j][0]), "+f"(a[j][1]), "+f"(a[j][2]), "+f"(a[j][3])
#define NTX_ACC32_AT(a, j)                                            \
  NTX_ACC4(a, j), NTX_ACC4(a, j + 1), NTX_ACC4(a, j + 2),             \
      NTX_ACC4(a, j + 3), NTX_ACC4(a, j + 4), NTX_ACC4(a, j + 5),     \
      NTX_ACC4(a, j + 6), NTX_ACC4(a, j + 7)
#define NTX_ACC32(a) NTX_ACC32_AT(a, 0)
#define NTX_ACC64(a) NTX_ACC32_AT(a, 0), NTX_ACC32_AT(a, 8)

// acc (64 x 64) (+)= A B^T for one k-step of 16: A (64 x 16) and B
// (64 x 16) both K-major in shared memory. scale_d 0 overwrites acc.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&acc)[8][4],
                                                   uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : NTX_ACC32(acc)
      : "l"(da), "l"(db), "r"(scale_d));
}

// ... the same with N = 32 (32 columns of B: half a 64-row tile).
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&acc)[4][4],
                                                   uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : NTX_ACC4(acc, 0), NTX_ACC4(acc, 1), NTX_ACC4(acc, 2), NTX_ACC4(acc, 3)
      : "l"(da), "l"(db), "r"(scale_d));
}
// S (64 x N) (+)= A B^T over one k-step for N = 32 or 64.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&acc)[N / 8][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 32)
    wgmma_m64n32k16_ss(acc, da, db, scale_d);
  else
    wgmma_m64n64k16_ss(acc, da, db, scale_d);
}

// acc (64 x N) += A B for one k-step of 16: A (64 x 16) from registers,
// B (16 x N) MN-major in shared memory (the transposed operand).
__device__ __forceinline__ void wgmma_m64n64k16_rs_t(float (&acc)[8][4],
                                                     const uint32_t (&a)[4],
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : NTX_ACC32(acc)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_m64n128k16_rs_t(float (&acc)[16][4],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : NTX_ACC64(acc)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_m64n192k16_rs_t(float (&acc)[24][4],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, "
      "%65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "
      "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, "
      "%91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : NTX_ACC64(acc), NTX_ACC32_AT(acc, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// The product of width D (64, 128 or 192: B spans D / 64 panels, the
// descriptor's lbo apart) of the above.
template <int D>
__device__ __forceinline__ void wgmma_rs_t(float (&acc)[D / 8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (D == 64)
    wgmma_m64n64k16_rs_t(acc, a, db);
  else if constexpr (D == 128)
    wgmma_m64n128k16_rs_t(acc, a, db);
  else
    wgmma_m64n192k16_rs_t(acc, a, db);
}

#undef NTX_ACC64
#undef NTX_ACC32
#undef NTX_ACC32_AT
#undef NTX_ACC4

}  // namespace ntx
