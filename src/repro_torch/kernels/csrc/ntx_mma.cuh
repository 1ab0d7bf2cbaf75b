// Warp-level bf16 tensor-core helpers for sm_80 and later (mma.sync and
// ldmatrix), and the exact split of an fp32 value into three bf16 parts.
//
// Fragments are those of mma.sync.m16n8k16.row.col with bf16 inputs and
// fp32 accumulators. With g = lane / 4 and q = lane % 4:
//   A (16 x 16, row-major), four 32-bit registers of two bf16 each:
//     a[0] = A[g][2q..2q+1],   a[1] = A[g+8][2q..2q+1],
//     a[2] = A[g][2q+8..+9],   a[3] = A[g+8][2q+8..+9]
//   B (16 x 8), two registers: b0 = B[2q..2q+1][g], b1 = B[2q+8..+9][g]
//   C (16 x 8, fp32): c[0..1] = C[g][2q..2q+1], c[2..3] = C[g+8][2q..2q+1]
// The lower 16 bits of a register hold the element of lower index.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ntx {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of
// each matrix, in r[0..3].
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same with each matrix transposed: lane l receives rows 2 (l % 4)
// and 2 (l % 4) + 1 of column l / 4.
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += A B for one 16x8x16 tile: products exact, sums in fp32.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// v0 and v1 as three bf16x2 words with v = hi + mid + lo exactly: each
// part takes the next 8 significant bits of the fp32 value, and each
// remainder is exact in fp32. So a product of a bf16 value with the
// three parts, summed in fp32, is the product with the fp32 value.
__device__ __forceinline__ void split3x2(float v0, float v1, uint32_t out[3]) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(hi);
  const float r0 = __fsub_rn(v0, hf.x), r1 = __fsub_rn(v1, hf.y);
  const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(mid);
  const __nv_bfloat162 lo =
      __floats2bfloat162_rn(__fsub_rn(r0, mf.x), __fsub_rn(r1, mf.y));
  out[0] = bits(hi);
  out[1] = bits(mid);
  out[2] = bits(lo);
}

}  // namespace ntx
