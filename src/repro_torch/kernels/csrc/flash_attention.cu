// Flash attention forward (online softmax) on Hopper.
//
// Replaces the TPU kernel
// repro/kernels/flash_attention.py:flash_attention_pallas (_flash_kernel):
// the NTX MAX reduction (running row max) and MAC reduction (running
// exp-weighted sums) over the key stream, accumulator initialised at the
// start of the stream and written back once at its end.
//
// Semantics kept from the reference kernel: GQA head map h // g; the
// runtime kv_len is a kernel argument; the causal query position is
// kv_len - sq + i; masked logits are set to -1e30 (not -inf), so the
// running max, the correction exp(m_prev - m_new) and the final guard
// (l == 0 -> 1) behave exactly as in the reference.
//
// Bound on the H100 at the serving shapes (b = 4, hq = 32, hkv = 8,
// d = 128): bytes. A decode step (sq = 1) reads the whole bf16 K/V cache
// once, 2 * b * hkv * skv * d * 2 bytes, against 4 * b * hq * skv * d
// flops, about 4 flop/byte; prefill (sq = skv = 32) is tiny either way,
// so launch latency dominates both at this sequence length.
//
// Design: one block per (b*hq, tile of BQ = 16 queries), 4 warps; warp w
// owns query rows w, w+4, w+8, w+12 of the tile. K and V tiles of
// BK = 32 keys are staged in shared memory as fp32 (K row-padded to
// avoid bank conflicts); lane j of a warp computes the logit of key j
// for each of the warp's rows, the row max and sum are warp shuffles,
// and each lane keeps D/32 output columns per row in registers. m, l and
// acc are fp32. Any sq and skv are handled with masks: keys past the
// end of the array contribute nothing, keys past kv_len or after the
// causal position are -1e30 as in the reference.
// Left for later: one block per kv head serving all g = hq/hkv query
// heads (decode re-reads each K/V tile g times today), wgmma for QK^T
// and PV at long prefill lengths, and TMA double buffering of K/V.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 16;
constexpr int BK = 32;
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = BQ / kWarps;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
             int sq, int skv, int kv_len, int causal, float scale) {
  constexpr int NC = D / 32;              // output columns per lane
  __shared__ float Qs[BQ][D];
  __shared__ float Ks[BK][D + 1];
  __shared__ float Vs[BK][D];

  const int bh = blockIdx.y;              // b * hq + h
  const int b = bh / hq, h = bh % hq;
  const int kvh = b * hkv + h / (hq / hkv);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const T* qb = q + (size_t)bh * sq * D;
  const T* kb = k + (size_t)kvh * skv * D;
  const T* vb = v + (size_t)kvh * skv * D;

  for (int e = tid; e < BQ * D; e += kWarps * 32) {
    const int i = e / D, d = e % D;
    Qs[i][d] = (q0 + i < sq) ? load(qb + (size_t)(q0 + i) * D + d) : 0.0f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.0f;
  }

  for (int t0 = 0; t0 < skv; t0 += BK) {
    __syncthreads();                      // previous tile fully consumed
    for (int e = tid; e < BK * D; e += kWarps * 32) {
      const int j = e / D, d = e % D;
      const bool in = t0 + j < skv;
      Ks[j][d] = in ? load(kb + (size_t)(t0 + j) * D + d) : 0.0f;
      Vs[j][d] = in ? load(vb + (size_t)(t0 + j) * D + d) : 0.0f;
    }
    __syncthreads();

    const int kpos = t0 + lane;
    const bool in_array = kpos < skv;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = warp + r * kWarps;    // row within the tile
      float s = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(Qs[i][d], Ks[lane][d], s);
      s *= scale;
      bool valid = kpos < kv_len;
      if (causal) valid = valid && (kpos <= kv_len - sq + q0 + i);
      if (!valid) s = kNegInf;
      // keys past the end of the array are not keys at all: excluded
      // from the max and given weight 0
      float mx = in_array ? s : -INFINITY;
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float p = in_array ? expf(s - m_new) : 0.0f;
      float ps = p;
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      const float corr = expf(m[r] - m_new);
      l[r] = corr * l[r] + ps;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[r][c] = fmaf(pj, Vs[j][lane + 32 * c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = q0 + warp + r * kWarps;
    if (i >= sq) continue;
    const float denom = (l[r] == 0.0f) ? 1.0f : l[r];
    T* orow = o + ((size_t)bh * sq + i) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(orow + lane + 32 * c, acc[r][c] / denom);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int skv, int d, int kv_len, int causal,
           float scale, cudaStream_t s) {
  dim3 grid((sq + BQ - 1) / BQ, b * hq), block(kWarps * 32);
  const T* Q = static_cast<const T*>(q);
  const T* K = static_cast<const T*>(k);
  const T* V = static_cast<const T*>(v);
  T* O = static_cast<T*>(o);
  switch (d) {
    case 64:
      flash_kernel<T, 64><<<grid, block, 0, s>>>(Q, K, V, O, hq, hkv, sq, skv,
                                                 kv_len, causal, scale);
      break;
    case 128:
      flash_kernel<T, 128><<<grid, block, 0, s>>>(Q, K, V, O, hq, hkv, sq,
                                                  skv, kv_len, causal, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (b, hq, sq, d), k/v (b, hkv, skv, d), o like q: contiguous on the
// device, all fp32 (bf16 = 0) or all bf16. hq % hkv == 0, d in {64, 128}.
int ntx_flash_attention(const void* q, const void* k, const void* v, void* o,
                        int b, int hq, int hkv, int sq, int skv, int d,
                        int kv_len, int causal, float scale, int bf16,
                        void* stream) {
  if (b < 0 || hq <= 0 || hkv <= 0 || hq % hkv || sq < 0 || skv < 0)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, skv, d, kv_len,
                                 causal, scale, s);
  return launch<float>(q, k, v, o, b, hq, hkv, sq, skv, d, kv_len, causal,
                       scale, s);
}

}  // extern "C"
