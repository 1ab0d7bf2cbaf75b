// NTX streaming GEMM with fused store epilogues, on Hopper.
//
// Replaces the TPU kernels repro/kernels/ntx_gemm.py:gemm_pallas
// (_gemm_kernel, with apply_epilogue run at the store step):
//   C = epilogue(A @ B), fp32 accumulator, one rounding at the store;
// and, with compensated = 1, _gemm_kernel_kahan (gemm_pallas(
// compensated=True)): the same with a Neumaier compensation term carried
// across k slabs and added before the epilogue.
// The Pallas kernel walks k as the sequential third grid axis with the
// accumulator in VMEM scratch; here the k loop runs inside the block and
// the accumulator lives in registers (the PCS wide accumulator), so no
// block ever waits on another.
//
// Bound on the H100 at the serving shapes:
//   * decode (m = 4, the batch): bytes. The weight matrix dominates:
//     4096 x 14336 bf16 is ~117 MB, ~35 us at 3.35 TB/s, against ~0.5
//     GFLOP of work (<1 us at the bf16 tensor-core rate).
//   * prefill (m = 128): about 15 GFLOP per MLP GEMM and the same
//     ~117 MB, near the ridge point of the bf16 tensor cores (~15 us
//     either way), so operations on FFMA units.
// Design: a simple shared-memory tiled kernel. A and B tiles are staged
// through shared memory as fp32 (bf16 widened with __bfloat162float),
// each thread keeps a TM x TN register tile of fp32 accumulators and
// runs IEEE fp32 FFMA (never TF32). Two tile shapes: 16 x 128 for small
// m (decode: less padding waste, more blocks across n) and 64 x 64
// otherwise. Ragged m/n/k edges are masked in the loads and the store;
// the host never pads. The ten epilogue stages run in the reference
// order on the fp32 accumulator in the store step, then the result is
// written once in the output dtype.
// Compensated variant (a compile-time switch of the same kernel): the
// FFMA accumulators collect one kKahanSlab-deep slab of k at a time as a
// partial product; at each slab's end every partial is Neumaier-added
// into two more register tiles, sum and comp, with __fadd_rn/__fsub_rn
// (no products in those terms, no contraction, never fast-math), and
// sum + comp enters the epilogue. The slab is fixed at 128, the default
// block_k of gemm_pallas, and kernels/ntx_gemm.py:gemm_kahan_plain
// compensates over the same slabs: the result depends on the slab width.
// Three register tiles instead of one; -Xptxas -v shows the spills.
// Left for later: wgmma on bf16 tiles fed by TMA through a multi-stage
// mbarrier ring (the tensor-core rate for prefill), vectorised 16-byte
// loads, and a split-k or persistent schedule so that decode's narrow
// grids fill all 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxEpilogue = 16;
constexpr int kThreads = 256;
constexpr int BK = 16;
constexpr int kKahanSlab = 128;   // kernels/ntx_gemm.py:KAHAN_SLAB
static_assert(kKahanSlab % BK == 0, "slabs end on a k step");

enum Kind { K_BIAS = 0, K_RESIDUAL, K_MUL, K_SUB, K_MASK, K_SCALE, K_RELU,
            K_THRESH, K_SILU, K_GELU };

struct Epilogue {
  int n;
  int kind[kMaxEpilogue];
  float imm[kMaxEpilogue];
  const float* op[kMaxEpilogue];   // fp32: (n,) for bias, else (m, n)
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float epilogue(float acc, const Epilogue& ep,
                                          int r, int c, int n) {
  const size_t at = (size_t)r * n + c;
  for (int s = 0; s < ep.n; ++s) {
    switch (ep.kind[s]) {
      case K_BIAS: acc = acc + ep.op[s][c]; break;
      case K_RESIDUAL: acc = acc + ep.op[s][at]; break;
      case K_MUL: acc = acc * ep.op[s][at]; break;
      case K_SUB: acc = acc - ep.op[s][at]; break;
      case K_MASK: acc = (ep.op[s][at] != 0.0f) ? acc : 0.0f; break;
      case K_SCALE: acc = acc * ep.imm[s]; break;
      case K_RELU: acc = fmaxf(acc, 0.0f); break;
      case K_THRESH: acc = (acc > ep.imm[s]) ? acc : 0.0f; break;
      case K_SILU: acc = acc * (1.0f / (1.0f + expf(-acc))); break;
      default: {   // K_GELU, tanh form (jax.nn.gelu's default)
        const float k0 = 0.7978845608028654f;   // sqrt(2/pi)
        acc = 0.5f * acc *
              (1.0f + tanhf(k0 * (acc + 0.044715f * acc * acc * acc)));
      }
    }
  }
  return acc;
}

// One Neumaier step: (s, c) += x, |s| >= |x| choosing the exact branch.
__device__ __forceinline__ void neumaier(float& s, float& c, float x) {
  const float t = __fadd_rn(s, x);
  const float d = fabsf(s) >= fabsf(x) ? __fadd_rn(__fsub_rn(s, t), x)
                                       : __fadd_rn(__fsub_rn(x, t), s);
  c = __fadd_rn(c, d);
  s = t;
}

// BM x BN output tile per block, TM x TN per thread, 256 threads; KAHAN
// compensates across kKahanSlab-deep slabs of k.
template <typename TI, typename TO, int BM, int BN, int TM, int TN,
          bool KAHAN>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const TI* __restrict__ A, const TI* __restrict__ B,
            TO* __restrict__ C, int M, int N, int K, Epilogue ep) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "thread tile");
  __shared__ float As[BK][BM + 4];      // A tile, transposed: As[kk][i]
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  constexpr int SM = KAHAN ? TM : 1, SN = KAHAN ? TN : 1;
  float acc[TM][TN], sum[SM][SN], comp[SM][SN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int i = 0; i < SM; ++i)
#pragma unroll
    for (int j = 0; j < SN; ++j) sum[i][j] = comp[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int i = e / BK, kk = e % BK;
      const int r = row0 + i, k = k0 + kk;
      As[kk][i] = (r < M && k < K) ? load(A + (size_t)r * K + k) : 0.0f;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int kk = e / BN, j = e % BN;
      const int k = k0 + kk, c = col0 + j;
      Bs[kk][j] = (k < K && c < N) ? load(B + (size_t)k * N + c) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (KAHAN && ((k0 + BK) % kKahanSlab == 0 || k0 + BK >= K)) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          neumaier(sum[i % SM][j % SN], comp[i % SM][j % SN], acc[i][j]);
          acc[i][j] = 0.0f;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      const float v = KAHAN ? __fadd_rn(sum[i % SM][j % SN],
                                         comp[i % SM][j % SN])
                            : acc[i][j];
      if (c < N) store(C + (size_t)r * N + c, epilogue(v, ep, r, c, N));
    }
  }
}

template <typename TI, typename TO, bool KAHAN>
void launch(const void* a, const void* b, void* c, int m, int n, int k,
            const Epilogue& ep, cudaStream_t s) {
  const TI* A = static_cast<const TI*>(a);
  const TI* B = static_cast<const TI*>(b);
  TO* C = static_cast<TO*>(c);
  if (m <= 16) {
    dim3 grid((n + 127) / 128, (m + 15) / 16);
    gemm_kernel<TI, TO, 16, 128, 2, 4, KAHAN><<<grid, kThreads, 0, s>>>(
        A, B, C, m, n, k, ep);
  } else {
    dim3 grid((n + 63) / 64, (m + 63) / 64);
    gemm_kernel<TI, TO, 64, 64, 4, 4, KAHAN><<<grid, kThreads, 0, s>>>(
        A, B, C, m, n, k, ep);
  }
}

template <typename TI, typename TO>
void launch(const void* a, const void* b, void* c, int m, int n, int k,
            bool compensated, const Epilogue& ep, cudaStream_t s) {
  if (compensated) launch<TI, TO, true>(a, b, c, m, n, k, ep, s);
  else launch<TI, TO, false>(a, b, c, m, n, k, ep, s);
}

}  // namespace

extern "C" {

// a (m, k), b (k, n), c (m, n): contiguous row-major on the device, a and
// b both fp32 (in_bf16 = 0) or both bf16; c fp32 or bf16 (out_bf16);
// compensated = 1 takes the Neumaier (Kahan) variant.
// kinds/imms/operands: host arrays of n_stages epilogue stages; each
// operand is a device pointer to contiguous fp32 ((n,) for bias, (m, n)
// for residual/mul/sub/mask), or null for the scalar kinds.
int ntx_gemm(const void* a, const void* b, void* c, int m, int n, int k,
             int in_bf16, int out_bf16, int compensated, int n_stages,
             const int* kinds, const float* imms,
             const void* const* operands, void* stream) {
  if (n_stages < 0 || n_stages > kMaxEpilogue || m < 0 || n < 0 || k < 0)
    return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return (int)cudaGetLastError();
  Epilogue ep;
  ep.n = n_stages;
  for (int s = 0; s < kMaxEpilogue; ++s) {
    ep.kind[s] = s < n_stages ? kinds[s] : K_SCALE;
    ep.imm[s] = s < n_stages ? imms[s] : 1.0f;
    ep.op[s] = s < n_stages ? static_cast<const float*>(operands[s])
                            : nullptr;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool kahan = compensated != 0;
  if (in_bf16) {
    if (out_bf16)
      launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, m, n, k, kahan, ep, s);
    else launch<__nv_bfloat16, float>(a, b, c, m, n, k, kahan, ep, s);
  } else {
    if (out_bf16) launch<float, __nv_bfloat16>(a, b, c, m, n, k, kahan, ep, s);
    else launch<float, float>(a, b, c, m, n, k, kahan, ep, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
