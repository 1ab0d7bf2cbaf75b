// NTX star-stencil pass (paper §III-B3) on Hopper.
//
// Replaces the TPU kernel repro/kernels/ntx_stencil.py:stencil1d_pallas
// (_stencil_kernel): a valid k-tap 1-D stencil, out[p] = sum_j c[j] *
// x[p + j], the taps in order over an fp32 accumulator. Star stencils
// (Laplace 1-D/2-D/3-D) decompose into one such pass per axis, "as NTX
// executes them". The Pallas kernel runs along the last axis of a
// (rows, n) array, so its wrapper moves the axis last and reshapes,
// which copies for every axis but the last; this kernel takes a
// contiguous (outer, n, inner) block and runs along n, so any axis of a
// contiguous array is a view.
//
// Bound on the H100: bytes. A 3-tap pass does 6 operations per output
// and reads and writes 8 bytes (a 512^3 fp32 volume: ~1.07 GB, ~0.32 ms
// at 3.35 TB/s, against ~0.01 ms of fp32 operations).
// Design: a 256-thread block covers a tile of outputs, TQ = the largest
// power of two <= min(inner, 32) along inner and 256 / TQ rows along n,
// each thread R <= 4 rows of them. A warp reads 32 neighbouring
// addresses (along inner, or along n when inner is 1), so every load is
// coalesced; the k reads of one value by neighbouring outputs hit L1,
// so the plane comes from device memory about once. The taps come in as
// a device array read with uniform (broadcast) loads: any k works. Tiles
// past the ragged edges of n - k + 1 and inner are masked.
// Exactness: every product is rounded by __fmul_rn before __fadd_rn adds
// it, so nvcc cannot contract them into an FMA and the result is
// bit-equal to the plain version (kernels/ntx_stencil.py:stencil1d_plain).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxR = 4;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil_kernel(const T* __restrict__ x, const float* __restrict__ coef,
               float* __restrict__ out, int n, long long inner, int k,
               int tq_log2, int R, unsigned p_tiles, unsigned q_tiles) {
  const int on = n - k + 1;
  const int TQ = 1 << tq_log2;
  const int rows = kThreads >> tq_log2;
  // 32-bit (block-uniform) index arithmetic: the grid has < 2^31 blocks
  unsigned b = blockIdx.x;
  const unsigned qt = b % q_tiles;
  b /= q_tiles;
  const int pt = (int)(b % p_tiles);
  const size_t o = b / p_tiles;
  const long long q = (long long)qt * TQ + (threadIdx.x & (TQ - 1));
  if (q >= inner) return;
  const int tp = threadIdx.x >> tq_log2;
  const T* xo = x + o * n * inner + q;
  float* oo = out + o * on * inner + q;
#pragma unroll 1
  for (int r = 0; r < R; ++r) {
    const int p = pt * rows * R + tp + rows * r;
    if (p >= on) break;
    const T* xp = xo + (size_t)p * inner;
    // the first product starts the sum, as in the reference's oracle
    float acc = __fmul_rn(__ldg(coef), load(xp));
    for (int j = 1; j < k; ++j)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(coef + j),
                                     load(xp + (size_t)j * inner)));
    oo[(size_t)p * inner] = acc;
  }
}

}  // namespace

extern "C" {

// x (outer, n, inner) contiguous fp32 (in_bf16 = 0) or bf16; coef (k,)
// fp32; out (outer, n - k + 1, inner) contiguous fp32; all on the device.
int ntx_stencil(const void* x, const void* coef, void* out, long long outer,
                int n, long long inner, int k, int in_bf16, void* stream) {
  if (k < 1 || k > n || outer < 0 || inner < 0)
    return (int)cudaErrorInvalidValue;
  if (outer == 0 || inner == 0) return (int)cudaGetLastError();
  const int on = n - k + 1;
  int tq_log2 = 0;
  while (tq_log2 < 5 && (2LL << tq_log2) <= inner) ++tq_log2;
  const int rows = kThreads >> tq_log2;
  int R = (on + rows - 1) / rows;
  R = R < 1 ? 1 : (R > kMaxR ? kMaxR : R);
  const int p_tiles = (on + rows * R - 1) / (rows * R);
  const long long q_tiles = (inner + (1 << tq_log2) - 1) >> tq_log2;
  const long long blocks = outer * p_tiles * q_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* C = static_cast<const float*>(coef);
  float* O = static_cast<float*>(out);
  if (in_bf16)
    stencil_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), C, O, n, inner, k, tq_log2, R,
        (unsigned)p_tiles, (unsigned)q_tiles);
  else
    stencil_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), C, O, n, inner, k, tq_log2, R,
        (unsigned)p_tiles, (unsigned)q_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
