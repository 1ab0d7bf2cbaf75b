// NTX star stencils (paper §III-B3) on Hopper: the per-axis pass and the
// fused Laplace.
//
// Replaces the TPU kernel repro/kernels/ntx_stencil.py:stencil1d_pallas
// (_stencil_kernel): a valid k-tap 1-D stencil, out[p] = sum_j c[j] *
// x[p + j], the taps in order over an fp32 accumulator. Star stencils
// (Laplace 1-D/2-D/3-D) decompose into one such pass per axis, "as NTX
// executes them" (repro/kernels/ops.py:laplace runs the passes over the
// slices interior on the other axes and sums them in axis order).
//
// Bound on the H100: bytes. A 3-tap pass does 6 operations per output
// and reads and writes 8 bytes (a 512^3 fp32 volume: ~1.07 GB, ~0.32 ms
// at 3.35 TB/s). Both kernels read each input value from device memory
// about once and take its neighbours from registers or L1.
//
// ntx_stencil, the pass along the middle axis of a contiguous (outer, n,
// inner) block (any axis of a contiguous array is such a view). Each
// thread computes R = 8 independent outputs; the taps loop runs outside
// the R outputs, so every tap issues R loads at once.
// - inner > 1: a 256-thread block covers TQ positions along inner (a
//   warp reads neighbouring addresses) and 256 / TQ rows along n, each
//   thread R rows 256 / TQ apart. When inner is a multiple of 4 and the
//   block is aligned, a thread takes 4 neighbouring positions with one
//   16-byte (fp32) or 8-byte (bf16) load.
// - inner == 1: the (outer, n - k + 1) outputs are one flat run; lane i
//   of the block owns outputs i, i + 256, ..., so a warp reads 32
//   neighbouring values for every tap and the k shifted reads hit L1.
// ntx_laplace, the whole Laplace of a contiguous 1-D, 2-D or 3-D array
// in one launch: it reads x once and writes the interior once, where the
// per-axis route copied each interior slice, wrote one fp32 term per axis
// and added the terms with separate passes (8-9x the bytes in 3-D). For
// each interior point it computes every axis's pass term as the pass
// does, t_d = (1 x[-1_d] + -2 x[0]) + 1 x[+1_d], and sums (t_0 + t_1) +
// t_2: the per-axis decomposition and its order, inside the kernel.
// - 3-D, the 2.5-D scheme: a 64 x 4 block owns a (y, x) tile and marches
//   along axis 0 over kRun3 = 4 planes, keeping planes z-1, z, z+1 of its
//   column in a register ring; the y and x neighbours are the values the
//   block's other lanes and warps load, so they come from L1. Blocks run
//   x tiles first, then y tiles, then z runs, so the two planes a run
//   shares with the next come from L2. Of the run lengths and tile widths
//   tried, short runs of wide tiles kept the most loads in flight.
// - 2-D: a 256-wide row segment marches along axis 0 over kRun2 = 8 rows
//   in the same way; 1-D: 8 outputs per thread, the shifted reads from
//   L1.
// - Full runs are unrolled with no tests, so their loads issue together;
//   ragged edges are masked.
// Exactness: every product is rounded by __fmul_rn before __fadd_rn adds
// it, so nvcc cannot contract them into an FMA; each output adds its
// taps in order, the first product starting the sum. Both kernels are
// bit-equal to their plain versions (kernels/ntx_stencil.py:
// stencil1d_plain and laplace_plain).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kR = 8;         // outputs per thread of the pass
constexpr int kRun2 = 8;      // rows per 2-D Laplace run
constexpr int kRun3 = 4;      // planes per 3-D Laplace run
constexpr int kLap1 = 8;      // outputs per thread of the 1-D Laplace
constexpr int kTileX = 64;    // x extent of a 3-D Laplace block's tile

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  const unsigned short b = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float((unsigned)b << 16);
}

// four neighbouring values: one 16-byte (fp32) or 8-byte (bf16) load
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}

// ---------------------------------------------------------------------
// the per-axis pass
// ---------------------------------------------------------------------
// one tap over V outputs; the first tap starts the sums
template <bool First, int V>
__device__ __forceinline__ void tap(float (&acc)[V], const float (&v)[V],
                                    float c) {
#pragma unroll
  for (int e = 0; e < V; ++e)
    acc[e] = First ? __fmul_rn(c, v[e])
                   : __fadd_rn(acc[e], __fmul_rn(c, v[e]));
}

template <typename T, int V>
__device__ __forceinline__ void load_v(const T* p, float (&v)[V]) {
  if constexpr (V == 4) load4(p, v);
  else v[0] = load(p);
}

// inner > 1; V = 4 takes four positions along inner per thread
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
stencil_tile_kernel(const T* __restrict__ x, const float* __restrict__ coef,
                    float* __restrict__ out, int n, long long inner, int k,
                    int tq_log2, unsigned p_tiles, unsigned q_tiles) {
  const int on = n - k + 1;
  const int rows = kThreads >> tq_log2;
  // 32-bit (block-uniform) index arithmetic: the grid has < 2^31 blocks
  unsigned b = blockIdx.x;
  const unsigned qt = b % q_tiles;
  b /= q_tiles;
  const int pt = (int)(b % p_tiles);
  const size_t o = b / p_tiles;
  const long long q =
      ((long long)qt * (1 << tq_log2) + (threadIdx.x & ((1 << tq_log2) - 1)))
      * V;
  if (q >= inner) return;
  const int p0 = pt * rows * kR + (threadIdx.x >> tq_log2);
  const T* xo = x + o * n * inner + q;
  // tap j of the R outputs (R loads issued together)
  float acc[kR][V];
  auto taps = [&](int j, auto first) {
    const float c = __ldg(coef + j);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int p = p0 + r * rows;
      if (p < on) {
        float v[V];
        load_v(xo + (size_t)(p + j) * inner, v);
        tap<decltype(first)::value>(acc[r], v, c);
      }
    }
  };
  taps(0, std::true_type{});
  for (int j = 1; j < k; ++j) taps(j, std::false_type{});
  float* oo = out + o * on * inner + q;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int p = p0 + r * rows;
    if (p >= on) break;
    float* dst = oo + (size_t)p * inner;
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    else
      *dst = acc[r][0];
  }
}

// inner == 1: the outputs are one flat run of outer * on
template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil_rows_kernel(const T* __restrict__ x, const float* __restrict__ coef,
                    float* __restrict__ out, long long total, int n, int on,
                    int k, int step_o, int step_p) {
  const long long e0 = (long long)blockIdx.x * (kThreads * kR) + threadIdx.x;
  if (e0 >= total) return;
  long long o = e0 / on;
  int p = (int)(e0 - o * on);
  size_t src[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {      // output e0 + 256 r reads x[o n + p]
    src[r] = (size_t)o * n + p;
    p += step_p;
    o += step_o;
    if (p >= on) { p -= on; ++o; }
  }
  float acc[kR][1];
  auto taps = [&](int j, auto first) {
    const float c = __ldg(coef + j);
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (e0 + (long long)r * kThreads < total) {
        const float v[1] = {load(x + src[r] + j)};
        tap<decltype(first)::value>(acc[r], v, c);
      }
  };
  taps(0, std::true_type{});
  for (int j = 1; j < k; ++j) taps(j, std::false_type{});
#pragma unroll
  for (int r = 0; r < kR; ++r)
    if (e0 + (long long)r * kThreads < total)
      out[e0 + (long long)r * kThreads] = acc[r][0];
}

// ---------------------------------------------------------------------
// the fused Laplace
// ---------------------------------------------------------------------
// one axis's [1, -2, 1] pass term, m2 = -2 * centre already rounded
__device__ __forceinline__ float term(float lo, float m2, float hi) {
  return __fadd_rn(__fadd_rn(__fmul_rn(1.0f, lo), m2), __fmul_rn(1.0f, hi));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
laplace1d_kernel(const T* __restrict__ x, float* __restrict__ out,
                 long long m) {
  const long long e0 =
      (long long)blockIdx.x * (kThreads * kLap1) + threadIdx.x;
  if (e0 + (long long)(kLap1 - 1) * kThreads < m) {
#pragma unroll
    for (int r = 0; r < kLap1; ++r) {
      const long long e = e0 + (long long)r * kThreads;
      out[e] = term(load(x + e), __fmul_rn(-2.0f, load(x + e + 1)),
                    load(x + e + 2));
    }
  } else {
    for (int r = 0; r < kLap1; ++r) {
      const long long e = e0 + (long long)r * kThreads;
      if (e >= m) break;
      out[e] = term(load(x + e), __fmul_rn(-2.0f, load(x + e + 1)),
                    load(x + e + 2));
    }
  }
}

// the ring step of the 2-D march: centre row q, output row o0
template <typename T>
__device__ __forceinline__ void lap2_row(const T* q, long long n1, float* dst,
                                         float& up, float& mid) {
  const float dn = load(q + n1);
  const float m2 = __fmul_rn(-2.0f, mid);
  const float t0 = term(up, m2, dn);
  const float t1 = term(load(q - 1), m2, load(q + 1));
  *dst = __fadd_rn(t0, t1);
  up = mid;
  mid = dn;
}

// (n0, n1): a 256-wide run of interior columns marches down kRun2 rows
template <typename T>
__global__ void __launch_bounds__(kThreads)
laplace2d_kernel(const T* __restrict__ x, float* __restrict__ out, int n0,
                 int n1, unsigned x_tiles) {
  const int m0 = n0 - 2, m1 = n1 - 2;
  const unsigned xt = blockIdx.x % x_tiles;
  const int z0 = (int)(blockIdx.x / x_tiles) * kRun2;
  const int o1 = (int)xt * kThreads + threadIdx.x;
  if (o1 >= m1) return;
  // input row z0 is the upper neighbour of output row z0
  const T* p = x + (size_t)z0 * n1 + (o1 + 1);
  float* d = out + (size_t)z0 * m1 + o1;
  float up = load(p), mid = load(p + n1);
  if (z0 + kRun2 <= m0) {
#pragma unroll
    for (int r = 0; r < kRun2; ++r)
      lap2_row(p + (size_t)(r + 1) * n1, n1, d + (size_t)r * m1, up, mid);
  } else {
    for (int r = 0; z0 + r < m0; ++r)
      lap2_row(p + (size_t)(r + 1) * n1, n1, d + (size_t)r * m1, up, mid);
  }
}

template <typename T>
__device__ __forceinline__ void lap3_plane(const T* q, size_t s0, int n2,
                                           float* dst, float& back,
                                           float& mid) {
  const float front = load(q + s0);
  const float m2 = __fmul_rn(-2.0f, mid);
  const float t0 = term(back, m2, front);
  const float t1 = term(load(q - n2), m2, load(q + n2));
  const float t2 = term(load(q - 1), m2, load(q + 1));
  *dst = __fadd_rn(__fadd_rn(t0, t1), t2);
  back = mid;
  mid = front;
}

// (n0, n1, n2): a kTileX x (256 / kTileX) (x, y) tile marches along axis 0
// over kRun3 planes
template <typename T>
__global__ void __launch_bounds__(kThreads)
laplace3d_kernel(const T* __restrict__ x, float* __restrict__ out, int n0,
                 int n1, int n2, unsigned x_tiles, unsigned y_tiles) {
  const int m0 = n0 - 2, m1 = n1 - 2, m2 = n2 - 2;
  unsigned b = blockIdx.x;
  const unsigned xt = b % x_tiles;
  b /= x_tiles;
  const unsigned yt = b % y_tiles;
  const int z0 = (int)(b / y_tiles) * kRun3;
  const int o2 = (int)xt * kTileX + (threadIdx.x % kTileX);
  const int o1 = (int)yt * (kThreads / kTileX) + (threadIdx.x / kTileX);
  if (o2 >= m2 || o1 >= m1) return;
  const size_t s0 = (size_t)n1 * n2, d0 = (size_t)m1 * m2;
  const T* p = x + (size_t)z0 * s0 + (size_t)(o1 + 1) * n2 + (o2 + 1);
  float* d = out + (size_t)z0 * d0 + (size_t)o1 * m2 + o2;
  float back = load(p), mid = load(p + s0);
  if (z0 + kRun3 <= m0) {
#pragma unroll
    for (int r = 0; r < kRun3; ++r)
      lap3_plane(p + (r + 1) * s0, s0, n2, d + r * d0, back, mid);
  } else {
    for (int r = 0; z0 + r < m0; ++r)
      lap3_plane(p + (r + 1) * s0, s0, n2, d + r * d0, back, mid);
  }
}

template <typename T>
int launch_laplace(const T* x, float* out, int nd, long long n0,
                   long long n1, long long n2, cudaStream_t s) {
  if (nd == 1) {
    const long long m = n0 - 2;
    const long long blocks = (m + kThreads * kLap1 - 1) / (kThreads * kLap1);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    laplace1d_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(x, out, m);
  } else if (nd == 2) {
    if (n0 > 0x7fffffffLL || n1 > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    const long long xt = (n1 - 2 + kThreads - 1) / kThreads;
    const long long blocks = xt * ((n0 - 2 + kRun2 - 1) / kRun2);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    laplace2d_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
        x, out, (int)n0, (int)n1, (unsigned)xt);
  } else {
    if (n0 > 0x7fffffffLL || n1 > 0x7fffffffLL || n2 > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    const long long xt = (n2 - 2 + kTileX - 1) / kTileX;
    const long long yt =
        (n1 - 2 + kThreads / kTileX - 1) / (kThreads / kTileX);
    const long long blocks = xt * yt * ((n0 - 2 + kRun3 - 1) / kRun3);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    laplace3d_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
        x, out, (int)n0, (int)n1, (int)n2, (unsigned)xt, (unsigned)yt);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_stencil(const T* x, const float* coef, float* out,
                   long long outer, int n, long long inner, int k,
                   cudaStream_t s) {
  const int on = n - k + 1;
  if (inner == 1) {
    const long long total = outer * on;
    const long long blocks =
        (total + kThreads * kR - 1) / (kThreads * kR);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    stencil_rows_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
        x, coef, out, total, n, on, k, kThreads / on, kThreads % on);
    return (int)cudaGetLastError();
  }
  const size_t align = sizeof(T) * 4;
  const bool vec = inner % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % align == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long units = vec ? inner / 4 : inner;
  int tq_log2 = 0;
  while (tq_log2 < 5 && (2LL << tq_log2) <= units) ++tq_log2;
  const int rows = kThreads >> tq_log2;
  const long long p_tiles = (on + rows * kR - 1) / (rows * kR);
  const long long q_tiles = (units + (1 << tq_log2) - 1) >> tq_log2;
  const long long blocks = outer * p_tiles * q_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (vec)
    stencil_tile_kernel<T, 4><<<(unsigned)blocks, kThreads, 0, s>>>(
        x, coef, out, n, inner, k, tq_log2, (unsigned)p_tiles,
        (unsigned)q_tiles);
  else
    stencil_tile_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, s>>>(
        x, coef, out, n, inner, k, tq_log2, (unsigned)p_tiles,
        (unsigned)q_tiles);
  return (int)cudaGetLastError();
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* C = static_cast<const float*>(coef);
  float* O = static_cast<float*>(out);
  if (in_bf16)
    return launch_stencil(static_cast<const __nv_bfloat16*>(x), C, O, outer,
                          n, inner, k, s);
  return launch_stencil(static_cast<const float*>(x), C, O, outer, n, inner,
                        k, s);
}

// x: a contiguous nd-D (nd = 1, 2, 3) fp32 (in_bf16 = 0) or bf16 array of
// shape (n0[, n1[, n2]]); out: its interior, (n0 - 2[, n1 - 2[, n2 - 2]])
// contiguous fp32. Nothing is launched when an axis is shorter than 3.
int ntx_laplace(const void* x, void* out, int nd, long long n0,
                long long n1, long long n2, int in_bf16, void* stream) {
  if (nd < 1 || nd > 3) return (int)cudaErrorInvalidValue;
  if (n0 < 3 || (nd > 1 && n1 < 3) || (nd > 2 && n2 < 3))
    return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* O = static_cast<float*>(out);
  if (in_bf16)
    return launch_laplace(static_cast<const __nv_bfloat16*>(x), O, nd, n0,
                          n1, n2, s);
  return launch_laplace(static_cast<const float*>(x), O, nd, n0, n1, n2, s);
}

}  // extern "C"
