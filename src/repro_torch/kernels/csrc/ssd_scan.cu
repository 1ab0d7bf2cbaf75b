// Mamba-2 SSD (state-space duality) chunked scan on Hopper.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:ssd_scan_pallas
// (_ssd_kernel): the NTX generalized reduction at chunk granularity. The
// recurrent state S (d_state x d_head, fp32) is the wide accumulator,
// initialised once per sequence and updated once per chunk:
//   y_t = sum_{s<=t} exp(la_t - la_s) (C_t . B_s) dt_s x_s
//         + exp(la_t) C_t . S                          (intra + carried)
//   S  <- exp(la_L) S + sum_s exp(la_L - la_s) dt_s B_s (x) x_s
// with la the inclusive cumulative sum of dt * A inside the chunk.
//
// Layouts are the model's, so the wrapper copies nothing: x and y
// (b, l, h, dh), dt (b, l, h) fp32, A (h,) fp32, B and C (b, l, n) read
// per batch index (the Pallas wrapper broadcast them per head first).
// x, B, C and y are all fp32 or all bf16; everything inside is fp32.
//
// Bound on the H100 at the training shapes (b 8, l 1024, h 64, dh 64,
// n 128, chunk 128): operations. A chunk of one sequence needs about
// 2 L^2 n + 2 L^2 dh + 4 L n dh ~ 10.5 MFLOP (half of the L^2 terms are
// masked away) against ~L (2n + 2dh) * 2 bytes read, well above the
// ~20 flop/byte at which fp32 FFMA leaves the memory bound.
//
// Design (simple first): one block of 512 threads per (head, batch)
// sequence; the chunk loop is sequential inside the block, which replaces
// the Pallas "arbitrary" grid axis, and S stays in shared memory across
// chunks (the Pallas VMEM scratch). Per chunk, shared memory holds B
// (rows padded to n + 1 floats, so a warp reading 32 rows of one column
// hits 32 banks), dt_s * x_s, S, and a 16-row slab of C and of the
// weights W[t][s] = exp(la_t - la_s) (C_t . B_s). W is never materialised
// for the whole chunk: y is formed one 16-row slab at a time (one row per
// warp), so at n 128, dh 64, chunk 128 the block uses 149.5 KB and the
// fp32 and bf16 inputs share one code path. Only s <= t terms are
// evaluated, so exp never sees a positive exponent (the reference's
// jnp chunked form takes exp of every (t, s) pair and then masks,
// which overflows to inf * 0 = NaN at chunk 128). A ragged last chunk
// (l % chunk != 0) is masked, not padded. Left for later: bf16 operands
// on the tensor cores (mma/wgmma for C.B^T, W.X, C.S and B^T.X), and
// more than one block per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = kWarps;             // rows of y per slab: one per warp
constexpr int kMaxChunk = 128;            // lane owns s = lane + 32 j, j < 4
constexpr int kMaxCols = 4;               // lane owns d = lane + 32 c, c < 4
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

size_t smem_floats(int n, int dh, int chunk) {
  return (size_t)chunk * (n + 1)          // B, padded rows
         + (size_t)chunk * dh             // dt_s * x_s
         + (size_t)n * dh                 // S
         + (size_t)kSlab * n              // C slab
         + (size_t)kSlab * chunk          // W slab
         + 2 * (size_t)chunk;             // la, exp(la_L - la_s)
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ B,
           const T* __restrict__ C, T* __restrict__ y, int l, int H, int dh,
           int n, int chunk) {
  extern __shared__ float smem[];
  const int nb = n + 1;
  float* Bs = smem;                       // chunk x (n + 1)
  float* Xs = Bs + (size_t)chunk * nb;    // chunk x dh
  float* Ss = Xs + (size_t)chunk * dh;    // n x dh
  float* Cs = Ss + (size_t)n * dh;        // kSlab x n
  float* Ws = Cs + (size_t)kSlab * n;     // kSlab x chunk
  float* la = Ws + (size_t)kSlab * chunk; // chunk
  float* wl = la + chunk;                 // chunk

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float a = A[h];
  const size_t row0 = (size_t)b * l;      // first (b, t) row

  for (int e = tid; e < n * dh; e += kThreads) Ss[e] = 0.0f;

  for (int c0 = 0; c0 < l; c0 += chunk) {
    const int L = min(chunk, l - c0);
    __syncthreads();                      // last chunk's state update done
    for (int e = tid; e < L * n; e += kThreads) {
      const int s = e / n, k = e % n;
      Bs[s * nb + k] = load(B + (row0 + c0 + s) * n + k);
    }
    for (int e = tid; e < L * dh; e += kThreads) {
      const int s = e / dh, d = e % dh;
      const size_t r = (row0 + c0 + s) * H + h;
      Xs[s * dh + d] = __fmul_rn(dt[r], load(x + r * dh + d));
    }
    // inclusive cumulative log-decay, summed in sequence order
    for (int t = tid; t < L; t += kThreads) {
      float acc = 0.0f;
      for (int s = 0; s <= t; ++s)
        acc = __fadd_rn(acc, __fmul_rn(dt[(row0 + c0 + s) * H + h], a));
      la[t] = acc;
    }
    __syncthreads();
    const float la_last = la[L - 1];
    for (int s = tid; s < L; s += kThreads) wl[s] = expf(la_last - la[s]);

    for (int r0 = 0; r0 < L; r0 += kSlab) {
      const int nr = min(kSlab, L - r0);
      for (int e = tid; e < nr * n; e += kThreads) {
        const int r = e / n, k = e % n;
        Cs[r * n + k] = load(C + (row0 + c0 + r0 + r) * n + k);
      }
      __syncthreads();
      const int r = warp, t = r0 + warp;  // this warp's row
      if (r < nr) {
        // W[r][s] for s <= t: lane owns s = lane + 32 j
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const int jn = t / 32 + 1;        // warp-uniform
        for (int k = 0; k < n; ++k) {
          const float c = Cs[r * n + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = lane + 32 * j;
            if (j < jn && s <= t) acc[j] = fmaf(c, Bs[s * nb + k], acc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = lane + 32 * j;
          if (s < L) Ws[r * chunk + s] = (s <= t)
              ? expf(la[t] - la[s]) * acc[j] : 0.0f;
        }
      }
      __syncwarp();                       // a warp reads only its own W row
      if (r < nr) {
        float yi[kMaxCols] = {0.0f, 0.0f, 0.0f, 0.0f};
        float ys[kMaxCols] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int s = 0; s <= t; ++s) {
          const float w = Ws[r * chunk + s];
#pragma unroll
          for (int c = 0; c < kMaxCols; ++c) {
            const int d = lane + 32 * c;
            if (d < dh) yi[c] = fmaf(w, Xs[s * dh + d], yi[c]);
          }
        }
        for (int k = 0; k < n; ++k) {
          const float cv = Cs[r * n + k];
#pragma unroll
          for (int c = 0; c < kMaxCols; ++c) {
            const int d = lane + 32 * c;
            if (d < dh) ys[c] = fmaf(cv, Ss[k * dh + d], ys[c]);
          }
        }
        const float e = expf(la[t]);
        T* yrow = y + ((row0 + c0 + t) * H + h) * dh;
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) {
          const int d = lane + 32 * c;
          if (d < dh) store(yrow + d, yi[c] + e * ys[c]);
        }
      }
      __syncthreads();                    // slab consumed: Cs/Ws reusable
    }

    // state update: warp owns rows k = warp + kWarps i of S
    const float dec = expf(la_last);
    for (int k = warp; k < n; k += kWarps) {
      float acc[kMaxCols] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int s = 0; s < L; ++s) {
        const float wb = wl[s] * Bs[s * nb + k];
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) {
          const int d = lane + 32 * c;
          if (d < dh) acc[c] = fmaf(wb, Xs[s * dh + d], acc[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int d = lane + 32 * c;
        if (d < dh) Ss[k * dh + d] = fmaf(dec, Ss[k * dh + d], acc[c]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, int b, int l, int h, int dh, int n,
           int chunk, cudaStream_t s) {
  const size_t bytes = smem_floats(n, dh, chunk) * sizeof(float);
  if (bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(h, b), block(kThreads);
  ssd_kernel<T><<<grid, block, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), l, h, dh, n, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y (b, l, h, dh); dt (b, l, h) fp32; A (h,) fp32; B, C (b, l, n):
// contiguous on the device; x, B, C, y all fp32 (bf16 = 0) or all bf16.
// 1 <= chunk <= 128, dh <= 128, and the shared memory of one block
// (smem_floats * 4 bytes) at most 227 KB.
int ntx_ssd_scan(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, void* y, int b, int l, int h, int dh, int n,
                 int chunk, int bf16, void* stream) {
  if (b < 0 || l < 0 || h < 0 || dh <= 0 || dh > 32 * kMaxCols || n <= 0 ||
      chunk <= 0 || chunk > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || l == 0 || h == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, A, B, C, y, b, l, h, dh, n, chunk, s);
  return launch<float>(x, dt, A, B, C, y, b, l, h, dh, n, chunk, s);
}

}  // extern "C"
