// Mamba-2 SSD (state-space duality) chunked scan on Hopper, backward.
//
// Replaces no TPU kernel: the reference differentiates its jnp chunked form
// (repro/kernels/ref.py ssd_scan_chunked) with XLA outside any Pallas
// kernel. This kernel is ops.ssd's backward on the card, in the place of
// PyTorch autograd of the plain chunked form, which held (b, nc, h, L, L)
// fp32 intermediates and took 11.2 ms a layer at the training shape.
//
// Per (batch, head) and chunk c of L steps, with la the inclusive cumsum of
// dt * A inside the chunk, u_s = dt_s x_s, S_c the state entering the
// chunk, R_c the gradient of the state leaving it (0 after the last chunk:
// ops.ssd returns y only) and gy the gradient of y:
//   R_c-1 = sum_t exp(la_t) C_t (x) gy_t + exp(la_L) R_c
//   du_s  = sum_{t>=s} exp(la_t - la_s) (C_t . B_s) gy_t
//           + exp(la_L - la_s) B_s R_c;  dx = dt du, d dt += x . du
//   dC_t  = sum_{s<=t} exp(la_t - la_s) (gy_t . u_s) B_s + exp(la_t) S_c gy_t
//   dB_s  = sum_{t>=s} exp(la_t - la_s) (gy_t . u_s) C_t
//           + exp(la_L - la_s) R_c u_s
//   d la_t = sum_s<t P_ts - sum_t'>t P_t't + Q_t - V_t, with P_ts =
//           exp(la_t - la_s) (C_t . B_s) (gy_t . u_s) (s <= t), Q_t =
//           exp(la_t) gy_t . (C_t S_c), V_s = exp(la_L - la_s) u_s . (B_s R_c);
//           d la_L also gets sum_s V_s + exp(la_L) <R_c, S_c>.
//   d(dt A) is d la summed backward inside the chunk: d dt += A d(dt A),
//   dA += sum dt d(dt A).
// (ssd_scan.ssd_scan_bwd_plain is the same in PyTorch.)
//
// Passes, one C entry point:
//   (a) the states S_c: ssd_scan.cu's passes 1 and 2 (ntx_ssd_states), the
//       forward's own kernels, so S and exp(la_L) are the forward's bits;
//   (b) each chunk's sum_t exp(la_t) C_t (x) gy_t: pass 1's code
//       (ssd_scan.cuh, kGrad) on C and gy, a grid over (chunk, batch, head
//       group x head-dim tile);
//   (c) R_c in place over (b): pass 2's code run backward over the chunks,
//       a grid over (state elements, head, batch);
//   (d) the gradient pass, a grid over (chunk, batch, head group), C and
//       B staged once for the group: per head G^T = B C^T, du, dx, d dt,
//       the head's dB and dC and d la, summed backward into d dt and a
//       per-chunk dA;
//   (e) dB and dC summed over the heads, dA over (batch, chunk), each in a
//       fixed order. No float atomics: two calls give the same bits.
//
// Pass (d), bf16 route: every product is a tensor-core mma.sync (m16n8k16,
// fp32 accumulators), one warp per 16-row strip of the chunk. x, gy, B and
// C are bf16 and enter as they are; R and S are split exactly into three
// bf16 planes (ntx_mma.cuh, split3x2), as are the decayed weights formed in
// registers from the accumulators (exp(la_t - la_s) G^T and exp(la_t -
// la_s) dt_s gy_t . x_s, their exps by __expf; the sums for d la take
// expf), so every product is exact and every sum fp32, as in the forward. A warp forms G^T and x gy^T for its rows s (du, dB) and
// G and gy x^T for its rows t (dC) one 16 x 16 block at a time, in
// registers, and uses each block as it forms: the L x L intermediates
// never reach memory. fp32 route: the same code with the
// fp32 operands split into three bf16 parts as their fragments are built,
// nine exact products for each (no TF32): fp32-accurate sums on the tensor
// cores.
//
// Shared memory holds C and B (nb d_state columns at a time), x and gy of
// one head, and R and S (nb x head dim each); the plan
// (ssd_scan.ssd_bwd_plan) picks nb, all of d_state where it fits, and then
// the warps meet only at a head's start and end. Accumulators are held
// kCols columns at a time.
//
// Bound on the H100 at the training shape (b 8, l 1024, h 64, dh 64,
// n 128, chunk 128, bf16): x, gy, dt, B, C read and five gradients written,
// 0.21 GB (0.064 ms); 77.5 GFLOP (ssd_scan.ssd_bwd_flops), 0.078 ms at
// 989 TFLOP/s. fp32: 1.16 ms at 67 TFLOP/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "ssd_scan.cuh"

extern "C" int ntx_ssd_states(const void* x, const void* dt, const void* A,
                              const void* B, void* S, void* dec, int b, int l,
                              int h, int dh, int n, int chunk, int is_bf16,
                              int lp, int np, int dtile, int heads,
                              void* stream);

namespace {

constexpr int kMaxHeadDim = 128;
constexpr int kCols = 128;       // dB and dC accumulator columns at a time
constexpr int kColTiles = kCols / 8;
constexpr int kDuCols = 64;      // du's, held twice (carried, intra)
constexpr int kDuTiles = kDuCols / 8;
constexpr unsigned kFull = 0xffffffffu;

// Shared memory of pass (d) (ssd_scan.grad_smem).
__host__ __device__ inline size_t grad_smem(int mma, int lp, int dp, int nb,
                                            int heads) {
  const size_t e = mma ? 2 : 4;
  const size_t tiles = e * (2ull * lp * (nb + kPad) + 2ull * lp * (dp + kPad));
  const size_t states = 2ull * nb * (dp + kPad) * (mma ? 6 : 4);
  return tiles + states + 16ull * lp +
         4ull * (2ull * heads * lp + 3ull * lp + 16);
}

// Operand tiles in shared memory: bf16 as it is (one exact plane), bf16
// in three exact planes `plane` elements apart, or fp32 split into three
// planes as its fragments are built.
struct TileBf {
  const bf16* p;
  int ld;
  static constexpr int kP = 1;
};
struct TileBf3 {
  const bf16* p;
  int ld;
  int plane;
  static constexpr int kP = 3;
};
struct TileF {
  const float* p;
  int ld;
  static constexpr int kP = 3;
};

__device__ __forceinline__ void put3(uint32_t (&f)[3][4], int i, float v0,
                                     float v1) {
  uint32_t s[3];
  ntx::split3x2(v0, v1, s);
#pragma unroll
  for (int p = 0; p < 3; ++p) f[p][i] = s[p];
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// A (16 x 16): rows r0.. and columns k0.. of a row-major [row][k] tile.
__device__ __forceinline__ void frag_a(uint32_t (&f)[1][4], TileBf t, int r0,
                                       int k0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
  ntx::ldsm_x4(f[0], t.p + (r0 + (mi & 1) * 8 + r8) * t.ld + k0 +
                         (mi >> 1) * 8);
}
__device__ __forceinline__ void frag_a(uint32_t (&f)[3][4], TileF t, int r0,
                                       int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const float* p = t.p + (r0 + g) * t.ld + k0 + 2 * q;
  const float2 v0 = ld2(p), v1 = ld2(p + 8 * t.ld), v2 = ld2(p + 8),
               v3 = ld2(p + 8 * t.ld + 8);
  put3(f, 0, v0.x, v0.y);
  put3(f, 1, v1.x, v1.y);
  put3(f, 2, v2.x, v2.y);
  put3(f, 3, v3.x, v3.y);
}

// B of two 8-column tiles (columns c0..c0+15, k rows k0..k0+15) of a tile
// stored [k][col] (b_kc) or [col][k] (b_ck); f[.][0..1] the first tile's
// two registers, f[.][2..3] the second's.
__device__ __forceinline__ void frag_b_kc(uint32_t (&f)[1][4], TileBf t,
                                          int k0, int c0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
  ntx::ldsm_x4_t(f[0], t.p + (k0 + (mi & 1) * 8 + r8) * t.ld + c0 +
                           (mi >> 1) * 8);
}
__device__ __forceinline__ void frag_b_kc(uint32_t (&f)[3][4], TileBf3 t,
                                          int k0, int c0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int p = 0; p < 3; ++p)
    ntx::ldsm_x4_t(f[p], t.p + p * t.plane +
                             (k0 + (mi & 1) * 8 + r8) * t.ld + c0 +
                             (mi >> 1) * 8);
}
__device__ __forceinline__ void frag_b_kc(uint32_t (&f)[3][4], TileF t,
                                          int k0, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const float* p = t.p + (k0 + 2 * q) * t.ld + c0 + g;
  const int ld = t.ld;
  put3(f, 0, p[0], p[ld]);
  put3(f, 1, p[8 * ld], p[9 * ld]);
  put3(f, 2, p[8], p[ld + 8]);
  put3(f, 3, p[8 * ld + 8], p[9 * ld + 8]);
}
__device__ __forceinline__ void frag_b_ck(uint32_t (&f)[1][4], TileBf t,
                                          int k0, int c0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
  ntx::ldsm_x4(f[0], t.p + (c0 + (mi >> 1) * 8 + r8) * t.ld + k0 +
                         (mi & 1) * 8);
}
__device__ __forceinline__ void frag_b_ck(uint32_t (&f)[3][4], TileBf3 t,
                                          int k0, int c0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int p = 0; p < 3; ++p)
    ntx::ldsm_x4(f[p], t.p + p * t.plane + (c0 + (mi >> 1) * 8 + r8) * t.ld +
                           k0 + (mi & 1) * 8);
}
__device__ __forceinline__ void frag_b_ck(uint32_t (&f)[3][4], TileF t,
                                          int k0, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const float* p = t.p + (c0 + g) * t.ld + k0 + 2 * q;
  const float2 v0 = ld2(p), v1 = ld2(p + 8), v2 = ld2(p + 8 * t.ld),
               v3 = ld2(p + 8 * t.ld + 8);
  put3(f, 0, v0.x, v0.y);
  put3(f, 1, v1.x, v1.y);
  put3(f, 2, v2.x, v2.y);
  put3(f, 3, v3.x, v3.y);
}

// acc[2 tp], acc[2 tp + 1] += A B_tp for every pair of 8-column tiles tp
// that `use` admits, B_tp from `load`: four pairs at a time, their B
// fragments all loaded first and the products issued plane by plane
// across the pairs, so that no product waits on the one just before it
// (the mma.sync statements keep their order).
template <int PB, int PA, int N, class Use, class Load>
__device__ __forceinline__ void mma_tiles(float (&acc)[N][4],
                                          const uint32_t (&a)[PA][4],
                                          Use use, Load load) {
  constexpr int kGroup = 4;
  static_assert(N % (2 * kGroup) == 0, "whole groups of tile pairs");
#pragma unroll
  for (int g0 = 0; g0 < N / 2; g0 += kGroup) {
    uint32_t b[kGroup][PB][4];
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      if (use(g0 + u)) load(b[u], g0 + u);
#pragma unroll
    for (int i = 0; i < PA; ++i)
#pragma unroll
      for (int j = 0; j < PB; ++j)
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          if (use(g0 + u)) {
            ntx::mma_bf16(acc[2 * (g0 + u)], a[i], b[u][j][0], b[u][j][1]);
            ntx::mma_bf16(acc[2 * (g0 + u) + 1], a[i], b[u][j][2],
                          b[u][j][3]);
          }
  }
}

// The three-plane A fragment of a 16 x 16 block held as accumulators
// (blk[0]: columns 16 kb .. + 7, blk[1]: the next 8), each value v at
// (row r of the thread's two, column c) replaced by f(r, c, v).
template <class F>
__device__ __forceinline__ void frag_blk(uint32_t (&af)[3][4],
                                         const float (&blk)[2][4], int kb,
                                         F f) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int hs = 0; hs < 2; ++hs) {
    const int c = 16 * kb + 8 * hs + 2 * q;
    const float* v = blk[hs];
    put3(af, 2 * hs, f(0, c, v[0]), f(0, c + 1, v[1]));
    put3(af, 2 * hs + 1, f(1, c, v[2]), f(1, c + 1, v[3]));
  }
}

template <typename V>
__device__ __forceinline__ V quad_sum(V v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

__device__ void load_tile_f32(float* dst, int ld, const float* src,
                              size_t stride, int rows, int cols, int lp,
                              int width) {
  const bool vec = (stride & 3) == 0 && aligned16(src);
  const int vpr = width / 4;
  staged<8, float4>(
      lp * vpr,
      [&](int e) {
        const int r = e / vpr;
        return r < rows ? load4(src + r * stride, 4 * (e % vpr), cols, vec)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      },
      [&](int e, float4 v) {
        *reinterpret_cast<float4*>(dst + (e / vpr) * ld + 4 * (e % vpr)) = v;
      });
}

__device__ __forceinline__ void stage_in(bf16* dst, int ld, const bf16* src,
                                         size_t stride, int rows, int cols,
                                         int lp, int width) {
  load_tile_bf16(dst, ld, src, stride, rows, cols, lp, width);
}
__device__ __forceinline__ void stage_in(float* dst, int ld, const float* src,
                                         size_t stride, int rows, int cols,
                                         int lp, int width) {
  load_tile_f32(dst, ld, src, stride, rows, cols, lp, width);
}

// n-tile rows x dh of R and of S (fp32, row stride dh; either null where
// it is 0 and not read) into nb x dp of shared memory (row stride ld),
// zero beyond: three bf16 planes (kBf) or fp32. With `dot` the thread
// also adds R . S over the elements it stages. A thread issues all the
// loads of a batch before any of its stores, so a head's states cost one
// round trip to memory.
template <bool kBf>
__device__ __forceinline__ void put_state(void* dst, int ld, int nb, int k,
                                          int d, float4 v) {
  if (kBf)
    put_split4(static_cast<bf16*>(dst) + k * ld + d, (size_t)nb * ld, v);
  else
    *reinterpret_cast<float4*>(static_cast<float*>(dst) + k * ld + d) = v;
}

template <bool kBf>
__device__ void stage_states(void* rdst, void* sdst, int ld, int nb,
                             const float* r, const float* s, int rows,
                             int dh, int dp, bool dot, float& acc) {
  const bool vec = (dh & 3) == 0;   // fresh buffers: 16-byte aligned rows
  const int vpr = dp / 4, total = nb * vpr;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  constexpr int kBatch = 8;
  for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
    float4 rv[kBatch], sv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + u * kThreads, k = e / vpr, d = 4 * (e % vpr);
      const bool in = e < total && k < rows;
      rv[u] = r && in ? load4(r + (size_t)k * dh, d, dh, vec) : zero4;
      sv[u] = s && in ? load4(s + (size_t)k * dh, d, dh, vec) : zero4;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + u * kThreads;
      if (e >= total) continue;
      const int k = e / vpr, d = 4 * (e % vpr);
      if (r) put_state<kBf>(rdst, ld, nb, k, d, rv[u]);
      if (s) put_state<kBf>(sdst, ld, nb, k, d, sv[u]);
      if (dot) {
        acc = fmaf(rv[u].x, sv[u].x, acc);
        acc = fmaf(rv[u].y, sv[u].y, acc);
        acc = fmaf(rv[u].z, sv[u].z, acc);
        acc = fmaf(rv[u].w, sv[u].w, acc);
      }
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b, bool two,
                                       bool pair) {
  if (pair && two) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (two) p[1] = b;
  }
}
__device__ __forceinline__ void store2(bf16* p, float a, float b, bool two,
                                       bool pair) {
  if (pair && two) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16(a);
    if (two) p[1] = __float2bfloat16(b);
  }
}

// The thread's values of acc (rows ra, rb of the chunk; columns c0 + 8 i
// + 2 q, + 1, those below `cols`) into out (row stride `stride`), rows
// below Lc; `pair`: the row stride and c0 are even, so pairs are aligned.
template <typename T, int N>
__device__ __forceinline__ void store_acc(T* out, size_t stride, int ra,
                                          int rb, int Lc, int c0, int cols,
                                          const float (&acc)[N][4],
                                          bool pair) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = hr ? rb : ra, c = c0 + 8 * i + 2 * q;
      if (r < Lc && c < cols)
        store2(out + r * stride + c, acc[i][2 * hr], acc[i][2 * hr + 1],
               c + 1 < cols, pair);
    }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
}

// blk = the 16 x 16 block of A B^T at rows r0.. (A row-major [row][k])
// and columns c0.. (B stored [col][k]), over ksteps of 16: even and odd
// k-steps in two chains, added at the end.
template <class TA, class TB>
__device__ __forceinline__ void block16(float (&blk)[2][4], TA ta, TB tb,
                                        int r0, int c0, int ksteps) {
  float e[2][4], o[2][4];
  zero(e);
  zero(o);
  int kk = 0;
  for (; kk + 1 < ksteps; kk += 2) {
    uint32_t a0[TA::kP][4], a1[TA::kP][4], b0[TB::kP][4], b1[TB::kP][4];
    frag_a(a0, ta, r0, 16 * kk);
    frag_b_ck(b0, tb, 16 * kk, c0);
    frag_a(a1, ta, r0, 16 * kk + 16);
    frag_b_ck(b1, tb, 16 * kk + 16, c0);
#pragma unroll
    for (int i = 0; i < TA::kP; ++i)
#pragma unroll
      for (int j = 0; j < TB::kP; ++j) {
        ntx::mma_bf16(e[0], a0[i], b0[j][0], b0[j][1]);
        ntx::mma_bf16(e[1], a0[i], b0[j][2], b0[j][3]);
        ntx::mma_bf16(o[0], a1[i], b1[j][0], b1[j][1]);
        ntx::mma_bf16(o[1], a1[i], b1[j][2], b1[j][3]);
      }
  }
  if (kk < ksteps) {
    uint32_t a0[TA::kP][4], b0[TB::kP][4];
    frag_a(a0, ta, r0, 16 * kk);
    frag_b_ck(b0, tb, 16 * kk, c0);
#pragma unroll
    for (int i = 0; i < TA::kP; ++i)
#pragma unroll
      for (int j = 0; j < TB::kP; ++j) {
        ntx::mma_bf16(e[0], a0[i], b0[j][0], b0[j][1]);
        ntx::mma_bf16(e[1], a0[i], b0[j][2], b0[j][3]);
      }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) blk[t][i] = e[t][i] + o[t][i];
}

// ---------------------------------------------------------------------
// pass (d): the gradients of one chunk and head group
// ---------------------------------------------------------------------
// Per head, with R and S staged (all of d_state at once where the plan's nb
// covers it, so that the warps meet only at the head's start and end):
//   du (rows s): exp(la_L - la_s) B R, then V_s, then + M^T gy from G^T;
//   sum_{t>s} P_ts (rows s) from G^T and x gy^T; dB (rows s): exp(la_L -
//   la_s) dt_s x R^T + P'^T C;
//   sum_{s<t} P_ts (rows t) from G and gy x^T; dC (rows t): exp(la_t) gy
//   S^T, then Q_t, then + P' B;
//   d la from the sums, summed backward into d dt and dA (warp 0).
// A warp's s-rows work shrinks with its strip index and its t-rows work
// grows with it, so every warp has about the same to do.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_grad(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const T* __restrict__ B,
             const T* __restrict__ C, const T* __restrict__ gy,
             const float* __restrict__ S, const float* __restrict__ R,
             T* __restrict__ dx, float* __restrict__ ddt,
             float* __restrict__ dBp, float* __restrict__ dCp,
             double* __restrict__ dAp, int l, int H, int dh, int n, int chunk,
             int nc, int lp, int dp, int nb, int heads) {
  constexpr bool kBf = std::is_same<T, bf16>::value;
  using In = typename std::conditional<kBf, TileBf, TileF>::type;
  using Rs = typename std::conditional<kBf, TileBf3, TileF>::type;
  constexpr int P = In::kP, RP = Rs::kP;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldn = nb + kPad, ldx = dp + kPad;
  const size_t state_bytes = (size_t)nb * ldx * (kBf ? 6 : 4);
  T* Cs = reinterpret_cast<T*>(smem);      // [lp][ldn]: C, nb columns
  T* Bs = Cs + lp * ldn;                   // [lp][ldn]: B
  T* Xs = Bs + lp * ldn;                   // [lp][ldx]: x of one head
  T* Gs = Xs + lp * ldx;                   // [lp][ldx]: gy of one head
  unsigned char* Rsm = reinterpret_cast<unsigned char*>(Gs + lp * ldx);
  unsigned char* Ssm = Rsm + state_bytes;  // R and S: [nb][ldx] each
  // d la's sums in fp64 (see the last step)
  double* pin = reinterpret_cast<double*>(Ssm + state_bytes);  // sum_s<t
  double* pout = pin + lp;                 // sum_t>s P_ts
  float* dts = reinterpret_cast<float*>(pout + lp);
  float* la = dts + heads * lp;
  float* qv = la + heads * lp;             // Q_t
  float* vv = qv + lp;                     // V_s
  float* ddd = vv + lp;                    // x_s . du_s
  float* red = ddd + lp;                   // 16: <R, S> by warp
  const In cs{Cs, ldn}, bs{Bs, ldn}, xs{Xs, ldx}, gs{Gs, ldx};
  Rs rt, st;
  if constexpr (kBf) {
    rt = Rs{reinterpret_cast<const bf16*>(Rsm), ldx, nb * ldx};
    st = Rs{reinterpret_cast<const bf16*>(Ssm), ldx, nb * ldx};
  } else {
    rt = Rs{reinterpret_cast<const float*>(Rsm), ldx};
    st = Rs{reinterpret_cast<const float*>(Ssm), ldx};
  }

  const Tile w = tile_of(l, H, dh, chunk, dh, heads);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = 16 * warp, ra = r0 + g, rb = ra + 8;
  const bool active = r0 < w.Lc;
  const int last = w.Lc - 1;
  const int nt = (n + nb - 1) / nb;
  const bool has_s = w.c > 0, has_r = w.c < nc - 1;
  const size_t row_x = (size_t)H * dh, row_p = (size_t)H * n;
  const bool pair_x = (dh & 1) == 0, pair_p = (n & 1) == 0;

  chunk_log_decay(dt, A, dts, la, w, H, heads, lp);

  int cb_tile = -1;   // the n-tile of C and B in shared memory
  auto stage_cb = [&](int t) {
    if (cb_tile == t) return;
    __syncthreads();
    const int k0 = t * nb, cols = min(nb, n - k0);
    stage_in(Cs, ldn, C + w.row0 * n + k0, n, w.Lc, cols, lp, nb);
    stage_in(Bs, ldn, B + w.row0 * n + k0, n, w.Lc, cols, lp, nb);
    __syncthreads();
    cb_tile = t;
  };

  for (int j = 0; j < w.nh; ++j) {
    const int h = w.h0 + j;
    const float* laj = la + j * lp;
    const float* dtj = dts + j * lp;
    const float la_last = laj[last];
    const size_t bch = ((size_t)w.b * nc + w.c) * H + h;
    const float* Sj = S + bch * n * dh;
    const float* Rj = R + bch * n * dh;
    float rs_dot = 0.0f;   // this thread's part of <R, S>
    // R and S of n-tile t, without the syncs (the caller's); with `dot`,
    // the thread also sums its part of <R, S> over the tile
    auto put_states = [&](int t, bool dot) {
      const size_t at = (size_t)t * nb * dh;
      stage_states<kBf>(Rsm, Ssm, ldx, nb, has_r ? Rj + at : nullptr,
                        has_s ? Sj + at : nullptr, min(nb, n - t * nb), dh,
                        dp, dot && has_r && has_s, rs_dot);
    };
    // n-tile t staged (with syncs) unless it is; each tile's dot summed
    // on its first staging only
    int st_tile = -1, st_seen = 0;
    auto stage_rs = [&](int t) {
      if (st_tile == t || !(has_r || has_s)) return;
      __syncthreads();
      put_states(t, t >= st_seen);
      st_seen = max(st_seen, t + 1);
      __syncthreads();
      st_tile = t;
    };
    __syncthreads();   // the previous head is done with x, gy, R, S, sums
    stage_in(Xs, ldx, x + (w.row0 * H + h) * dh, row_x, w.Lc, dh, lp, dp);
    stage_in(Gs, ldx, gy + (w.row0 * H + h) * dh, row_x, w.Lc, dh, lp, dp);
    if (nt == 1) {   // staged with x and gy, for the whole head
      put_states(0, true);
      st_tile = 0;
      st_seen = 1;
    }
    for (int t = tid; t < lp; t += kThreads) {
      pin[t] = pout[t] = 0.0;
      qv[t] = vv[t] = ddd[t] = 0.0f;
    }
    __syncthreads();
    // this thread's rows: log-decay and dt
    const float lsa = active ? laj[ra] : 0.0f, lsb = active ? laj[rb] : 0.0f;
    const float dsa = active ? dtj[ra] : 0.0f, dsb = active ? dtj[rb] : 0.0f;
    const float ea = active ? expf(la_last - lsa) : 0.0f;
    const float eb = active ? expf(la_last - lsb) : 0.0f;
    float* dBj = dBp + (w.row0 * H + h) * (size_t)n;
    float* dCj = dCp + (w.row0 * H + h) * (size_t)n;
    const int kb_end = (w.Lc + 15) / 16;   // 16-step blocks of the chunk

    // du (rows s) = exp(la_L - la_s) B R + M^T gy, M^T = exp(la_t - la_s)
    // G^T (t >= s), G^T a 16 x 16 block at a time; the carried part apart,
    // for V_s = dt_s x_s . (the carried du)
    {
      float va = 0.0f, vb = 0.0f, xa = 0.0f, xb = 0.0f;
      for (int dc = 0; dc < dp; dc += kDuCols) {
        float duc[kDuTiles][4], dui[kDuTiles][4];
        zero(duc);
        zero(dui);
        const auto cols = [&](int tp) { return dc + 16 * tp < dp; };
        for (int t = 0; t < nt; ++t) {
          stage_cb(t);
          stage_rs(t);
          if (!active) continue;
          if (has_r)
            for (int kk = 0; kk < nb / 16; ++kk) {
              uint32_t a[P][4];
              frag_a(a, bs, r0, 16 * kk);
              mma_tiles<RP>(duc, a, cols,
                            [&](uint32_t (&bq)[RP][4], int tp) {
                              frag_b_kc(bq, rt, 16 * kk, dc + 16 * tp);
                            });
            }
          for (int kb = warp; kb < kb_end; ++kb) {
            float gb[2][4];
            block16(gb, bs, cs, r0, 16 * kb, nb / 16);
            uint32_t af[3][4];
            frag_blk(af, gb, kb, [&](int r, int c, float v) {
              return c >= (r ? rb : ra)
                         ? v * __expf(laj[c] - (r ? lsb : lsa)) : 0.0f;
            });
            mma_tiles<P>(dui, af, cols, [&](uint32_t (&bq)[P][4], int tp) {
              frag_b_kc(bq, gs, 16 * kb, dc + 16 * tp);
            });
          }
        }
        if (!active) continue;
#pragma unroll
        for (int i = 0; i < kDuTiles; ++i) {
          const int d = dc + 8 * i + 2 * q;
          const bool in = d < dp;
          const float xa0 = in ? to_f(Xs[ra * ldx + d]) : 0.0f;
          const float xa1 = in ? to_f(Xs[ra * ldx + d + 1]) : 0.0f;
          const float xb0 = in ? to_f(Xs[rb * ldx + d]) : 0.0f;
          const float xb1 = in ? to_f(Xs[rb * ldx + d + 1]) : 0.0f;
          float du[4] = {duc[i][0] * ea, duc[i][1] * ea, duc[i][2] * eb,
                         duc[i][3] * eb};
          va += du[0] * xa0 + du[1] * xa1;
          vb += du[2] * xb0 + du[3] * xb1;
#pragma unroll
          for (int e = 0; e < 4; ++e) du[e] += dui[i][e];
          xa += du[0] * xa0 + du[1] * xa1;
          xb += du[2] * xb0 + du[3] * xb1;
          dui[i][0] = du[0] * dsa;   // dx = dt du
          dui[i][1] = du[1] * dsa;
          dui[i][2] = du[2] * dsb;
          dui[i][3] = du[3] * dsb;
        }
        store_acc(dx + (w.row0 * H + h) * dh, row_x, ra, rb, w.Lc, dc, dh,
                  dui, pair_x);
      }
      va = quad_sum(va);
      vb = quad_sum(vb);
      xa = quad_sum(xa);
      xb = quad_sum(xb);
      if (active && q == 0) {
        vv[ra] = dsa * va;
        vv[rb] = dsb * vb;
        ddd[ra] = xa;
        ddd[rb] = xb;
      }
    }

    // dB (rows s) = exp(la_L - la_s) dt_s x R^T + P'^T C, P'^T =
    // exp(la_t - la_s) dt_s x_s . gy_t (t >= s); and sum_{t > s} P_ts,
    // P_ts = G^T[s][t] P'^T[s][t] (P_tt, which enters d la_t and leaves it
    // again, left out of both sums: it would only add rounding to a d la
    // that may be far smaller than it)
    {
      double oa = 0.0, ob = 0.0;
      const float wa = ea * dsa, wb = eb * dsb;
      for (int t = 0; t < nt; ++t) {
        stage_cb(t);
        stage_rs(t);
        if (!active) continue;
        for (int cc = 0; cc < nb; cc += kCols) {
          const auto cols = [&](int tp) { return cc + 16 * tp < nb; };
          float acc[kColTiles][4];
          zero(acc);
          if (has_r) {
            for (int ks = 0; ks < dp / 16; ++ks) {
              uint32_t a[P][4];
              frag_a(a, xs, r0, 16 * ks);
              mma_tiles<RP>(acc, a, cols,
                            [&](uint32_t (&bq)[RP][4], int tp) {
                              frag_b_ck(bq, rt, 16 * ks, cc + 16 * tp);
                            });
            }
#pragma unroll
            for (int i = 0; i < kColTiles; ++i) {
              acc[i][0] *= wa;
              acc[i][1] *= wa;
              acc[i][2] *= wb;
              acc[i][3] *= wb;
            }
          }
          for (int kb = warp; kb < kb_end; ++kb) {
            float xg[2][4];
            block16(xg, xs, gs, r0, 16 * kb, dp / 16);
            if (cc == 0) {   // linear in G: this n-tile's part of it
              float gb[2][4];
              block16(gb, bs, cs, r0, 16 * kb, nb / 16);
#pragma unroll
              for (int hs = 0; hs < 2; ++hs)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int c = 16 * kb + 8 * hs + 2 * q + e;
                  const float lc = laj[c];
                  if (c > ra)
                    oa += gb[hs][e] * xg[hs][e] * dsa * expf(lc - lsa);
                  if (c > rb)
                    ob += gb[hs][2 + e] * xg[hs][2 + e] * dsb *
                          expf(lc - lsb);
                }
            }
            uint32_t af[3][4];
            frag_blk(af, xg, kb, [&](int r, int c, float v) {
              return c >= (r ? rb : ra)
                         ? v * (r ? dsb : dsa) *
                               __expf(laj[c] - (r ? lsb : lsa))
                         : 0.0f;
            });
            mma_tiles<P>(acc, af, cols, [&](uint32_t (&bq)[P][4], int tp) {
              frag_b_kc(bq, cs, 16 * kb, cc + 16 * tp);
            });
          }
          store_acc(dBj, row_p, ra, rb, w.Lc, t * nb + cc,
                    min(n, t * nb + nb), acc, pair_p);
        }
      }
      oa = quad_sum(oa);
      ob = quad_sum(ob);
      if (active && q == 0) {
        pout[ra] = oa;
        pout[rb] = ob;
      }
    }

    // dC (rows t) = exp(la_t) gy S^T + P' B, P' = exp(la_t - la_s) dt_s
    // gy_t . x_s (s <= t); Q_t = C_t . (the carried part); and sum_{s < t}
    // P_ts from G = C B^T
    {
      double ia = 0.0, ib = 0.0;
      float qa = 0.0f, qb = 0.0f;
      const float eta = active ? expf(lsa) : 0.0f;
      const float etb = active ? expf(lsb) : 0.0f;
      for (int t = 0; t < nt; ++t) {
        stage_cb(t);
        stage_rs(t);
        if (!active) continue;
        for (int cc = 0; cc < nb; cc += kCols) {
          const auto cols = [&](int tp) { return cc + 16 * tp < nb; };
          float acc[kColTiles][4];
          zero(acc);
          if (has_s) {
            for (int ks = 0; ks < dp / 16; ++ks) {
              uint32_t a[P][4];
              frag_a(a, gs, r0, 16 * ks);
              mma_tiles<RP>(acc, a, cols,
                            [&](uint32_t (&bq)[RP][4], int tp) {
                              frag_b_ck(bq, st, 16 * ks, cc + 16 * tp);
                            });
            }
#pragma unroll
            for (int i = 0; i < kColTiles; ++i) {
              acc[i][0] *= eta;
              acc[i][1] *= eta;
              acc[i][2] *= etb;
              acc[i][3] *= etb;
              const int k = cc + 8 * i + 2 * q;
              if (k < nb) {
                qa += acc[i][0] * to_f(Cs[ra * ldn + k]) +
                      acc[i][1] * to_f(Cs[ra * ldn + k + 1]);
                qb += acc[i][2] * to_f(Cs[rb * ldn + k]) +
                      acc[i][3] * to_f(Cs[rb * ldn + k + 1]);
              }
            }
          }
          for (int kb = 0; kb <= warp; ++kb) {
            float xg[2][4];
            block16(xg, gs, xs, r0, 16 * kb, dp / 16);
            if (cc == 0) {
              float gb[2][4];
              block16(gb, cs, bs, r0, 16 * kb, nb / 16);
#pragma unroll
              for (int hs = 0; hs < 2; ++hs)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int c = 16 * kb + 8 * hs + 2 * q + e;
                  const float lc = laj[c], dc_ = dtj[c];
                  if (c < ra)
                    ia += gb[hs][e] * xg[hs][e] * dc_ * expf(lsa - lc);
                  if (c < rb)
                    ib += gb[hs][2 + e] * xg[hs][2 + e] * dc_ *
                          expf(lsb - lc);
                }
            }
            uint32_t af[3][4];
            frag_blk(af, xg, kb, [&](int r, int c, float v) {
              return c <= (r ? rb : ra)
                         ? v * dtj[c] * __expf((r ? lsb : lsa) - laj[c])
                         : 0.0f;
            });
            mma_tiles<P>(acc, af, cols, [&](uint32_t (&bq)[P][4], int tp) {
              frag_b_kc(bq, bs, 16 * kb, cc + 16 * tp);
            });
          }
          store_acc(dCj, row_p, ra, rb, w.Lc, t * nb + cc,
                    min(n, t * nb + nb), acc, pair_p);
        }
      }
      ia = quad_sum(ia);
      ib = quad_sum(ib);
      qa = quad_sum(qa);
      qb = quad_sum(qb);
      if (active && q == 0) {
        pin[ra] = ia;
        pin[rb] = ib;
        qv[ra] = qa;
        qv[rb] = qb;
      }
    }

    // <R, S> over the block, then d la, summed backward into d(dt A)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      rs_dot += __shfl_xor_sync(kFull, rs_dot, o);
    if (lane == 0) red[warp] = rs_dot;
    __syncthreads();
    if (warp == 0) {
      // in fp64: d(dt A)_r = sum_{t >= r} d la_t takes differences of
      // sums of P (and of V) over the chunk whose terms can be far larger
      // than the result (strong decay), which fp32 rounding would swamp
      double rsum = 0.0;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) rsum += red[i];
      double v[4], vs = 0.0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * lane + i;
        v[i] = 0.0;
        if (t < w.Lc) {
          v[i] = pin[t] - pout[t] + (double)qv[t] - (double)vv[t];
          vs += vv[t];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) vs += __shfl_xor_sync(kFull, vs, o);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * lane + i == last) v[i] += vs + (double)expf(la_last) * rsum;
      // suffix sums: inside the lane, then over the lanes above it
      double sfx[4];
      sfx[3] = v[3];
      sfx[2] = v[2] + sfx[3];
      sfx[1] = v[1] + sfx[2];
      sfx[0] = v[0] + sfx[1];
      double incl = sfx[0];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_down_sync(kFull, incl, o);
        if (lane + o < 32) incl += u;
      }
      double excl = __shfl_down_sync(kFull, incl, 1);
      if (lane == 31) excl = 0.0;
      const double a_h = A[h];
      double da_sum = 0.0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = 4 * lane + i;
        if (t < w.Lc) {
          const double da = sfx[i] + excl;
          ddt[(w.row0 + t) * H + h] = (float)(ddd[t] + a_h * da);
          da_sum += dtj[t] * da;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        da_sum += __shfl_xor_sync(kFull, da_sum, o);
      if (lane == 0) dAp[bch] = da_sum;
    }
  }
}

// ---------------------------------------------------------------------
// pass (e): dB and dC over the heads, dA over (batch, chunk)
// ---------------------------------------------------------------------
__device__ __forceinline__ void put1(float* p, float v) { *p = v; }
__device__ __forceinline__ void put1(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce(const float* __restrict__ dBp, const float* __restrict__ dCp,
               T* __restrict__ dB, T* __restrict__ dC, size_t total, int H,
               int n) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const size_t row = e / n;
  const int k = (int)(e % n);
  const float* p = (blockIdx.y ? dCp : dBp) + row * H * n + k;
  float s = 0.0f;
#pragma unroll 8
  for (int hh = 0; hh < H; ++hh) s += p[(size_t)hh * n];
  put1((blockIdx.y ? dC : dB) + e, s);
}

__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_da(const double* __restrict__ dAp, float* __restrict__ dA,
                  int rows, int H) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= H) return;
  double s = 0.0;
  for (int r = 0; r < rows; ++r) s += dAp[(size_t)r * H + h];
  dA[h] = (float)s;
}

template <typename T>
int launch_grad(dim3 grid, size_t bytes, cudaStream_t s, const void* x,
                const void* dt, const void* A, const void* B, const void* C,
                const void* gy, const float* S, const float* R, void* dx,
                void* ddt, float* dBp, float* dCp, double* dAp, void* dB,
                void* dC, void* dA, int b, int l, int h, int dh, int n,
                int chunk, int nc, int lp, int dp, int nb, int heads) {
  cudaError_t err = allow_smem(ssd_bwd_grad<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_grad<T><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const T*>(gy), S, R,
      static_cast<T*>(dx), static_cast<float*>(ddt), dBp, dCp, dAp, l, h, dh,
      n, chunk, nc, lp, dp, nb, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)b * l * n;
  ssd_bwd_reduce<T><<<dim3((unsigned)((total + kThreads - 1) / kThreads), 2),
                      kThreads, 0, s>>>(dBp, dCp, static_cast<T*>(dB),
                                        static_cast<T*>(dC), total, h, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_reduce_da<<<(h + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      dAp, static_cast<float*>(dA), b * nc, h);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, gy, dx (b, l, h, dh); dt, ddt (b, l, h) fp32; A, dA (h,) fp32; B, C,
// dB, dC (b, l, n): contiguous on the device, x, gy, B, C 16-byte aligned;
// x, gy, B, C, dx, dB, dC all fp32 (is_bf16 = 0) or all bf16. Scratch:
// S and R (b, ceil(l / chunk), h, n, dh), dec (b, nc, h), dBp and dCp
// (b, l, h, n), fp32; dAp (b, nc, h) fp64. The forward's plan (lp, np,
// dtile, heads, as ntx_ssd_scan takes it) for passes (a)-(b); the
// gradient pass's: glp = chunk rounded up to 16, dp = dh rounded up to 16
// (dh <= 128), nb a multiple of 16 up to n rounded up to 16, gheads
// 1..64, its shared memory at most 227 KB. Eight launches.
int ntx_ssd_scan_bwd(const void* x, const void* dt, const void* A,
                     const void* B, const void* C, const void* gy, void* dx,
                     void* ddt, void* dA, void* dB, void* dC, void* S,
                     void* R, void* dec, void* dBp, void* dCp, void* dAp,
                     int b, int l, int h, int dh, int n, int chunk,
                     int is_bf16, int lp, int np, int dtile, int heads,
                     int glp, int dp, int nb, int gheads, void* stream) {
  if (b < 0 || l < 0 || h < 0 || dh <= 0 || dh > kMaxHeadDim || n <= 0 ||
      chunk <= 0 || chunk > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  if (glp != round_up(chunk, 16) || dp != round_up(dh, 16) || nb < 16 ||
      nb % 16 != 0 || nb > round_up(n, 16) || gheads < 1 ||
      gheads > kMaxHeads ||
      grad_smem(is_bf16, glp, dp, nb, gheads) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if ((h + gheads - 1) / gheads > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // (a): also checks the forward's plan, before any launch
  int err = ntx_ssd_states(x, dt, A, B, S, dec, b, l, h, dh, n, chunk,
                           is_bf16, lp, np, dtile, heads, stream);
  if (err) return err;
  const int nc = (l + chunk - 1) / chunk;
  if (b == 0 || l == 0 || h == 0) {   // nothing to sum: dA is 0
    if (h > 0)
      ssd_bwd_reduce_da<<<(h + kThreads - 1) / kThreads, kThreads, 0, s>>>(
          static_cast<const double*>(dAp), static_cast<float*>(dA), 0, h);
    return (int)cudaGetLastError();
  }
  float* Rf = static_cast<float*>(R);
  float* decf = static_cast<float*>(dec);

  // (b): pass 1's code on C and gy
  const int tiles = ((h + heads - 1) / heads) * ((dh + dtile - 1) / dtile);
  const dim3 grid1(nc, b, tiles);
  const size_t smem1 = state_smem(is_bf16, lp, np, dtile, heads);
  cudaError_t e;
  if (is_bf16) {
    e = allow_smem(ssd_state_mma<true>, smem1);
    if (e != cudaSuccess) return (int)e;
    ssd_state_mma<true><<<grid1, kThreads, smem1, s>>>(
        static_cast<const bf16*>(gy), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const bf16*>(C), Rf, decf,
        l, h, dh, n, chunk, nc, lp, np, dtile, heads);
  } else {
    e = allow_smem(ssd_state_f32<true>, smem1);
    if (e != cudaSuccess) return (int)e;
    ssd_state_f32<true><<<grid1, kThreads, smem1, s>>>(
        static_cast<const float*>(gy), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const float*>(C), Rf, decf,
        l, h, dh, n, chunk, nc, lp, np, dtile, heads);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // (c): the reverse carry
  const int nd = n * dh;
  if (nd % 4 == 0)
    ssd_carry<float4, true><<<dim3((nd / 4 + kThreads - 1) / kThreads, h,
                                   b), kThreads, 0, s>>>(Rf, decf, nullptr, h,
                                                         nc, nd);
  else
    ssd_carry<float, true><<<dim3((nd + kThreads - 1) / kThreads, h, b),
                             kThreads, 0, s>>>(Rf, decf, nullptr, h, nc, nd);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // (d) and (e)
  const dim3 grid(nc, b, (h + gheads - 1) / gheads);
  const size_t bytes = grad_smem(is_bf16, glp, dp, nb, gheads);
  const float* Sf = static_cast<const float*>(S);
  float* bp = static_cast<float*>(dBp);
  float* cp = static_cast<float*>(dCp);
  double* ap = static_cast<double*>(dAp);
  if (is_bf16)
    return launch_grad<bf16>(grid, bytes, s, x, dt, A, B, C, gy, Sf, Rf, dx,
                             ddt, bp, cp, ap, dB, dC, dA, b, l, h, dh, n,
                             chunk, nc, glp, dp, nb, gheads);
  return launch_grad<float>(grid, bytes, s, x, dt, A, B, C, gy, Sf, Rf, dx,
                            ddt, bp, cp, ap, dB, dC, dA, b, l, h, dh, n,
                            chunk, nc, glp, dp, nb, gheads);
}

}  // extern "C"
