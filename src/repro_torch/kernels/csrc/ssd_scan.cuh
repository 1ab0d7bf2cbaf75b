// Device code shared by the SSD scan's forward (ssd_scan.cu) and its
// backward (ssd_scan_bwd.cu): the constants, the staged loads, the
// log-decay scan, and passes 1 and 2, which both run (the backward
// recomputes the states entering each chunk with them, and runs pass 1's
// code on C and gy for its own per-chunk sums, pass 2's backward over the
// chunks). Everything is in an anonymous namespace: each source that
// includes it gets its own copy of the same code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ntx_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 128;   // one 16-row strip per warp; 4 steps a lane
constexpr int kMaxHeads = 64;
constexpr int kPad = 8;          // bf16 row padding: ldmatrix rows in 8 banks
constexpr int kMaxSmem = 232448;

typedef __nv_bfloat16 bf16;

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Shared memory of pass 1 and pass 3 for a plan (ssd_scan.smem_bytes).
__host__ __device__ inline size_t state_smem(int mma, int lp, int np, int dt,
                                             int heads) {
  const size_t tiles =
      mma ? 2ull * lp * (np + kPad) + 6ull * lp * (dt + kPad)
          : 4ull * lp * np + 4ull * lp * dt;
  return tiles + 8ull * heads * lp;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// put(e, get(e)) for e = threadIdx.x, + kThreads, ... < total, with the
// gets of kBatch consecutive steps issued before any of their puts, so a
// thread keeps kBatch global loads in flight (a load and a store to shared
// memory one after the other would wait out each load's latency in turn).
template <int kBatch, typename V, typename Get, typename Put>
__device__ __forceinline__ void staged(int total, Get get, Put put) {
  for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
    V v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + u * kThreads;
      if (e < total) v[u] = get(e);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + u * kThreads;
      if (e < total) put(e, v[u]);
    }
  }
}

// Eight head-dim columns of one bf16 row (16 bytes), zero past `cols`.
__device__ __forceinline__ uint4 load8(const bf16* row, int d, int cols,
                                       bool vec) {
  if (vec && d + 8 <= cols) return *reinterpret_cast<const uint4*>(row + d);
  uint4 out;
  bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    o[i] = d + i < cols ? row[d + i] : __float2bfloat16(0.0f);
  return out;
}

// Four fp32 columns of one row (16 bytes), zero past `cols`.
__device__ __forceinline__ float4 load4(const float* row, int d, int cols,
                                        bool vec) {
  if (vec && d + 4 <= cols) return *reinterpret_cast<const float4*>(row + d);
  float4 out;
  out.x = d < cols ? row[d] : 0.0f;
  out.y = d + 1 < cols ? row[d + 1] : 0.0f;
  out.z = d + 2 < cols ? row[d + 2] : 0.0f;
  out.w = d + 3 < cols ? row[d + 3] : 0.0f;
  return out;
}

// The three bf16 planes of four fp32 values, 8 bytes into each plane.
__device__ __forceinline__ void put_split4(bf16* plane0, size_t stride,
                                           float4 v) {
  uint32_t a[3], b[3];
  ntx::split3x2(v.x, v.y, a);
  ntx::split3x2(v.z, v.w, b);
#pragma unroll
  for (int p = 0; p < 3; ++p)
    *reinterpret_cast<uint2*>(plane0 + p * stride) = make_uint2(a[p], b[p]);
}

// Where one block works: chunk c of sequence b, heads [h0, h0 + nh),
// head-dim columns [d0, d0 + dtile).
struct Tile {
  int c, b, h0, nh, d0, t0, Lc;
  size_t row0;   // first (b, t) row of the chunk
};

__device__ __forceinline__ Tile tile_of(int l, int H, int dh, int chunk,
                                        int dtile, int heads) {
  Tile w;
  const int d_tiles = (dh + dtile - 1) / dtile;
  w.c = blockIdx.x;
  w.b = blockIdx.y;
  w.h0 = (blockIdx.z / d_tiles) * heads;
  w.nh = min(heads, H - w.h0);
  w.d0 = (blockIdx.z % d_tiles) * dtile;
  w.t0 = w.c * chunk;
  w.Lc = min(chunk, l - w.t0);
  w.row0 = (size_t)w.b * l + w.t0;
  return w;
}

// dt of the block's heads into dts[j][s] (0 past the chunk's end), then
// la[j][s], the inclusive cumulative sum of dt * A over the chunk: one
// warp per head, 4 steps a lane, a shuffle scan over the lanes' sums.
__device__ void chunk_log_decay(const float* __restrict__ dt,
                                const float* __restrict__ A, float* dts,
                                float* la, const Tile& w, int H, int heads,
                                int lp) {
  staged<4, float>(
      lp * heads,
      [&](int e) {
        const int s = e / heads, j = e % heads;
        return (s < w.Lc && j < w.nh) ? dt[(w.row0 + s) * H + w.h0 + j]
                                      : 0.0f;
      },
      [&](int e, float v) { dts[(e % heads) * lp + e / heads] = v; });
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < w.nh; j += kWarps) {
    const float a = A[w.h0 + j];
    float q[4], run = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 4 * lane + i;
      run = __fadd_rn(run, s < lp ? __fmul_rn(dts[j * lp + s], a) : 0.0f);
      q[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl = __fadd_rn(incl, u);
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * lane + i < lp) la[j * lp + 4 * lane + i] = __fadd_rn(excl, q[i]);
  }
  __syncthreads();
}

// rows x cols of a bf16 matrix (row stride `stride`) into a width-wide
// shared tile of `lp` rows (row stride ld), zero-filled beyond; 16-byte
// copies where every row starts on a 16-byte boundary.
__device__ void load_tile_bf16(bf16* dst, int ld, const bf16* src,
                               size_t stride, int rows, int cols, int lp,
                               int width) {
  const bool vec = (stride & 7) == 0 && aligned16(src);
  const int vpr = width / 8;
  staged<8, uint4>(
      lp * vpr,
      [&](int e) {
        const int r = e / vpr;
        return r < rows ? load8(src + r * stride, 8 * (e % vpr), cols, vec)
                        : make_uint4(0u, 0u, 0u, 0u);
      },
      [&](int e, uint4 v) {
        *reinterpret_cast<uint4*>(dst + (e / vpr) * ld + 8 * (e % vpr)) = v;
      });
}

// ---------------------------------------------------------------------
// pass 1: each chunk's own state contribution, and exp(la_L)
// ---------------------------------------------------------------------
// kGrad = false (the forward): x and B are x and B, a step's weight is
// exp(la_L - la_s) dt_s, and exp(la_L) goes to dec. kGrad = true (the
// backward's per-chunk sums sum_t exp(la_t) C_t (x) gy_t): x and B are gy
// and C, a step's weight is exp(la_t), and dec is not written.
template <bool kGrad>
__device__ __forceinline__ float step_weight(float last, float la_s,
                                             float dt_s) {
  return kGrad ? expf(la_s) : __fmul_rn(expf(__fsub_rn(last, la_s)), dt_s);
}

template <bool kGrad>
__global__ void __launch_bounds__(kThreads)
ssd_state_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ B,
              float* __restrict__ dS, float* __restrict__ dec, int l, int H,
              int dh, int n, int chunk, int nc, int lp, int np, int dtile,
              int heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldb = np + kPad, ldx = dtile + kPad;
  bf16* Bs = reinterpret_cast<bf16*>(smem);          // [lp][ldb], exact
  bf16* Xw = Bs + lp * ldb;                          // 3 x [lp][ldx]
  float* dts = reinterpret_cast<float*>(Xw + 3 * lp * ldx);
  float* la = dts + heads * lp;
  const Tile w = tile_of(l, H, dh, chunk, dtile, heads);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mi = lane >> 3, r8 = lane & 7, g = lane >> 2, q = lane & 3;

  load_tile_bf16(Bs, ldb, B + w.row0 * n, n, w.Lc, n, lp, np);
  chunk_log_decay(dt, A, dts, la, w, H, heads, lp);

  const int strips = np / 16, pairs = dtile / 16;
  const int ksteps = (w.Lc + 15) / 16;
  const bool vec_x = (dh & 7) == 0 && aligned16(x);
  for (int j = 0; j < w.nh; ++j) {
    const float* laj = la + j * lp;
    const float last = laj[w.Lc - 1];
    if (!kGrad && w.d0 == 0 && tid == 0)
      dec[((size_t)w.b * nc + w.c) * H + w.h0 + j] = expf(last);
    // Xw = exp(la_L - la_s) dt_s x_s, split exactly into three bf16 planes
    const bf16* xj = x + (w.row0 * H + w.h0 + j) * dh + w.d0;
    const int cols = min(dtile, dh - w.d0), vpr = dtile / 8;
    staged<4, uint4>(
        lp * vpr,
        [&](int e) {
          const int s = e / vpr;
          return s < w.Lc ? load8(xj + (size_t)s * H * dh, 8 * (e % vpr),
                                  cols, vec_x)
                          : make_uint4(0u, 0u, 0u, 0u);
        },
        [&](int e, uint4 raw) {
          const int s = e / vpr, d = 8 * (e % vpr);
          const float ws =
              s < w.Lc ? step_weight<kGrad>(last, laj[s], dts[j * lp + s])
                       : 0.0f;
          const bf16* xv = reinterpret_cast<const bf16*>(&raw);
          uint32_t parts[4][3];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            ntx::split3x2(__fmul_rn(ws, to_f(xv[2 * i])),
                          __fmul_rn(ws, to_f(xv[2 * i + 1])), parts[i]);
#pragma unroll
          for (int p = 0; p < 3; ++p)
            *reinterpret_cast<uint4*>(Xw + (p * lp + s) * ldx + d) =
                make_uint4(parts[0][p], parts[1][p], parts[2][p], parts[3][p]);
        });
    __syncthreads();
    // dS (np x dtile) = Bs^T Xw; a warp item is a 16-state strip and a
    // pair of 8-column tiles
    float* out = dS + (((size_t)w.b * nc + w.c) * H + w.h0 + j) * n * dh;
    for (int it = warp; it < strips * pairs; it += kWarps) {
      const int m0 = 16 * (it % strips), n0 = 16 * (it / strips);
      float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t a[4];   // A = Bs^T: stored [s][state], so transposed
        ntx::ldsm_x4_t(a, Bs + (16 * ks + (mi >> 1) * 8 + r8) * ldb + m0 +
                              (mi & 1) * 8);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          uint32_t bq[4];
          ntx::ldsm_x4_t(bq, Xw + (p * lp + 16 * ks + (mi & 1) * 8 + r8) *
                                      ldx + n0 + (mi >> 1) * 8);
          ntx::mma_bf16(acc[0], a, bq[0], bq[1]);
          ntx::mma_bf16(acc[1], a, bq[2], bq[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int k = m0 + g + 8 * hr, d = w.d0 + n0 + 8 * nt + 2 * q;
          if (k < n) {
            if (d < dh) out[k * dh + d] = acc[nt][2 * hr];
            if (d + 1 < dh) out[k * dh + d + 1] = acc[nt][2 * hr + 1];
          }
        }
    }
    __syncthreads();
  }
}

// A 4 x 8 register tile of fp32 products: acc[i][j] += a[i] b[j].
__device__ __forceinline__ void fma4x8(float acc[4][8], float4 a, float4 b0,
                                       float4 b1) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// Rows r0..r0+3 (those below `rows`) by columns c0..c0+7 (those below
// `cols`) of a row-major fp32 matrix with row stride ld; 16-byte stores
// where `vec` says the rows allow them.
__device__ __forceinline__ void store4x8(float* out, size_t ld, int r0,
                                         int rows, int c0, int cols,
                                         const float acc[4][8], bool vec) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (r0 + i >= rows) continue;
    float* row = out + (size_t)(r0 + i) * ld + c0;
    if (vec && c0 + 8 <= cols) {
      *reinterpret_cast<float4*>(row) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(row + 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c0 + j < cols) row[j] = acc[i][j];
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <bool kGrad>
__global__ void __launch_bounds__(kThreads)
ssd_state_f32(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const float* __restrict__ B,
              float* __restrict__ dS, float* __restrict__ dec, int l, int H,
              int dh, int n, int chunk, int nc, int lp, int np, int dtile,
              int heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Bs = reinterpret_cast<float*>(smem);       // [lp][np]
  float* Xw = Bs + lp * np;                         // [lp][dtile]
  float* dts = Xw + lp * dtile;
  float* la = dts + heads * lp;
  const Tile w = tile_of(l, H, dh, chunk, dtile, heads);
  const int tid = threadIdx.x;

  staged<8, float>(
      lp * np,
      [&](int e) {
        const int s = e / np, k = e % np;
        return (s < w.Lc && k < n) ? B[(w.row0 + s) * n + k] : 0.0f;
      },
      [&](int e, float v) { Bs[e] = v; });
  chunk_log_decay(dt, A, dts, la, w, H, heads, lp);

  const int vpr = dtile / 4, nk4 = np / 4, nd8 = dtile / 8;
  const int cols = min(dtile, dh - w.d0);
  const bool vec_x = (dh & 3) == 0 && aligned16(x), vec_o = (dh & 3) == 0;
  for (int j = 0; j < w.nh; ++j) {
    const float* laj = la + j * lp;
    const float last = laj[w.Lc - 1];
    if (!kGrad && w.d0 == 0 && tid == 0)
      dec[((size_t)w.b * nc + w.c) * H + w.h0 + j] = expf(last);
    const float* xj = x + (w.row0 * H + w.h0 + j) * dh + w.d0;
    staged<8, float4>(
        lp * vpr,
        [&](int e) {
          const int s = e / vpr;
          return s < w.Lc ? load4(xj + (size_t)s * H * dh, 4 * (e % vpr),
                                  cols, vec_x)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        },
        [&](int e, float4 v) {
          const int s = e / vpr;
          const float ws =
              s < w.Lc ? step_weight<kGrad>(last, laj[s], dts[j * lp + s])
                       : 0.0f;
          *reinterpret_cast<float4*>(Xw + 4 * e) =
              make_float4(__fmul_rn(ws, v.x), __fmul_rn(ws, v.y),
                          __fmul_rn(ws, v.z), __fmul_rn(ws, v.w));
        });
    __syncthreads();
    // dS[k][d] = sum_s Bs[s][k] Xw[s][d]: a thread owns 4 states and 8
    // columns; a warp's lanes hold consecutive 4-state groups
    float* out = dS + (((size_t)w.b * nc + w.c) * H + w.h0 + j) * n * dh;
    for (int it = tid; it < nk4 * nd8; it += kThreads) {
      const int k0 = 4 * (it % nk4), d0 = 8 * (it / nk4);
      float acc[4][8] = {};
#pragma unroll 4
      for (int s = 0; s < w.Lc; ++s)
        fma4x8(acc, ld4(Bs + s * np + k0), ld4(Xw + s * dtile + d0),
               ld4(Xw + s * dtile + d0 + 4));
      store4x8(out, dh, k0, n, w.d0 + d0, dh, acc, vec_o);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------
// pass 2: the state entering each chunk, over dS in place
// ---------------------------------------------------------------------
// A thread carries V (float4 when n * dh is a multiple of 4, else float)
// of one (batch, head)'s state through the chunks, loading kCarryBatch
// chunks' contributions before it stores their states; with S_final it
// then stores the state after the last chunk, by the same carry1. A
// ragged last chunk ends at its last real row: pass 1 zero-fills dt past
// l, so exp(la_L) and exp(la_L - la_s) stop there.
constexpr int kCarryBatch = 8;

__device__ __forceinline__ float carry1(float dec, float s, float d) {
  return __fadd_rn(__fmul_rn(dec, s), d);
}
__device__ __forceinline__ float4 carry1(float dec, float4 s, float4 d) {
  return make_float4(carry1(dec, s.x, d.x), carry1(dec, s.y, d.y),
                     carry1(dec, s.z, d.z), carry1(dec, s.w, d.w));
}

// kReverse walks the chunks from the last to the first: the backward's
// R_{c-1} = sum_c + exp(la_L,c) R_c, with R 0 after the last chunk.
template <typename V, bool kReverse>
__global__ void __launch_bounds__(kThreads)
ssd_carry(float* __restrict__ S, const float* __restrict__ dec,
          float* __restrict__ S_final, int H, int nc, int nd) {
  constexpr int kW = sizeof(V) / sizeof(float);
  const int e = kW * (blockIdx.x * kThreads + threadIdx.x);
  if (e >= nd) return;
  const int h = blockIdx.y, b = blockIdx.z;
  V s{};
  for (int c0 = 0; c0 < nc; c0 += kCarryBatch) {
    V d[kCarryBatch];
    float f[kCarryBatch];
#pragma unroll
    for (int u = 0; u < kCarryBatch; ++u) {
      const int c = kReverse ? nc - 1 - (c0 + u) : c0 + u;
      const size_t bch = ((size_t)b * nc + c) * H + h;
      if (c0 + u < nc) {
        d[u] = *reinterpret_cast<const V*>(S + bch * nd + e);
        f[u] = dec[bch];
      }
    }
#pragma unroll
    for (int u = 0; u < kCarryBatch; ++u) {
      const int c = kReverse ? nc - 1 - (c0 + u) : c0 + u;
      const size_t bch = ((size_t)b * nc + c) * H + h;
      if (c0 + u < nc) {
        *reinterpret_cast<V*>(S + bch * nd + e) = s;
        s = carry1(f[u], s, d[u]);
      }
    }
  }
  // the state after the last chunk: prefill hands it to decode
  if (S_final)
    *reinterpret_cast<V*>(S_final + ((size_t)b * H + h) * nd + e) = s;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
