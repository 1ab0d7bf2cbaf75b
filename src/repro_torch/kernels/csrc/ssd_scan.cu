// Mamba-2 SSD (state-space duality) chunked scan on Hopper, forward.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:ssd_scan_pallas
// (_ssd_kernel): the NTX generalized reduction at chunk granularity. The
// recurrent state S (d_state x d_head, fp32) is the wide accumulator,
// carried from chunk to chunk. Per chunk of L steps, with la the
// inclusive cumulative sum of dt * A inside the chunk,
//   y_t = sum_{s<=t} exp(la_t - la_s) (C_t . B_s) dt_s x_s
//         + exp(la_t) C_t . S                          (intra + carried)
//   S  <- exp(la_L) S + sum_s exp(la_L - la_s) dt_s B_s (x) x_s.
//
// Layouts are the model's, so the wrapper copies nothing: x and y
// (b, l, h, dh), dt (b, l, h) fp32, A (h,) fp32, B and C (b, l, n) read
// per batch index and shared by all heads. x, B, C and y are all fp32 or
// all bf16.
//
// Bound on the H100 at the training shapes (b 8, l 1024, h 64, dh 64,
// n 128, chunk 128): the bf16 call reads and writes 0.14 GB (0.042 ms)
// for ~30 GFLOP; in fp32 the operations bound it (0.45 ms at 67 TFLOP/s).
//
// Design: the chunk loop, sequential only in S, is cut into three
// launches, so that every chunk of every sequence runs in parallel:
//   1. state pass, a grid over (chunk, batch, head group x head-dim
//      tile): each chunk's own contribution dS_c = sum_s exp(la_L - la_s)
//      dt_s B_s (x) x_s, and exp(la_L);
//   2. carry pass, a grid over (state elements, head, batch): the state
//      entering each chunk, S_c = exp(la_L,c-1) S_c-1 + dS_c-1, written
//      over dS in place (sequential only over the chunks);
//   3. output pass, a grid over (chunk, batch, head group x head-dim
//      tile): G = C_c B_c^T once for the head group, then per head
//      y = (G o exp(la_t - la_s) dt_s, s <= t) x + exp(la_t) C S_c,
//      rounded once to y's dtype.
// The log-decay la is recomputed by passes 1 and 3 from dt, one warp per
// head (a shuffle scan), with the same code, so both see the same bits.
// The exponent is masked before exp (s <= t), so exp never sees a
// positive exponent (the reference's jnp chunked form takes exp of every
// (t, s) pair and then masks, which overflows to inf * 0 = NaN at chunk
// 128). A ragged last chunk is zero-filled in shared memory and its rows
// past the end are not stored.
//
// bf16 route (passes 1 and 3): every product is a bf16 tensor-core
// mma.sync (m16n8k16, fp32 accumulators), one warp per 16-row strip. C
// B^T takes the bf16 inputs as they are (exact products). W, the decayed
// weights, exp(la_L - la_s) dt_s x_s and S are fp32 values: each is split
// exactly into three bf16 parts (ntx_mma.cuh, split3x2) and multiplied
// against the bf16 input on the other side, so those products too are
// exact and every sum is fp32. (Rounding W and dt x to one bf16 each, as
// the reference's work_dtype route does, does not hold chip_smoke's 1e-2
// check against the plain version at the training shapes.) G stays in the
// warp's registers across the head group, and its accumulator fragments
// become the A fragments of W x without a trip through shared memory.
// fp32 route (passes 1 and 3): register-tiled FFMA on the FP32 pipe,
// no TF32: a thread owns a 4 x 8 tile of the output, and both operands
// come from shared memory as 16-byte loads that the warp's lanes spread
// over distinct addresses (a row per thread with its other operand read
// as a broadcast was bound by shared-memory issue, at a quarter of the
// FP32 rate).
//
// The plan (chunk padded to lp, n to np, the head-dim tile, the heads per
// block) comes from ssd_scan.scan_plan in Python; the kernel refuses any
// other.
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

__host__ __device__ inline size_t out_smem(int mma, int lp, int np, int dt,
                                           int heads) {
  size_t tiles;
  if (mma) {
    const size_t cs = 2ull * lp * (np + kPad), xs = 2ull * lp * (dt + kPad);
    const size_t sp = 6ull * np * (dt + kPad);
    tiles = cs + xs + (sp > cs ? sp : cs);
  } else {
    const size_t ct = 4ull * np * (lp + 4), gt = 4ull * lp * lp;
    const size_t xs = 4ull * (lp + np) * dt;
    tiles = ct + gt + (xs > ct ? xs : ct);
  }
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
    if (w.d0 == 0 && tid == 0)
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
          const float ws = s < w.Lc ? __fmul_rn(expf(__fsub_rn(last, laj[s])),
                                                dts[j * lp + s])
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
    if (w.d0 == 0 && tid == 0)
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
          const float ws = s < w.Lc ? __fmul_rn(expf(__fsub_rn(last, laj[s])),
                                                dts[j * lp + s])
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

template <typename V>
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
      const size_t bch = ((size_t)b * nc + c0 + u) * H + h;
      if (c0 + u < nc) {
        d[u] = *reinterpret_cast<const V*>(S + bch * nd + e);
        f[u] = dec[bch];
      }
    }
#pragma unroll
    for (int u = 0; u < kCarryBatch; ++u) {
      const size_t bch = ((size_t)b * nc + c0 + u) * H + h;
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

// ---------------------------------------------------------------------
// pass 3: y = (G o decay) (dt x) + exp(la_t) C S, per chunk
// ---------------------------------------------------------------------
template <int DT>
__global__ void __launch_bounds__(kThreads, 1)
ssd_out_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const bf16* __restrict__ B,
            const bf16* __restrict__ C, const float* __restrict__ S,
            bf16* __restrict__ y, int l, int H, int dh, int n, int chunk,
            int nc, int lp, int np, int heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ldx = DT + kPad;
  const int ldc = np + kPad;
  bf16* Cs = reinterpret_cast<bf16*>(smem);          // [lp][ldc], exact
  bf16* Xs = Cs + lp * ldc;                          // [lp][ldx], exact x
  bf16* Sp = Xs + lp * ldx;                          // 3 x [np][ldx]
  bf16* Bs = Sp;                                     // [lp][ldc], G only
  const size_t u = (size_t)3 * np * ldx > (size_t)lp * ldc
                       ? (size_t)3 * np * ldx : (size_t)lp * ldc;
  float* dts = reinterpret_cast<float*>(Sp + u);
  float* la = dts + heads * lp;
  const Tile w = tile_of(l, H, dh, chunk, DT, heads);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mi = lane >> 3, r8 = lane & 7, g = lane >> 2, q = lane & 3;

  load_tile_bf16(Cs, ldc, C + w.row0 * n, n, w.Lc, n, lp, np);
  load_tile_bf16(Bs, ldc, B + w.row0 * n, n, w.Lc, n, lp, np);
  chunk_log_decay(dt, A, dts, la, w, H, heads, lp);

  // G = C B^T for this warp's 16 rows t and the columns s <= t, kept in
  // registers for every head: tile i holds s = 8 i .. 8 i + 7
  const int r0 = 16 * warp;
  const bool active = r0 < w.Lc;
  float gt[kMaxChunk / 8][4];
#pragma unroll
  for (int i = 0; i < kMaxChunk / 8; ++i)
    gt[i][0] = gt[i][1] = gt[i][2] = gt[i][3] = 0.0f;
  if (active) {
    for (int kk = 0; kk < np / 16; ++kk) {
      uint32_t a[4];
      ntx::ldsm_x4(a, Cs + (r0 + (mi & 1) * 8 + r8) * ldc + 16 * kk +
                          (mi >> 1) * 8);
#pragma unroll
      for (int tp = 0; tp < kMaxChunk / 16; ++tp) {
        if (tp <= warp) {
          uint32_t bq[4];
          ntx::ldsm_x4(bq, Bs + (16 * tp + (mi >> 1) * 8 + r8) * ldc +
                               16 * kk + (mi & 1) * 8);
          ntx::mma_bf16(gt[2 * tp], a, bq[0], bq[1]);
          ntx::mma_bf16(gt[2 * tp + 1], a, bq[2], bq[3]);
        }
      }
    }
  }
  __syncthreads();   // B is dead: the S planes take its place

  constexpr int kQuads = DT / 4;
  const int cols = min(DT, dh - w.d0);
  const bool vec_s = (dh & 3) == 0;     // S is a fresh, aligned buffer
  const int ta = r0 + g, tb = ta + 8;   // this thread's two rows
  for (int j = 0; j < w.nh; ++j) {
    const float* laj = la + j * lp;
    const float* dtj = dts + j * lp;
    const bf16* xj = x + (w.row0 * H + w.h0 + j) * dh + w.d0;
    load_tile_bf16(Xs, ldx, xj, (size_t)H * dh, w.Lc, cols, lp, DT);
    if (w.c > 0) {
      const float* sj =
          S + (((size_t)w.b * nc + w.c) * H + w.h0 + j) * n * dh + w.d0;
      staged<8, float4>(
          np * kQuads,
          [&](int e) {
            const int k = e / kQuads;
            return k < n ? load4(sj + k * dh, 4 * (e % kQuads), cols, vec_s)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          },
          [&](int e, float4 v) {
            put_split4(Sp + (e / kQuads) * ldx + 4 * (e % kQuads),
                       (size_t)np * ldx, v);
          });
    }
    __syncthreads();
    if (active) {
      float acc[DT / 8][4];
#pragma unroll
      for (int i = 0; i < DT / 8; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
      const float la_a = laj[ta], la_b = laj[tb];
      if (w.c > 0) {   // the carried part: exp(la_t) C S
        for (int kk = 0; kk < np / 16; ++kk) {
          uint32_t a[4];
          ntx::ldsm_x4(a, Cs + (r0 + (mi & 1) * 8 + r8) * ldc + 16 * kk +
                              (mi >> 1) * 8);
#pragma unroll
          for (int tp = 0; tp < DT / 16; ++tp)
#pragma unroll
            for (int p = 0; p < 3; ++p) {
              uint32_t bq[4];
              ntx::ldsm_x4_t(bq, Sp + (p * np + 16 * kk + (mi & 1) * 8 + r8) *
                                          ldx + 16 * tp + (mi >> 1) * 8);
              ntx::mma_bf16(acc[2 * tp], a, bq[0], bq[1]);
              ntx::mma_bf16(acc[2 * tp + 1], a, bq[2], bq[3]);
            }
        }
        const float ea = expf(la_a), eb = expf(la_b);
#pragma unroll
        for (int i = 0; i < DT / 8; ++i) {
          acc[i][0] *= ea;
          acc[i][1] *= ea;
          acc[i][2] *= eb;
          acc[i][3] *= eb;
        }
      }
      // the intra-chunk part: W[t][s] = G[t][s] exp(la_t - la_s) dt_s for
      // s <= t (masked before exp), split into three bf16 A fragments
#pragma unroll
      for (int ks = 0; ks < kMaxChunk / 16; ++ks) {
        if (ks <= warp) {
          uint32_t af[3][4];
#pragma unroll
          for (int hs = 0; hs < 2; ++hs) {
            const int s = 16 * ks + 8 * hs + 2 * q;
            const float l0 = laj[s], l1 = laj[s + 1];
            const float d0 = dtj[s], d1 = dtj[s + 1];
            const float* gv = gt[2 * ks + hs];
            const float wa0 = s <= ta ? gv[0] * expf(la_a - l0) * d0 : 0.0f;
            const float wa1 = s + 1 <= ta ? gv[1] * expf(la_a - l1) * d1
                                          : 0.0f;
            const float wb0 = s <= tb ? gv[2] * expf(la_b - l0) * d0 : 0.0f;
            const float wb1 = s + 1 <= tb ? gv[3] * expf(la_b - l1) * d1
                                          : 0.0f;
            uint32_t pa[3], pb[3];
            ntx::split3x2(wa0, wa1, pa);
            ntx::split3x2(wb0, wb1, pb);
#pragma unroll
            for (int p = 0; p < 3; ++p) {
              af[p][2 * hs] = pa[p];
              af[p][2 * hs + 1] = pb[p];
            }
          }
#pragma unroll
          for (int tp = 0; tp < DT / 16; ++tp) {
            uint32_t bq[4];
            ntx::ldsm_x4_t(bq, Xs + (16 * ks + (mi & 1) * 8 + r8) * ldx +
                                   16 * tp + (mi >> 1) * 8);
#pragma unroll
            for (int p = 0; p < 3; ++p) {
              ntx::mma_bf16(acc[2 * tp], af[p], bq[0], bq[1]);
              ntx::mma_bf16(acc[2 * tp + 1], af[p], bq[2], bq[3]);
            }
          }
        }
      }
      bf16* yj = y + (w.row0 * H + w.h0 + j) * dh + w.d0;
#pragma unroll
      for (int i = 0; i < DT / 8; ++i)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int t = hr ? tb : ta, d = 8 * i + 2 * q;
          if (t < w.Lc && w.d0 + d < dh) {
            bf16* yr = yj + (size_t)t * H * dh + d;
            if ((dh & 1) == 0) {   // w.d0 + d even, so the pair is aligned
              *reinterpret_cast<__nv_bfloat162*>(yr) = __floats2bfloat162_rn(
                  acc[i][2 * hr], acc[i][2 * hr + 1]);
            } else {
              yr[0] = __float2bfloat16(acc[i][2 * hr]);
              if (w.d0 + d + 1 < dh)
                yr[1] = __float2bfloat16(acc[i][2 * hr + 1]);
            }
          }
        }
    }
    __syncthreads();   // Xs and the S planes are rewritten for the next head
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_out_f32(const float* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const float* __restrict__ B,
            const float* __restrict__ C, const float* __restrict__ S,
            float* __restrict__ y, int l, int H, int dh, int n, int chunk,
            int nc, int lp, int np, int dtile, int heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldt = lp + 4;
  float* Ct = reinterpret_cast<float*>(smem);       // [np][ldt]: C^T
  float* Gt = Ct + np * ldt;                        // [lp][lp]: G^T
  float* Xs = Gt + lp * lp;                         // [lp][dtile]: dt x
  float* Ss = Xs + lp * dtile;                      // [np][dtile]
  float* Bt = Xs;                                   // [np][ldt]: B^T, G only
  const int u = (lp + np) * dtile > np * ldt ? (lp + np) * dtile : np * ldt;
  float* dts = Xs + u;
  float* la = dts + heads * lp;
  const Tile w = tile_of(l, H, dh, chunk, dtile, heads);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  staged<8, float2>(
      lp * np,
      [&](int e) {
        const int t = e / np, k = e % np;
        const bool in = t < w.Lc && k < n;
        const size_t at = (w.row0 + t) * n + k;
        return make_float2(in ? C[at] : 0.0f, in ? B[at] : 0.0f);
      },
      [&](int e, float2 v) {
        const int at = (e % np) * ldt + e / np;
        Ct[at] = v.x;
        Bt[at] = v.y;
      });
  chunk_log_decay(dt, A, dts, la, w, H, heads, lp);

  // G^T[s][t] = sum_k C[t][k] B[s][k]: a warp item is 16 rows t by 32
  // columns s (only those with some s <= t), a lane 4 by 4 of them
  const int tbs = lp / 16, sbs = lp / 32;
  for (int wi = warp; wi < tbs * sbs; wi += kWarps) {
    const int tb = wi % tbs, sb = wi / tbs;
    if (32 * sb > 16 * tb + 15 || 16 * tb >= w.Lc) continue;   // warp-uniform
    const int t0 = 16 * tb + 4 * (lane & 3), s0 = 32 * sb + 4 * (lane >> 2);
    float acc[4][4] = {};
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float4 c = ld4(Ct + k * ldt + t0), b = ld4(Bt + k * ldt + s0);
      const float cv[4] = {c.x, c.y, c.z, c.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[i][jj] = fmaf(cv[i], bv[jj], acc[i][jj]);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      *reinterpret_cast<float4*>(Gt + (s0 + jj) * lp + t0) =
          make_float4(acc[0][jj], acc[1][jj], acc[2][jj], acc[3][jj]);
  }
  __syncthreads();   // B^T is dead: dt x and S take its place

  // output warp items: 4 TQ rows by 8 DQ columns, a lane 4 by 8 of them
  const int DQ = dtile / 8 < 8 ? dtile / 8 : 8, TQ = 32 / DQ;
  const int rows_w = 4 * TQ, cols_w = 8 * DQ;
  const int rbs = lp / rows_w, cbs = dtile / cols_w;
  const int vpr = dtile / 4;
  const int cols = min(dtile, dh - w.d0);
  const bool vec_x = (dh & 3) == 0 && aligned16(x), vec_s = (dh & 3) == 0;
  for (int j = 0; j < w.nh; ++j) {
    const float* laj = la + j * lp;
    const float* dtj = dts + j * lp;
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
          const float d = dtj[e / vpr];
          *reinterpret_cast<float4*>(Xs + 4 * e) =
              make_float4(__fmul_rn(d, v.x), __fmul_rn(d, v.y),
                          __fmul_rn(d, v.z), __fmul_rn(d, v.w));
        });
    if (w.c > 0) {
      const float* sj =
          S + (((size_t)w.b * nc + w.c) * H + w.h0 + j) * n * dh + w.d0;
      staged<8, float4>(
          np * vpr,
          [&](int e) {
            const int k = e / vpr;
            return k < n ? load4(sj + k * dh, 4 * (e % vpr), cols, vec_s)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          },
          [&](int e, float4 v) {
            *reinterpret_cast<float4*>(Ss + 4 * e) = v;
          });
    }
    __syncthreads();
    float* yj = y + (w.row0 * H + w.h0 + j) * dh;
    for (int wi = warp; wi < rbs * cbs; wi += kWarps) {
      const int rb = wi % rbs, cb = wi / rbs;
      if (rb * rows_w >= w.Lc) continue;                      // warp-uniform
      const int t0 = rb * rows_w + 4 * (lane % TQ);
      const int d0 = cb * cols_w + 8 * (lane / TQ);
      float acc[4][8] = {};
      const float lt[4] = {laj[t0], laj[t0 + 1], laj[t0 + 2], laj[t0 + 3]};
      if (w.c > 0) {   // the carried part: exp(la_t) C S
#pragma unroll 4
        for (int k = 0; k < n; ++k)
          fma4x8(acc, ld4(Ct + k * ldt + t0), ld4(Ss + k * dtile + d0),
                 ld4(Ss + k * dtile + d0 + 4));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = expf(lt[i]);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) acc[i][jj] *= e;
        }
      }
      // the intra-chunk part: W[t][s] = G[t][s] exp(la_t - la_s) for
      // s <= t (masked before exp), times dt_s x_s
      const int s_end = min(w.Lc, (rb + 1) * rows_w);        // warp-uniform
#pragma unroll 4
      for (int s = 0; s < s_end; ++s) {
        const float4 g = ld4(Gt + s * lp + t0);
        const float gv[4] = {g.x, g.y, g.z, g.w};
        const float ls = laj[s];
        float wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wv[i] = s <= t0 + i ? gv[i] * __expf(lt[i] - ls) : 0.0f;
        fma4x8(acc, make_float4(wv[0], wv[1], wv[2], wv[3]),
               ld4(Xs + s * dtile + d0), ld4(Xs + s * dtile + d0 + 4));
      }
      store4x8(yj, (size_t)H * dh, t0, w.Lc, w.d0 + d0, dh, acc, vec_s);
    }
    __syncthreads();
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int DT>
int launch_out_mma(dim3 grid, size_t bytes, cudaStream_t s, const void* x,
                   const void* dt, const void* A, const void* B,
                   const void* C, const float* S, void* y, int l, int h,
                   int dh, int n, int chunk, int nc, int lp, int np,
                   int heads) {
  cudaError_t err = allow_smem(ssd_out_mma<DT>, bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_out_mma<DT><<<grid, kThreads, bytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(B),
      static_cast<const bf16*>(C), S, static_cast<bf16*>(y), l, h, dh, n,
      chunk, nc, lp, np, heads);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y (b, l, h, dh); dt (b, l, h) fp32; A (h,) fp32; B, C (b, l, n):
// contiguous on the device, x, B and C 16-byte aligned; x, B, C, y all
// fp32 (is_bf16 = 0) or all bf16. S: (b, ceil(l / chunk), h, n, dh) fp32
// scratch (ends holding the state entering each chunk); dec: (b, nc, h)
// fp32 scratch; S_final: null, or (b, h, n, dh) fp32, 16-byte aligned,
// which receives the state after the last chunk. The plan: lp = chunk
// rounded up to 16 (bf16) or 32 (fp32), at most 128; np = n rounded up
// to 16; dtile, the head-dim columns of a block, 16/32/64/128 (bf16) or
// 32/64/128 (fp32); heads per block 1..64; each pass's shared memory at
// most 227 KB. Three launches.
int ntx_ssd_scan(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, void* y, void* S, void* dec, void* S_final,
                 int b, int l, int h, int dh, int n, int chunk, int is_bf16,
                 int lp, int np, int dtile, int heads, void* stream) {
  if (b < 0 || l < 0 || h < 0 || dh <= 0 || n <= 0 || chunk <= 0 ||
      chunk > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  if (lp != round_up(chunk, is_bf16 ? 16 : 32) || lp > kMaxChunk ||
      np != round_up(n, 16) || heads < 1 || heads > kMaxHeads)
    return (int)cudaErrorInvalidValue;
  const bool dt_ok = is_bf16 ? (dtile == 16 || dtile == 32 || dtile == 64 ||
                             dtile == 128)
                          : (dtile == 32 || dtile == 64 || dtile == 128);
  if (!dt_ok) return (int)cudaErrorInvalidValue;
  const size_t smem1 = state_smem(is_bf16, lp, np, dtile, heads);
  const size_t smem3 = out_smem(is_bf16, lp, np, dtile, heads);
  if (smem1 > (size_t)kMaxSmem || smem3 > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || l == 0 || h == 0) return (int)cudaGetLastError();
  if (b > 65535 || h > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (l + chunk - 1) / chunk;
  const int tiles = ((h + heads - 1) / heads) * ((dh + dtile - 1) / dtile);
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(nc, b, tiles);
  float* Sf = static_cast<float*>(S);
  float* decf = static_cast<float*>(dec);
  float* finf = static_cast<float*>(S_final);
  cudaError_t err;

  if (is_bf16) {
    err = allow_smem(ssd_state_mma, smem1);
    if (err != cudaSuccess) return (int)err;
    ssd_state_mma<<<grid, kThreads, smem1, s>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const bf16*>(B), Sf, decf,
        l, h, dh, n, chunk, nc, lp, np, dtile, heads);
  } else {
    err = allow_smem(ssd_state_f32, smem1);
    if (err != cudaSuccess) return (int)err;
    ssd_state_f32<<<grid, kThreads, smem1, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const float*>(B), Sf, decf,
        l, h, dh, n, chunk, nc, lp, np, dtile, heads);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int nd = n * dh;
  if (nd % 4 == 0)
    ssd_carry<float4><<<dim3((nd / 4 + kThreads - 1) / kThreads, h, b),
                        kThreads, 0, s>>>(Sf, decf, finf, h, nc, nd);
  else
    ssd_carry<float><<<dim3((nd + kThreads - 1) / kThreads, h, b), kThreads,
                       0, s>>>(Sf, decf, finf, h, nc, nd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if (!is_bf16) {
    err = allow_smem(ssd_out_f32, smem3);
    if (err != cudaSuccess) return (int)err;
    ssd_out_f32<<<grid, kThreads, smem3, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const float*>(B),
        static_cast<const float*>(C), Sf, static_cast<float*>(y), l, h, dh,
        n, chunk, nc, lp, np, dtile, heads);
    return (int)cudaGetLastError();
  }
  switch (dtile) {
    case 16:
      return launch_out_mma<16>(grid, smem3, s, x, dt, A, B, C, Sf, y, l, h,
                                dh, n, chunk, nc, lp, np, heads);
    case 32:
      return launch_out_mma<32>(grid, smem3, s, x, dt, A, B, C, Sf, y, l, h,
                                dh, n, chunk, nc, lp, np, heads);
    case 64:
      return launch_out_mma<64>(grid, smem3, s, x, dt, A, B, C, Sf, y, l, h,
                                dh, n, chunk, nc, lp, np, heads);
    default:
      return launch_out_mma<128>(grid, smem3, s, x, dt, A, B, C, Sf, y, l, h,
                                 dh, n, chunk, nc, lp, np, heads);
  }
}

}  // extern "C"
