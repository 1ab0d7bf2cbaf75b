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

#include "ssd_scan.cuh"

namespace {

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

// The checks of a plan for passes 1 and 2 (lp, np, dtile, heads as
// ntx_ssd_scan below takes them): 0, or cudaErrorInvalidValue.
int states_plan_error(int b, int l, int h, int dh, int n, int chunk,
                      int is_bf16, int lp, int np, int dtile, int heads) {
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
  if (state_smem(is_bf16, lp, np, dtile, heads) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (b > 65535 || h > 65535) return (int)cudaErrorInvalidValue;
  const int tiles = ((h + heads - 1) / heads) * ((dh + dtile - 1) / dtile);
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  return 0;
}

// Passes 1 and 2 of a checked plan (b, l, h > 0).
int launch_states(const void* x, const void* dt, const void* A,
                  const void* B, float* S, float* dec, float* S_final, int b,
                  int l, int h, int dh, int n, int chunk, int is_bf16,
                  int lp, int np, int dtile, int heads, cudaStream_t s) {
  const int nc = (l + chunk - 1) / chunk;
  const int tiles = ((h + heads - 1) / heads) * ((dh + dtile - 1) / dtile);
  const dim3 grid(nc, b, tiles);
  const size_t smem1 = state_smem(is_bf16, lp, np, dtile, heads);
  cudaError_t err;
  if (is_bf16) {
    err = allow_smem(ssd_state_mma<false>, smem1);
    if (err != cudaSuccess) return (int)err;
    ssd_state_mma<false><<<grid, kThreads, smem1, s>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const bf16*>(B), S, dec, l,
        h, dh, n, chunk, nc, lp, np, dtile, heads);
  } else {
    err = allow_smem(ssd_state_f32<false>, smem1);
    if (err != cudaSuccess) return (int)err;
    ssd_state_f32<false><<<grid, kThreads, smem1, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const float*>(B), S, dec,
        l, h, dh, n, chunk, nc, lp, np, dtile, heads);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nd = n * dh;
  if (nd % 4 == 0)
    ssd_carry<float4, false><<<dim3((nd / 4 + kThreads - 1) / kThreads, h,
                                    b), kThreads, 0, s>>>(S, dec, S_final, h,
                                                          nc, nd);
  else
    ssd_carry<float, false><<<dim3((nd + kThreads - 1) / kThreads, h, b),
                              kThreads, 0, s>>>(S, dec, S_final, h, nc, nd);
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
  const int bad =
      states_plan_error(b, l, h, dh, n, chunk, is_bf16, lp, np, dtile, heads);
  if (bad) return bad;
  const size_t smem3 = out_smem(is_bf16, lp, np, dtile, heads);
  if (smem3 > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (b == 0 || l == 0 || h == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (l + chunk - 1) / chunk;
  const int tiles = ((h + heads - 1) / heads) * ((dh + dtile - 1) / dtile);
  const dim3 grid(nc, b, tiles);
  float* Sf = static_cast<float*>(S);
  int err = launch_states(x, dt, A, B, Sf, static_cast<float*>(dec),
                          static_cast<float*>(S_final), b, l, h, dh, n, chunk,
                          is_bf16, lp, np, dtile, heads, s);
  if (err) return err;

  if (!is_bf16) {
    cudaError_t e = allow_smem(ssd_out_f32, smem3);
    if (e != cudaSuccess) return (int)e;
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

// Passes 1 and 2 alone, as ntx_ssd_scan runs them (no final state): S
// ends holding the state entering each chunk and dec exp(la_L) of each
// chunk. The backward (ssd_scan_bwd.cu) recomputes the forward's states
// with it, so they are the forward's bits.
int ntx_ssd_states(const void* x, const void* dt, const void* A,
                   const void* B, void* S, void* dec, int b, int l, int h,
                   int dh, int n, int chunk, int is_bf16, int lp, int np,
                   int dtile, int heads, void* stream) {
  const int bad =
      states_plan_error(b, l, h, dh, n, chunk, is_bf16, lp, np, dtile, heads);
  if (bad) return bad;
  if (b == 0 || l == 0 || h == 0) return (int)cudaGetLastError();
  return launch_states(x, dt, A, B, static_cast<float*>(S),
                       static_cast<float*>(dec), nullptr, b, l, h, dh, n,
                       chunk, is_bf16, lp, np, dtile, heads,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
