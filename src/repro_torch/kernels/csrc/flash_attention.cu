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
// kv_len - sq + i; masked logits are -1e30 (not -inf), so the running
// max, the correction exp(m_prev - m_new) and the final guard (l == 0 ->
// 1) behave exactly as in the reference: a row with no valid key averages
// every key of the array. Keys past the end of the array are excluded
// from the max and weigh 0. m, l and acc are fp32. Logits are kept in
// base 2 (scale * log2 e), so exp2 replaces exp; -1e30 stays -1e30.
//
// Bound on the H100: a causal prefill at a real prompt length is bound by
// operations (b 1, hq 32, s 4096, d 128: 137 GFLOP over the unmasked
// pairs, 0.139 ms at 989 TFLOP/s); a decode step by bytes (the K/V cache
// read once: b 4, hkv 8, kv_len 4000, d 128 bf16 is 65.5 MB, 0.0196 ms).
//
// Design. One planner, kernels/flash_attention.py:flash_plan, cuts the
// call; the kernel takes its plan as arguments and refuses one it cannot
// run (shared memory past the card's 227 KB, tiles that do not fit).
// * Rows. A block takes gh query heads of one kv head (b, kv head) times
//   qn queries: row r is head j0 + r / qn, query q0 + r % qn. A long
//   prefill takes gh = 1, qn = 128; decode stacks the group's g heads (g =
//   4, sq = 1: 4 rows), so each K/V tile is read once for all g heads.
//   q / k / v / o are read by element strides (batch, head, seq; d
//   contiguous): the (b, s, h, d) projections viewed as (b, h, s, d) are
//   not copied.
// * Keys. A block visits key tiles up to the last one that holds a key <=
//   min(kv_len - 1, its last query position); every later key of a row
//   with a valid key weighs exp(-1e30 - m) = 0, so stopping there changes
//   nothing. A block holding a row with no valid key visits every key, as
//   the reference does. Masks are computed only on tiles past the keys
//   every row of the block takes (the diagonal, kv_len, the array's end).
//   Longest blocks (the last query tiles) are launched first.
// * bf16: tensor cores. mma.sync m16n8k16 bf16 -> fp32; WR row warps (16
//   rows each) x WK key warps (64 / WK keys of each 64-key tile): 8 x 1
//   for long prefills (128 rows, so each K/V tile is read from L2 once for
//   128 rows), else 4 warps, 4 x 1, 2 x 2 or 1 x 4. Q fragments are
//   loaded once into registers; K and V tiles of 64 keys come through a
//   2-stage (WR = 4: two blocks per SM) or 3-stage ring of bf16 rows
//   padded by 16 bytes (conflict-free ldmatrix), filled by
//   16-byte cp.async (masked 2-byte loads for operands off a 16-byte
//   boundary). S = Q K^T with K (key, d) row-major as the col-major B
//   operand; the online softmax runs on the accumulator fragments (row max
//   and sum over each quad by shuffles); P becomes the PV mma's A
//   fragments in registers as one bf16 (the plain math with P rounded to
//   bf16 stays within 0.31 of the bf16 tolerance at the checked shapes,
//   tests/test_torch_attention_plans.py); V comes by ldmatrix.trans. The
//   WK key warps' (m, l, acc) are merged through shared memory.
// * fp32: IEEE FFMA (never TF32): lane j computes the logit of key j of a
//   32-key tile for each of its warp's 4 rows, row max and sum by warp
//   shuffles, D / 32 output columns per lane in registers. It takes the
//   same rows, key bound, strides and splits.
// * Head dims. q/k rows of d and v rows of dv, instantiated for the pairs
//   (64, 64), (128, 128) and MLA's (192, 128) (deepseek-v2: 128 nope + 64
//   rope dims against v of 128): S = Q K^T runs over d (12 mma k-steps at
//   192), P V, the accumulator, the merge and the output over dv. At
//   (192, 128) the 8-row-warp block's Q, K ring and V ring take ~180 KB;
//   the fp32 route's 53 KB opt in past the 48 KiB static limit.
// * Split-kv. When the blocks do not fill the card (decode: b * hkv = 32
//   groups), the planner splits each block's key tiles into contiguous
//   ranges (one wave over 132 SMs). Each split writes fp32 (m, l, acc) to
//   a workspace the wrapper allocates; flash_merge then combines them in
//   split order, applies the guard and rounds once. No float atomics: two
//   calls give the same bits.
// * lse: the kernel can also write each row's natural log-sum-exp of the
//   scaled logits, m ln 2 + log(max(l, 1e-30)) (m in base 2), as the
//   reference's mha_blocked forward saves it for its backward
//   (csrc/flash_attention_bwd.cu; training takes unsplit plans). With
//   splits, flash_merge writes it beside o from the merged row:
//   m* ln 2 + log(max(sum_z l_z 2^(m_z - m*), 1e-30)), m* the splits'
//   largest m. A decode over a sequence-sharded cache merges such
//   (o, lse) pairs across ranks (models/common.py:merge_partials). Only
//   when asked: o is the same either way.
// Left for later: a register-tiled fp32 route; wgmma with TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ntx_mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSmem = 232448;
constexpr int kMaxSplits = 64;
constexpr int kTcKeys = 64;     // keys per tile, tensor-core route
constexpr int kF32Keys = 32;    // keys per tile, fp32 route
constexpr int kF32Rows = 16;    // rows per block, fp32 route
constexpr int kPad = 8;         // bf16 elements of row padding
constexpr float kMasked = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// Everything a launch needs; strides are in elements (batch, head, seq).
struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* ws;
  float* lse;                   // (b, hq, sq) or null
  long long qs[3], ks[3], vs[3], os[3];
  int b, hq, hkv, sq, skv, kv_len, causal;
  float scale2;                 // scale * log2(e)
  int g, gh, qn, q_tiles, head_blocks, splits;
};

// Shared memory of a tensor-core block (flash_attention.tc_smem) for q/k
// rows of dqk and v rows of dv: Q rows and the K ring at dqk, the V ring at
// dv, or the fp32 staging of the merge (dv wide), whichever is larger.
// A block of wr row warps has max(4, wr) warps: wr = 1, 2, 4 split each
// key tile over 4 / wr key warps, wr = 8 (long prefills) takes 128 rows.
__host__ __device__ constexpr int tc_warps(int wr) { return wr > 4 ? wr : 4; }
__host__ __device__ constexpr int tc_stages(int wr) { return wr == 4 ? 2 : 3; }
__host__ __device__ constexpr size_t tc_smem(int dqk, int dv, int wr) {
  const size_t ring =
      2 * ((size_t)16 * wr * (dqk + kPad) +
           (size_t)tc_stages(wr) * kTcKeys * (dqk + kPad + dv + kPad));
  const size_t rows = (size_t)16 * tc_warps(wr);   // key warps x rows
  const size_t out = 4 * (rows * (dv + 4) + 2 * rows);
  return ring > out ? ring : out;
}
// The fp32 route's shared memory (flash_attention.f32_smem): Q rows, a K
// tile (rows padded by one) at dqk and a V tile at dv; above 48 KiB (dqk
// 192) the launch opts in.
__host__ __device__ constexpr size_t f32_smem(int dqk, int dv) {
  return 4 * ((size_t)kF32Rows * dqk + (size_t)kF32Keys * (dqk + 1) +
              (size_t)kF32Keys * dv);
}
// The (q/k, v) head-dim pairs the kernels are instantiated for: equal dims
// of the GQA models, and MLA's 192 (128 nope + 64 rope) against v of 128.
__host__ __device__ constexpr bool head_pair(int dqk, int dv) {
  return (dqk == 64 && dv == 64) || (dqk == 128 && dv == 128) ||
         (dqk == 192 && dv == 128);
}

// Where a block sits and which keys it takes.
struct Geo {
  int b, kvh, j0, q0, qlo, t0, t1, full;
};

__device__ __forceinline__ Geo geometry(const Args& a, int bk) {
  Geo g;
  const int hb = blockIdx.x % a.head_blocks;
  const int grp = blockIdx.x / a.head_blocks;
  g.b = grp / a.hkv;
  g.kvh = grp % a.hkv;
  g.j0 = hb * a.gh;
  g.q0 = (a.q_tiles - 1 - (int)blockIdx.y) * a.qn;   // longest first
  const int qn = min(a.qn, a.sq - g.q0);
  g.qlo = a.kv_len - a.sq + g.q0;
  const int qhi = g.qlo + qn - 1;
  // valid keys of the block's first and last row: [0, lim)
  const int lim_lo = a.causal ? min(a.kv_len, g.qlo + 1) : a.kv_len;
  const int lim_hi = a.causal ? min(a.kv_len, qhi + 1) : a.kv_len;
  const int visit = lim_lo <= 0 ? a.skv : min(a.skv, lim_hi);
  g.full = max(0, min(a.skv, lim_lo));
  const int nt = (visit + bk - 1) / bk;
  g.t0 = (int)((long long)blockIdx.z * nt / a.splits);
  g.t1 = (int)((long long)(blockIdx.z + 1) * nt / a.splits);
  return g;
}

// The logit of (row at query position qpos, key kp) in base 2, masked as
// the reference masks it; keys past the array are -inf (weight 0).
__device__ __forceinline__ float mask(const Args& a, float x, int kp,
                                      int qpos) {
  if (kp >= a.skv) return -INFINITY;
  return (kp < a.kv_len && (!a.causal || kp <= qpos)) ? x : kMasked;
}

// 2^x by the SFU in one instruction (results below 2^-126 flush to 0),
// for the tensor-core route whose P is rounded to bf16 anyway
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// One finished row element: to o (one split: acc / l, the guard, one
// rounding, and the row's lse if asked) or, with splits, to the workspace
// as fp32 (m, l, acc).
template <typename T>
__device__ __forceinline__ void put(const Args& a, int b, int h, int i, int c,
                                   int d, float m, float l, float acc) {
  if (a.splits == 1) {
    T* o = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[1] + i * a.os[2];
    store(o + c, acc / (l == 0.0f ? 1.0f : l));
    if (a.lse != nullptr && c == 0)
      a.lse[((long long)b * a.hq + h) * a.sq + i] =
          m * kLn2 + logf(fmaxf(l, 1e-30f));
    return;
  }
  const long long rows = (long long)a.b * a.hq * a.sq;
  const long long row = ((long long)b * a.hq + h) * a.sq + i;
  const long long at = (long long)blockIdx.z * rows + row;
  a.ws[2 * (long long)a.splits * rows + at * d + c] = acc;
  if (c == 0) {
    a.ws[2 * at] = m;
    a.ws[2 * at + 1] = l;
  }
}

// ---------------------------------------------------------------------
// bf16 route: tensor cores, a cp.async ring.
// ---------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(ntx::smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// n rows of D bf16 at src + row_offset(r) into dst (row stride LD), zero
// where ok(r) is false: 16-byte cp.async (VEC) or masked 2-byte loads.
template <int D, bool VEC, int NT, class Off>
__device__ __forceinline__ void load_rows(uint16_t* dst, const uint16_t* src,
                                          int n, Off off) {
  constexpr int LD = D + kPad, CH = D / 8;
  for (int c = threadIdx.x; c < n * CH; c += NT) {
    const int r = c / CH, col = (c % CH) * 8;
    const long long o = off(r);
    if (VEC) {
      cp_async16(dst + r * LD + col, o >= 0 ? src + o + col : src,
                 o >= 0 ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[r * LD + col + e] = o >= 0 ? src[o + col + e] : (uint16_t)0;
    }
  }
}

template <int D, int DV, int WR, bool VEC>
__global__ void __launch_bounds__(32 * tc_warps(WR), 1)
flash_tc(const Args a) {
  // D: the q/k head dim (S = Q K^T runs over it); DV: v's (P V and the
  // output accumulator run over it)
  constexpr int NT = 32 * tc_warps(WR), WK = tc_warps(WR) / WR;
  constexpr int R = 16 * WR, KW = kTcKeys / WK, NS = KW / 8;
  constexpr int ST = tc_stages(WR), LD = D + kPad, LDV = DV + kPad;
  constexpr int LDO = DV + 4;
  constexpr int QT = R * LD, KT = kTcKeys * LD, VTL = kTcKeys * LDV;
  static_assert(NS % 2 == 0 && KW % 16 == 0, "whole mma tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem);
  uint16_t* sK = sQ + QT;
  uint16_t* sV = sK + ST * KT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp / WK, wk = warp % WK;
  const Geo geo = geometry(a, kTcKeys);
  const int nrow = a.gh * a.qn;
  const uint16_t* q = static_cast<const uint16_t*>(a.q);
  const uint16_t* kb = static_cast<const uint16_t*>(a.k) + geo.b * a.ks[0] +
                       geo.kvh * a.ks[1];
  const uint16_t* vb = static_cast<const uint16_t*>(a.v) + geo.b * a.vs[0] +
                       geo.kvh * a.vs[1];
  const int h0 = geo.kvh * a.g + geo.j0;
  auto q_off = [&](int r) -> long long {
    const int i = geo.q0 + r % a.qn;
    if (r >= nrow || i >= a.sq) return -1;
    return geo.b * a.qs[0] + (long long)(h0 + r / a.qn) * a.qs[1] +
           (long long)i * a.qs[2];
  };
  auto load_kv = [&](int t, int st) {
    const int k0 = t * kTcKeys;
    load_rows<D, VEC, NT>(sK + st * KT, kb, kTcKeys, [&](int r) -> long long {
      return k0 + r < a.skv ? (long long)(k0 + r) * a.ks[2] : -1;
    });
    load_rows<DV, VEC, NT>(sV + st * VTL, vb, kTcKeys,
                           [&](int r) -> long long {
      return k0 + r < a.skv ? (long long)(k0 + r) * a.vs[2] : -1;
    });
  };

  // this thread's two rows (g and g + 8 of its warp's 16) and positions
  const int r0 = wr * 16 + (lane >> 2);
  const int qpos[2] = {geo.qlo + r0 % a.qn, geo.qlo + (r0 + 8) % a.qn};
  float m[2] = {kMasked, kMasked}, l[2] = {0.0f, 0.0f};
  float acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  uint32_t qf[D / 16][4];

  const int nkt = geo.t1 - geo.t0;
  load_rows<D, VEC, NT>(sQ, q, R, q_off);
  if (nkt > 0) load_kv(geo.t0, 0);
  cp_async_commit();
#pragma unroll
  for (int st = 1; st < ST - 1; ++st) {
    if (st < nkt) load_kv(geo.t0 + st, st);
    cp_async_commit();
  }
  for (int it = 0; it < nkt; ++it) {
    cp_async_wait<ST - 2>();            // tile it (and Q) has landed
    __syncthreads();                    // ... for all; stage it - 1 is free
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ntx::ldsm_x4(qf[kk], sQ + (wr * 16 + (lane & 15)) * LD + kk * 16 +
                                 (lane >> 4) * 8);
    }
    const int nxt = it + ST - 1;
    if (nxt < nkt) load_kv(geo.t0 + nxt, nxt % ST);
    cp_async_commit();
    const uint16_t* kt = sK + (it % ST) * KT;
    const uint16_t* vt = sV + (it % ST) * VTL;
    const int t = geo.t0 + it;

    // S = Q K^T for the warp's 16 rows and KW keys. Each k step's K
    // fragments are loaded while the previous step's mma run (lanes 0-15:
    // keys 0-7 at d 0 / d 8; lanes 16-31: keys 8-15)
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    uint32_t kf[2][NS / 2][4];
    const uint16_t* krow = kt + (wk * KW + (lane & 7) + ((lane >> 4) << 3)) *
                                    LD + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int np = 0; np < NS / 2; ++np)
      ntx::ldsm_x4(kf[0][np], krow + np * 16 * LD);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if (kk + 1 < D / 16) {
#pragma unroll
        for (int np = 0; np < NS / 2; ++np)
          ntx::ldsm_x4(kf[(kk + 1) & 1][np],
                       krow + np * 16 * LD + (kk + 1) * 16);
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        const uint32_t* r = kf[kk & 1][np];
        ntx::mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
        ntx::mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= a.scale2;
    if ((t + 1) * kTcKeys > geo.full) {   // a tile the masks reach
      const int kbase = t * kTcKeys + wk * KW + 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = mask(a, s[n][e], kbase + n * 8 + (e & 1), qpos[e >> 1]);
    }
    // online softmax on the fragments: rows g (e 0-1) and g + 8 (e 2-3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float corr[2], ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = ex2(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = ex2(s[n][e] - m[e >> 1]);
        ps[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = corr[h] * l[h] + ps[h];
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // acc += P V: P's fragments are S's, rounded to bf16; V's fragments
    // come two (key step, d pair) steps ahead of their mma
    constexpr int DP = DV / 16, VT = KW / 16 * DP;
    const uint16_t* vrow =
        vt + (wk * KW + (lane & 15)) * LDV + (lane >> 4) * 8;
    uint32_t vf[3][4];
    ntx::ldsm_x4_t(vf[0], vrow);
    ntx::ldsm_x4_t(vf[1], vrow + (1 / DP) * 16 * LDV + (1 % DP) * 16);
    uint32_t pa[4];
#pragma unroll
    for (int st = 0; st < VT; ++st) {
      const int t2 = st / DP, dp = st % DP;
      if (st + 2 < VT)
        ntx::ldsm_x4_t(vf[(st + 2) % 3], vrow + ((st + 2) / DP) * 16 * LDV +
                                             ((st + 2) % DP) * 16);
      if (dp == 0) {
        pa[0] = ntx::bits(__floats2bfloat162_rn(s[2 * t2][0], s[2 * t2][1]));
        pa[1] = ntx::bits(__floats2bfloat162_rn(s[2 * t2][2], s[2 * t2][3]));
        pa[2] = ntx::bits(
            __floats2bfloat162_rn(s[2 * t2 + 1][0], s[2 * t2 + 1][1]));
        pa[3] = ntx::bits(
            __floats2bfloat162_rn(s[2 * t2 + 1][2], s[2 * t2 + 1][3]));
      }
      ntx::mma_bf16(acc[2 * dp], pa, vf[st % 3][0], vf[st % 3][1]);
      ntx::mma_bf16(acc[2 * dp + 1], pa, vf[st % 3][2], vf[st % 3][3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                      // the ring is free: stage the rows

  // each key warp's (m, l, acc) to shared memory, then merged in key-warp
  // order and written a row element per thread
  float* so = reinterpret_cast<float*>(smem);       // [WK][R][LDO]
  float* sm = so + WK * R * LDO;                    // [WK][R]
  float* sl = sm + WK * R;                          // [WK][R]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if ((lane & 3) == 0) {
      sm[wk * R + r0 + 8 * h] = m[h];
      sl[wk * R + r0 + 8 * h] = l[h];
    }
  }
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      so[(wk * R + r0 + 8 * (e >> 1)) * LDO + n * 8 + 2 * (lane & 3) +
         (e & 1)] = acc[n][e];
  __syncthreads();
  for (int e = tid; e < R * DV; e += NT) {
    const int r = e / DV, c = e % DV;
    const int i = geo.q0 + r % a.qn;
    if (r >= nrow || i >= a.sq) continue;
    float mm = sm[r];
#pragma unroll
    for (int w = 1; w < WK; ++w) mm = fmaxf(mm, sm[w * R + r]);
    float ll = 0.0f, aa = 0.0f;
#pragma unroll
    for (int w = 0; w < WK; ++w) {
      const float f = exp2f(sm[w * R + r] - mm);
      ll += sl[w * R + r] * f;
      aa += so[(w * R + r) * LDO + c] * f;
    }
    put<__nv_bfloat16>(a, geo.b, h0 + r / a.qn, i, c, DV, mm, ll, aa);
  }
}

// ---------------------------------------------------------------------
// fp32 route: IEEE FFMA, 16 rows a block, 4 a warp, 32-key tiles; q/k rows
// of D, v rows of DV, in dynamic shared memory.
// ---------------------------------------------------------------------
template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
flash_f32(const Args a) {
  constexpr int NC = DV / 32, RW = kF32Rows / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float (*Qs)[D] = reinterpret_cast<float (*)[D]>(smem);
  float (*Ks)[D + 1] = reinterpret_cast<float (*)[D + 1]>(Qs + kF32Rows);
  float (*Vs)[DV] = reinterpret_cast<float (*)[DV]>(Ks + kF32Keys);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Geo geo = geometry(a, kF32Keys);
  const int nrow = a.gh * a.qn, h0 = geo.kvh * a.g + geo.j0;
  const float* q = static_cast<const float*>(a.q);
  const float* kb = static_cast<const float*>(a.k) + geo.b * a.ks[0] +
                    geo.kvh * a.ks[1];
  const float* vb = static_cast<const float*>(a.v) + geo.b * a.vs[0] +
                    geo.kvh * a.vs[1];
  for (int e = tid; e < kF32Rows * D; e += kThreads) {
    const int r = e / D, c = e % D, i = geo.q0 + r % a.qn;
    Qs[r][c] = (r < nrow && i < a.sq)
                   ? q[geo.b * a.qs[0] + (long long)(h0 + r / a.qn) * a.qs[1] +
                       (long long)i * a.qs[2] + c]
                   : 0.0f;
  }
  float m[RW], l[RW], acc[RW][NC];
#pragma unroll
  for (int w = 0; w < RW; ++w) {
    m[w] = kMasked;
    l[w] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[w][c] = 0.0f;
  }
  for (int t = geo.t0; t < geo.t1; ++t) {
    const int k0 = t * kF32Keys;
    __syncthreads();                    // the previous tile is consumed
    for (int e = tid; e < kF32Keys * D; e += kThreads) {
      const int j = e / D, c = e % D;
      Ks[j][c] = k0 + j < a.skv ? kb[(long long)(k0 + j) * a.ks[2] + c] : 0.0f;
    }
    for (int e = tid; e < kF32Keys * DV; e += kThreads) {
      const int j = e / DV, c = e % DV;
      Vs[j][c] = k0 + j < a.skv ? vb[(long long)(k0 + j) * a.vs[2] + c] : 0.0f;
    }
    __syncthreads();
    const bool masked = (t + 1) * kF32Keys > geo.full;
#pragma unroll
    for (int w = 0; w < RW; ++w) {
      const int r = warp + 4 * w;
      float s = 0.0f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) s = fmaf(Qs[r][c], Ks[lane][c], s);
      s *= a.scale2;
      if (masked) s = mask(a, s, k0 + lane, geo.qlo + r % a.qn);
      float mx = s;
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[w], mx);
      const float p = exp2f(s - m_new);
      float ps = p;
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      const float corr = exp2f(m[w] - m_new);
      l[w] = corr * l[w] + ps;
      m[w] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[w][c] *= corr;
      for (int j = 0; j < kF32Keys; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[w][c] = fmaf(pj, Vs[j][lane + 32 * c], acc[w][c]);
      }
    }
  }
#pragma unroll
  for (int w = 0; w < RW; ++w) {
    const int r = warp + 4 * w, i = geo.q0 + r % a.qn;
    if (r >= nrow || i >= a.sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      put<float>(a, geo.b, h0 + r / a.qn, i, lane + 32 * c, DV, m[w], l[w],
                 acc[w][c]);
  }
}

// ---------------------------------------------------------------------
// The splits' partials, merged in split order: one output element per
// thread, the guard, one rounding.
// ---------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
flash_merge(const float* __restrict__ ws, T* __restrict__ o,
            float* __restrict__ lse, long long os0, long long os1,
            long long os2, int b, int hq, int sq, int d, int splits) {
  const long long rows = (long long)b * hq * sq;
  const float* wacc = ws + 2 * (long long)splits * rows;
  const long long total = rows * d;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long row = e / d;
    const int c = (int)(e % d);
    float mm = ws[2 * row];
    for (int z = 1; z < splits; ++z) mm = fmaxf(mm, ws[2 * (z * rows + row)]);
    float ll = 0.0f, aa = 0.0f;
    for (int z = 0; z < splits; ++z) {
      const long long at = z * rows + row;
      const float f = exp2f(ws[2 * at] - mm);
      ll += ws[2 * at + 1] * f;
      aa += wacc[at * d + c] * f;
    }
    const int i = (int)(row % sq), h = (int)(row / sq % hq);
    const long long bi = row / ((long long)sq * hq);
    store(o + bi * os0 + h * os1 + i * os2 + c, aa / (ll == 0.0f ? 1.0f : ll));
    if (lse != nullptr && c == 0)
      lse[row] = mm * kLn2 + logf(fmaxf(ll, 1e-30f));
  }
}

template <typename T>
cudaError_t launch_merge(const float* ws, void* o, float* lse,
                         const long long* os, int b, int hq, int sq, int d,
                         int splits, cudaStream_t s) {
  const long long total = (long long)b * hq * sq * d;
  const long long need = (total + 255) / 256;
  const int blocks = (int)(need < 132 * 16 ? need : 132 * 16);
  flash_merge<T><<<blocks, 256, 0, s>>>(ws, static_cast<T*>(o), lse, os[0],
                                        os[1], os[2], b, hq, sq, d, splits);
  return cudaGetLastError();
}

// Opt a kernel into `smem` bytes of dynamic shared memory once per device.
template <class K>
cudaError_t opt_in(K kernel, size_t smem, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <int D, int DV, int WR, bool VEC>
cudaError_t launch_tc(const Args& a, dim3 grid, cudaStream_t s) {
  static bool done[64] = {};
  const size_t smem = tc_smem(D, DV, WR);
  const cudaError_t err = opt_in(flash_tc<D, DV, WR, VEC>, smem, done);
  if (err != cudaSuccess) return err;
  flash_tc<D, DV, WR, VEC><<<grid, 32 * tc_warps(WR), smem, s>>>(a);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch_pair(const Args& a, bool bf16, bool vec, int wr, dim3 grid,
                        cudaStream_t s) {
  if (!bf16) {
    static bool done[64] = {};
    const size_t smem = f32_smem(D, DV);
    const cudaError_t err = opt_in(flash_f32<D, DV>, smem, done);
    if (err != cudaSuccess) return err;
    flash_f32<D, DV><<<grid, kThreads, smem, s>>>(a);
    return cudaGetLastError();
  }
  if (vec) {
    if (wr == 1) return launch_tc<D, DV, 1, true>(a, grid, s);
    if (wr == 2) return launch_tc<D, DV, 2, true>(a, grid, s);
    if (wr == 4) return launch_tc<D, DV, 4, true>(a, grid, s);
    return launch_tc<D, DV, 8, true>(a, grid, s);
  }
  if (wr == 1) return launch_tc<D, DV, 1, false>(a, grid, s);
  if (wr == 2) return launch_tc<D, DV, 2, false>(a, grid, s);
  if (wr == 4) return launch_tc<D, DV, 4, false>(a, grid, s);
  return launch_tc<D, DV, 8, false>(a, grid, s);
}

bool aligned16(const void* p, const long long* st) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0 && st[0] % 8 == 0 &&
         st[1] % 8 == 0 && st[2] % 8 == 0;
}

}  // namespace

extern "C" {

// q (b, hq, sq, d), k (b, hkv, skv, d), v (b, hkv, skv, dv), o (b, hq, sq,
// dv), on the device, all fp32 or all bf16, each with its last dim
// contiguous. p (host, 28 values, built once per call shape by the
// wrapper): the element strides (batch, head, seq) of q, k, v and o in
// p[0..11], then b, hq, hkv, sq, skv, d, kv_len, causal, bf16, and the plan
// (kernels/flash_attention.py:flash_plan): gh query heads of a group times
// qn queries a block, wr row warps (bf16: 16 wr rows a block; fp32: wr =
// 1, 16 rows), stages (bf16: 2 for wr = 4, else 3; fp32: 1), splits of
// each block's key tiles, and merge; then dv. hq % hkv == 0, (d, dv) one
// of (64, 64), (128, 128), (192, 128). With splits > 1, ws holds splits *
// b * hq * sq * (dv + 2) fp32 and merge = 1 adds the merge launch (merge =
// 0 leaves the partials in ws and o untouched). lse (b * hq * sq fp32)
// receives each row's log-sum-exp when not null: from the kernel with one
// split, from the merge with several (merge = 0 then refuses it).
// Anything else is refused.
int ntx_flash_attention(const void* q, const void* k, const void* v, void* o,
                        float* ws, float* lse, const long long* p,
                        float scale, void* stream) {
  const long long* strides = p;
  const int b = (int)p[12], hq = (int)p[13], hkv = (int)p[14];
  const int sq = (int)p[15], skv = (int)p[16], d = (int)p[17];
  const int kv_len = (int)p[18], causal = (int)p[19], bf16 = (int)p[20];
  const int gh = (int)p[21], qn = (int)p[22], wr = (int)p[23];
  const int stages = (int)p[24], splits = (int)p[25], merge = (int)p[26];
  const int dv = (int)p[27];
  if (b < 0 || hq <= 0 || hkv <= 0 || hq % hkv || sq < 0 || skv < 0 ||
      !head_pair(d, dv))
    return (int)cudaErrorInvalidValue;
  const int g = hq / hkv;
  const int rows = bf16 ? 16 * wr : kF32Rows;
  if (gh < 1 || gh > g || g % gh || qn < 1 || gh * qn > rows)
    return (int)cudaErrorInvalidValue;
  if (bf16 ? (wr != 1 && wr != 2 && wr != 4 && wr != 8) ||
                 stages != tc_stages(wr)
           : wr != 1 || stages != 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bf16 ? tc_smem(d, dv, wr) : f32_smem(d, dv);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > kMaxSplits || (splits > 1 && ws == nullptr) ||
      (splits > 1 && !merge && lse != nullptr))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return (int)cudaGetLastError();
  const int q_tiles = (sq + qn - 1) / qn;
  const long long xblocks = (long long)(g / gh) * b * hkv;
  if (q_tiles > 65535 || xblocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.ws = ws;
  a.lse = splits == 1 ? lse : nullptr;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.b = b;
  a.hq = hq;
  a.hkv = hkv;
  a.sq = sq;
  a.skv = skv;
  a.kv_len = kv_len;
  a.causal = causal;
  a.scale2 = scale * 1.4426950408889634f;
  a.g = g;
  a.gh = gh;
  a.qn = qn;
  a.q_tiles = q_tiles;
  a.head_blocks = g / gh;
  a.splits = splits;
  const dim3 grid((unsigned)xblocks, q_tiles, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = bf16 && aligned16(q, strides) &&
                   aligned16(k, strides + 3) && aligned16(v, strides + 6);
  const cudaError_t err =
      d == 64    ? launch_pair<64, 64>(a, bf16, vec, wr, grid, s)
      : d == 128 ? launch_pair<128, 128>(a, bf16, vec, wr, grid, s)
                 : launch_pair<192, 128>(a, bf16, vec, wr, grid, s);
  if (err != cudaSuccess || splits == 1 || !merge) return (int)err;
  return (int)(bf16 ? launch_merge<__nv_bfloat16>(ws, o, lse, strides + 9, b,
                                                  hq, sq, dv, splits, s)
                    : launch_merge<float>(ws, o, lse, strides + 9, b, hq, sq,
                                          dv, splits, s));
}

// The merge alone, on partials ntx_flash_attention left in ws (merge = 0):
// o (b, hq, sq, d) at element strides os[0..2], fp32 or bf16 (d: v's head
// dim), and each row's log-sum-exp into lse (b * hq * sq fp32) when not
// null.
int ntx_flash_merge(const float* ws, void* o, float* lse, const long long* os,
                    int b, int hq, int sq, int d, int splits, int bf16,
                    void* stream) {
  if (b < 0 || hq <= 0 || sq < 0 || d <= 0 || splits < 2 ||
      splits > kMaxSplits || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || sq == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_merge<__nv_bfloat16>(ws, o, lse, os, b, hq, sq,
                                                  d, splits, s)
                    : launch_merge<float>(ws, o, lse, os, b, hq, sq, d, splits,
                                          s));
}

}  // extern "C"
