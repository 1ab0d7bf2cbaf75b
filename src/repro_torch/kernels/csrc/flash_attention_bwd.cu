// Flash attention backward on Hopper: dQ, dK and dV of causal (or full)
// GQA attention from the forward's saved row log-sum-exp.
//
// Replaces the reference's flash-style VJP of its blocked attention,
// repro/kernels/ref.py:250 _mha_blocked_bwd (the route its ops.attention
// takes for training at sq >= 512, skv >= 2048, causal). There is no TPU
// kernel for it: the reference runs that VJP as XLA over key blocks. Same
// math: P = exp(S scale - lse) recomputed per key tile from the forward's
// lse (natural log, of the scaled logits: flash_attention.cu writes it),
// D = rowsum(dO o O), dS = P o (dP - D), dQ = scale dS K, dK = scale dS^T
// Q, dV = P^T dO; masked logits are -1e30, which weigh exp(-1e30 - lse) =
// 0; keys past the array weigh 0. Results are stored in the inputs' dtype.
//
// Bound on the H100: operations. The five products per unmasked (query,
// key) pair (S, dP, dV, dK, dQ) at 2 d flop each: b 4, hq 32, s 2048,
// d 128, causal is 268.6 M pairs x 1280 flop = 0.344 TFLOP, 0.348 ms at
// 989 TFLOP/s (bf16). This design keeps dQ in its own pass, which forms S
// and dP again: 7 products a pair, 0.487 ms at that rate.
//
// Design: deterministic (no atomics: every output element is summed in a
// fixed order, so two calls give the same bits), launches in this order:
// 1. flash_bwd_delta: D = rowsum(dO o O) in fp32, one warp a row, written
//    with lse log2(e) into a padded row table (b hq, 64-query tiles of
//    [lse2 x 64, D x 64], an even tile count a head) that the kernels read
//    a whole tile at a time.
// 2. dK/dV: one block per (batch, kv head, split of the group, key tile).
//    It walks its g / gs query heads and, for each, the query tiles that
//    the causal bound admits, so the GQA sum stays in fp32 registers in a
//    fixed order. The planner (kernels/flash_attention.py:flash_bwd_plan)
//    picks the split count gs: 1 where the longest block does not bound
//    the run, else the fewest splits whose longest block fits in the
//    mean work of a slot (yi's groups of 8, the fp32 route's small grids).
//    With gs > 1 the blocks write fp32 partials and flash_bwd_merge adds
//    them in split order. The first key tiles (the longest) launch first.
// 3. dQ: one block per (batch, q head, query tile), walking the key tiles
//    up to the causal bound; the last query tiles (the longest) first.
// * bf16 (the path), what each point of the sm_80 design this replaces
//   costs and what this one does:
//   - products: wgmma.mma_async bf16 -> fp32 (csrc/ntx_wgmma.cuh), two
//     consumer warpgroups of 64 rows (keys in the dK/dV pass, queries in
//     the dQ pass) sharing each tile. S^T = K Q^T and dP^T = V dO^T (and
//     in the dQ pass S = Q K^T, dP = dO V^T) read both operands from
//     shared memory; dV += P^T dO, dK += dS^T Q and dQ += dS K take P^T /
//     dS as the register A operand, rounded to bf16 once as the forward
//     rounds P, and Q, dO or K as the B operand through wgmma's
//     transpose bit. Every sum is fp32.
//   - copies: one producer thread keeps TMA loads (cp.async.bulk.tensor,
//     4-D maps over (d, seq, head, batch) of the strided views, 128-byte
//     swizzle matching the wgmma descriptors, zero fill past the edge) in
//     flight into a ring of kStages stages with full and empty mbarriers;
//     a stage's lse2 / D tile arrives by a 1-D cp.async.bulk in the same
//     transaction count. The -1e30 / 0 masking stays in registers, and a
//     tile inside the causal bound and the arrays skips it.
//   - products a pair: the dK/dV item forms S^T and dP^T (P^T computed
//     while dP^T runs), then issues dV and dK together with only dK, dV
//     and the two bf16 operands live; dQ keeps its own pass (7 products a
//     pair where the bound counts 5), which keeps every sum in one block.
//   - registers: the producer's warpgroup hands its registers to the
//     consumers (setmaxnreg 24 / 240), so dK and dV (64 fp32 each a
//     thread) and the S and dP fragments (the dK/dV consumer needs ~221)
//     fit without spills. ptxas gives a branch the count of its
//     setmaxnreg only if no trap is reachable from it, so the barrier
//     waits spin without a watchdog.
//   - 384 threads and ~163 KB of shared memory a block (~203 KB at
//     (192, 128)), one block an SM.
// * fp32: IEEE FFMA (never TF32): 32-key / 16-query tiles in shared
//   memory, each (key, query) logit and dP a d-deep dot product by one
//   thread, P and dS staged in shared memory, then each thread sums its
//   rows' outputs over the tile's pairs; the same group splits.
// * Head dims: q/k rows of d and v rows of dv, instantiated for (64, 64),
//   (128, 128) and MLA's (192, 128) (deepseek-v2: 128 nope + 64 rope dims
//   against v of 128). S and dQ, dK run over d; dP, dV and D over dv. At
//   d 192 the dK/dV consumer holds dK (96 fp32 a thread) and dV (64), so
//   it forms S^T and dP^T of each 64-query tile in two halves of 32
//   queries (m64n32 products over the same ring tile) to keep their
//   fragments at 16 registers each; dK += dS^T Q and dQ += dS K are
//   m64n192 products over the tile's three 64-column panels.
// The launcher recomputes the planner's plan (tiles, stages, warpgroups,
// gs, shared memory, workspace and row-table bytes) and refuses any other.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ntx_wgmma.cuh"

namespace {

constexpr int kBwdThreads = 128;   // fp32 blocks
constexpr int kWG = 2;             // bf16: consumer warpgroups a block
constexpr int kWgThreads = 128 * (kWG + 1);   // and the producer's
constexpr int kBk = 64 * kWG;      // bf16: keys a dK/dV block
constexpr int kBq = 64;            // bf16: queries a tile of the dK/dV ring
constexpr int kDqRows = 64 * kWG;  // bf16: queries a dQ block
constexpr int kDqKeys = 64;        // bf16: keys a tile of the dQ ring
constexpr int kStages = 3;         // bf16: ring depth
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kF32BwdKeys = 32;    // fp32 route
constexpr int kF32BwdRows = 16;
constexpr int kF32BlocksPerSm = 4;
constexpr int kSms = 132;
constexpr int kTile = 64;          // queries a tile of the row table
constexpr int kMaxSmem = 232448;
constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;       // (b, hq, sq), natural log
  float* rows;            // row table, written by flash_bwd_delta
  float* ws;              // fp32 partials (gs > 1): dK (gs, b, hkv, skv, d),
                          // then dV (gs, b, hkv, skv, dv)
  void* dq;
  void* dk;
  void* dv;
  long long qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
  int b, hq, hkv, sq, skv, causal, g, q_off;   // q_off = skv - sq
  int gs, nqt_pad;                              // group splits, row tiles
  float scale, scale2;                          // scale, scale * log2(e)
};

// The plan; flash_bwd_plan in kernels/flash_attention.py computes the same.
struct Plan {
  int bk, bq, dq_rows, dq_keys, stages, wgs, gs;
  long long smem_dkdv, smem_dq, ws_bytes, rows_bytes;
};

// Shared memory of the bf16 blocks for q/k rows of d and v rows of dv:
// dK/dV: K and V of the key tile, then a ring of (Q, dO) tiles with their
// row-table tiles, and the barriers; dQ: its Q and dO rows and row-table
// tile, then a ring of (K, V) tiles.
__host__ __device__ constexpr long long wg_dkdv_smem(int d, int dv) {
  return 1024 + 2LL * kBk * (d + dv) +
         kStages * (2LL * kBq * (d + dv) + 8 * kBq) + 8 * (2 * kStages + 1);
}
__host__ __device__ constexpr long long wg_dq_smem(int d, int dv) {
  return 1024 + 2LL * kDqRows * (d + dv) + 8 * kDqRows +
         kStages * 2LL * kDqKeys * (d + dv) + 8 * (2 * kStages + 1);
}
// ... of the fp32 blocks (rows padded by one float).
__host__ __device__ constexpr long long f32_dkdv_smem(int d, int dv) {
  return 4 * ((long long)kF32BwdKeys * (d + 1 + dv + 1) +
              (long long)kF32BwdRows * (d + 1 + dv + 1) +
              (long long)2 * kF32BwdKeys * (kF32BwdRows + 1) + 2 * kF32BwdRows);
}
__host__ __device__ constexpr long long f32_dq_smem(int d, int dv) {
  return 4 * ((long long)kF32BwdRows * (d + 1 + dv + 1) +
              (long long)kF32BwdKeys * (d + 1 + dv + 1) +
              (long long)kF32BwdRows * (kF32BwdKeys + 1) + 2 * kF32BwdRows);
}
// The (q/k, v) head-dim pairs the kernels are instantiated for.
__host__ __device__ constexpr bool head_pair(int d, int dv) {
  return (d == 64 && dv == 64) || (d == 128 && dv == 128) ||
         (d == 192 && dv == 128);
}

// First query tile (of bq) that key tile t (of bk) meets under the causal
// bound (a tile holding a query at or after the key tile's first key).
__host__ __device__ inline int first_q_tile(int t, int bk, int bq, int q_off,
                                            int causal) {
  if (!causal) return 0;
  const int f = (t * bk - q_off) / bq;
  return f > 0 ? f : 0;
}

// The fewest group splits gs (a divisor of g) whose longest dK/dV block
// (its heads times the first key tile's query tiles) is at most the mean
// work of one of `slots` block slots; g where none is.
int group_split(int b, int hkv, int g, int sq, int skv, int bk, int bq,
                int causal, long long slots) {
  const int nkt = (skv + bk - 1) / bk, nqt = (sq + bq - 1) / bq;
  long long sum = 0, per0 = 0;
  for (int t = 0; t < nkt; ++t) {
    const long long per = nqt - first_q_tile(t, bk, bq, skv - sq, causal);
    sum += per > 0 ? per : 0;
    per0 = per > per0 ? per : per0;
  }
  const long long total = (long long)b * hkv * g * sum;
  for (int gs = 1; gs <= g; ++gs)
    if (g % gs == 0 && (long long)(g / gs) * per0 * slots <= total) return gs;
  return g;
}

Plan make_plan(int b, int hq, int hkv, int sq, int skv, int d, int dv,
               int causal, int bf16) {
  Plan p;
  const int g = hq / hkv;
  if (bf16) {
    p.bk = kBk;
    p.bq = kBq;
    p.dq_rows = kDqRows;
    p.dq_keys = kDqKeys;
    p.stages = kStages;
    p.wgs = kWG;
    p.smem_dkdv = wg_dkdv_smem(d, dv);
    p.smem_dq = wg_dq_smem(d, dv);
  } else {
    p.bk = kF32BwdKeys;
    p.bq = kF32BwdRows;
    p.dq_rows = kF32BwdRows;
    p.dq_keys = kF32BwdKeys;
    p.stages = 1;
    p.wgs = 1;
    p.smem_dkdv = f32_dkdv_smem(d, dv);
    p.smem_dq = f32_dq_smem(d, dv);
  }
  const long long slots = (long long)kSms * (bf16 ? 1 : kF32BlocksPerSm);
  p.gs = group_split(b, hkv, g, sq, skv, p.bk, p.bq, causal, slots);
  p.ws_bytes = p.gs > 1 ? (long long)p.gs * b * hkv * skv * (d + dv) * 4 : 0;
  p.rows_bytes = (long long)b * hq * 2 * ((sq + 2 * kTile - 1) / (2 * kTile)) *
                 2 * kTile * 4;
  return p;
}

// Element offset of (batch, head, row) under strides s.
__device__ __forceinline__ long long at(const long long* s, int b, int h,
                                        int r) {
  return b * s[0] + h * s[1] + r * s[2];
}

// The row table's tile of query i of (batch, q head) bh: lse2 at [0, 64),
// D at [64, 128).
__device__ __forceinline__ const float* row_tile(const BwdArgs& a, int bh,
                                                 int tile) {
  return a.rows + ((long long)bh * a.nqt_pad + tile) * 2 * kTile;
}

// The dot product of this lane's D / 32 consecutive elements of rows x
// and y (bf16 rows are 16-byte aligned: the launcher copies one that is
// not; fp32 rows are read one element a lane at a time).
template <int D>
__device__ __forceinline__ float lane_dot(const __nv_bfloat16* x,
                                          const __nv_bfloat16* y, int lane) {
  constexpr int V = D / 32;
  float s = 0.0f;
  __nv_bfloat162 xv[V / 2], yv[V / 2];
  if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(xv) = *reinterpret_cast<const uint2*>(x + 4 * lane);
    *reinterpret_cast<uint2*>(yv) = *reinterpret_cast<const uint2*>(y + 4 * lane);
  } else {
    xv[0] = *reinterpret_cast<const __nv_bfloat162*>(x + 2 * lane);
    yv[0] = *reinterpret_cast<const __nv_bfloat162*>(y + 2 * lane);
  }
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    const float2 xf = __bfloat1622float2(xv[i]), yf = __bfloat1622float2(yv[i]);
    s = fmaf(xf.x, yf.x, s);
    s = fmaf(xf.y, yf.y, s);
  }
  return s;
}
template <int D>
__device__ __forceinline__ float lane_dot(const float* x, const float* y,
                                          int lane) {
  float s = 0.0f;
#pragma unroll
  for (int c = lane; c < D; c += 32) s = fmaf(x[c], y[c], s);
  return s;
}

// ---------------------------------------------------------------------
// 1. D = rowsum(dO o O) and lse log2(e) into the row table, one warp a
//    row (padding rows get 0, 0)
// ---------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const BwdArgs a) {
  const long long per = (long long)a.nqt_pad * kTile;
  const long long rows = (long long)a.b * a.hq * per;
  const int lane = threadIdx.x & 31;
  for (long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
       r < rows; r += (long long)gridDim.x * blockDim.x / 32) {
    const int i = (int)(r % per), bh = (int)(r / per);
    const int h = bh % a.hq, bi = bh / a.hq;
    float s = 0.0f, l2 = 0.0f;
    if (i < a.sq) {
      s = lane_dot<D>(static_cast<const T*>(a.dout) + at(a.dos, bi, h, i),
                      static_cast<const T*>(a.o) + at(a.os, bi, h, i), lane);
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      l2 = a.lse[(long long)bh * a.sq + i] * kLog2e;
    }
    if (lane == 0) {
      float* t = a.rows + ((long long)bh * a.nqt_pad + i / kTile) * 2 * kTile;
      t[i % kTile] = l2;
      t[kTile + i % kTile] = s;
    }
  }
}

// ---------------------------------------------------------------------
// bf16 route: wgmma fed by TMA, warp-specialised
// ---------------------------------------------------------------------
// Shared memory of a kernel starts at the dynamic window rounded up to
// 1024 bytes (the swizzle atom); the plan counts 1024 bytes of slack.
__device__ __forceinline__ unsigned char* smem_base(unsigned char* raw) {
  const uint32_t a = ntx::smem_u32(raw);
  return raw + ((1024 - (a & 1023)) & 1023);
}

// Descriptor of k-step kk of a K-major operand: rows row0.. of a tile of
// R rows at shared address t (panels of 64 columns). The start address is
// the descriptor's low field, so a step within the tile adds its offset /
// 16 to the tile's descriptor.
template <int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t t, int row0, int kk) {
  return ntx::desc_sw128(t, 16, 1024) +
         (uint64_t)(((kk >> 2) * R * 128 + row0 * 128 + (kk & 3) * 32) >> 4);
}
// ... of k-step kk (rows 16 kk..) of a tile of R rows read MN-major.
template <int R>
__device__ __forceinline__ uint64_t mnmajor(uint32_t t, int kk) {
  return ntx::desc_sw128(t, R * 128, 1024) + (uint64_t)(kk * 2048 >> 4);
}

// A tile of R rows (R / 64 boxes of 64 rows) and D columns (D / 64
// panels) at rows r0.. of (head, batch) of map into dst, on bar.
template <int D, int R>
__device__ __forceinline__ void load_tile(unsigned char* dst, const void* map,
                                          uint64_t* bar, int r0, int h,
                                          int bi) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
#pragma unroll
    for (int half = 0; half < R / 64; ++half)
      ntx::tma_load_4d(dst + p * R * 128 + half * 64 * 128, map, bar, p * 64,
                       r0 + half * 64, h, bi);
}

// Store a warpgroup's 64 x D fp32 accumulator times f: rows row0 + r of
// dst (bf16, row stride rs; rows past n skipped), or of the fp32 workspace
// (row stride D) when ws is set.
template <int D>
__device__ __forceinline__ void store_acc(const float (&acc)[D / 8][4],
                                          float f, __nv_bfloat16* dst,
                                          long long rs, float* ws, int row0,
                                          int n) {
  const int t = threadIdx.x & 127, lane = t & 31;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + (t >> 5) * 16 + (lane >> 2) + 8 * hh;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      if (ws) {
        *reinterpret_cast<float2*>(ws + (long long)r * D + c) =
            make_float2(acc[j][2 * hh] * f, acc[j][2 * hh + 1] * f);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst + r * rs + c) =
            __floats2bfloat162_rn(acc[j][2 * hh] * f, acc[j][2 * hh + 1] * f);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&a)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.0f;
}

template <int D, int DV>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const BwdArgs a) {
  constexpr int TK = kBk * D * 2, TV = kBk * DV * 2;
  constexpr int TQ = kBq * D * 2, TO = kBq * DV * 2;
  // queries a product round takes: the whole tile, or two halves at d 192
  constexpr int QH = D > 128 ? 32 : kBq;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = smem_base(smem_raw);
  unsigned char* sV = sK + TK;
  unsigned char* ring = sV + TV;                 // [stage][Q, dO]
  float* sLD = reinterpret_cast<float*>(ring + kStages * (TQ + TO));
  uint64_t* full = reinterpret_cast<uint64_t*>(sLD + kStages * 2 * kBq);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  // warpgroups 0..kWG-1 consume, warpgroup kWG produces; the index is
  // warp-uniform as the compiler sees it
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int grp = blockIdx.x / a.gs, split = blockIdx.x % a.gs;
  const int bi = grp / a.hkv, kvh = grp % a.hkv;
  const int k0 = blockIdx.y * kBk;              // the longest tiles first
  const int nqt = (a.sq + kBq - 1) / kBq;
  const int qt0 = first_q_tile(blockIdx.y, kBk, kBq, a.q_off, a.causal);
  const int per = max(0, nqt - qt0), hps = a.g / a.gs;
  const int n_it = hps * per, h0 = kvh * a.g + split * hps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      ntx::mbar_init(&full[s], 1);
      ntx::mbar_init(&empty[s], kWG * 128);
    }
    ntx::mbar_init(kvbar, 1);
    ntx::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kWG) {
    // producer: one thread issues every copy
    ntx::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kWG * 128) {
      ntx::mbar_expect_tx(kvbar, TK + TV);
      load_tile<D, kBk>(sK, &tk, kvbar, k0, kvh, bi);
      load_tile<DV, kBk>(sV, &tv, kvbar, k0, kvh, bi);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        ntx::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        const int h = h0 + it / per, qt = qt0 + it % per;
        unsigned char* sQ = ring + s * (TQ + TO);
        ntx::mbar_expect_tx(&full[s], TQ + TO + 8 * kBq);
        load_tile<D, kBq>(sQ, &tq, &full[s], qt * kBq, h, bi);
        load_tile<DV, kBq>(sQ + TQ, &tdo, &full[s], qt * kBq, h, bi);
        ntx::bulk_load(sLD + s * 2 * kBq, row_tile(a, bi * a.hq + h, qt),
                       8 * kBq, &full[s]);
      }
    }
  } else {
    ntx::setmaxnreg_inc<kConsumerRegs>();
    const int t = threadIdx.x & 127, lane = t & 31;
    const int kw0 = k0 + wg * 64;                 // this warpgroup's keys
    const int kp0 = kw0 + (t >> 5) * 16 + (lane >> 2);   // its rows, + 8
    const uint32_t uK = ntx::smem_u32(sK), uV = ntx::smem_u32(sV);
    float dk[D / 8][4], dv[DV / 8][4];
    zero(dk);
    zero(dv);
    ntx::mbar_wait(kvbar, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kStages;
      const int q0 = (qt0 + it % per) * kBq;
      ntx::mbar_wait(&full[s], (it / kStages) & 1);
      const uint32_t uQ = ntx::smem_u32(ring + s * (TQ + TO));
      const uint32_t udO = uQ + TQ;
      const float* sl = sLD + s * 2 * kBq;
#pragma unroll
      for (int hh = 0; hh < kBq / QH; ++hh) {
        const int qh0 = q0 + hh * QH;             // this round's queries
        const bool live = kw0 < a.skv && qh0 < a.sq && (!a.causal ||
                          a.q_off + min(qh0 + QH, a.sq) - 1 >= kw0);
        if (!live) continue;
        float p[QH / 8][4], dp[QH / 8][4];
        zero(p);
        zero(dp);
        ntx::fence_regs(p);
        ntx::fence_regs(dp);
        ntx::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)       // S^T = K_w Q^T
          ntx::wgmma_ss<QH>(p, kmajor<kBk>(uK, wg * 64, kk),
                            kmajor<kBq>(uQ, hh * QH, kk), 1);
        ntx::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk)      // dP^T = V_w dO^T
          ntx::wgmma_ss<QH>(dp, kmajor<kBk>(uV, wg * 64, kk),
                            kmajor<kBq>(udO, hh * QH, kk), 1);
        ntx::wgmma_commit();
        ntx::wgmma_wait<1>();
        ntx::fence_regs(p);
        // P^T = exp2(S^T scale2 - lse2), while dP^T runs: keys are rows,
        // queries columns; a tile inside the causal bound and the arrays
        // is not masked
        const bool inside = kw0 + 64 <= a.skv && qh0 + QH <= a.sq &&
                            (!a.causal || kw0 + 63 <= a.q_off + qh0);
        if (inside) {
#pragma unroll
          for (int j = 0; j < QH / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int ql = hh * QH + 8 * j + 2 * (lane & 3) + (e & 1);
              p[j][e] = exp2f(p[j][e] * a.scale2 - sl[ql]);
            }
        } else {
#pragma unroll
          for (int j = 0; j < QH / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int ql = hh * QH + 8 * j + 2 * (lane & 3) + (e & 1);
              const int kp = kp0 + 8 * (e >> 1), qi = q0 + ql;
              const bool ok = kp < a.skv && qi < a.sq &&
                              (!a.causal || kp <= a.q_off + qi);
              p[j][e] = ok ? exp2f(p[j][e] * a.scale2 - sl[ql]) : 0.0f;
            }
        }
        uint32_t pa[QH / 16][4], da[QH / 16][4];
        ntx::pack_a<QH / 8>(pa, p);
        ntx::wgmma_wait<0>();
        ntx::fence_regs(dp);
        // dS^T = P^T o (dP^T - D)
#pragma unroll
        for (int j = 0; j < QH / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ql = hh * QH + 8 * j + 2 * (lane & 3) + (e & 1);
            dp[j][e] = p[j][e] * (dp[j][e] - sl[kBq + ql]);
          }
        ntx::pack_a<QH / 8>(da, dp);
        // only dK, dV and the two bf16 operands are live from here
        ntx::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QH / 16; ++kk)      // dV += P^T dO
          ntx::wgmma_rs_t<DV>(dv, pa[kk],
                              mnmajor<kBq>(udO, hh * QH / 16 + kk));
#pragma unroll
        for (int kk = 0; kk < QH / 16; ++kk)      // dK += dS^T Q
          ntx::wgmma_rs_t<D>(dk, da[kk], mnmajor<kBq>(uQ, hh * QH / 16 + kk));
        ntx::wgmma_commit();
        ntx::wgmma_wait<0>();
        ntx::fence_regs(pa);
        ntx::fence_regs(da);
        ntx::fence_regs(dv);
        ntx::fence_regs(dk);
      }
      ntx::mbar_arrive(&empty[s]);
    }
    if (a.gs > 1) {
      const long long nk = (long long)a.b * a.hkv * a.skv * D;
      const long long part = ((long long)split * a.b * a.hkv + grp) * a.skv;
      store_acc<D>(dk, 1.0f, nullptr, 0, a.ws + part * D, kw0, a.skv);
      store_acc<DV>(dv, 1.0f, nullptr, 0, a.ws + a.gs * nk + part * DV, kw0,
                    a.skv);
    } else {
      store_acc<D>(dk, a.scale,
                   static_cast<__nv_bfloat16*>(a.dk) + at(a.dks, bi, kvh, 0),
                   a.dks[2], nullptr, kw0, a.skv);
      store_acc<DV>(dv, 1.0f,
                    static_cast<__nv_bfloat16*>(a.dv) + at(a.dvs, bi, kvh, 0),
                    a.dvs[2], nullptr, kw0, a.skv);
    }
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const BwdArgs a) {
  constexpr int TQ = kDqRows * D * 2, TO = kDqRows * DV * 2;
  constexpr int TK = kDqKeys * D * 2, TV = kDqKeys * DV * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = smem_base(smem_raw);
  unsigned char* sdO = sQ + TQ;
  unsigned char* ring = sdO + TO;                // [stage][K, V]
  float* sLD = reinterpret_cast<float*>(ring + kStages * (TK + TV));
  uint64_t* full = reinterpret_cast<uint64_t*>(sLD + 2 * kDqRows);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int bh = blockIdx.x, bi = bh / a.hq, h = bh % a.hq;
  const int kvh = h / a.g;
  const int nqb = (a.sq + kDqRows - 1) / kDqRows;
  const int qb = nqb - 1 - (int)blockIdx.y;      // the longest first
  const int q0 = qb * kDqRows;
  const int last = a.q_off + min(a.sq - 1, q0 + kDqRows - 1);
  const int nkt_all = (a.skv + kDqKeys - 1) / kDqKeys;
  const int nkt = a.causal ? min(nkt_all, last / kDqKeys + 1) : nkt_all;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      ntx::mbar_init(&full[s], 1);
      ntx::mbar_init(&empty[s], kWG * 128);
    }
    ntx::mbar_init(qbar, 1);
    ntx::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kWG) {
    ntx::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kWG * 128) {
      ntx::mbar_expect_tx(qbar, TQ + TO + 8 * kDqRows);
      load_tile<D, kDqRows>(sQ, &tq, qbar, q0, h, bi);
      load_tile<DV, kDqRows>(sdO, &tdo, qbar, q0, h, bi);
      ntx::bulk_load(sLD, row_tile(a, bh, q0 / kTile), 8 * kDqRows, qbar);
      for (int it = 0; it < nkt; ++it) {
        const int s = it % kStages;
        ntx::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        unsigned char* sK = ring + s * (TK + TV);
        ntx::mbar_expect_tx(&full[s], TK + TV);
        load_tile<D, kDqKeys>(sK, &tk, &full[s], it * kDqKeys, kvh, bi);
        load_tile<DV, kDqKeys>(sK + TK, &tv, &full[s], it * kDqKeys, kvh, bi);
      }
    }
  } else {
    ntx::setmaxnreg_inc<kConsumerRegs>();
    const int t = threadIdx.x & 127, lane = t & 31;
    const int qw0 = q0 + wg * 64;                 // this warpgroup's queries
    const int r0 = (t >> 5) * 16 + (lane >> 2);   // its rows r0, r0 + 8
    const int nkt_w =
        qw0 >= a.sq ? 0
        : a.causal
            ? min(nkt_all, (a.q_off + min(a.sq - 1, qw0 + 63)) / kDqKeys + 1)
            : nkt_all;
    const uint32_t uQ = ntx::smem_u32(sQ), udO = ntx::smem_u32(sdO);
    ntx::mbar_wait(qbar, 0);
    float lse2[2], dd[2];
    int qi[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      qi[hh] = qw0 + r0 + 8 * hh;
      lse2[hh] = sLD[wg * 2 * kTile + r0 + 8 * hh];
      dd[hh] = sLD[wg * 2 * kTile + kTile + r0 + 8 * hh];
    }
    float dq[D / 8][4];
    zero(dq);
    for (int it = 0; it < nkt; ++it) {
      const int s = it % kStages;
      ntx::mbar_wait(&full[s], (it / kStages) & 1);
      if (it < nkt_w) {
        const uint32_t uK = ntx::smem_u32(ring + s * (TK + TV)), uV = uK + TK;
        const int k0 = it * kDqKeys;
        float p[8][4], dp[8][4];
        zero(p);
        zero(dp);
        ntx::fence_regs(p);
        ntx::fence_regs(dp);
        ntx::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)       // S = Q_w K^T
          ntx::wgmma_m64n64k16_ss(p, kmajor<kDqRows>(uQ, wg * 64, kk),
                                  kmajor<kDqKeys>(uK, 0, kk), 1);
        ntx::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk)      // dP = dO_w V^T
          ntx::wgmma_m64n64k16_ss(dp, kmajor<kDqRows>(udO, wg * 64, kk),
                                  kmajor<kDqKeys>(uV, 0, kk), 1);
        ntx::wgmma_commit();
        ntx::wgmma_wait<1>();
        ntx::fence_regs(p);
        // P, while dP runs; a tile inside the causal bound and the
        // arrays is not masked
        const bool inside = k0 + kDqKeys <= a.skv && qw0 + 64 <= a.sq &&
                            (!a.causal || k0 + kDqKeys - 1 <= a.q_off + qw0);
        if (inside) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              p[j][e] = exp2f(p[j][e] * a.scale2 - lse2[e >> 1]);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int hh = e >> 1;
              const int kp = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
              const bool ok =
                  kp < a.skv && (!a.causal || kp <= a.q_off + qi[hh]);
              p[j][e] = ok ? exp2f(p[j][e] * a.scale2 - lse2[hh]) : 0.0f;
            }
        }
        ntx::wgmma_wait<0>();
        ntx::fence_regs(dp);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[j][e] = p[j][e] * (dp[j][e] - dd[e >> 1]);
        uint32_t da[4][4];
        ntx::pack_a<8>(da, dp);
        ntx::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDqKeys / 16; ++kk)   // dQ += dS K
          ntx::wgmma_rs_t<D>(dq, da[kk], mnmajor<kDqKeys>(uK, kk));
        ntx::wgmma_commit();
        ntx::wgmma_wait<0>();
        ntx::fence_regs(da);
        ntx::fence_regs(dq);
      }
      ntx::mbar_arrive(&empty[s]);
    }
    store_acc<D>(dq, a.scale,
                 static_cast<__nv_bfloat16*>(a.dq) + at(a.dqs, bi, h, 0),
                 a.dqs[2], nullptr, qw0, a.sq);
  }
}

// ---------------------------------------------------------------------
// fp32 route: IEEE FFMA through shared memory
// ---------------------------------------------------------------------
// Load n rows of D fp32 (row stride D + 1) at src + row * rs, zero past
// n_valid.
template <int D>
__device__ __forceinline__ void load_f32(float* dst, const float* src,
                                         long long rs, int n, int n_valid) {
  for (int e = threadIdx.x; e < n * D; e += kBwdThreads) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] = r < n_valid ? src[r * rs + c] : 0.0f;
  }
}

// lse2 and D of rows q0..q0+n-1 (n <= 16, within one row-table tile) of
// (batch, q head) bh into Ls, Ds.
__device__ __forceinline__ void load_ld(const BwdArgs& a, int bh, int q0,
                                        int n, float* Ls, float* Ds) {
  const float* t = row_tile(a, bh, q0 / kTile) + q0 % kTile;
  for (int r = threadIdx.x; r < n; r += kBwdThreads) {
    Ls[r] = t[r];
    Ds[r] = t[kTile + r];
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_f32(const BwdArgs a) {
  constexpr int NC = D / 32, NV = DV / 32, KR = kF32BwdKeys / 4;
  constexpr int QR = kF32BwdRows, LD = D + 1, LDV = DV + 1, LP = QR + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + kF32BwdKeys * LD;
  float* Qs = Vs + kF32BwdKeys * LDV;
  float* dOs = Qs + QR * LD;
  float* Ps = dOs + QR * LDV;
  float* dSs = Ps + kF32BwdKeys * LP;
  float* Ls = dSs + kF32BwdKeys * LP;
  float* Ds = Ls + QR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = blockIdx.x / a.gs, split = blockIdx.x % a.gs;
  const int bi = grp / a.hkv, kvh = grp % a.hkv;
  const int k0 = blockIdx.y * kF32BwdKeys;
  const int nk = min(kF32BwdKeys, a.skv - k0);
  const int nqt = (a.sq + QR - 1) / QR;
  const int qt0 = first_q_tile(blockIdx.y, kF32BwdKeys, QR, a.q_off, a.causal);
  const int hps = a.g / a.gs, h0 = kvh * a.g + split * hps;
  load_f32<D>(Ks, static_cast<const float*>(a.k) + at(a.ks, bi, kvh, k0),
              a.ks[2], kF32BwdKeys, nk);
  load_f32<DV>(Vs, static_cast<const float*>(a.v) + at(a.vs, bi, kvh, k0),
               a.vs[2], kF32BwdKeys, nk);
  float dk[KR][NC], dv[KR][NV];
#pragma unroll
  for (int r = 0; r < KR; ++r) {
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[r][c] = 0.0f;
#pragma unroll
    for (int c = 0; c < NV; ++c) dv[r][c] = 0.0f;
  }
  for (int j = 0; j < hps; ++j) {
    const int h = h0 + j;
    for (int qt = qt0; qt < nqt; ++qt) {
      const int q0 = qt * QR, nq = min(QR, a.sq - q0);
      __syncthreads();                  // the previous tile is consumed
      load_f32<D>(Qs, static_cast<const float*>(a.q) + at(a.qs, bi, h, q0),
                  a.qs[2], QR, nq);
      load_f32<DV>(dOs,
                   static_cast<const float*>(a.dout) + at(a.dos, bi, h, q0),
                   a.dos[2], QR, nq);
      load_ld(a, bi * a.hq + h, q0, QR, Ls, Ds);
      __syncthreads();
      for (int e = threadIdx.x; e < kF32BwdKeys * QR; e += kBwdThreads) {
        const int kj = e / QR, qq = e % QR;
        float s = 0.0f, dp = 0.0f;
#pragma unroll 8
        for (int c = 0; c < D; ++c) s = fmaf(Ks[kj * LD + c], Qs[qq * LD + c], s);
#pragma unroll 8
        for (int c = 0; c < DV; ++c)
          dp = fmaf(Vs[kj * LDV + c], dOs[qq * LDV + c], dp);
        const int kp = k0 + kj, qi = q0 + qq;
        const bool ok = kp < a.skv && qi < a.sq &&
                        (!a.causal || kp <= a.q_off + qi);
        const float pv = ok ? exp2f(s * a.scale2 - Ls[qq]) : 0.0f;
        Ps[kj * LP + qq] = pv;
        dSs[kj * LP + qq] = pv * (dp - Ds[qq]);
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < KR; ++r) {
        const int kj = warp * KR + r;
        for (int qq = 0; qq < QR; ++qq) {
          const float pv = Ps[kj * LP + qq], dsv = dSs[kj * LP + qq];
#pragma unroll
          for (int c = 0; c < NV; ++c)
            dv[r][c] = fmaf(pv, dOs[qq * LDV + lane + 32 * c], dv[r][c]);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            dk[r][c] = fmaf(dsv, Qs[qq * LD + lane + 32 * c], dk[r][c]);
        }
      }
    }
  }
  const bool part = a.gs > 1;
  const long long nkd = (long long)a.b * a.hkv * a.skv * D;
  const long long row0 =
      ((long long)split * a.b * a.hkv + grp) * a.skv + k0;   // partial row
  float* dkb = part ? a.ws + row0 * D
                    : static_cast<float*>(a.dk) + at(a.dks, bi, kvh, k0);
  float* dvb = part ? a.ws + a.gs * nkd + row0 * DV
                    : static_cast<float*>(a.dv) + at(a.dvs, bi, kvh, k0);
  const long long rk = part ? D : a.dks[2], rv = part ? DV : a.dvs[2];
  const float f = part ? 1.0f : a.scale;
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const int kj = warp * KR + r;
    if (kj >= nk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) dkb[kj * rk + lane + 32 * c] = dk[r][c] * f;
#pragma unroll
    for (int c = 0; c < NV; ++c) dvb[kj * rv + lane + 32 * c] = dv[r][c];
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_f32(const BwdArgs a) {
  constexpr int NC = D / 32, QR = kF32BwdRows / 4, KT = kF32BwdKeys;
  constexpr int LD = D + 1, LDV = DV + 1, LS = KT + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + kF32BwdRows * LD;
  float* Ks = dOs + kF32BwdRows * LDV;
  float* Vs = Ks + KT * LD;
  float* dSs = Vs + KT * LDV;
  float* Ls = dSs + kF32BwdRows * LS;
  float* Ds = Ls + kF32BwdRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bi = blockIdx.x / a.hq, h = blockIdx.x % a.hq, kvh = h / a.g;
  const int nqt = (a.sq + kF32BwdRows - 1) / kF32BwdRows;
  const int q0 = (nqt - 1 - (int)blockIdx.y) * kF32BwdRows;
  const int nq = min(kF32BwdRows, a.sq - q0);
  const int last = a.q_off + q0 + nq - 1;
  const int nkt_all = (a.skv + KT - 1) / KT;
  const int nkt = a.causal ? (last < 0 ? 0 : min(nkt_all, last / KT + 1))
                           : nkt_all;
  load_f32<D>(Qs, static_cast<const float*>(a.q) + at(a.qs, bi, h, q0),
              a.qs[2], kF32BwdRows, nq);
  load_f32<DV>(dOs, static_cast<const float*>(a.dout) + at(a.dos, bi, h, q0),
               a.dos[2], kF32BwdRows, nq);
  load_ld(a, blockIdx.x, q0, kF32BwdRows, Ls, Ds);
  float dq[QR][NC];
#pragma unroll
  for (int r = 0; r < QR; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[r][c] = 0.0f;
  for (int t = 0; t < nkt; ++t) {
    const int k0 = t * KT, nk = min(KT, a.skv - k0);
    __syncthreads();                    // the previous tile is consumed
    load_f32<D>(Ks, static_cast<const float*>(a.k) + at(a.ks, bi, kvh, k0),
                a.ks[2], KT, nk);
    load_f32<DV>(Vs, static_cast<const float*>(a.v) + at(a.vs, bi, kvh, k0),
                 a.vs[2], KT, nk);
    __syncthreads();
    for (int e = threadIdx.x; e < kF32BwdRows * KT; e += kBwdThreads) {
      const int qq = e / KT, kj = e % KT;
      float s = 0.0f, dp = 0.0f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) s = fmaf(Qs[qq * LD + c], Ks[kj * LD + c], s);
#pragma unroll 8
      for (int c = 0; c < DV; ++c)
        dp = fmaf(dOs[qq * LDV + c], Vs[kj * LDV + c], dp);
      const int kp = k0 + kj, qi = q0 + qq;
      const bool ok = kp < a.skv && qi < a.sq &&
                      (!a.causal || kp <= a.q_off + qi);
      const float pv = ok ? exp2f(s * a.scale2 - Ls[qq]) : 0.0f;
      dSs[qq * LS + kj] = pv * (dp - Ds[qq]);
    }
    __syncthreads();
    // keys outer: each K element is loaded once for the warp's rows (with
    // the rows outer, the compiler keeps a tile's K values live across
    // them and spills at d 192); every dq element still sums its keys in
    // order
    for (int kj = 0; kj < KT; ++kj) {
      float kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = Ks[kj * LD + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < QR; ++r) {
        const float dsv = dSs[(warp * QR + r) * LS + kj];
#pragma unroll
        for (int c = 0; c < NC; ++c) dq[r][c] = fmaf(dsv, kv[c], dq[r][c]);
      }
    }
  }
  float* dqb = static_cast<float*>(a.dq) + at(a.dqs, bi, h, q0);
#pragma unroll
  for (int r = 0; r < QR; ++r) {
    const int qq = warp * QR + r;
    if (qq >= nq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dqb[qq * a.dqs[2] + lane + 32 * c] = dq[r][c] * a.scale;
  }
}

// ---------------------------------------------------------------------
// The group splits' partials of dK (times scale) and dV, added in split
// order into the outputs (dK rows of d, dV rows of dv)
// ---------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_merge(const BwdArgs a, int d, int dv) {
  const long long rows = (long long)a.b * a.hkv * a.skv;
  const long long nk = rows * d, nv = rows * dv;
  for (long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
       i < nk + nv; i += 4LL * gridDim.x * blockDim.x) {
    const int which = i >= nk;
    const long long e = which ? i - nk : i;     // 4 columns of one row
    const int w = which ? dv : d;
    const long long n = which ? nv : nk;
    const int c = (int)(e % w);
    const long long row = e / w;
    const int key = (int)(row % a.skv), bh = (int)(row / a.skv);
    const int kvh = bh % a.hkv, bi = bh / a.hkv;
    const float* src = a.ws + (which ? a.gs * nk : 0) + e;
    float4 s = *reinterpret_cast<const float4*>(src);
    for (int j = 1; j < a.gs; ++j) {
      const float4 t = *reinterpret_cast<const float4*>(src + j * n);
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    const float f = which == 0 ? a.scale : 1.0f;
    T* dst = static_cast<T*>(which == 0 ? a.dk : a.dv) +
             at(which == 0 ? a.dks : a.dvs, bi, kvh, key) + c;
    dst[0] = T(s.x * f);
    dst[1] = T(s.y * f);
    dst[2] = T(s.z * f);
    dst[3] = T(s.w * f);
  }
}

// Opt a kernel into its dynamic shared memory once per device.
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

// cuTensorMapEncodeTiled, reached through the runtime (the library links
// no libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn) return fn;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
  if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
    fn = reinterpret_cast<EncodeTiled>(p);
  return fn;
}

// A 4-D map (d, seq, head, batch) over a bf16 operand with element
// strides st (batch, head, seq), d contiguous: 64 x 64 boxes, 128-byte
// swizzle, zeros past the edge.
bool encode(CUtensorMap* map, const void* base, const long long* st, int b,
            int h, int s, int d) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1}, unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int DV>
cudaError_t launch_passes(const BwdArgs& a, const Plan& p, bool bf16,
                          cudaStream_t s) {
  static bool done[4][64] = {};
  const unsigned groups = (unsigned)(a.b * a.hkv * p.gs);
  const unsigned heads = (unsigned)(a.b * a.hq);
  const dim3 g2(groups, (a.skv + p.bk - 1) / p.bk);
  const dim3 g3(heads, (a.sq + p.dq_rows - 1) / p.dq_rows);
  cudaError_t err;
  if (bf16) {
    CUtensorMap tq, tdo, tk, tv;
    if (!encode(&tq, a.q, a.qs, a.b, a.hq, a.sq, D) ||
        !encode(&tdo, a.dout, a.dos, a.b, a.hq, a.sq, DV) ||
        !encode(&tk, a.k, a.ks, a.b, a.hkv, a.skv, D) ||
        !encode(&tv, a.v, a.vs, a.b, a.hkv, a.skv, DV))
      return cudaErrorInvalidValue;
    if ((err = opt_in(flash_bwd_dkdv_wgmma<D, DV>, p.smem_dkdv, done[0])) !=
        cudaSuccess)
      return err;
    if ((err = opt_in(flash_bwd_dq_wgmma<D, DV>, p.smem_dq, done[1])) !=
        cudaSuccess)
      return err;
    flash_bwd_dkdv_wgmma<D, DV><<<g2, kWgThreads, p.smem_dkdv, s>>>(tq, tdo, tk,
                                                                tv, a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    flash_bwd_dq_wgmma<D, DV><<<g3, kWgThreads, p.smem_dq, s>>>(tq, tdo, tk, tv,
                                                            a);
  } else {
    if ((err = opt_in(flash_bwd_dkdv_f32<D, DV>, p.smem_dkdv, done[2])) !=
        cudaSuccess)
      return err;
    if ((err = opt_in(flash_bwd_dq_f32<D, DV>, p.smem_dq, done[3])) != cudaSuccess)
      return err;
    flash_bwd_dkdv_f32<D, DV><<<g2, kBwdThreads, p.smem_dkdv, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    flash_bwd_dq_f32<D, DV><<<g3, kBwdThreads, p.smem_dq, s>>>(a);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (p.gs > 1) {
    const long long n = (long long)a.b * a.hkv * a.skv * (D + DV) / 4;
    const long long need = (n + 255) / 256;
    const int blocks = (int)(need < kSms * 16 ? need : kSms * 16);
    if (bf16)
      flash_bwd_merge<__nv_bfloat16><<<blocks, 256, 0, s>>>(a, D, DV);
    else
      flash_bwd_merge<float><<<blocks, 256, 0, s>>>(a, D, DV);
    err = cudaGetLastError();
  }
  return err;
}

bool aligned16(const void* p, const long long* st) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0 && st[0] % 8 == 0 &&
         st[1] % 8 == 0 && st[2] % 8 == 0;
}

}  // namespace

extern "C" {

// q, dq (b, hq, sq, d); o, dout (b, hq, sq, dv); k, dk (b, hkv, skv, d);
// v, dv (b, hkv, skv, dv), on the device, all fp32 or all bf16, each with
// its last dim contiguous (bf16: q, k, v and dout 16-byte aligned with
// strides in multiples of 8 elements, which the tensor maps need); lse
// (b * hq * sq fp32, the forward's); rows (the row table, rows_bytes of
// scratch); ws (ws_bytes of scratch, or null when gs is 1). p (host, 44
// values): the element strides (batch, head, seq) of q, k, v, o, dout,
// dq, dk and dv in p[0..23], then b, hq, hkv, sq, skv, d, causal, bf16,
// and the plan (kernels/flash_attention.py:flash_bwd_plan): keys a dK/dV
// block, queries a tile it walks, queries a dQ block, keys a tile it
// walks, ring stages, consumer warpgroups, group splits gs, the dK/dV and
// the dQ blocks' shared memory, the workspace's and the row table's
// bytes; then dv. (d, dv) is one of (64, 64), (128, 128), (192, 128).
// Causal attention needs sq <= skv (query i at position skv - sq + i); sq
// and skv are at least 1. Launches: the delta, dK/dV, dQ, and with gs > 1
// the merge. Anything else is refused.
int ntx_flash_attention_bwd(const void* q, const void* k, const void* v,
                            const void* o, const void* dout,
                            const float* lse, float* rows, float* ws,
                            void* dq, void* dk, void* dv, const long long* p,
                            float scale, void* stream) {
  const int b = (int)p[24], hq = (int)p[25], hkv = (int)p[26];
  const int sq = (int)p[27], skv = (int)p[28], d = (int)p[29];
  const int causal = (int)p[30], bf16 = (int)p[31];
  const int d_v = (int)p[43];                   // v's head dim
  if (b < 0 || hq <= 0 || hkv <= 0 || hq % hkv || sq <= 0 || skv <= 0 ||
      !head_pair(d, d_v) || (causal && sq > skv))
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(b, hq, hkv, sq, skv, d, d_v, causal, bf16);
  if (p[32] != pl.bk || p[33] != pl.bq || p[34] != pl.dq_rows ||
      p[35] != pl.dq_keys || p[36] != pl.stages || p[37] != pl.wgs ||
      p[38] != pl.gs || p[39] != pl.smem_dkdv || p[40] != pl.smem_dq ||
      p[41] != pl.ws_bytes || p[42] != pl.rows_bytes ||
      pl.smem_dkdv > kMaxSmem || pl.smem_dq > kMaxSmem ||
      (pl.gs > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (bf16 && !(aligned16(q, p) && aligned16(k, p + 3) &&
                aligned16(v, p + 6) && aligned16(dout, p + 12)))
    return (int)cudaErrorInvalidValue;
  if ((long long)b * hkv * pl.gs > 0x7fffffffLL ||
      (long long)b * hq > 0x7fffffffLL || (skv + pl.bk - 1) / pl.bk > 65535 ||
      (sq + pl.dq_rows - 1) / pl.dq_rows > 65535)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaGetLastError();
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.rows = rows;
  a.ws = ws;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = p[i];
    a.ks[i] = p[3 + i];
    a.vs[i] = p[6 + i];
    a.os[i] = p[9 + i];
    a.dos[i] = p[12 + i];
    a.dqs[i] = p[15 + i];
    a.dks[i] = p[18 + i];
    a.dvs[i] = p[21 + i];
  }
  a.b = b;
  a.hq = hq;
  a.hkv = hkv;
  a.sq = sq;
  a.skv = skv;
  a.causal = causal;
  a.g = hq / hkv;
  a.q_off = skv - sq;
  a.gs = pl.gs;
  a.nqt_pad = 2 * ((sq + 2 * kTile - 1) / (2 * kTile));
  a.scale = scale;
  a.scale2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_rows = (long long)b * hq * a.nqt_pad * kTile;
  const long long need = (n_rows * 32 + 255) / 256;
  const int blocks = (int)(need < kSms * 16 ? need : kSms * 16);
  // D = rowsum(dO o O) runs over v's head dim
  if (bf16 && d_v == 64)
    flash_bwd_delta<__nv_bfloat16, 64><<<blocks, 256, 0, s>>>(a);
  else if (bf16)
    flash_bwd_delta<__nv_bfloat16, 128><<<blocks, 256, 0, s>>>(a);
  else if (d_v == 64)
    flash_bwd_delta<float, 64><<<blocks, 256, 0, s>>>(a);
  else
    flash_bwd_delta<float, 128><<<blocks, 256, 0, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)(d == 64    ? launch_passes<64, 64>(a, pl, bf16, s)
               : d == 128 ? launch_passes<128, 128>(a, pl, bf16, s)
                          : launch_passes<192, 128>(a, pl, bf16, s));
}

}  // extern "C"
