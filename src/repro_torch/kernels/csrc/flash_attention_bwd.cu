// Flash attention backward on Hopper: dQ, dK and dV of causal (or full)
// GQA attention from the forward's saved row log-sum-exp.
//
// Replaces the reference's flash-style VJP of its blocked attention,
// repro/kernels/ref.py:_mha_blocked_bwd (the route its ops.attention takes
// for training at sq >= 512, skv >= 2048, causal). There is no TPU kernel
// for it: the reference runs that VJP as XLA over key blocks. Same math:
// P = exp(S scale - lse) recomputed per key tile from the forward's lse
// (natural log, of the scaled logits: flash_attention.cu writes it),
// D = rowsum(dO o O), dS = P o (dP - D), dQ = scale dS K, dK = scale dS^T Q,
// dV = P^T dO; masked logits are -1e30, which weigh exp(-1e30 - lse) = 0;
// keys past the array weigh 0. Results are stored in the inputs' dtype.
//
// Bound on the H100: operations. The five products per unmasked (query,
// key) pair (S, dP, dV, dK, dQ) at 2 d flop each: b 4, hq 32, s 2048,
// d 128, causal is 268.6 M pairs x 1280 flop = 0.344 TFLOP, 0.348 ms at
// 989 TFLOP/s (bf16). This design recomputes S and dP in its dQ pass, 7
// products a pair.
//
// Design: three launches, deterministic (no atomics: every output element
// is summed by one thread in a fixed order).
// 1. flash_bwd_delta: D = rowsum(dO o O) in fp32, one warp a row.
// 2. dK/dV: one block per (batch, kv head, key tile). It walks the g query
//    heads of its group and, for each, the query tiles that the causal
//    bound admits (tile i holds a query at or after the tile's first key),
//    so the GQA sum over the group stays inside the block, in fp32
//    registers, rounded once. Blocks of the first key tiles (the longest)
//    are launched first.
// 3. dQ: one block per (batch, q head, query tile), walking the key tiles
//    up to the causal bound; the last query tiles (the longest) first.
// * bf16: tensor cores, mma.sync m16n8k16 bf16 -> fp32 (csrc/ntx_mma.cuh)
//   with the forward's fragment patterns; 4 warps of 16 rows (keys in
//   the dK/dV pass, queries in the dQ pass), 64-row tiles of Q, dO, K and
//   V in bf16 rows padded by 16 bytes, double-buffered by 16-byte
//   cp.async (the launcher copies an operand that is off a 16-byte
//   boundary). P and dS are rounded to bf16 where they feed a product, as
//   the forward rounds P; every sum is fp32. dK/dV pass: S^T = K_w Q^T and
//   dP^T = V_w dO^T per warp, dV += P^T dO, dK += dS^T Q with 128 fp32
//   accumulators a thread. dQ pass: the block's Q and dO rows stay in
//   shared memory, S = Q K^T, dP = dO V^T, dQ += dS K. 2 blocks per SM
//   (~103 KB each).
// * fp32: IEEE FFMA (never TF32): 32-key / 16-query tiles in shared
//   memory, each (key, query) logit and dP a 128-deep dot product by one
//   thread, P and dS staged in shared memory, then each thread sums its
//   rows' outputs over the tile's pairs.
// The launcher recomputes the planner's (kernels/flash_attention.py:
// flash_bwd_plan) tiles and shared memory and refuses a plan that differs.
// Left for later: wgmma with TMA, and one pass that atomically adds dQ.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ntx_mma.cuh"

namespace {

constexpr int kBwdThreads = 128;
constexpr int kBwdKeys = 64;       // bf16: keys a dK/dV block, keys a tile
constexpr int kBwdRows = 64;       // bf16: queries a tile, queries a dQ block
constexpr int kBwdStages = 2;      // bf16: double-buffered tiles
constexpr int kF32BwdKeys = 32;    // fp32 route
constexpr int kF32BwdRows = 16;
constexpr int kPad = 8;            // bf16 elements of row padding
constexpr int kMaxSmem = 232448;
constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;       // (b, hq, sq), natural log
  float* delta;           // (b, hq, sq), written by flash_bwd_delta
  void* dq;
  void* dk;
  void* dv;
  long long qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
  int b, hq, hkv, sq, skv, causal, g, q_off;   // q_off = skv - sq
  float scale, scale2;                          // scale, scale * log2(e)
};

// Shared memory of the bf16 dK/dV block: K and V of the key tile, then a
// ring of (Q, dO) tiles with their lse and D rows.
__host__ __device__ constexpr size_t tc_dkdv_smem(int d) {
  return (size_t)2 * 2 * kBwdKeys * (d + kPad) +
         (size_t)kBwdStages * (2 * 2 * kBwdRows * (d + kPad) + 2 * 4 * kBwdRows);
}
// ... of the bf16 dQ block: its Q and dO rows, then a ring of (K, V) tiles.
__host__ __device__ constexpr size_t tc_dq_smem(int d) {
  return (size_t)2 * 2 * kBwdRows * (d + kPad) +
         (size_t)kBwdStages * 2 * 2 * kBwdKeys * (d + kPad);
}
// ... of the fp32 blocks (rows padded by one float).
__host__ __device__ constexpr size_t f32_dkdv_smem(int d) {
  return 4 * ((size_t)2 * kF32BwdKeys * (d + 1) +
              (size_t)2 * kF32BwdRows * (d + 1) +
              (size_t)2 * kF32BwdKeys * (kF32BwdRows + 1) + 2 * kF32BwdRows);
}
__host__ __device__ constexpr size_t f32_dq_smem(int d) {
  return 4 * ((size_t)2 * kF32BwdRows * (d + 1) +
              (size_t)2 * kF32BwdKeys * (d + 1) +
              (size_t)kF32BwdRows * (kF32BwdKeys + 1) + 2 * kF32BwdRows);
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Element offset of (batch, head, row) under strides s.
__device__ __forceinline__ long long at(const long long* s, int b, int h,
                                        int r) {
  return b * s[0] + h * s[1] + r * s[2];
}

// ---------------------------------------------------------------------
// 1. D = rowsum(dO o O), fp32, one warp a row
// ---------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const BwdArgs a, int d) {
  const long long rows = (long long)a.b * a.hq * a.sq;
  const int lane = threadIdx.x & 31;
  for (long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
       r < rows; r += (long long)gridDim.x * blockDim.x / 32) {
    const int i = (int)(r % a.sq), h = (int)(r / a.sq % a.hq);
    const int bi = (int)(r / ((long long)a.sq * a.hq));
    const T* o = static_cast<const T*>(a.o) + at(a.os, bi, h, i);
    const T* dO = static_cast<const T*>(a.dout) + at(a.dos, bi, h, i);
    float s = 0.0f;
    for (int c = lane; c < d; c += 32) s = fmaf(ld(dO + c), ld(o + c), s);
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) a.delta[r] = s;
  }
}

// ---------------------------------------------------------------------
// bf16 route: tensor cores
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// n rows of D bf16 at src + off(r) into dst (row stride D + kPad) by
// 16-byte cp.async; a row with off(r) < 0 is zero-filled.
template <int D, class Off>
__device__ __forceinline__ void load_rows(uint16_t* dst, const uint16_t* src,
                                          int n, Off off) {
  constexpr int LD = D + kPad, CH = D / 8;
  for (int c = threadIdx.x; c < n * CH; c += kBwdThreads) {
    const int r = c / CH, col = (c % CH) * 8;
    const long long o = off(r);
    cp_async16(dst + r * LD + col, o >= 0 ? src + o + col : src,
               o >= 0 ? 16 : 0);
  }
}

// acc[16 rows of the warp][NT n-tiles of 8] += A (16 x 16 k-steps, rows of
// a at arow, row-major in shared memory) B^T, with B's rows (n) at brow
// row-major: the forward's S = Q K^T pattern, K = D / 16 steps.
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4],
                                        const uint16_t* a_tile, int a_row0,
                                        const uint16_t* b_tile) {
  constexpr int LD = D + kPad;
  const int lane = threadIdx.x & 31;
  const uint16_t* arow = a_tile + (a_row0 + (lane & 15)) * LD + (lane >> 4) * 8;
  const uint16_t* brow = b_tile + ((lane & 7) + ((lane >> 4) << 3)) * LD +
                         ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ntx::ldsm_x4(af, arow + kk * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ntx::ldsm_x4(bf, brow + np * 16 * LD + kk * 16);
      ntx::mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      ntx::mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// out[16 rows][D / 8 n-tiles] += P (16 x 64, fp32 fragments p, rounded to
// bf16) times the 64 x D tile at b_tile (rows k, row-major): the forward's
// P V pattern.
template <int D>
__device__ __forceinline__ void mma_pb(float (&out)[D / 8][4],
                                       const float (&p)[8][4],
                                       const uint16_t* b_tile) {
  constexpr int LD = D + kPad;
  const int lane = threadIdx.x & 31;
  const uint16_t* brow = b_tile + (lane & 15) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    uint32_t pa[4];
    pa[0] = ntx::bits(__floats2bfloat162_rn(p[2 * t][0], p[2 * t][1]));
    pa[1] = ntx::bits(__floats2bfloat162_rn(p[2 * t][2], p[2 * t][3]));
    pa[2] = ntx::bits(__floats2bfloat162_rn(p[2 * t + 1][0], p[2 * t + 1][1]));
    pa[3] = ntx::bits(__floats2bfloat162_rn(p[2 * t + 1][2], p[2 * t + 1][3]));
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bf[4];
      ntx::ldsm_x4_t(bf, brow + t * 16 * LD + dp * 16);
      ntx::mma_bf16(out[2 * dp], pa, bf[0], bf[1]);
      ntx::mma_bf16(out[2 * dp + 1], pa, bf[2], bf[3]);
    }
  }
}

// Store a warp's 16 x D fp32 fragments, times f, to rows row0 + r of
// dst (strides s; rows past n skipped).
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                           float f, __nv_bfloat16* dst,
                                           long long row_stride, int row0,
                                           int n) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + (lane >> 2) + 8 * h;
    if (r >= n) continue;
    __nv_bfloat16* p = dst + r * row_stride + 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      p[c * 8] = __float2bfloat16(acc[c][2 * h] * f);
      p[c * 8 + 1] = __float2bfloat16(acc[c][2 * h + 1] * f);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 2)
bwd_dkdv_tc(const BwdArgs a) {
  constexpr int LD = D + kPad, T = kBwdRows * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sK = reinterpret_cast<uint16_t*>(smem);
  uint16_t* sV = sK + kBwdKeys * LD;
  uint16_t* ring = sV + kBwdKeys * LD;          // [stage][Q, dO]
  float* sLD = reinterpret_cast<float*>(ring + kBwdStages * 2 * T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = blockIdx.x, bi = grp / a.hkv, kvh = grp % a.hkv;
  const int k0 = blockIdx.y * kBwdKeys;         // the longest tiles first
  const int nqt = (a.sq + kBwdRows - 1) / kBwdRows;
  const int qt0 = a.causal ? max(0, (k0 - a.q_off) / kBwdRows) : 0;
  const int per = max(0, nqt - qt0), n_it = a.g * per;
  const uint16_t* kb = static_cast<const uint16_t*>(a.k) + at(a.ks, bi, kvh, 0);
  const uint16_t* vb = static_cast<const uint16_t*>(a.v) + at(a.vs, bi, kvh, 0);

  auto load_item = [&](int it, int stage) {
    const int h = kvh * a.g + it / per, q0 = (qt0 + it % per) * kBwdRows;
    uint16_t* sQ = ring + stage * 2 * T;
    const uint16_t* qb =
        static_cast<const uint16_t*>(a.q) + at(a.qs, bi, h, 0);
    const uint16_t* db =
        static_cast<const uint16_t*>(a.dout) + at(a.dos, bi, h, 0);
    load_rows<D>(sQ, qb, kBwdRows, [&](int r) -> long long {
      return q0 + r < a.sq ? (long long)(q0 + r) * a.qs[2] : -1;
    });
    load_rows<D>(sQ + T, db, kBwdRows, [&](int r) -> long long {
      return q0 + r < a.sq ? (long long)(q0 + r) * a.dos[2] : -1;
    });
    float* sl = sLD + stage * 2 * kBwdRows;
    for (int r = threadIdx.x; r < kBwdRows; r += kBwdThreads) {
      const bool in = q0 + r < a.sq;
      const long long row = ((long long)bi * a.hq + h) * a.sq + q0 + r;
      sl[r] = in ? a.lse[row] * kLog2e : 0.0f;
      sl[kBwdRows + r] = in ? a.delta[row] : 0.0f;
    }
  };

  load_rows<D>(sK, kb, kBwdKeys, [&](int r) -> long long {
    return k0 + r < a.skv ? (long long)(k0 + r) * a.ks[2] : -1;
  });
  load_rows<D>(sV, vb, kBwdKeys, [&](int r) -> long long {
    return k0 + r < a.skv ? (long long)(k0 + r) * a.vs[2] : -1;
  });
  if (n_it > 0) load_item(0, 0);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;
  // this thread's keys: rows g and g + 8 of its warp's 16
  const int kp0 = k0 + warp * 16 + (lane >> 2);

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_all();
    __syncthreads();                    // item it landed; it - 1 consumed
    if (it + 1 < n_it) load_item(it + 1, (it + 1) % kBwdStages);
    cp_async_commit();
    const int stage = it % kBwdStages;
    const uint16_t* sQ = ring + stage * 2 * T;
    const uint16_t* sdO = sQ + T;
    const float* sl = sLD + stage * 2 * kBwdRows;
    const int q0 = (qt0 + it % per) * kBwdRows;

    // P^T = exp2(S^T scale2 - lse2): keys are rows, queries columns
    float p[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = 0.0f;
    mma_abt<D, 8>(p, sK, warp * 16, sQ);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + 2 * (lane & 3) + (e & 1);
        const int kp = kp0 + 8 * (e >> 1), qi = q0 + ql;
        const bool ok = kp < a.skv && qi < a.sq &&
                        (!a.causal || kp <= a.q_off + qi);
        p[n][e] = ok ? exp2f(p[n][e] * a.scale2 - sl[ql]) : 0.0f;
      }
    mma_pb<D>(dv, p, sdO);              // dV += P^T dO
    // dP^T = V_w dO^T, then dS^T = P^T o (dP^T - D)
    float ds[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[n][e] = 0.0f;
    mma_abt<D, 8>(ds, sV, warp * 16, sdO);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + 2 * (lane & 3) + (e & 1);
        ds[n][e] = p[n][e] * (ds[n][e] - sl[kBwdRows + ql]);
      }
    mma_pb<D>(dk, ds, sQ);              // dK += dS^T Q
  }
  cp_async_wait_all();
  __nv_bfloat16* dkb = static_cast<__nv_bfloat16*>(a.dk) + at(a.dks, bi, kvh, 0);
  __nv_bfloat16* dvb = static_cast<__nv_bfloat16*>(a.dv) + at(a.dvs, bi, kvh, 0);
  store_rows<D>(dk, a.scale, dkb, a.dks[2], k0 + warp * 16, a.skv);
  store_rows<D>(dv, 1.0f, dvb, a.dvs[2], k0 + warp * 16, a.skv);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 2)
bwd_dq_tc(const BwdArgs a) {
  constexpr int LD = D + kPad, T = kBwdKeys * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem);
  uint16_t* sdO = sQ + kBwdRows * LD;
  uint16_t* ring = sdO + kBwdRows * LD;         // [stage][K, V]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bi = blockIdx.x / a.hq, h = blockIdx.x % a.hq;
  const int kvh = h / a.g;
  const int nqt = (a.sq + kBwdRows - 1) / kBwdRows;
  const int q0 = (nqt - 1 - (int)blockIdx.y) * kBwdRows;   // longest first
  const int last = a.q_off + min(a.sq - 1, q0 + kBwdRows - 1);
  const int nkt_all = (a.skv + kBwdKeys - 1) / kBwdKeys;
  const int nkt = a.causal ? (last < 0 ? 0 : min(nkt_all, last / kBwdKeys + 1))
                           : nkt_all;
  const uint16_t* kb = static_cast<const uint16_t*>(a.k) + at(a.ks, bi, kvh, 0);
  const uint16_t* vb = static_cast<const uint16_t*>(a.v) + at(a.vs, bi, kvh, 0);
  auto load_kv = [&](int t, int stage) {
    const int k0 = t * kBwdKeys;
    uint16_t* sK = ring + stage * 2 * T;
    load_rows<D>(sK, kb, kBwdKeys, [&](int r) -> long long {
      return k0 + r < a.skv ? (long long)(k0 + r) * a.ks[2] : -1;
    });
    load_rows<D>(sK + T, vb, kBwdKeys, [&](int r) -> long long {
      return k0 + r < a.skv ? (long long)(k0 + r) * a.vs[2] : -1;
    });
  };
  load_rows<D>(sQ, static_cast<const uint16_t*>(a.q) + at(a.qs, bi, h, 0),
               kBwdRows, [&](int r) -> long long {
                 return q0 + r < a.sq ? (long long)(q0 + r) * a.qs[2] : -1;
               });
  load_rows<D>(sdO, static_cast<const uint16_t*>(a.dout) + at(a.dos, bi, h, 0),
               kBwdRows, [&](int r) -> long long {
                 return q0 + r < a.sq ? (long long)(q0 + r) * a.dos[2] : -1;
               });
  if (nkt > 0) load_kv(0, 0);
  cp_async_commit();

  // this thread's rows g and g + 8 of its warp's 16: lse2 and D
  const int r0 = warp * 16 + (lane >> 2);
  float lse2[2], dd[2];
  int qi[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    qi[hh] = q0 + r0 + 8 * hh;
    const long long row = ((long long)bi * a.hq + h) * a.sq + qi[hh];
    lse2[hh] = qi[hh] < a.sq ? a.lse[row] * kLog2e : 0.0f;
    dd[hh] = qi[hh] < a.sq ? a.delta[row] : 0.0f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;

  for (int it = 0; it < nkt; ++it) {
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < nkt) load_kv(it + 1, (it + 1) % kBwdStages);
    cp_async_commit();
    const uint16_t* sK = ring + (it % kBwdStages) * 2 * T;
    const uint16_t* sV = sK + T;
    const int k0 = it * kBwdKeys;
    float p[8][4], ds[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = ds[n][e] = 0.0f;
    mma_abt<D, 8>(p, sQ, warp * 16, sK);         // S = Q K^T
    mma_abt<D, 8>(ds, sdO, warp * 16, sV);       // dP = dO V^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const int kp = k0 + n * 8 + 2 * (lane & 3) + (e & 1);
        const bool ok = kp < a.skv && (!a.causal || kp <= a.q_off + qi[hh]);
        const float pv = ok ? exp2f(p[n][e] * a.scale2 - lse2[hh]) : 0.0f;
        ds[n][e] = pv * (ds[n][e] - dd[hh]);
      }
    mma_pb<D>(dq, ds, sK);                       // dQ += dS K
  }
  cp_async_wait_all();
  store_rows<D>(dq, a.scale,
                static_cast<__nv_bfloat16*>(a.dq) + at(a.dqs, bi, h, 0),
                a.dqs[2], q0 + warp * 16, a.sq);
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

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
bwd_dkdv_f32(const BwdArgs a) {
  constexpr int NC = D / 32, KR = kF32BwdKeys / 4, QR = kF32BwdRows;
  constexpr int LD = D + 1, LP = QR + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + kF32BwdKeys * LD;
  float* Qs = Vs + kF32BwdKeys * LD;
  float* dOs = Qs + QR * LD;
  float* Ps = dOs + QR * LD;
  float* dSs = Ps + kF32BwdKeys * LP;
  float* Ls = dSs + kF32BwdKeys * LP;
  float* Ds = Ls + QR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bi = blockIdx.x / a.hkv, kvh = blockIdx.x % a.hkv;
  const int k0 = blockIdx.y * kF32BwdKeys;
  const int nk = min(kF32BwdKeys, a.skv - k0);
  const int nqt = (a.sq + QR - 1) / QR;
  const int qt0 = a.causal ? max(0, (k0 - a.q_off) / QR) : 0;
  load_f32<D>(Ks, static_cast<const float*>(a.k) + at(a.ks, bi, kvh, k0),
              a.ks[2], kF32BwdKeys, nk);
  load_f32<D>(Vs, static_cast<const float*>(a.v) + at(a.vs, bi, kvh, k0),
              a.vs[2], kF32BwdKeys, nk);
  float dk[KR][NC], dv[KR][NC];
#pragma unroll
  for (int r = 0; r < KR; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[r][c] = dv[r][c] = 0.0f;
  for (int j = 0; j < a.g; ++j) {
    const int h = kvh * a.g + j;
    for (int qt = qt0; qt < nqt; ++qt) {
      const int q0 = qt * QR, nq = min(QR, a.sq - q0);
      __syncthreads();                  // the previous tile is consumed
      load_f32<D>(Qs, static_cast<const float*>(a.q) + at(a.qs, bi, h, q0),
                  a.qs[2], QR, nq);
      load_f32<D>(dOs,
                  static_cast<const float*>(a.dout) + at(a.dos, bi, h, q0),
                  a.dos[2], QR, nq);
      for (int r = threadIdx.x; r < QR; r += kBwdThreads) {
        const long long row = ((long long)bi * a.hq + h) * a.sq + q0 + r;
        Ls[r] = r < nq ? a.lse[row] * kLog2e : 0.0f;
        Ds[r] = r < nq ? a.delta[row] : 0.0f;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < kF32BwdKeys * QR; e += kBwdThreads) {
        const int kj = e / QR, qq = e % QR;
        float s = 0.0f, dp = 0.0f;
#pragma unroll 8
        for (int c = 0; c < D; ++c) {
          s = fmaf(Ks[kj * LD + c], Qs[qq * LD + c], s);
          dp = fmaf(Vs[kj * LD + c], dOs[qq * LD + c], dp);
        }
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
          for (int c = 0; c < NC; ++c) {
            dv[r][c] = fmaf(pv, dOs[qq * LD + lane + 32 * c], dv[r][c]);
            dk[r][c] = fmaf(dsv, Qs[qq * LD + lane + 32 * c], dk[r][c]);
          }
        }
      }
    }
  }
  float* dkb = static_cast<float*>(a.dk) + at(a.dks, bi, kvh, k0);
  float* dvb = static_cast<float*>(a.dv) + at(a.dvs, bi, kvh, k0);
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const int kj = warp * KR + r;
    if (kj >= nk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkb[kj * a.dks[2] + lane + 32 * c] = dk[r][c] * a.scale;
      dvb[kj * a.dvs[2] + lane + 32 * c] = dv[r][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
bwd_dq_f32(const BwdArgs a) {
  constexpr int NC = D / 32, QR = kF32BwdRows / 4, KT = kF32BwdKeys;
  constexpr int LD = D + 1, LS = KT + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + kF32BwdRows * LD;
  float* Ks = dOs + kF32BwdRows * LD;
  float* Vs = Ks + KT * LD;
  float* dSs = Vs + KT * LD;
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
  load_f32<D>(dOs, static_cast<const float*>(a.dout) + at(a.dos, bi, h, q0),
              a.dos[2], kF32BwdRows, nq);
  for (int r = threadIdx.x; r < kF32BwdRows; r += kBwdThreads) {
    const long long row = ((long long)bi * a.hq + h) * a.sq + q0 + r;
    Ls[r] = r < nq ? a.lse[row] * kLog2e : 0.0f;
    Ds[r] = r < nq ? a.delta[row] : 0.0f;
  }
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
    load_f32<D>(Vs, static_cast<const float*>(a.v) + at(a.vs, bi, kvh, k0),
                a.vs[2], KT, nk);
    __syncthreads();
    for (int e = threadIdx.x; e < kF32BwdRows * KT; e += kBwdThreads) {
      const int qq = e / KT, kj = e % KT;
      float s = 0.0f, dp = 0.0f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        s = fmaf(Qs[qq * LD + c], Ks[kj * LD + c], s);
        dp = fmaf(dOs[qq * LD + c], Vs[kj * LD + c], dp);
      }
      const int kp = k0 + kj, qi = q0 + qq;
      const bool ok = kp < a.skv && qi < a.sq &&
                      (!a.causal || kp <= a.q_off + qi);
      const float pv = ok ? exp2f(s * a.scale2 - Ls[qq]) : 0.0f;
      dSs[qq * LS + kj] = pv * (dp - Ds[qq]);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < QR; ++r) {
      const int qq = warp * QR + r;
      for (int kj = 0; kj < KT; ++kj) {
        const float dsv = dSs[qq * LS + kj];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          dq[r][c] = fmaf(dsv, Ks[kj * LD + lane + 32 * c], dq[r][c]);
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

template <int D>
cudaError_t launch_passes(const BwdArgs& a, bool bf16, cudaStream_t s) {
  static bool done[4][64] = {};
  const unsigned groups = (unsigned)(a.b * a.hkv), heads = (unsigned)(a.b * a.hq);
  cudaError_t err;
  if (bf16) {
    const size_t s2 = tc_dkdv_smem(D), s3 = tc_dq_smem(D);
    if ((err = opt_in(bwd_dkdv_tc<D>, s2, done[0])) != cudaSuccess) return err;
    if ((err = opt_in(bwd_dq_tc<D>, s3, done[1])) != cudaSuccess) return err;
    const dim3 g2(groups, (a.skv + kBwdKeys - 1) / kBwdKeys);
    const dim3 g3(heads, (a.sq + kBwdRows - 1) / kBwdRows);
    if (g2.y > 0) bwd_dkdv_tc<D><<<g2, kBwdThreads, s2, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (g3.y > 0) bwd_dq_tc<D><<<g3, kBwdThreads, s3, s>>>(a);
    return cudaGetLastError();
  }
  const size_t s2 = f32_dkdv_smem(D), s3 = f32_dq_smem(D);
  if ((err = opt_in(bwd_dkdv_f32<D>, s2, done[2])) != cudaSuccess) return err;
  if ((err = opt_in(bwd_dq_f32<D>, s3, done[3])) != cudaSuccess) return err;
  const dim3 g2(groups, (a.skv + kF32BwdKeys - 1) / kF32BwdKeys);
  const dim3 g3(heads, (a.sq + kF32BwdRows - 1) / kF32BwdRows);
  if (g2.y > 0) bwd_dkdv_f32<D><<<g2, kBwdThreads, s2, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (g3.y > 0) bwd_dq_f32<D><<<g3, kBwdThreads, s3, s>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p, const long long* st) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0 && st[0] % 8 == 0 &&
         st[1] % 8 == 0 && st[2] % 8 == 0;
}

}  // namespace

extern "C" {

// q, o, dout, dq (b, hq, sq, d); k, v, dk, dv (b, hkv, skv, d), on the
// device, all fp32 or all bf16, each with d contiguous (bf16: q, k, v and
// dout 16-byte aligned with strides in multiples of 8 elements); lse
// (b * hq * sq fp32, the forward's); delta (b * hq * sq fp32 scratch). p
// (host, 36 values): the element strides (batch, head, seq) of q, k, v,
// o, dout, dq, dk and dv in p[0..23], then b, hq, hkv, sq, skv, d,
// causal, bf16, and the plan (kernels/flash_attention.py:flash_bwd_plan):
// keys a tile, queries a tile, the dK/dV and the dQ blocks' shared
// memory. Causal attention needs sq <= skv (query i at position skv - sq
// + i). Three launches: D, dK/dV, dQ. Anything else is refused.
int ntx_flash_attention_bwd(const void* q, const void* k, const void* v,
                            const void* o, const void* dout,
                            const float* lse, float* delta, void* dq,
                            void* dk, void* dv, const long long* p,
                            float scale, void* stream) {
  const int b = (int)p[24], hq = (int)p[25], hkv = (int)p[26];
  const int sq = (int)p[27], skv = (int)p[28], d = (int)p[29];
  const int causal = (int)p[30], bf16 = (int)p[31];
  if (b < 0 || hq <= 0 || hkv <= 0 || hq % hkv || sq < 0 || skv < 0 ||
      (d != 64 && d != 128) || (causal && sq > skv))
    return (int)cudaErrorInvalidValue;
  const int bk = bf16 ? kBwdKeys : kF32BwdKeys;
  const int bq = bf16 ? kBwdRows : kF32BwdRows;
  const size_t s2 = bf16 ? tc_dkdv_smem(d) : f32_dkdv_smem(d);
  const size_t s3 = bf16 ? tc_dq_smem(d) : f32_dq_smem(d);
  if (p[32] != bk || p[33] != bq || (size_t)p[34] != s2 ||
      (size_t)p[35] != s3 || s2 > (size_t)kMaxSmem || s3 > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (bf16 && !(aligned16(q, p) && aligned16(k, p + 3) &&
                aligned16(v, p + 6) && aligned16(dout, p + 12)))
    return (int)cudaErrorInvalidValue;
  if ((long long)b * hkv > 0x7fffffffLL || (long long)b * hq > 0x7fffffffLL ||
      (skv + bk - 1) / bk > 65535 || (sq + bq - 1) / bq > 65535)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaGetLastError();
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
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
  a.scale = scale;
  a.scale2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)b * hq * sq;
  if (rows > 0) {
    const long long need = (rows * 32 + 255) / 256;
    const int blocks = (int)(need < 132 * 16 ? need : 132 * 16);
    if (bf16)
      flash_bwd_delta<__nv_bfloat16><<<blocks, 256, 0, s>>>(a, d);
    else
      flash_bwd_delta<float><<<blocks, 256, 0, s>>>(a, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)(d == 64 ? launch_passes<64>(a, bf16, s)
                       : launch_passes<128>(a, bf16, s));
}

}  // extern "C"
