// NTX streaming GEMM with fused store epilogues, on Hopper.
//
// Replaces the TPU kernels repro/kernels/ntx_gemm.py:gemm_pallas
// (_gemm_kernel, with apply_epilogue run at the store step):
//   C = epilogue(A @ B), fp32 accumulator, one rounding at the store;
// and, with compensated = 1, _gemm_kernel_kahan (gemm_pallas(
// compensated=True)): the same with a Neumaier compensation term carried
// across k slabs and added before the epilogue.
// The Pallas kernel walks k as the sequential third grid axis with the
// accumulator in VMEM scratch; here each block runs its k range in a
// loop with the accumulator in registers (the PCS wide accumulator).
//
// Two routes, chosen by the launcher:
//
// 1. bf16 inputs, not compensated (the serving MLP: ops.fused_mlp's gate,
//    w1 and w2 products). Bound on the H100 at the serving shapes:
//    bytes. The 4096 x 14336 bf16 weight matrix is ~117 MB, ~35 us at
//    3.35 TB/s; decode (m = 4) does ~0.5 GFLOP (<1 us on the tensor
//    cores), prefill (m = 128) ~15 GFLOP (~15 us at 989 TFLOP/s), so at
//    both the goal is to stream B at the card's bandwidth. A first port
//    widened bf16 to fp32 in shared memory and ran FFMA from 2-byte
//    loads with one block per output tile: 0.86-3.0 ms, 25-85x the bound.
//    Design:
//    * tensor cores: mma.sync.m16n8k16 bf16 with fp32 accumulators, A
//      fragments by ldmatrix, B (row-major (k, n)) by ldmatrix.trans;
//      a 16 x 128 x 64 tile for m <= 16 (decode: the unused rows of the
//      mma cost no bytes) and a 128 x 128 x 64 tile otherwise;
//    * a ring of A/B tiles in dynamic shared memory (4 stages, 77 KB, for
//      the small tile; 3 stages, 105 KB, for the large one; rows padded
//      by 16 bytes so ldmatrix is conflict-free), filled by 16-byte
//      cp.async copies, so the next tiles are in flight while the
//      tensor cores work on the current one. Ragged m/n/k edges are zero-
//      filled by the copies (src-size 0); an operand whose pointer is
//      not 16-byte aligned, or whose k or n is not a multiple of 8, takes
//      an instantiation that fills the ring with masked 2-byte loads.
//      The host never pads and nothing falls back;
//    * deterministic split-k: kernels/ntx_gemm.py:split_k_plan picks the
//      number of k splits from (m, n, k): as many as fit the grid in one
//      block per SM (w2 at decode has 32 output tiles for 132 SMs: 4
//      splits; gate and w1 have 112 tiles: none). On an H100 two blocks
//      per SM were slower at four of the six path shapes and level at a
//      fifth; prefill w1 alone gains from 2 splits (its epilogue then
//      runs in the reduction pass), and it shares its shape with gate.
//      Each split stores fp32 partials to a workspace the wrapper
//      allocates; a second launch adds them in split order, runs the
//      epilogue once on the fp32 sum and rounds once. No float atomics:
//      two calls give the same bits. With one split the epilogue runs in
//      the first launch, on the tile staged through shared memory, a
//      stage at a time with 16 read-only operand loads in flight per
//      thread; stores and operand reads are coalesced either way.
//    What bounds it now (H100, chip_smoke phase 3): decode streams B at
//    ~2.6 TB/s (45-48 us against the 35 us bound); prefill takes 74-97
//    us, w1's in-kernel epilogue ~20 us of it, as one 8-warp block per
//    SM cannot hide the operand and store latency after its k loop.
//    Left for later: wgmma fed by TMA with mbarriers and a persistent
//    tile schedule whose epilogue overlaps the next tile's loads.
//
// 2. fp32 inputs (descriptor programs, the paper's suite), and the
//    compensated variant for either input type: IEEE fp32 FFMA (never
//    TF32), tiles picked by kernels/ntx_gemm.py:ffma_plan (the kernel
//    refuses any other):
//    * fp32 inputs with m > 16 where 128 x 128 blocks fill the card (one
//      block per SM or more, e.g. the suite's 4096^3): gemm_ffma, 8 x 8
//      register tiles read from k-major A and row-major B as float4 (64
//      FFMA per 4 shared loads), a 3-stage ring filled by cp.async (B)
//      and float4 loads staged through registers (A, transposed) while
//      the current stage computes. Bound by operations: 4096^3 is 137
//      GFLOP, 2.05 ms at 67 TFLOP/s. The 64 x 64 synchronous kernel below
//      with 4 x 4 tiles took 8.46 ms there (0.24 of the rate);
//    * otherwise gemm_kernel: A and B tiles staged through shared memory
//      as fp32 (bf16 widened with __bfloat162float), synchronous loads,
//      a TM x TN register tile per thread; 16 x 128 for m <= 16 and 64 x
//      64 otherwise (smaller products, whose 128 x 128 grid is less than
//      a wave, and the bf16-input compensated GEMM).
//    Compensated variant (a compile-time switch of either kernel): the
//    FFMA accumulators collect one kKahanSlab-deep slab of k at a time as
//    a partial product; at each slab's end every partial is Neumaier-
//    added into two more register tiles, sum and comp, with __fadd_rn/
//    __fsub_rn (no products in those terms, no contraction, never fast-
//    math), and sum + comp enters the epilogue. The slab is fixed at 128,
//    the default block_k of gemm_pallas, and kernels/ntx_gemm.py:
//    gemm_kahan_plain compensates over the same slabs: the result depends
//    on the slab width.
//
// Lanes (the Executor's multistream/pipeline vmap transport runs one
// launch for L uniform GEMM lanes, the reference's vmap-batched Pallas
// call): every kernel takes a lane count and the lanes' strides; grid z
// walks the lanes (beside the k splits on the tensor-core route), and
// each lane is cut with the plan (tile, splits) of a one-lane launch of
// its (m, n, k), its split-k partials in a workspace of its own. Only
// the addressing changes, so each lane's bits equal a one-lane launch's.
// The compensated variant takes one lane: moving its pointers per lane
// cost it 10 % at 4096^3 (chip_smoke, H100), the registers at its limit.
//
// Both routes run the ten epilogue stages in the reference order on the
// fp32 accumulator (tanh GELU; silu as acc * (1 / (1 + exp(-acc)))),
// reading each array operand in its own dtype (fp32 or bf16), and write
// the result once in the output dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxEpilogue = 16;
constexpr int kThreads = 256;
constexpr int kSms = 132;            // SMs of an H100 SXM (ntx_gemm.SMS)
constexpr int BK = 16;
constexpr int kKahanSlab = 128;   // kernels/ntx_gemm.py:KAHAN_SLAB
static_assert(kKahanSlab % BK == 0, "slabs end on a k step");

enum Kind { K_BIAS = 0, K_RESIDUAL, K_MUL, K_SUB, K_MASK, K_SCALE, K_RELU,
            K_THRESH, K_SILU, K_GELU };

struct Epilogue {
  int n;
  int kind[kMaxEpilogue];
  float imm[kMaxEpilogue];
  const void* op[kMaxEpilogue];   // (n,) for bias, else (m, n), per lane
  int op_bf16[kMaxEpilogue];      // op is bf16 (1) or fp32 (0)
  long long op_lane[kMaxEpilogue];   // elements from one lane's op to the next
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Element i of lane `lane`'s epilogue operand s, widened to fp32 (exact
// for bf16).
__device__ __forceinline__ float operand(const Epilogue& ep, int s, int lane,
                                         size_t i) {
  i += (size_t)lane * ep.op_lane[s];
  return ep.op_bf16[s]
             ? load(static_cast<const __nv_bfloat16*>(ep.op[s]) + i)
             : static_cast<const float*>(ep.op[s])[i];
}

// One epilogue stage on the fp32 accumulator; o is the stage's operand
// element (array kinds), imm its immediate (scale, thresh).
__device__ __forceinline__ float apply_stage(int kind, float acc, float o,
                                             float imm) {
  switch (kind) {
    case K_BIAS:
    case K_RESIDUAL: return acc + o;
    case K_MUL: return acc * o;
    case K_SUB: return acc - o;
    case K_MASK: return (o != 0.0f) ? acc : 0.0f;
    case K_SCALE: return acc * imm;
    case K_RELU: return fmaxf(acc, 0.0f);
    case K_THRESH: return (acc > imm) ? acc : 0.0f;
    case K_SILU: return acc * (1.0f / (1.0f + expf(-acc)));
    default: {   // K_GELU, tanh form (jax.nn.gelu's default)
      const float k0 = 0.7978845608028654f;   // sqrt(2/pi)
      return 0.5f * acc *
             (1.0f + tanhf(k0 * (acc + 0.044715f * acc * acc * acc)));
    }
  }
}

__device__ __forceinline__ float epilogue(float acc, const Epilogue& ep,
                                          int lane, int r, int c, int n) {
  const size_t at = (size_t)r * n + c;
  for (int s = 0; s < ep.n; ++s) {
    const int kind = ep.kind[s];
    const float o = kind > K_MASK ? 0.0f
                                  : operand(ep, s, lane,
                                            kind == K_BIAS ? c : at);
    acc = apply_stage(kind, acc, o, ep.imm[s]);
  }
  return acc;
}

// The epilogue over a block's BM x BN fp32 tile in shared memory (row
// stride kCStride), thread tid on elements tid + j * kThreads, a stage
// at a time and 16 elements at a time. An array stage's 16 operand loads
// are read-only global loads (__ldg) with no branch between them
// (indices outside M x N read element 0), so they are in flight
// together: with one block per SM, a load at a time made the epilogue
// of a 128 x 128 tile cost as much as streaming its k range.
template <class T>
__device__ __forceinline__ void tile_epilogue(float* sC, const Epilogue& ep,
                                              int lane, int m0, int n0, int M,
                                              int N) {
  constexpr int E = T::BM * T::BN / T::kThreads;
  constexpr int G = E < 16 ? E : 16;
  static_assert(E % G == 0, "whole groups");
  for (int s = 0; s < ep.n; ++s) {
    const int kind = ep.kind[s];
    const bool array = kind <= K_MASK, bias = kind == K_BIAS;
    const bool bf16 = ep.op_bf16[s] != 0;
    const size_t lane_at = array ? (size_t)lane * ep.op_lane[s] : 0;
    const float* p32 = static_cast<const float*>(ep.op[s]) + lane_at;
    const __nv_bfloat16* p16 =
        static_cast<const __nv_bfloat16*>(ep.op[s]) + lane_at;
    const float imm = ep.imm[s];
#pragma unroll 1
    for (int g = 0; g < E; g += G) {
      float o[G];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int e = threadIdx.x + (g + i) * T::kThreads;
        const int r = m0 + e / T::BN, c = n0 + e % T::BN;
        const size_t at = (r >= M || c >= N) ? 0
                          : bias ? (size_t)c : (size_t)r * N + c;
        o[i] = !array ? 0.0f
               : bf16 ? __bfloat162float(__ldg(p16 + at)) : __ldg(p32 + at);
      }
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int e = threadIdx.x + (g + i) * T::kThreads;
        float& x = sC[(e / T::BN) * T::kCStride + e % T::BN];
        x = apply_stage(kind, x, o[i], imm);
      }
    }
  }
}

// One Neumaier step: (s, c) += x, |s| >= |x| choosing the exact branch.
__device__ __forceinline__ void neumaier(float& s, float& c, float x) {
  const float t = __fadd_rn(s, x);
  const float d = fabsf(s) >= fabsf(x) ? __fadd_rn(__fsub_rn(s, t), x)
                                       : __fadd_rn(__fsub_rn(x, t), s);
  c = __fadd_rn(c, d);
  s = t;
}

// BM x BN output tile per block, TM x TN per thread, 256 threads; KAHAN
// compensates across kKahanSlab-deep slabs of k.
template <typename TI, typename TO, int BM, int BN, int TM, int TN,
          bool KAHAN>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const TI* __restrict__ A, const TI* __restrict__ B,
            TO* __restrict__ C, int M, int N, int K, long long lda,
            long long ldb, Epilogue ep) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "thread tile");
  // grid z walks the lanes (read again at the store: no register held);
  // the compensated variant takes one lane and keeps the pointers as
  // launch parameters (no registers at its 255)
  if (!KAHAN) {
    A += blockIdx.z * lda;
    B += blockIdx.z * ldb;
    C += (size_t)blockIdx.z * M * N;
  }
  __shared__ float As[BK][BM + 4];      // A tile, transposed: As[kk][i]
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  constexpr int SM = KAHAN ? TM : 1, SN = KAHAN ? TN : 1;
  float acc[TM][TN], sum[SM][SN], comp[SM][SN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int i = 0; i < SM; ++i)
#pragma unroll
    for (int j = 0; j < SN; ++j) sum[i][j] = comp[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int i = e / BK, kk = e % BK;
      const int r = row0 + i, k = k0 + kk;
      As[kk][i] = (r < M && k < K) ? load(A + (size_t)r * K + k) : 0.0f;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int kk = e / BN, j = e % BN;
      const int k = k0 + kk, c = col0 + j;
      Bs[kk][j] = (k < K && c < N) ? load(B + (size_t)k * N + c) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (KAHAN && ((k0 + BK) % kKahanSlab == 0 || k0 + BK >= K)) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          neumaier(sum[i % SM][j % SN], comp[i % SM][j % SN], acc[i][j]);
          acc[i][j] = 0.0f;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      const float v = KAHAN ? __fadd_rn(sum[i % SM][j % SN],
                                         comp[i % SM][j % SN])
                            : acc[i][j];
      if (c < N)
        store(C + (size_t)r * N + c,
              epilogue(v, ep, KAHAN ? 0 : blockIdx.z, r, c, N));
    }
  }
}

template <typename TI, typename TO, bool KAHAN>
void launch(const void* a, const void* b, void* c, int m, int n, int k,
            int lanes, long long lda, long long ldb, int tile,
            const Epilogue& ep, cudaStream_t s) {
  const TI* A = static_cast<const TI*>(a);
  const TI* B = static_cast<const TI*>(b);
  TO* C = static_cast<TO*>(c);
  if (tile == 0) {
    dim3 grid((n + 127) / 128, (m + 15) / 16, lanes);
    gemm_kernel<TI, TO, 16, 128, 2, 4, KAHAN><<<grid, kThreads, 0, s>>>(
        A, B, C, m, n, k, lda, ldb, ep);
  } else {
    dim3 grid((n + 63) / 64, (m + 63) / 64, lanes);
    gemm_kernel<TI, TO, 64, 64, 4, 4, KAHAN><<<grid, kThreads, 0, s>>>(
        A, B, C, m, n, k, lda, ldb, ep);
  }
}


// ---------------------------------------------------------------------
// bf16 route: tensor cores, a cp.async ring, deterministic split-k.
// ---------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block tile BM x BN x BK, WM x WN warps each owning a (BM / WM) x
// (BN / WN) piece, STAGES tiles of A and B in the ring. Rows of both
// shared tiles are padded by 8 bf16 (16 bytes): ldmatrix then reads
// eight rows from eight different bank groups.
template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct TcTile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int kAStride = BK + 8;
  static constexpr int kBStride = BN + 8;
  static constexpr int kAStage = BM * kAStride;   // bf16 elements
  static constexpr int kBStage = BK * kBStride;
  static constexpr int kCStride = BN + 4;         // fp32 tile of the store
  static constexpr int kRingBytes = STAGES * (kAStage + kBStage) * 2;
  static constexpr int kCBytes = BM * kCStride * 4;
  static constexpr int kSmem = kRingBytes > kCBytes ? kRingBytes : kCBytes;
  static constexpr int WTM = BM / WM, WTN = BN / WN;
  static constexpr int MI = WTM / 16, NI = WTN / 8;
  static_assert(WTM % 16 == 0 && WTN % 16 == 0 && BK % 16 == 0,
                "whole mma tiles, B fragments loaded in pairs");
  static_assert((BM * BK / 8) % kThreads == 0 &&
                (BK * BN / 8) % kThreads == 0 &&
                (BM * BN) % kThreads == 0, "whole copies per thread");
};
// kernels/ntx_gemm.py:TC_TILES lists the same (BM, BN, BK), in this order
using TileSmall = TcTile<16, 128, 64, 1, 4, 4>;    // m <= 16 (decode)
using TileLarge = TcTile<128, 128, 64, 2, 4, 3>;   // prefill and larger

// Fill one ring stage with the A tile (rows m0.., k k0..) and the B tile
// (k k0.., cols n0..); whatever lies past M, N or K is zero.
template <class T, bool VEC>
__device__ __forceinline__ void tc_load(uint16_t* a_s, uint16_t* b_s,
                                        const uint16_t* __restrict__ A,
                                        const uint16_t* __restrict__ B,
                                        int M, int N, int K, int m0, int n0,
                                        int k0) {
  const int tid = threadIdx.x;
  if (VEC) {   // 16-byte copies; K and N are multiples of 8
    constexpr int ACR = T::BK / 8, BCR = T::BN / 8;
#pragma unroll
    for (int i = 0; i < T::BM * T::BK / 8 / T::kThreads; ++i) {
      const int c = tid + i * T::kThreads;
      const int r = c / ACR, kc = (c % ACR) * 8;
      const int gr = m0 + r, gk = k0 + kc;
      const bool ok = gr < M && gk < K;
      cp_async16(a_s + r * T::kAStride + kc,
                 ok ? A + (size_t)gr * K + gk : A, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < T::BK * T::BN / 8 / T::kThreads; ++i) {
      const int c = tid + i * T::kThreads;
      const int r = c / BCR, nc = (c % BCR) * 8;
      const int gk = k0 + r, gn = n0 + nc;
      const bool ok = gk < K && gn < N;
      cp_async16(b_s + r * T::kBStride + nc,
                 ok ? B + (size_t)gk * N + gn : B, ok ? 16 : 0);
    }
  } else {     // masked 2-byte loads: any alignment, any K and N
    for (int e = tid; e < T::BM * T::BK; e += T::kThreads) {
      const int r = e / T::BK, kk = e % T::BK;
      const int gr = m0 + r, gk = k0 + kk;
      a_s[r * T::kAStride + kk] =
          (gr < M && gk < K) ? A[(size_t)gr * K + gk] : (uint16_t)0;
    }
    for (int e = tid; e < T::BK * T::BN; e += T::kThreads) {
      const int r = e / T::BN, j = e % T::BN;
      const int gk = k0 + r, gn = n0 + j;
      b_s[r * T::kBStride + j] =
          (gk < K && gn < N) ? B[(size_t)gk * N + gn] : (uint16_t)0;
    }
  }
}

// The warp's share of one ring stage: BK / 16 k-steps of MI x NI mmas.
template <class T>
__device__ __forceinline__ void tc_compute(const uint16_t* a_s,
                                           const uint16_t* b_s,
                                           float (&acc)[T::MI][T::NI][4],
                                           int wm, int wn, int lane) {
#pragma unroll
  for (int kk = 0; kk < T::BK; kk += 16) {
    uint32_t af[T::MI][4];
    uint32_t bf[T::NI][2];
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi) {
      // lanes 0-15 address rows 0-15 at k 0, lanes 16-31 the same rows
      // at k 8: a0..a3 of the m16n8k16 A fragment
      const int row = wm * T::WTM + mi * 16 + (lane & 15);
      const int col = kk + (lane >> 4) * 8;
      ldmatrix_x4(af[mi], a_s + row * T::kAStride + col);
    }
#pragma unroll
    for (int nj = 0; nj < T::NI; nj += 2) {
      // lanes 0-15 address k rows 0-15 at n 0, lanes 16-31 at n 8; the
      // transpose gives b0, b1 of two n8 tiles
      const int krow = kk + (lane & 15);
      const int col = wn * T::WTN + nj * 8 + (lane >> 4) * 8;
      uint32_t r[4];
      ldmatrix_x4_trans(r, b_s + krow * T::kBStride + col);
      bf[nj][0] = r[0];
      bf[nj][1] = r[1];
      bf[nj + 1][0] = r[2];
      bf[nj + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni)
        mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
  }
}

// Grid (m tiles, n tiles, lanes * splits); block z is split z % splits of
// lane z / splits, and split z takes k tiles [z * kt / splits, (z + 1) *
// kt / splits) of kt = ceil(K / BK): every lane is cut as a one-lane
// launch is. splits == 1: the epilogue and the store in the output dtype
// here; otherwise the fp32 partial to ws (lanes, splits, M, N) for
// tc_reduce.
template <class T, typename TO, bool VEC>
__global__ void __launch_bounds__(T::kThreads)
gemm_bf16_tc(const uint16_t* __restrict__ A, const uint16_t* __restrict__ B,
             TO* __restrict__ C, float* __restrict__ ws, int M, int N, int K,
             int splits, long long lda, long long ldb, Epilogue ep) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sA = reinterpret_cast<uint16_t*>(smem);
  uint16_t* sB = sA + T::STAGES * T::kAStage;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  const int split = blockIdx.z % splits;
  A += blockIdx.z / splits * lda;
  B += blockIdx.z / splits * ldb;
  C += (size_t)(blockIdx.z / splits) * M * N;
  const int k_tiles = (K + T::BK - 1) / T::BK;
  const int kt0 = (int)((long long)split * k_tiles / splits);
  const int kt1 = (int)((long long)(split + 1) * k_tiles / splits);
  const int nkt = kt1 - kt0;

  float acc[T::MI][T::NI][4];
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

#pragma unroll
  for (int st = 0; st < T::STAGES - 1; ++st) {
    if (st < nkt)
      tc_load<T, VEC>(sA + st * T::kAStage, sB + st * T::kBStage, A, B, M,
                      N, K, m0, n0, (kt0 + st) * T::BK);
    cp_async_commit();
  }
  for (int i = 0; i < nkt; ++i) {
    cp_async_wait<T::STAGES - 2>();   // tile i has landed
    __syncthreads();                  // ... for every thread; stage
                                      // (i - 1) % STAGES is free again
    const int nxt = i + T::STAGES - 1;
    if (nxt < nkt) {
      const int st = nxt % T::STAGES;
      tc_load<T, VEC>(sA + st * T::kAStage, sB + st * T::kBStage, A, B, M,
                      N, K, m0, n0, (kt0 + nxt) * T::BK);
    }
    cp_async_commit();
    const int cur = i % T::STAGES;
    tc_compute<T>(sA + cur * T::kAStage, sB + cur * T::kBStage, acc, wm, wn,
                  lane);
  }
  cp_async_wait<0>();
  __syncthreads();                    // the ring is free: reuse it

  // accumulators -> shared fp32 tile (c0, c1 at row g, c2, c3 at g + 8)
  float* sC = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wm * T::WTM + mi * 16 + (lane >> 2) + (e >> 1) * 8;
        const int c = wn * T::WTN + ni * 8 + (lane & 3) * 2 + (e & 1);
        sC[r * T::kCStride + c] = acc[mi][ni][e];
      }
  __syncthreads();
  // the epilogue, then the store, on elements tid + j * kThreads: each
  // thread reads back only what it wrote, and a warp covers whole rows
  if (splits == 1) tile_epilogue<T>(sC, ep, blockIdx.z, m0, n0, M, N);
  float* part = ws + (size_t)blockIdx.z * M * N;
  for (int e = tid; e < T::BM * T::BN; e += T::kThreads) {
    const int r = m0 + e / T::BN, c = n0 + e % T::BN;
    if (r >= M || c >= N) continue;
    const float v = sC[(e / T::BN) * T::kCStride + e % T::BN];
    if (splits == 1) store(C + (size_t)r * N + c, v);
    else part[(size_t)r * N + c] = v;
  }
}

// The partials of every split added in split order, then the epilogue
// once on the fp32 sum and one rounding to the output dtype; lanes in
// turn (ws (lanes, splits, M, N), C (lanes, M, N)).
template <typename TO>
__global__ void __launch_bounds__(256)
tc_reduce(const float* __restrict__ ws, TO* __restrict__ C, int M, int N,
          int splits, int lanes, Epilogue ep) {
  const size_t total = (size_t)M * N;
  const size_t step = (size_t)gridDim.x * blockDim.x;
  for (size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       g < total * lanes; g += step) {
    const int ln = (int)(g / total);
    const size_t i = g - (size_t)ln * total;
    const float* w = ws + (size_t)ln * splits * total;
    float acc = w[i];
    for (int z = 1; z < splits; ++z) acc = acc + w[(size_t)z * total + i];
    const int r = (int)(i / N), c = (int)(i % N);
    store(C + g, epilogue(acc, ep, ln, r, c, N));
  }
}

// cudaFuncAttributeMaxDynamicSharedMemorySize once per instantiation and
// card (the ring is past the 48 KB a launch gets without it)
template <class T, typename TO, bool VEC>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(gemm_bf16_tc<T, TO, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmem);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// Lanes and their strides, passed to every launch of the routes.
struct Lanes {
  int n;           // lanes
  long long a, b;  // elements from one lane's A (B) to the next
};

template <class T, typename TO, bool VEC>
cudaError_t launch_tc_tile(const void* a, const void* b, void* c,
                           float* ws, int m, int n, int k, int splits,
                           const Lanes& ln, const Epilogue& ep,
                           cudaStream_t s) {
  cudaError_t err = allow_smem<T, TO, VEC>();
  if (err != cudaSuccess) return err;
  const dim3 grid((m + T::BM - 1) / T::BM, (n + T::BN - 1) / T::BN,
                  ln.n * splits);
  gemm_bf16_tc<T, TO, VEC><<<grid, T::kThreads, T::kSmem, s>>>(
      static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b),
      static_cast<TO*>(c), ws, m, n, k, splits, ln.a, ln.b, ep);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = (size_t)m * n * ln.n;
  const size_t need = (total + 255) / 256;
  const int blocks = (int)(need < 132 * 8 ? need : 132 * 8);
  tc_reduce<TO><<<blocks, 256, 0, s>>>(ws, static_cast<TO*>(c), m, n,
                                       splits, ln.n, ep);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_tc(const void* a, const void* b, void* c, float* ws,
                      int m, int n, int k, int tile, int splits, bool vec,
                      const Lanes& ln, const Epilogue& ep, cudaStream_t s) {
  if (tile == 0 && vec)
    return launch_tc_tile<TileSmall, TO, true>(a, b, c, ws, m, n, k, splits,
                                               ln, ep, s);
  if (tile == 0)
    return launch_tc_tile<TileSmall, TO, false>(a, b, c, ws, m, n, k, splits,
                                                ln, ep, s);
  if (vec)
    return launch_tc_tile<TileLarge, TO, true>(a, b, c, ws, m, n, k, splits,
                                               ln, ep, s);
  return launch_tc_tile<TileLarge, TO, false>(a, b, c, ws, m, n, k, splits,
                                              ln, ep, s);
}


// ---------------------------------------------------------------------
// fp32 route, large tile: register-tiled FFMA from a multi-stage ring.
// ---------------------------------------------------------------------
// A 128 x BN block tile, 256 threads as 16 x 16, an 8 x TN fp32 register
// tile per thread (rows ty * 4 + {0..3} and 64 + ty * 4 + {0..3}, columns
// tx * 4 + {0..3} of each BN / (TN / 4)-wide column group), BK = 16. A is
// kept k-major in shared memory and B row-major, both rows padded by 4
// floats, in a STAGES-deep ring: B tiles arrive by 16-byte cp.async
// STAGES - 1 tiles ahead; A, transposed on the way, by float4 loads into
// registers issued before a tile's products and stored after them. Each
// k step reads its fragments as float4 (2 + TN / 4 shared loads for
// 8 TN FFMA).
template <int BN_, int TN_, int STAGES_>
struct FfmaTile {
  static constexpr int BM = 128, BN = BN_, TM = 8, TN = TN_, BK = 16;
  static constexpr int STAGES = STAGES_;
  static constexpr int TX = BN / TN, TY = BM / TM;
  static constexpr int LDA = BM + 4, LDB = BN + 4;
  static constexpr int kAStage = BK * LDA, kBStage = BK * LDB;   // floats
  static constexpr int kSmem = STAGES * (kAStage + kBStage) * 4;
  static constexpr int AV = BM * BK / 4 / kThreads;   // A float4 a thread
  static constexpr int BV = BK * BN / 4 / kThreads;   // B float4 a thread
  static constexpr int CW = BN / (TN / 4);            // column group width
  static_assert(TX * TY == kThreads && TY == 16 && TN % 4 == 0 && AV >= 1 &&
                BV >= 1 && kKahanSlab % BK == 0, "thread tile");
};
// kernels/ntx_gemm.py:FFMA_TILES[2] lists its (BM, BN, TM, TN, STAGES);
// compensated, its 3 x 64 fp32 register tiles take 255 registers, no spill
using FfmaLarge = FfmaTile<128, 8, 3>;

// The A tile (rows m0.., k k0..k0 + 15) into registers; whatever lies
// past M or K is zero. VEC: K % 4 == 0 and A 16-byte aligned.
template <class T, bool VEC>
__device__ __forceinline__ void ffma_load_a(float4 (&ra)[T::AV],
                                            const float* __restrict__ A,
                                            int M, int K, int m0, int k0) {
#pragma unroll
  for (int j = 0; j < T::AV; ++j) {
    const int f = threadIdx.x + j * kThreads;
    const int gr = m0 + (f >> 2), gk = k0 + (f & 3) * 4;
    const float* p = A + (size_t)gr * K + gk;
    if (VEC) {
      ra[j] = (gr < M && gk < K) ? __ldg(reinterpret_cast<const float4*>(p))
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      const bool r_ok = gr < M;
      ra[j].x = r_ok && gk < K ? __ldg(p) : 0.0f;
      ra[j].y = r_ok && gk + 1 < K ? __ldg(p + 1) : 0.0f;
      ra[j].z = r_ok && gk + 2 < K ? __ldg(p + 2) : 0.0f;
      ra[j].w = r_ok && gk + 3 < K ? __ldg(p + 3) : 0.0f;
    }
  }
}

template <class T>
__device__ __forceinline__ void ffma_store_a(float* as,
                                             const float4 (&ra)[T::AV]) {
#pragma unroll
  for (int j = 0; j < T::AV; ++j) {
    const int f = threadIdx.x + j * kThreads;
    const int r = f >> 2, kc = (f & 3) * 4;
    as[(kc + 0) * T::LDA + r] = ra[j].x;
    as[(kc + 1) * T::LDA + r] = ra[j].y;
    as[(kc + 2) * T::LDA + r] = ra[j].z;
    as[(kc + 3) * T::LDA + r] = ra[j].w;
  }
}

// The B tile (k k0.., columns n0..): VEC by cp.async into bs (N % 4 == 0,
// B 16-byte aligned); otherwise masked scalar loads into rb.
template <class T, bool VEC>
__device__ __forceinline__ void ffma_load_b(float* bs, float4 (&rb)[T::BV],
                                            const float* __restrict__ B,
                                            int N, int K, int n0, int k0) {
#pragma unroll
  for (int j = 0; j < T::BV; ++j) {
    const int f = threadIdx.x + j * kThreads;
    const int kr = f / (T::BN / 4), nc = (f % (T::BN / 4)) * 4;
    const int gk = k0 + kr, gn = n0 + nc;
    const float* p = B + (size_t)gk * N + gn;
    if (VEC) {
      const bool ok = gk < K && gn < N;
      cp_async16(bs + kr * T::LDB + nc, ok ? p : B, ok ? 16 : 0);
    } else {
      const bool k_ok = gk < K;
      rb[j].x = k_ok && gn < N ? __ldg(p) : 0.0f;
      rb[j].y = k_ok && gn + 1 < N ? __ldg(p + 1) : 0.0f;
      rb[j].z = k_ok && gn + 2 < N ? __ldg(p + 2) : 0.0f;
      rb[j].w = k_ok && gn + 3 < N ? __ldg(p + 3) : 0.0f;
    }
  }
}

template <class T>
__device__ __forceinline__ void ffma_store_b(float* bs,
                                             const float4 (&rb)[T::BV]) {
#pragma unroll
  for (int j = 0; j < T::BV; ++j) {
    const int f = threadIdx.x + j * kThreads;
    const int kr = f / (T::BN / 4), nc = (f % (T::BN / 4)) * 4;
    *reinterpret_cast<float4*>(bs + kr * T::LDB + nc) = rb[j];
  }
}

// Four output elements from column c on: one 16- (fp32) or 8-byte (bf16)
// store where all four lie inside N and the row is so aligned.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]),
                                            pack_bf16(v[2], v[3]));
}

// Grid (ceil(N / BN), ceil(M / 128)). KAHAN compensates across
// kKahanSlab-deep slabs of k exactly as gemm_kernel does.
template <class T, typename TO, bool KAHAN, bool VEC>
__global__ void __launch_bounds__(kThreads, KAHAN ? 1 : 2)
gemm_ffma(const float* __restrict__ A, const float* __restrict__ B,
          TO* __restrict__ C, int M, int N, int K, long long lda,
          long long ldb, Epilogue ep) {
  extern __shared__ __align__(16) unsigned char smem[];
  // grid z walks the lanes (read again at the store: no register held);
  // the compensated variant takes one lane and keeps the pointers as
  // launch parameters (no registers at its 255)
  if (!KAHAN) {
    A += blockIdx.z * lda;
    B += blockIdx.z * ldb;
    C += (size_t)blockIdx.z * M * N;
  }
  float* sA = reinterpret_cast<float*>(smem);
  float* sB = sA + T::STAGES * T::kAStage;
  const int tid = threadIdx.x, tx = tid % T::TX, ty = tid / T::TX;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int nkt = (K + T::BK - 1) / T::BK;

  constexpr int SM = KAHAN ? T::TM : 1, SN = KAHAN ? T::TN : 1;
  float acc[T::TM][T::TN], sum[SM][SN], comp[SM][SN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int i = 0; i < SM; ++i)
#pragma unroll
    for (int j = 0; j < SN; ++j) sum[i][j] = comp[i][j] = 0.0f;

  float4 ra[T::AV], rb[T::BV];
#pragma unroll
  for (int st = 0; st < T::STAGES - 1; ++st) {
    if (st < nkt) {
      ffma_load_a<T, VEC>(ra, A, M, K, m0, st * T::BK);
      ffma_store_a<T>(sA + st * T::kAStage, ra);
      ffma_load_b<T, VEC>(sB + st * T::kBStage, rb, B, N, K, n0, st * T::BK);
      if (!VEC) ffma_store_b<T>(sB + st * T::kBStage, rb);
    }
    cp_async_commit();
  }
  for (int it = 0; it < nkt; ++it) {
    const int nxt = it + T::STAGES - 1;
    const bool more = nxt < nkt;
    const int ns = nxt % T::STAGES;
    if (more) {   // in flight while tile it is multiplied
      ffma_load_a<T, VEC>(ra, A, M, K, m0, nxt * T::BK);
      if (!VEC)
        ffma_load_b<T, false>(sB + ns * T::kBStage, rb, B, N, K, n0,
                              nxt * T::BK);
    }
    cp_async_wait<T::STAGES - 2>();   // tile it's B has landed
    __syncthreads();                  // ... for all; stage ns is free again
    if (more && VEC)
      ffma_load_b<T, true>(sB + ns * T::kBStage, rb, B, N, K, n0,
                           nxt * T::BK);
    cp_async_commit();
    const float* as = sA + (it % T::STAGES) * T::kAStage;
    const float* bs = sB + (it % T::STAGES) * T::kBStage;
#pragma unroll
    for (int kk = 0; kk < T::BK; ++kk) {
      float a[T::TM], b[T::TN];
      const float4 a0 =
          *reinterpret_cast<const float4*>(as + kk * T::LDA + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + kk * T::LDA + 64 + ty * 4);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
#pragma unroll
      for (int j4 = 0; j4 < T::TN / 4; ++j4) {
        const float4 bv = *reinterpret_cast<const float4*>(
            bs + kk * T::LDB + j4 * T::CW + tx * 4);
        b[4 * j4] = bv.x; b[4 * j4 + 1] = bv.y;
        b[4 * j4 + 2] = bv.z; b[4 * j4 + 3] = bv.w;
      }
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j)
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {   // stage ns was last read before this iteration's barrier
      ffma_store_a<T>(sA + ns * T::kAStage, ra);
      if (!VEC) ffma_store_b<T>(sB + ns * T::kBStage, rb);
    }
    if (KAHAN && (((it + 1) * T::BK) % kKahanSlab == 0 || it + 1 == nkt)) {
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j) {
          neumaier(sum[i % SM][j % SN], comp[i % SM][j % SN], acc[i][j]);
          acc[i][j] = 0.0f;
        }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int r = m0 + (i >> 2) * 64 + ty * 4 + (i & 3);
    if (r >= M) continue;
#pragma unroll
    for (int j4 = 0; j4 < T::TN / 4; ++j4) {
      const int c = n0 + j4 * T::CW + tx * 4;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * j4 + e;
        v[e] = KAHAN ? __fadd_rn(sum[i % SM][j % SN], comp[i % SM][j % SN])
                     : acc[i][j];
        if (c + e < N)
          v[e] = epilogue(v[e], ep, KAHAN ? 0 : blockIdx.z, r, c + e, N);
      }
      TO* out = C + (size_t)r * N + c;
      if (VEC && c + 3 < N) {
        store4(out, v);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < N) store(out + e, v[e]);
      }
    }
  }
}

template <class T, typename TO, bool KAHAN, bool VEC>
cudaError_t launch_ffma_tile(const void* a, const void* b, void* c, int m,
                             int n, int k, const Lanes& ln,
                             const Epilogue& ep, cudaStream_t s) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !done[dev]) {
    err = cudaFuncSetAttribute(gemm_ffma<T, TO, KAHAN, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) done[dev] = true;
  }
  const dim3 grid((n + T::BN - 1) / T::BN, (m + T::BM - 1) / T::BM, ln.n);
  gemm_ffma<T, TO, KAHAN, VEC><<<grid, kThreads, T::kSmem, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<TO*>(c), m, n, k, ln.a, ln.b, ep);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_ffma(const void* a, const void* b, void* c, int m, int n,
                        int k, bool kahan, bool vec, const Lanes& ln,
                        const Epilogue& ep, cudaStream_t s) {
  using T = FfmaLarge;
  if (kahan)
    return vec ? launch_ffma_tile<T, TO, true, true>(a, b, c, m, n, k, ln,
                                                     ep, s)
               : launch_ffma_tile<T, TO, true, false>(a, b, c, m, n, k, ln,
                                                      ep, s);
  return vec ? launch_ffma_tile<T, TO, false, true>(a, b, c, m, n, k, ln, ep,
                                                    s)
             : launch_ffma_tile<T, TO, false, false>(a, b, c, m, n, k, ln, ep,
                                                     s);
}

// The FFMA route's tile for a product, as ntx_gemm.ffma_plan picks it:
// 0 (16 x 128) for m <= 16, 2 (the register-tiled 128-row tile) for fp32
// inputs where it gives at least one block per SM, 1 (64 x 64) otherwise.
int ffma_tile(int m, int n, bool in_bf16) {
  if (m <= 16) return 0;
  if (in_bf16) return 1;
  using T = FfmaLarge;
  const long long blocks =
      (long long)((m + T::BM - 1) / T::BM) * ((n + T::BN - 1) / T::BN);
  return blocks >= kSms ? 2 : 1;
}

}  // namespace

extern "C" {

// a (m, k), b (k, n), c (m, n): row-major on the device, a and b both
// fp32 (in_bf16 = 0) or both bf16; c fp32 or bf16 (out_bf16);
// compensated = 1 takes the Neumaier (Kahan) variant.
// lanes >= 1 independent products in one launch: lane l's a starts lda
// elements after lane l - 1's, its b ldb after (each lane's own matrices
// contiguous), and c holds the lanes one after the other, (lanes, m, n).
// Every lane is cut by the tile and splits a one-lane launch of (m, n, k)
// takes, so each lane's bits equal that launch's. The compensated route
// refuses lanes > 1 (its register tiles leave no room for lane pointers).
// kinds/imms/operands/op_bf16/op_lane: host arrays of n_stages epilogue
// stages; each operand is a device pointer to a contiguous fp32 or bf16
// (op_bf16) array per lane ((n,) for bias, (m, n) for residual/mul/sub/
// mask), lane l's op_lane[s] elements after lane l - 1's, or null for
// the scalar kinds.
// bf16 and not compensated: the tensor-core route, with tile 0 (16 x
// 128 x 64) or 1 (128 x 128 x 64) and splits k splits, each at least one
// k tile; with splits > 1, ws holds lanes * splits * m * n fp32
// partials. The FFMA routes take splits 1, no ws and the tile ffma_tile
// gives (0: 16 x 128, 1: 64 x 64, 2: the register-tiled 128-row tile).
int ntx_gemm(const void* a, const void* b, void* c, int m, int n, int k,
             int lanes, long long lda, long long ldb, int in_bf16,
             int out_bf16, int compensated, int n_stages, const int* kinds,
             const float* imms, const void* const* operands,
             const int* op_bf16, const long long* op_lane, int tile,
             int splits, void* ws, void* stream) {
  if (n_stages < 0 || n_stages > kMaxEpilogue || m < 0 || n < 0 || k < 0 ||
      tile < 0 || tile > 2 || splits < 1 || lanes < 1 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  if (lanes == 1) lda = ldb = 0;
  if (lanes > 1 && (compensated || lda < (long long)m * k ||
                    ldb < (long long)k * n))
    return (int)cudaErrorInvalidValue;   // the compensated route: one lane
  const bool tc = in_bf16 && !compensated;
  if (tc) {
    if (tile > 1) return (int)cudaErrorInvalidValue;
    const int bk = tile == 0 ? TileSmall::BK : TileLarge::BK;
    const int k_tiles = (k + bk - 1) / bk;
    if ((splits > 1 && (ws == nullptr || splits > k_tiles)) ||
        (long long)splits * lanes > 65535)
      return (int)cudaErrorInvalidValue;
  } else if (splits != 1 || tile != ffma_tile(m, n, in_bf16 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (m == 0 || n == 0) return (int)cudaGetLastError();
  Epilogue ep;
  ep.n = n_stages;
  for (int s = 0; s < kMaxEpilogue; ++s) {
    ep.kind[s] = s < n_stages ? kinds[s] : K_SCALE;
    ep.imm[s] = s < n_stages ? imms[s] : 1.0f;
    ep.op[s] = s < n_stages ? operands[s] : nullptr;
    ep.op_bf16[s] = s < n_stages ? op_bf16[s] : 0;
    ep.op_lane[s] = s < n_stages && lanes > 1 && op_lane ? op_lane[s] : 0;
  }
  const Lanes ln{lanes, lda, ldb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a);
  const uintptr_t pb = reinterpret_cast<uintptr_t>(b);
  if (tc) {
    // 16-byte copies: every lane's a and b on a 16-byte boundary
    const bool vec = ((pa | pb) & 15u) == 0 && k % 8 == 0 && n % 8 == 0 &&
                     lda % 8 == 0 && ldb % 8 == 0;
    float* w = static_cast<float*>(ws);
    cudaError_t err =
        out_bf16 ? launch_tc<__nv_bfloat16>(a, b, c, w, m, n, k, tile, splits,
                                            vec, ln, ep, s)
                 : launch_tc<float>(a, b, c, w, m, n, k, tile, splits, vec,
                                    ln, ep, s);
    return (int)err;
  }
  if (in_bf16) {   // compensated: the tensor-core route took the rest
    if (out_bf16)
      launch<__nv_bfloat16, __nv_bfloat16, true>(a, b, c, m, n, k, lanes, lda,
                                                 ldb, tile, ep, s);
    else
      launch<__nv_bfloat16, float, true>(a, b, c, m, n, k, lanes, lda, ldb,
                                         tile, ep, s);
    return (int)cudaGetLastError();
  }
  const bool kahan = compensated != 0;
  if (tile == 2) {
    const bool vec = ((pa | pb) & 15u) == 0 && k % 4 == 0 && n % 4 == 0 &&
                     lda % 4 == 0 && ldb % 4 == 0;
    return (int)(out_bf16 ? launch_ffma<__nv_bfloat16>(a, b, c, m, n, k, kahan,
                                                       vec, ln, ep, s)
                          : launch_ffma<float>(a, b, c, m, n, k, kahan, vec,
                                               ln, ep, s));
  }
  if (kahan) {
    if (out_bf16)
      launch<float, __nv_bfloat16, true>(a, b, c, m, n, k, lanes, lda, ldb,
                                         tile, ep, s);
    else launch<float, float, true>(a, b, c, m, n, k, lanes, lda, ldb, tile,
                                    ep, s);
  } else {
    if (out_bf16)
      launch<float, __nv_bfloat16, false>(a, b, c, m, n, k, lanes, lda, ldb,
                                          tile, ep, s);
    else launch<float, float, false>(a, b, c, m, n, k, lanes, lda, ldb, tile,
                                     ep, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
