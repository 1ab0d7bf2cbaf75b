// NTX streaming datapath on Hopper: one FPU with an opcode register, run
// over a stage list with an optional reduction tail.
//
// Replaces the TPU kernels
//   repro/kernels/ntx_elementwise.py:elementwise_pallas        (_ew_kernel)
//   repro/kernels/ntx_elementwise.py:elementwise_chain_pallas  (_chain_kernel)
//   repro/kernels/ntx_reduce.py:chain_reduce_pallas    (_chain_reduce_kernel)
//   repro/kernels/ntx_reduce.py:reduce_pallas                  (_reduce_kernel)
// A single command is a one-stage chain, a plain reduction a zero-stage
// chain with a tail, so one set of templates covers all four.
//
// Bound on the H100: bytes. Every stage is one or two fp32 operations
// per element read, far below the ~20 flop/byte an fp32 pass needs to
// leave the memory bound. A 1 x 2^22 AXPY moves 50 MB (15 us at 3.35
// TB/s); the serving ARGMAX reads one 128256-entry logits row (0.5 MB,
// 0.15 us), so there the launches and the host's time to issue them
// set the time, not the card's bandwidth.
//
// Design. The Pallas kernels walk a row in blocks on one core; a first
// port ran one CUDA block per row, so a long row used one SM of 132.
// Here a row is split across blocks:
//   * no tail: one grid-stride pass over all rows * n elements (x, out
//     and every operand share the contiguous (rows, n) layout), with
//     16-byte float4 loads and stores when every pointer is 16-byte
//     aligned, and a scalar instantiation, chosen by the launcher, when
//     one is not (descriptor programs hand the kernel views of the
//     memory image at any element offset);
//   * lane-batched launches (the Executor's multistream/pipeline vmap
//     transport runs one launch for L uniform lanes): x, out and each
//     operand carry their own row stride, so the rows are the lanes'
//     windows in the memory image, read in place with no gather. Where a
//     stride differs from n the pass indexes (row, column): float4 when
//     every row start is 16-byte aligned (bases and strides multiples of
//     4 elements), else scalar. A lane's elements see the same
//     arithmetic as in a one-row launch;
//   * reduction tails: one block per (row, kChunk-element chunk). Each
//     block runs the stages, writes out, reduces its chunk and stores a
//     partial (value, index) to a scratch array the wrapper keeps; the
//     row's last block to finish, counted with an integer atomic, merges
//     the partials in chunk order. One launch either way, since the
//     serving rows are set by the host's time to issue launches. The
//     split depends on n alone (not on the stages, on whether out is
//     written, or on rows), so a SUM reduces in the same order whether
//     it follows an elementwise command or ends a fused chain: the
//     serial and fused policies stay bit-equal. Loads here are scalar
//     and coalesced, one fixed element-to-thread map, for the same
//     reason. No float atomics anywhere.
//
// Exactness, to be bit-equal with the reference:
//   * AXPY and MUL round each product with __fmul_rn and each sum with
//     __fadd_rn, so the compiler cannot contract them into an FMA;
//   * THRESH is a strict '>', MASK tests '!= 0';
//   * min/max are exact in any order; arg tails reduce (value, index)
//     pairs where the greater (lesser) value wins and an equal value
//     keeps the lower index: first-wins, as np.argmax, within a thread,
//     across threads and across chunks;
//   * columns at or past n_valid contribute the tail's identity.
// Sums are taken in another order than the reference, so they agree
// within a tolerance, not bitwise; two calls give the same bits.
//
// What bounds it now (H100, chip_smoke): a 1 x 2^22 AXPY runs in ~19 us
// of device time (~2.6 TB/s, 0.8 of the bytes bound); the serving rows
// take ~7 us of device time and 20-40 us of the host's time to issue
// the call, which sets their event times. Left for later: CUDA graphs
// for the per-request sampler programs.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxStages = 8;
constexpr int kThreads = 256;
// elements of a row one block reduces (the scratch holds one partial
// per chunk; kernels/ntx_elementwise.py:STREAM_CHUNK mirrors it)
constexpr int kChunk = 4096;
constexpr int kPerThread = kChunk / kThreads;
static_assert(kChunk % kThreads == 0, "whole elements per thread");

enum Op { OP_AXPY = 0, OP_ADD, OP_SUB, OP_MUL, OP_MASK, OP_RELU, OP_THRESH,
          OP_COPY, OP_SET };
enum Tail { TAIL_NONE = 0, TAIL_SUM, TAIL_MIN, TAIL_MAX, TAIL_ARGMIN,
            TAIL_ARGMAX };

struct Stages {
  int n;
  int op[kMaxStages];
  float imm[kMaxStages];
  const float* y[kMaxStages];   // (rows, n) operand, row stride ld, or null
  long long ld[kMaxStages];     // row stride of y[s], in elements
};

__device__ __forceinline__ float apply_op(int op, float v, float y,
                                          float imm) {
  switch (op) {
    case OP_AXPY: return __fadd_rn(__fmul_rn(imm, v), y);
    case OP_ADD: return __fadd_rn(v, y);
    case OP_SUB: return __fsub_rn(v, y);
    case OP_MUL: return __fmul_rn(v, y);
    case OP_MASK: return (y != 0.0f) ? v : 0.0f;
    case OP_RELU: return (v < 0.0f) ? 0.0f : v;
    case OP_THRESH: return (v > imm) ? v : 0.0f;
    case OP_COPY: return v;
    default: return imm;          // OP_SET
  }
}

// (value, index) merge: b replaces a if it is strictly better, or equal
// with a lower index (first-wins).
template <int TAIL>
__device__ __forceinline__ void merge_arg(float& av, int& ai, float bv,
                                          int bi) {
  bool better = (TAIL == TAIL_ARGMAX) ? (bv > av) : (bv < av);
  if (better || (bv == av && bi < ai)) {
    av = bv;
    ai = bi;
  }
}

template <int TAIL>
__device__ __forceinline__ float identity() {
  if (TAIL == TAIL_MIN || TAIL == TAIL_ARGMIN) return INFINITY;
  if (TAIL == TAIL_MAX || TAIL == TAIL_ARGMAX) return -INFINITY;
  return 0.0f;
}

template <int TAIL>
__device__ __forceinline__ void combine(float& acc, int& idx, float v,
                                        int i) {
  if (TAIL == TAIL_SUM) acc += v;
  else if (TAIL == TAIL_MIN) acc = fminf(acc, v);
  else if (TAIL == TAIL_MAX) acc = fmaxf(acc, v);
  else merge_arg<TAIL>(acc, idx, v, i);
}

// Reduce (acc, idx) over the block; the result is valid in thread 0.
// The order is fixed: shuffles down within each warp, then warp 0 over
// the warps' values in warp order.
template <int TAIL>
__device__ __forceinline__ void block_reduce(float& acc, int& idx) {
  __shared__ float sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, acc, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    combine<TAIL>(acc, idx, ov, oi);
  }
  if (lane == 0) { sv[warp] = acc; si[warp] = idx; }
  __syncthreads();
  if (warp == 0) {
    constexpr int nw = kThreads / 32;
    acc = lane < nw ? sv[lane] : identity<TAIL>();
    idx = lane < nw ? si[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, acc, off);
      const int oi = __shfl_down_sync(0xffffffffu, idx, off);
      combine<TAIL>(acc, idx, ov, oi);
    }
  }
}

template <int TAIL>
__device__ __forceinline__ void store_result(void* red, int red_int,
                                             int row, float acc, int idx) {
  const bool arg = (TAIL == TAIL_ARGMIN || TAIL == TAIL_ARGMAX);
  if (arg && red_int) static_cast<int*>(red)[row] = idx;
  else static_cast<float*>(red)[row] = arg ? (float)idx : acc;
}

// ---------------------------------------------------------------------
// No tail: a grid-stride pass over `total` contiguous elements.
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
stream_flat_scalar(const float* __restrict__ x, float* __restrict__ out,
                   size_t total, Stages st) {
  const size_t step = (size_t)gridDim.x * kThreads;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += step) {
    float v = x ? x[i] : 0.0f;
#pragma unroll 1
    for (int s = 0; s < st.n; ++s) {
      const float y = st.y[s] ? st.y[s][i] : 0.0f;
      v = apply_op(st.op[s], v, y, st.imm[s]);
    }
    out[i] = v;
  }
}

// Every pointer 16-byte aligned: float4 over the first total / 4 * 4
// elements, then the last (total % 4) scalars by the first threads.
__global__ void __launch_bounds__(kThreads)
stream_flat_vec4(const float* __restrict__ x, float* __restrict__ out,
                 size_t total, Stages st) {
  const size_t n4 = total / 4;
  const size_t step = (size_t)gridDim.x * kThreads;
  const size_t tid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  for (size_t i = tid; i < n4; i += step) {
    float4 v = x ? reinterpret_cast<const float4*>(x)[i]
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 1
    for (int s = 0; s < st.n; ++s) {
      float4 y = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (st.y[s]) y = reinterpret_cast<const float4*>(st.y[s])[i];
      const int op = st.op[s];
      const float imm = st.imm[s];
      v.x = apply_op(op, v.x, y.x, imm);
      v.y = apply_op(op, v.y, y.y, imm);
      v.z = apply_op(op, v.z, y.z, imm);
      v.w = apply_op(op, v.w, y.w, imm);
    }
    reinterpret_cast<float4*>(out)[i] = v;
  }
  const size_t i = n4 * 4 + tid;
  if (i < total) {
    float v = x ? x[i] : 0.0f;
#pragma unroll 1
    for (int s = 0; s < st.n; ++s) {
      const float y = st.y[s] ? st.y[s][i] : 0.0f;
      v = apply_op(st.op[s], v, y, st.imm[s]);
    }
    out[i] = v;
  }
}

// ---------------------------------------------------------------------
// No tail, rows with their own strides (lane-batched launches: row r of
// x, out and each operand starts at r * its stride). One grid-stride
// pass over the rows * n elements, element i at (i / n, i % n).
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
stream_rows_scalar(const float* __restrict__ x, long long ldx,
                   float* __restrict__ out, long long ldo, int n,
                   size_t total, Stages st) {
  const size_t step = (size_t)gridDim.x * kThreads;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += step) {
    const size_t r = i / n, c = i - r * n;
    float v = x ? x[r * ldx + c] : 0.0f;
#pragma unroll 1
    for (int s = 0; s < st.n; ++s) {
      const float y = st.y[s] ? st.y[s][r * st.ld[s] + c] : 0.0f;
      v = apply_op(st.op[s], v, y, st.imm[s]);
    }
    out[r * ldo + c] = v;
  }
}

// Every row start 16-byte aligned (bases and strides multiples of 4
// elements): float4 over the first n / 4 * 4 columns of each row, then
// the last n % 4 columns of every row one element at a time.
__global__ void __launch_bounds__(kThreads)
stream_rows_vec4(const float* __restrict__ x, long long ldx,
                 float* __restrict__ out, long long ldo, int n, int rows,
                 Stages st) {
  const int n4 = n / 4, rem = n - n4 * 4;
  const size_t vecs = (size_t)rows * n4;
  const size_t step = (size_t)gridDim.x * kThreads;
  const size_t tid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  for (size_t i = tid; i < vecs; i += step) {
    const size_t r = i / n4, c = (i - r * n4) * 4;
    float4 v = x ? *reinterpret_cast<const float4*>(x + r * ldx + c)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 1
    for (int s = 0; s < st.n; ++s) {
      float4 y = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (st.y[s])
        y = *reinterpret_cast<const float4*>(st.y[s] + r * st.ld[s] + c);
      const int op = st.op[s];
      const float imm = st.imm[s];
      v.x = apply_op(op, v.x, y.x, imm);
      v.y = apply_op(op, v.y, y.y, imm);
      v.z = apply_op(op, v.z, y.z, imm);
      v.w = apply_op(op, v.w, y.w, imm);
    }
    *reinterpret_cast<float4*>(out + r * ldo + c) = v;
  }
  for (size_t i = tid; i < (size_t)rows * rem; i += step) {
    const size_t r = i / rem, c = (size_t)n4 * 4 + (i - r * rem);
    float v = x ? x[r * ldx + c] : 0.0f;
#pragma unroll 1
    for (int s = 0; s < st.n; ++s) {
      const float y = st.y[s] ? st.y[s][r * st.ld[s] + c] : 0.0f;
      v = apply_op(st.op[s], v, y, st.imm[s]);
    }
    out[r * ldo + c] = v;
  }
}

// ---------------------------------------------------------------------
// Reduction tails: block b reduces chunk (b % chunks) of row
// (b / chunks). With chunks == 1 it stores the row's result. Otherwise it
// stores the chunk's partial (value, index; the index counted from the
// row start), and the row's last block to finish, found with an atomic
// counter per row, merges the row's partials: thread t takes chunks t,
// t + kThreads, ... in order, then the block reduces in a fixed order.
// That block sets the counter back to 0 for the next launch on the
// stream (the wrapper zeroes the counters once, when it makes them).
// ---------------------------------------------------------------------
template <int TAIL>
__global__ void __launch_bounds__(kThreads)
stream_chunk_kernel(const float* __restrict__ x, long long ldx,
                    float* __restrict__ out, long long ldo, int n,
                    int n_valid, int chunks, Stages st,
                    unsigned* __restrict__ counters,
                    float* __restrict__ part_v, int* __restrict__ part_i,
                    void* red, int red_int) {
  const int row = blockIdx.x / chunks;
  const int chunk = blockIdx.x - row * chunks;
  const size_t xbase = (size_t)row * ldx, obase = (size_t)row * ldo;
  const int c0 = chunk * kChunk;
  float acc = identity<TAIL>();
  int idx = 0;
#pragma unroll 4
  for (int j = 0; j < kPerThread; ++j) {
    const int c = c0 + j * kThreads + threadIdx.x;
    if (c >= n) break;
    float v = x ? x[xbase + c] : 0.0f;
#pragma unroll 1
    for (int s = 0; s < st.n; ++s) {
      const float y = st.y[s] ? st.y[s][(size_t)row * st.ld[s] + c] : 0.0f;
      v = apply_op(st.op[s], v, y, st.imm[s]);
    }
    if (out) out[obase + c] = v;
    if (c < n_valid) {
      if (TAIL == TAIL_ARGMAX) { if (v > acc) { acc = v; idx = c; } }
      else if (TAIL == TAIL_ARGMIN) { if (v < acc) { acc = v; idx = c; } }
      else combine<TAIL>(acc, idx, v, c);
    }
  }
  block_reduce<TAIL>(acc, idx);
  if (chunks == 1) {
    if (threadIdx.x == 0) store_result<TAIL>(red, red_int, row, acc, idx);
    return;
  }
  __shared__ bool last;
  if (threadIdx.x == 0) {
    part_v[blockIdx.x] = acc;
    part_i[blockIdx.x] = idx;
    __threadfence();            // the partial is visible before the count
    last = atomicAdd(&counters[row], 1u) == (unsigned)chunks - 1;
  }
  __syncthreads();
  if (!last) return;
  const size_t pbase = (size_t)row * chunks;
  acc = identity<TAIL>();
  idx = 0;
  for (int j = threadIdx.x; j < chunks; j += kThreads)   // L2, not L1
    combine<TAIL>(acc, idx, __ldcg(part_v + pbase + j),
                  __ldcg(part_i + pbase + j));
  block_reduce<TAIL>(acc, idx);
  if (threadIdx.x == 0) {
    store_result<TAIL>(red, red_int, row, acc, idx);
    counters[row] = 0;
  }
}

template <int TAIL>
void launch_tail(const float* x, long long ldx, float* out, long long ldo,
                 int rows, int n, int n_valid, int chunks, const Stages& st,
                 unsigned* counters, float* part_v, int* part_i, void* red,
                 int red_int, cudaStream_t s) {
  const unsigned blocks = (unsigned)((size_t)rows * chunks);
  stream_chunk_kernel<TAIL><<<blocks, kThreads, 0, s>>>(
      x, ldx, out, ldo, n, n_valid, chunks, st, counters, part_v, part_i,
      red, red_int);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Every row of a strided operand starts on a 16-byte boundary (a null
// operand has no rows to load).
bool rows_aligned16(const void* p, long long ld) {
  return p == nullptr || (aligned16(p) && ld % 4 == 0);
}

int flat_blocks(size_t work) {
  // enough blocks for 16 per SM on a 132-SM card, and no more than the
  // work needs; the loops stride over the rest
  const size_t need = (work + kThreads - 1) / kThreads;
  const size_t cap = 132 * 16;
  return (int)(need < cap ? (need > 0 ? need : 1) : cap);
}

}  // namespace

extern "C" {

const char* ntx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x/out/ys: (rows, n) fp32 on the device, row r of each starting r * its
// row stride (ldx, ldo, ldys[s], in elements; >= n, or anything for one
// row) after its base: a lane-batched launch gives rows = lanes and the
// lanes' spacing in the memory image as the strides. Contiguous operands
// (every stride n) stream as one flat run. out may be null (a reduction
// alone), x may be null (read as 0, for SET).
// ops/imms/ys/ldys: host arrays of n_stages entries.
// tail: 0 none, 1 sum, 2 min, 3 max, 4 argmin, 5 argmax; red holds one
// result per row, int32 when red_int and the tail is an arg tail, else
// fp32. chunk must be kChunk. With a tail and chunks = ceil(n / chunk)
// > 1: counters holds rows uint32 that are 0 (and are 0 again when the
// launch ends), part 2 * rows * chunks words: the fp32 partial values,
// then their int32 indices. The chunks depend on n alone, so a row's
// bits do not depend on rows or on the strides.
int ntx_stream(const void* x, long long ldx, void* out, long long ldo,
               int rows, int n, int n_valid, int n_stages, const int* ops,
               const float* imms, const void* const* ys,
               const long long* ldys, int tail, void* red, int red_int,
               int chunk, void* counters, void* part, void* stream) {
  if (n_stages < 0 || n_stages > kMaxStages || rows < 0 || n < 0 ||
      tail < 0 || tail > TAIL_ARGMAX || chunk != kChunk)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || (n == 0 && tail == TAIL_NONE))
    return (int)cudaGetLastError();
  if (tail == TAIL_NONE && out == nullptr) return (int)cudaErrorInvalidValue;
  if (rows == 1) ldx = ldo = n;      // one row: the strides are unused
  if (ldx < n || ldo < n) return (int)cudaErrorInvalidValue;
  Stages st;
  st.n = n_stages;
  bool flat = ldx == n && ldo == n;
  bool vec = aligned16(x) && aligned16(out);
  bool rvec = rows_aligned16(x, ldx) && rows_aligned16(out, ldo);
  for (int s = 0; s < kMaxStages; ++s) {
    st.op[s] = s < n_stages ? ops[s] : OP_COPY;
    st.imm[s] = s < n_stages ? imms[s] : 0.0f;
    st.y[s] = s < n_stages ? static_cast<const float*>(ys[s]) : nullptr;
    st.ld[s] = st.y[s] ? (rows == 1 ? n : ldys[s]) : n;
    if (st.ld[s] < n) return (int)cudaErrorInvalidValue;
    flat = flat && st.ld[s] == n;
    vec = vec && aligned16(st.y[s]);
    rvec = rvec && rows_aligned16(st.y[s], st.ld[s]);
  }
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tail == TAIL_NONE) {
    const size_t total = (size_t)rows * n;
    if (flat && vec)
      stream_flat_vec4<<<flat_blocks(total / 4), kThreads, 0, s>>>(
          xp, op, total, st);
    else if (flat)
      stream_flat_scalar<<<flat_blocks(total), kThreads, 0, s>>>(
          xp, op, total, st);
    else if (rvec)
      stream_rows_vec4<<<flat_blocks(total / 4), kThreads, 0, s>>>(
          xp, ldx, op, ldo, n, rows, st);
    else
      stream_rows_scalar<<<flat_blocks(total), kThreads, 0, s>>>(
          xp, ldx, op, ldo, n, total, st);
    return (int)cudaGetLastError();
  }
  const int chunks = n > 0 ? (n + kChunk - 1) / kChunk : 1;
  if (chunks > 1 && (counters == nullptr || part == nullptr))
    return (int)cudaErrorInvalidValue;
  unsigned* cnt = static_cast<unsigned*>(counters);
  float* pv = static_cast<float*>(part);
  int* pi = pv ? reinterpret_cast<int*>(pv + (size_t)rows * chunks)
                : nullptr;
  switch (tail) {
    case TAIL_SUM:
      launch_tail<TAIL_SUM>(xp, ldx, op, ldo, rows, n, n_valid, chunks, st,
                            cnt, pv, pi, red, red_int, s);
      break;
    case TAIL_MIN:
      launch_tail<TAIL_MIN>(xp, ldx, op, ldo, rows, n, n_valid, chunks, st,
                            cnt, pv, pi, red, red_int, s);
      break;
    case TAIL_MAX:
      launch_tail<TAIL_MAX>(xp, ldx, op, ldo, rows, n, n_valid, chunks, st,
                            cnt, pv, pi, red, red_int, s);
      break;
    case TAIL_ARGMIN:
      launch_tail<TAIL_ARGMIN>(xp, ldx, op, ldo, rows, n, n_valid, chunks,
                               st, cnt, pv, pi, red, red_int, s);
      break;
    default:
      launch_tail<TAIL_ARGMAX>(xp, ldx, op, ldo, rows, n, n_valid, chunks,
                               st, cnt, pv, pi, red, red_int, s);
      break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
