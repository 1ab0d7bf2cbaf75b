// NTX streaming datapath on Hopper: one FPU with an opcode register, run
// over a stage list with an optional reduction tail.
//
// Replaces the TPU kernels
//   repro/kernels/ntx_elementwise.py:elementwise_pallas        (_ew_kernel)
//   repro/kernels/ntx_elementwise.py:elementwise_chain_pallas  (_chain_kernel)
//   repro/kernels/ntx_reduce.py:chain_reduce_pallas    (_chain_reduce_kernel)
//   repro/kernels/ntx_reduce.py:reduce_pallas                  (_reduce_kernel)
// A single command is a one-stage chain, a plain reduction a zero-stage
// chain with a tail, so one kernel template covers all four; it is
// instantiated once per tail (none/sum/min/max/argmin/argmax).
//
// Bound on the H100: bytes. Every stage is one or two fp32 operations
// per element read, far below the ~20 flop/byte an fp32 pass needs to
// leave the memory bound. On the serving path the per-request ARGMAX
// reads one 128256-entry fp32 logits row (~0.5 MB, ~0.15 us at
// 3.35 TB/s), so it is bound by launch latency and by the bytes one SM
// can pull, not by the card's bandwidth.
//
// Design: one block per row, threads stride over the row, the carried
// value stays in a register from stage to stage (the TCDM-resident
// operand chain of the paper), the tail reduces thread-locally and then
// across the block with warp shuffles. One block per row suits the
// serving rows (few rows, one long reduction each); a long elementwise
// stream over one row uses one SM only, which a later PR can fix with a
// grid-stride split and a second reduction pass.
//
// Exactness, to be bit-equal with the reference:
//   * AXPY and MUL round each product with __fmul_rn and each sum with
//     __fadd_rn, so the compiler cannot contract them into an FMA;
//   * THRESH is a strict '>', MASK tests '!= 0';
//   * min/max are exact in any order; arg tails reduce (value, index)
//     pairs where the greater (lesser) value wins and an equal value
//     keeps the lower index: first-wins, as np.argmax;
//   * columns at or past n_valid contribute the tail's identity.
// Sums are taken in another order than the reference, so they agree
// within a tolerance, not bitwise.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxStages = 8;
constexpr int kThreads = 1024;

enum Op { OP_AXPY = 0, OP_ADD, OP_SUB, OP_MUL, OP_MASK, OP_RELU, OP_THRESH,
          OP_COPY, OP_SET };
enum Tail { TAIL_NONE = 0, TAIL_SUM, TAIL_MIN, TAIL_MAX, TAIL_ARGMIN,
            TAIL_ARGMAX };

struct Stages {
  int n;
  int op[kMaxStages];
  float imm[kMaxStages];
  const float* y[kMaxStages];   // row-major (rows, n) operand, or null
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
__global__ void __launch_bounds__(kThreads)
stream_kernel(const float* __restrict__ x, float* __restrict__ out,
              int n, int n_valid, Stages st, void* red, int red_int) {
  const int row = blockIdx.x;
  const size_t base = (size_t)row * n;
  float acc = identity<TAIL>();
  int idx = 0;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    float v = x ? x[base + c] : 0.0f;
#pragma unroll 1
    for (int s = 0; s < st.n; ++s) {
      const float y = st.y[s] ? st.y[s][base + c] : 0.0f;
      v = apply_op(st.op[s], v, y, st.imm[s]);
    }
    if (out) out[base + c] = v;
    if (TAIL != TAIL_NONE && c < n_valid) {
      if (TAIL == TAIL_SUM) acc += v;
      else if (TAIL == TAIL_MIN) acc = fminf(acc, v);
      else if (TAIL == TAIL_MAX) acc = fmaxf(acc, v);
      else if (TAIL == TAIL_ARGMAX) { if (v > acc) { acc = v; idx = c; } }
      else { if (v < acc) { acc = v; idx = c; } }
    }
  }
  if (TAIL == TAIL_NONE) return;

  // block reduction: warp shuffles, then one value per warp in shared
  __shared__ float sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, acc, off);
    int oi = __shfl_down_sync(0xffffffffu, idx, off);
    if (TAIL == TAIL_SUM) acc += ov;
    else if (TAIL == TAIL_MIN) acc = fminf(acc, ov);
    else if (TAIL == TAIL_MAX) acc = fmaxf(acc, ov);
    else merge_arg<TAIL>(acc, idx, ov, oi);
  }
  if (lane == 0) { sv[warp] = acc; si[warp] = idx; }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    acc = lane < nw ? sv[lane] : identity<TAIL>();
    idx = lane < nw ? si[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      float ov = __shfl_down_sync(0xffffffffu, acc, off);
      int oi = __shfl_down_sync(0xffffffffu, idx, off);
      if (TAIL == TAIL_SUM) acc += ov;
      else if (TAIL == TAIL_MIN) acc = fminf(acc, ov);
      else if (TAIL == TAIL_MAX) acc = fmaxf(acc, ov);
      else merge_arg<TAIL>(acc, idx, ov, oi);
    }
    if (lane == 0) {
      const bool arg = (TAIL == TAIL_ARGMIN || TAIL == TAIL_ARGMAX);
      if (arg && red_int) static_cast<int*>(red)[row] = idx;
      else static_cast<float*>(red)[row] = arg ? (float)idx : acc;
    }
  }
}

}  // namespace

extern "C" {

const char* ntx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x/out/ys: contiguous (rows, n) fp32 on the device; out may be null
// (a reduction alone). ops/imms/ys: host arrays of n_stages entries.
// tail: 0 none, 1 sum, 2 min, 3 max, 4 argmin, 5 argmax; red holds one
// result per row, int32 when red_int and the tail is an arg tail, else
// fp32.
int ntx_stream(const void* x, void* out, int rows, int n, int n_valid,
               int n_stages, const int* ops, const float* imms,
               const void* const* ys, int tail, void* red, int red_int,
               void* stream) {
  if (n_stages < 0 || n_stages > kMaxStages || rows < 0 || n < 0 ||
      tail < 0 || tail > TAIL_ARGMAX)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  Stages st;
  st.n = n_stages;
  for (int s = 0; s < kMaxStages; ++s) {
    st.op[s] = s < n_stages ? ops[s] : OP_COPY;
    st.imm[s] = s < n_stages ? imms[s] : 0.0f;
    st.y[s] = s < n_stages ? static_cast<const float*>(ys[s]) : nullptr;
  }
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(rows), block(kThreads);
  switch (tail) {
    case TAIL_NONE:
      stream_kernel<TAIL_NONE><<<grid, block, 0, s>>>(xp, op, n, n_valid, st,
                                                      red, red_int);
      break;
    case TAIL_SUM:
      stream_kernel<TAIL_SUM><<<grid, block, 0, s>>>(xp, op, n, n_valid, st,
                                                     red, red_int);
      break;
    case TAIL_MIN:
      stream_kernel<TAIL_MIN><<<grid, block, 0, s>>>(xp, op, n, n_valid, st,
                                                     red, red_int);
      break;
    case TAIL_MAX:
      stream_kernel<TAIL_MAX><<<grid, block, 0, s>>>(xp, op, n, n_valid, st,
                                                     red, red_int);
      break;
    case TAIL_ARGMIN:
      stream_kernel<TAIL_ARGMIN><<<grid, block, 0, s>>>(xp, op, n, n_valid,
                                                        st, red, red_int);
      break;
    default:
      stream_kernel<TAIL_ARGMAX><<<grid, block, 0, s>>>(xp, op, n, n_valid,
                                                        st, red, red_int);
      break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
