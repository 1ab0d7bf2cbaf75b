// Fused AdamW step on Hopper: one elementwise pass over p, g, m and v.
//
// Replaces the TPU kernel repro/kernels/ntx_elementwise.py:adamw_pallas
// (_adamw_kernel): the NTX streaming bundle of an optimizer update,
//   m <- b1 m + (1 - b1) g
//   v <- b2 v + (1 - b2) g g
//   p <- p - lr (m * bc1 / (sqrt(v * bc2) + eps) + wd p)
// with the bias corrections bc1 = 1 / (1 - b1^t), bc2 = 1 / (1 - b2^t)
// passed as reciprocals and multiplied in, as the reference kernel does.
// lr, b1, b2, eps, wd and the corrections are launch arguments, so no
// constant is captured by the kernel (the reference closes over lr, which
// fails when lr is a traced scalar). 1 - b1 and 1 - b2 arrive rounded
// from the host's double, as the reference's weakly typed Python floats
// round them.
//
// Bound on the H100: bytes. 28 bytes per element for an fp32 p (read
// p, g, m, v; write p, m, v) against ~15 flops; the full mamba2-1.3b
// state is 1.45 G elements, ~40 GB, ~12 ms at 3.35 TB/s.
//
// Design: a grid-stride loop, one element per thread per step, loads
// and stores coalesced. Every product and sum is rounded on its own
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), in the plain version's
// order, so the compiler cannot contract them into FMAs and the kernel
// computes what adamw_plain computes. p is fp32 or bf16 (its own dtype
// in and out); g, m and v are fp32. Outputs may alias the inputs: each
// thread reads an element before it writes it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const P* p, const float* g, const float* m, const float* v,
             P* po, float* mo, float* vo, long long n, float lr, float b1,
             float omb1, float b2, float omb2, float eps, float wd,
             float bc1, float bc2) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float gi = g[i];
    const float mi = __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(omb1, gi));
    const float vi = __fadd_rn(__fmul_rn(b2, v[i]),
                               __fmul_rn(__fmul_rn(omb2, gi), gi));
    const float mhat = __fmul_rn(mi, bc1);
    const float vhat = __fmul_rn(vi, bc2);
    const float pi = load(p + i);
    const float upd = __fadd_rn(
        __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), eps)), __fmul_rn(wd, pi));
    store(po + i, __fsub_rn(pi, __fmul_rn(lr, upd)));
    mo[i] = mi;
    vo[i] = vi;
  }
}

template <typename P>
int launch(const void* p, const void* g, const void* m, const void* v,
           void* po, void* mo, void* vo, long long n, float lr, float b1,
           float omb1, float b2, float omb2, float eps, float wd, float bc1,
           float bc2, cudaStream_t s) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;   // 64 blocks per SM
  adamw_kernel<P><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const P*>(p), static_cast<const float*>(g),
      static_cast<const float*>(m), static_cast<const float*>(v),
      static_cast<P*>(po), static_cast<float*>(mo), static_cast<float*>(vo),
      n, lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// p/po (n,) fp32 (p_bf16 = 0) or bf16; g, m, v, mo, vo (n,) fp32; all
// contiguous on the device.
int ntx_adamw(const void* p, const void* g, const void* m, const void* v,
              void* po, void* mo, void* vo, long long n, float lr, float b1,
              float omb1, float b2, float omb2, float eps, float wd,
              float bc1, float bc2, int p_bf16, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_bf16)
    return launch<__nv_bfloat16>(p, g, m, v, po, mo, vo, n, lr, b1, omb1, b2,
                                 omb2, eps, wd, bc1, bc2, s);
  return launch<float>(p, g, m, v, po, mo, vo, n, lr, b1, omb1, b2, omb2,
                       eps, wd, bc1, bc2, s);
}

}  // extern "C"
