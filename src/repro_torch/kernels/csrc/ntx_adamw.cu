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
// Design: every byte is touched once, so the kernel streams. The body
// moves 16 bytes per load and store (float4 for g, m, v and an fp32 p;
// 8 bytes of four bf16 for a bf16 p), kUnroll vectors in flight per
// thread, with the streaming cache hints (__ldcs / __stcs: evict first).
// The grid comes from the card's SM count, queried once per device by the
// wrapper, and strides over the vectors. The part of a tensor before its
// first 16-byte boundary (the head) and after its last whole vector (the
// tail) goes element by element; the wrapper's plan (ntx_elementwise.
// adamw_plan) fixes head, vectors and blocks once per call, and operands
// whose alignments disagree take the element route throughout. Both
// routes compute one element with the same function: every product and
// sum is rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn) in the plain version's order, so the compiler cannot
// contract them into FMAs, the kernel computes what adamw_plain computes,
// and the two routes give the same bits. p is fp32 or bf16 (its own dtype
// in and out); g, m and v are fp32. Outputs may alias the inputs: a
// thread reads its elements before it writes them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // 16-byte vectors in flight per thread

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2;
};

__device__ __forceinline__ void step(const Hyper& k, float pi, float gi,
                                     float m, float v, float& po, float& mo,
                                     float& vo) {
  const float mi = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.omb1, gi));
  const float vi = __fadd_rn(__fmul_rn(k.b2, v),
                             __fmul_rn(__fmul_rn(k.omb2, gi), gi));
  const float mhat = __fmul_rn(mi, k.bc1);
  const float vhat = __fmul_rn(vi, k.bc2);
  const float upd =
      __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), k.eps)),
                __fmul_rn(k.wd, pi));
  po = __fsub_rn(pi, __fmul_rn(k.lr, upd));
  mo = mi;
  vo = vi;
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Four consecutive elements of p as one vector: 16 bytes of fp32 or 8 of
// bf16, loaded and stored with the streaming hints.
template <typename P>
struct Quad;

template <>
struct Quad<float> {
  typedef float4 V;
  static __device__ __forceinline__ V load(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void unpack(const V& v, float o[4]) {
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float o[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(o[0], o[1], o[2], o[3]));
  }
};

template <>
struct Quad<__nv_bfloat16> {
  typedef uint2 V;
  static __device__ __forceinline__ V load(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ void unpack(const V& v, float o[4]) {
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    o[0] = lo.x;
    o[1] = lo.y;
    o[2] = hi.x;
    o[3] = hi.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float o[4]) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
    uint2 v;
    v.x = *reinterpret_cast<const uint32_t*>(&lo);
    v.y = *reinterpret_cast<const uint32_t*>(&hi);
    __stcs(reinterpret_cast<uint2*>(p), v);
  }
};

__device__ __forceinline__ void to4(const float4& v, float o[4]) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

// Elements [0, head) and [head + 4 vecs, n) one at a time; the vectors of
// [head, head + 4 vecs) kUnroll at a time per thread.
template <typename P>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const P* p, const float* g, const float* m, const float* v,
             P* po, float* mo, float* vo, long long n, long long head,
             long long vecs, Hyper k) {
  const long long threads = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long body_end = head + 4 * vecs;
  const long long singles = head + (n - body_end);
  for (long long i = tid; i < singles; i += threads) {
    const long long e = i < head ? i : body_end + (i - head);
    float pn, mn, vn;
    step(k, load1(p + e), g[e], m[e], v[e], pn, mn, vn);
    store1(po + e, pn);
    mo[e] = mn;
    vo[e] = vn;
  }
  const float4* g4 = reinterpret_cast<const float4*>(g + head);
  const float4* m4 = reinterpret_cast<const float4*>(m + head);
  const float4* v4 = reinterpret_cast<const float4*>(v + head);
  float4* mo4 = reinterpret_cast<float4*>(mo + head);
  float4* vo4 = reinterpret_cast<float4*>(vo + head);
  const P* pb = p + head;
  P* pob = po + head;
  for (long long i0 = (long long)blockIdx.x * kThreads * kUnroll +
                      threadIdx.x;
       i0 < vecs; i0 += threads * kUnroll) {
    float4 gv[kUnroll], mv[kUnroll], vv[kUnroll];
    typename Quad<P>::V pv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + (long long)u * kThreads;
      if (i < vecs) {
        gv[u] = __ldcs(g4 + i);
        mv[u] = __ldcs(m4 + i);
        vv[u] = __ldcs(v4 + i);
        pv[u] = Quad<P>::load(pb + 4 * i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + (long long)u * kThreads;
      if (i < vecs) {
        float pf[4], gf[4], mf[4], vf[4], pn[4], mn[4], vn[4];
        Quad<P>::unpack(pv[u], pf);
        to4(gv[u], gf);
        to4(mv[u], mf);
        to4(vv[u], vf);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          step(k, pf[e], gf[e], mf[e], vf[e], pn[e], mn[e], vn[e]);
        Quad<P>::store(pob + 4 * i, pn);
        __stcs(mo4 + i, make_float4(mn[0], mn[1], mn[2], mn[3]));
        __stcs(vo4 + i, make_float4(vn[0], vn[1], vn[2], vn[3]));
      }
    }
  }
}

bool aligned(const void* ptr, long long offset_bytes, int to) {
  return ((reinterpret_cast<uintptr_t>(ptr) + offset_bytes) % to) == 0;
}

template <typename P>
int launch(const void* p, const void* g, const void* m, const void* v,
           void* po, void* mo, void* vo, long long n, long long head,
           long long vecs, int blocks, const Hyper& k, cudaStream_t s) {
  if (vecs > 0) {   // the body's vectors start on their natural boundary
    const long long f = 4 * head, pe = (long long)sizeof(P) * head;
    const int pv = 4 * (int)sizeof(P);
    if (!aligned(g, f, 16) || !aligned(m, f, 16) || !aligned(v, f, 16) ||
        !aligned(mo, f, 16) || !aligned(vo, f, 16) || !aligned(p, pe, pv) ||
        !aligned(po, pe, pv))
      return (int)cudaErrorMisalignedAddress;
  }
  adamw_kernel<P><<<blocks, kThreads, 0, s>>>(
      static_cast<const P*>(p), static_cast<const float*>(g),
      static_cast<const float*>(m), static_cast<const float*>(v),
      static_cast<P*>(po), static_cast<float*>(mo), static_cast<float*>(vo),
      n, head, vecs, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// p/po (n,) fp32 (p_bf16 = 0) or bf16; g, m, v, mo, vo (n,) fp32; all
// contiguous on the device. hyper: the host's (lr, b1, 1 - b1, b2,
// 1 - b2, eps, wd, bc1, bc2). The plan: elements [0, head) and
// [head + 4 vecs, n) one at a time, the vecs vectors between them 16
// bytes at a time (each operand must be aligned there), on `blocks`
// blocks of 256 threads.
int ntx_adamw(const void* p, const void* g, const void* m, const void* v,
              void* po, void* mo, void* vo, long long n, const float* hyper,
              int p_bf16, long long head, long long vecs, int blocks,
              void* stream) {
  if (n < 0 || head < 0 || vecs < 0 || head + 4 * vecs > n || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Hyper k = {hyper[0], hyper[1], hyper[2], hyper[3], hyper[4],
                   hyper[5], hyper[6], hyper[7], hyper[8]};
  if (p_bf16)
    return launch<__nv_bfloat16>(p, g, m, v, po, mo, vo, n, head, vecs,
                                 blocks, k, s);
  return launch<float>(p, g, m, v, po, mo, vo, n, head, vecs, blocks, k, s);
}

}  // extern "C"
