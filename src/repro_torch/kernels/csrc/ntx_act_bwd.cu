// The MLP activation's backward on Hopper: one streaming pass over
// (dh, a1, gate) in fp32 that writes da1, dgate and the hidden h in the
// compute dtype.
//
// It has no TPU counterpart: the reference differentiates its fused MLP's
// store epilogues (the act of ntx_gemm.py:apply_epilogue) with XLA. This
// kernel is that derivative for ops.fused_mlp's backward:
//   SwiGLU: h = silu(a1) gate, da1 = dh gate silu'(a1), dgate = dh silu(a1)
//           with sig = 1 / (1 + exp(-a1)), silu = a1 sig and silu' =
//           sig (1 + a1 (1 - sig)), silu as the GEMM epilogue computes it,
//           so h has the forward's bits;
//   GELU (tanh form, jax.nn.gelu's default; never erf): h = 0.5 a1 (1 + t),
//           t = tanh(k0 (a1 + c a1^3)), da1 = dh (0.5 (1 + t) + 0.5 a1 (1 -
//           t^2) k0 (1 + 3 c a1^2)), k0 = sqrt(2 / pi), c = 0.044715.
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn, no FMA contraction), in the order of the plain
// version (kernels/ntx_elementwise.py:act_bwd_plain), so the two are
// bit-equal on the card.
//
// Bound on the H100: bytes. Per element it reads 12 bytes (8 for GELU)
// and writes 3 (2) outputs of the compute dtype: at 8192 x 14336 in bf16,
// 2.11 GB, 0.63 ms at 3.35 TB/s. Design: a grid-stride loop over 4
// elements a thread with 16-byte loads (scalar where the length or a
// pointer is off 16 bytes), a block per 1024 elements up to 16 blocks an
// SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kK0 = 0.7978845608028654f;   // sqrt(2 / pi)
constexpr float kC = 0.044715f;
constexpr float kC3 = 0.134145f;             // 3 c

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// Four elements at p (16-byte aligned for fp32, 8-byte for bf16).
__device__ __forceinline__ void put4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void put4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// One element: da1, dgate (SwiGLU) and h from dh, a1 and gate.
template <bool SWIGLU>
__device__ __forceinline__ void element(float dh, float a, float gate,
                                        float& da1, float& dgate, float& h) {
  if (SWIGLU) {
    const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-a)));
    const float silu = __fmul_rn(a, sig);
    h = __fmul_rn(silu, gate);
    dgate = __fmul_rn(dh, silu);
    const float dsilu =
        __fmul_rn(sig, __fadd_rn(1.0f, __fmul_rn(a, __fsub_rn(1.0f, sig))));
    da1 = __fmul_rn(__fmul_rn(dh, gate), dsilu);
  } else {
    const float x2 = __fmul_rn(a, a);
    const float z = __fadd_rn(a, __fmul_rn(kC, __fmul_rn(x2, a)));
    const float t = tanhf(__fmul_rn(kK0, z));
    const float onept = __fadd_rn(1.0f, t);
    const float half_a = __fmul_rn(0.5f, a);
    h = __fmul_rn(half_a, onept);
    const float sech2 = __fsub_rn(1.0f, __fmul_rn(t, t));
    const float dinner = __fmul_rn(kK0, __fadd_rn(1.0f, __fmul_rn(kC3, x2)));
    const float dg = __fadd_rn(__fmul_rn(0.5f, onept),
                               __fmul_rn(__fmul_rn(half_a, sech2), dinner));
    da1 = __fmul_rn(dh, dg);
    dgate = 0.0f;
  }
}

template <typename T, bool SWIGLU, bool VEC>
__global__ void __launch_bounds__(kThreads)
act_bwd(const float* __restrict__ dh, const float* __restrict__ a1,
        const float* __restrict__ gate, T* __restrict__ da1,
        T* __restrict__ dgate, T* __restrict__ h, long long n) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long start = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (VEC) {
    const long long n4 = n / 4;
    for (long long i = start; i < n4; i += stride) {
      const float4 d4 = reinterpret_cast<const float4*>(dh)[i];
      const float4 x4 = reinterpret_cast<const float4*>(a1)[i];
      const float4 g4 = SWIGLU ? reinterpret_cast<const float4*>(gate)[i]
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
      float o1[4], o2[4], o3[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        element<SWIGLU>(dv[e], xv[e], gv[e], o1[e], o2[e], o3[e]);
      put4(da1 + 4 * i, o1);
      if (SWIGLU) put4(dgate + 4 * i, o2);
      put4(h + 4 * i, o3);
    }
    return;
  }
  for (long long i = start; i < n; i += stride) {
    float o1, o2, o3;
    element<SWIGLU>(dh[i], a1[i], SWIGLU ? gate[i] : 0.0f, o1, o2, o3);
    put(da1 + i, o1);
    if (SWIGLU) put(dgate + i, o2);
    put(h + i, o3);
  }
}

template <typename T, bool SWIGLU>
cudaError_t launch(const float* dh, const float* a1, const float* gate,
                   void* da1, void* dgate, void* h, long long n, bool vec,
                   cudaStream_t s) {
  const long long per = vec ? 4 * kThreads : kThreads;
  const long long need = (n + per - 1) / per;
  const int blocks = (int)(need < 132 * 16 ? need : 132 * 16);
  if (vec)
    act_bwd<T, SWIGLU, true><<<blocks, kThreads, 0, s>>>(
        dh, a1, gate, static_cast<T*>(da1), static_cast<T*>(dgate),
        static_cast<T*>(h), n);
  else
    act_bwd<T, SWIGLU, false><<<blocks, kThreads, 0, s>>>(
        dh, a1, gate, static_cast<T*>(da1), static_cast<T*>(dgate),
        static_cast<T*>(h), n);
  return cudaGetLastError();
}

bool al16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// dh, a1 and (act 0, SwiGLU) gate: n contiguous fp32 on the device; da1,
// (SwiGLU) dgate and h: n contiguous outputs, bf16 when out_bf16, else
// fp32. act: 0 SwiGLU, 1 GELU (tanh form; gate and dgate unused).
int ntx_act_bwd(const float* dh, const float* a1, const float* gate,
                void* da1, void* dgate, void* h, long long n, int act,
                int out_bf16, void* stream) {
  if (n < 0 || (act != 0 && act != 1) ||
      (act == 0 && (gate == nullptr || dgate == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && al16(dh) && al16(a1) && al16(gate) &&
                   al16(da1) && al16(dgate) && al16(h);
  if (act == 0)
    return (int)(out_bf16 ? launch<__nv_bfloat16, true>(dh, a1, gate, da1,
                                                        dgate, h, n, vec, s)
                          : launch<float, true>(dh, a1, gate, da1, dgate, h,
                                                n, vec, s));
  return (int)(out_bf16 ? launch<__nv_bfloat16, false>(dh, a1, gate, da1,
                                                       dgate, h, n, vec, s)
                        : launch<float, false>(dh, a1, gate, da1, dgate, h,
                                               n, vec, s));
}

}  // extern "C"
