// Decode attention over a GQA cache whose head_dim is split across the
// model ranks (``cache_shard="latent"``): each rank holds a block of db
// of every kv head's hd columns, so no rank can contract q.k alone. Two
// kernels, with the sum over the ranks (an all-reduce of the logits)
// between them, in PyTorch:
//
//   split_logits (kernel A): the partial fp32 logits over the rank's
//     head_dim block, logits[b, h, i, t] = sum_d q[b, h, i, d] k[b, h / g,
//     t, d] for t < kv_len, unscaled. A block takes one (batch, kv head)
//     group and 1024 keys: the group's g s query rows sit in shared memory
//     and each thread reads its 4 keys' rows once (one 16-byte load each
//     at db 8 in bf16, all in flight together) for every row of the
//     group, so K is never expanded to hq heads. Bound: bytes (k read, the
//     logits written: at llama3-8b's decode_32k rank shape on 16x16, b 8,
//     hq 32, hkv 8, kv_len 32768, db 8, 33.5 MB each way, 0.020 ms at
//     3.35 TB/s).
//   split_pv (kernel B): the NTX MAX+MAC streaming reduction over the
//     summed logits, the softmax's running max, the sum of its
//     exponentials and the fp32 sum of p v over the rank's block of v;
//     query row i sees keys <= q_pos + i when causal, masked with -1e30
//     as the flash kernel masks (a row with no key left is the mean of
//     every value, as the reference's softmax gives), l == 0 taken as 1;
//     o written in v's dtype. A block takes one (batch, kv head) group's
//     rows (4, 8 or 16 of them) over a range of keys, so each v row is
//     read once; each thread streams its keys a few at a time (their
//     logits and v rows loaded together, one running max, sum and
//     accumulator a row in registers), and the threads' partials are
//     combined by their maxima at the end. Where the groups leave SMs
//     idle the keys are split, each split's (m, l, acc) written to a
//     workspace laid out as the flash kernel's, and the wrapper launches
//     csrc/flash_attention.cu's flash_merge on it. Bound: bytes (the
//     logits and v read, o written; 67 MB at the shape above).
//
// Neither replaces a TPU kernel: the reference partitions its decode
// step's einsums with XLA under jit (repro.launch.dryrun's serve_step) and
// has no Pallas kernel for a split head_dim. The flash kernel cannot take
// this layout: its softmax needs the logits summed over the ranks first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsA = 8;           // logits rows of one pass of kernel A
constexpr int kKeysA = 4;           // keys a thread of kernel A
constexpr int kChunk = 512;         // a split of kernel B: a multiple
constexpr int kMaxSplits = 64;      // flash_merge's limit
constexpr float kMasked = -1e30f;   // a causally masked logit (base 2)
constexpr int kSmemA = 48 * 1024;   // kernel A's rows, without opting in

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// N (4 or 8) consecutive elements at p as floats (p aligned to min(16,
// N * size) bytes).
template <int N>
__device__ __forceinline__ void load(const float* p, float (&x)[N]) {
  static_assert(N == 4 || N == 8, "4 or 8 elements a load");
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 u = *reinterpret_cast<const float4*>(p + i);
    x[i] = u.x;
    x[i + 1] = u.y;
    x[i + 2] = u.z;
    x[i + 3] = u.w;
  }
}
template <int N>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&x)[N]) {
  static_assert(N == 4 || N == 8, "4 or 8 elements a load");
  if constexpr (N == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
}

struct LogitsArgs {
  long long qsb, qsh, qss;          // q strides (batch, head, query)
  long long ksb, ksh, kst;          // k strides (batch, head, key)
  int b, hq, hkv, s, kv_len, db;
};

// Kernel A. Grid (key tiles of kThreads kKeysA, b hkv); dynamic shared
// memory: the group's g s rows of q in fp32. Row r of the group is head
// j g + r / s, query r % s; its logits row is contiguous in out (b, hq, s,
// kv_len). A thread takes kKeysA keys kThreads apart (its loads in flight
// together, neighbouring threads on neighbouring keys).
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
split_logits(const T* __restrict__ q, const T* __restrict__ k,
             float* __restrict__ out, LogitsArgs a) {
  extern __shared__ float qs[];
  const int g = a.hq / a.hkv;
  const int rows = g * a.s;
  const int bi = blockIdx.y / a.hkv, j = blockIdx.y % a.hkv;
  for (int e = threadIdx.x; e < rows * a.db; e += kThreads) {
    const int r = e / a.db, d = e % a.db;
    qs[e] = to_f(q[bi * a.qsb + (j * g + r / a.s) * a.qsh +
                   (r % a.s) * a.qss + d]);
  }
  __syncthreads();
  const int t0 = blockIdx.x * kThreads * kKeysA + threadIdx.x;
  const T* kb = k + bi * a.ksb + j * a.ksh;
  float* ob = out + ((long long)bi * a.hq + j * g) * a.s * a.kv_len;
  for (int r0 = 0; r0 < rows; r0 += kRowsA) {
    float acc[kKeysA][kRowsA];
#pragma unroll
    for (int u = 0; u < kKeysA; ++u)
#pragma unroll
      for (int r = 0; r < kRowsA; ++r) acc[u][r] = 0.0f;
    for (int d0 = 0; d0 < a.db; d0 += N) {
      float x[kKeysA][N];
#pragma unroll
      for (int u = 0; u < kKeysA; ++u)      // clamped: every load at once
        load<N>(kb + (long long)min(t0 + u * kThreads, a.kv_len - 1) *
                         a.kst + d0, x[u]);
#pragma unroll
      for (int r = 0; r < kRowsA; ++r) {
        if (r0 + r < rows) {
          const float* qr = qs + (r0 + r) * a.db + d0;
#pragma unroll
          for (int e = 0; e < N; ++e) {
            const float qv = qr[e];
#pragma unroll
            for (int u = 0; u < kKeysA; ++u)
              acc[u][r] = fmaf(qv, x[u][e], acc[u][r]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kKeysA; ++u) {
      const int t = t0 + u * kThreads;
      if (t < a.kv_len) {
#pragma unroll
        for (int r = 0; r < kRowsA; ++r)
          if (r0 + r < rows) ob[(long long)(r0 + r) * a.kv_len + t] = acc[u][r];
      }
    }
  }
}

struct PvArgs {
  long long vsb, vsh, vst;          // v strides (batch, head, key)
  int b, hq, hkv, s, kv_len, db;
  int dc;          // threads a key: db / N rounded up to a power of 2
  int row_groups;  // blocks of RB rows a group
  int chunk;       // keys a split, a multiple of kChunk
  int q_pos, causal;
  float scale2;    // the softmax scale times log2(e)
};

// Kernel B. Grid (splits, b hkv row_groups). Thread (kp, dc) =
// (threadIdx.x / a.dc, threadIdx.x % a.dc) takes columns [dc N, dc N + N)
// of keys kp, kp + kThreads / a.dc, ... of the split's range, U at a time
// (their logits and v rows loaded together), keeping for each row its
// running max m (base 2), sum l and accumulator; the threads' partials are
// then combined by their maxima: across a warp's lanes by shuffles, then
// the warps in order through shared memory (no atomics: the same bits on
// every run). One split writes o; several write (m, l, acc) to ws as
// the flash kernel's splits do, for flash_merge.
template <typename T, int N, int RB>
__global__ void __launch_bounds__(kThreads)
split_pv(const float* __restrict__ logits, const T* __restrict__ v,
         T* __restrict__ o, float* __restrict__ ws, PvArgs a) {
  constexpr int U = RB * N >= 128 ? 1 : (RB * N >= 64 ? 2 : 4);
  __shared__ float red[RB * 32 * 8];          // (rows, dc N) accumulators
  __shared__ float red_m[kWarps][RB], red_l[RB], sm_m[RB];
  const int g = a.hq / a.hkv;
  const int grp = blockIdx.y / a.row_groups;
  const int r_lo = (blockIdx.y % a.row_groups) * RB;
  const int rows = min(RB, g * a.s - r_lo);
  const int bi = grp / a.hkv, j = grp % a.hkv;
  const long long row0 = ((long long)bi * a.hq + j * g) * a.s + r_lo;
  const int z = blockIdx.x;
  const int k0 = z * a.chunk, k1 = min(a.kv_len, k0 + a.chunk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kp = threadIdx.x / a.dc, kstep = kThreads / a.dc;
  const int col = (threadIdx.x % a.dc) * N;
  const bool has_col = col < a.db;
  const T* vc = v + bi * a.vsb + j * a.vsh + (has_col ? col : 0);
  const float* lg = logits + row0 * a.kv_len;
  int qmax[RB];                               // each row's last key
#pragma unroll
  for (int r = 0; r < RB; ++r)
    qmax[r] = a.causal ? a.q_pos + (r_lo + r) % a.s : a.kv_len;
  float m[RB], l[RB], acc[RB][N];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < N; ++e) acc[r][e] = 0.0f;
  }

  for (int t0 = k0 + kp; t0 < k1; t0 += kstep * U) {
    // every load first, at addresses clamped into the tensors (a warp
    // issues in order: a load used at once would stall it each time),
    // then the values past the range or the rows dropped
    float x[U][RB], vv[U][N];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = min(t0 + u * kstep, k1 - 1);
#pragma unroll
      for (int r = 0; r < RB; ++r)
        x[u][r] = lg[min(r, rows - 1) * a.kv_len + t];
      load<N>(vc + (long long)t * a.vst, vv[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * kstep;
#pragma unroll
      for (int r = 0; r < RB; ++r)
        x[u][r] = t >= k1 || r >= rows ? -INFINITY   // weight 0
                  : t > qmax[r] ? kMasked : x[u][r] * a.scale2;
      if (t >= k1 || !has_col) {
#pragma unroll
        for (int e = 0; e < N; ++e) vv[u][e] = 0.0f;
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < rows) {
        float mb = x[0][r];                   // key t0 is in the range
#pragma unroll
        for (int u = 1; u < U; ++u) mb = fmaxf(mb, x[u][r]);
        const float m_new = fmaxf(m[r], mb);
        const float al = exp2f(m[r] - m_new);   // 0 while m is -inf
        l[r] *= al;
#pragma unroll
        for (int e = 0; e < N; ++e) acc[r][e] *= al;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = exp2f(x[u][r] - m_new);
          l[r] += p;
#pragma unroll
          for (int e = 0; e < N; ++e) acc[r][e] = fmaf(p, vv[u][e], acc[r][e]);
        }
        m[r] = m_new;
      }
    }
  }

  // lanes of one column chunk (other keys) combined by their maxima
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    for (int off = 16; off >= a.dc; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mn = fmaxf(m[r], mo);
      const float fs = mn == -INFINITY ? 0.0f : exp2f(m[r] - mn);
      const float fo = mn == -INFINITY ? 0.0f : exp2f(mo - mn);
      l[r] = l[r] * fs + lo * fo;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        acc[r][e] = acc[r][e] * fs + ao * fo;
      }
      m[r] = mn;
    }
  }
  // then the warps, scaled to the block's maxima, in warp order
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RB; ++r) red_m[warp][r] = m[r];
  }
  __syncthreads();
  if (threadIdx.x < RB) {
    float mm = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, red_m[w][threadIdx.x]);
    sm_m[threadIdx.x] = mm;
  }
  __syncthreads();
  const int width = a.dc * N;
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w && lane < a.dc) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < rows) {
          const float f = m[r] == -INFINITY ? 0.0f : exp2f(m[r] - sm_m[r]);
          if (lane == 0) red_l[r] = (w == 0 ? 0.0f : red_l[r]) + l[r] * f;
#pragma unroll
          for (int e = 0; e < N; ++e) {
            float* dst = red + r * width + lane * N + e;
            *dst = (w == 0 ? 0.0f : *dst) + acc[r][e] * f;
          }
        }
      }
    }
    __syncthreads();
  }
  const int splits = gridDim.x;
  const long long rows_total = (long long)a.b * a.hq * a.s;
  for (int e = threadIdx.x; e < rows * a.db; e += kThreads) {
    const int r = e / a.db, d = e % a.db;
    const float val = red[r * width + d];
    const long long gr = row0 + r;
    if (splits == 1) {
      const float lsum = red_l[r];
      put(o + gr * a.db + d, val / (lsum == 0.0f ? 1.0f : lsum));
    } else {
      const long long zr = (long long)z * rows_total + gr;
      ws[2 * splits * rows_total + zr * a.db + d] = val;
      if (d == 0) {
        ws[2 * zr] = sm_m[r];
        ws[2 * zr + 1] = red_l[r];
      }
    }
  }
}

template <typename T, int N>
cudaError_t logits_launch(const void* q, const void* k, float* out,
                          const LogitsArgs& a, cudaStream_t s) {
  const int rows = a.hq / a.hkv * a.s;
  const size_t smem = (size_t)rows * a.db * sizeof(float);
  dim3 grid((a.kv_len + kThreads * kKeysA - 1) / (kThreads * kKeysA),
            a.b * a.hkv);
  split_logits<T, N><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), out, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t logits_typed(const void* q, const void* k, float* out,
                         const LogitsArgs& a, int n, cudaStream_t s) {
  switch (n) {
    case 8: return logits_launch<T, 8>(q, k, out, a, s);
    default: return logits_launch<T, 4>(q, k, out, a, s);
  }
}

template <typename T, int N, int RB>
cudaError_t pv_launch(const float* logits, const void* v, void* o,
                      float* ws, const PvArgs& a, int splits,
                      cudaStream_t s) {
  dim3 grid(splits, a.b * a.hkv * a.row_groups);
  split_pv<T, N, RB><<<grid, kThreads, 0, s>>>(
      logits, static_cast<const T*>(v), static_cast<T*>(o), ws, a);
  return cudaGetLastError();
}

template <typename T, int RB>
cudaError_t pv_rows(const float* logits, const void* v, void* o, float* ws,
                    const PvArgs& a, int n, int splits, cudaStream_t s) {
  switch (n) {
    case 8: return pv_launch<T, 8, RB>(logits, v, o, ws, a, splits, s);
    default: return pv_launch<T, 4, RB>(logits, v, o, ws, a, splits, s);
  }
}

template <typename T>
cudaError_t pv_typed(const float* logits, const void* v, void* o, float* ws,
                     const PvArgs& a, int n, int rb, int splits,
                     cudaStream_t s) {
  if (rb == 4) return pv_rows<T, 4>(logits, v, o, ws, a, n, splits, s);
  if (rb == 8) return pv_rows<T, 8>(logits, v, o, ws, a, n, splits, s);
  return pv_rows<T, 16>(logits, v, o, ws, a, n, splits, s);
}

bool vec_ok(int n) { return n == 4 || n == 8; }

}  // namespace

extern "C" {

// q (b, hq, s, db), k (b, hkv, S >= kv_len, db), both fp32 or both bf16
// (bf16 != 0), d contiguous, strides p[0:6] = q's (b, h, s), k's (b, h,
// t); out (b, hq, s, kv_len) contiguous fp32. p: (q strides, k strides,
// b, hq, hkv, s, kv_len, db, bf16, n): k read n (4 or 8) elements at a
// time (db, its base and row strides aligned to that).
int ntx_attn_split_logits(const void* q, const void* k, float* out,
                          const long long* p, void* stream) {
  LogitsArgs a{p[0], p[1], p[2], p[3], p[4], p[5], (int)p[6], (int)p[7],
               (int)p[8], (int)p[9], (int)p[10], (int)p[11]};
  const int bf16 = (int)p[12], n = (int)p[13];
  if (a.b < 0 || a.hq <= 0 || a.hkv <= 0 || a.hq % a.hkv || a.s <= 0 ||
      a.kv_len <= 0 || a.db <= 0 || !vec_ok(n) || a.db % n ||
      a.b * a.hkv > 65535 ||
      (size_t)(a.hq / a.hkv) * a.s * a.db * sizeof(float) > kSmemA)
    return (int)cudaErrorInvalidValue;
  if (a.b == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? logits_typed<__nv_bfloat16>(q, k, out, a, n, s)
                    : logits_typed<float>(q, k, out, a, n, s));
}

// logits (b, hq, s, kv_len) contiguous fp32 (summed over the ranks), v
// (b, hkv, S >= kv_len, db) fp32 or bf16 with d contiguous, o (b, hq, s,
// db) contiguous in v's dtype, ws (splits > 1): splits (b hq s) (db + 2)
// fp32, left for flash_merge (o is then not written). p: (v strides (b,
// h, t), b, hq, hkv, s, kv_len, db, dc, row_groups, chunk, q_pos, causal,
// bf16, n, rb, splits): v read n (4 or 8) elements at a time.
int ntx_attn_split_pv(const float* logits, const void* v, void* o,
                      float* ws, const long long* p, float scale2,
                      void* stream) {
  PvArgs a{p[0], p[1], p[2], (int)p[3], (int)p[4], (int)p[5], (int)p[6],
           (int)p[7], (int)p[8], (int)p[9], (int)p[10], (int)p[11],
           (int)p[12], (int)p[13], scale2};
  const int bf16 = (int)p[14], n = (int)p[15], rb = (int)p[16];
  const int splits = (int)p[17];
  const bool dc_ok = a.dc >= 1 && a.dc <= 32 && (a.dc & (a.dc - 1)) == 0;
  if (a.b < 0 || a.hq <= 0 || a.hkv <= 0 || a.hq % a.hkv || a.s <= 0 ||
      a.kv_len <= 0 || a.db <= 0 || !vec_ok(n) || a.db % n || !dc_ok ||
      a.dc * n < a.db || (rb != 4 && rb != 8 && rb != 16) ||
      a.row_groups * rb < a.hq / a.hkv * a.s ||
      (a.row_groups - 1) * rb >= a.hq / a.hkv * a.s || splits < 1 ||
      splits > kMaxSplits ||
      a.chunk <= 0 || a.chunk % kChunk || (long long)(splits - 1) *
      a.chunk >= a.kv_len || (long long)splits * a.chunk < a.kv_len ||
      (splits > 1 && ws == nullptr) || a.q_pos < 0 ||
      (long long)a.b * a.hkv * a.row_groups > 65535)
    return (int)cudaErrorInvalidValue;
  if (a.b == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? pv_typed<__nv_bfloat16>(logits, v, o, ws, a, n, rb,
                                              splits, s)
                    : pv_typed<float>(logits, v, o, ws, a, n, rb, splits,
                                      s));
}

}  // extern "C"
