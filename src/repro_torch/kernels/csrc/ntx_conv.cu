// NTX direct 2-D convolution (paper §III-B2) on Hopper.
//
// Replaces the TPU kernel repro/kernels/ntx_conv.py:conv2d_pallas
// (_conv_kernel): the valid correlation of one (h, w) plane with
// (kh, kw) taps, out[y][x] = sum_i sum_j ker[i][j] * img[y+i][x+j], the
// taps run i outer, j inner over an fp32 accumulator rounded once at the
// store. The Pallas kernel takes one VMEM-resident strip per call and the
// host (ops.conv2d) cuts the plane into halo-overlapped strips; here one
// launch covers the plane, its output tiles taking the place of the
// host's strip loop.
//
// Bound on the H100: bytes for 3x3 and 5x5, the FP32 pipe for 7x7. An
// 8192 x 8192 fp32 plane is 256 MiB in and about as much out (~0.16 ms
// at 3.35 TB/s). Bit-equality forbids FMA, so every tap is one FMUL and
// one FADD, each an instruction of the FP32 pipe (132 SMs x 128 lanes x
// ~1.98 GHz ~ 33.5 T/s): 7x7 on 8192^2 needs >= 0.196 ms of them.
// Design:
// - A thread computes a run of 4 adjacent output columns on RPT rows
//   (RPT = 8 or 1), a block TX x TY threads: an output tile of (4 TX) x
//   (RPT TY). The caller passes the plan (TX, TY, RPT, the tap chunk and
//   the grid; kernels/ntx_conv.py:tile_plan makes it) and the launch
//   refuses one the kernel cannot run. tile_plan takes the largest tile
//   that still gives one tile per SM, so a 256^2 plane fills the card
//   with 32 x 8 tiles and an 8192^2 one runs 256 x 32 tiles.
// - Register sliding window: for each input row u of its rows, a thread
//   loads the run plus its kw - 1 halo once from shared memory (16-byte
//   loads, conflict-free: a quarter warp reads 128 neighbouring bytes)
//   and applies it to every output row r with tap row i = u - r, kw taps
//   each from registers. For 3x3, 5x5 and 7x7 taps the whole loop nest is
//   compile-time (no branch; window and taps are register arrays); other
//   taps shift a 4-value window by one per tap. Per output row, u runs in
//   order, so each output still adds its taps i outer, j inner.
// - The halo tile arrives by 16-byte cp.async (4-byte when the rows are
//   not 16-byte aligned; zero-filled past the plane), with no division
//   per element; bf16 planes are widened to fp32 on their way into
//   shared memory (plain loads). Taps past the shared-memory stage budget
//   are taken in chunks (whole tap rows as many as fit, else one row of
//   as many columns, a multiple of 4, as fit: the i-outer, j-inner order
//   holds). Block b takes tiles b, b + grid, b + 2 grid, ...; a step is
//   one tap chunk of one tile, and with more than one step a block runs
//   them through a two-stage ring: the next step's copy (the next chunk,
//   or the next tile's first) runs while this step's products do. The
//   plan's grid is one block per tile: a persistent grid of two blocks
//   per SM was slower (chip_smoke phase 3 times both), so between tiles
//   the copies overlap the products of the other blocks on the SM.
// - Ragged output edges are masked at the store; nothing pads.
// Exactness: every product is rounded by __fmul_rn before __fadd_rn adds
// it, so nvcc cannot contract them into an FMA and the result is
// bit-equal to the plain version (kernels/ntx_conv.py:conv2d_plain).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRunW = 4;                     // output columns per thread
constexpr int kStageFloats = 12 * 1024;      // 48 KB per ring stage

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

struct Geo {              // what every block knows of the launch
  int h, w, kh, kw, oh, ow;
  int ci, cj, nci, ncj;   // tap chunk and the number of chunks each way
  int x_tiles, tiles;
  int stage;              // floats per ring stage
  bool vec;               // rows 16-byte aligned: 16-byte copies
};

// Stage the halo tile and the taps of chunk c of tile t.
template <typename T>
__device__ __forceinline__ void load_stage(const T* __restrict__ img,
                                           const float* __restrict__ ker,
                                           float* st, const Geo& g, int th,
                                           int tw, int t, int c) {
  const int nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  const int ic = c / g.ncj, jc = c - ic * g.ncj;
  const int i0 = ic * g.ci, j0 = jc * g.cj;
  const int ci = min(g.ci, g.kh - i0), cj = min(g.cj, g.kw - j0);
  const int ty = t / g.x_tiles;
  const int y0 = ty * th + i0, x0 = (t - ty * g.x_tiles) * tw + j0;
  const int rows = th + ci - 1, cols = tw + cj - 1, pitch = round4(cols);
  for (int r = warp; r < rows; r += nwarps) {
    const int gy = y0 + r;
    float* srow = st + r * pitch;
    const T* grow = img + (size_t)min(gy, g.h - 1) * g.w;
    if constexpr (sizeof(T) == 4) {
      if (g.vec) {
        for (int q = lane * 4; q < cols; q += 128) {
          const bool in = gy < g.h && x0 + q < g.w;
          cp_async16(srow + q, in ? grow + x0 + q : img, in ? 16 : 0);
        }
      } else {
        for (int q = lane; q < cols; q += 32) {
          const bool in = gy < g.h && x0 + q < g.w;
          cp_async4(srow + q, in ? grow + x0 + q : img, in ? 4 : 0);
        }
      }
    } else {
      for (int q = lane; q < cols; q += 32) {
        const bool in = gy < g.h && x0 + q < g.w;
        const unsigned short b =
            in ? __ldg(reinterpret_cast<const unsigned short*>(grow + x0 + q))
               : 0;
        srow[q] = __uint_as_float((unsigned)b << 16);
      }
    }
  }
  float* taps = st + rows * pitch;
  const int kwp = round4(cj);
  for (int i = warp; i < ci; i += nwarps)
    for (int j = lane; j < kwp; j += 32)
      taps[i * kwp + j] =
          j < cj ? __ldg(ker + (size_t)(i0 + i) * g.kw + j0 + j) : 0.0f;
}

// Apply chunk c (staged at st) to the thread's RPT x 4 accumulators.
// K > 0: the chunk is all of a K x K tap block, so the input rows u, the
// output rows r and the tap rows i = u - r are compile-time: no branch,
// and the window and taps are register arrays. K = 0: any chunk.
template <int K, int RPT>
__device__ __forceinline__ void apply_chunk(const float* st, const Geo& g,
                                            int th, int tw, int c,
                                            float (&acc)[RPT][kRunW]) {
  const int tx = threadIdx.x % (tw / kRunW), ty = threadIdx.x / (tw / kRunW);
  if constexpr (K > 0) {
    constexpr int NW = round4(kRunW + K - 1), KP = round4(K);
    const int pitch = round4(tw + K - 1);
    const float* base = st + ty * RPT * pitch + tx * kRunW;
    const float* taps = st + (th + K - 1) * pitch;
#pragma unroll
    for (int u = 0; u < RPT + K - 1; ++u) {
      float win[NW];
#pragma unroll
      for (int v = 0; v < NW; v += 4) {
        const float4 f =
            *reinterpret_cast<const float4*>(base + u * pitch + v);
        win[v] = f.x; win[v + 1] = f.y; win[v + 2] = f.z; win[v + 3] = f.w;
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int i = u - r;
        if (i < 0 || i >= K) continue;
        float t[KP];
#pragma unroll
        for (int v = 0; v < KP; v += 4) {
          const float4 f = *reinterpret_cast<const float4*>(taps + i * KP + v);
          t[v] = f.x; t[v + 1] = f.y; t[v + 2] = f.z; t[v + 3] = f.w;
        }
#pragma unroll
        for (int j = 0; j < K; ++j)
#pragma unroll
          for (int q = 0; q < kRunW; ++q)
            acc[r][q] = __fadd_rn(acc[r][q], __fmul_rn(t[j], win[q + j]));
      }
    }
  } else {
    const int ic = c / g.ncj, jc = c - ic * g.ncj;
    const int ci = min(g.ci, g.kh - ic * g.ci);
    const int cj = min(g.cj, g.kw - jc * g.cj);
    const int pitch = round4(tw + cj - 1), kwp = round4(cj);
    const float* base = st + ty * RPT * pitch + tx * kRunW;
    const float* taps = st + (th + ci - 1) * pitch;
    for (int u = 0; u < RPT + ci - 1; ++u) {
      const float* row = base + u * pitch;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int i = u - r;
        if (i < 0 || i >= ci) continue;
        const float* trow = taps + i * kwp;
        // a 4-value window shifted by one column per tap
        float win[kRunW];
#pragma unroll
        for (int q = 0; q < kRunW; ++q) win[q] = row[q];
        for (int j = 0; j < cj; ++j) {
          const float t = trow[j];
#pragma unroll
          for (int q = 0; q < kRunW; ++q)
            acc[r][q] = __fadd_rn(acc[r][q], __fmul_rn(t, win[q]));
          if (j + 1 < cj) {
#pragma unroll
            for (int q = 0; q + 1 < kRunW; ++q) win[q] = win[q + 1];
            win[kRunW - 1] = row[kRunW + j];
          }
        }
      }
    }
  }
}

template <int RPT>
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           const Geo& g, int th, int tw,
                                           int t,
                                           const float (&acc)[RPT][kRunW]) {
  const int tx = threadIdx.x % (tw / kRunW), ty = threadIdx.x / (tw / kRunW);
  const int tyt = t / g.x_tiles;
  const int x = (t - tyt * g.x_tiles) * tw + tx * kRunW;
  if (x >= g.ow) return;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int y = tyt * th + ty * RPT + r;
    if (y >= g.oh) break;
    float* o = out + (size_t)y * g.ow + x;
    if (g.ow % 4 == 0) {          // x % 4 == 0: the run is in or out
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else if (g.ow % 2 == 0) {
      *reinterpret_cast<float2*>(o) = make_float2(acc[r][0], acc[r][1]);
      if (x + 2 < g.ow)
        *reinterpret_cast<float2*>(o + 2) = make_float2(acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int q = 0; q < kRunW; ++q)
        if (x + q < g.ow) o[q] = acc[r][q];
    }
  }
}

template <int RPT>
__device__ __forceinline__ void zero(float (&acc)[RPT][kRunW]) {
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int q = 0; q < kRunW; ++q) acc[r][q] = 0.0f;
}

template <typename T, int K, int RPT>
__global__ void __launch_bounds__(256)
conv_kernel(const T* __restrict__ img, const float* __restrict__ ker,
            float* __restrict__ out, Geo g, int th, int tw) {
  extern __shared__ __align__(16) float smem[];
  const int nch = g.nci * g.ncj, grid = gridDim.x;
  const int steps = ((g.tiles - 1 - (int)blockIdx.x) / grid + 1) * nch;
  float acc[RPT][kRunW];
  zero<RPT>(acc);
  int t = blockIdx.x, c = 0;      // this step's tile and tap chunk
  int tn = t, cn = 0;             // the next step's
  load_stage(img, ker, smem, g, th, tw, t, 0);
  cp_commit();
  for (int s = 0; s < steps; ++s) {
    // the next step's copy runs while this step's products do
    if (++cn == nch) {
      cn = 0;
      tn += grid;
    }
    if (s + 1 < steps)
      load_stage(img, ker, smem + ((s + 1) & 1) * g.stage, g, th, tw, tn,
                 cn);
    cp_commit();                  // one group per step, empty or not
    cp_wait<1>();                 // step s's group has landed
    __syncthreads();
    apply_chunk<K, RPT>(smem + (s & 1) * g.stage, g, th, tw, c, acc);
    __syncthreads();              // the stage is free for step s + 2
    if (++c == nch) {
      store_tile<RPT>(out, g, th, tw, t, acc);
      zero<RPT>(acc);
      c = 0;
      t += grid;
    }
  }
}

template <typename T, int K, int RPT>
int launch(const T* img, const float* ker, float* out, const Geo& g,
           int tx, int ty, int blocks, size_t smem, cudaStream_t s) {
  // a ring of two 48 KB stages passes the 48 KB a block gets unasked: opt
  // each instance in once per device
  static unsigned opted = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!(opted & (1u << dev))) {
    e = cudaFuncSetAttribute(&conv_kernel<T, K, RPT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(2 * sizeof(float) * kStageFloats));
    if (e != cudaSuccess) return (int)e;
    opted |= 1u << dev;
  }
  conv_kernel<T, K, RPT><<<blocks, tx * ty, smem, s>>>(
      img, ker, out, g, RPT * ty, kRunW * tx);
  return (int)cudaGetLastError();
}

template <typename T, int RPT>
int launch_k(const T* img, const float* ker, float* out, const Geo& g,
             int tx, int ty, int blocks, size_t smem, cudaStream_t s) {
  // 3x3, 5x5 and 7x7 taps in one chunk are compiled for; the rest is not
  const int k = g.kh == g.kw && g.ci == g.kh && g.cj == g.kw ? g.kh : 0;
  switch (k) {
    case 3: return launch<T, 3, RPT>(img, ker, out, g, tx, ty, blocks, smem, s);
    case 5: return launch<T, 5, RPT>(img, ker, out, g, tx, ty, blocks, smem, s);
    case 7: return launch<T, 7, RPT>(img, ker, out, g, tx, ty, blocks, smem, s);
    default:
      return launch<T, 0, RPT>(img, ker, out, g, tx, ty, blocks, smem, s);
  }
}

// Check the plan (kernels/ntx_conv.py:tile_plan) and launch it: the tile
// is (4 tx) x (rpt ty) outputs, ci x cj taps a chunk (whole tap rows, or
// one row of a multiple of 4 columns, so the i-outer, j-inner order and
// the 16-byte copies hold), one stage within kStageFloats, blocks at most
// one per tile.
template <typename T>
int launch_conv(const T* img, const float* ker, float* out, int h, int w,
                int kh, int kw, int tx, int ty, int rpt, int ci, int cj,
                int blocks, cudaStream_t s) {
  const long long threads = (long long)tx * ty;
  if (tx < 1 || ty < 1 || threads % 32 != 0 || threads > 256 ||
      (rpt != 1 && rpt != 8))
    return (int)cudaErrorInvalidConfiguration;
  if (ci < 1 || ci > kh || cj < 1 || cj > kw ||
      (cj < kw && (ci != 1 || cj % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  Geo g;
  g.h = h; g.w = w; g.kh = kh; g.kw = kw;
  g.oh = h - kh + 1; g.ow = w - kw + 1;
  const int tw = kRunW * tx, th = rpt * ty;
  const long long x_tiles = (g.ow + tw - 1) / tw;
  const long long tiles = x_tiles * ((g.oh + th - 1) / th);
  const long long stage = (long long)(th + ci - 1) * round4(tw + cj - 1) +
                          (long long)ci * round4(cj);
  if (tiles > 0x7fffffffLL || blocks < 1 || blocks > tiles ||
      stage > kStageFloats)
    return (int)cudaErrorInvalidValue;
  g.x_tiles = (int)x_tiles;
  g.tiles = (int)tiles;
  g.ci = ci; g.cj = cj;
  g.nci = (kh + ci - 1) / ci;
  g.ncj = (kw + cj - 1) / cj;
  g.stage = (int)stage;
  g.vec = sizeof(T) == 4 && w % 4 == 0 &&
          reinterpret_cast<uintptr_t>(img) % 16 == 0;
  // one stage, or a ring of two when a block runs more than one step
  const bool ring = g.nci * g.ncj > 1 || blocks < g.tiles;
  const size_t smem = sizeof(float) * (ring ? 2 : 1) * (size_t)g.stage;
  if (rpt == 8)
    return launch_k<T, 8>(img, ker, out, g, tx, ty, blocks, smem, s);
  return launch_k<T, 1>(img, ker, out, g, tx, ty, blocks, smem, s);
}

}  // namespace

extern "C" {

// img (h, w) contiguous fp32 (in_bf16 = 0) or bf16; ker (kh, kw)
// contiguous fp32; out (h-kh+1, w-kw+1) contiguous fp32, 16-byte
// aligned; all on the device. (tx, ty, rpt, ci, cj, blocks): the plan,
// as launch_conv takes it.
int ntx_conv2d(const void* img, const void* ker, void* out, int h, int w,
               int kh, int kw, int in_bf16, int tx, int ty, int rpt, int ci,
               int cj, int blocks, void* stream) {
  if (kh < 1 || kw < 1 || kh > h || kw > w) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* K = static_cast<const float*>(ker);
  float* O = static_cast<float*>(out);
  if (in_bf16)
    return launch_conv(static_cast<const __nv_bfloat16*>(img), K, O, h, w,
                       kh, kw, tx, ty, rpt, ci, cj, blocks, s);
  return launch_conv(static_cast<const float*>(img), K, O, h, w, kh, kw, tx,
                     ty, rpt, ci, cj, blocks, s);
}

}  // extern "C"
