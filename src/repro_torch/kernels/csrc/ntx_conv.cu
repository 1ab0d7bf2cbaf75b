// NTX direct 2-D convolution (paper §III-B2) on Hopper.
//
// Replaces the TPU kernel repro/kernels/ntx_conv.py:conv2d_pallas
// (_conv_kernel): the valid correlation of one (h, w) plane with
// (kh, kw) taps, out[y][x] = sum_i sum_j ker[i][j] * img[y+i][x+j], the
// taps run i outer, j inner over an fp32 accumulator rounded once at the
// store. The Pallas kernel takes one VMEM-resident strip per call and the
// host (ops.conv2d) cuts the plane into halo-overlapped strips; here one
// launch covers the plane, its grid of output tiles taking the place of
// the host's strip loop.
//
// Bound on the H100: bytes for the paper's 3x3 to 7x7 taps. An 8192 x
// 8192 fp32 plane is 256 MiB in and about as much out (~0.16 ms at
// 3.35 TB/s), against 2 kh kw operations per output (7x7: 6.6 GFLOP,
// ~0.1 ms at the 67 TFLOP/s fp32 rate).
// Design: each 256-thread block computes a 64-row x 32-column output
// tile from a (64 + kh - 1) x (32 + kw - 1) fp32 halo tile in shared
// memory (bf16 planes widened on load), with the taps beside it in
// shared memory; lane x of a warp owns output column x, each thread 8
// rows 8 apart, so every shared-memory read is conflict-free and each
// tap read is a broadcast used for 8 outputs. Taps come in as a device
// array, so any (kh, kw) works: when the halo tile and taps would pass
// 48 KB, the tap rows are taken in chunks (and, one row at a time, the
// tap columns), which keeps the i-outer, j-inner order. Ragged output
// edges are masked in the loads and the store; nothing pads.
// Exactness: every product is rounded by __fmul_rn before __fadd_rn adds
// it, so nvcc cannot contract them into an FMA and the result is
// bit-equal to the plain version (kernels/ntx_conv.py:conv2d_plain).
// Left for later: a register sliding window along each tap row (one
// shared read per 8 products instead of one per product) and TMA loads
// of the halo tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int TW = 32;                       // output columns per tile
constexpr int TH = 64;                       // output rows per tile
constexpr int RPT = TH / (kThreads / TW);    // rows per thread (8)
constexpr int kSmemFloats = 48 * 1024 / 4;   // no opt-in attribute needed

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const T* __restrict__ img, const float* __restrict__ ker,
            float* __restrict__ out, int h, int w, int kh, int kw,
            int ci_max, int cj_max) {
  extern __shared__ float smem[];
  const int pitch = TW + cj_max - 1;
  float* tile = smem;                                  // rows x pitch
  float* taps = smem + (TH + ci_max - 1) * pitch;      // ci x cj
  const int tid = threadIdx.x;
  const int tx = tid % TW, ty = tid / TW;
  const int oh = h - kh + 1, ow = w - kw + 1;
  const int ox0 = blockIdx.x * TW, oy0 = blockIdx.y * TH;

  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.0f;

  for (int i0 = 0; i0 < kh; i0 += ci_max) {
    const int ci = min(ci_max, kh - i0);
    for (int j0 = 0; j0 < kw; j0 += cj_max) {
      const int cj = min(cj_max, kw - j0);
      const int th = TH + ci - 1, tw = TW + cj - 1;
      for (int e = tid; e < th * tw; e += kThreads) {
        const int r = e / tw, c = e - r * tw;
        const int gy = oy0 + i0 + r, gx = ox0 + j0 + c;
        tile[r * pitch + c] =
            (gy < h && gx < w) ? load(img + (size_t)gy * w + gx) : 0.0f;
      }
      for (int e = tid; e < ci * cj; e += kThreads) {
        const int i = e / cj, j = e - i * cj;
        taps[e] = ker[(size_t)(i0 + i) * kw + j0 + j];
      }
      __syncthreads();
      for (int i = 0; i < ci; ++i) {
        const float* row = tile + (ty + i) * pitch + tx;
        for (int j = 0; j < cj; ++j) {
          const float t = taps[i * cj + j];
#pragma unroll
          for (int r = 0; r < RPT; ++r)
            acc[r] = __fadd_rn(acc[r],
                               __fmul_rn(t, row[r * (kThreads / TW) * pitch
                                                + j]));
        }
      }
      __syncthreads();
    }
  }

  const int x = ox0 + tx;
  if (x >= ow) return;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int y = oy0 + ty + r * (kThreads / TW);
    if (y < oh) out[(size_t)y * ow + x] = acc[r];
  }
}

// The largest tap chunk whose halo tile and taps fit kSmemFloats: whole
// tap rows (as many as fit), else one row of as many columns as fit.
void pick_chunk(int kh, int kw, int* ci, int* cj) {
  auto floats = [](int a, int b) {
    return (TH + a - 1) * (TW + b - 1) + a * b;
  };
  *cj = kw;
  *ci = 0;
  while (*ci < kh && floats(*ci + 1, kw) <= kSmemFloats) ++*ci;
  if (*ci > 0) return;
  *ci = 1;
  *cj = 1;
  while (*cj < kw && floats(1, *cj + 1) <= kSmemFloats) ++*cj;
}

}  // namespace

extern "C" {

// img (h, w) contiguous fp32 (in_bf16 = 0) or bf16; ker (kh, kw)
// contiguous fp32; out (h-kh+1, w-kw+1) contiguous fp32; all on the device.
int ntx_conv2d(const void* img, const void* ker, void* out, int h, int w,
               int kh, int kw, int in_bf16, void* stream) {
  if (kh < 1 || kw < 1 || kh > h || kw > w) return (int)cudaErrorInvalidValue;
  const int oh = h - kh + 1, ow = w - kw + 1;
  dim3 grid((ow + TW - 1) / TW, (oh + TH - 1) / TH);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  int ci, cj;
  pick_chunk(kh, kw, &ci, &cj);
  const size_t smem =
      sizeof(float) * ((size_t)(TH + ci - 1) * (TW + cj - 1) + ci * cj);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* K = static_cast<const float*>(ker);
  float* O = static_cast<float*>(out);
  if (in_bf16)
    conv_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(img), K, O, h, w, kh, kw, ci, cj);
  else
    conv_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(img), K, O, h, w, kh, kw, ci, cj);
  return (int)cudaGetLastError();
}

}  // extern "C"
