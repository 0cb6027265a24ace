// Kernel E: per-sample bilinear source colours from the 4x4-supercell table,
// read straight from the table (no union).
//
// Replaces matchnerf_tpu/ops/pallas_color.py::supercell_color_sample (the
// supercell colour Pallas kernel of the eval render). Plain version and
// wrapper: matchnerf_tpu_torch/ops/supercell_color.py.
//
// Table colors_sc [V,Hs,Ws,80] uint8: row (sy, sx) is the 5x5 pixel window
// at (4*sy, 4*sx), edge-padded, channel a*16 + b*3 + c (window row a,
// column b, colour c; byte 15 of each window row is zero). grids [V,N,2]
// f32, N = R*S samples. For each sample and view: x = clip((gx+1)/2*(img_w-1),
// 0, img_w-1), x0 = floor(x), fx = x-x0 (the same for y); the supercell
// (y0/4, x0/4) and the in-window tap (ty, tx) = (y0%4, x0%4); then the
// y-then-x blend of the TPU kernel (pallas_color.py:160-172):
// T_b = M[ty][b]*(1-fy) + M[ty+1][b]*fy for b = tx, tx+1,
// colour = T_tx*(1-fx) + T_tx+1*fx, on the 0-255 scale. out [N, 3V] f32,
// channel 3v+c: the decoder's colour layout.
//
// What bounds it: bytes. Per sample it reads 8 grid bytes per view and
// writes 12 bytes per view (0.162 GB per 20480-ray slice at S=128 and 3
// views), against ~200 MFLOP. The TPU kernel gathered each 8-ray block's
// union of supercells into VMEM to feed a one-hot MXU product; on the H100
// the whole table (3 x 128 x 160 x 80 B = 4.9 MB at 640x512) stays in the
// 50 MB L2, and every tap of a sample lies in its own supercell's window, so
// no union is needed. Design: one thread per sample, looping over the views;
// each view's float2 grid load is coalesced across the warp; the two window
// rows ty, ty+1 are two 16-byte __ldg loads from L2 (through L1, where the
// neighbouring samples of a ray mostly hit the same supercell); the block's
// 256 x 3V colours are staged in dynamic shared memory (3 KB a view: 48 KB
// at V = 16, MAX_V_WIDE of views.cuh, the most a block has without opting
// in) and leave as coalesced 16-byte stores. All
// arithmetic uses round-to-nearest intrinsics (no FMA contraction), so the
// kernel equals the plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "views.cuh"

namespace {

constexpr int SC = 4;
constexpr int ROW_CH = 80;
constexpr int THREADS = 256;
static_assert(THREADS * 3 * MAX_V_WIDE * sizeof(float) <= 48 * 1024,
              "the stage fits the default dynamic shared memory at every V");

// byte j (0..15) of a 16-byte window row
__device__ __forceinline__ float byte_at(const uint4& r, int j) {
  const uint32_t w = j < 8 ? (j < 4 ? r.x : r.y) : (j < 12 ? r.z : r.w);
  return (float)((w >> ((j & 3) * 8)) & 0xffu);
}

__global__ void __launch_bounds__(THREADS)
supercell_color_kernel(const uint8_t* __restrict__ colors_sc,
                       const float2* __restrict__ grids, float* __restrict__ out,
                       int V, int Hs, int Ws, int img_h, int img_w, int N) {
  extern __shared__ __align__(16) float stage[];     // [THREADS][3V]
  const int n0 = blockIdx.x * THREADS;
  const int n = n0 + threadIdx.x;
  const int cols = 3 * V;
  const float wm1 = (float)(img_w - 1), hm1 = (float)(img_h - 1);
  if (n < N) {
    for (int v = 0; v < V; ++v) {
      const float2 gr = grids[(size_t)v * N + n];
      const float x = fminf(fmaxf(__fmul_rn(__fmul_rn(__fadd_rn(gr.x, 1.f), 0.5f), wm1), 0.f),
                            wm1);
      const float y = fminf(fmaxf(__fmul_rn(__fmul_rn(__fadd_rn(gr.y, 1.f), 0.5f), hm1), 0.f),
                            hm1);
      const float x0f = floorf(x), y0f = floorf(y);
      const float fx = __fsub_rn(x, x0f), fy = __fsub_rn(y, y0f);
      const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
      const int x0 = (int)x0f, y0 = (int)y0f;
      const int sx = x0 / SC, sy = y0 / SC;
      const int tx = x0 - sx * SC, ty = y0 - sy * SC;
      const uint4* row = reinterpret_cast<const uint4*>(
          colors_sc + (((size_t)v * Hs + sy) * Ws + sx) * ROW_CH) + ty;
      const uint4 m0 = __ldg(row), m1 = __ldg(row + 1);     // window rows ty, ty+1
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int b0 = tx * 3 + c, b1 = b0 + 3;
        const float t0 = __fadd_rn(__fmul_rn(byte_at(m0, b0), gy), __fmul_rn(byte_at(m1, b0), fy));
        const float t1 = __fadd_rn(__fmul_rn(byte_at(m0, b1), gy), __fmul_rn(byte_at(m1, b1), fy));
        stage[threadIdx.x * cols + v * 3 + c] = __fadd_rn(__fmul_rn(t0, gx), __fmul_rn(t1, fx));
      }
    }
  }
  __syncthreads();
  // the block's samples are one contiguous span of out: 16-byte stores
  const int count = min(THREADS, N - n0) * cols;
  float* dst = out + (size_t)n0 * cols;
  const int n4 = count / 4;
  for (int i = threadIdx.x; i < n4; i += THREADS)
    reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(stage)[i];
  for (int i = n4 * 4 + threadIdx.x; i < count; i += THREADS) dst[i] = stage[i];
}

}  // namespace

// colors_sc [V,Hs,Ws,80] uint8 (V = 1 to MAX_V_WIDE), grids [V,N,2] f32, out [N,3V] f32
// (16-byte aligned)
extern "C" int supercell_color_u8(const void* colors_sc, const void* grids, void* out,
                                  int V, int Hs, int Ws, int img_h, int img_w, int N,
                                  void* stream) {
  if (V < 1 || V > MAX_V_WIDE || Hs != (img_h + SC - 1) / SC ||
      Ws != (img_w + SC - 1) / SC || img_h <= 0 || img_w <= 0 || N <= 0 ||
      reinterpret_cast<uintptr_t>(colors_sc) % 16 || reinterpret_cast<uintptr_t>(grids) % 8 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const int blocks = (N + THREADS - 1) / THREADS;
  const size_t smem = (size_t)THREADS * 3 * V * sizeof(float);
  supercell_color_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(colors_sc), static_cast<const float2*>(grids),
      static_cast<float*>(out), V, Hs, Ws, img_h, img_w, N);
  return (int)cudaGetLastError();
}
