// Kernel E: per-sample bilinear source colours from the 4x4-supercell table,
// through one union of supercells shared by each 8-ray block.
//
// Replaces matchnerf_tpu/ops/pallas_color.py::supercell_color_sample (the
// supercell colour Pallas kernel of the eval render). Plain version, union
// build and wrapper: matchnerf_tpu_torch/ops/supercell_color.py.
//
// Table colors_sc [V,Hs,Ws,80] uint8: row (sy, sx) is the 5x5 pixel window
// at (4*sy, 4*sx), edge-padded, channel a*16 + b*3 + c (window row a,
// column b, colour c). grids [V,Rp,S,2] f32 (Rp = 8*NB, tail rays
// edge-padded); unions [V*NB, ut] int32: per (view, 8-ray block) the sorted
// unique supercells of the block's samples, -1 padded. For each sample and
// view: x = clip((gx+1)/2*(img_w-1), 0, img_w-1), x0 = floor(x), fx = x-x0
// (the same for y); the supercell (y0/4, x0/4) and the in-window tap
// (ty, tx) = (y0%4, x0%4); then the y-then-x blend of the TPU kernel
// (pallas_color.py:160-172): T_b = M[ty][b]*(1-fy) + M[ty+1][b]*fy for
// b = tx, tx+1, colour = T_tx*(1-fx) + T_tx+1*fx, on the 0-255 scale.
// out [R, S, 3V] f32, channel 3v+c: the decoder's colour layout.
//
// What bounds it: bytes. Per sample it reads 8 grid floats per view and
// writes 3V floats (~0.16 GB per 20480-ray slice at S=128), against
// ~200 MFLOP. Design: one block of 256 threads per 8-ray block stages the
// <= ut union rows of all V views (<= 3 x 320 x 80 B = 77 KB, dynamic
// shared memory) with 16-byte loads, then one thread per (sample, view)
// binary-searches its supercell in the sorted union and reads its 12 bytes
// from shared memory; consecutive threads write consecutive 12-byte
// colours. All arithmetic uses round-to-nearest intrinsics (no FMA
// contraction), so the kernel equals the plain version bit for bit and its
// supercells equal the torch ops that built the unions.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int SC = 4;
constexpr int ROW_CH = 80;
constexpr int THREADS = 256;
constexpr int BLOCK_RAYS = 8;
constexpr int MAX_V = 4;
constexpr int MAX_UT = 320;

__device__ __forceinline__ int find_row(const int* u, int ut, int key) {
  int lo = 0, hi = ut;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (u[mid] < key) lo = mid + 1; else hi = mid;
  }
  return (lo < ut && u[lo] == key) ? lo : -1;
}

__global__ void __launch_bounds__(THREADS)
supercell_color_kernel(const uint8_t* __restrict__ colors_sc,
                       const float* __restrict__ grids,
                       const int* __restrict__ unions, float* __restrict__ out,
                       int V, int Hs, int Ws, int img_h, int img_w, int R, int S,
                       int NB, int ut) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* rows = smem;                                           // [V][ut][80]
  int* u_s = reinterpret_cast<int*>(smem + (size_t)V * ut * ROW_CH);   // [V][ut]

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int Rp = NB * BLOCK_RAYS;
  for (int i = tid; i < V * ut; i += THREADS) {
    const int v = i / ut, r = i % ut;
    const int c = unions[((size_t)v * NB + blk) * ut + r];
    u_s[i] = c < 0 ? INT_MAX : c;
  }
  __syncthreads();
  for (int i = tid; i < V * ut * (ROW_CH / 16); i += THREADS) {
    const int vr = i / (ROW_CH / 16), part = i % (ROW_CH / 16);
    const int v = vr / ut;
    const int cell = u_s[vr];
    uint4 val = make_uint4(0, 0, 0, 0);
    if (cell != INT_MAX)
      val = *reinterpret_cast<const uint4*>(
          colors_sc + ((size_t)v * Hs * Ws + cell) * ROW_CH + part * 16);
    *reinterpret_cast<uint4*>(rows + (size_t)vr * ROW_CH + part * 16) = val;
  }
  __syncthreads();

  const int rays = min(BLOCK_RAYS, R - blk * BLOCK_RAYS);
  const int tasks = rays * S * V;
  const float wm1 = (float)(img_w - 1), hm1 = (float)(img_h - 1);
  for (int t = tid; t < tasks; t += THREADS) {
    const int v = t % V;
    const int nl = t / V;                       // sample in the block
    const int ray = blk * BLOCK_RAYS + nl / S;
    const int s = nl % S;
    const size_t g = (((size_t)v * Rp + ray) * S + s) * 2;
    const float x = fminf(fmaxf(__fmul_rn(__fmul_rn(__fadd_rn(grids[g], 1.f), 0.5f),
                                          wm1), 0.f), wm1);
    const float y = fminf(fmaxf(__fmul_rn(__fmul_rn(__fadd_rn(grids[g + 1], 1.f), 0.5f),
                                          hm1), 0.f), hm1);
    const float x0f = floorf(x), y0f = floorf(y);
    const float fx = __fsub_rn(x, x0f), fy = __fsub_rn(y, y0f);
    const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
    const int x0 = (int)x0f, y0 = (int)y0f;
    const int sx = x0 / SC, sy = y0 / SC;
    const int tx = x0 - sx * SC, ty = y0 - sy * SC;
    const int pos = find_row(u_s + v * ut, ut, sy * Ws + sx);
    float col[3] = {0.f, 0.f, 0.f};
    if (pos >= 0) {
      const uint8_t* m = rows + ((size_t)v * ut + pos) * ROW_CH;
      const uint8_t* m0 = m + ty * 16 + tx * 3;         // window row ty
      const uint8_t* m1 = m0 + 16;                      // window row ty + 1
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float t0 = __fadd_rn(__fmul_rn((float)m0[c], gy), __fmul_rn((float)m1[c], fy));
        const float t1 = __fadd_rn(__fmul_rn((float)m0[3 + c], gy),
                                   __fmul_rn((float)m1[3 + c], fy));
        col[c] = __fadd_rn(__fmul_rn(t0, gx), __fmul_rn(t1, fx));
      }
    }
    float* dst = out + (((size_t)ray * S + s) * V + v) * 3;
    dst[0] = col[0];
    dst[1] = col[1];
    dst[2] = col[2];
  }
}

}  // namespace

extern "C" int supercell_color_u8(const void* colors_sc, const void* grids,
                                  const void* unions, void* out, int V, int Hs,
                                  int Ws, int img_h, int img_w, int R, int S,
                                  int NB, int ut, void* stream) {
  if (V < 1 || V > MAX_V || Hs != (img_h + SC - 1) / SC ||
      Ws != (img_w + SC - 1) / SC || img_h <= 0 || img_w <= 0 || R <= 0 ||
      S <= 0 || NB * BLOCK_RAYS < R || ut <= 0 || ut > MAX_UT)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)V * ut * (ROW_CH + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      supercell_color_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (R + BLOCK_RAYS - 1) / BLOCK_RAYS;
  supercell_color_kernel<<<blocks, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(colors_sc), static_cast<const float*>(grids),
      static_cast<const int*>(unions), static_cast<float*>(out), V, Hs, Ws,
      img_h, img_w, R, S, NB, ut);
  return (int)cudaGetLastError();
}
