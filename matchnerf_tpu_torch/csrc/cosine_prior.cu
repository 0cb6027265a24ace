// Kernel B: grouped-cosine matching prior of one feature scale.
//
// Replaces matchnerf_tpu/ops/pallas_banded.py::banded_cosine_scale (the
// per-ray banded Pallas kernel of the eval render). Plain version and
// wrapper: matchnerf_tpu_torch/ops/cosine_prior.py.
//
// For each sample n and each of the V = 3 views: bilinear sample (align
// corners, border clamp) of the view's unpacked table [V,H,W,2C] (C = 128,
// int8 or f32) at grids[v, n], times the per-(view, channel) dequantisation
// scale; then for each pair (i, j) in (0,1), (0,2), (1,2) the grouped cosine
// of view i's chunk j-1 against view j's chunk i (eps 1e-8 on each norm),
// averaged over the pairs. out[n, g], f32.
//
// What bounds it: gathers. Each sample reads 4 taps x 3 views x 256 channels
// (3 KB with int8 tables, 12 KB with f32) for ~10 K flops, so it is bound by
// bytes moved through L2, not by arithmetic. Design: no dedup, no host
// buckets. Half a warp (16 lanes) owns one sample, each lane 8 channels of
// both chunks of every view, so a tap row of 256 int8 channels is read as
// 16 lanes x 8 bytes per chunk, coalesced. Both DTU tables (3.9 MB and
// 15.7 MB in int8 for 3 views) fit in the 50 MB L2 together, and the
// neighbouring samples of a ray hit neighbouring cells, so most tap reads
// are L2 hits. Interpolation and dequantisation are f32 in registers; the
// per-group dot products and norms reduce with shuffles inside the group's
// lanes. Only [N, G] f32 is written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int V = 3;
constexpr int C = 128;          // channels per pair chunk
constexpr int CC = 2 * C;       // channels per view table row
constexpr int LANES = C / 8;    // lanes per sample (8 channels each)
constexpr int THREADS = 256;
constexpr int SAMPLES_PER_BLOCK = THREADS / LANES;

__device__ __forceinline__ void load8(const int8_t* p, float* f) {
  const int2 raw = *reinterpret_cast<const int2*>(p);
  const int w[2] = {raw.x, raw.y};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[h * 4 + b] = (float)(int8_t)((w[h] >> (8 * b)) & 0xff);
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
cosine_prior_kernel(const T* __restrict__ table, const float* __restrict__ grids,
                    const float* __restrict__ scales, float* __restrict__ out,
                    int H, int W, int G, int N) {
  const int lane = threadIdx.x % LANES;
  const int n_raw = blockIdx.x * SAMPLES_PER_BLOCK + threadIdx.x / LANES;
  // out-of-range samples still run (clamped) so every shuffle has all lanes
  const int n = min(n_raw, N - 1);
  const int o = lane * 8;

  float f[V][2][8];   // [view][chunk][channel] interpolated, dequantised
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float gx = grids[((size_t)v * N + n) * 2 + 0];
    const float gy = grids[((size_t)v * N + n) * 2 + 1];
    const float x = fminf(fmaxf((gx + 1.f) * 0.5f * (float)(W - 1), 0.f), (float)(W - 1));
    const float y = fminf(fmaxf((gy + 1.f) * 0.5f * (float)(H - 1), 0.f), (float)(H - 1));
    const float x0f = floorf(x), y0f = floorf(y);
    const float wx1 = x - x0f, wy1 = y - y0f;
    const float wx0 = 1.f - wx1, wy0 = 1.f - wy1;
    const int x0 = (int)x0f, y0 = (int)y0f;
    const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
    const float w00 = wy0 * wx0, w01 = wy0 * wx1, w10 = wy1 * wx0, w11 = wy1 * wx1;
    const T* tv = table + (size_t)v * H * W * CC;
    const T* r00 = tv + ((size_t)y0 * W + x0) * CC;
    const T* r01 = tv + ((size_t)y0 * W + x1) * CC;
    const T* r10 = tv + ((size_t)y1 * W + x0) * CC;
    const T* r11 = tv + ((size_t)y1 * W + x1) * CC;
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      const int c0 = ch * C + o;
      float a[8], b[8], c[8], d[8];
      load8(r00 + c0, a);
      load8(r01 + c0, b);
      load8(r10 + c0, c);
      load8(r11 + c0, d);
      const float4 s0 = *reinterpret_cast<const float4*>(scales + v * CC + c0);
      const float4 s1 = *reinterpret_cast<const float4*>(scales + v * CC + c0 + 4);
      const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        f[v][ch][e] = (a[e] * w00 + b[e] * w01 + c[e] * w10 + d[e] * w11) * sc[e];
    }
  }

  const int lanes_per_group = LANES / G;   // G in {1,2,4,8,16}
  float total = 0.f;
  // pair (i, j): view i's chunk j-1 against view j's chunk i
  constexpr int PI[3] = {0, 0, 1}, PJ[3] = {1, 2, 2};
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const float* fa = f[PI[p]][PJ[p] - 1];
    const float* fb = f[PJ[p]][PI[p]];
    float dot = 0.f, na2 = 0.f, nb2 = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      dot = fmaf(fa[e], fb[e], dot);
      na2 = fmaf(fa[e], fa[e], na2);
      nb2 = fmaf(fb[e], fb[e], nb2);
    }
    for (int off = lanes_per_group / 2; off > 0; off >>= 1) {
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
      na2 += __shfl_xor_sync(0xffffffffu, na2, off);
      nb2 += __shfl_xor_sync(0xffffffffu, nb2, off);
    }
    total += dot / (fmaxf(sqrtf(na2), 1e-8f) * fmaxf(sqrtf(nb2), 1e-8f));
  }
  if (n_raw < N && lane % lanes_per_group == 0)
    out[(size_t)n * G + lane / lanes_per_group] = total / 3.f;
}

template <typename T>
int launch(const void* table, const void* grids, const void* scales, void* out,
           int views, int H, int W, int channels, int G, int N,
           cudaStream_t stream) {
  if (views != V || channels != C || H <= 0 || W <= 0 || N < 0 ||
      !(G == 1 || G == 2 || G == 4 || G == 8 || G == 16))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  const int blocks = (N + SAMPLES_PER_BLOCK - 1) / SAMPLES_PER_BLOCK;
  cosine_prior_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const float*>(grids),
      static_cast<const float*>(scales), static_cast<float*>(out), H, W, G, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cosine_prior_i8(const void* table, const void* grids,
                               const void* scales, void* out, int views, int H,
                               int W, int channels, int G, int N, void* stream) {
  return launch<int8_t>(table, grids, scales, out, views, H, W, channels, G, N,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int cosine_prior_f32(const void* table, const void* grids,
                                const void* scales, void* out, int views, int H,
                                int W, int channels, int G, int N, void* stream) {
  return launch<float>(table, grids, scales, out, views, H, W, channels, G, N,
                       static_cast<cudaStream_t>(stream));
}
