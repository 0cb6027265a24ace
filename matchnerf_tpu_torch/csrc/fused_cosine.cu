// Kernel F: bilinear interpolation and grouped cosine on gathered tap rows.
//
// Replaces matchnerf_tpu/ops/pallas_cond.py::fused_interp_grouped_cosine,
// the forward-only kernel of `precision.fused_cosine` (eval and video
// renders). Plain version and wrapper: matchnerf_tpu_torch/ops/fused_cosine.py.
//
// Input: rows [V,N,4*(V-1)C] (V = 2 to 16 views, views.cuh; C = 128; int8,
// bf16 or f32), per view and sample the four bilinear taps y0x0, y0x1,
// y1x0, y1x1 of the view's table row, each (V-1)C channels; weights
// [V,N,2] f32 (wx, wy); scales [V,(V-1)C] f32 or NULL (per-(view, channel)
// dequantisation, applied after interpolation). Per sample and view: the
// nested lerp
//   (t00 (1-wx) + t01 wx) (1-wy) + (t10 (1-wx) + t11 wx) wy
// in f32 (pallas_cond.py:54-55), times the scale; then for each of the
// P = V(V-1)/2 pairs (i, j), i < j in row-major order (`pair_index_lists`),
// the grouped cosine of view i's chunk j-1 against view j's chunk i (eps
// 1e-8 on each norm), summed in that order and divided by P. Output
// out[n, g], f32. One template instance per V to V = 8 (MAX_V): the pair
// list is compile-time, so every loop unrolls. V = 9 to 16 (MAX_V_WIDE)
// share one instance per row type (VT = 0) that walks the same pairs in the
// same order in a loop, each pair's views and the row width found at run
// time: the same arithmetic, 16 live interpolated floats a lane.
//
// What bounds it: bytes. Each sample reads V x 4(V-1)C row elements (at
// V = 3, 3 KB in int8, 6 KB in bf16, 12 KB in f32) once and does ~10 K
// flops, so at 1 M samples per slice and scale it needs ~1 ms (int8) to
// ~4 ms (f32) of device-memory time against ~0.15 ms of f32 arithmetic.
// Design: one streaming pass, nothing staged. Half a warp (16 lanes) owns
// one sample, each lane 8 channels of every chunk of every view, so each
// tap's chunk of a row is read as 16 lanes x 8 elements, coalesced, with
// streaming loads (the rows are read once). The sample's pairs are walked
// in order, as Kernel B walks them (csrc/cosine_prior.cu): each (view,
// chunk) enters exactly one pair, so for pair (i, j) a lane interpolates
// and dequantises view i's chunk j-1 and view j's chunk i from their four
// tap rows, reduces them and adds the cosine to the pair sum, then drops
// both: 16 interpolated floats a lane are live at every V, where
// interpolating every (view, chunk) first would hold 8V(V-1) (96 at V = 4,
// 448 at V = 8). Interpolation and
// dequantisation are f32 in registers; the per-group dot products and
// norms reduce with shuffles inside the group's lanes. Only [N, G] f32 is
// written.

#include <cuda_runtime.h>
#include <stdint.h>

#include "views.cuh"

namespace {

constexpr int C = 128;          // channels per pair chunk
constexpr int LANES = C / 8;    // lanes per sample (8 channels each)
constexpr int THREADS = 256;
constexpr int SAMPLES_PER_BLOCK = THREADS / LANES;

__device__ __forceinline__ void load8(const int8_t* p, float* f) {
  const int2 raw = __ldcs(reinterpret_cast<const int2*>(p));
  const int w[2] = {raw.x, raw.y};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[h * 4 + b] = (float)(int8_t)((w[h] >> (8 * b)) & 0xff);
}

// bf16 stored as its 16 bits: the f32 with the same upper half
__device__ __forceinline__ void load8(const uint16_t* p, float* f) {
  const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(p));
  const unsigned int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    f[2 * h] = __uint_as_float(w[h] << 16);
    f[2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p + 4));
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// this lane's 8 channels (from channel c0 of the view's row) of view v at
// sample n: the nested lerp of the four tap rows, times the scale; V views
template <typename T>
__device__ __forceinline__ void interp8(const T* __restrict__ rows,
                                        const float* __restrict__ weights,
                                        const float* __restrict__ scales, int V, int v,
                                        int c0, int n, int N, float* f) {
  const int CC = (V - 1) * C;       // channels per view
  const int ROW = 4 * CC;           // elements per tap row
  const size_t vn = (size_t)v * N + n;
  const float wx = weights[vn * 2 + 0];
  const float wy = weights[vn * 2 + 1];
  const float wx0 = 1.f - wx, wy0 = 1.f - wy;
  const T* r = rows + vn * ROW;
  float a[8], b[8], c[8], d[8];
  load8(r + 0 * CC + c0, a);
  load8(r + 1 * CC + c0, b);
  load8(r + 2 * CC + c0, c);
  load8(r + 3 * CC + c0, d);
  float sc[8] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
  if (scales != nullptr) {
    const float4 s0 = *reinterpret_cast<const float4*>(scales + v * CC + c0);
    const float4 s1 = *reinterpret_cast<const float4*>(scales + v * CC + c0 + 4);
    sc[0] = s0.x; sc[1] = s0.y; sc[2] = s0.z; sc[3] = s0.w;
    sc[4] = s1.x; sc[5] = s1.y; sc[6] = s1.z; sc[7] = s1.w;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    f[e] = ((a[e] * wx0 + b[e] * wx) * wy0 + (c[e] * wx0 + d[e] * wx) * wy) * sc[e];
}

// VT: the compiled view count (2 to MAX_V), or 0 for V = v_rt at run time
// (MAX_V + 1 to MAX_V_WIDE)
template <typename T, int VT>
__global__ void __launch_bounds__(THREADS)
fused_cosine_kernel(const T* __restrict__ rows, const float* __restrict__ weights,
                    const float* __restrict__ scales, float* __restrict__ out,
                    int G, int N, int v_rt) {
  const int V = VT ? VT : v_rt;
  const int P = n_pairs(V);
  const int lane = threadIdx.x % LANES;
  const int n_raw = blockIdx.x * SAMPLES_PER_BLOCK + threadIdx.x / LANES;
  // out-of-range samples still run (clamped) so every shuffle has all lanes
  const int n = min(n_raw, N - 1);
  const int o = lane * 8;
  const int lanes_per_group = LANES / G;   // G in {1,2,4,8,16}
  float total = 0.f;
  // pair (i, j): view i's chunk j-1 against view j's chunk i
  auto pair = [&](int p) {
    const int vi = pair_first(V, p), vj = pair_second(V, p);
    float fa[8], fb[8];
    interp8<T>(rows, weights, scales, V, vi, (vj - 1) * C + o, n, N, fa);
    interp8<T>(rows, weights, scales, V, vj, vi * C + o, n, N, fb);
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
  };
  if constexpr (VT != 0) {
#pragma unroll
    for (int p = 0; p < n_pairs(VT); ++p) pair(p);
  } else {
#pragma unroll 1
    for (int p = 0; p < P; ++p) pair(p);
  }
  if (n_raw < N && lane % lanes_per_group == 0)
    out[(size_t)n * G + lane / lanes_per_group] = total / (float)P;
}

// VT = 0: the run-time-V instance, at V = views
template <typename T, int VT>
void launch_v(const T* r, const float* w, const float* s, float* o, int G, int N, int views,
              cudaStream_t stream) {
  const int blocks = (N + SAMPLES_PER_BLOCK - 1) / SAMPLES_PER_BLOCK;
  fused_cosine_kernel<T, VT><<<blocks, THREADS, 0, stream>>>(r, w, s, o, G, N, views);
}

template <typename T>
int launch(const void* rows, const void* weights, const void* scales, void* out,
           int views, int channels, int G, int N, cudaStream_t stream) {
  if (views < MIN_V || views > MAX_V_WIDE || channels != C || N < 0 ||
      !(G == 1 || G == 2 || G == 4 || G == 8 || G == 16))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  const T* r = static_cast<const T*>(rows);
  const float* w = static_cast<const float*>(weights);
  const float* s = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  switch (views) {
    case 2: launch_v<T, 2>(r, w, s, o, G, N, views, stream); break;
    case 3: launch_v<T, 3>(r, w, s, o, G, N, views, stream); break;
    case 4: launch_v<T, 4>(r, w, s, o, G, N, views, stream); break;
    case 5: launch_v<T, 5>(r, w, s, o, G, N, views, stream); break;
    case 6: launch_v<T, 6>(r, w, s, o, G, N, views, stream); break;
    case 7: launch_v<T, 7>(r, w, s, o, G, N, views, stream); break;
    case 8: launch_v<T, 8>(r, w, s, o, G, N, views, stream); break;
    default: launch_v<T, 0>(r, w, s, o, G, N, views, stream); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_cosine_i8(const void* rows, const void* weights, const void* scales,
                               void* out, int views, int channels, int G, int N,
                               void* stream) {
  return launch<int8_t>(rows, weights, scales, out, views, channels, G, N,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int fused_cosine_bf16(const void* rows, const void* weights, const void* scales,
                                 void* out, int views, int channels, int G, int N,
                                 void* stream) {
  return launch<uint16_t>(rows, weights, scales, out, views, channels, G, N,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int fused_cosine_f32(const void* rows, const void* weights, const void* scales,
                                void* out, int views, int channels, int G, int N,
                                void* stream) {
  return launch<float>(rows, weights, scales, out, views, channels, G, N,
                       static_cast<cudaStream_t>(stream));
}
