// Kernel A: single-head window attention of the GMFlow encoder, forward.
//
// Replaces matchnerf_tpu/ops/pallas_attention.py::flash_window_attention
// (the Pallas TPU flash kernel). Plain version and wrapper:
// matchnerf_tpu_torch/ops/window_attention.py.
//
// out[w, i, :] = softmax_j(q_i . k_j / sqrt(C) + mask_ij) v_j, for windows w
// of L tokens and C = 128 channels, where mask_ij = -100 when the region ids
// of tokens i and j differ (shifted layers) and 0 otherwise.
//
// What bounds it: at the DTU shape (24 windows, L = 1280, C = 128) the two
// products take 2 * 24 * 1280^2 * 128 * 2 = 20 GFLOP against 24 MB of q/k/v,
// so it is bound by arithmetic, not by bytes; the risk is the [BW, L, L]
// score matrix (157 MB in f32) that the plain version writes and reads back.
// Design: flash-style online softmax. One block owns 64 queries of one
// window and streams 64-key tiles of K and V through shared memory; the
// 64x64 score tile lives in registers (4x4 per thread) and in a transposed
// shared tile for the P.V product, so the score matrix never reaches device
// memory. Operands are f32 in shared memory (bf16 inputs are widened on
// load), accumulation and softmax are f32, and the products are register-
// blocked CUDA-core FMAs. Tensor cores (wgmma) are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;              // queries per block
constexpr int BK = 64;              // keys per tile
constexpr int C = 128;              // channels (the encoder's width)
constexpr int THREADS = 256;
constexpr int T_STRIDE = BQ + 4;    // transposed Q / K tiles: [C][T_STRIDE]
constexpr int V_STRIDE = C + 4;     // V tile: [BK][V_STRIDE]
constexpr int P_STRIDE = BQ + 4;    // transposed P tile: [BK][P_STRIDE]
constexpr size_t SMEM_BYTES =
    sizeof(float) * (2 * C * T_STRIDE + BK * V_STRIDE + BK * P_STRIDE);

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ rid,
                        T* __restrict__ out, int L, int n_rid) {
  extern __shared__ float smem[];
  float* qt = smem;                   // [C][T_STRIDE]   Q tile, transposed
  float* kt = qt + C * T_STRIDE;      // [C][T_STRIDE]   K tile, transposed
  float* vs = kt + C * T_STRIDE;      // [BK][V_STRIDE]  V tile
  float* pt = vs + BK * V_STRIDE;     // [BK][P_STRIDE]  probabilities, transposed

  const int w = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;            // query rows ty*4 .. ty*4+3
  const int tx = tid % 16;            // score cols tx*4 .. +3, output cols tx*8 .. +7
  const size_t base = (size_t)w * L * C;
  const int* rw = rid ? rid + (size_t)(w % n_rid) * L : nullptr;
  const float sqrt_c = sqrtf((float)C);

  for (int i = tid; i < BQ * C; i += THREADS) {
    const int r = i / C, c = i % C;
    qt[c * T_STRIDE + r] = (q0 + r < L) ? load_f(q + base + (size_t)(q0 + r) * C + c) : 0.f;
  }
  int rq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    rq[i] = (rw && qi < L) ? rw[qi] : 0;
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();   // the previous tile's K, V and P are no longer read
    for (int i = tid; i < BK * C; i += THREADS) {
      const int r = i / C, c = i % C;
      const bool ok = k0 + r < L;
      const size_t off = base + (size_t)(k0 + r) * C + c;
      kt[c * T_STRIDE + r] = ok ? load_f(k + off) : 0.f;
      vs[r * V_STRIDE + c] = ok ? load_f(v + off) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[c * T_STRIDE + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&kt[c * T_STRIDE + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        float sc = -INFINITY;
        if (key < L) {
          sc = s[i][j] / sqrt_c;
          if (rw && rw[key] != rq[i]) sc += -100.f;
        }
        s[i][j] = sc;
        mx = fmaxf(mx, sc);
      }
      // the 16 threads of a query row are 16 consecutive lanes
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float scale = expf(m[i] - m_new);   // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * scale + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= scale;
#pragma unroll
      for (int j = 0; j < 4; ++j) pt[(tx * 4 + j) * P_STRIDE + ty * 4 + i] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(&pt[kk * P_STRIDE + ty * 4]);
      const float4 v0 = *reinterpret_cast<const float4*>(&vs[kk * V_STRIDE + tx * 8]);
      const float4 v1 = *reinterpret_cast<const float4*>(&vs[kk * V_STRIDE + tx * 8 + 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= L) continue;
    const float inv = 1.f / l[i];
    T* o = out + base + (size_t)qi * C + tx * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) store_f(o + j, acc[i][j] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* rid,
           void* out, int BW, int L, int channels, int n_rid,
           cudaStream_t stream) {
  if (channels != C || BW <= 0 || L <= 0 || (rid && n_rid <= 0))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + BQ - 1) / BQ, BW);
  window_attention_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(rid),
      static_cast<T*>(out), L, n_rid);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int window_attention_f32(const void* q, const void* k, const void* v,
                                    const void* rid, void* out, int BW, int L,
                                    int channels, int n_rid, void* stream) {
  return launch<float>(q, k, v, rid, out, BW, L, channels, n_rid,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int window_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* rid, void* out, int BW, int L,
                                     int channels, int n_rid, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, rid, out, BW, L, channels, n_rid,
                               static_cast<cudaStream_t>(stream));
}
