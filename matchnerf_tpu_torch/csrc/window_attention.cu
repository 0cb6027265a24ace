// Kernel A / A': single-head window attention of the GMFlow encoder,
// forward (with the per-row logsumexp for training) and backward.
//
// Replaces matchnerf_tpu/ops/pallas_attention.py::flash_window_attention
// (the eval forward) and matchnerf_tpu/ops/pallas_window_attention.py::
// fused_window_attention (the training forward and its custom VJP). Plain
// version, autograd Function and wrapper:
// matchnerf_tpu_torch/ops/window_attention.py.
//
// out[w, i, :] = softmax_j(q_i . k_j / sqrt(C) + mask_ij) v_j, for windows w
// of L tokens and C = 128 channels, where mask_ij = -100 when the region ids
// of tokens i and j differ (shifted layers) and 0 otherwise.
//
// What bounds it: at the DTU shape (24 windows, L = 1280, C = 128) the two
// forward products take 2 * 24 * 1280^2 * 128 * 2 = 20 GFLOP against 24 MB of
// q/k/v, so it is bound by arithmetic, not by bytes (0.020 ms at the bf16
// tensor-core peak); the risk is the [BW, L, L] score matrix (157 MB in f32)
// that the plain version writes and reads back. Both forwards use a
// flash-style online softmax: one block owns 64 queries of one window and
// streams 64-key tiles of K and V through shared memory, so the score matrix
// never reaches device memory. With a non-null `lse` they also write the
// per-row logsumexp of the masked, scaled scores (f32 [BW, L]), all the
// backward keeps besides q, k, v and out (the TPU kernel saves the whole
// [BW, L, L] attention instead).
// - bf16 (the eval and training encoder): on tensor cores, FlashAttention-2
//   style (see "forward on tensor cores" at the end): Q fragments in
//   registers, K/V tiles double-buffered by cp.async, both products as
//   mma.sync with ldmatrix operands, scores and P never leave registers.
// - f32 (the f32 policy only): CUDA-core FP32 FMAs; the 64x64 score tile
//   lives in registers (4x4 per thread) and in a transposed shared tile for
//   the P.V product. It is bound by the 67 TFLOP/s of the CUDA cores.
//
// Backward design (flash-style, two launches, no atomics, so dq, dk and dv
// are the same bits from run to run):
//  1. dq kernel: one block owns 64 queries. It forms D_i = dO_i . O_i
//     (= rowsum(P o dP)) and writes it for launch 2; then it streams 64-key
//     tiles, recomputes S = Q K^T, P = exp(S / sqrt(C) + mask - lse) and
//     dP = dO V^T, forms dS = P o (dP - D) and accumulates
//     dQ = dS K / sqrt(C) in registers.
//  2. dkv kernel: one block owns 64 keys and streams 64-query tiles,
//     recomputing P^T and dP^T the same way, and accumulates dV = P^T dO and
//     dK = dS^T Q / sqrt(C) in registers.
// Each recomputes the two score-sized products (7 products in all against
// the 5 a saved attention needs) and keeps every [L, L] tile on chip; dq,
// dk, dv are written in the input dtype.
// - bf16 (the training encoder): on tensor cores with the forward's operand
//   path (see "backward on tensor cores" at the end): mma.sync with ldmatrix
//   fragments from row-major tiles, streaming tiles in a three-stage
//   cp.async ring, the block's own Q and dO (dq) or K and V (dkv) fragments
//   in registers, dkv split over 8 warps with P^T and dS^T through shared
//   memory; P and dS rounded to bf16 as the TPU kernel rounds them.
// - f32 (the f32 policy only): operands f32 in shared memory, softmax and
//   accumulation f32, register-blocked CUDA-core FMAs.

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
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ rid,
                        T* __restrict__ out, float* __restrict__ lse, int L,
                        int n_rid) {
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
    if (lse && tx == 0) lse[(size_t)w * L + qi] = m[i] + logf(l[i]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* rid,
           void* out, void* lse, int BW, int L, int channels, int n_rid,
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
      static_cast<T*>(out), static_cast<float*>(lse), L, n_rid);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward

constexpr int R_STRIDE = C + 4;     // row-major [rows][R_STRIDE] tiles; 33 float4
                                    // per row, so 8 consecutive rows hit 8 bank groups
constexpr size_t BWD_SMEM_BYTES =
    sizeof(float) * (2 * C * T_STRIDE + 2 * 64 * R_STRIDE + 64 * P_STRIDE + 4 * 64);
constexpr size_t DKV_SMEM_BYTES =
    sizeof(float) * (2 * C * T_STRIDE + 2 * 64 * R_STRIDE + 2 * 64 * P_STRIDE + 4 * 64);

// s[i][j] += sum_c At[c][ty*4+i] * Bs[tx+16j][c]: A transposed ([C][T_STRIDE]),
// B row-major ([64][R_STRIDE]); the 16 threads of a row read B rows tx, tx+16,
// tx+32, tx+48, so a quarter warp's float4 loads fall on distinct banks
__device__ __forceinline__ void tile_dot(const float* At, const float* Bs, int ty,
                                         int tx, float s[4][4]) {
#pragma unroll 2
  for (int c = 0; c < C; c += 4) {
    float a[4][4], b[4][4];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float4 t = *reinterpret_cast<const float4*>(&At[(c + cc) * T_STRIDE + ty * 4]);
      a[cc][0] = t.x; a[cc][1] = t.y; a[cc][2] = t.z; a[cc][3] = t.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 t = *reinterpret_cast<const float4*>(&Bs[(tx + 16 * j) * R_STRIDE + c]);
      b[j][0] = t.x; b[j][1] = t.y; b[j][2] = t.z; b[j][3] = t.w;
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[cc][i], b[j][cc], s[i][j]);
  }
}

// acc[i][j] += sum_kk Pt[kk][ty*4+i] * Bs[kk][tx*8+j], kk over a 64-row tile
__device__ __forceinline__ void tile_acc(const float* Pt, const float* Bs, int ty,
                                         int tx, float acc[4][8]) {
#pragma unroll 4
  for (int kk = 0; kk < 64; ++kk) {
    const float4 p = *reinterpret_cast<const float4*>(&Pt[kk * P_STRIDE + ty * 4]);
    const float4 v0 = *reinterpret_cast<const float4*>(&Bs[kk * R_STRIDE + tx * 8]);
    const float4 v1 = *reinterpret_cast<const float4*>(&Bs[kk * R_STRIDE + tx * 8 + 4]);
    const float pv[4] = {p.x, p.y, p.z, p.w};
    const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
  }
}

// rows r0 .. r0+63 of a [L][C] window into a transposed [C][T_STRIDE] tile
__device__ __forceinline__ void load_t(float* dst, const float* src, int r0, int L, int tid) {
  for (int i = tid; i < 64 * C; i += THREADS) {
    const int r = i / C, c = i % C;
    dst[c * T_STRIDE + r] = (r0 + r < L) ? src[(size_t)(r0 + r) * C + c] : 0.f;
  }
}

// the same rows into a row-major [64][R_STRIDE] tile
__device__ __forceinline__ void load_r(float* dst, const float* src, int r0, int L, int tid) {
  for (int i = tid; i < 64 * C; i += THREADS) {
    const int r = i / C, c = i % C;
    dst[r * R_STRIDE + c] = (r0 + r < L) ? src[(size_t)(r0 + r) * C + c] : 0.f;
  }
}

// P and dS of one score element from its two recomputed products
__device__ __forceinline__ void p_ds(float s, float dp, float lse_q, float d_q,
                                     bool masked, bool valid, float sqrt_c,
                                     float& p, float& ds) {
  float sc = s / sqrt_c;
  if (masked) sc += -100.f;
  p = valid ? expf(sc - lse_q) : 0.f;
  ds = p * (dp - d_q) / sqrt_c;
}

__global__ void __launch_bounds__(THREADS)
window_attention_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const int* __restrict__ rid,
                           const float* __restrict__ out, const float* __restrict__ dout,
                           const float* __restrict__ lse, float* __restrict__ dsum,
                           float* __restrict__ dq, int L, int n_rid) {
  extern __shared__ float smem[];
  float* qt = smem;                   // [C][T_STRIDE]  Q tile, transposed
  float* dot = qt + C * T_STRIDE;     // [C][T_STRIDE]  dO tile, transposed
  float* ks = dot + C * T_STRIDE;     // [64][R_STRIDE] K tile
  float* vs = ks + 64 * R_STRIDE;     // [64][R_STRIDE] V tile
  float* dst = vs + 64 * R_STRIDE;    // [64][P_STRIDE] dS, [key][query]
  float* d_s = dst + 64 * P_STRIDE;   // [64] D of the block's queries

  const int w = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const size_t base = (size_t)w * L * C;
  const int* rw = rid ? rid + (size_t)(w % n_rid) * L : nullptr;
  const float sqrt_c = sqrtf((float)C);

  load_t(qt, q + base, q0, L, tid);
  load_t(dot, dout + base, q0, L, tid);
  // D_i = dO_i . O_i, 4 threads per query row
  {
    const int r = tid / 4, part = tid % 4;
    float d = 0.f;
    if (q0 + r < L) {
      const size_t off = base + (size_t)(q0 + r) * C + part * 32;
      for (int c = 0; c < 32; ++c) d = fmaf(dout[off + c], out[off + c], d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (part == 0) {
      d_s[r] = d;
      if (q0 + r < L) dsum[(size_t)w * L + q0 + r] = d;
    }
  }
  __syncthreads();
  float lq[4], dq_row[4];
  int rq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    lq[i] = qi < L ? lse[(size_t)w * L + qi] : 0.f;
    dq_row[i] = d_s[ty * 4 + i];
    rq[i] = (rw && qi < L) ? rw[qi] : 0;
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();   // the previous tile's K, V and dS are no longer read
    load_r(ks, k + base, k0, L, tid);
    load_r(vs, v + base, k0, L, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_dot(qt, ks, ty, tx, s);
    tile_dot(dot, vs, ty, tx, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      const int rk = (rw && key < L) ? rw[key] : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p, ds;
        p_ds(s[i][j], dp[i][j], lq[i], dq_row[i], rw && rk != rq[i],
             key < L && q0 + ty * 4 + i < L, sqrt_c, p, ds);
        dst[(tx + 16 * j) * P_STRIDE + ty * 4 + i] = ds;
      }
    }
    __syncthreads();
    tile_acc(dst, ks, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= L) continue;
    float* o = dq + base + (size_t)qi * C + tx * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = acc[i][j];
  }
}

__global__ void __launch_bounds__(THREADS)
window_attention_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const int* __restrict__ rid,
                            const float* __restrict__ dout, const float* __restrict__ lse,
                            const float* __restrict__ dsum, float* __restrict__ dk,
                            float* __restrict__ dv, int L, int n_rid) {
  extern __shared__ float smem[];
  float* kt = smem;                   // [C][T_STRIDE]  K tile, transposed
  float* vt = kt + C * T_STRIDE;      // [C][T_STRIDE]  V tile, transposed
  float* qs = vt + C * T_STRIDE;      // [64][R_STRIDE] Q tile
  float* dos = qs + 64 * R_STRIDE;    // [64][R_STRIDE] dO tile
  float* pq = dos + 64 * R_STRIDE;    // [64][P_STRIDE] P, [query][key]
  float* dsq = pq + 64 * P_STRIDE;    // [64][P_STRIDE] dS, [query][key]
  float* l_s = dsq + 64 * P_STRIDE;   // [64] lse of the tile's queries
  float* d_s = l_s + 64;              // [64] D of the tile's queries

  const int w = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const size_t base = (size_t)w * L * C;
  const int* rw = rid ? rid + (size_t)(w % n_rid) * L : nullptr;
  const float sqrt_c = sqrtf((float)C);

  load_t(kt, k + base, k0, L, tid);
  load_t(vt, v + base, k0, L, tid);
  int rk[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    rk[i] = (rw && key < L) ? rw[key] : 0;
  }
  float acc_k[4][8], acc_v[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int q0 = 0; q0 < L; q0 += BQ) {
    __syncthreads();   // the previous tile's Q, dO, P and dS are no longer read
    load_r(qs, q + base, q0, L, tid);
    load_r(dos, dout + base, q0, L, tid);
    if (tid < 64) {
      const bool ok = q0 + tid < L;
      l_s[tid] = ok ? lse[(size_t)w * L + q0 + tid] : 0.f;
      d_s[tid] = ok ? dsum[(size_t)w * L + q0 + tid] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_dot(kt, qs, ty, tx, s);      // S^T: rows are keys, columns queries
    tile_dot(vt, dos, ty, tx, dp);    // dP^T
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ql = tx + 16 * j, qi = q0 + ql;
      const int rq = (rw && qi < L) ? rw[qi] : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p, ds;
        p_ds(s[i][j], dp[i][j], l_s[ql], d_s[ql], rw && rq != rk[i],
             qi < L && k0 + ty * 4 + i < L, sqrt_c, p, ds);
        pq[ql * P_STRIDE + ty * 4 + i] = p;
        dsq[ql * P_STRIDE + ty * 4 + i] = ds;
      }
    }
    __syncthreads();
    tile_acc(pq, dos, ty, tx, acc_v);
    tile_acc(dsq, qs, ty, tx, acc_k);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= L) continue;
    float* ok = dk + base + (size_t)key * C + tx * 8;
    float* ov = dv + base + (size_t)key * C + tx * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ok[j] = acc_k[i][j];
      ov[j] = acc_v[i][j];
    }
  }
}

int launch_bwd(const void* q, const void* k, const void* v, const void* rid,
               const void* out, const void* dout, const void* lse, void* dsum,
               void* dq, void* dk, void* dv, int BW, int L, int channels, int n_rid,
               cudaStream_t stream) {
  if (channels != C || BW <= 0 || L <= 0 || (rid && n_rid <= 0) || !lse || !dsum)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BWD_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      window_attention_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DKV_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + 63) / 64, BW);
  window_attention_dq_kernel<<<grid, THREADS, BWD_SMEM_BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(rid),
      static_cast<const float*>(out), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(dsum), static_cast<float*>(dq),
      L, n_rid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  window_attention_dkv_kernel<<<grid, THREADS, DKV_SMEM_BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(rid),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<float*>(dk), static_cast<float*>(dv), L,
      n_rid);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- tensor-core helpers (bf16)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b for one 16x8x16 tile: a 4 regs (16x16 row-major), b 2 regs
// (16x8 column-major), d 4 f32 (16x8)
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -------------------------------------------- forward on tensor cores (bf16)
//
// FlashAttention-2 style. A block of 4 warps owns 64 queries of one window;
// each warp owns 16 query rows, whose Q fragments it loads once with
// ldmatrix and keeps in registers. 64-key tiles of K and V (bf16, rows
// padded to 272 bytes, so the 8 row addresses of every ldmatrix fall on
// distinct banks) and the tile's 64 key region ids are double-buffered with
// cp.async: the next tile loads while this one computes. S = Q K^T runs as
// mma.sync m16n8k16 (K's B fragments by ldmatrix from its row-major tile)
// and stays in the f32 accumulators; the online softmax works there, in
// base-2 units (scores times log2(e)), with the row max reduced over the 4
// lanes of a row by shuffles and the row sum kept per lane until the end.
// P is rounded to bf16 in registers, its accumulator layout being the A
// fragment of O += P V, whose B fragments come from the row-major V tile by
// ldmatrix.trans. The epilogue divides by the row sum, stages the warp's
// 16 output rows in its rows of the Q tile and stores them with 16-byte
// stores; with a non-null lse it writes m + log(l) per row.

constexpr int FWD_THREADS = 128;
constexpr int FS = C + 8;                        // [64][FS] bf16 tiles
constexpr int FWD_TILE = 64 * FS;
constexpr size_t FWD_SMEM = sizeof(__nv_bfloat16) * 5 * FWD_TILE + sizeof(int) * 2 * 64;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronous; zeros where !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 64 rows from r0 of a [L][C] bf16 window into a [64][FS] tile by NT threads;
// rows past L zero
template <int NT = FWD_THREADS>
__device__ __forceinline__ void cp_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                        int L, int tid) {
#pragma unroll
  for (int i = tid; i < 64 * (C / 8); i += NT) {
    const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
    const bool ok = r0 + r < L;
    cp_async16(dst + r * FS + c8, src + (ok ? (size_t)(r0 + r) * C + c8 : 0), ok);
  }
}

__global__ void __launch_bounds__(FWD_THREADS, 2)
window_attention_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const int* __restrict__ rid, __nv_bfloat16* __restrict__ out,
                                float* __restrict__ lse, int L, int n_rid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [64][FS] Q, then O
  __nv_bfloat16* ks = qs + FWD_TILE;                                 // [2][64][FS]
  __nv_bfloat16* vs = ks + 2 * FWD_TILE;                             // [2][64][FS]
  int* rs = reinterpret_cast<int*>(vs + 2 * FWD_TILE);               // [2][64] key regions

  const int w = blockIdx.y;
  const int q0 = blockIdx.x * 64;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const size_t base = (size_t)w * L * C;
  const int* rw = rid ? rid + (size_t)(w % n_rid) * L : nullptr;
  const int n_tiles = (L + 63) / 64;
  const float scale = LOG2E / sqrtf((float)C);     // scores in base-2 units
  const float mask = -100.f * LOG2E;

  auto load_tile = [&](int tile) {
    const int k0 = tile * 64, st = tile & 1;
    cp_rows(ks + st * FWD_TILE, k + base, k0, L, tid);
    cp_rows(vs + st * FWD_TILE, v + base, k0, L, tid);
    if (rw && tid < 64) cp_async4(rs + st * 64 + tid, rw + min(k0 + tid, L - 1), k0 + tid < L);
  };
  cp_rows(qs, q + base, q0, L, tid);
  cp_async_commit();
  load_tile(0);
  cp_async_commit();

  int rq[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + warp * 16 + g + 8 * h;
    rq[h] = (rw && qi < L) ? rw[qi] : 0;
  }
  cp_async_wait<1>();                   // the Q tile
  __syncthreads();
  uint32_t qf[C / 16][4];               // the warp's 16 x C Q rows as A fragments
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk)
    ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * FS + kk * 16 + (lane >> 4) * 8);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[C / 8][4];
#pragma unroll
  for (int n = 0; n < C / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) load_tile(tile + 1);
    cp_async_commit();
    cp_async_wait<1>();                 // this tile
    __syncthreads();
    const __nv_bfloat16* kt = ks + (tile & 1) * FWD_TILE;
    const __nv_bfloat16* vt = vs + (tile & 1) * FWD_TILE;
    const int* rk = rs + (tile & 1) * 64;
    const int k0 = tile * 64;

    // S = Q K^T: 8 column tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, kt + ((2 * jp + (lane >> 4)) * 8 + (lane & 7)) * FS + kk * 16 +
                       ((lane >> 3) & 1) * 8);
        mma16816(s[2 * jp], qf[kk], b[0], b[1]);
        mma16816(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }

    // scale, then the region mask; keys past L get -inf
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, kl = j * 8 + 2 * t + (e & 1);
        float x = -INFINITY;
        if (k0 + kl < L) x = s[j][e] * scale + ((rw && rk[kl] != rq[h]) ? mask : 0.f);
        s[j][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);    // finite: key k0 < L is valid
      corr[h] = ex2(m[h] - m_new);                // 0 on the first tile
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[j][e] - m[e / 2]);
        s[j][e] = p;
        l[e / 2] += p;
      }
#pragma unroll
    for (int n = 0; n < C / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V: P's accumulator layout is the A fragment of 16 keys
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t a[4] = {pack_bf16(s[2 * i][0], s[2 * i][1]),
                             pack_bf16(s[2 * i][2], s[2 * i][3]),
                             pack_bf16(s[2 * i + 1][0], s[2 * i + 1][1]),
                             pack_bf16(s[2 * i + 1][2], s[2 * i + 1][3])};
#pragma unroll
      for (int np = 0; np < C / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, vt + (i * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * FS +
                         (2 * np + (lane >> 4)) * 8);
        mma16816(acc[2 * np], a, b[0], b[1]);
        mma16816(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();                    // this stage is free for tile + 2
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / l[h];
  }
  __nv_bfloat16* os = qs + warp * 16 * FS;        // the warp's own Q rows
#pragma unroll
  for (int n = 0; n < C / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(os + (g + 8 * h) * FS + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * h] * inv[h], acc[n][2 * h + 1] * inv[h]);
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * (C / 8); i += 32) {
    const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
    const int qi = q0 + warp * 16 + r;
    if (qi < L)
      *reinterpret_cast<int4*>(out + base + (size_t)qi * C + c8) =
          *reinterpret_cast<const int4*>(os + r * FS + c8);
  }
  if (lse && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = q0 + warp * 16 + g + 8 * h;
      if (qi < L) lse[(size_t)w * L + qi] = m[h] / LOG2E + logf(l[h]);
    }
  }
}

int launch_fwd_mma(const void* q, const void* k, const void* v, const void* rid, void* out,
                   void* lse, int BW, int L, int channels, int n_rid, cudaStream_t stream) {
  if (channels != C || BW <= 0 || L <= 0 || (rid && n_rid <= 0) ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(window_attention_fwd_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  using bf = __nv_bfloat16;
  dim3 grid((L + 63) / 64, BW);
  window_attention_fwd_mma_kernel<<<grid, FWD_THREADS, FWD_SMEM, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const int*>(rid), static_cast<bf*>(out), static_cast<float*>(lse), L, n_rid);
  return (int)cudaGetLastError();
}

// ------------------------------------------- backward on tensor cores (bf16)
//
// Replaces the backward of matchnerf_tpu/ops/pallas_window_attention.py::
// fused_window_attention (its bwd pallas_call, which reads the saved
// [BW, L, L] attention). What bounds it: at [24, 1280, 128] the function is
// 5 score-sized products (the S recompute, dP, dV, dQ and dK: 50.3 GFLOP)
// against ~40 MB of inputs and gradients, so operations bound it: 0.0509 ms
// at the bf16 tensor-core peak. Two launches and no atomics (dq, dk and dv
// are the same bits from run to run) cost 7 products, since each launch
// recomputes S and dP.
//
// What the design does about it: every product takes the forward's operand
// path, mma.sync m16n8k16 (bf16 operands, f32 accumulation) fed by
// ldmatrix, and shared-memory reads per mma are kept low, since they, more
// than the tensor cores, set the pace of such a kernel. Every tile is bf16
// and row-major in 272-byte rows, so the 8 row addresses of each ldmatrix
// fall on distinct banks, and no tile is transposed in shared memory: B
// fragments come by ldmatrix where a product reads a tile's rows along its
// K dimension (K and V in S = Q K^T and dP = dO V^T, Q and dO in
// S^T = K Q^T and dP^T = V dO^T) and by ldmatrix.trans where it reads
// columns (K in dQ += dS K, dO and Q in dV += P^T dO and dK += dS^T Q).
// Streaming tiles run in a ring of three stages filled by cp.async,
// zero-filled past L: a tile loads two tiles ahead of its use, and one
// barrier a tile both publishes it and frees the stage it overwrites (the
// third stage first holds the block's own rows, which go to registers).
// P and dS are rounded to bf16 where they become an A operand, as the TPU
// kernel rounds its attention and dS; the softmax is recomputed in base-2
// units (ex2) from the natural-log lse, converted once per row.
//  1. dq: 4 warps x 16 queries, 2 blocks per SM. The warp's Q and dO
//     fragments stay in registers for the whole key loop. While the first
//     tiles load, two lanes per row form D_i = dO_i . O_i from 16-byte
//     loads and write it for launch 2. Per 64-key tile (K, V and the key
//     region ids) and per 32-key half: S and dP in the accumulators,
//     dS = P o (dP - D) in place, whose accumulator layout is the A
//     fragment of dQ += dS K.
//  2. dkv: 8 warps per 64 keys, 1 block per SM; warp w keeps the K and V
//     fragments of keys 16 (w % 4) .. in registers. Per 64-query tile (Q,
//     dO, and the queries' lse, D and region ids) it forms S^T and dP^T for
//     those keys x queries 32 (w / 4) .. and writes P^T and dS^T to shared
//     memory as bf16; after a barrier it accumulates dV += P^T dO and
//     dK += dS^T Q for keys 32 (w % 2) .. x channels 32 (w / 2) .., so each
//     dO and Q fragment feeds two 16-key row tiles: 64 f32 accumulators a
//     thread, and nothing spills.
// 1/sqrt(C) of dQ and dK is applied in the epilogues, which stage the
// gradients in shared memory for 16-byte stores. wgmma, TMA and warp
// specialisation are left for a later change.

constexpr int DQ_THREADS = 128;
constexpr size_t DQ_SMEM = sizeof(__nv_bfloat16) * 6 * FWD_TILE + sizeof(int) * 3 * 64;
constexpr int DKV_THREADS = 256;
constexpr int PS = 64 + 8;                       // [64][PS] bf16 P^T, dS^T: 144-byte rows
constexpr size_t DKV_SMEM = sizeof(__nv_bfloat16) * (6 * FWD_TILE + 2 * 64 * PS) +
                            (2 * sizeof(float) + sizeof(int)) * 3 * 64;

__global__ void __launch_bounds__(DQ_THREADS, 2)
window_attention_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const int* __restrict__ rid,
                               const __nv_bfloat16* __restrict__ out,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse, float* __restrict__ dsum,
                               __nv_bfloat16* __restrict__ dq, int L, int n_rid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // three stages of K and V tiles; the third holds Q and dO until their
  // fragments are in registers, and dQ at the end
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [64][FS] Q, dQ
  __nv_bfloat16* dos = qs + FWD_TILE;                                // [64][FS] dO
  __nv_bfloat16* ks = dos + FWD_TILE;                                // [2][64][FS]
  __nv_bfloat16* vs = ks + 2 * FWD_TILE;                             // [2][64][FS]
  int* rs = reinterpret_cast<int*>(vs + 2 * FWD_TILE);               // [3][64] key regions
  auto k_st = [&](int st) { return st < 2 ? ks + st * FWD_TILE : qs; };
  auto v_st = [&](int st) { return st < 2 ? vs + st * FWD_TILE : dos; };

  const int w = blockIdx.y;
  const int q0 = blockIdx.x * 64;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const size_t base = (size_t)w * L * C;
  const int* rw = rid ? rid + (size_t)(w % n_rid) * L : nullptr;
  const int n_tiles = (L + 63) / 64;
  const float scale = LOG2E / sqrtf((float)C);     // scores in base-2 units
  const float mask = -100.f * LOG2E;

  auto load_tile = [&](int tile) {
    const int k0 = tile * 64, st = tile % 3;
    cp_rows<DQ_THREADS>(k_st(st), k + base, k0, L, tid);
    cp_rows<DQ_THREADS>(v_st(st), v + base, k0, L, tid);
    if (rw && tid < 64) cp_async4(rs + st * 64 + tid, rw + min(k0 + tid, L - 1), k0 + tid < L);
  };
  cp_rows<DQ_THREADS>(qs, q + base, q0, L, tid);
  cp_rows<DQ_THREADS>(dos, dout + base, q0, L, tid);
  cp_async_commit();
  load_tile(0);
  cp_async_commit();
  if (n_tiles > 1) load_tile(1);
  cp_async_commit();

  // D_i = dO_i . O_i: lanes 2r and 2r+1 take 64 channels each of the warp's
  // own query row r, with 16-byte loads
  float d = 0.f;
  {
    const int qi = q0 + tid / 2;
    if (qi < L) {
      const size_t off = base + (size_t)qi * C + (tid & 1) * 64;
      const int4* po = reinterpret_cast<const int4*>(out + off);
      const int4* pd = reinterpret_cast<const int4*>(dout + off);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int4 a = po[i], b = pd[i];
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 fa = __bfloat1622float2(a2[j]), fb = __bfloat1622float2(b2[j]);
          d = fmaf(fa.x, fb.x, d);
          d = fmaf(fa.y, fb.y, d);
        }
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if ((tid & 1) == 0 && qi < L) dsum[(size_t)w * L + qi] = d;
  }
  // this thread's rows m0+g and m0+g+8: D, lse in base-2 units, region
  float dr[2], lr[2];
  int rq[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + warp * 16 + g + 8 * h;
    dr[h] = __shfl_sync(0xffffffffu, d, 2 * g + 16 * h);
    lr[h] = qi < L ? lse[(size_t)w * L + qi] * LOG2E : 0.f;
    rq[h] = (rw && qi < L) ? rw[qi] : 0;
  }

  cp_async_wait<2>();                   // the Q and dO tiles
  __syncthreads();
  uint32_t qf[C / 16][4], df[C / 16][4];  // the warp's 16 rows of Q and dO as A fragments
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    const int off = (warp * 16 + (lane & 15)) * FS + kk * 16 + (lane >> 4) * 8;
    ldsm_x4(qf[kk], qs + off);
    ldsm_x4(df[kk], dos + off);
  }

  float acc[C / 8][4];
#pragma unroll
  for (int n = 0; n < C / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<1>();                 // this tile
    // one barrier a tile: this tile is visible, and every warp is done with
    // the stage that tile + 2 overwrites (tile - 1's, or Q and dO)
    __syncthreads();
    if (tile + 2 < n_tiles) load_tile(tile + 2);
    cp_async_commit();
    const __nv_bfloat16* kt = k_st(tile % 3);
    const __nv_bfloat16* vt = v_st(tile % 3);
    const int* rk = rs + (tile % 3) * 64;
    const int k0 = tile * 64;

#pragma unroll
    for (int kh = 0; kh < 64; kh += 32) {          // 32 keys at a time
      // S = Q K^T and dP = dO V^T: 4 column tiles of 8 keys each
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int off = (kh + (2 * jp + (lane >> 4)) * 8 + (lane & 7)) * FS + kk * 16 +
                          ((lane >> 3) & 1) * 8;
          uint32_t b[4];
          ldsm_x4(b, kt + off);
          mma16816(s[2 * jp], qf[kk], b[0], b[1]);
          mma16816(s[2 * jp + 1], qf[kk], b[2], b[3]);
          ldsm_x4(b, vt + off);
          mma16816(dp[2 * jp], df[kk], b[0], b[1]);
          mma16816(dp[2 * jp + 1], df[kk], b[2], b[3]);
        }

      // dS = P o (dP - D), P = 2^(S scale + mask - lse); keys past L give 0
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kl = kh + j * 8 + 2 * t;
        const int2 r2 = rw ? *reinterpret_cast<const int2*>(rk + kl) : make_int2(0, 0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2;
          const int rkey = (e & 1) ? r2.y : r2.x;
          float p = 0.f;
          if (k0 + kl + (e & 1) < L)
            p = ex2(s[j][e] * scale + ((rw && rkey != rq[h]) ? mask : 0.f) - lr[h]);
          s[j][e] = p * (dp[j][e] - dr[h]);
        }
      }

      // dQ += dS K: dS's accumulator layout is the A fragment of 16 keys;
      // K's B fragments by ldmatrix.trans from its row-major tile
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t a[4] = {pack_bf16(s[2 * i][0], s[2 * i][1]),
                               pack_bf16(s[2 * i][2], s[2 * i][3]),
                               pack_bf16(s[2 * i + 1][0], s[2 * i + 1][1]),
                               pack_bf16(s[2 * i + 1][2], s[2 * i + 1][3])};
#pragma unroll
        for (int np = 0; np < C / 16; ++np) {
          uint32_t b[4];
          ldsm_x4_t(b, kt + (kh + i * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * FS +
                           (2 * np + (lane >> 4)) * 8);
          mma16816(acc[2 * np], a, b[0], b[1]);
          mma16816(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
  }
  __syncthreads();                      // the third stage may hold the last tile

  // dQ / sqrt(C), staged in the warp's own rows of the Q tile
  const float inv_sqrt_c = 1.f / sqrtf((float)C);
  __nv_bfloat16* os = qs + warp * 16 * FS;
#pragma unroll
  for (int n = 0; n < C / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(os + (g + 8 * h) * FS + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * h] * inv_sqrt_c, acc[n][2 * h + 1] * inv_sqrt_c);
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * (C / 8); i += 32) {
    const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
    const int qi = q0 + warp * 16 + r;
    if (qi < L)
      *reinterpret_cast<int4*>(dq + base + (size_t)qi * C + c8) =
          *reinterpret_cast<const int4*>(os + r * FS + c8);
  }
}

__global__ void __launch_bounds__(DKV_THREADS, 1)
window_attention_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const int* __restrict__ rid,
                                const __nv_bfloat16* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ dsum,
                                __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, int L, int n_rid) {
  // three stages of Q and dO tiles; the third holds K and V until their
  // fragments are in registers, and dK and dV at the end
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [64][FS] K, dK
  __nv_bfloat16* vs = ks + FWD_TILE;                                 // [64][FS] V, dV
  __nv_bfloat16* qs = vs + FWD_TILE;                                 // [2][64][FS]
  __nv_bfloat16* dos = qs + 2 * FWD_TILE;                            // [2][64][FS]
  __nv_bfloat16* pt = dos + 2 * FWD_TILE;                            // [64][PS] P^T
  __nv_bfloat16* dst = pt + 64 * PS;                                 // [64][PS] dS^T
  float* ls = reinterpret_cast<float*>(dst + 64 * PS);               // [3][64] queries' lse
  float* dss = ls + 3 * 64;                                          // [3][64] queries' D
  int* rs = reinterpret_cast<int*>(dss + 3 * 64);                    // [3][64] query regions
  auto q_st = [&](int st) { return st < 2 ? qs + st * FWD_TILE : ks; };
  auto do_st = [&](int st) { return st < 2 ? dos + st * FWD_TILE : vs; };

  const int w = blockIdx.y;
  const int k0 = blockIdx.x * 64;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  // S^T and dP^T: keys m0 .. m0+15 x queries 32 half ..;
  // dK and dV: keys 32 kp .. x channels 32 cq ..
  const int m0 = (warp & 3) * 16, half = warp >> 2;
  const int kp = warp & 1, cq = warp >> 1;
  const size_t base = (size_t)w * L * C;
  const int* rw = rid ? rid + (size_t)(w % n_rid) * L : nullptr;
  const int n_tiles = (L + 63) / 64;
  const float scale = LOG2E / sqrtf((float)C);
  const float mask = -100.f * LOG2E;

  auto load_tile = [&](int tile) {
    const int q0 = tile * 64, st = tile % 3;
    cp_rows<DKV_THREADS>(q_st(st), q + base, q0, L, tid);
    cp_rows<DKV_THREADS>(do_st(st), dout + base, q0, L, tid);
    const int r = tid & 63;
    const bool ok = q0 + r < L;
    const size_t qi = (size_t)min(q0 + r, L - 1);
    if (tid < 64)
      cp_async4(ls + st * 64 + r, lse + (size_t)w * L + qi, ok);
    else if (tid < 128)
      cp_async4(dss + st * 64 + r, dsum + (size_t)w * L + qi, ok);
    else if (rw && tid < 192)
      cp_async4(rs + st * 64 + r, rw + qi, ok);
  };
  cp_rows<DKV_THREADS>(ks, k + base, k0, L, tid);
  cp_rows<DKV_THREADS>(vs, v + base, k0, L, tid);
  cp_async_commit();
  load_tile(0);
  cp_async_commit();
  if (n_tiles > 1) load_tile(1);
  cp_async_commit();

  int rk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + m0 + g + 8 * h;
    rk[h] = (rw && key < L) ? rw[key] : 0;
  }
  cp_async_wait<2>();                   // the K and V tiles
  __syncthreads();
  uint32_t kf[C / 16][4], vf[C / 16][4];  // the warp's 16 keys of K and V as A fragments
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    const int off = (m0 + (lane & 15)) * FS + kk * 16 + (lane >> 4) * 8;
    ldsm_x4(kf[kk], ks + off);
    ldsm_x4(vf[kk], vs + off);
  }
  float acc_k[2][4][4], acc_v[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[mt][n][e] = acc_v[mt][n][e] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<1>();                 // this tile
    // this tile is visible, and every warp is done with tile - 1: its stage,
    // which tile + 2 overwrites (or K and V), and P^T and dS^T
    __syncthreads();
    if (tile + 2 < n_tiles) load_tile(tile + 2);
    cp_async_commit();
    const int st = tile % 3;
    const __nv_bfloat16* qt = q_st(st);
    const __nv_bfloat16* dot = do_st(st);
    const float* lt = ls + st * 64;
    const float* dt = dss + st * 64;
    const int* rt = rs + st * 64;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 32 queries
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        const int boff = (half * 32 + (2 * jp + (lane >> 4)) * 8 + (lane & 7)) * FS + kk * 16 +
                         ((lane >> 3) & 1) * 8;
        uint32_t b[4];
        ldsm_x4(b, qt + boff);
        mma16816(s[2 * jp], kf[kk], b[0], b[1]);
        mma16816(s[2 * jp + 1], kf[kk], b[2], b[3]);
        ldsm_x4(b, dot + boff);
        mma16816(dp[2 * jp], vf[kk], b[0], b[1]);
        mma16816(dp[2 * jp + 1], vf[kk], b[2], b[3]);
      }

    // P^T = 2^(S^T scale + mask - lse) and dS^T = P^T o (dP^T - D), as bf16
    // in shared memory. Query rows past L were zero-filled (Q, dO, lse, D),
    // so they add nothing below.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ql = half * 32 + j * 8 + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(lt + ql);
      const float2 d2 = *reinterpret_cast<const float2*>(dt + ql);
      const int2 r2 = rw ? *reinterpret_cast<const int2*>(rt + ql) : make_int2(0, 0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = ex2(s[j][2 * h] * scale + ((rw && r2.x != rk[h]) ? mask : 0.f) -
                             l2.x * LOG2E);
        const float p1 = ex2(s[j][2 * h + 1] * scale + ((rw && r2.y != rk[h]) ? mask : 0.f) -
                             l2.y * LOG2E);
        const int off = (m0 + g + 8 * h) * PS + ql;
        *reinterpret_cast<uint32_t*>(pt + off) = pack_bf16(p0, p1);
        *reinterpret_cast<uint32_t*>(dst + off) =
            pack_bf16(p0 * (dp[j][2 * h] - d2.x), p1 * (dp[j][2 * h + 1] - d2.y));
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q: the warp's 32 keys x 32 channels, K =
    // the tile's 64 queries; dO and Q B fragments by ldmatrix.trans, each
    // feeding both 16-key row tiles
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t ap[2][4], ad[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int aoff = (kp * 32 + mt * 16 + (lane & 15)) * PS + i * 16 + (lane >> 4) * 8;
        ldsm_x4(ap[mt], pt + aoff);
        ldsm_x4(ad[mt], dst + aoff);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int boff = (i * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * FS + cq * 32 +
                         (2 * np + (lane >> 4)) * 8;
        uint32_t b[4];
        ldsm_x4_t(b, dot + boff);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(acc_v[mt][2 * np], ap[mt], b[0], b[1]);
          mma16816(acc_v[mt][2 * np + 1], ap[mt], b[2], b[3]);
        }
        ldsm_x4_t(b, qt + boff);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(acc_k[mt][2 * np], ad[mt], b[0], b[1]);
          mma16816(acc_k[mt][2 * np + 1], ad[mt], b[2], b[3]);
        }
      }
    }
  }
  __syncthreads();                      // the third stage may hold the last tile

  // dK / sqrt(C) and dV, staged in the K and V tiles (read no more)
  const float inv_sqrt_c = 1.f / sqrtf((float)C);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off = (kp * 32 + mt * 16 + g + 8 * h) * FS + cq * 32 + n * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(ks + off) = pack_bf16(
            acc_k[mt][n][2 * h] * inv_sqrt_c, acc_k[mt][n][2 * h + 1] * inv_sqrt_c);
        *reinterpret_cast<uint32_t*>(vs + off) =
            pack_bf16(acc_v[mt][n][2 * h], acc_v[mt][n][2 * h + 1]);
      }
  __syncthreads();
#pragma unroll
  for (int i = tid; i < 64 * (C / 8); i += DKV_THREADS) {
    const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
    if (k0 + r < L) {
      const size_t o = base + (size_t)(k0 + r) * C + c8;
      *reinterpret_cast<int4*>(dk + o) = *reinterpret_cast<const int4*>(ks + r * FS + c8);
      *reinterpret_cast<int4*>(dv + o) = *reinterpret_cast<const int4*>(vs + r * FS + c8);
    }
  }
}

int launch_bwd_mma(const void* q, const void* k, const void* v, const void* rid,
                   const void* out, const void* dout, const void* lse, void* dsum,
                   void* dq, void* dk, void* dv, int BW, int L, int channels, int n_rid,
                   cudaStream_t stream) {
  const uintptr_t addr_bits =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
      reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
      reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  if (channels != C || BW <= 0 || L <= 0 || (rid && n_rid <= 0) || !lse || !dsum ||
      addr_bits % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(window_attention_dq_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(window_attention_dkv_mma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  using bf = __nv_bfloat16;
  dim3 grid((L + 63) / 64, BW);
  window_attention_dq_mma_kernel<<<grid, DQ_THREADS, DQ_SMEM, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const int*>(rid), static_cast<const bf*>(out),
      static_cast<const bf*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(dsum), static_cast<bf*>(dq), L, n_rid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  window_attention_dkv_mma_kernel<<<grid, DKV_THREADS, DKV_SMEM, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const int*>(rid), static_cast<const bf*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum), static_cast<bf*>(dk),
      static_cast<bf*>(dv), L, n_rid);
  return (int)cudaGetLastError();
}

}  // namespace

// lse may be NULL (the eval forward)
extern "C" int window_attention_f32(const void* q, const void* k, const void* v,
                                    const void* rid, void* out, void* lse, int BW,
                                    int L, int channels, int n_rid, void* stream) {
  return launch<float>(q, k, v, rid, out, lse, BW, L, channels, n_rid,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int window_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* rid, void* out, void* lse, int BW,
                                     int L, int channels, int n_rid, void* stream) {
  return launch_fwd_mma(q, k, v, rid, out, lse, BW, L, channels, n_rid,
                        static_cast<cudaStream_t>(stream));
}

// dsum: f32 [BW, L] scratch for D = rowsum(dO o O); dq, dk, dv in the input dtype
extern "C" int window_attention_bwd_f32(const void* q, const void* k, const void* v,
                                        const void* rid, const void* out,
                                        const void* dout, const void* lse, void* dsum,
                                        void* dq, void* dk, void* dv, int BW, int L,
                                        int channels, int n_rid, void* stream) {
  return launch_bwd(q, k, v, rid, out, dout, lse, dsum, dq, dk, dv, BW, L, channels, n_rid,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int window_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                         const void* rid, const void* out,
                                         const void* dout, const void* lse, void* dsum,
                                         void* dq, void* dk, void* dv, int BW, int L,
                                         int channels, int n_rid, void* stream) {
  return launch_bwd_mma(q, k, v, rid, out, dout, lse, dsum, dq, dk, dv, BW, L, channels,
                        n_rid, static_cast<cudaStream_t>(stream));
}
