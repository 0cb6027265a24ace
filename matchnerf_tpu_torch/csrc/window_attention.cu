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
// q/k/v, so it is bound by arithmetic, not by bytes; the risk is the
// [BW, L, L] score matrix (157 MB in f32) that the plain version writes and
// reads back. Every kernel here is flash-style: the score tiles never leave
// the chip. With a non-null `lse` the forwards also write the per-row
// logsumexp of the masked, scaled scores (f32 [BW, L]), all the backward
// keeps besides q, k, v and out (the TPU kernel saves the whole [BW, L, L]
// attention instead).
//
// Backward (two launches, no atomics, so dq, dk and dv are the same bits
// from run to run):
//  1. dq kernel: a block owns a run of queries. It forms D_i = dO_i . O_i
//     (= rowsum(P o dP)) and writes it for launch 2; then it streams key
//     tiles, recomputes S = Q K^T, P = exp(S / sqrt(C) + mask - lse) and
//     dP = dO V^T, forms dS = P o (dP - D) and accumulates
//     dQ = dS K / sqrt(C) in registers.
//  2. dkv kernel: a block owns a run of keys and streams query tiles,
//     recomputing P^T and dP^T the same way, and accumulates dV = P^T dO and
//     dK = dS^T Q / sqrt(C) in registers.
// The function is 5 score-sized products (50.3 GFLOP at the DTU shape);
// the two launches do 7, since each recomputes S and dP.
//
// Two operand types, both on tensor cores with f32 accumulation, softmax
// and logsumexp:
// - bf16 (the eval and training encoder): mma.sync m16n8k16 on bf16
//   operands fed by ldmatrix (see "forward on tensor cores" and "backward
//   on tensor cores" below); P and dS rounded to bf16 as the TPU kernel
//   rounds them. Bound: 0.020 ms forward, 0.051 ms backward at the bf16
//   peak (989 TFLOP/s).
// - f32 (configs/base.yaml's encoder, precision.strict, the f32 training
//   policy): split TF32 (see "f32 on tensor cores" at the end). On CUDA
//   cores the f32 products are bound by the card's 67 TFLOP/s of FP32 FMAs
//   (0.30 ms forward, 0.75 ms backward); a single TF32 product keeps 10
//   mantissa bits (2e-4 to 9e-4 off in the output, against a 1e-5
//   tolerance: tests/test_torch_window_attention.py emulates both), so
//   each f32 product is three TF32 products, hi*hi + hi*lo + lo*hi, on the
//   495 TFLOP/s of the TF32 tensor cores: bound 0.122 ms forward, 0.305 ms
//   backward (5 products). mma.sync and not wgmma: wgmma reads TF32
//   operands from shared memory, so each streamed tile would need hi and
//   lo copies, and transposed ones for the half of the products that read
//   B across rows (wgmma transposes 16-bit types only); they do not fit
//   beside the block's own rows. mma.sync runs TF32 at about two thirds
//   of 495 on this card (profile_attention --mma-peak), and splitting and
//   fragment loads compete with it for instruction slots: that, not the
//   bound, sets the pace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int C = 128;              // channels (the encoder's width)

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


// ---------------------------------------- f32 on tensor cores (split TF32)
//
// Kernel A's f32 forward and Kernel A''s f32 backward. Every product runs as
// mma.sync m16n8k8 on TF32 operands, split: x = hi + lo with hi = x rounded
// to TF32 (as cvt.rna) and lo = x - hi, whose low 13 bits the tensor core
// drops; each f32 product is hi*hi + hi*lo + lo*hi (lo*lo, ~2^-22 of the
// product, is left out). The tensor core truncates as it accumulates, so
// products are summed in zeroed tiles (the small products first) and added
// to the f32 accumulators with f32 adds: per 32-deep group (four k8 steps,
// twelve MMAs) where the contraction runs over the channels, per streamed
// tile (32 or 64 rows) where it runs over keys or queries.
//
// Operands. Tiles stay f32, row-major in 528-byte rows ([rows][TS]), so 8
// consecutive rows start on 8 distinct 4-bank groups. Two kinds of product:
// - contraction over the 128 channels (S = Q K^T, dP = dO V^T, S^T = K Q^T,
//   dP^T = V dO^T): both operands read along their rows, A and B fragments
//   by ldmatrix on 32-bit words (a non-transposing ldmatrix of a K-major
//   f32 tile is a TF32 fragment);
// - contraction over keys or queries (O += P V, dQ += dS K, dV += P^T dO,
//   dK += dS^T Q): A is P or dS straight from the accumulators, with the
//   k-permutation of Kernel C (A slot t <-> column 2t, slot t + 4 <-> column
//   2t + 1), and the B rows are read in the same permuted order; the n8
//   tiles 2m and 2m + 1 take the even and odd channels of 16m .. 16m + 15,
//   so one 8-byte load gives both tiles' B value (8t + 2g spreads a warp's
//   loads over 32 banks), and each row's results leave as 16-byte stores.
// Each warp splits the fragments it loads (3 full-rate instructions a
// value). Splitting the streamed tiles once per block into shared hi and lo
// copies instead leaves room for one stage of them only, doubles the
// fragment loads and spills registers: it ran slower.
//
// Shapes: 8 warps, each owning 16 rows, so a block owns 128 queries (A,
// dq) or 128 keys (dkv), kept in shared memory for the whole launch, and
// streams the other side's tiles through two cp.async stages, zero-filled
// past L: 64 keys a tile in the forward, 32 rows in the backward (its
// block holds two 128-row operands). ~198 KB of shared memory, one block
// per SM. The softmax is online and in base 2 as in the bf16 forward; the
// backward recomputes P from the logsumexp, and dkv sees query rows past L
// zero-filled (Q, dO, lse, D), so they add nothing.

constexpr int TS = C + 4;               // [rows][TS] f32 tiles: 528-byte rows
constexpr int TC_THREADS = 256;         // 8 warps x 16 rows
constexpr int TC_ROWS = 128;            // the block's own rows
constexpr int TC_FK = 64;               // forward key tile
constexpr int TC_BK = 32;               // backward streaming tile
constexpr size_t TC_FWD_SMEM =
    sizeof(float) * (TC_ROWS + 4 * TC_FK) * TS + sizeof(int) * 2 * TC_FK;
constexpr size_t TC_DQ_SMEM =
    sizeof(float) * (2 * TC_ROWS + 4 * TC_BK) * TS + sizeof(int) * 2 * TC_BK;
constexpr size_t TC_DKV_SMEM = sizeof(float) * (2 * TC_ROWS + 4 * TC_BK) * TS +
                               (2 * sizeof(float) + sizeof(int)) * 2 * TC_BK;

// x rounded to TF32, to nearest with ties away from zero: the bits of
// cvt.rna.tf32.f32 from an integer add and a mask, which run at the full
// ALU rate (the conversion does not, and splitting is a third of the
// instructions here)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// d (+)= a * b for one 16x8x8 tile: a 4 regs (16x8 row-major), b 2 regs
// (8x8 column-major), d 4 f32 (16x8)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// A operand of two k8 steps (16 of the contraction); per step a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
struct APair {
  uint32_t hi[2][4], lo[2][4];
  __device__ __forceinline__ void set(int s, const float (&x)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(x[i], hi[s][i], lo[s][i]);
  }
};

// t (=, when first, else +=) A B over two k8 steps, small products first;
// b[s] = {b0 (k = t, n = g), b1 (k = t + 4, n = g)} of step s, raw f32
__device__ __forceinline__ void mma_group_into(float (&t)[4], const APair& a,
                                               const float (&b)[2][2], bool first) {
  uint32_t bh[2][2], bl[2][2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int r = 0; r < 2; ++r) split(b[s][r], bh[s][r], bl[s][r]);
  if (first)
    mma_tf32_zero(t, a.lo[0], bh[0][0], bh[0][1]);
  else
    mma_tf32(t, a.lo[0], bh[0][0], bh[0][1]);
  mma_tf32(t, a.hi[0], bl[0][0], bl[0][1]);
  mma_tf32(t, a.lo[1], bh[1][0], bh[1][1]);
  mma_tf32(t, a.hi[1], bl[1][0], bl[1][1]);
  mma_tf32(t, a.hi[0], bh[0][0], bh[0][1]);
  mma_tf32(t, a.hi[1], bh[1][0], bh[1][1]);
}

// ldmatrix on f32 tiles: each 8x8 b16 matrix is 8 rows of four 32-bit
// words, lane l getting word l % 4 of row l / 4, a TF32 fragment
__device__ __forceinline__ void ldsm_x4_f32(uint32_t (&r)[4], const float* p) {
  ldsm_x4(r, reinterpret_cast<const __nv_bfloat16*>(p));
}

// acc[j] += rows r0 .. r0+15 of A times rows n0 + 8j .. n0 + 8j + 7 of B,
// contracted over the C channels (A, B [rows][TS] f32 tiles); each 32-deep
// group's twelve products go into a zeroed tile, added to acc[j] once
template <int NT>
__device__ __forceinline__ void prod_c(float (&acc)[NT][4], const float* A, int r0,
                                       const float* B, int n0, int lane) {
#pragma unroll 1
  for (int c0 = 0; c0 < C; c0 += 32) {
    APair a[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint32_t x[4];
        ldsm_x4_f32(x, A + (r0 + (lane & 15)) * TS + c0 + 16 * h + 8 * s + 4 * (lane >> 4));
        const float f[4] = {__uint_as_float(x[0]), __uint_as_float(x[1]),
                            __uint_as_float(x[2]), __uint_as_float(x[3])};
        a[h].set(s, f);
      }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float t[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t x[4];
        ldsm_x4_f32(x, B + (n0 + 8 * j + (lane & 7)) * TS + c0 + 16 * h + 4 * (lane >> 3));
        const float b[2][2] = {{__uint_as_float(x[0]), __uint_as_float(x[1])},
                               {__uint_as_float(x[2]), __uint_as_float(x[3])}};
        mma_group_into(t, a[h], b, h == 0);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += t[e];
    }
  }
}

// acc += P B, contracted over the 16 NP rows of P's accumulator tiles
// (p[j]: columns 8j .. 8j + 7) against rows 0 .. 16 NP - 1 of the [rows][TS]
// tile B; acc[2m + e] holds channels 16m + 2n + e (n the accumulator
// column). P is split once; per pair of n8 tiles the 6 NP products go
// into two zeroed tiles, added to acc once.
template <int NP>
__device__ __forceinline__ void prod_r(float (&acc)[C / 8][4], const float (&p)[2 * NP][4],
                                       const float* B, int lane) {
  const int g = lane >> 2, t = lane & 3;
  APair a[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float (&c)[4] = p[2 * i + s];
      const float f[4] = {c[0], c[2], c[1], c[3]};
      a[i].set(s, f);
    }
  const float* b0 = B + 2 * t * TS + 2 * g;
#pragma unroll
  for (int m = 0; m < C / 16; ++m) {
    float te[4], to[4];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      float2 x[2][2];
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          x[s][r] = *reinterpret_cast<const float2*>(b0 + (16 * i + 8 * s + r) * TS + 16 * m);
      const float be[2][2] = {{x[0][0].x, x[0][1].x}, {x[1][0].x, x[1][1].x}};
      const float bo[2][2] = {{x[0][0].y, x[0][1].y}, {x[1][0].y, x[1][1].y}};
      mma_group_into(te, a[i], be, i == 0);
      mma_group_into(to, a[i], bo, i == 0);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * m][e] += te[e];
      acc[2 * m + 1][e] += to[e];
    }
  }
}

// prod_r's accumulators of rows r0 + g (h = 0) and r0 + g + 8 (h = 1), times
// mul[h], to a [L][C] f32 array: one 16-byte store per row and 16 channels
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[C / 8][4], int r0,
                                           int L, const float (&mul)[2], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= L) continue;
#pragma unroll
    for (int m = 0; m < C / 16; ++m)
      *reinterpret_cast<float4*>(dst + (size_t)row * C + 16 * m + 4 * t) =
          make_float4(acc[2 * m][2 * h] * mul[h], acc[2 * m + 1][2 * h] * mul[h],
                      acc[2 * m][2 * h + 1] * mul[h], acc[2 * m + 1][2 * h + 1] * mul[h]);
  }
}

template <int NC>
__device__ __forceinline__ void zero(float (&a)[NC][4]) {
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.f;
}

// n rows from r0 of a [L][C] f32 window into a [n][TS] tile; rows past L zero
__device__ __forceinline__ void cp_rows_f32(float* dst, const float* src, int r0, int n, int L,
                                            int tid) {
  for (int i = tid; i < n * (C / 4); i += TC_THREADS) {
    const int r = i / (C / 4), c4 = (i % (C / 4)) * 4;
    const bool ok = r0 + r < L;
    cp_async16(dst + r * TS + c4, src + (ok ? (size_t)(r0 + r) * C + c4 : 0), ok);
  }
}

__global__ void __launch_bounds__(TC_THREADS, 1)
window_attention_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const int* __restrict__ rid,
                                 float* __restrict__ out, float* __restrict__ lse, int L,
                                 int n_rid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);            // [128][TS] Q
  float* ks = qs + TC_ROWS * TS;                             // [2][64][TS]
  float* vs = ks + 2 * TC_FK * TS;                           // [2][64][TS]
  int* rs = reinterpret_cast<int*>(vs + 2 * TC_FK * TS);     // [2][64] key regions

  const int w = blockIdx.y;
  const int q0 = blockIdx.x * TC_ROWS;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const size_t base = (size_t)w * L * C;
  const int* rw = rid ? rid + (size_t)(w % n_rid) * L : nullptr;
  const int n_tiles = (L + TC_FK - 1) / TC_FK;
  const float scale = LOG2E / sqrtf((float)C);     // scores in base-2 units
  const float mask = -100.f * LOG2E;

  auto load_tile = [&](int tile) {
    const int k0 = tile * TC_FK, st = tile & 1;
    cp_rows_f32(ks + st * TC_FK * TS, k + base, k0, TC_FK, L, tid);
    cp_rows_f32(vs + st * TC_FK * TS, v + base, k0, TC_FK, L, tid);
    if (rw && tid < TC_FK)
      cp_async4(rs + st * TC_FK + tid, rw + min(k0 + tid, L - 1), k0 + tid < L);
  };
  cp_rows_f32(qs, q + base, q0, TC_ROWS, L, tid);
  cp_async_commit();
  load_tile(0);
  cp_async_commit();

  int rq[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + warp * 16 + g + 8 * h;
    rq[h] = (rw && qi < L) ? rw[qi] : 0;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[C / 8][4];
  zero(acc);

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) load_tile(tile + 1);
    cp_async_commit();
    cp_async_wait<1>();                 // Q and this tile
    __syncthreads();
    const float* kt = ks + (tile & 1) * TC_FK * TS;
    const float* vt = vs + (tile & 1) * TC_FK * TS;
    const int* rk = rs + (tile & 1) * TC_FK;
    const int k0 = tile * TC_FK;

    float s[8][4];
    zero(s);
    prod_c<8>(s, qs, warp * 16, kt, 0, lane);

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
    for (int n = 0; n < C / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e / 2];

    prod_r<4>(acc, s, vt, lane);        // O += P V
    __syncthreads();                    // this stage is free for tile + 2
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / l[h];
  }
  store_rows(out + base, acc, q0 + warp * 16, L, inv, lane);
  if (lse && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = q0 + warp * 16 + g + 8 * h;
      if (qi < L) lse[(size_t)w * L + qi] = m[h] / LOG2E + logf(l[h]);
    }
  }
}

int launch_fwd_tf32(const void* q, const void* k, const void* v, const void* rid, void* out,
                    void* lse, int BW, int L, int channels, int n_rid, cudaStream_t stream) {
  if (channels != C || BW <= 0 || L <= 0 || (rid && n_rid <= 0) ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(window_attention_fwd_tf32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TC_FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + TC_ROWS - 1) / TC_ROWS, BW);
  window_attention_fwd_tf32_kernel<<<grid, TC_THREADS, TC_FWD_SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(rid), static_cast<float*>(out), static_cast<float*>(lse), L,
      n_rid);
  return (int)cudaGetLastError();
}

// dq: 8 warps x 16 queries; Q and dO stay in shared memory, 32-key tiles of
// K, V and the key region ids stream. Per tile: S and dP in the
// accumulators, dS = P o (dP - D) in place, dQ += dS K.
__global__ void __launch_bounds__(TC_THREADS, 1)
window_attention_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const int* __restrict__ rid,
                                const float* __restrict__ out, const float* __restrict__ dout,
                                const float* __restrict__ lse, float* __restrict__ dsum,
                                float* __restrict__ dq, int L, int n_rid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);            // [128][TS] Q
  float* dos = qs + TC_ROWS * TS;                            // [128][TS] dO
  float* ks = dos + TC_ROWS * TS;                            // [2][32][TS]
  float* vs = ks + 2 * TC_BK * TS;                           // [2][32][TS]
  int* rs = reinterpret_cast<int*>(vs + 2 * TC_BK * TS);     // [2][32] key regions

  const int w = blockIdx.y;
  const int q0 = blockIdx.x * TC_ROWS;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const size_t base = (size_t)w * L * C;
  const int* rw = rid ? rid + (size_t)(w % n_rid) * L : nullptr;
  const int n_tiles = (L + TC_BK - 1) / TC_BK;
  const float scale = LOG2E / sqrtf((float)C);
  const float mask = -100.f * LOG2E;

  auto load_tile = [&](int tile) {
    const int k0 = tile * TC_BK, st = tile & 1;
    cp_rows_f32(ks + st * TC_BK * TS, k + base, k0, TC_BK, L, tid);
    cp_rows_f32(vs + st * TC_BK * TS, v + base, k0, TC_BK, L, tid);
    if (rw && tid < TC_BK)
      cp_async4(rs + st * TC_BK + tid, rw + min(k0 + tid, L - 1), k0 + tid < L);
  };
  cp_rows_f32(qs, q + base, q0, TC_ROWS, L, tid);
  cp_rows_f32(dos, dout + base, q0, TC_ROWS, L, tid);
  cp_async_commit();
  load_tile(0);
  cp_async_commit();

  // D_i = dO_i . O_i: lanes 2r and 2r+1 take 64 channels each of the warp's
  // own query row r, with 16-byte loads
  float d = 0.f;
  {
    const int qi = q0 + tid / 2;
    if (qi < L) {
      const size_t off = base + (size_t)qi * C + (tid & 1) * 64;
      const float4* po = reinterpret_cast<const float4*>(out + off);
      const float4* pd = reinterpret_cast<const float4*>(dout + off);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float4 a = po[i], b = pd[i];
        d = fmaf(a.x, b.x, d);
        d = fmaf(a.y, b.y, d);
        d = fmaf(a.z, b.z, d);
        d = fmaf(a.w, b.w, d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if ((tid & 1) == 0 && qi < L) dsum[(size_t)w * L + qi] = d;
  }
  // this thread's rows: D, lse in base-2 units, region
  float dr[2], lr[2];
  int rq[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + warp * 16 + g + 8 * h;
    dr[h] = __shfl_sync(0xffffffffu, d, 2 * g + 16 * h);
    lr[h] = qi < L ? lse[(size_t)w * L + qi] * LOG2E : 0.f;
    rq[h] = (rw && qi < L) ? rw[qi] : 0;
  }
  float acc[C / 8][4];
  zero(acc);

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) load_tile(tile + 1);
    cp_async_commit();
    cp_async_wait<1>();                 // Q, dO and this tile
    __syncthreads();
    const float* kt = ks + (tile & 1) * TC_BK * TS;
    const float* vt = vs + (tile & 1) * TC_BK * TS;
    const int* rk = rs + (tile & 1) * TC_BK;
    const int k0 = tile * TC_BK;

    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    prod_c<4>(s, qs, warp * 16, kt, 0, lane);
    prod_c<4>(dp, dos, warp * 16, vt, 0, lane);

    // dS = P o (dP - D), P = 2^(S scale + mask - lse); keys past L give 0
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kl = j * 8 + 2 * t;
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
    prod_r<2>(acc, s, kt, lane);        // dQ += dS K
    __syncthreads();                    // this stage is free for tile + 2
  }

  const float inv_sqrt_c = 1.f / sqrtf((float)C);
  const float mul[2] = {inv_sqrt_c, inv_sqrt_c};
  store_rows(dq + base, acc, q0 + warp * 16, L, mul, lane);
}

// dkv: 8 warps x 16 keys; K and V stay in shared memory, 32-query tiles of
// Q, dO and the queries' lse, D and region ids stream. Per tile: S^T and
// dP^T in the accumulators, P^T and dS^T in place, dV += P^T dO and
// dK += dS^T Q (128 f32 accumulators a thread).
__global__ void __launch_bounds__(TC_THREADS, 1)
window_attention_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const int* __restrict__ rid,
                                 const float* __restrict__ dout, const float* __restrict__ lse,
                                 const float* __restrict__ dsum, float* __restrict__ dk,
                                 float* __restrict__ dv, int L, int n_rid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);            // [128][TS] K
  float* vs = ks + TC_ROWS * TS;                             // [128][TS] V
  float* qs = vs + TC_ROWS * TS;                             // [2][32][TS]
  float* dos = qs + 2 * TC_BK * TS;                          // [2][32][TS]
  float* ls = dos + 2 * TC_BK * TS;                          // [2][32] queries' lse
  float* dss = ls + 2 * TC_BK;                               // [2][32] queries' D
  int* rs = reinterpret_cast<int*>(dss + 2 * TC_BK);         // [2][32] query regions

  const int w = blockIdx.y;
  const int k0 = blockIdx.x * TC_ROWS;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const size_t base = (size_t)w * L * C;
  const int* rw = rid ? rid + (size_t)(w % n_rid) * L : nullptr;
  const int n_tiles = (L + TC_BK - 1) / TC_BK;
  const float scale = LOG2E / sqrtf((float)C);
  const float mask = -100.f * LOG2E;

  auto load_tile = [&](int tile) {
    const int q0 = tile * TC_BK, st = tile & 1;
    cp_rows_f32(qs + st * TC_BK * TS, q + base, q0, TC_BK, L, tid);
    cp_rows_f32(dos + st * TC_BK * TS, dout + base, q0, TC_BK, L, tid);
    const int r = tid % TC_BK;
    const bool ok = q0 + r < L;
    const size_t qi = (size_t)min(q0 + r, L - 1);
    if (tid < TC_BK)
      cp_async4(ls + st * TC_BK + r, lse + (size_t)w * L + qi, ok);
    else if (tid < 2 * TC_BK)
      cp_async4(dss + st * TC_BK + r, dsum + (size_t)w * L + qi, ok);
    else if (rw && tid < 3 * TC_BK)
      cp_async4(rs + st * TC_BK + r, rw + qi, ok);
  };
  cp_rows_f32(ks, k + base, k0, TC_ROWS, L, tid);
  cp_rows_f32(vs, v + base, k0, TC_ROWS, L, tid);
  cp_async_commit();
  load_tile(0);
  cp_async_commit();

  int rk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + warp * 16 + g + 8 * h;
    rk[h] = (rw && key < L) ? rw[key] : 0;
  }
  float acc_k[C / 8][4], acc_v[C / 8][4];
  zero(acc_k);
  zero(acc_v);

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) load_tile(tile + 1);
    cp_async_commit();
    cp_async_wait<1>();                 // K, V and this tile
    __syncthreads();
    const int st = tile & 1;
    const float* qt = qs + st * TC_BK * TS;
    const float* dot = dos + st * TC_BK * TS;
    const float* lt = ls + st * TC_BK;
    const float* dt = dss + st * TC_BK;
    const int* rt = rs + st * TC_BK;

    float s[4][4], dp[4][4];            // S^T and dP^T: the warp's 16 keys x 32 queries
    zero(s);
    zero(dp);
    prod_c<4>(s, ks, warp * 16, qt, 0, lane);
    prod_c<4>(dp, vs, warp * 16, dot, 0, lane);

    // P^T = 2^(S^T scale + mask - lse) and dS^T = P^T o (dP^T - D), in place
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ql = j * 8 + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(lt + ql);
      const float2 d2 = *reinterpret_cast<const float2*>(dt + ql);
      const int2 r2 = rw ? *reinterpret_cast<const int2*>(rt + ql) : make_int2(0, 0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = ex2(s[j][2 * h] * scale + ((rw && r2.x != rk[h]) ? mask : 0.f) -
                             l2.x * LOG2E);
        const float p1 = ex2(s[j][2 * h + 1] * scale + ((rw && r2.y != rk[h]) ? mask : 0.f) -
                             l2.y * LOG2E);
        s[j][2 * h] = p0;
        s[j][2 * h + 1] = p1;
        dp[j][2 * h] = p0 * (dp[j][2 * h] - d2.x);
        dp[j][2 * h + 1] = p1 * (dp[j][2 * h + 1] - d2.y);
      }
    }
    prod_r<2>(acc_v, s, dot, lane);     // dV += P^T dO
    prod_r<2>(acc_k, dp, qt, lane);     // dK += dS^T Q
    __syncthreads();                    // this stage is free for tile + 2
  }

  const float inv_sqrt_c = 1.f / sqrtf((float)C);
  const float mul_k[2] = {inv_sqrt_c, inv_sqrt_c}, mul_v[2] = {1.f, 1.f};
  store_rows(dk + base, acc_k, k0 + warp * 16, L, mul_k, lane);
  store_rows(dv + base, acc_v, k0 + warp * 16, L, mul_v, lane);
}

int launch_bwd_tf32(const void* q, const void* k, const void* v, const void* rid,
                    const void* out, const void* dout, const void* lse, void* dsum, void* dq,
                    void* dk, void* dv, int BW, int L, int channels, int n_rid,
                    cudaStream_t stream) {
  const uintptr_t addr_bits =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
      reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
      reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  if (channels != C || BW <= 0 || L <= 0 || (rid && n_rid <= 0) || !lse || !dsum ||
      addr_bits % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(window_attention_dq_tf32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TC_DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(window_attention_dkv_tf32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TC_DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + TC_ROWS - 1) / TC_ROWS, BW);
  window_attention_dq_tf32_kernel<<<grid, TC_THREADS, TC_DQ_SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(rid), static_cast<const float*>(out),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(dsum), static_cast<float*>(dq), L, n_rid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  window_attention_dkv_tf32_kernel<<<grid, TC_THREADS, TC_DKV_SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(rid), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum), static_cast<float*>(dk),
      static_cast<float*>(dv), L, n_rid);
  return (int)cudaGetLastError();
}

}  // namespace

// lse may be NULL (the eval forward)
extern "C" int window_attention_f32(const void* q, const void* k, const void* v,
                                    const void* rid, void* out, void* lse, int BW,
                                    int L, int channels, int n_rid, void* stream) {
  return launch_fwd_tf32(q, k, v, rid, out, lse, BW, L, channels, n_rid,
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
  return launch_bwd_tf32(q, k, v, rid, out, dout, lse, dsum, dq, dk, dv, BW, L, channels,
                         n_rid, static_cast<cudaStream_t>(stream));
}

extern "C" int window_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                         const void* rid, const void* out,
                                         const void* dout, const void* lse, void* dsum,
                                         void* dq, void* dk, void* dv, int BW, int L,
                                         int channels, int n_rid, void* stream) {
  return launch_bwd_mma(q, k, v, rid, out, dout, lse, dsum, dq, dk, dv, BW, L, channels,
                        n_rid, static_cast<cudaStream_t>(stream));
}
