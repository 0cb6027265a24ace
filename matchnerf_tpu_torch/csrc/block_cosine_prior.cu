// Kernel D / D': grouped-cosine matching prior of one feature scale, from one
// dilated union of table rows shared by each 8-ray block; D' is its f32
// forward and backward for training.
//
// Replaces matchnerf_tpu/ops/pallas_block_banded.py::block_banded_cosine_scale
// (the block-banded Pallas kernel of the eval render) and
// ::block_banded_cosine_scale_trainable (its custom VJP on f32 tables).
// Plain version, union build, autograd Function and wrappers:
// matchnerf_tpu_torch/ops/block_cosine_prior.py.
//
// Output as Kernel B (csrc/cosine_prior.cu): for each sample n and each of
// the V = 3 views, the bilinear sample (align corners, border clamp) of the
// view's unpacked int8 table [V,H,W,2C] (C = 128), times the per-(view,
// channel) dequantisation scale; for each pair (i, j) in (0,1), (0,2), (1,2)
// the grouped cosine of view i's chunk j-1 against view j's chunk i (eps
// 1e-8 on each norm), averaged over the pairs. out[n, g], f32.
//
// Inputs besides the table: grids [V,Rp,S,2] f32 (Rp = 8*NB, the tail rays
// edge-padded) and unions [V*NB, ut] int32: per (view, 8-ray block) the
// sorted unique cells y0*W+x0 of the block's samples dilated by
// {c, c+1, c+W, c+W+1}, -1 padded. The dilation holds every bilinear tap
// of every sample of the block, border-clamped taps included.
//
// What bounds it: Kernel B gathers 4 taps x 3 views x 256 channels per
// sample from L2. Adjacent rays of a block cross nearly the same table
// rows, so here one block of 512 threads owns one 8-ray block. A prologue
// finds, once per (sample, view) and one thread each, the union rows of the
// sample's four bilinear taps by binary search in the sorted union in
// shared memory (this replaces the TPU kernel's one-hot matmul and sublane
// rolls) and keeps them as four uint16 rows plus the two f32 fractions.
// Then, for each pair, the block copies the two 128-channel chunks the pair
// needs (view i chunk j-1, view j chunk i) of its <= ut union rows into
// shared memory once (<= 2 x 512 x 128 B = 128 KB, dynamic shared memory;
// a zero row after them stands for a tap missing from an overflowed union)
// and gathers the taps from there: table bytes read per block fall from
// ~3 MB to 768 B x ut. A half warp (16 lanes x 8 channels) owns one sample,
// as in Kernel B; interpolation and dequantisation are f32 in registers
// (the TPU kernel rounds its stencil to bf16), the group sums reduce by
// shuffles, and the per-sample sum over pairs stays in shared memory
// ([8*S, G] f32) until the block writes [8, S, G] once. The tap
// coordinates are computed with round-to-nearest intrinsics (no FMA
// contraction) so they equal the torch ops that built the unions bit for
// bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int V = 3;
constexpr int C = 128;          // channels per pair chunk
constexpr int CC = 2 * C;       // channels per view table row
constexpr int LANES = C / 8;    // lanes per sample (8 channels each)
constexpr int THREADS = 512;
constexpr int GROUPS = THREADS / LANES;   // samples in flight per block
constexpr int BLOCK_RAYS = 8;
constexpr int MAX_UT = 512;
constexpr int MAX_SMEM = 232448;          // 227 KB, the sm_90 per-block limit

__device__ __forceinline__ void load8_i8(const int8_t* p, float* f) {
  const int2 raw = *reinterpret_cast<const int2*>(p);
  const int w[2] = {raw.x, raw.y};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[h * 4 + b] = (float)(int8_t)((w[h] >> (8 * b)) & 0xff);
}

// index of `key` in the ascending union u[0..ut) (INT_MAX padded), or
// `ut` (the zero row) when it is missing
__device__ __forceinline__ int find_row(const int* u, int ut, int key) {
  int lo = 0, hi = ut;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (u[mid] < key) lo = mid + 1; else hi = mid;
  }
  return (lo < ut && u[lo] == key) ? lo : ut;
}

// 8 channels (this lane's) of one view's chunk at one sample: taps from the
// staged rows, weights rebuilt from the fractions as
// ops/grid_sample.py::grid_sample_2d forms them, then the dequant scale
__device__ __forceinline__ void interp8(const int8_t* rows, uint2 pos, float2 fr,
                                        int o, const float* scale, float* f) {
  const float wx1 = fr.x, wy1 = fr.y;
  const float wx0 = __fsub_rn(1.f, wx1), wy0 = __fsub_rn(1.f, wy1);
  const float w00 = __fmul_rn(wy0, wx0), w01 = __fmul_rn(wy0, wx1);
  const float w10 = __fmul_rn(wy1, wx0), w11 = __fmul_rn(wy1, wx1);
  float a[8], b[8], c[8], d[8];
  load8_i8(rows + (pos.x & 0xffff) * C + o, a);
  load8_i8(rows + (pos.x >> 16) * C + o, b);
  load8_i8(rows + (pos.y & 0xffff) * C + o, c);
  load8_i8(rows + (pos.y >> 16) * C + o, d);
  const float4 s0 = *reinterpret_cast<const float4*>(scale + o);
  const float4 s1 = *reinterpret_cast<const float4*>(scale + o + 4);
  const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    f[e] = (a[e] * w00 + b[e] * w01 + c[e] * w10 + d[e] * w11) * sc[e];
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

struct Layout {           // dynamic shared memory, in bytes from its start
  size_t rows, taps, fracs, unions, acc, total;
  __host__ __device__ Layout(int ut, int S, int G) {
    const size_t samples = (size_t)BLOCK_RAYS * S;
    rows = 0;                                              // [2][ut+1][C] int8
    taps = align16(rows + (size_t)2 * (ut + 1) * C);       // [V][8S] uint2
    fracs = taps + (size_t)V * samples * sizeof(uint2);    // [V][8S] float2
    unions = fracs + (size_t)V * samples * sizeof(float2); // [V][ut] int
    acc = align16(unions + (size_t)V * ut * sizeof(int));  // [8S][G] f32
    total = acc + samples * G * sizeof(float);
  }
};

__global__ void __launch_bounds__(THREADS)
block_cosine_prior_kernel(const int8_t* __restrict__ table,
                          const float* __restrict__ grids,
                          const float* __restrict__ scales,
                          const int* __restrict__ unions,
                          float* __restrict__ out,
                          int H, int W, int G, int R, int S, int NB, int ut) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(ut, S, G);
  int8_t* rows = reinterpret_cast<int8_t*>(smem + L.rows);
  uint2* taps = reinterpret_cast<uint2*>(smem + L.taps);
  float2* fracs = reinterpret_cast<float2*>(smem + L.fracs);
  int* u_s = reinterpret_cast<int*>(smem + L.unions);
  float* acc = reinterpret_cast<float*>(smem + L.acc);

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % LANES;
  const int grp = tid / LANES;
  const int o = lane * 8;
  const int samples = BLOCK_RAYS * S;
  const int Rp = NB * BLOCK_RAYS;
  const int lanes_per_group = LANES / G;   // G in {1,2,4,8,16}

  for (int i = tid; i < V * ut; i += THREADS) {
    const int v = i / ut, r = i % ut;
    const int c = unions[((size_t)v * NB + blk) * ut + r];
    u_s[i] = c < 0 ? INT_MAX : c;          // ascending with the padding last
  }
  __syncthreads();
  // prologue: each (view, sample)'s four tap rows and its two fractions,
  // clip then floor as ops/grid_sample.py::bilinear_taps computes them
  for (int t = tid; t < V * samples; t += THREADS) {
    const int v = t / samples, nl = t % samples;
    const size_t g = (((size_t)v * Rp + blk * BLOCK_RAYS + nl / S) * S + nl % S) * 2;
    const float x = fminf(fmaxf(__fmul_rn(__fmul_rn(__fadd_rn(grids[g], 1.f), 0.5f),
                                          (float)(W - 1)), 0.f), (float)(W - 1));
    const float y = fminf(fmaxf(__fmul_rn(__fmul_rn(__fadd_rn(grids[g + 1], 1.f), 0.5f),
                                          (float)(H - 1)), 0.f), (float)(H - 1));
    const float x0f = floorf(x), y0f = floorf(y);
    const int x0 = (int)x0f, y0 = (int)y0f;
    const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
    const int* u = u_s + v * ut;
    const int p00 = find_row(u, ut, y0 * W + x0), p01 = find_row(u, ut, y0 * W + x1);
    const int p10 = find_row(u, ut, y1 * W + x0), p11 = find_row(u, ut, y1 * W + x1);
    taps[t] = make_uint2((unsigned)p00 | ((unsigned)p01 << 16),
                         (unsigned)p10 | ((unsigned)p11 << 16));
    fracs[t] = make_float2(__fsub_rn(x, x0f), __fsub_rn(y, y0f));
  }

#pragma unroll 1
  for (int p = 0; p < 3; ++p) {
    const int vi = p == 2 ? 1 : 0, vj = p == 0 ? 1 : 2;   // (0,1), (0,2), (1,2)
    const int ca = vj - 1, cb = vi;        // view i's chunk j-1, view j's chunk i
    __syncthreads();                       // prologue / previous pair done
    // stage both chunks of the union rows, 16 bytes a thread; row ut is zero
    for (int i = tid; i < 2 * (ut + 1) * (C / 16); i += THREADS) {
      const int side = i / ((ut + 1) * (C / 16));
      const int rem = i % ((ut + 1) * (C / 16));
      const int r = rem / (C / 16), part = rem % (C / 16);
      const int v = side ? vj : vi;
      const int chunk = side ? cb : ca;
      const int cell = r < ut ? u_s[v * ut + r] : INT_MAX;
      int4 val = make_int4(0, 0, 0, 0);
      if (cell != INT_MAX)
        val = *reinterpret_cast<const int4*>(
            table + ((size_t)v * H * W + cell) * CC + chunk * C + part * 16);
      *reinterpret_cast<int4*>(rows + ((size_t)side * (ut + 1) + r) * C + part * 16) = val;
    }
    __syncthreads();

    const int8_t* rows_a = rows;
    const int8_t* rows_b = rows + (size_t)(ut + 1) * C;
    for (int base = 0; base < samples; base += GROUPS) {
      const int nl_raw = base + grp;
      const bool active = nl_raw < samples;
      const int nl = active ? nl_raw : samples - 1;   // all lanes reach the shuffles
      float fa[8], fb[8];
      interp8(rows_a, taps[vi * samples + nl], fracs[vi * samples + nl], o,
              scales + vi * CC + ca * C, fa);
      interp8(rows_b, taps[vj * samples + nl], fracs[vj * samples + nl], o,
              scales + vj * CC + cb * C, fb);
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
      const float cosv = dot / (fmaxf(sqrtf(na2), 1e-8f) * fmaxf(sqrtf(nb2), 1e-8f));
      if (active && lane % lanes_per_group == 0) {
        float* a = acc + nl * G + lane / lanes_per_group;
        *a = p == 0 ? cosv : *a + cosv;    // the same thread owns it every pair
      }
    }
  }
  __syncthreads();
  const int valid = min(BLOCK_RAYS, R - blk * BLOCK_RAYS) * S * G;
  float* ob = out + (size_t)blk * BLOCK_RAYS * S * G;
  for (int i = tid; i < valid; i += THREADS) ob[i] = acc[i] / 3.f;
}

// ------------------------------ D': f32 tables, training; D on bf16 tables
//
// The same block, unions and prologue as above, on f32 or bf16 tables
// [V,H,W,2C] with no dequantisation scale. f32 union rows are 4x the int8
// bytes: the two 128-channel chunks of 321 rows (ut 320) would take 321 KB,
// over the 227 KB a block may have. So each pair is staged in passes of CP
// channels (128, 64 or 32; the host picks the widest that fits, see
// ops/block_cosine_prior.py::channels_per_pass), fewer channels per pass,
// the rows unchanged. bf16 union rows (the eval renders of
// configs/train.yaml, whose cond_sample_dtype defaults to bfloat16) are
// staged as bf16, half the f32 bytes, so a pass is twice as wide for the
// same shared memory (CP = 128 up to ut 320 at S = 128, 64 above), and
// widened to f32 in registers; the forward is the same template. A cosine group must lie inside one pass
// (G * CP >= 128), so each pass finishes its groups; the sum over pairs
// accumulates in `out` itself (the same thread owns an output in every
// pair and pass), which frees the [8S, G] shared accumulator.
//
// Backward: per pair and pass the block stages the rows as the forward does
// plus an f32 gradient row of the same width per union row (d_acc, zeroed),
// recomputes each sample's interpolation and group sums, forms the
// grouped-cosine backward (pallas_banded.py::_grouped_cosine_bwd, no
// gradient through a norm clamped at eps), and adds the gradient times each
// bilinear weight into the tap's union row with shared-memory atomics: the
// counterpart of the TPU kernel's per-block d_acc. Each union row then goes
// to d_table once per block with float4 global atomics, so global atomics
// fall by the union's reuse factor (8 rays x S samples x 4 taps per view
// onto <= ut rows). Each (view, chunk) is one side of exactly one pair, so
// every row and channel is flushed once per block. A tap missing from an
// overflowed union (the zero row) adds nothing.

struct LayoutPass {       // dynamic shared memory, in bytes from its start
  size_t rows, dacc, taps, fracs, unions, total;
  __host__ __device__ LayoutPass(int ut, int S, int CP, bool bwd, int esize) {
    const size_t samples = (size_t)BLOCK_RAYS * S;
    const size_t side = (size_t)(ut + 1) * CP * esize;
    rows = 0;                                              // [2][ut+1][CP] table type
    dacc = rows + 2 * side;                                // [2][ut+1][CP] f32 (bwd, f32)
    taps = dacc + (bwd ? 2 * side : 0);                    // [V][8S] uint2
    fracs = taps + (size_t)V * samples * sizeof(uint2);    // [V][8S] float2
    unions = fracs + (size_t)V * samples * sizeof(float2); // [V][ut] int
    total = unions + (size_t)V * ut * sizeof(int);
  }
};

// the unions into shared memory (INT_MAX padded) and the prologue: each
// (view, sample)'s four tap rows and two fractions, as the int8 kernel
__device__ __forceinline__ void block_prologue(const float* __restrict__ grids,
                                               const int* __restrict__ unions,
                                               int* u_s, uint2* taps, float2* fracs,
                                               int H, int W, int S, int NB, int ut,
                                               int blk, int tid) {
  const int samples = BLOCK_RAYS * S;
  const int Rp = NB * BLOCK_RAYS;
  for (int i = tid; i < V * ut; i += THREADS) {
    const int v = i / ut, r = i % ut;
    const int c = unions[((size_t)v * NB + blk) * ut + r];
    u_s[i] = c < 0 ? INT_MAX : c;
  }
  __syncthreads();
  for (int t = tid; t < V * samples; t += THREADS) {
    const int v = t / samples, nl = t % samples;
    const size_t g = (((size_t)v * Rp + blk * BLOCK_RAYS + nl / S) * S + nl % S) * 2;
    const float x = fminf(fmaxf(__fmul_rn(__fmul_rn(__fadd_rn(grids[g], 1.f), 0.5f),
                                          (float)(W - 1)), 0.f), (float)(W - 1));
    const float y = fminf(fmaxf(__fmul_rn(__fmul_rn(__fadd_rn(grids[g + 1], 1.f), 0.5f),
                                          (float)(H - 1)), 0.f), (float)(H - 1));
    const float x0f = floorf(x), y0f = floorf(y);
    const int x0 = (int)x0f, y0 = (int)y0f;
    const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
    const int* u = u_s + v * ut;
    const int p00 = find_row(u, ut, y0 * W + x0), p01 = find_row(u, ut, y0 * W + x1);
    const int p10 = find_row(u, ut, y1 * W + x0), p11 = find_row(u, ut, y1 * W + x1);
    taps[t] = make_uint2((unsigned)p00 | ((unsigned)p01 << 16),
                         (unsigned)p10 | ((unsigned)p11 << 16));
    fracs[t] = make_float2(__fsub_rn(x, x0f), __fsub_rn(y, y0f));
  }
}

// stage CP channels (from channel c0 of the chunk) of both sides' union rows,
// 16 bytes a thread; row ut is zero. With `dacc` (f32 tables), zero the
// gradient rows too.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ table, const int* u_s,
                                           T* rows, float* dacc, int H, int W, int ut,
                                           int CP, int vi, int vj, int ca, int cb, int c0,
                                           int tid) {
  constexpr int EL = 16 / sizeof(T);           // elements per 16 bytes
  const int per_side = (ut + 1) * (CP / EL);
  for (int i = tid; i < 2 * per_side; i += THREADS) {
    const int side = i / per_side, rem = i % per_side;
    const int r = rem / (CP / EL), part = rem % (CP / EL);
    const int v = side ? vj : vi;
    const int chunk = side ? cb : ca;
    const int cell = r < ut ? u_s[v * ut + r] : INT_MAX;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (cell != INT_MAX)
      val = *reinterpret_cast<const uint4*>(
          table + ((size_t)v * H * W + cell) * CC + chunk * C + c0 + part * EL);
    const size_t off = ((size_t)side * (ut + 1) + r) * CP + part * EL;
    *reinterpret_cast<uint4*>(rows + off) = val;
    if (dacc) *reinterpret_cast<float4*>(dacc + off) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// one staged element as f32: bf16 is stored as its 16 bits (uint16_t), the
// f32 with the same upper half, so widening is exact
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t x) {
  return __uint_as_float((unsigned int)x << 16);
}

__device__ __forceinline__ void weights4(float2 fr, float* w) {
  const float wx1 = fr.x, wy1 = fr.y;
  const float wx0 = __fsub_rn(1.f, wx1), wy0 = __fsub_rn(1.f, wy1);
  w[0] = __fmul_rn(wy0, wx0); w[1] = __fmul_rn(wy0, wx1);
  w[2] = __fmul_rn(wy1, wx0); w[3] = __fmul_rn(wy1, wx1);
}

__device__ __forceinline__ int tap_row(uint2 pos, int t) {
  const unsigned h = t < 2 ? pos.x : pos.y;
  return (t & 1) ? (int)(h >> 16) : (int)(h & 0xffff);
}

// CPL channels (this lane's, from o) of one side at one sample, in f32
template <typename T, int CPL>
__device__ __forceinline__ void interp_rows(const T* rows, int CP, uint2 pos, float2 fr,
                                            int o, float* f) {
  float w[4];
  weights4(fr, w);
  const T* a = rows + tap_row(pos, 0) * CP + o;
  const T* b = rows + tap_row(pos, 1) * CP + o;
  const T* c = rows + tap_row(pos, 2) * CP + o;
  const T* d = rows + tap_row(pos, 3) * CP + o;
#pragma unroll
  for (int e = 0; e < CPL; ++e)
    f[e] = widen(a[e]) * w[0] + widen(b[e]) * w[1] + widen(c[e]) * w[2] + widen(d[e]) * w[3];
}

template <typename T, int CPL>
__global__ void __launch_bounds__(THREADS)
block_cosine_prior_pass_kernel(const T* __restrict__ table,
                               const float* __restrict__ grids,
                               const int* __restrict__ unions, float* __restrict__ out,
                               int H, int W, int G, int R, int S, int NB, int ut) {
  constexpr int CP = CPL * LANES;
  extern __shared__ __align__(16) unsigned char smem[];
  const LayoutPass L(ut, S, CP, false, sizeof(T));
  T* rows = reinterpret_cast<T*>(smem + L.rows);
  uint2* taps = reinterpret_cast<uint2*>(smem + L.taps);
  float2* fracs = reinterpret_cast<float2*>(smem + L.fracs);
  int* u_s = reinterpret_cast<int*>(smem + L.unions);

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % LANES;
  const int grp = tid / LANES;
  const int o = lane * CPL;
  const int samples = BLOCK_RAYS * S;
  const int valid = min(BLOCK_RAYS, R - blk * BLOCK_RAYS) * S;
  const int gsize = C / G;                     // channels per group
  const int lanes_per_group = gsize / CPL;     // <= LANES: G * CP >= C
  block_prologue(grids, unions, u_s, taps, fracs, H, W, S, NB, ut, blk, tid);
  float* ob = out + (size_t)blk * BLOCK_RAYS * S * G;

#pragma unroll 1
  for (int p = 0; p < 3; ++p) {
    const int vi = p == 2 ? 1 : 0, vj = p == 0 ? 1 : 2;
    const int ca = vj - 1, cb = vi;
#pragma unroll 1
    for (int c0 = 0; c0 < C; c0 += CP) {
      __syncthreads();                     // prologue / previous pass done
      stage_rows<T>(table, u_s, rows, nullptr, H, W, ut, CP, vi, vj, ca, cb, c0, tid);
      __syncthreads();
      const T* rows_a = rows;
      const T* rows_b = rows + (size_t)(ut + 1) * CP;
      const int group = (c0 + o) / gsize;
      for (int base = 0; base < samples; base += GROUPS) {
        const int nl_raw = base + grp;
        const int nl = nl_raw < samples ? nl_raw : samples - 1;
        float fa[CPL], fb[CPL];
        interp_rows<T, CPL>(rows_a, CP, taps[vi * samples + nl], fracs[vi * samples + nl], o,
                            fa);
        interp_rows<T, CPL>(rows_b, CP, taps[vj * samples + nl], fracs[vj * samples + nl], o,
                            fb);
        float dot = 0.f, na2 = 0.f, nb2 = 0.f;
#pragma unroll
        for (int e = 0; e < CPL; ++e) {
          dot = fmaf(fa[e], fb[e], dot);
          na2 = fmaf(fa[e], fa[e], na2);
          nb2 = fmaf(fb[e], fb[e], nb2);
        }
        for (int off = lanes_per_group / 2; off > 0; off >>= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
          na2 += __shfl_xor_sync(0xffffffffu, na2, off);
          nb2 += __shfl_xor_sync(0xffffffffu, nb2, off);
        }
        const float cosv = dot / (fmaxf(sqrtf(na2), 1e-8f) * fmaxf(sqrtf(nb2), 1e-8f));
        if (nl_raw < valid && lane % lanes_per_group == 0) {
          float* a = ob + (size_t)nl * G + group;
          *a = p == 0 ? cosv : (p == 1 ? *a + cosv : (*a + cosv) / 3.f);
        }
      }
    }
  }
}

template <int CPL>
__global__ void __launch_bounds__(THREADS)
block_cosine_prior_bwd_kernel(const float* __restrict__ table,
                              const float* __restrict__ grids,
                              const int* __restrict__ unions, const float* __restrict__ gout,
                              float* __restrict__ d_table, int H, int W, int G, int R,
                              int S, int NB, int ut) {
  constexpr int CP = CPL * LANES;
  extern __shared__ __align__(16) unsigned char smem[];
  const LayoutPass L(ut, S, CP, true, sizeof(float));
  float* rows = reinterpret_cast<float*>(smem + L.rows);
  float* dacc = reinterpret_cast<float*>(smem + L.dacc);
  uint2* taps = reinterpret_cast<uint2*>(smem + L.taps);
  float2* fracs = reinterpret_cast<float2*>(smem + L.fracs);
  int* u_s = reinterpret_cast<int*>(smem + L.unions);

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % LANES;
  const int grp = tid / LANES;
  const int o = lane * CPL;
  const int samples = BLOCK_RAYS * S;
  const int valid = min(BLOCK_RAYS, R - blk * BLOCK_RAYS) * S;
  const int gsize = C / G;
  const int lanes_per_group = gsize / CPL;
  const float eps = 1e-8f;
  block_prologue(grids, unions, u_s, taps, fracs, H, W, S, NB, ut, blk, tid);
  const float* gb = gout + (size_t)blk * BLOCK_RAYS * S * G;

#pragma unroll 1
  for (int p = 0; p < 3; ++p) {
    const int vi = p == 2 ? 1 : 0, vj = p == 0 ? 1 : 2;
    const int ca = vj - 1, cb = vi;
#pragma unroll 1
    for (int c0 = 0; c0 < C; c0 += CP) {
      __syncthreads();                     // prologue / previous flush done
      stage_rows<float>(table, u_s, rows, dacc, H, W, ut, CP, vi, vj, ca, cb, c0, tid);
      __syncthreads();
      const float* rows_a = rows;
      const float* rows_b = rows + (size_t)(ut + 1) * CP;
      float* dacc_a = dacc;
      float* dacc_b = dacc + (size_t)(ut + 1) * CP;
      const int group = (c0 + o) / gsize;
      for (int base = 0; base < samples; base += GROUPS) {
        const int nl_raw = base + grp;
        const bool active = nl_raw < valid;  // padded rays carry no cotangent
        const int nl = nl_raw < samples ? nl_raw : samples - 1;
        const uint2 ta = taps[vi * samples + nl], tb = taps[vj * samples + nl];
        const float2 fra = fracs[vi * samples + nl], frb = fracs[vj * samples + nl];
        float fa[CPL], fb[CPL];
        interp_rows<float, CPL>(rows_a, CP, ta, fra, o, fa);
        interp_rows<float, CPL>(rows_b, CP, tb, frb, o, fb);
        float dot = 0.f, na2 = 0.f, nb2 = 0.f;
#pragma unroll
        for (int e = 0; e < CPL; ++e) {
          dot = fmaf(fa[e], fb[e], dot);
          na2 = fmaf(fa[e], fa[e], na2);
          nb2 = fmaf(fb[e], fb[e], nb2);
        }
        for (int off = lanes_per_group / 2; off > 0; off >>= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
          na2 += __shfl_xor_sync(0xffffffffu, na2, off);
          nb2 += __shfl_xor_sync(0xffffffffu, nb2, off);
        }
        if (!active) continue;
        const float dcos = gb[(size_t)nl * G + group] * (1.f / 3.f);
        const float sna = sqrtf(na2), snb = sqrtf(nb2);
        const float na = fmaxf(sna, eps), nb = fmaxf(snb, eps);
        const float inv_ab = 1.f / (na * nb);
        const float d_dot = dcos * inv_ab;
        const float d_na2 = sna > eps ? -dcos * dot * inv_ab / na * (0.5f / na) : 0.f;
        const float d_nb2 = snb > eps ? -dcos * dot * inv_ab / nb * (0.5f / nb) : 0.f;
        float wa[4], wb[4];
        weights4(fra, wa);
        weights4(frb, wb);
#pragma unroll
        for (int e = 0; e < CPL; ++e) {
          const float dfa = d_dot * fb[e] + 2.f * d_na2 * fa[e];
          const float dfb = d_dot * fa[e] + 2.f * d_nb2 * fb[e];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            atomicAdd(dacc_a + tap_row(ta, t) * CP + o + e, dfa * wa[t]);
            atomicAdd(dacc_b + tap_row(tb, t) * CP + o + e, dfb * wb[t]);
          }
        }
      }
      __syncthreads();
      // flush: every union row of both sides, once, into d_table
      const int per_side = ut * (CP / 4);
      for (int i = tid; i < 2 * per_side; i += THREADS) {
        const int side = i / per_side, rem = i % per_side;
        const int r = rem / (CP / 4), part = rem % (CP / 4);
        const int v = side ? vj : vi;
        const int cell = u_s[v * ut + r];
        if (cell == INT_MAX) continue;
        const float4 val = *reinterpret_cast<const float4*>(
            dacc + ((size_t)side * (ut + 1) + r) * CP + part * 4);
        float* dst = d_table + ((size_t)v * H * W + cell) * CC + (side ? cb : ca) * C + c0 +
                     part * 4;
#if (__CUDACC_VER_MAJOR__ > 12) || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 4)
        atomicAdd(reinterpret_cast<float4*>(dst), val);
#else
        atomicAdd(dst, val.x); atomicAdd(dst + 1, val.y);
        atomicAdd(dst + 2, val.z); atomicAdd(dst + 3, val.w);
#endif
      }
    }
  }
}

bool pass_args_ok(int views, int channels, int H, int W, int R, int S, int NB, int ut,
                  int G, int CP) {
  return views == V && channels == C && H > 0 && W > 0 && R > 0 && S > 0 &&
         NB * BLOCK_RAYS >= R && ut > 0 && ut <= MAX_UT &&
         (G == 1 || G == 2 || G == 4 || G == 8 || G == 16) &&
         (CP == 32 || CP == 64 || CP == 128) && G * CP >= C && G * CP <= C * LANES;
}

template <typename T, int CPL>
int launch_pass(bool bwd, const void* table, const void* grids, const void* unions,
                const void* gout, void* out, int H, int W, int G, int R, int S, int NB,
                int ut, cudaStream_t stream) {
  const LayoutPass L(ut, S, CPL * LANES, bwd, sizeof(T));
  if (L.total > (size_t)MAX_SMEM || (bwd && sizeof(T) != sizeof(float)))
    return (int)cudaErrorInvalidValue;
  const int blocks = (R + BLOCK_RAYS - 1) / BLOCK_RAYS;
  cudaError_t err;
  if (bwd) {
    err = cudaFuncSetAttribute(block_cosine_prior_bwd_kernel<CPL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (err != cudaSuccess) return (int)err;
    block_cosine_prior_bwd_kernel<CPL><<<blocks, THREADS, L.total, stream>>>(
        static_cast<const float*>(table), static_cast<const float*>(grids),
        static_cast<const int*>(unions), static_cast<const float*>(gout),
        static_cast<float*>(out), H, W, G, R, S, NB, ut);
  } else {
    err = cudaFuncSetAttribute(block_cosine_prior_pass_kernel<T, CPL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (err != cudaSuccess) return (int)err;
    block_cosine_prior_pass_kernel<T, CPL><<<blocks, THREADS, L.total, stream>>>(
        static_cast<const T*>(table), static_cast<const float*>(grids),
        static_cast<const int*>(unions), static_cast<float*>(out), H, W, G, R, S, NB, ut);
  }
  return (int)cudaGetLastError();
}

// T = float (f32 tables, forward or backward) or uint16_t (bf16 tables,
// forward only)
template <typename T>
int dispatch_pass(bool bwd, const void* table, const void* grids, const void* unions,
                  const void* gout, void* out, int views, int H, int W, int channels, int G,
                  int R, int S, int NB, int ut, int CP, void* stream) {
  if (!pass_args_ok(views, channels, H, W, R, S, NB, ut, G, CP))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (CP == 128)
    return launch_pass<T, 8>(bwd, table, grids, unions, gout, out, H, W, G, R, S, NB, ut, st);
  if (CP == 64)
    return launch_pass<T, 4>(bwd, table, grids, unions, gout, out, H, W, G, R, S, NB, ut, st);
  return launch_pass<T, 2>(bwd, table, grids, unions, gout, out, H, W, G, R, S, NB, ut, st);
}

}  // namespace

// D' forward: out [R,S,G] f32; CP channels staged per pass
extern "C" int block_cosine_prior_f32(const void* table, const void* grids,
                                      const void* unions, void* out, int views, int H,
                                      int W, int channels, int G, int R, int S, int NB,
                                      int ut, int CP, void* stream) {
  return dispatch_pass<float>(false, table, grids, unions, nullptr, out, views, H, W,
                              channels, G, R, S, NB, ut, CP, stream);
}

// D on bf16 tables (no scales), forward only: out [R,S,G] f32; CP channels
// staged per pass
extern "C" int block_cosine_prior_bf16(const void* table, const void* grids,
                                       const void* unions, void* out, int views, int H,
                                       int W, int channels, int G, int R, int S, int NB,
                                       int ut, int CP, void* stream) {
  return dispatch_pass<uint16_t>(false, table, grids, unions, nullptr, out, views, H, W,
                                 channels, G, R, S, NB, ut, CP, stream);
}

// D' backward: g [R,S,G] f32 cotangent; d_table [V,H,W,2C] f32, zeroed by the caller
extern "C" int block_cosine_prior_bwd_f32(const void* table, const void* grids,
                                          const void* unions, const void* g, void* d_table,
                                          int views, int H, int W, int channels, int G,
                                          int R, int S, int NB, int ut, int CP,
                                          void* stream) {
  return dispatch_pass<float>(true, table, grids, unions, g, d_table, views, H, W,
                              channels, G, R, S, NB, ut, CP, stream);
}

extern "C" int block_cosine_prior_i8(const void* table, const void* grids,
                                     const void* scales, const void* unions,
                                     void* out, int views, int H, int W,
                                     int channels, int G, int R, int S, int NB,
                                     int ut, void* stream) {
  if (views != V || channels != C || H <= 0 || W <= 0 || R <= 0 || S <= 0 ||
      NB * BLOCK_RAYS < R || ut <= 0 || ut > MAX_UT ||
      !(G == 1 || G == 2 || G == 4 || G == 8 || G == 16))
    return (int)cudaErrorInvalidValue;
  const Layout L(ut, S, G);
  if (L.total > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      block_cosine_prior_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (R + BLOCK_RAYS - 1) / BLOCK_RAYS;
  block_cosine_prior_kernel<<<blocks, THREADS, L.total,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(table), static_cast<const float*>(grids),
      static_cast<const float*>(scales), static_cast<const int*>(unions),
      static_cast<float*>(out), H, W, G, R, S, NB, ut);
  return (int)cudaGetLastError();
}
