// Kernel B / B': grouped-cosine matching prior of one feature scale, and
// the gradient of its f32 form with respect to the table.
//
// Replaces matchnerf_tpu/ops/pallas_banded.py::banded_cosine_scale (the
// per-ray banded Pallas kernel of the eval render) and, with the backward
// below, ::banded_cosine_scale_trainable (its custom VJP for training). Plain
// version, autograd Function and wrappers:
// matchnerf_tpu_torch/ops/cosine_prior.py.
//
// For each sample n and each of the V views (V = 2 to 16: n_src_views):
// bilinear sample (align corners, border clamp) of the view's unpacked
// table [V,H,W,(V-1)C] (C = 128, int8, bf16 or f32; or int4: uint8
// [V,H,W,(V-1)C/2], two codes + 8 a byte, channel 2k in byte k's low
// nibble and 2k + 1 in its high one) at grids[v, n], times the
// per-(view, channel) dequantisation scale [V,(V-1)C] where scales are
// given (int8 and int4 tables; NULL for bf16 and f32); then for each of the
// P = V(V-1)/2 pairs (i, j) of pair_index_lists(V) ((0,1), (0,2), (1,2) at
// V = 3; views.cuh) the grouped cosine of view i's chunk j-1 against view
// j's chunk i (eps 1e-8 on each norm), averaged over the pairs. out[n, g],
// f32. The forward is compiled once per V to V = 8 (MAX_V, views.cuh); V = 9
// to 16 (MAX_V_WIDE) share one instance per table type that takes V at run
// time (VT = 0 below): the V = 5 to 8 pair loop with the pair, the row width
// and the pair count found at run time.
//
// What bounds it: instruction issue. Each sample reads 4 taps x V views x
// (V-1)128 channels (3 KB with int8 tables at V = 3, 6 KB with bf16, 12 KB
// with f32) for ~10 K flops; both DTU tables (3.9 MB and 15.7 MB in int8 for
// 3 views) fit
// in the 50 MB L2 and neighbouring samples of a ray hit neighbouring cells,
// so the taps come from L1 and L2, and the SMs' issue slots run out first:
// per tap element a widening and a multiply-add (an int-to-float
// conversion of int8 cost about two issue slots), and per sample and lane
// the three views' coordinates, weights and row addresses, the loads and
// the group reductions. Design: on int8 and bf16 rows eight lanes own one
// sample, each 16 consecutive channels of every (view, chunk), so the
// per-sample work that every lane repeats is paid 8 times, not 16 (f32 rows
// keep 16 lanes of 8 channels); a lane reads its channels of a tap row as
// one 16-byte load (int8), two (bf16, f32), one 8-byte load (int4), the
// sample's lanes one contiguous run. Each view's taps are found once and
// serve its V-1 pairs (to V = 4; past it once a pair, see the kernel).
// int8 taps are converted on the integer pipe, exactly (int8_exact.cuh: a
// byte permute and a subtract, no int-to-float instruction); int4 nibbles
// alike (masked, permuted into 2^23's mantissa, 2^23 + 8 subtracted: the
// code - 8, exactly); bf16 widen by a shift or a mask. The int4 form is
// int8's design on half the bytes, and as issue-bound: at the DTU slice it
// takes the int8 form's time to within 2 % (chip_smoke.py phase 3).
// Each (view, chunk) enters exactly one pair, so a pair's two sides are
// interpolated (f32 weights and sums, as the plain version), dequantised,
// reduced and dropped before the next pair; the pair sum stays in
// registers. Group sums reduce with shuffles inside the group's lanes (on
// 16 channels a lane at G = 16, each 8-channel half is a group). Only
// [N, G] f32 is written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cosine_bwd.cuh"
#include "int8_exact.cuh"
#include "views.cuh"

namespace {

constexpr int C = 128;          // channels per pair chunk; a view's row holds V-1
constexpr int THREADS = 256;
constexpr int LANES = C / 8;    // backward: lanes per sample and pair, 8 channels each

// the forward's channels per lane: 16 on int8 and bf16 rows (8 lanes a
// sample), 8 on f32 rows (16 lanes: 64 bytes of a tap row a lane were
// slower than the 16-lane design's 32)
template <typename T>
__host__ __device__ constexpr int lane_channels() { return sizeof(T) == 4 ? 8 : 16; }

// int4 table rows: one byte holds two channels (see the header)
struct int4x2 {
  uint8_t b;
};

// channels per stored element: a row of CC channels is CC / pack<T>()
// elements, and channel c lives in element c / pack<T>()
template <typename T>
__host__ __device__ constexpr int pack() { return 1; }
template <>
__host__ __device__ constexpr int pack<int4x2>() { return 2; }

// N consecutive table elements as f32
template <int N>
__device__ __forceinline__ void load_run(const int8_t* p, float* f) {
  static_assert(N == 16, "int8 runs are 16 elements");
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  int8x4_to_f32(raw.x, f);
  int8x4_to_f32(raw.y, f + 4);
  int8x4_to_f32(raw.z, f + 8);
  int8x4_to_f32(raw.w, f + 12);
}

// 16 channels of int4 rows, 8 bytes: each nibble goes into the low byte of
// 0x4B000000 (8388608.0f, whose last mantissa bit is worth 1.0) by one
// byte permute, which makes the float 8388608 + code + 8; subtracting
// 8388616.0f leaves the code, for all 16 values
template <int N>
__device__ __forceinline__ void load_run(const int4x2* p, float* f) {
  static_assert(N == 16, "int4 runs are 16 elements");
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const unsigned int w[2] = {raw.x, raw.y};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const unsigned int lo = w[q] & 0x0f0f0f0fu, hi = (w[q] >> 4) & 0x0f0f0f0fu;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      f[8 * q + 2 * b] = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7650u + b)) -
                         8388616.f;
      f[8 * q + 2 * b + 1] = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7650u + b)) -
                             8388616.f;
    }
  }
}

// bf16 stored as its 16 bits (uint16_t): the f32 with the same upper half,
// so widening is exact
template <int N>
__device__ __forceinline__ void load_run(const uint16_t* p, float* f) {
#pragma unroll
  for (int q = 0; q < N / 8; ++q) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + q);
    const unsigned int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      f[8 * q + 2 * h] = __uint_as_float(w[h] << 16);
      f[8 * q + 2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
    }
  }
}

template <int N>
__device__ __forceinline__ void load_run(const float* p, float* f) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p) + q);
    f[4 * q] = a.x; f[4 * q + 1] = a.y; f[4 * q + 2] = a.z; f[4 * q + 3] = a.w;
  }
}

// one view's bilinear taps at one sample: the four rows (element offsets
// into the table of CC-channel rows) and their weights, the plain version's
// rule (clip, floor, border-clamped x1/y1)
struct Taps {
  size_t row[4];
  float w[4];
};

__device__ __forceinline__ Taps view_taps(const float* __restrict__ grids, int v, int n, int N,
                                          int H, int W, int CC) {
  const float gx = grids[((size_t)v * N + n) * 2 + 0];
  const float gy = grids[((size_t)v * N + n) * 2 + 1];
  const float x = fminf(fmaxf((gx + 1.f) * 0.5f * (float)(W - 1), 0.f), (float)(W - 1));
  const float y = fminf(fmaxf((gy + 1.f) * 0.5f * (float)(H - 1), 0.f), (float)(H - 1));
  const float x0f = floorf(x), y0f = floorf(y);
  const float wx1 = x - x0f, wy1 = y - y0f;
  const float wx0 = 1.f - wx1, wy0 = 1.f - wy1;
  const int x0 = (int)x0f, y0 = (int)y0f;
  const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
  const size_t tv = (size_t)v * H * W;
  Taps t;
  t.row[0] = (tv + (size_t)y0 * W + x0) * CC;
  t.row[1] = (tv + (size_t)y0 * W + x1) * CC;
  t.row[2] = (tv + (size_t)y1 * W + x0) * CC;
  t.row[3] = (tv + (size_t)y1 * W + x1) * CC;
  t.w[0] = wy0 * wx0; t.w[1] = wy0 * wx1; t.w[2] = wy1 * wx0; t.w[3] = wy1 * wx1;
  return t;
}

// this lane's N channels (from channel c0 of the row; t's rows are element
// offsets) of one view at one sample, interpolated and, with scales,
// dequantised
template <int N, typename T>
__device__ __forceinline__ void interp_run(const T* __restrict__ table, const Taps& t, int c0,
                                           const float* __restrict__ scale, float* f) {
  float a[N], b[N], c[N], d[N];
  const int e0 = c0 / pack<T>();
  load_run<N>(table + t.row[0] + e0, a);
  load_run<N>(table + t.row[1] + e0, b);
  load_run<N>(table + t.row[2] + e0, c);
  load_run<N>(table + t.row[3] + e0, d);
#pragma unroll
  for (int k = 0; k < N; ++k) f[k] = a[k] * t.w[0] + b[k] * t.w[1] + c[k] * t.w[2] + d[k] * t.w[3];
  if (scale) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 s = __ldg(reinterpret_cast<const float4*>(scale + c0) + q);
      f[4 * q] *= s.x; f[4 * q + 1] *= s.y; f[4 * q + 2] *= s.z; f[4 * q + 3] *= s.w;
    }
  }
}

// dot / (max(|a|, eps) * max(|b|, eps)), eps = 1e-8, as max(|a|^2, eps^2)
// under a reciprocal square root each (a few ulp from the plain version's
// divide, and a fraction of its instructions)
__device__ __forceinline__ float cosine(float dot, float na2, float nb2) {
  return dot * rsqrtf(fmaxf(na2, 1e-16f)) * rsqrtf(fmaxf(nb2, 1e-16f));
}

// VT: the compiled view count (2 to MAX_V), or 0 for V = v_rt at run time
// (MAX_V + 1 to MAX_V_WIDE)
template <typename T, int VT>
__global__ void __launch_bounds__(THREADS)
cosine_prior_kernel(const T* __restrict__ table, const float* __restrict__ grids,
                    const float* __restrict__ scales, float* __restrict__ out,
                    int H, int W, int G, int N, int v_rt) {
  const int V = VT ? VT : v_rt;
  const int CC = (V - 1) * C;            // channels per view table row
  const int RE = CC / pack<T>();          // its stored elements
  const int P = n_pairs(V);
  constexpr int CPL = lane_channels<T>();
  constexpr int SAMPLE_LANES = C / CPL, SAMPLES = THREADS / SAMPLE_LANES;
  constexpr int HALVES = CPL / 8;        // 8-channel halves: the groups at G = 16
  const int lane = threadIdx.x % SAMPLE_LANES;
  const int n_raw = blockIdx.x * SAMPLES + threadIdx.x / SAMPLE_LANES;
  // out-of-range samples still run (clamped) so every shuffle has all lanes
  const int n = min(n_raw, N - 1);
  const int o = lane * CPL;
  // up to V = 4 each view's taps are found once and kept for its V-1 pairs,
  // and the pairs unroll; past that a view's taps are found again for each
  // pair it enters, one pair at a time: 56-80 registers a thread at V = 5
  // to 8, where kept taps (12 registers a view) took 128-255 and one block
  // an SM, 2.4x the time at V = 6 and 8
  constexpr bool KEEP = VT != 0 && VT <= 4;
  Taps kept[KEEP ? VT : 1];
  if constexpr (KEEP) {
#pragma unroll
    for (int v = 0; v < VT; ++v) kept[v] = view_taps(grids, v, n, N, H, W, RE);
  }
  auto taps_of = [&](int v) -> Taps {
    if constexpr (KEEP) return kept[v];
    else return view_taps(grids, v, n, N, H, W, RE);
  };

  // G * CPL <= 128: the lanes_per_group lanes of a group reduce by shuffles;
  // G = 16 with 16 channels a lane: each half of a lane's channels is a group
  const bool by_half = HALVES == 2 && G == 16;
  const int lanes_per_group = by_half ? 1 : C / G / CPL;
  float total[HALVES];
#pragma unroll
  for (int h = 0; h < HALVES; ++h) total[h] = 0.f;
  // pair (i, j): view i's chunk j-1 against view j's chunk i
  auto pair = [&](int p) {
    const int vi = pair_first(V, p), vj = pair_second(V, p), ca = vj - 1, cb = vi;
    float fa[CPL], fb[CPL];
    interp_run<CPL>(table, taps_of(vi), ca * C + o, scales ? scales + vi * CC : nullptr, fa);
    interp_run<CPL>(table, taps_of(vj), cb * C + o, scales ? scales + vj * CC : nullptr, fb);
    float dot[HALVES], na2[HALVES], nb2[HALVES];
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      dot[h] = 0.f; na2[h] = 0.f; nb2[h] = 0.f;
#pragma unroll
      for (int e = 8 * h; e < 8 * h + 8; ++e) {
        dot[h] = fmaf(fa[e], fb[e], dot[h]);
        na2[h] = fmaf(fa[e], fa[e], na2[h]);
        nb2[h] = fmaf(fb[e], fb[e], nb2[h]);
      }
    }
    if (by_half) {
#pragma unroll
      for (int h = 0; h < HALVES; ++h) total[h] += cosine(dot[h], na2[h], nb2[h]);
    } else {
      float d = dot[0], a = na2[0], b = nb2[0];
#pragma unroll
      for (int h = 1; h < HALVES; ++h) { d += dot[h]; a += na2[h]; b += nb2[h]; }
      for (int off = lanes_per_group / 2; off > 0; off >>= 1) {
        d += __shfl_xor_sync(0xffffffffu, d, off);
        a += __shfl_xor_sync(0xffffffffu, a, off);
        b += __shfl_xor_sync(0xffffffffu, b, off);
      }
      total[0] += cosine(d, a, b);
    }
  };
  // past V = 4 one pair at a time: unrolled, the compiler would keep a
  // view's taps live across the pairs it enters, as the kept taps did
  if constexpr (KEEP) {
#pragma unroll
    for (int p = 0; p < n_pairs(VT); ++p) pair(p);
  } else {
#pragma unroll 1
    for (int p = 0; p < P; ++p) pair(p);
  }
  if (n_raw >= N) return;
  if (by_half) {
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
      out[(size_t)n * G + HALVES * lane + h] = total[h] / (float)P;
  } else if (lane % lanes_per_group == 0) {
    out[(size_t)n * G + lane / lanes_per_group] = total[0] / (float)P;
  }
}

bool args_ok(int views, int H, int W, int channels, int G, int N) {
  return views >= MIN_V && views <= MAX_V_WIDE && channels == C && H > 0 && W > 0 && N >= 0 &&
         (G == 1 || G == 2 || G == 4 || G == 8 || G == 16);
}

// VT = 0: the run-time-V instance, at V = views
template <typename T, int VT>
int launch_v(const void* table, const void* grids, const void* scales, void* out, int H,
             int W, int G, int N, int views, cudaStream_t stream) {
  constexpr int SAMPLES = THREADS / (C / lane_channels<T>());
  cosine_prior_kernel<T, VT><<<(N + SAMPLES - 1) / SAMPLES, THREADS, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const float*>(grids),
      static_cast<const float*>(scales), static_cast<float*>(out), H, W, G, N, views);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* table, const void* grids, const void* scales, void* out,
           int views, int H, int W, int channels, int G, int N,
           cudaStream_t stream) {
  if (!args_ok(views, H, W, channels, G, N)) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  switch (views) {
    case 2: return launch_v<T, 2>(table, grids, scales, out, H, W, G, N, views, stream);
    case 3: return launch_v<T, 3>(table, grids, scales, out, H, W, G, N, views, stream);
    case 4: return launch_v<T, 4>(table, grids, scales, out, H, W, G, N, views, stream);
    case 5: return launch_v<T, 5>(table, grids, scales, out, H, W, G, N, views, stream);
    case 6: return launch_v<T, 6>(table, grids, scales, out, H, W, G, N, views, stream);
    case 7: return launch_v<T, 7>(table, grids, scales, out, H, W, G, N, views, stream);
    case 8: return launch_v<T, 8>(table, grids, scales, out, H, W, G, N, views, stream);
    default: return launch_v<T, 0>(table, grids, scales, out, H, W, G, N, views, stream);
  }
}

// ---------------------------------------------------------------- backward
//
// B': d_table of the f32 prior (no dequantisation scales); V (2 to 16) is a
// run-time argument (the pair comes from blockIdx.y). Per sample and pair the same
// 16 lanes recompute the four-tap interpolation of the pair's two sides
// (the forward's tap rule: clip, floor, border-clamped x1/y1), run the
// pair-mean grouped-cosine backward exactly as pallas_banded.py::
// _grouped_cosine_bwd (no gradient through a norm clamped at eps) and owe
// each side's gradient times each bilinear weight to its four tap rows.
// Each (view, chunk) is one side of exactly one pair, so the pairs'
// gradients touch disjoint columns of d_table.
//
// What bounds it: the scatter into d_table. Added one tap at a time it is
// V views x 4 taps x (V-1)32 float4 adds a sample (1.0e8 a launch at 1024
// rays x 128 samples and V = 3), and the 16 samples of a block, consecutive
// samples of one ray, hit the same few cells at once. A ray's consecutive
// samples mostly stay in a cell, so the design sums on chip first, as the
// JAX VJP's per-ray dedup did with its kt buckets:
//
// 1. A block is 8 walks of 16 lanes, all on one pair (blockIdx.y, one of
//    V(V-1)/2), so a lane holds 8 channels of each of the pair's two sides.
//    A walk takes WALK consecutive samples (flat n = ray * S + s: a ray's
//    samples are contiguous) in order.
// 2. Parity slots: a 2x2 footprint holds exactly one cell of each (row
//    parity, column parity), so slot 2*py + px of a side holds the cell of
//    parities (py, px) and a cell that stays in the footprint stays in its
//    slot. A lane keeps each slot's 8-channel sum in registers while the
//    slot's cell stays the same from sample to sample, and ends the run when
//    the cell changes and at the end of the walk: one record per (run,
//    cell), not one add per (sample, tap). No rule assumes monotone rays: a
//    cell that leaves and comes back opens a new run, and any jump ends
//    every slot's run.
// 3. Borders: where x0 = W-1 the tap x1 is clamped onto x0 with weight
//    wx1 = x - x0 = 0 exactly (likewise y), so the slot of the cell past
//    the border (x = W) reads the clamped row with weight 0 and never makes
//    a record (key -1); the other slot holds x0 with its full weight.
// 4. The same sums on every run (training repeats itself, as the JAX step
//    does): a run's sum is not added to d_table with an atomic, whose order
//    changes from run to run. The runs of a (walk, view) depend on the
//    grids alone, so a count pass (cosine_prior_bwd_count) gives each
//    (walk, view) its number of runs and the wrapper's exclusive scan its
//    first record. The walk writes each run as a record at a position fixed
//    by (walk, view, run ordinal): the run's (V-1)C-channel table row, each
//    pair filling its chunk's columns, and its cell. The wrapper sorts the
//    cells, stably, and prior_bwd_reduce_f32 sums each cell's records in
//    that order, the order of their positions, into its d_table row. The
//    records add ~(V-1)C x 4 bytes written and read per run (~0.33 GB each
//    way at scale 1 of configs/train.yaml).
//
// f32 throughout; the result differs from the plain twin only in the order
// of summation. python -m matchnerf_tpu_torch.profile_prior --backward
// counts the runs for the training grids.

constexpr int BWD_THREADS = 128;
constexpr int BWD_WALKS = BWD_THREADS / LANES;    // walks per block
constexpr int WALK = 64;                           // consecutive samples per walk

// the backward's 8 channels of an f32 row
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// one view's footprint at one sample in parity slots (item 2 above): the
// table row of each slot's cell (clamped at the border), its key (the same
// row, or -1 for a cell past the border) and its bilinear weight
struct Foot {
  int row[4], key[4];
  float w[4];
};

__device__ __forceinline__ Foot footprint(const float* __restrict__ grids, int v, int n, int N,
                                          int H, int W) {
  const float gx = grids[((size_t)v * N + n) * 2 + 0];
  const float gy = grids[((size_t)v * N + n) * 2 + 1];
  const float x = fminf(fmaxf((gx + 1.f) * 0.5f * (float)(W - 1), 0.f), (float)(W - 1));
  const float y = fminf(fmaxf((gy + 1.f) * 0.5f * (float)(H - 1), 0.f), (float)(H - 1));
  const float x0f = floorf(x), y0f = floorf(y);
  const float wx[2] = {1.f - (x - x0f), x - x0f}, wy[2] = {1.f - (y - y0f), y - y0f};
  const int x0 = (int)x0f, y0 = (int)y0f;
  Foot f;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int a = (s >> 1) ^ (y0 & 1), b = (s & 1) ^ (x0 & 1);   // tap (y0 + a, x0 + b)
    const int yy = y0 + a, xx = x0 + b;
    f.row[s] = (v * H + min(yy, H - 1)) * W + min(xx, W - 1);
    f.key[s] = yy < H && xx < W ? f.row[s] : -1;
    f.w[s] = (a ? wy[1] : wy[0]) * (b ? wx[1] : wx[0]);
  }
  return f;
}

// 8 channels (from channel c0 of the CC-channel row) of one side, interpolated
__device__ __forceinline__ void interp8(const float* __restrict__ table, const Foot& f, int CC,
                                        int c0, float* out) {
  float r[4][8];
#pragma unroll
  for (int s = 0; s < 4; ++s) load8(table + (size_t)f.row[s] * CC + c0, r[s]);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    out[e] = r[0][e] * f.w[0] + r[1][e] * f.w[1] + r[2][e] * f.w[2] + r[3][e] * f.w[3];
}

// the runs of one walk over one view (item 4 above): the count pass's rule,
// which the records follow in the same order (per sample slots 0..3, then
// the walk's last runs)
__global__ void cosine_prior_bwd_count_kernel(const float* __restrict__ grids,
                                              int* __restrict__ counts, int V, int H, int W,
                                              int N, int walks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= walks * V) return;
  const int walk = i / V, v = i - walk * V;
  int key[4] = {-1, -1, -1, -1}, runs = 0;
  const int n_end = min(N, (walk + 1) * WALK);
#pragma unroll 1
  for (int n = walk * WALK; n < n_end; ++n) {
    const Foot f = footprint(grids, v, n, N, H, W);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (f.key[s] != key[s]) {
        runs += key[s] >= 0;
        key[s] = f.key[s];
      }
    }
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) runs += key[s] >= 0;
  counts[i] = runs;
}

// where one side of a walk writes its runs: record `pos` (the next one of
// its (walk, view)) holds the run's sum in columns col .. col + 7 of its
// (V-1)C-channel row; the side whose chunk is 0 also writes the cell
struct Records {
  float* rec;
  int* keys;
  int pos, CC, col;
  bool key_writer;
  __device__ __forceinline__ void put(int key, const float (&v)[8]) {
    float* dst = rec + (size_t)pos * CC + col;
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
    if (key_writer) keys[pos] = key;
    ++pos;
  }
};

// one side's slots after one more sample: a slot whose cell changed writes
// its run and restarts with this sample's weight times df; a slot that
// keeps its cell accumulates
__device__ __forceinline__ void slot_update(float (&acc)[4][8], int (&key)[4], const Foot& f,
                                            const float* df, Records& out) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const bool changed = f.key[s] != key[s];
    if (changed && key[s] >= 0) out.put(key[s], acc[s]);
    key[s] = f.key[s];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[s][e] = fmaf(f.w[s], df[e], changed ? 0.f : acc[s][e]);
  }
}

__global__ void __launch_bounds__(BWD_THREADS)
cosine_prior_bwd_kernel(const float* __restrict__ table, const float* __restrict__ grids,
                        const float* __restrict__ g, const int* __restrict__ starts,
                        float* __restrict__ rec, int* __restrict__ keys, int V, int H, int W,
                        int G, int N, int walks) {
  const int CC = (V - 1) * C;
  const float inv_p = 1.f / (float)n_pairs(V);    // the mean over the pairs
  const int p = blockIdx.y;
  const int vi = pair_first(V, p), vj = pair_second(V, p), ca = (vj - 1) * C, cb = vi * C;
  const int lane = threadIdx.x % LANES;
  const int walk = blockIdx.x * BWD_WALKS + threadIdx.x / LANES;
  if (walk >= walks) return;              // the whole walk: its 16 lanes leave together
  // the walk's 16 lanes shuffle among themselves only: the two walks of a
  // warp branch apart at their run ends and ends
  const unsigned mask = 0xffffu << (threadIdx.x & 16);
  const int o = lane * 8;
  const int lanes_per_group = LANES / G;
  const int group = lane / lanes_per_group;
  Records out[2] = {{rec, keys, starts[walk * V + vi], CC, ca + o, lane == 0 && ca == 0},
                    {rec, keys, starts[walk * V + vj], CC, cb + o, lane == 0 && cb == 0}};

  float acc[2][4][8];
  int key[2][4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    key[0][s] = key[1][s] = -1;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[0][s][e] = acc[1][s][e] = 0.f;
  }
  const int n_end = min(N, (walk + 1) * WALK);
#pragma unroll 1
  for (int n = walk * WALK; n < n_end; ++n) {
    const Foot ta = footprint(grids, vi, n, N, H, W), tb = footprint(grids, vj, n, N, H, W);
    float fa[8], fb[8];
    interp8(table, ta, CC, ca + o, fa);
    interp8(table, tb, CC, cb + o, fb);
    float dot = 0.f, na2 = 0.f, nb2 = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      dot = fmaf(fa[e], fb[e], dot);
      na2 = fmaf(fa[e], fa[e], na2);
      nb2 = fmaf(fb[e], fb[e], nb2);
    }
    for (int off = lanes_per_group / 2; off > 0; off >>= 1) {
      dot += __shfl_xor_sync(mask, dot, off);
      na2 += __shfl_xor_sync(mask, na2, off);
      nb2 += __shfl_xor_sync(mask, nb2, off);
    }
    float d_dot, d_na2, d_nb2;
    cosine_bwd(g[(size_t)n * G + group] * inv_p, dot, na2, nb2, d_dot, d_na2, d_nb2);
    float dfa[8], dfb[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      dfa[e] = d_dot * fb[e] + 2.f * d_na2 * fa[e];
      dfb[e] = d_dot * fa[e] + 2.f * d_nb2 * fb[e];
    }
    slot_update(acc[0], key[0], ta, dfa, out[0]);
    slot_update(acc[1], key[1], tb, dfb, out[1]);
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (key[0][s] >= 0) out[0].put(key[0][s], acc[0][s]);
    if (key[1][s] >= 0) out[1].put(key[1][s], acc[1][s]);
  }
}

// B' and D''s last pass: one warp per cell of the stably sorted record
// cells, at the first of its records (the others leave); it sums the
// cell's records in their sorted order, which is the order of their
// positions, and writes the sum into the cell's d_table row (rows that no
// record names stay as the caller zeroed them).
__global__ void prior_bwd_reduce_kernel(const int* __restrict__ sorted_keys,
                                        const int64_t* __restrict__ order,
                                        const float* __restrict__ rec,
                                        float* __restrict__ d_table, int R, int CC) {
  const int i = (int)(((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= R) return;
  const int key = sorted_keys[i];
  if (i > 0 && sorted_keys[i - 1] == key) return;
  int end = i + 1;
  while (end < R && sorted_keys[end] == key) ++end;
  for (int c = 4 * lane; c < CC; c += 128) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = i; j < end; ++j) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(rec + (size_t)order[j] * CC + c));
      s.x += x.x; s.y += x.y; s.z += x.z; s.w += x.w;
    }
    *reinterpret_cast<float4*>(d_table + (size_t)key * CC + c) = s;
  }
}

}  // namespace

// B''s count pass: counts [walks * V] int32, the runs of each (walk, view),
// walks = ceil(N / 64)
extern "C" int cosine_prior_bwd_count(const void* grids, void* counts, int views, int H, int W,
                                      int N, void* stream) {
  if (views < MIN_V || views > MAX_V_WIDE || H <= 0 || W <= 0 || N < 0)
    return (int)cudaErrorInvalidValue;
  const int walks = (N + WALK - 1) / WALK;
  if (walks == 0) return (int)cudaGetLastError();
  cosine_prior_bwd_count_kernel<<<(walks * views + 255) / 256, 256, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grids), static_cast<int*>(counts), views, H, W, N, walks);
  return (int)cudaGetLastError();
}

// B''s records: starts [walks * V] int32, the first record of each (walk,
// view) (the exclusive scan of the counts); rec [n_records, (V-1)C] f32 and
// keys [n_records] int32 (each run's table row), every entry written
extern "C" int cosine_prior_bwd_f32(const void* table, const void* grids, const void* g,
                                    const void* starts, void* rec, void* keys, int views,
                                    int H, int W, int channels, int G, int N, void* stream) {
  if (!args_ok(views, H, W, channels, G, N)) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  const int walks = (N + WALK - 1) / WALK;
  const dim3 blocks((walks + BWD_WALKS - 1) / BWD_WALKS, n_pairs(views));
  cosine_prior_bwd_kernel<<<blocks, BWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const float*>(grids),
      static_cast<const float*>(g), static_cast<const int*>(starts), static_cast<float*>(rec),
      static_cast<int*>(keys), views, H, W, G, N, walks);
  return (int)cudaGetLastError();
}

// B' and D''s sum of the records into d_table [*, CC] f32: sorted_keys
// [R] int32 (the records' table rows, stably sorted) and order [R] int64
// (each one's record)
extern "C" int prior_bwd_reduce_f32(const void* sorted_keys, const void* order, const void* rec,
                                    void* d_table, int R, int CC, void* stream) {
  if (R < 0 || CC <= 0 || CC % 4) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaGetLastError();
  const size_t threads = (size_t)R * 32;
  prior_bwd_reduce_kernel<<<(unsigned)((threads + 255) / 256), 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sorted_keys), static_cast<const int64_t*>(order),
      static_cast<const float*>(rec), static_cast<float*>(d_table), R, CC);
  return (int)cudaGetLastError();
}

extern "C" int cosine_prior_i8(const void* table, const void* grids,
                               const void* scales, void* out, int views, int H,
                               int W, int channels, int G, int N, void* stream) {
  return launch<int8_t>(table, grids, scales, out, views, H, W, channels, G, N,
                        static_cast<cudaStream_t>(stream));
}

// bf16 tables (the eval renders of configs/train.yaml: precision.
// cond_sample_dtype defaults to bfloat16), forward only
extern "C" int cosine_prior_bf16(const void* table, const void* grids,
                                 const void* scales, void* out, int views, int H,
                                 int W, int channels, int G, int N, void* stream) {
  return launch<uint16_t>(table, grids, scales, out, views, H, W, channels, G, N,
                          static_cast<cudaStream_t>(stream));
}

// int4 tables (precision.cond_sample_dtype int4 / int4pXX.X), eval only:
// table uint8 [V,H,W,(V-1)C/2], channels = C (128), scales required
extern "C" int cosine_prior_i4(const void* table, const void* grids,
                               const void* scales, void* out, int views, int H,
                               int W, int channels, int G, int N, void* stream) {
  if (scales == nullptr) return (int)cudaErrorInvalidValue;
  return launch<int4x2>(table, grids, scales, out, views, H, W, channels, G, N,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int cosine_prior_f32(const void* table, const void* grids,
                                const void* scales, void* out, int views, int H,
                                int W, int channels, int G, int N, void* stream) {
  return launch<float>(table, grids, scales, out, views, H, W, channels, G, N,
                       static_cast<cudaStream_t>(stream));
}
