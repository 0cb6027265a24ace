// Kernel D / D': grouped-cosine matching prior of one feature scale, from one
// dilated union of table rows shared by each 8-ray block; D' is its f32
// forward and backward for training.
//
// Replaces matchnerf_tpu/ops/pallas_block_banded.py::block_banded_cosine_scale
// (the block-banded Pallas kernel of the eval render) and
// ::block_banded_cosine_scale_trainable (its custom VJP on f32 tables).
// Plain version, autograd Function and wrappers:
// matchnerf_tpu_torch/ops/block_cosine_prior.py.
//
// Output as Kernel B (csrc/cosine_prior.cu): for each sample n and each of
// the V views (V = 2 to 8, a run-time argument), the bilinear sample
// (align corners, border clamp) of the view's unpacked table [V,H,W,(V-1)C]
// (C = 128; int8 with a per-(view, channel) dequantisation scale
// [V,(V-1)C] after the interpolation, bf16 or f32 without); for each of
// the P = V(V-1)/2 pairs (i, j) of pair_index_lists(V) (views.cuh) the
// grouped cosine of view i's chunk j-1 against view j's chunk i (eps 1e-8
// on each norm), averaged over the pairs. out[n, g], f32. grids [V,R,S,2]
// f32; the tail block repeats the last ray (the edge padding of the plain
// version).
//
// What bounds it: instruction issue in the sample loops (three quarters of
// a block's cycles at the eval buckets; the union build and the staging
// take the rest: python -m matchnerf_tpu_torch.profile_prior --phases).
// Kernel B gathers 4 taps x V views x (V-1)128 channels per sample from L2 and,
// on int8 tables, converts each one. Adjacent rays of a block cross nearly
// the same table rows, so one block of 512 threads owns one 8-ray block and
// works from the block's union of table rows, where a tap element costs a
// shared-memory load share, a widening and a multiply-add:
//
// 1. Union, in the kernel (what ops/block_cosine_prior.py::block_union_cells
//    builds with torch sorts, for the plain version). Per view a bitmap of
//    the table's H*W cells takes the base cell y0*W + x0 of each of the 8*S
//    samples; a block-wide scan of the words' popcounts ranks the set bits,
//    so the first ut of them in ascending order are the capped sorted
//    unique cells. Those are dilated by {c, c+1, c+W, c+W+1} (below H*W)
//    into a fresh bitmap, ranked again, and its first ut cells are the
//    union. A sample's tap is found by its bit and its rank (prefix count
//    plus the popcount below it in its word): no search. A tap whose cell
//    is missing or ranks at ut or later (an overflowed union) reads the
//    zero row ut and adds 0, as in the plain version. The coordinates use
//    round-to-nearest intrinsics (no FMA contraction), so the cells equal
//    the plain version's bit for bit. The bitmaps and scan live in the
//    staging area until the first pass overwrites them. With `unions_out`
//    (D''s forward) the union is written to [V*NB, ut] int32, -1 padded,
//    for D''s backward.
// 2. Staging, once per pair and pass: the CP channels (128, 64 or 32; the
//    host picks the widest that fits at this V, ops/block_cosine_prior.py::
//    channels_per_pass) of the pair's two chunks of the <= ut union rows go
//    to shared memory as 16-bit bf16 (int8 and bf16 tables) or f32 (f32
//    tables). bf16 and f32 rows arrive by cp.async, 16 bytes a copy; int8
//    rows pass through registers and are converted there, exactly
//    (int8_exact.cuh: a byte permute and a subtract, no int-to-float
//    instruction), once per staged element instead of once per tap (8 rays
//    x 128 samples x 4 taps against <= ut rows). A bf16 element widens to
//    f32 with a shift or a mask on the integer pipe.
// 3. Per sample, eight lanes (CP/8 channels each, in the slots of
//    pair_cosine8 below, so the 8 lanes of a slot read one 128-byte run of a
//    staged row: no bank conflicts) interpolate both sides from the staged
//    rows in f32 (the TPU kernel rounds its stencil to bf16), dequantise
//    int8 rows by the scale after the interpolation, reduce each cosine
//    group by shuffles (a group lies inside one pass: G * CP >= 128) and add
//    its cosine into `out` itself (the same lane owns an output in every
//    pair and pass; it fetches the pair sum so far one sample ahead).
//    Eight lanes, not sixteen, pay the per-sample work that every lane
//    repeats (tap rows, weights, reductions, the norms' reciprocal square
//    roots) half as often.
//
// Shared memory (LayoutFwd), at the eval pose's buckets, S = 128 and V = 3:
// rows 2 x (ut+1) x CP x 2 B (ut 320, CP 128: 164,352 B; at ut 160 82,432
// B), taps [V][8S] uint2 (24,576 B: four 16-bit union rows each), fractions
// [V][8S] float2 (24,576 B), the union [V][ut] int32 (3,840 B at ut 320):
// 217,344 B of the 232,448 a block may have at ut 320, one block per SM.
// Wider unions stage 64 channels a pass; so does V = 4 at ut 320 (its taps,
// fractions and union take 70,656 B), and every V from 4 to 8 at ut 320
// (V = 8: 141,312 B of them). The union scratch needs
// (2 V ceil(H*W/32) + 32) x 4 B (15,488 B for a 128 x 160 table at V = 3)
// and takes the larger of the two in the rows' place.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <limits.h>

#include "cosine_bwd.cuh"
#include "int8_exact.cuh"
#include "views.cuh"

namespace {

constexpr int C = 128;          // channels per pair chunk; a view's row holds V-1
constexpr int LANES = 8;        // forward: lanes per sample (pair_cosine8)
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int GROUPS = THREADS / LANES;           // samples in flight per block
constexpr int BLOCK_RAYS = 8;
constexpr int MAX_UT = 512;
constexpr int MAX_SMEM = 232448;          // 227 KB, the sm_90 per-block limit

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

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

// a sample's pixel coordinates, clip then floor as
// ops/grid_sample.py::bilinear_taps computes them, rounded step by step
__device__ __forceinline__ void sample_xy(const float* __restrict__ grids, size_t g, int H,
                                          int W, float& x, float& y) {
  x = fminf(fmaxf(__fmul_rn(__fmul_rn(__fadd_rn(grids[g], 1.f), 0.5f), (float)(W - 1)), 0.f),
            (float)(W - 1));
  y = fminf(fmaxf(__fmul_rn(__fmul_rn(__fadd_rn(grids[g + 1], 1.f), 0.5f), (float)(H - 1)),
                  0.f), (float)(H - 1));
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

// The grouped cosine of one pair at one sample, eight lanes a sample.
//
// Slot layout: lane l (0-7, the sample's lanes are 8-aligned in the warp)
// holds NS slots of SW consecutive channels; slot k holds channels
// k*8*SW + l*SW .. +SW-1 of the CP = 8*NS*SW channels in hand, so the 8
// lanes of one slot read 8*SW consecutive channels of a row together (one
// 128-byte run of 16-byte loads, or 64 bytes of 8-byte ones). Groups are
// C/G consecutive channels (C = 128): a group narrower than a slot row spans
// gsize/SW lanes of one slot, which reduce by xor shuffles; a wider one
// spans gsize/(8*SW) slots of every lane, which sum first. The group's first
// lane and slot own its cosine (slot_group), the same lane and slot at every
// call. tests/test_torch_block_cosine_prior.py emulates this layout in numpy.
template <int SW>
struct SlotGroups {
  int gsize, spg, lpg;     // channels, slots and lanes per group
  __device__ __forceinline__ explicit SlotGroups(int G)
      : gsize(C / G), spg(C / G > 8 * SW ? C / G / (8 * SW) : 1),
        lpg(C / G > 8 * SW ? 8 : C / G / SW) {}
  // the group slot k of this lane owns at chunk channel c0, or -1
  __device__ __forceinline__ int slot_group(int k, int lane, int c0) const {
    return lane % lpg == 0 && k % spg == 0 ? (c0 + k * 8 * SW + lane * SW) / gsize : -1;
  }
};

// dot / (max(|a|, eps) * max(|b|, eps)), eps = 1e-8, as max(|a|^2, eps^2)
// under a reciprocal square root each (a few ulp from the plain version's
// divide, and a fraction of its instructions)
__device__ __forceinline__ float group_cosine(float dot, float na2, float nb2) {
  return dot * rsqrtf(fmaxf(na2, 1e-16f)) * rsqrtf(fmaxf(nb2, 1e-16f));
}

// fa, fb: [NS*SW] this lane's channels of the pair's two sides -> cosv[k],
// the cosine of the group slot k owns (meaningless where it owns none);
// every lane of the warp calls it
template <int NS, int SW>
__device__ __forceinline__ void pair_cosine8(const float* fa, const float* fb,
                                             const SlotGroups<SW>& sg, float* cosv) {
  float d[NS], a[NS], b[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    d[k] = 0.f; a[k] = 0.f; b[k] = 0.f;
#pragma unroll
    for (int e = 0; e < SW; ++e) {
      const float x = fa[k * SW + e], y = fb[k * SW + e];
      d[k] = fmaf(x, y, d[k]);
      a[k] = fmaf(x, x, a[k]);
      b[k] = fmaf(y, y, b[k]);
    }
  }
#pragma unroll
  for (int s = 1; s < NS; s <<= 1) {
    if (s < sg.spg) {
      float td[NS], ta[NS], tb[NS];
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        td[k] = d[k] + d[k ^ s]; ta[k] = a[k] + a[k ^ s]; tb[k] = b[k] + b[k ^ s];
      }
#pragma unroll
      for (int k = 0; k < NS; ++k) { d[k] = td[k]; a[k] = ta[k]; b[k] = tb[k]; }
    }
  }
  for (int off = sg.lpg / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      d[k] += __shfl_xor_sync(0xffffffffu, d[k], off);
      a[k] += __shfl_xor_sync(0xffffffffu, a[k], off);
      b[k] += __shfl_xor_sync(0xffffffffu, b[k], off);
    }
  }
#pragma unroll
  for (int k = 0; k < NS; ++k) cosv[k] = group_cosine(d[k], a[k], b[k]);
}

// ------------------------------------------------- D and D''s forward
struct LayoutFwd {        // dynamic shared memory, in bytes from its start
  size_t rows, taps, fracs, unions, total;
  __host__ __device__ LayoutFwd(int V, int ut, int S, int CP, int esize, int HW) {
    const size_t samples = (size_t)BLOCK_RAYS * S;
    const size_t staged = (size_t)2 * (ut + 1) * CP * esize;   // [2][ut+1][CP]
    const size_t scratch = ((size_t)2 * V * ((HW + 31) / 32) + 32) * sizeof(int);
    rows = 0;
    taps = align16(staged > scratch ? staged : scratch);   // [V][8S] uint2
    fracs = taps + (size_t)V * samples * sizeof(uint2);    // [V][8S] float2
    unions = fracs + (size_t)V * samples * sizeof(float2); // [V][ut] int
    total = unions + (size_t)V * ut * sizeof(int);
  }
};

// exclusive prefix sums of popc(bits[i]), i < M, into pre[i]; every thread
// of the block calls it; it ends synchronised
__device__ __forceinline__ void scan_popc(const unsigned* bits, int* pre, int M, int* wsum,
                                          int tid) {
  const int per = (M + THREADS - 1) / THREADS;
  const int lo = min(tid * per, M), hi = min(lo + per, M);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += __popc(bits[i]);
  const int lane = tid & 31, warp = tid >> 5;
  int x = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int y = lane < WARPS ? wsum[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int z = __shfl_up_sync(0xffffffffu, y, off);
      if (lane >= off) y += z;
    }
    if (lane < WARPS) wsum[lane] = y;
  }
  __syncthreads();
  int base = (warp ? wsum[warp - 1] : 0) + x - s;
  for (int i = lo; i < hi; ++i) {
    pre[i] = base;
    base += __popc(bits[i]);
  }
  __syncthreads();
}

// set bits per view, after a scan: min(ut, count) in n[v]; the first ut
// cells of each view, ascending, into u[v * ut + rank]
__device__ __forceinline__ void take_first(const unsigned* bits, const int* pre, int V, int nw,
                                           int ut, int* u, int* n, int tid) {
  const int M = V * nw;
#pragma unroll
  for (int v = 0; v < MAX_V; ++v) {
    if (v >= V) break;
    const int end = v + 1 < V ? pre[(v + 1) * nw] : pre[M - 1] + __popc(bits[M - 1]);
    n[v] = min(ut, end - pre[v * nw]);
  }
  for (int i = tid; i < M; i += THREADS) {
    unsigned word = bits[i];
    if (!word) continue;
    const int v = i / nw;
    int rank = pre[i] - pre[v * nw];
    const int c0 = (i - v * nw) * 32;
    while (word && rank < ut) {
      u[v * ut + rank++] = c0 + __ffs(word) - 1;
      word &= word - 1;
    }
  }
}

// n[v] with v known only at run time, without a local-memory array: a
// chain of selects over the MAX_V registers
__device__ __forceinline__ int of_view(const int* n, int v) {
  int r = n[0];
#pragma unroll
  for (int k = 1; k < MAX_V; ++k) r = v == k ? n[k] : r;
  return r;
}

// the union row of `cell` in view v: its rank among the set bits, or ut
// (the zero row) when it is not in the first ut
__device__ __forceinline__ unsigned union_row(const unsigned* bits, const int* pre, int nw,
                                              int v, int cell, int ut) {
  const int i = v * nw + (cell >> 5);
  const unsigned word = bits[i], bit = 1u << (cell & 31);
  if (!(word & bit)) return ut;
  const int rank = pre[i] - pre[v * nw] + __popc(word & (bit - 1));
  return rank < ut ? rank : ut;
}

// step 1 of the header: the block's union per view into u_s (INT_MAX
// padded) and, with unions_out, to global memory; each (view, sample)'s four
// union rows (16 bits each) into taps and its fractions into fracs. Every
// thread calls it; it ends synchronised.
__device__ __forceinline__ void build_union(const float* __restrict__ grids,
                                            int* __restrict__ unions_out, unsigned* bits,
                                            int* pre, int* wsum, uint2* taps, float2* fracs,
                                            int* u_s, int V, int H, int W, int R, int S,
                                            int ut, int blk, int tid) {
  const int samples = BLOCK_RAYS * S;
  const int HW = H * W, nw = (HW + 31) / 32, M = V * nw;
  for (int i = tid; i < M; i += THREADS) bits[i] = 0u;
  __syncthreads();
  for (int t = tid; t < V * samples; t += THREADS) {
    const int v = t / samples, nl = t % samples;
    const int ray = min(blk * BLOCK_RAYS + nl / S, R - 1);
    float x, y;
    sample_xy(grids, (((size_t)v * R + ray) * S + nl % S) * 2, H, W, x, y);
    const float x0f = floorf(x), y0f = floorf(y);
    const int cell = (int)y0f * W + (int)x0f;
    taps[t] = make_uint2((unsigned)cell, 0u);
    fracs[t] = make_float2(__fsub_rn(x, x0f), __fsub_rn(y, y0f));
    atomicOr(bits + v * nw + (cell >> 5), 1u << (cell & 31));
  }
  __syncthreads();
  int n[MAX_V] = {};
  scan_popc(bits, pre, M, wsum, tid);
  take_first(bits, pre, V, nw, ut, u_s, n, tid);    // the capped base cells
  __syncthreads();
  for (int i = tid; i < M; i += THREADS) bits[i] = 0u;
  __syncthreads();
  for (int i = tid; i < V * ut; i += THREADS) {
    const int v = i / ut;
    if (i - v * ut >= of_view(n, v)) continue;
    const int c = u_s[i];
    unsigned* b = bits + v * nw;
    atomicOr(b + (c >> 5), 1u << (c & 31));
    if (c + 1 < HW) atomicOr(b + ((c + 1) >> 5), 1u << ((c + 1) & 31));
    if (c + W < HW) atomicOr(b + ((c + W) >> 5), 1u << ((c + W) & 31));
    if (c + W + 1 < HW) atomicOr(b + ((c + W + 1) >> 5), 1u << ((c + W + 1) & 31));
  }
  __syncthreads();
  scan_popc(bits, pre, M, wsum, tid);
  take_first(bits, pre, V, nw, ut, u_s, n, tid);    // the union
  for (int i = tid; i < V * ut; i += THREADS)
    if (i % ut >= of_view(n, i / ut)) u_s[i] = INT_MAX;
  for (int t = tid; t < V * samples; t += THREADS) {
    const int v = t / samples, cell = (int)taps[t].x;
    const int y0 = cell / W, x0 = cell - y0 * W;
    const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
    taps[t] = make_uint2(union_row(bits, pre, nw, v, cell, ut) |
                             (union_row(bits, pre, nw, v, y0 * W + x1, ut) << 16),
                         union_row(bits, pre, nw, v, y1 * W + x0, ut) |
                             (union_row(bits, pre, nw, v, y1 * W + x1, ut) << 16));
  }
  __syncthreads();
  if (unions_out) {
    const int NB = gridDim.x;
    for (int i = tid; i < V * ut; i += THREADS) {
      const int v = i / ut, c = u_s[i];
      unions_out[((size_t)v * NB + blk) * ut + i % ut] = c == INT_MAX ? -1 : c;
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// step 2 of the header: CP channels (from channel c0 of the chunk) of both
// sides' union rows (CC channels a table row); row ut is zero. TG = TS:
// cp.async, 16 bytes a copy.
template <typename TG, typename TS>
__device__ __forceinline__ void stage_pass(const TG* __restrict__ table, const int* u_s,
                                           TS* rows, int H, int W, int CC, int ut, int CP,
                                           int vi, int vj, int ca, int cb, int c0, int tid) {
  constexpr int EL = 16 / sizeof(TG);              // table elements per 16 bytes
  const int parts = CP / EL;
  const int per_side = (ut + 1) * parts;
  if constexpr (sizeof(TG) == sizeof(TS)) {
    for (int i = tid; i < 2 * per_side; i += THREADS) {
      const int side = i / per_side, rem = i - side * per_side;
      const int r = rem / parts, part = rem - r * parts;
      const int v = side ? vj : vi;
      const int cell = r < ut ? u_s[v * ut + r] : INT_MAX;
      const bool valid = cell != INT_MAX;
      const TG* src = table + ((size_t)v * H * W + (valid ? cell : 0)) * CC +
                      (side ? cb : ca) * C + c0 + part * EL;
      cp_async16(rows + ((size_t)side * (ut + 1) + r) * CP + part * EL, src, valid);
    }
    cp_async_wait_all();
  } else {
    // int8 rows: 16 bytes in, 32 bytes of bf16 out, four loads in flight
    constexpr int BATCH = 4;
    for (int i0 = tid; i0 < 2 * per_side; i0 += BATCH * THREADS) {
      uint4 raw[BATCH];
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int i = i0 + k * THREADS;
        raw[k] = make_uint4(0u, 0u, 0u, 0u);
        if (i >= 2 * per_side) continue;
        const int side = i / per_side, rem = i - side * per_side;
        const int r = rem / parts, part = rem - r * parts;
        const int v = side ? vj : vi;
        const int cell = r < ut ? u_s[v * ut + r] : INT_MAX;
        if (cell != INT_MAX)
          raw[k] = __ldg(reinterpret_cast<const uint4*>(
              table + ((size_t)v * H * W + cell) * CC + (side ? cb : ca) * C + c0 + part * EL));
      }
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int i = i0 + k * THREADS;
        if (i >= 2 * per_side) continue;
        const int side = i / per_side, rem = i - side * per_side;
        const int r = rem / parts, part = rem - r * parts;
        const uint2 a = int8x4_to_bf16x4(raw[k].x), b = int8x4_to_bf16x4(raw[k].y);
        const uint2 c = int8x4_to_bf16x4(raw[k].z), d = int8x4_to_bf16x4(raw[k].w);
        uint4* dst = reinterpret_cast<uint4*>(rows + ((size_t)side * (ut + 1) + r) * CP +
                                              part * EL);
        dst[0] = make_uint4(a.x, a.y, b.x, b.y);
        dst[1] = make_uint4(c.x, c.y, d.x, d.y);
      }
    }
  }
}

// CPL staged elements as f32: bf16 bits widen by a shift or a mask
template <int CPL>
__device__ __forceinline__ void load_row(const uint16_t* p, float* f) {
  unsigned w[CPL / 2];
  if constexpr (CPL == 8) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    w[0] = r.x; w[1] = r.y; w[2] = r.z; w[3] = r.w;
  } else if constexpr (CPL == 4) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    w[0] = r.x; w[1] = r.y;
  } else {
    w[0] = *reinterpret_cast<const unsigned*>(p);
  }
#pragma unroll
  for (int h = 0; h < CPL / 2; ++h) {
    f[2 * h] = __uint_as_float(w[h] << 16);
    f[2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
  }
}

template <int CPL>
__device__ __forceinline__ void load_row(const float* p, float* f) {
#pragma unroll
  for (int h = 0; h < CPL; h += 4) {
    if constexpr (CPL >= 4) {
      const float4 r = *reinterpret_cast<const float4*>(p + h);
      f[h] = r.x; f[h + 1] = r.y; f[h + 2] = r.z; f[h + 3] = r.w;
    } else {
      const float2 r = *reinterpret_cast<const float2*>(p);
      f[0] = r.x; f[1] = r.y;
    }
  }
}

// this lane's NS slots of SW channels (pair_cosine8) of one side at one
// sample, interpolated in f32; the backward's lanes hold one slot of CPL
// channels
template <typename TS, int NS, int SW>
__device__ __forceinline__ void interp_slots(const TS* rows, int CP, uint2 pos, float2 fr,
                                             int lane, float* f) {
  float w[4];
  weights4(fr, w);
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int off = k * 8 * SW + lane * SW;
    float a[SW], b[SW], c[SW], d[SW];
    load_row<SW>(rows + tap_row(pos, 0) * CP + off, a);
    load_row<SW>(rows + tap_row(pos, 1) * CP + off, b);
    load_row<SW>(rows + tap_row(pos, 2) * CP + off, c);
    load_row<SW>(rows + tap_row(pos, 3) * CP + off, d);
#pragma unroll
    for (int e = 0; e < SW; ++e)
      f[k * SW + e] = a[e] * w[0] + b[e] * w[1] + c[e] * w[2] + d[e] * w[3];
  }
}

#ifdef KERNEL_D_PHASES
// Phase timing for matchnerf_tpu_torch/profile_prior.py --phases (built with
// -DKERNEL_D_PHASES only): thread 0 of every block adds the clock64 cycles
// since its previous mark to g_phases[k]: 0 the union build, 1 the staging
// passes (with the wait for the block's slowest warp), 2 its own sample
// loops; 3 counts the blocks.
__device__ unsigned long long g_phases[4];
#define PHASE_START long long phase_t = clock64()
#define PHASE_MARK(k)                                                        \
  do {                                                                       \
    if (threadIdx.x == 0) {                                                  \
      const long long now = clock64();                                       \
      atomicAdd(&g_phases[k], (unsigned long long)(now - phase_t));          \
      phase_t = now;                                                         \
    }                                                                        \
  } while (0)
#else
#define PHASE_START
#define PHASE_MARK(k)
#endif

// TG: the table's element (int8_t, uint16_t for bf16, float); TS: the
// staged element (uint16_t bf16 bits for int8 and bf16 tables, float)
template <typename TG, typename TS, int CP>
__global__ void __launch_bounds__(THREADS)
block_cosine_prior_kernel(const TG* __restrict__ table, const float* __restrict__ grids,
                          const float* __restrict__ scales, int* __restrict__ unions_out,
                          float* __restrict__ out, int V, int H, int W, int G, int R, int S,
                          int ut) {
  constexpr int CPL = CP / LANES;                  // channels per lane: 16, 8 or 4
  constexpr int SW = 16 / (int)sizeof(TS) < CPL ? 16 / (int)sizeof(TS) : CPL;
  constexpr int NS = CPL / SW;
  constexpr bool SCALED = sizeof(TG) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const LayoutFwd L(V, ut, S, CP, sizeof(TS), H * W);
  TS* rows = reinterpret_cast<TS*>(smem + L.rows);
  uint2* taps = reinterpret_cast<uint2*>(smem + L.taps);
  float2* fracs = reinterpret_cast<float2*>(smem + L.fracs);
  int* u_s = reinterpret_cast<int*>(smem + L.unions);
  const int nw = (H * W + 31) / 32;
  unsigned* bits = reinterpret_cast<unsigned*>(smem + L.rows);   // until the first pass
  int* pre = reinterpret_cast<int*>(bits + V * nw);
  int* wsum = pre + V * nw;

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % LANES;
  const int grp = tid / LANES;
  const int samples = BLOCK_RAYS * S;
  const int valid = min(BLOCK_RAYS, R - blk * BLOCK_RAYS) * S;
  const int CC = (V - 1) * C;              // channels per view table row
  const int P = n_pairs(V);
  const float inv_p = 1.f / (float)P;      // the mean over the pairs
  const SlotGroups<SW> sg(G);
  PHASE_START;
  build_union(grids, unions_out, bits, pre, wsum, taps, fracs, u_s, V, H, W, R, S, ut, blk,
              tid);
  PHASE_MARK(0);
  float* ob = out + (size_t)blk * BLOCK_RAYS * S * G;

#pragma unroll 1
  for (int p = 0; p < P; ++p) {
    const int vi = pair_first(V, p), vj = pair_second(V, p);
    const int ca = vj - 1, cb = vi;        // view i's chunk j-1, view j's chunk i
#pragma unroll 1
    for (int c0 = 0; c0 < C; c0 += CP) {
      __syncthreads();                     // the union / the previous pass done
      stage_pass<TG, TS>(table, u_s, rows, H, W, CC, ut, CP, vi, vj, ca, cb, c0, tid);
      __syncthreads();
      PHASE_MARK(1);
      float sa[CPL], sb[CPL];             // dequantisation scales (int8 tables)
      if constexpr (SCALED) {
#pragma unroll
        for (int k = 0; k < NS; ++k)
#pragma unroll
          for (int e = 0; e < SW; ++e) {
            const int ch = c0 + k * 8 * SW + lane * SW + e;
            sa[k * SW + e] = scales[vi * CC + ca * C + ch];
            sb[k * SW + e] = scales[vj * CC + cb * C + ch];
          }
      }
      const TS* rows_a = rows;
      const TS* rows_b = rows + (size_t)(ut + 1) * CP;
      // the outputs this lane owns, and their pair sums so far, fetched one
      // sample ahead so that the load's latency hides behind a sample's work
      int owned[NS];
#pragma unroll
      for (int k = 0; k < NS; ++k) owned[k] = sg.slot_group(k, lane, c0);
      float sum[NS], next[NS];
      auto fetch = [&](int nl, float* dst) {
#pragma unroll
        for (int k = 0; k < NS; ++k)
          dst[k] = p > 0 && owned[k] >= 0 && nl < valid ? ob[(size_t)nl * G + owned[k]] : 0.f;
      };
      fetch(grp, sum);
      for (int base = 0; base < samples; base += GROUPS) {
        const int nl_raw = base + grp;
        const int nl = nl_raw < samples ? nl_raw : samples - 1;   // all lanes shuffle
        fetch(nl_raw + GROUPS, next);
        float fa[CPL], fb[CPL], cosv[NS];
        interp_slots<TS, NS, SW>(rows_a, CP, taps[vi * samples + nl],
                                 fracs[vi * samples + nl], lane, fa);
        interp_slots<TS, NS, SW>(rows_b, CP, taps[vj * samples + nl],
                                 fracs[vj * samples + nl], lane, fb);
        if constexpr (SCALED) {
#pragma unroll
          for (int e = 0; e < CPL; ++e) {
            fa[e] *= sa[e];
            fb[e] *= sb[e];
          }
        }
        pair_cosine8<NS, SW>(fa, fb, sg, cosv);
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          if (owned[k] >= 0 && nl_raw < valid) {
            const float t = sum[k] + cosv[k];
            ob[(size_t)nl * G + owned[k]] = p == P - 1 ? t * inv_p : t;
          }
          sum[k] = next[k];
        }
      }
      PHASE_MARK(2);
    }
  }
#ifdef KERNEL_D_PHASES
  if (tid == 0) atomicAdd(&g_phases[3], 1ull);
#endif
}

// ------------------------------------------------------- D''s backward
//
// Per pair and pass of CP channels (ops/block_cosine_prior.py::
// channels_per_pass with backward=True) the block stages the f32 union rows
// of the union its forward wrote, recomputes each sample's interpolation
// and group sums, forms the grouped-cosine backward (pallas_banded.py::
// _grouped_cosine_bwd, no gradient through a norm clamped at eps), and sums
// the gradient times each bilinear weight per union row: the counterpart of
// the TPU kernel's per-block d_acc. Each (view, chunk) is one side of
// exactly one pair. A tap missing from an overflowed union (the zero row
// ut) adds nothing. grids here are [V,8*NB,S,2], the tail rays
// edge-padded; padded rays carry no cotangent.
//
// What bounds it: the sums per union row. One add per (sample, side, tap,
// channel), 3,072 a sample, paced the first design at one block per SM. So:
//
// 1. Walks. The block's 8 rays are adjacent pixels of a strip: at one depth
//    they sit in the same cell or the next. A sample group of BL lanes (16
//    at CP 64 and 128, 8 at CP 32; CPL = CP / BL channels each) walks a band
//    of ceil(S / (512 / BL)) consecutive depths across all 8 rays,
//    serpentine (depth d over rays 0..7, depth d+1 over rays 7..0), so
//    consecutive samples of a walk are neighbouring pixels or neighbouring
//    depths.
// 2. Parity slots, as in B' (csrc/cosine_prior.cu): a 2x2 footprint holds
//    one cell of each (row parity, column parity), so slot 2*py + px of a
//    side holds the tap of those parities; the prologue stores each
//    sample's four union rows in slot order (16 bits each, the rows' parity
//    bits in bit 15 of the first two), rows past the border (weight 0) and
//    missing rows as the zero row ut. A lane sums each slot's CPL channels
//    in registers while its row stays the same and ends the run when the
//    row changes and at the end of the walk; the zero row makes no run.
// 3. The same sums on every run (training repeats itself, as the JAX step
//    does): no walk adds into a shared d_acc, and no block into d_table,
//    where the order of the adds changes from run to run. As in B', a count
//    pass (block_cosine_prior_bwd_count: the prologue, then each walk's runs
//    per view) gives each (block, walk, view) its number of runs and the
//    wrapper's exclusive scan its first record; the walk writes each run
//    as a record at the position fixed by (block, walk, view, run ordinal):
//    its CPL channels of the run's (V-1)C-channel table row (every pass
//    fills its columns: the runs of a walk over a view are the same in every
//    pass), and its cell. The wrapper sorts the cells, stably, and
//    cosine_prior.cu's prior_bwd_reduce_f32 sums each cell's records in the
//    order of their positions into its d_table row.
// 4. Overlap: the rows of the next pass arrive by cp.async into the second
//    row buffer while the walks run on the first.
//
// Shared memory (LayoutPass) at the training pose's buckets, S = 128 and
// V = 3: ut 160, CP 64 (G = 2): two buffers of both sides' rows 2 x 2 x
// 161 x 64 x 4 B = 164,864 B, taps and fractions [V][8S] 49,152 B, union
// 1,920 B: 215,936 B; ut 320, CP 32 (G = 8): 164,352 B, 49,152 B, 3,840 B:
// 217,344 B. One block per SM. At V = 4 the taps and fractions take 65,536
// B, so ut 160 at G = 2 fits no pass (CP 64: 232,960 B) and takes B'; at
// V = 8 131,072 B, and G = 2 fits ut 64 alone (CP 64), G = 8 up to ut 160
// (CP 32).

struct LayoutPass {       // dynamic shared memory, in bytes from its start
  size_t rows, taps, fracs, unions, total;
  __host__ __device__ LayoutPass(int V, int ut, int S, int CP) {
    const size_t samples = (size_t)BLOCK_RAYS * S;
    const size_t buffer = 2 * (size_t)(ut + 1) * CP * sizeof(float);
    rows = 0;                                              // [2][2][ut+1][CP] f32
    taps = rows + 2 * buffer;                              // [V][8S] uint2
    fracs = taps + (size_t)V * samples * sizeof(uint2);    // [V][8S] float2
    unions = fracs + (size_t)V * samples * sizeof(float2); // [V][ut] int
    total = unions + (size_t)V * ut * sizeof(int);
  }
};

// the count pass's shared memory: LayoutPass without the rows
struct LayoutCount {
  size_t taps, fracs, unions, total;
  __host__ __device__ LayoutCount(int V, int ut, int S) {
    const size_t samples = (size_t)BLOCK_RAYS * S;
    taps = 0;
    fracs = taps + (size_t)V * samples * sizeof(uint2);
    unions = fracs + (size_t)V * samples * sizeof(float2);
    total = unions + (size_t)V * ut * sizeof(int);
  }
};

// the backward's prologue: the unions its forward wrote, into shared memory
// (INT_MAX padded), and each (view, sample)'s four union rows in parity-slot
// order (binary search; ut for a cell past the border or missing), with
// the base cell's row and column parities in bit 15 of rows 0 and 1, and
// its two fractions
__device__ __forceinline__ void block_prologue(const float* __restrict__ grids,
                                               const int* __restrict__ unions,
                                               int* u_s, uint2* taps, float2* fracs,
                                               int V, int H, int W, int S, int NB, int ut,
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
    float x, y;
    sample_xy(grids, g, H, W, x, y);
    const float x0f = floorf(x), y0f = floorf(y);
    const int x0 = (int)x0f, y0 = (int)y0f;
    const int* u = u_s + v * ut;
    unsigned row[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int yy = y0 + ((s >> 1) ^ (y0 & 1)), xx = x0 + ((s & 1) ^ (x0 & 1));
      row[s] = yy < H && xx < W ? (unsigned)find_row(u, ut, yy * W + xx) : (unsigned)ut;
    }
    taps[t] = make_uint2(row[0] | ((unsigned)(y0 & 1) << 15) | (row[1] << 16) |
                             ((unsigned)(x0 & 1) << 31),
                         row[2] | (row[3] << 16));
    fracs[t] = make_float2(__fsub_rn(x, x0f), __fsub_rn(y, y0f));
  }
}

// a sample's four slot rows (decoded from the prologue's taps) and weights
struct SlotTaps {
  int row[4];
  float w[4];
};

__device__ __forceinline__ SlotTaps slot_taps(uint2 t, float2 fr) {
  SlotTaps st;
  st.row[0] = (int)(t.x & 0x7fffu);
  st.row[1] = (int)((t.x >> 16) & 0x7fffu);
  st.row[2] = (int)(t.y & 0xffffu);
  st.row[3] = (int)(t.y >> 16);
  const bool oy = (t.x >> 15) & 1u, ox = t.x >> 31;
  const float wx1 = fr.x, wy1 = fr.y;
  const float wx0 = __fsub_rn(1.f, wx1), wy0 = __fsub_rn(1.f, wy1);
  // slot (py, px) holds tap (py ^ oy, px ^ ox)
  const float wyp[2] = {oy ? wy1 : wy0, oy ? wy0 : wy1};
  const float wxp[2] = {ox ? wx1 : wx0, ox ? wx0 : wx1};
#pragma unroll
  for (int s = 0; s < 4; ++s) st.w[s] = __fmul_rn(wyp[s >> 1], wxp[s & 1]);
  return st;
}

template <int CPL>
__device__ __forceinline__ void interp_rows(const float* rows, int CP, const SlotTaps& st,
                                            int o, float* f) {
  float r[4][CPL];
#pragma unroll
  for (int s = 0; s < 4; ++s) load_row<CPL>(rows + st.row[s] * CP + o, r[s]);
#pragma unroll
  for (int e = 0; e < CPL; ++e)
    f[e] = r[0][e] * st.w[0] + r[1][e] * st.w[1] + r[2][e] * st.w[2] + r[3][e] * st.w[3];
}

// where one side of a walk writes its runs in one pass: record `pos` (the
// next one of its (block, walk, view)) holds the run's CPL channels from
// column col of its (V-1)C-channel row; in the pass that stages channel 0
// of chunk 0 the lane 0 of each walk also writes the run's cell
struct Records {
  float* rec;
  int* keys;
  const int* u;          // the side's union cells
  int pos, CC, col, cell0;
  bool key_writer;
  template <int CPL>
  __device__ __forceinline__ void put(int row, const float (&v)[CPL]) {
    float* dst = rec + (size_t)pos * CC + col;
#pragma unroll
    for (int e = 0; e < CPL; e += 4)
      *reinterpret_cast<float4*>(dst + e) = make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
    if (key_writer) keys[pos] = cell0 + u[row];
    ++pos;
  }
};

// one side's slots after one more sample of a walk (B''s slot_update on
// union rows): a slot whose row changed writes its run, unless it held the
// zero row, and restarts; only the write branches
template <int CPL>
__device__ __forceinline__ void slot_update(float (&acc)[4][CPL], int (&key)[4],
                                            const SlotTaps& st, const float* df, Records& out,
                                            int ut) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const bool changed = st.row[s] != key[s];
    if (changed && key[s] != ut) out.put<CPL>(key[s], acc[s]);
    key[s] = st.row[s];
#pragma unroll
    for (int e = 0; e < CPL; ++e) acc[s][e] = fmaf(st.w[s], df[e], changed ? 0.f : acc[s][e]);
  }
}

template <int CPL>
__device__ __forceinline__ void slot_flush(const float (&acc)[4][CPL], const int (&key)[4],
                                           Records& out, int ut) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (key[s] != ut) out.put<CPL>(key[s], acc[s]);
}

// CP channels (from channel c0 of the chunk) of both sides of pair p's f32
// union rows by cp.async, 16 bytes a copy, row ut zero; committed, not
// waited for
__device__ __forceinline__ void issue_rows(const float* __restrict__ table, const int* u_s,
                                           float* rows, int V, int H, int W, int ut, int CP,
                                           int p, int c0, int tid) {
  const int CC = (V - 1) * C;
  const int vi = pair_first(V, p), vj = pair_second(V, p), ca = vj - 1, cb = vi;
  const int parts = CP / 4;
  const int per_side = (ut + 1) * parts;
  for (int i = tid; i < 2 * per_side; i += THREADS) {
    const int side = i / per_side, rem = i - side * per_side;
    const int r = rem / parts, part = rem - r * parts;
    const int v = side ? vj : vi;
    const int cell = r < ut ? u_s[v * ut + r] : INT_MAX;
    const bool valid = cell != INT_MAX;
    const float* src = table + ((size_t)v * H * W + (valid ? cell : 0)) * CC +
                       (side ? cb : ca) * C + c0 + part * 4;
    cp_async16(rows + ((size_t)side * (ut + 1) + r) * CP + part * 4, src, valid);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the walk of sample group grp (item 1 of the header): depths lo .. lo +
// nd - 1 of the block's rays that are not padding, visited as step i ->
// (ray, depth), or ray -1 for a padded ray
struct Walk {
  int lo, nd, rays;
  __device__ __forceinline__ Walk(int grp, int walks, int S, int R, int blk) {
    const int seg = (S + walks - 1) / walks;
    lo = grp * seg;
    nd = max(0, min(S, lo + seg) - lo);
    rays = min(BLOCK_RAYS, R - blk * BLOCK_RAYS);
  }
  __device__ __forceinline__ int sample(int i, int S) const {
    const int d = i / BLOCK_RAYS, j = i % BLOCK_RAYS;
    const int ray = d & 1 ? BLOCK_RAYS - 1 - j : j;       // serpentine
    return ray < rays ? ray * S + lo + d : -1;
  }
};

// D''s count pass: the prologue, then per (walk, view) the runs of item 3
// in the header, in the order the records follow
template <int BL>
__global__ void __launch_bounds__(THREADS)
block_cosine_prior_bwd_count_kernel(const float* __restrict__ grids,
                                    const int* __restrict__ unions, int* __restrict__ counts,
                                    int V, int H, int W, int R, int S, int NB, int ut) {
  constexpr int WALKS = THREADS / BL;
  extern __shared__ __align__(16) unsigned char smem[];
  const LayoutCount L(V, ut, S);
  uint2* taps = reinterpret_cast<uint2*>(smem + L.taps);
  float2* fracs = reinterpret_cast<float2*>(smem + L.fracs);
  int* u_s = reinterpret_cast<int*>(smem + L.unions);
  const int blk = blockIdx.x, tid = threadIdx.x;
  const int samples = BLOCK_RAYS * S;
  block_prologue(grids, unions, u_s, taps, fracs, V, H, W, S, NB, ut, blk, tid);
  __syncthreads();
  for (int t = tid; t < WALKS * V; t += THREADS) {
    const int grp = t / V, v = t - grp * V;
    const Walk walk(grp, WALKS, S, R, blk);
    int key[4] = {ut, ut, ut, ut}, runs = 0;
#pragma unroll 1
    for (int i = 0; i < walk.nd * BLOCK_RAYS; ++i) {
      const int nl = walk.sample(i, S);
      if (nl < 0) continue;
      const SlotTaps st = slot_taps(taps[v * samples + nl], fracs[v * samples + nl]);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (st.row[s] != key[s]) {
          runs += key[s] != ut;
          key[s] = st.row[s];
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) runs += key[s] != ut;
    counts[((size_t)blk * WALKS + grp) * V + v] = runs;
  }
}

template <int CPL, int BL>
__global__ void __launch_bounds__(THREADS)
block_cosine_prior_bwd_kernel(const float* __restrict__ table,
                              const float* __restrict__ grids,
                              const int* __restrict__ unions, const float* __restrict__ gout,
                              const int* __restrict__ starts, float* __restrict__ rec,
                              int* __restrict__ keys, int V, int H, int W, int G, int R, int S,
                              int NB, int ut) {
  constexpr int CP = CPL * BL;
  constexpr int WALKS = THREADS / BL;                   // sample groups, one walk each
  extern __shared__ __align__(16) unsigned char smem[];
  const LayoutPass L(V, ut, S, CP);
  float* rows = reinterpret_cast<float*>(smem + L.rows);
  uint2* taps = reinterpret_cast<uint2*>(smem + L.taps);
  float2* fracs = reinterpret_cast<float2*>(smem + L.fracs);
  int* u_s = reinterpret_cast<int*>(smem + L.unions);

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % BL;
  const int grp = tid / BL;
  // a group's BL lanes shuffle among themselves only: the walks of a warp
  // branch apart at their run ends and ends
  const unsigned mask = ((1u << BL) - 1u) << (tid & (32 - BL));
  const int o = lane * CPL;
  const int samples = BLOCK_RAYS * S;
  const int gsize = C / G;
  const int lanes_per_group = gsize / CPL;
  const Walk walk(grp, WALKS, S, R, blk);
  const int CC = (V - 1) * C;
  const int P = n_pairs(V);
  const float inv_p = 1.f / (float)P;      // the mean over the pairs
  const size_t buffer = 2 * (size_t)(ut + 1) * CP;      // floats of one row buffer
  const int* first = starts + ((size_t)blk * WALKS + grp) * V;
  block_prologue(grids, unions, u_s, taps, fracs, V, H, W, S, NB, ut, blk, tid);
  __syncthreads();                         // the union, for the first staging
  issue_rows(table, u_s, rows, V, H, W, ut, CP, 0, 0, tid);
  const float* gb = gout + (size_t)blk * BLOCK_RAYS * S * G;
  const int per_pair = C / CP, passes = P * per_pair;

#pragma unroll 1
  for (int k = 0; k < passes; ++k) {
    const int p = k / per_pair, c0 = (k % per_pair) * CP;
    const int vi = pair_first(V, p), vj = pair_second(V, p);
    const int ca = vj - 1, cb = vi;
    __syncthreads();                       // every walk is done with pass k - 1's buffer
    if (k + 1 < passes)
      issue_rows(table, u_s, rows + ((k + 1) & 1) * buffer, V, H, W, ut, CP,
                 (k + 1) / per_pair, ((k + 1) % per_pair) * CP, tid);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();                       // pass k's rows staged
    const float* rows_a = rows + (k & 1) * buffer;
    const float* rows_b = rows_a + (size_t)(ut + 1) * CP;
    const int group = (c0 + o) / gsize;
    Records out[2] = {{rec, keys, u_s + vi * ut, first[vi], CC, ca * C + c0 + o,
                       vi * H * W, lane == 0 && ca == 0 && c0 == 0},
                      {rec, keys, u_s + vj * ut, first[vj], CC, cb * C + c0 + o,
                       vj * H * W, lane == 0 && cb == 0 && c0 == 0}};
    float acc[2][4][CPL];
    int key[2][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      key[0][s] = key[1][s] = ut;
#pragma unroll
      for (int e = 0; e < CPL; ++e) acc[0][s][e] = acc[1][s][e] = 0.f;
    }
#pragma unroll 1
    for (int i = 0; i < walk.nd * BLOCK_RAYS; ++i) {
      const int nl = walk.sample(i, S);
      if (nl < 0) continue;
      const SlotTaps ta = slot_taps(taps[vi * samples + nl], fracs[vi * samples + nl]);
      const SlotTaps tb = slot_taps(taps[vj * samples + nl], fracs[vj * samples + nl]);
      float fa[CPL], fb[CPL];
      interp_rows<CPL>(rows_a, CP, ta, o, fa);
      interp_rows<CPL>(rows_b, CP, tb, o, fb);
      float dot = 0.f, na2 = 0.f, nb2 = 0.f;
#pragma unroll
      for (int e = 0; e < CPL; ++e) {
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
      cosine_bwd(gb[(size_t)nl * G + group] * inv_p, dot, na2, nb2, d_dot, d_na2, d_nb2);
      float dfa[CPL], dfb[CPL];
#pragma unroll
      for (int e = 0; e < CPL; ++e) {
        dfa[e] = d_dot * fb[e] + 2.f * d_na2 * fa[e];
        dfb[e] = d_dot * fa[e] + 2.f * d_nb2 * fb[e];
      }
      slot_update<CPL>(acc[0], key[0], ta, dfa, out[0], ut);
      slot_update<CPL>(acc[1], key[1], tb, dfb, out[1], ut);
    }
    slot_flush<CPL>(acc[0], key[0], out[0], ut);
    slot_flush<CPL>(acc[1], key[1], out[1], ut);
  }
}

template <int BL>
int launch_bwd_count(const void* grids, const void* unions, void* counts, int V, int H, int W,
                     int R, int S, int NB, int ut, cudaStream_t stream) {
  const LayoutCount L(V, ut, S);
  if (L.total > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      block_cosine_prior_bwd_count_kernel<BL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return (int)err;
  block_cosine_prior_bwd_count_kernel<BL><<<NB, THREADS, L.total, stream>>>(
      static_cast<const float*>(grids), static_cast<const int*>(unions),
      static_cast<int*>(counts), V, H, W, R, S, NB, ut);
  return (int)cudaGetLastError();
}

template <int CPL, int BL>
int launch_bwd(const void* table, const void* grids, const void* unions, const void* g,
               const void* starts, void* rec, void* keys, int V, int H, int W, int G, int R,
               int S, int NB, int ut, cudaStream_t stream) {
  const LayoutPass L(V, ut, S, CPL * BL);
  if (L.total > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      block_cosine_prior_bwd_kernel<CPL, BL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) return (int)err;
  block_cosine_prior_bwd_kernel<CPL, BL><<<NB, THREADS, L.total, stream>>>(
      static_cast<const float*>(table), static_cast<const float*>(grids),
      static_cast<const int*>(unions), static_cast<const float*>(g),
      static_cast<const int*>(starts), static_cast<float*>(rec), static_cast<int*>(keys), V, H,
      W, G, R, S, NB, ut);
  return (int)cudaGetLastError();
}

bool args_ok(int views, int channels, int H, int W, int R, int S, int ut, int G, int CP) {
  return views >= MIN_V && views <= MAX_V && channels == C && H > 0 && W > 0 && R > 0 && S > 0 && ut > 0 &&
         ut <= MAX_UT && (G == 1 || G == 2 || G == 4 || G == 8 || G == 16) &&
         (CP == 32 || CP == 64 || CP == 128) && G * CP >= C && G * CP <= 16 * C;
}

template <typename TG, typename TS, int CP>
int launch_fwd(const void* table, const void* grids, const void* scales, void* unions_out,
               void* out, int V, int H, int W, int G, int R, int S, int ut,
               cudaStream_t stream) {
  const LayoutFwd L(V, ut, S, CP, sizeof(TS), H * W);
  if (L.total > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = block_cosine_prior_kernel<TG, TS, CP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(R + BLOCK_RAYS - 1) / BLOCK_RAYS, THREADS, L.total, stream>>>(
      static_cast<const TG*>(table), static_cast<const float*>(grids),
      static_cast<const float*>(scales), static_cast<int*>(unions_out),
      static_cast<float*>(out), V, H, W, G, R, S, ut);
  return (int)cudaGetLastError();
}

// TG: the table's element type, TS: the staged one; scales only with int8
template <typename TG, typename TS>
int dispatch_fwd(const void* table, const void* grids, const void* scales, void* unions_out,
                 void* out, int views, int H, int W, int channels, int G, int R, int S,
                 int ut, int CP, void* stream) {
  if (!args_ok(views, channels, H, W, R, S, ut, G, CP) ||
      (sizeof(TG) == 1) != (scales != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (CP == 128)
    return launch_fwd<TG, TS, 128>(table, grids, scales, unions_out, out, views, H, W, G, R,
                                   S, ut, st);
  if (CP == 64)
    return launch_fwd<TG, TS, 64>(table, grids, scales, unions_out, out, views, H, W, G, R,
                                  S, ut, st);
  return launch_fwd<TG, TS, 32>(table, grids, scales, unions_out, out, views, H, W, G, R, S,
                                ut, st);
}

}  // namespace

// The forward entries: table [V,H,W,(V-1)C] (V = 2 to 8), grids [V,R,S,2]
// f32, scales [V,(V-1)C] f32 (int8 tables) or NULL, unions_out
// [V*ceil(R/8), ut] int32 or NULL, out [R,S,G] f32; CP channels staged per
// pass.

// Kernel D on int8 tables (configs/test.yaml's eval render)
extern "C" int block_cosine_prior_i8(const void* table, const void* grids, const void* scales,
                                     void* unions_out, void* out, int views, int H, int W,
                                     int channels, int G, int R, int S, int ut, int CP,
                                     void* stream) {
  return dispatch_fwd<int8_t, uint16_t>(table, grids, scales, unions_out, out, views, H, W,
                                        channels, G, R, S, ut, CP, stream);
}

// Kernel D on bf16 tables (the eval renders of configs/train.yaml)
extern "C" int block_cosine_prior_bf16(const void* table, const void* grids,
                                       const void* scales, void* unions_out, void* out,
                                       int views, int H, int W, int channels, int G, int R,
                                       int S, int ut, int CP, void* stream) {
  return dispatch_fwd<uint16_t, uint16_t>(table, grids, scales, unions_out, out, views, H, W,
                                          channels, G, R, S, ut, CP, stream);
}

// D''s forward on f32 tables, with the union for its backward
extern "C" int block_cosine_prior_f32(const void* table, const void* grids,
                                      const void* scales, void* unions_out, void* out,
                                      int views, int H, int W, int channels, int G, int R,
                                      int S, int ut, int CP, void* stream) {
  return dispatch_fwd<float, float>(table, grids, scales, unions_out, out, views, H, W,
                                    channels, G, R, S, ut, CP, stream);
}

#ifdef KERNEL_D_PHASES
// Copies the 4 phase counters to dst (host memory) and zeroes them.
extern "C" int block_cosine_prior_phases(void* dst) {
  cudaError_t err = cudaMemcpyFromSymbol(dst, g_phases, sizeof(g_phases));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zeros[4] = {};
  return (int)cudaMemcpyToSymbol(g_phases, zeros, sizeof(g_phases));
}
#endif

// D''s count pass: grids [V,8*NB,S,2] (edge-padded), the forward's unions
// [V*NB, ut]; counts [NB * (512 / BL) * V] int32, the runs of each (block,
// walk, view), with BL = 16 at CP 64 and 128, 8 at CP 32
extern "C" int block_cosine_prior_bwd_count(const void* grids, const void* unions, void* counts,
                                            int views, int H, int W, int R, int S, int NB,
                                            int ut, int CP, void* stream) {
  if (!args_ok(views, C, H, W, R, S, ut, 8, CP) || NB * BLOCK_RAYS < R)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (CP == 32)
    return launch_bwd_count<8>(grids, unions, counts, views, H, W, R, S, NB, ut, st);
  return launch_bwd_count<16>(grids, unions, counts, views, H, W, R, S, NB, ut, st);
}

// D''s records: as the count pass, with the table, g [R,S,G] f32
// cotangent, starts (the exclusive scan of the counts), rec [n_records,
// (V-1)C] f32 and keys [n_records] int32 (each run's table row), every
// entry written
extern "C" int block_cosine_prior_bwd_f32(const void* table, const void* grids,
                                          const void* unions, const void* g, const void* starts,
                                          void* rec, void* keys, int views, int H, int W,
                                          int channels, int G, int R, int S, int NB, int ut,
                                          int CP, void* stream) {
  if (!args_ok(views, channels, H, W, R, S, ut, G, CP) || NB * BLOCK_RAYS < R)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (CP == 128)
    return launch_bwd<8, 16>(table, grids, unions, g, starts, rec, keys, views, H, W, G, R, S,
                             NB, ut, st);
  if (CP == 64)
    return launch_bwd<4, 16>(table, grids, unions, g, starts, rec, keys, views, H, W, G, R, S,
                             NB, ut, st);
  return launch_bwd<4, 8>(table, grids, unions, g, starts, rec, keys, views, H, W, G, R, S, NB,
                          ut, st);
}
