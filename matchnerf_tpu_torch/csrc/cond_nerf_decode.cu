// Kernel C: the CondNeRF decoder with the emission-absorption composite.
//
// Replaces matchnerf_tpu/ops/pallas_decoder.py::cond_nerf_decode with
// fold_composite=True (the decoder megakernel of the eval render), with both
// of its operand types (matmul_dtype f32 and bf16). Plain version and
// wrapper: matchnerf_tpu_torch/ops/decoder.py.
//
// Per ray of 1 <= S <= 512 samples:
//   enc  = [p, sin(2^l p), cos(2^l p)], l < 10     (legacy posenc, 63 wide)
//   bias = pts_bias([feat, color, mask])           (128 wide, once per sample)
//   h    = relu((W_l h + b_l) * bias), 6 layers, h = [enc, h] after layer 4
//   tok  = act(alpha_linear(h)) (+ sinusoid table when raytrans_posenc)
//   4-head ray attention over the samples (query-axis mask fill where fewer
//   than 2 views see the point), residual, LayerNorm eps 1e-6, two linears
//   -> density (relu; 0 where no view sees the point with maskfill)
//   rgb  = sigmoid(rgb_linear(relu(views_linear([feature_linear(h), dir]))))
//   then the composite: rgb, depth and opacity of the ray.
//
// Two operand routes for the "wide" products (pts_bias, the six pts_linears,
// alpha_linear, feature_linear, views_linears.0, rgb_linear), both with f32
// accumulation on tensor cores (mma.sync):
// - f32 (the default): split TF32. Each operand is a = a_hi + a_lo with a_hi
//   = tf32(a); the product takes hi*hi + hi*lo + lo*hi (m16n8k8). Weights are
//   split once on the host (lo kept exact in f32; the tensor core reads its
//   top 19 bits); activations are split as they enter each product.
// - bf16 (precision.decoder_matmul_dtype: bf16, the JAX kernel's
//   matmul_dtype=bfloat16): weights rounded to bf16 once on the host,
//   activations rounded to bf16 as they enter each product (m16n8k16).
// Everything else is f32 on CUDA cores in both routes: the bias multiply and
// the activations, the 16-wide w_qs/w_ks/w_vs/fc, the ray attention and its
// softmax, the LayerNorm, out_alpha_linear and the composite.
//
// What bounds it: arithmetic. The wide products are ~97 % of the ~270 kFLOP
// per sample; inputs are ~120 bytes per sample. Design:
// - One persistent block of 8 warps per SM walks over rays. The MLP is
//   pointwise per sample, so it runs over tiles of 128 samples of a ray;
//   each warp owns 16 whole rows (samples) x all 128 columns. A layer's
//   accumulators become the next layer's A operand without leaving
//   registers: for bf16 two adjacent n8 C tiles are one k16 A fragment; for
//   TF32 the host permutes each k8 group of weight rows (A slot t <-> row 2t,
//   slot t+4 <-> row 2t+1) so that the C layout is the A layout. Inputs that
//   are not a previous layer's output (the conditioning for pts_bias, the
//   encoding for layers 0 and 5, the direction of views_linears) are A
//   fragments read from the warp's rows in shared memory. pts_bias(cond)
//   lives in shared memory in the accumulator layout, read by every layer's
//   epilogue. The enc columns are padded 63 -> 64 and the views input
//   131 -> 144 with zero weight rows (the skip layer 191 -> 192).
// - Weights are packed on the host in B-fragment order (16 bytes per lane
//   per (k8, n8) tile for TF32 hi/lo, per (k16, n16) tile pair for bf16) and
//   stream from L2 through a four-slot ring of 16 KB groups (16 weight rows
//   of a 128-wide layer in TF32, 64 in bf16), each group one bulk copy
//   (cp.async.bulk) completing on an mbarrier, kept two groups ahead across
//   layers, tiles and rays; warps free slots by arriving on a second
//   mbarrier, so no block-wide barrier paces the products.
// - The tensor core truncates as it accumulates; each n8 tile sums one
//   group's products in a zeroed tile and adds it to the layer's
//   accumulator in f32, so truncation spans at most one group. bf16 keeps
//   the layer's output as packed bf16 A fragments (every consumer rounds
//   it), which leaves the registers for a zeroed tile per n8 tile.
// - Only what the ray's attention and composite need outlives a tile: the
//   16-wide token, rgb, the number of views that see the sample and its
//   depth (92 bytes per sample). The attention's q, k, v overlay the tile
//   buffers. The ray tail runs on all 8 warps from shared memory (the
//   16-wide weights are staged there once per block): q, k, v and the
//   fc/LayerNorm/density head on two threads per sample; attention one
//   head of two samples per thread, a warp on one head (each k and v load
//   is a broadcast that feeds two queries), an online softmax in base 2
//   (ex2.approx) over blocks of 8 keys (a masked query gets q = 0, so its
//   attention is uniform); composite: a warp scan.
// Shared memory: 182,032 + 92 * S bytes (193,808 at S = 128, 229,136 at
// S = 512), one block per SM.
//
// Small-parameter buffer (f32), offsets below (SM_*): the biases of the wide
// layers (rgb padded to 16), then w_qs, w_ks, w_vs, fc as [in][out], the
// LayerNorm weight and bias, out_alpha_linear.0 [in][out] and bias,
// out_alpha_linear.2 [16] and bias.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int S_MAX = 512;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 16 * WARPS;        // samples per MLP tile
constexpr int CD_MAX = 64;              // conditioning width Gf + 4V
constexpr int BS = 136;                 // bias row stride (floats; 8 mod 32)
constexpr int XS = 72;                  // input row stride (floats; 8 mod 32)
constexpr int STAGES = 4;
constexpr int AHEAD = 2;                // groups in flight beyond the one in use
constexpr int STAGE_U4 = 1024;          // 16 KB per ring stage
constexpr int MAX_GROUPS = 96;
constexpr int RING_FLOATS = STAGES * STAGE_U4 * 4;
constexpr int OVL_FLOATS = WARPS * 16 * (BS + XS);
// per-warp point and direction rows, 2 mbarriers per stage, the group
// table, the 16-wide weights of the ray tail (small buffer from SM_WQ on)
constexpr int TAIL_W = 1348;
constexpr int MISC_FLOATS = WARPS * 16 * 8 + 4 * STAGES + 112 + TAIL_W;
constexpr int FIXED_FLOATS = RING_FLOATS + OVL_FLOATS + MISC_FLOATS;
constexpr int RAY_FLOATS_PER_SAMPLE = 16 + 4 + 3;   // tok, rgb, nv/depth/alpha
static_assert(48 * S_MAX <= OVL_FLOATS, "q, k, v of a ray must fit the tile buffers");

// small-parameter offsets (floats)
constexpr int SM_PB_B = 0, SM_L_B = 128, SM_F_B = 896, SM_V_B = 1024, SM_A_B = 1088,
              SM_R_B = 1104, SM_WQ = 1120, SM_WK = 1376, SM_WV = 1632, SM_FC = 1888,
              SM_LN_W = 2144, SM_LN_B = 2160, SM_O0_W = 2176, SM_O0_B = 2432,
              SM_O1_W = 2448, SM_O1_B = 2464, SM_TOTAL = 2465;
static_assert(SM_TOTAL == SM_O1_B + 1, "out_alpha_linear.2's bias ends the buffer");
static_assert(SM_TOTAL - SM_WQ <= TAIL_W && MAX_GROUPS < 112, "misc region");
static_assert((SM_WK - SM_WQ) % 4 == 0 && (SM_FC - SM_WQ) % 4 == 0 && (SM_LN_B - SM_WQ) % 4 == 0 &&
                  (SM_O0_W - SM_WQ) % 4 == 0 && (SM_O0_B - SM_WQ) % 4 == 0 &&
                  (SM_O1_W - SM_WQ) % 4 == 0,
              "the ray tail reads the 16-wide weights as float4");

// The wide layers in stream order: (K16 blocks, n8 tiles). The first entry's
// K16 count is the padded conditioning width / 16.
constexpr int N_LAYERS = 11;
__host__ __device__ inline void layer_shape(int l, int cd_kb, int& kb, int& nt) {
  const int KB[N_LAYERS] = {0, 4, 8, 8, 8, 8, 12, 8, 8, 9, 4};
  const int NT[N_LAYERS] = {16, 16, 16, 16, 16, 16, 16, 2, 16, 8, 2};
  kb = l == 0 ? cd_kb : KB[l];
  nt = NT[l];
}

// Ring groups of one tile pass: group g spans [off[g], off[g + 1]) of the
// fragment buffer (16-byte units). TF32: one K16 block per group (64 units
// per n8 tile); bf16: up to four K16 blocks (16 units per n8 tile). Returns
// the number of groups; with off == nullptr it only counts.
__host__ __device__ inline int group_table(bool bf16, int cd_kb, int* off) {
  const int kpg = bf16 ? 4 : 1, upt = bf16 ? 16 : 64;
  int n = 0, end = 0;
  if (off != nullptr) off[0] = 0;
  for (int l = 0; l < N_LAYERS; ++l) {
    int kb, nt;
    layer_shape(l, cd_kb, kb, nt);
    for (int k0 = 0; k0 < kb; k0 += kpg) {
      const int kbs = kb - k0 < kpg ? kb - k0 : kpg;
      end += kbs * upt * nt;
      if (off != nullptr) off[n + 1] = end;
      ++n;
    }
  }
  return n;
}

#ifdef KERNEL_C_PHASES
// Phase timing for matchnerf_tpu_torch/profile_decoder.py (built with
// -DKERNEL_C_PHASES only): threads 0 and 128 add the clock64 cycles since
// their previous mark to slot k (+ 32 for thread 128) of g_phases.
__device__ unsigned long long g_phases[64];
__device__ __forceinline__ int phase_slot() {
  return threadIdx.x == 0 ? 0 : (threadIdx.x == 128 ? 32 : -1);
}
__device__ __forceinline__ void phase(int k) {
  __shared__ unsigned long long last[2];
  const int w = phase_slot();
  if (w < 0) return;
  const unsigned long long t = clock64();
  if (k >= 0) atomicAdd(&g_phases[k + w], t - last[w / 32]);
  last[w / 32] = t;
}
#define PHASE(k) phase(k)
#define PHASE_WAIT(k, stmt)                                                     \
  do {                                                                          \
    const unsigned long long t0_ = clock64();                                   \
    stmt;                                                                       \
    if (phase_slot() >= 0) atomicAdd(&g_phases[(k) + phase_slot()], clock64() - t0_); \
  } while (0)
#else
#define PHASE(k)
#define PHASE_WAIT(k, stmt) stmt
#endif

struct Args {
  const float *pts, *ray_unit, *feat, *color, *mask, *depth, *ray;
  const float* small;
  const uint4* frag;
  const float* postab;
  float* out;
  int N, S, Gf, V, act, maskfill, wo_interval, setbg;
};

__device__ __forceinline__ float activate(float x, int act) {
  return act == 1 ? (x > 0.f ? x : expm1f(x)) : fmaxf(x, 0.f);
}

// ---- weight ring: bulk copies completing on mbarriers ---------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
// one contiguous run of global memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Streams the groups of the block's tile passes, in order, through STAGES
// slots: thread 0 keeps AHEAD groups in flight beyond the one in use, each
// one bulk copy that completes on the slot's `full` barrier; a warp frees a
// slot by arriving on its `empty` barrier when it asks for the next group.
// No block-wide barrier: warps drift apart by up to STAGES - AHEAD groups.
// Every warp calls next() for every group, in order.
struct Ring {
  uint4* base;
  const uint4* src;
  const int* off;
  uint64_t *full, *empty;
  int ng, total, fetched, fetch_g, cur;

  __device__ __forceinline__ void fetch() {
    if (fetched >= total) return;
    const int slot = fetched % STAGES;
    if (fetched >= STAGES) PHASE_WAIT(11, mbar_wait(empty + slot, (fetched / STAGES - 1) & 1));
    bulk_copy(base + slot * STAGE_U4, src + off[fetch_g], 16 * (off[fetch_g + 1] - off[fetch_g]),
              full + slot);
    ++fetched;
    if (++fetch_g == ng) fetch_g = 0;
  }
  __device__ __forceinline__ const uint4* next() {
    if (cur > 0) {
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(empty + (cur - 1) % STAGES);
    }
    if (threadIdx.x == 0)
      while (fetched < total && fetched <= cur + AHEAD) fetch();
    const int slot = cur % STAGES;
    PHASE_WAIT(10, mbar_wait(full + slot, (cur / STAGES) & 1));
    ++cur;
    return base + slot * STAGE_U4;
  }
};

// ---- tensor-core operand routes -------------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A operand of one K16 block of a warp's 16 rows, lane = 4 g + t.
// TF32: two k8 steps, slot t <-> column 2t, slot t + 4 <-> column 2t + 1;
// value order per step: (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1).
struct AF32 {
  uint32_t hi[2][4], lo[2][4];
  __device__ __forceinline__ void set(int s, float v0, float v1, float v2, float v3) {
    const float v[4] = {v0, v1, v2, v3};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[s][i] = tf32(v[i]);
      lo[s][i] = tf32(v[i] - __uint_as_float(hi[s][i]));
    }
  }
};
// bf16: (g, 2t..2t+1), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..).
struct ABF {
  uint32_t x[4];
};

template <int NT>
__device__ __forceinline__ void zero_tiles(float (&a)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
}

template <bool BF16>
struct Route;

template <>
struct Route<false> {
  using A = AF32;
  static constexpr int KPG = 1;          // K16 blocks per ring group
  static constexpr int UPT = 64;         // 16-byte units per (K16 block, n8 tile)
  // a layer's output kept as the next A operand: f32 in the accumulator layout
  typedef float H[16][4];
  template <int NT>
  static __device__ __forceinline__ void put(H& h, const float (&acc)[NT][4]) {
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) h[i][j] = acc[i][j];
  }
  // from the accumulators of the previous layer (n8 tiles 2kb, 2kb + 1)
  static __device__ __forceinline__ A regs(const H& h, int kb) {
    A a;
#pragma unroll
    for (int s = 0; s < 2; ++s)
      a.set(s, h[2 * kb + s][0], h[2 * kb + s][2], h[2 * kb + s][1], h[2 * kb + s][3]);
    return a;
  }
  // from row-major f32 rows X (stride XS), columns c0 .. c0 + 15
  static __device__ __forceinline__ A smem(const float* X, int c0, int lane) {
    const int g = lane >> 2, t = lane & 3;
    A a;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float2 p = *reinterpret_cast<const float2*>(X + g * XS + c0 + 8 * s + 2 * t);
      const float2 q = *reinterpret_cast<const float2*>(X + (g + 8) * XS + c0 + 8 * s + 2 * t);
      a.set(s, p.x, q.x, p.y, q.y);
    }
    return a;
  }
  // columns 128..143 of the views input: the direction (3), then zeros
  static __device__ __forceinline__ A dir(const float* misc, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const float* d0 = misc + g * 8 + 4;
    const float* d1 = misc + (g + 8) * 8 + 4;
    const float p0 = 2 * t < 3 ? d0[2 * t] : 0.f, p1 = 2 * t + 1 < 3 ? d0[2 * t + 1] : 0.f;
    const float q0 = 2 * t < 3 ? d1[2 * t] : 0.f, q1 = 2 * t + 1 < 3 ? d1[2 * t + 1] : 0.f;
    A a;
    a.set(0, p0, q0, p1, q1);
    a.set(1, 0.f, 0.f, 0.f, 0.f);
    return a;
  }
  // c += one group's product for n8 tile nt
  template <int NT, int KN>
  static __device__ __forceinline__ void group_tile(float (&c)[4], const A (&a)[KN], int kn,
                                                    const float4* w, int nt) {
#pragma unroll
    for (int j = 0; j < KN; ++j) {
      if (j < kn) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const float4 b = w[((j * 2 + s) * NT + nt) * 32];
          const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
          const uint32_t bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
          mma_tf32(c, a[j].lo[s], bh0, bh1);
          mma_tf32(c, a[j].hi[s], bl0, bl1);
          mma_tf32(c, a[j].hi[s], bh0, bh1);
        }
      }
    }
  }
  // acc += this group's product: per n8 tile, the group's MMAs into a zeroed
  // tile, then one f32 add, so the tensor core's truncating accumulation
  // only spans one group (the first group of a layer goes straight into the
  // zeroed accumulators: the same sums)
  template <int NT, int KN, bool FIRST>
  static __device__ __forceinline__ void mma(float (&acc)[NT][4], const A (&a)[KN], int kn,
                                             const uint4* st, int lane) {
    const float4* w = reinterpret_cast<const float4*>(st) + lane;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (FIRST) {
        group_tile<NT, KN>(acc[nt], a, kn, w, nt);
      } else {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        group_tile<NT, KN>(t, a, kn, w, nt);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] += t[i];
      }
    }
  }
};

template <>
struct Route<true> {
  using A = ABF;
  static constexpr int KPG = 4;
  static constexpr int UPT = 16;
  // every consumer rounds a layer's output to bf16: keep it rounded, as the
  // A fragments of its K16 blocks (half the registers of f32)
  typedef uint32_t H[8][4];
  template <int NT>
  static __device__ __forceinline__ void put(H& h, const float (&acc)[NT][4]) {
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      h[p][0] = pack_bf16(acc[2 * p][0], acc[2 * p][1]);
      h[p][1] = pack_bf16(acc[2 * p][2], acc[2 * p][3]);
      h[p][2] = pack_bf16(acc[2 * p + 1][0], acc[2 * p + 1][1]);
      h[p][3] = pack_bf16(acc[2 * p + 1][2], acc[2 * p + 1][3]);
    }
  }
  static __device__ __forceinline__ A regs(const H& h, int kb) {
    A a;
#pragma unroll
    for (int i = 0; i < 4; ++i) a.x[i] = h[kb][i];
    return a;
  }
  static __device__ __forceinline__ A smem(const float* X, int c0, int lane) {
    const int g = lane >> 2, t = lane & 3;
    A a;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = *reinterpret_cast<const float2*>(X + (g + 8 * (i & 1)) * XS + c0 +
                                                        8 * (i >> 1) + 2 * t);
      a.x[i] = pack_bf16(p.x, p.y);
    }
    return a;
  }
  static __device__ __forceinline__ A dir(const float* misc, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const float* d0 = misc + g * 8 + 4;
    const float* d1 = misc + (g + 8) * 8 + 4;
    A a;
    a.x[0] = pack_bf16(2 * t < 3 ? d0[2 * t] : 0.f, 2 * t + 1 < 3 ? d0[2 * t + 1] : 0.f);
    a.x[1] = pack_bf16(2 * t < 3 ? d1[2 * t] : 0.f, 2 * t + 1 < 3 ? d1[2 * t + 1] : 0.f);
    a.x[2] = 0u;
    a.x[3] = 0u;
    return a;
  }
  // (bf16 keeps a zeroed tile for every n8 tile of the group: the K16
  // blocks run outside, so NT independent MMAs follow each B load)
  template <int NT, int KN>
  static __device__ __forceinline__ void group(float (&c)[NT][4], const A (&a)[KN], int kn,
                                               const uint4* w) {
#pragma unroll
    for (int j = 0; j < KN; ++j) {
      if (j < kn) {
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          const uint4 b = w[(j * (NT / 2) + p) * 32];
          mma_bf16(c[2 * p], a[j].x, b.x, b.y);
          mma_bf16(c[2 * p + 1], a[j].x, b.z, b.w);
        }
      }
    }
  }
  template <int NT, int KN, bool FIRST>
  static __device__ __forceinline__ void mma(float (&acc)[NT][4], const A (&a)[KN], int kn,
                                             const uint4* st, int lane) {
    if (FIRST) {
      group<NT, KN>(acc, a, kn, st + lane);
    } else {
      float t[NT][4];
      zero_tiles(t);
      group<NT, KN>(t, a, kn, st + lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] += t[nt][i];
    }
  }
};

// One wide layer of KB K16 blocks (unrolled: `src(kb)` may index registers)
// into the warp's accumulators, one ring group at a time; every warp walks
// the ring, only warps with rows in the tile compute.
template <bool BF16, int NT, int KB, class Src>
__device__ __forceinline__ void dense(float (&acc)[NT][4], Ring& ring, bool active, int lane,
                                      Src src) {
  using R = Route<BF16>;
  constexpr int KPG = R::KPG;
  zero_tiles(acc);
#pragma unroll
  for (int g0 = 0; g0 < KB; g0 += KPG) {
    const uint4* st = ring.next();
    if (active) {
      typename R::A a[KPG];
#pragma unroll
      for (int j = 0; j < KPG; ++j)
        if (g0 + j < KB) a[j] = src(g0 + j < KB ? g0 + j : 0);
      const int kn = KB - g0 < KPG ? KB - g0 : KPG;
      if (g0 == 0) R::template mma<NT, KPG, true>(acc, a, kn, st, lane);
      else R::template mma<NT, KPG, false>(acc, a, kn, st, lane);
    }
  }
}

// The same with a run-time number of K16 blocks, A from shared memory.
template <bool BF16, int NT>
__device__ __forceinline__ void dense_smem(float (&acc)[NT][4], Ring& ring, bool active,
                                           int lane, int kbn, const float* X) {
  using R = Route<BF16>;
  constexpr int KPG = R::KPG;
  zero_tiles(acc);
#pragma unroll 1
  for (int g0 = 0; g0 < kbn; g0 += KPG) {
    const uint4* st = ring.next();
    if (active) {
      typename R::A a[KPG];
      const int kn = kbn - g0 < KPG ? kbn - g0 : KPG;
#pragma unroll
      for (int j = 0; j < KPG; ++j)
        if (j < kn) a[j] = R::smem(X, 16 * (g0 + j), lane);
      if (g0 == 0) R::template mma<NT, KPG, true>(acc, a, kn, st, lane);
      else R::template mma<NT, KPG, false>(acc, a, kn, st, lane);
    }
  }
}

// f(row 0..15, column c, value at c, value at c + 1) over a warp's
// accumulator tiles, by column pairs
template <int NT, class F>
__device__ __forceinline__ void each_pair(float (&acc)[NT][4], int lane, F f) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) f(g + 8 * h, 8 * nt + 2 * t, acc[nt][2 * h], acc[nt][2 * h + 1]);
}

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// f(row 0..15, column, value) over a warp's accumulator tiles
template <int NT, class F>
__device__ __forceinline__ void each_c(float (&acc)[NT][4], int lane, F f) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) f(g + 8 * (i >> 1), 8 * nt + 2 * t + (i & 1), acc[nt][i]);
}

struct Smem {
  uint4* ring;
  float *ovl, *misc, *w, *tok, *rgb, *nv, *dep, *alpha;
  int* off;
};

// The MLP over one tile of the ray's samples: writes tok, rgb, nv and depth
// of the samples row0 .. row0 + 127 of ray n.
template <bool BF16>
__device__ __forceinline__ void mlp_tile(const Args& a, const Smem& m, Ring& ring, int n,
                                         int tile, int cd_kb) {
  using R = Route<BF16>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = a.S, Gf = a.Gf, V = a.V, CD = Gf + 4 * V, CDP = 16 * cd_kb;
  const int row0 = tile * TILE + 16 * warp;
  const int nrows = max(0, min(16, S - row0));
  const bool active = nrows > 0;
  float* biasw = m.ovl + warp * 16 * BS;
  float* X = m.ovl + WARPS * 16 * BS + warp * 16 * XS;
  float* misc = m.misc + warp * 16 * 8;
  const float* sp = a.small;

  // ---- inputs of the warp's rows: conditioning into X (zero padding past
  // CD and past the last sample; a lane owns columns lane and lane + 32 and
  // starts all 16 rows' loads at once), point, direction and depth; nv from
  // the staged mask
  if (active) {
    const size_t base = (size_t)n * S + row0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c = lane + 32 * k;
      if (c >= CDP) break;
      const float* src = nullptr;
      int stride = 0;
      if (c < Gf) { src = a.feat + c; stride = Gf; }
      else if (c < Gf + 3 * V) { src = a.color + c - Gf; stride = 3 * V; }
      else if (c < CD) { src = a.mask + c - Gf - 3 * V; stride = V; }
      float v[16];
#pragma unroll
      for (int r = 0; r < 16; ++r)
        v[r] = (src != nullptr && r < nrows) ? __ldg(src + (base + r) * stride) : 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) X[r * XS + c] = v[r];
    }
    if (lane < 16) {
      const int r = lane;
      float* mr = misc + r * 8;
      float p[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f}, dp = 0.f;
      if (r < nrows) {
        const size_t s = base + r;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          p[k] = __ldg(a.pts + s * 3 + k);
          d[k] = __ldg(a.ray_unit + s * 3 + k);
        }
        dp = __ldg(a.depth + s);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        mr[k] = p[k];
        mr[4 + k] = d[k];
      }
      if (r < nrows) m.dep[row0 + r] = dp;
    }
    __syncwarp();
    if (lane < nrows) {
      float cnt = 0.f;
      for (int k = 0; k < V; ++k) cnt += X[lane * XS + Gf + 3 * V + k];
      m.nv[row0 + lane] = cnt;
    }
  }

  PHASE(0);
  // ---- bias = pts_bias(cond) into shared memory, accumulator layout
  float acc[16][4];
  typename R::H h;
  dense_smem<BF16, 16>(acc, ring, active, lane, cd_kb, X);
  if (active) {
    each_pair(acc, lane, [&](int r, int c, float& v0, float& v1) {
      const float2 b = ldg2(sp + SM_PB_B + c);
      *reinterpret_cast<float2*>(biasw + r * BS + c) = make_float2(v0 + b.x, v1 + b.y);
    });
    __syncwarp();
    // the encoding replaces the conditioning in X: lane -> row lane / 2,
    // frequencies 5 (lane & 1) .. + 4
    const int r = lane >> 1, half = lane & 1;
    const float* mr = misc + r * 8;
    float* xr = X + r * XS;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float p = mr[d];
      if (half == 0) xr[d] = p;
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const int l = 5 * half + j;
        float sn, cs;
        sincosf(p * (float)(1 << l), &sn, &cs);
        xr[3 + 3 * l + d] = sn;
        xr[33 + 3 * l + d] = cs;
      }
    }
    if (half == 1) xr[63] = 0.f;
    __syncwarp();
  }

  PHASE(1);
  auto epilogue = [&](int l) {
    const float* b = sp + SM_L_B + 128 * l;
    each_pair(acc, lane, [&](int r, int c, float& v0, float& v1) {
      const float2 bb = ldg2(b + c);
      const float2 pb = *reinterpret_cast<const float2*>(biasw + r * BS + c);
      v0 = fmaxf((v0 + bb.x) * pb.x, 0.f);
      v1 = fmaxf((v1 + bb.y) * pb.y, 0.f);
    });
    R::put(h, acc);
  };

  // ---- layer 0 (encoding), layers 1-4, layer 5 ([encoding, h])
  dense<BF16, 16, 4>(acc, ring, active, lane, [&](int kb) { return R::smem(X, 16 * kb, lane); });
  if (active) epilogue(0);
#pragma unroll 1
  for (int l = 1; l < 5; ++l) {
    dense<BF16, 16, 8>(acc, ring, active, lane, [&](int kb) { return R::regs(h, kb); });
    if (active) epilogue(l);
  }
  dense<BF16, 16, 12>(acc, ring, active, lane, [&](int kb) {
    return kb < 4 ? R::smem(X, 16 * kb, lane) : R::regs(h, kb < 4 ? 0 : kb - 4);
  });
  if (active) epilogue(5);
  PHASE(2);

  // ---- alpha token
  {
    float ta[2][4];
    dense<BF16, 2, 8>(ta, ring, active, lane, [&](int kb) { return R::regs(h, kb); });
    if (active)
      each_c(ta, lane, [&](int r, int c, float& v) {
        const int s = row0 + r;
        if (r < nrows) {
          float t = activate(v + __ldg(sp + SM_A_B + c), a.act);
          if (a.postab != nullptr) t += __ldg(a.postab + s * 16 + c);
          m.tok[s * 16 + c] = t;
        }
      });
  }
  // ---- rgb branch: feature (no activation), views ([feature, dir]), rgb
  dense<BF16, 16, 8>(acc, ring, active, lane, [&](int kb) { return R::regs(h, kb); });
  if (active) {
    each_pair(acc, lane, [&](int, int c, float& v0, float& v1) {
      const float2 b = ldg2(sp + SM_F_B + c);
      v0 += b.x;
      v1 += b.y;
    });
    R::put(h, acc);
  }
  {
    float av[8][4];
    dense<BF16, 8, 9>(av, ring, active, lane, [&](int kb) {
      return kb < 8 ? R::regs(h, kb < 8 ? kb : 0) : R::dir(misc, lane);
    });
    if (active) {
      each_pair(av, lane, [&](int, int c, float& v0, float& v1) {
        const float2 b = ldg2(sp + SM_V_B + c);
        v0 = fmaxf(v0 + b.x, 0.f);
        v1 = fmaxf(v1 + b.y, 0.f);
      });
      R::put(h, av);
    }
  }
  {
    float ar[2][4];
    dense<BF16, 2, 4>(ar, ring, active, lane, [&](int kb) { return R::regs(h, kb); });
    if (active)
      each_c(ar, lane, [&](int r, int c, float& v) {
        if (r < nrows && c < 3)
          m.rgb[(row0 + r) * 4 + c] = 1.f / (1.f + expf(-(v + __ldg(sp + SM_R_B + c))));
      });
  }
  PHASE(3);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

// Online softmax of one query over base-2 scores: rescale() takes a block
// of scores (raising the running max), add() one key's weight and value.
struct Softmax4 {
  float mx = -INFINITY, sum = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  template <int U>
  __device__ __forceinline__ void rescale(float (&x)[U]) {
    float cm = x[0];
#pragma unroll
    for (int u = 1; u < U; ++u) cm = fmaxf(cm, x[u]);
    const float mn = fmaxf(mx, cm), c = ex2(mx - mn);
    sum *= c;
    o.x *= c; o.y *= c; o.z *= c; o.w *= c;
    mx = mn;
  }
  __device__ __forceinline__ void add(float x, float4 v) {
    const float e = ex2(x - mx);
    sum += e;
    o.x = fmaf(e, v.x, o.x); o.y = fmaf(e, v.y, o.y);
    o.z = fmaf(e, v.z, o.z); o.w = fmaf(e, v.w, o.w);
  }
  __device__ __forceinline__ float4 out() const {
    const float r = 1.f / sum;
    return make_float4(o.x * r, o.y * r, o.z * r, o.w * r);
  }
};

// 8 consecutive floats from 16-byte aligned shared memory
__device__ __forceinline__ void load8(const float* p, float (&r)[8]) {
  const float4 x = *reinterpret_cast<const float4*>(p), y = *reinterpret_cast<const float4*>(p + 4);
  r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
  r[4] = y.x; r[5] = y.y; r[6] = y.z; r[7] = y.w;
}

// Brings ray n's inputs into L2 (the block's next ray, while it finishes
// this one), so the next tile's staging loads do not wait on device memory.
__device__ __forceinline__ void prefetch_ray(const Args& a, int n) {
  const int S = a.S;
  const float* src[6] = {a.feat, a.color, a.mask, a.pts, a.ray_unit, a.depth};
  const int width[6] = {a.Gf, 3 * a.V, a.V, 3, 3, 1};
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const uintptr_t p0 = reinterpret_cast<uintptr_t>(src[k] + (size_t)n * S * width[k]);
    const uintptr_t first = p0 & ~uintptr_t(127);
    const uintptr_t last = (p0 + S * width[k] * 4 - 1) & ~uintptr_t(127);
    const int lines = (int)((last - first) / 128) + 1;
    for (int i = threadIdx.x; i < lines; i += THREADS)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(first + 128 * (uintptr_t)i));
  }
}

// The ray transformer, the density head and the composite of ray n. The
// 16-wide weights are in shared memory (m.w, offsets SM_* - SM_WQ).
__device__ __forceinline__ void ray_tail(const Args& a, const Smem& m, int n, int Sp) {
  const int tid = threadIdx.x, lane = tid & 31, S = a.S;
  const float* w = m.w - SM_WQ;
  float* qb = m.ovl;                      // q * log2(e) / 2, then the output
  float* kb = qb + Sp * 16;
  float* vb = kb + Sp * 16;

  // ---- q, k, v: two threads per sample, 8 outputs each. A query that fewer
  // than 2 views see is zero: its scores are all 0 and its attention is
  // uniform, the plain version's fill of the query row.
  for (int i = tid; i < 2 * S; i += THREADS) {
    const int s = i >> 1, o0 = (i & 1) * 8;
    float t[16], q[8], k[8], v[8];
#pragma unroll
    for (int d = 0; d < 16; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(m.tok + s * 16 + d);
      t[d] = x.x; t[d + 1] = x.y; t[d + 2] = x.z; t[d + 3] = x.w;
    }
#pragma unroll
    for (int o = 0; o < 8; ++o) q[o] = k[o] = v[o] = 0.f;
#pragma unroll
    for (int d = 0; d < 16; ++d) {
      float wq[8], wk[8], wv[8];
      load8(w + SM_WQ + d * 16 + o0, wq);
      load8(w + SM_WK + d * 16 + o0, wk);
      load8(w + SM_WV + d * 16 + o0, wv);
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        q[o] = fmaf(t[d], wq[o], q[o]);
        k[o] = fmaf(t[d], wk[o], k[o]);
        v[o] = fmaf(t[d], wv[o], v[o]);
      }
    }
    // scores q.k / sqrt(d_k) in base 2: softmax by exp2
    const float qs = m.nv[s] > 1.f ? 0.5f * 1.4426950408889634f : 0.f;
#pragma unroll
    for (int o = 0; o < 8; o += 4) {
      *reinterpret_cast<float4*>(qb + s * 16 + o0 + o) =
          make_float4(q[o] * qs, q[o + 1] * qs, q[o + 2] * qs, q[o + 3] * qs);
      *reinterpret_cast<float4*>(kb + s * 16 + o0 + o) =
          make_float4(k[o], k[o + 1], k[o + 2], k[o + 3]);
      *reinterpret_cast<float4*>(vb + s * 16 + o0 + o) =
          make_float4(v[o], v[o + 1], v[o + 2], v[o + 3]);
    }
  }
  __syncthreads();
  PHASE(5);

  // ---- attention: a lane takes one head of two samples (s and s + 32), an
  // online softmax over blocks of 8 keys; a warp shares the head, so each
  // k and v load is a broadcast that feeds both queries. The output
  // replaces q.
  const int S8 = S & ~7;
  for (int task = tid; task < 128 * ((S + 63) / 64); task += THREADS) {
    const int c = task >> 5, hd = (c & 3) * 4, s0 = (c >> 2) * 64 + (task & 31), s1 = s0 + 32;
    if (s0 >= S) continue;
    const bool has1 = s1 < S;
    const float4 q0 = *reinterpret_cast<const float4*>(qb + s0 * 16 + hd);
    const float4 q1 = has1 ? *reinterpret_cast<const float4*>(qb + s1 * 16 + hd)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    Softmax4 a0, a1;
    const float* kp = kb + hd;
    const float* vp = vb + hd;
    for (int j0 = 0; j0 < S8; j0 += 8) {
      float x0[8], x1[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float4 k = *reinterpret_cast<const float4*>(kp + (j0 + u) * 16);
        x0[u] = dot4(q0, k);
        x1[u] = dot4(q1, k);
      }
      a0.rescale(x0);
      a1.rescale(x1);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float4 v = *reinterpret_cast<const float4*>(vp + (j0 + u) * 16);
        a0.add(x0[u], v);
        a1.add(x1[u], v);
      }
    }
    for (int j = S8; j < S; ++j) {        // the last S % 8 keys
      const float4 k = *reinterpret_cast<const float4*>(kp + j * 16);
      const float4 v = *reinterpret_cast<const float4*>(vp + j * 16);
      float x0[1] = {dot4(q0, k)}, x1[1] = {dot4(q1, k)};
      a0.rescale(x0);
      a1.rescale(x1);
      a0.add(x0[0], v);
      a1.add(x1[0], v);
    }
    *reinterpret_cast<float4*>(qb + s0 * 16 + hd) = a0.out();
    if (has1) *reinterpret_cast<float4*>(qb + s1 * 16 + hd) = a1.out();
  }
  __syncthreads();
  PHASE(6);

  // ---- fc + residual, LayerNorm, density head: two lanes per sample, 8
  // channels each, joined by shuffles
  for (int i0 = 0; i0 < 2 * S; i0 += THREADS) {
    const int i = i0 + tid, s = min(i >> 1, S - 1), c0 = (i & 1) * 8;
    float at[16], y[8];
#pragma unroll
    for (int d = 0; d < 16; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(qb + s * 16 + d);
      at[d] = x.x; at[d + 1] = x.y; at[d + 2] = x.z; at[d + 3] = x.w;
    }
    float z[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, wr[8];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      load8(w + SM_FC + k * 16 + c0, wr);
#pragma unroll
      for (int c = 0; c < 8; ++c) z[c] = fmaf(at[k], wr[c], z[c]);
    }
    float mu = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      y[c] = z[c] + m.tok[s * 16 + c0 + c];
      mu += y[c];
    }
    mu = (mu + __shfl_xor_sync(0xffffffffu, mu, 1)) / 16.f;
    float var = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) var += (y[c] - mu) * (y[c] - mu);
    var = (var + __shfl_xor_sync(0xffffffffu, var, 1)) / 16.f;
    const float sd = sqrtf(var + 1e-6f);
    float yn[16], lw[8], lb[8];   // the pair swaps halves
    load8(w + SM_LN_W + c0, lw);
    load8(w + SM_LN_B + c0, lb);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float mine = (y[c] - mu) / sd * lw[c] + lb[c];
      const float other = __shfl_xor_sync(0xffffffffu, mine, 1);
      yn[c] = c0 == 0 ? mine : other;
      yn[8 + c] = c0 == 0 ? other : mine;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) z[c] = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      load8(w + SM_O0_W + k * 16 + c0, wr);
#pragma unroll
      for (int c = 0; c < 8; ++c) z[c] = fmaf(yn[k], wr[c], z[c]);
    }
    float ob[8], o1[8], al = 0.f;
    load8(w + SM_O0_B + c0, ob);
    load8(w + SM_O1_W + c0, o1);
#pragma unroll
    for (int c = 0; c < 8; ++c) al = fmaf(activate(z[c] + ob[c], a.act), o1[c], al);
    al += __shfl_xor_sync(0xffffffffu, al, 1);
    al = fmaxf(al + w[SM_O1_B], 0.f);
    if (a.maskfill && m.nv[s] < 1.f) al = 0.f;
    if (i < 2 * S && c0 == 0) m.alpha[s] = al;
  }
  __syncthreads();
  PHASE(7);

  // ---- composite: exclusive transmittance scan, one warp, 32 samples a step
  if (tid < 32) {
    float rl = 1.f;
    if (!a.wo_interval) {
      const float* rr = a.ray + (size_t)n * 3;
      rl = sqrtf(rr[0] * rr[0] + rr[1] * rr[1] + rr[2] * rr[2]);
    }
    float carry = 0.f, cr = 0.f, cgr = 0.f, cb = 0.f, cd = 0.f, co = 0.f;
    for (int c0 = 0; c0 < S; c0 += 32) {
      const int s = c0 + lane;
      float sdelta = 0.f;
      if (s < S) {
        sdelta = m.alpha[s];
        if (!a.wo_interval) {
          const float intv = (s + 1 < S) ? m.dep[s + 1] - m.dep[s] : 1e10f;
          sdelta = m.alpha[s] * (intv * rl);
        }
      }
      float incl = sdelta;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      if (s < S) {
        const float prob = expf(-(carry + excl)) * (1.f - expf(-sdelta));
        cr = fmaf(m.rgb[s * 4 + 0], prob, cr);
        cgr = fmaf(m.rgb[s * 4 + 1], prob, cgr);
        cb = fmaf(m.rgb[s * 4 + 2], prob, cb);
        cd = fmaf(m.dep[s], prob, cd);
        co += prob;
      }
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      cr += __shfl_xor_sync(0xffffffffu, cr, off);
      cgr += __shfl_xor_sync(0xffffffffu, cgr, off);
      cb += __shfl_xor_sync(0xffffffffu, cb, off);
      cd += __shfl_xor_sync(0xffffffffu, cd, off);
      co += __shfl_xor_sync(0xffffffffu, co, off);
    }
    if (lane == 0) {
      if (a.setbg) { cr += 1.f - co; cgr += 1.f - co; cb += 1.f - co; }
      float* o = a.out + (size_t)n * 5;
      o[0] = cr; o[1] = cgr; o[2] = cb; o[3] = cd; o[4] = co;
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1) cond_nerf_decode_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int S = a.S, Sp = (S + 3) & ~3;
  const int cd_kb = (a.Gf + 4 * a.V + 15) / 16;
  Smem m;
  m.ring = reinterpret_cast<uint4*>(sm);
  m.ovl = sm + RING_FLOATS;
  m.misc = m.ovl + OVL_FLOATS;
  uint64_t* bars = reinterpret_cast<uint64_t*>(m.misc + WARPS * 16 * 8);   // 8-byte aligned
  m.off = reinterpret_cast<int*>(bars + 2 * STAGES);
  m.w = reinterpret_cast<float*>(m.off + 112);
  m.tok = m.misc + MISC_FLOATS;
  m.rgb = m.tok + Sp * 16;
  m.nv = m.rgb + Sp * 4;
  m.dep = m.nv + Sp;
  m.alpha = m.dep + Sp;

  if (threadIdx.x == 0) {
    group_table(BF16, cd_kb, m.off);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(bars + i, 1);
      mbar_init(bars + STAGES + i, WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < SM_TOTAL - SM_WQ; i += THREADS) m.w[i] = __ldg(a.small + SM_WQ + i);
  __syncthreads();
  const int ntiles = (S + TILE - 1) / TILE;
  const int my_rays = (a.N - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  Ring ring;
  ring.base = m.ring;
  ring.src = a.frag;
  ring.off = m.off;
  ring.full = bars;
  ring.empty = bars + STAGES;
  ring.ng = group_table(BF16, cd_kb, nullptr);
  ring.total = my_rays * ntiles * ring.ng;
  ring.fetched = ring.fetch_g = ring.cur = 0;

  for (int n = blockIdx.x; n < a.N; n += gridDim.x) {
    __syncthreads();                      // the previous ray's tail is done
    PHASE(-1);
    for (int tile = 0; tile < ntiles; ++tile) mlp_tile<BF16>(a, m, ring, n, tile, cd_kb);
    __syncthreads();
    PHASE(4);
    if (n + (int)gridDim.x < a.N) prefetch_ray(a, n + gridDim.x);
    ray_tail(a, m, n, Sp);
    PHASE(9);
  }
}

template <bool BF16>
int launch(const Args& a, int frag_units, cudaStream_t stream) {
  const int CD = a.Gf + 4 * a.V;
  if (a.N < 0 || a.S < 1 || a.S > S_MAX || a.Gf < 0 || a.V < 1 || CD > CD_MAX ||
      (a.act != 0 && a.act != 1))
    return (int)cudaErrorInvalidValue;
  int off[MAX_GROUPS + 1];
  const int ng = group_table(BF16, (CD + 15) / 16, off);
  if (ng > MAX_GROUPS || off[ng] != frag_units) return (int)cudaErrorInvalidValue;
  if (a.N == 0) return (int)cudaGetLastError();
  const int Sp = (a.S + 3) & ~3;
  const size_t smem = ((size_t)FIXED_FLOATS + (size_t)RAY_FLOATS_PER_SAMPLE * Sp) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(cond_nerf_decode_kernel<BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, cond_nerf_decode_kernel<BF16>, THREADS, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = a.N < sms * per_sm ? a.N : sms * per_sm;
  cond_nerf_decode_kernel<BF16><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

Args make_args(const void* pts, const void* ray_unit, const void* feat, const void* color,
               const void* mask, const void* depth, const void* ray, const void* small,
               const void* frag, const void* postab, void* out, int N, int S, int Gf, int V,
               int act, int maskfill, int wo_interval, int setbg) {
  Args a;
  a.pts = static_cast<const float*>(pts);
  a.ray_unit = static_cast<const float*>(ray_unit);
  a.feat = static_cast<const float*>(feat);
  a.color = static_cast<const float*>(color);
  a.mask = static_cast<const float*>(mask);
  a.depth = static_cast<const float*>(depth);
  a.ray = static_cast<const float*>(ray);
  a.small = static_cast<const float*>(small);
  a.frag = static_cast<const uint4*>(frag);
  a.postab = static_cast<const float*>(postab);
  a.out = static_cast<float*>(out);
  a.N = N; a.S = S; a.Gf = Gf; a.V = V;
  a.act = act; a.maskfill = maskfill; a.wo_interval = wo_interval; a.setbg = setbg;
  return a;
}

}  // namespace

// pts, ray_unit, feat, color, mask, depth, ray, small (SM_TOTAL f32), frag
// (route's fragment buffer, frag_units 16-byte units), postab [S][16] or
// NULL, out [N][5]; returns cudaGetLastError().
#define COND_NERF_DECODE_ENTRY(NAME, BF16)                                                   \
  extern "C" int NAME(const void* pts, const void* ray_unit, const void* feat,              \
                      const void* color, const void* mask, const void* depth,               \
                      const void* ray, const void* small, const void* frag,                 \
                      const void* postab, void* out, int frag_units, int N, int S, int Gf,  \
                      int V, int act, int maskfill, int wo_interval, int setbg,             \
                      void* stream) {                                                        \
    return launch<BF16>(make_args(pts, ray_unit, feat, color, mask, depth, ray, small, frag, \
                                  postab, out, N, S, Gf, V, act, maskfill, wo_interval,      \
                                  setbg),                                                    \
                        frag_units, static_cast<cudaStream_t>(stream));                      \
  }

COND_NERF_DECODE_ENTRY(cond_nerf_decode_f32, false)
COND_NERF_DECODE_ENTRY(cond_nerf_decode_bf16, true)

#ifdef KERNEL_C_PHASES
// Copies the 64 phase counters to dst (host memory) and zeroes them.
extern "C" int cond_nerf_decode_phases(void* dst) {
  cudaError_t err = cudaMemcpyFromSymbol(dst, g_phases, sizeof(g_phases));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zeros[64] = {};
  return (int)cudaMemcpyToSymbol(g_phases, zeros, sizeof(g_phases));
}
#endif
