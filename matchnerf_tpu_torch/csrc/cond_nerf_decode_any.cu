// Kernel Cg: the CondNeRF decoder with the emission-absorption composite, at
// every decoder shape the TPU kernel takes.
//
// Replaces matchnerf_tpu/ops/pallas_decoder.py::cond_nerf_decode with
// fold_composite=True wherever Kernel C (cond_nerf_decode.cu, the shipped
// width-128 depth-6 decoder) does not apply: any even net_width from 32 to
// 512, net_depth 1 to 16, any skip set, posenc L_3D and L_view 0 to 10 (the
// view encoding beside the direction), legacy (pi-less, frequency-major) or
// standard (pi-scaled, interleaved) encoding, raytrans_act ReLU, ELU or GELU
// (tanh form, as jax.nn.gelu), a conditioning width Gf + 4V up to 128 and
// 1 <= S <= 512 samples per ray. Plain version and wrapper:
// matchnerf_tpu_torch/ops/decoder.py (`cond_nerf_decode_plain`,
// `pack_any`, `any_fragments`).
//
// Per ray of S samples:
//   enc  = [p, posenc(p)]                          (E = 3 + 6 L_3D wide)
//   bias = pts_bias([feat, color, mask])           (W wide)
//   h    = relu((W_l h + b_l) * bias), D layers, h = [enc, h] after each
//          layer named in skip
//   tok  = act(alpha_linear(h)) (+ sinusoid table when raytrans_posenc)
//   4-head ray attention over the samples, fc, residual, LayerNorm eps 1e-6,
//   out_alpha_linear -> density (relu; 0 where no view sees the point with
//   maskfill)
//   rgb  = sigmoid(rgb_linear(relu(views_linear([feature_linear(h),
//          [d, posenc(d)]]))))
//   then the composite: rgb, depth and opacity of the ray.
//
// The wide products (pts_bias, pts_linears, alpha_linear, feature_linear,
// views_linears.0, rgb_linear) run on the tensor cores (mma.sync) with f32
// accumulation, on both operand routes, as Kernel C's:
// - f32 (the default): split TF32. Each operand is a = a_hi + a_lo with
//   a_hi = tf32(a); the product takes hi*hi + hi*lo + lo*hi (m16n8k8).
//   Activations and weights are split as they enter each product (the
//   weights stream as f32: half the bytes of a split kept in memory). The
//   tensor core truncates as it accumulates, so each k8 step sums into a
//   zeroed tile that one f32 add puts into the accumulator: the truncation
//   spans one step.
// - bf16 (precision.decoder_matmul_dtype: bf16): the host rounds the
//   weights to bf16, every activation that enters a wide product is
//   rounded to bf16 as it is written to shared memory, and each k8 half of
//   a k16 step (m16n8k8 of bf16 operands) goes into a zeroed tile, then
//   into the f32 accumulator.
// Everything else is f32 on the CUDA cores: the bias multiply and the
// activations, and the ray tail (ray_tail.cuh, Kernel C's: the 16-wide
// w_qs/w_ks/w_vs/fc, the ray attention and its softmax, the LayerNorm,
// out_alpha_linear, the composite).
//
// What bounds it: the product loops. At the NeRF MLP (256x8, L_view 4)
// the wide products are 1.2 MFLOP a sample (3x that in split TF32), and
// every tile of T samples reads all the layers' weights from L2 again (2.5
// MB in f32, 1.2 MB in bf16). Beside each round of products a warp issues
// the operand splits and the zeroed tiles' adds, and its chains of
// dependent products wait with the register file full: the tensor cores
// run well below mma.sync's rate (python -m
// matchnerf_tpu_torch.profile_decoder prints the TFLOP/s). Design
// (mma.sync, as Kernel C: its fragment layouts and split-TF32 route are
// proven on this card; wgmma's 64-row warpgroup tiles with asynchronous
// accumulators are the way past it, a redesign of their own):
// - One persistent block of 8 warps per SM walks over rays; a ray's samples
//   go through the MLP in tiles of T samples (128, 64, 32 or 16: the most
//   whose outputs the warps' registers hold, 64 accumulators a thread, and
//   whose buffers fit, no more than the ray needs). A warp owns 16 MR rows
//   (samples; MR = 2, 1 at T = 16) and a band of 8 / MR n16 pairs of the
//   layer's output columns, so a B fragment (and its split) feeds MR
//   products; the f32 route issues each of a pair's three product rounds
//   for all its 2 MR tiles before the next (independent chains). A layer's
//   products are one piece of code (`layer_mma`), its epilogue apart.
// - The activations live in shared memory sample-major ([T][stride], the
//   stride 8 past a multiple of 32 floats: a warp's A fragment and its
//   epilogue's float2 stores are conflict-free): the tile's h (or its
//   conditioning, before pts_bias) and the point and direction encodings.
//   A layer keeps its outputs in registers until every warp has read its
//   last input, then its epilogue overwrites h in place. pts_bias's output
//   stays in each warp's registers for the pts_linears' epilogues (every
//   one of these layers gives a warp the same outputs).
// - The weights (`any_fragments`: each layer's [K, np] matrix padded to k8
//   steps (f32) or k16 steps (bf16) and n16 pairs with zeros, per k-step
//   and pair 32 lanes x 16 bytes in the B-fragment order of mma.sync's
//   m16n8k8 (f32) or m16n8k16 (bf16)) stream from L2 through a ring of
//   `stages` slots, kg k-steps a slot (up to 64 KB of a layer's rows):
//   bulk copies (cp.async.bulk) that complete on an mbarrier, issued by one
//   thread stages - 1 groups ahead across layers, tiles and rays (through
//   the ray tail too); one block barrier a group frees a slot.
// - Padding makes every width a multiple of 8 with zero weights and biases,
//   so padded channels stay exactly 0 through the layers; the k16 step past
//   a bf16 layer's last 8 rows reads zeros.
// - Only what the ray's attention and composite need outlives a tile: the
//   16-wide token, rgb, the number of views that see the sample and its
//   depth (92 bytes per sample); q, k, v overlay the activations.
// Shared memory: the ring (stages x kg k-steps of the widest layer), the
// three activation buffers (at least 48 Sp floats) and 23 Sp floats, Sp =
// S rounded up to 4: at the NeRF MLP and S = 128, T = 64, 3 stages of 4
// k-steps (32 KB on either route) and 3 x 64 rows: 206,400 bytes.
//
// Parameter buffers (the layout `pack_any` and `any_fragments` write):
// - small (f32): the ray tail's weights (ray_tail.cuh TW_*), then from
//   SM_BIAS the biases of pts_bias [W8], the D pts_linears [W8 each],
//   alpha_linear [16], feature_linear [W8], views_linears.0 [H8 = W/2
//   rounded up to 8] and rgb_linear [8].
// - fragments (16-byte units): each wide layer in the order pts_bias (K =
//   CD8), pts_linears 0 .. D-1 (layer 0: E8; a layer after a skip: E8
//   encoding rows then W8 h rows; else W8), alpha_linear (W8 x 16),
//   feature_linear (W8 x W8), views_linears.0 (W8 feature rows then Ev8
//   direction rows, x H8), rgb_linear (H8 x 8); per k-step (8 rows f32, 16
//   rows bf16) and n16 pair of ceil16(np) columns, lane 4g + t holds f32
//   {W[2t][n], W[2t+1][n], W[2t][n+8], W[2t+1][n+8]} (n = 16 pair + g; the
//   k8 step's rows permuted so that slot t takes row 2t, slot t + 4 row
//   2t + 1) or 8 bf16 {W[2t..2t+1][n], W[2t+8..2t+9][n], the same at n+8}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int S_MAX = 512;
constexpr int W_MIN = 32, W_MAX = 512, D_MAX = 16, L_MAX = 10, CD_MAX = 128;
constexpr int MAX_LAYERS = D_MAX + 5;
// a warp's outputs: MR m16 row tiles x pairs<MR>() n16 column pairs, 64
// accumulators a thread
template <int MR>
__host__ __device__ constexpr int pairs_of() { return 8 / MR; }
// the m16 tiles a warp takes at a tile of T samples
__host__ __device__ constexpr int tile_mr(int T) { return T >= 32 ? 2 : 1; }
constexpr int MAX_STAGES = 3;
constexpr int BAR_BYTES = 64;           // the ring's mbarriers (keeps what follows 16-byte aligned)
constexpr int RAY_FLOATS_PER_SAMPLE = 16 + 4 + 3;   // tok, rgb, nv/depth/alpha

#include "ray_tail.cuh"

// the wide layers' biases in the small buffer, after the ray tail's weights
constexpr int SM_BIAS = 1348;
static_assert(SM_BIAS >= TW_FLOATS && SM_BIAS % 4 == 0, "the biases follow the tail");
static_assert(BAR_BYTES >= 8 * MAX_STAGES && BAR_BYTES % 16 == 0, "the mbarriers' region");

// what a layer's epilogue does with its sums
enum Kind { K_BIAS, K_PTS, K_ALPHA, K_FEATURE, K_VIEWS, K_RGB };
// the shared-memory buffers a layer reads
enum Src { B_H, B_E, B_R };

struct Layer {
  int k1, k2;       // input rows from src1, then from src2 (multiples of 8)
  int src1, src2;
  int np;           // outputs, padded to 8: the columns the epilogue writes
  int nt;           // n8 tiles of its fragments (np rounded up to 16, / 8)
  int ks;           // k-steps: K / 8 (f32) or ceil(K / 16) (bf16)
  int units;        // 16-byte units of one k-step (32 lanes x one unit a n16 pair)
  int kind, boff;   // the epilogue, and the bias's offset in the small buffer
  int foff;         // the layer's first unit in the fragment buffer
};

struct Plan {
  int W8, H8, E8, Ev8, CD8, HR;
  int n_layers, n_units, n_small, max_units, max_nt;
  Layer layer[MAX_LAYERS];
};

__host__ __device__ inline int ceil8(int x) { return (x + 7) & ~7; }
__host__ __device__ inline int ceil16(int x) { return (x + 15) & ~15; }
// a sample-major row stride (floats): 8 past a multiple of 32
__host__ __device__ inline int row_stride(int x) { return ((x + 31) & ~31) + 8; }

// The layers in stream order and their fragments' sizes, from the decoder's
// shape and the route; skip_mask bit l: pts_linears[l] reads [enc, h] (l - 1
// is in skip).
inline Plan make_plan(int W, int D, int skip_mask, int E, int Ev, int CD, bool bf16) {
  Plan p;
  p.W8 = ceil8(W);
  p.H8 = ceil8(W / 2);
  p.E8 = ceil8(E);
  p.Ev8 = ceil8(Ev);
  p.CD8 = ceil8(CD);
  p.HR = p.W8 > p.CD8 ? p.W8 : p.CD8;
  p.max_units = p.max_nt = 0;
  int n = 0, foff = 0, boff = SM_BIAS;
  auto add = [&](int k1, int src1, int k2, int src2, int np, int kind) {
    Layer& l = p.layer[n++];
    l.k1 = k1; l.src1 = src1; l.k2 = k2; l.src2 = src2;
    l.np = np; l.kind = kind; l.boff = boff;
    l.nt = ceil16(np) / 8;
    l.ks = bf16 ? (k1 + k2 + 15) / 16 : (k1 + k2) / 8;
    l.units = l.nt / 2 * 32;
    l.foff = foff;
    foff += l.ks * l.units;
    boff += np;
    if (l.units > p.max_units) p.max_units = l.units;
    if (l.nt > p.max_nt) p.max_nt = l.nt;
  };
  add(p.CD8, B_H, 0, B_H, p.W8, K_BIAS);
  for (int l = 0; l < D; ++l) {
    if (l == 0) add(p.E8, B_E, 0, B_H, p.W8, K_PTS);
    else if ((skip_mask >> l) & 1) add(p.E8, B_E, p.W8, B_H, p.W8, K_PTS);
    else add(p.W8, B_H, 0, B_H, p.W8, K_PTS);
  }
  add(p.W8, B_H, 0, B_H, 16, K_ALPHA);
  add(p.W8, B_H, 0, B_H, p.W8, K_FEATURE);
  add(p.W8, B_H, p.Ev8, B_R, p.H8, K_VIEWS);
  add(p.H8, B_H, 0, B_H, 8, K_RGB);
  p.n_layers = n;
  p.n_units = foff;
  p.n_small = boff;
  return p;
}

struct Args {
  const float *pts, *ray_unit, *feat, *color, *mask, *depth, *ray;
  const float* small;
  const uint4* frag;
  const float* postab;
  float* out;
  int N, S, Gf, V, L3, Lv, legacy, act, maskfill, wo_interval, setbg, T, stages, kg;
  Plan p;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---- the weight ring: bulk copies completing on mbarriers ------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
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

// The groups of kg k-steps of every layer of every tile the block decodes
// (a layer's last group may hold fewer), in order, through `stages` slots.
// Every thread keeps the same counters; thread 0 issues the copies. A
// group's slot is reissued only after the block barrier that follows the
// group's products.
struct Ring {
  uint4* slots;
  uint64_t* full;
  const uint4* src;
  const Plan* p;
  int stages, slot_units, kg, total, issued, consumed, il, is;

  __device__ __forceinline__ void issue() {
    if (issued >= total) return;
    const Layer& L = p->layer[il];
    const int n = min(kg, L.ks - is);
    if (threadIdx.x == 0) {
      const int slot = issued % stages;
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_copy(slots + (size_t)slot * slot_units, src + L.foff + (size_t)is * L.units,
                16 * n * L.units, full + slot);
    }
    ++issued;
    is += n;
    if (is == L.ks) {
      is = 0;
      if (++il == p->n_layers) il = 0;
    }
  }
  // the next group's weights, once they have landed (call after the
  // barrier that frees the slot issue() refills)
  __device__ __forceinline__ const uint4* next() {
    issue();
    const int slot = consumed % stages;
    mbar_wait(full + slot, (consumed / stages) & 1);
    ++consumed;
    return slots + (size_t)slot * slot_units;
  }
};

// ---- tensor-core operand routes (Kernel C's) -------------------------------

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

__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], uint32_t a0, uint32_t a1,
                                            uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Smem {
  float *H, *E, *R;
  float *tok, *rgb, *nv, *dep, *alpha;
  int T, SH, SE, SR;
  __device__ __forceinline__ const float* buf(int id) const {
    return id == B_E ? E : (id == B_R ? R : H);
  }
  __device__ __forceinline__ int stride(int id) const {
    return id == B_E ? SE : (id == B_R ? SR : SH);
  }
};

// the 8 input columns k0 .. k0 + 7 of a layer (k0 a multiple of 8): their
// buffer and stride, or nullptr past the layer's last row
struct Cols {
  const float* x;
  int stride;
};
__device__ __forceinline__ Cols cols_of(const Smem& m, const Layer& L, int k0) {
  if (k0 < L.k1) return {m.buf(L.src1) + k0, m.stride(L.src1)};
  if (k0 < L.k1 + L.k2) return {m.buf(L.src2) + (k0 - L.k1), m.stride(L.src2)};
  return {nullptr, 0};
}

__device__ __forceinline__ float2 cols2(const Cols& c, int row, int t) {
  return c.x ? *reinterpret_cast<const float2*>(c.x + row * c.stride + 2 * t)
             : make_float2(0.f, 0.f);
}

template <int MR>
using Tiles = float[MR][2 * pairs_of<MR>()][4];

// A warp's share of one layer's outputs: rows r0 .. r0 + 16 MR - 1 and the
// npw n16 pairs from pair p0 (none where the layer has fewer columns than
// the warps' bands).
struct Band {
  int r0, p0, npw;
  template <int MR>
  __device__ __forceinline__ static Band of(int T, const Layer& L) {
    const int warp = threadIdx.x >> 5;
    const int RG = T / (16 * MR), CG = WARPS / RG;
    const int rg = warp / CG, cg = warp - rg * CG;
    const int pairs = L.nt >> 1, ppw = (pairs + CG - 1) / CG;
    Band b;
    b.r0 = rg * 16 * MR;
    b.p0 = cg * ppw;
    b.npw = max(0, min(pairs, b.p0 + ppw) - b.p0);
    return b;
  }
};

// One k-step of a layer for a warp: its MR m16 tiles against its band's
// n16 pairs of the step's fragments wc, into acc.
template <bool BF16, int MR>
__device__ __forceinline__ void step_mma(Tiles<MR>& acc, const Smem& m, const Layer& L,
                                         int step, const uint4* wc, const Band& bd, int lane) {
  constexpr int NP = pairs_of<MR>();
  const int g = lane >> 2, t = lane & 3;
  if constexpr (BF16) {
    const Cols c0 = cols_of(m, L, 16 * step), c1 = cols_of(m, L, 16 * step + 8);
    uint32_t a[MR][4];
#pragma unroll
    for (int mt = 0; mt < MR; ++mt) {
      const int r = bd.r0 + 16 * mt + g;
      const float2 x0 = cols2(c0, r, t), x1 = cols2(c0, r + 8, t);
      const float2 x2 = cols2(c1, r, t), x3 = cols2(c1, r + 8, t);
      a[mt][0] = pack_bf16(x0.x, x0.y);
      a[mt][1] = pack_bf16(x1.x, x1.y);
      a[mt][2] = pack_bf16(x2.x, x2.y);
      a[mt][3] = pack_bf16(x3.x, x3.y);
    }
#pragma unroll
    for (int pp = 0; pp < NP; ++pp) {
      if (pp < bd.npw) {
        const uint4 b = wc[(bd.p0 + pp) * 32 + lane];
        const uint32_t bb[2][2] = {{b.x, b.y}, {b.z, b.w}};
#pragma unroll
        for (int mt = 0; mt < MR; ++mt)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            // each k8 half (m16n8k8) into a zeroed tile, then one f32 add:
            // the tensor core truncates as it sums, and a k16 product sums
            // enough products at once to move its output past the plain
            // twin's own rounding, which flips bf16 roundings downstream
            // (the NeRF MLP's GPU test case went 1.5e-3 from its twin)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float tt[4] = {0.f, 0.f, 0.f, 0.f};
              mma_bf16_k8(tt, a[mt][2 * h], a[mt][2 * h + 1], bb[u][h]);
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[mt][2 * pp + u][i] += tt[i];
            }
          }
      }
    }
  } else {
    const Cols c = cols_of(m, L, 8 * step);
    uint32_t hi[MR][4], lo[MR][4];
#pragma unroll
    for (int mt = 0; mt < MR; ++mt) {
      const int r = bd.r0 + 16 * mt + g;
      const float2 p = cols2(c, r, t), q = cols2(c, r + 8, t);
      // slot t <-> column 2t, slot t + 4 <-> column 2t + 1 (the host's row
      // permutation of each k8 step)
      const float v[4] = {p.x, q.x, p.y, q.y};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hi[mt][i] = tf32(v[i]);
        lo[mt][i] = tf32(v[i] - __uint_as_float(hi[mt][i]));
      }
    }
#pragma unroll
    for (int pp = 0; pp < NP; ++pp) {
      if (pp < bd.npw) {
        // the pair's raw f32 weights {W[2t][n], W[2t+1][n]} of its two n8
        // tiles, split here as the activations are
        const float4 b = *reinterpret_cast<const float4*>(wc + (bd.p0 + pp) * 32 + lane);
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float w0 = u ? b.z : b.x, w1 = u ? b.w : b.y;
          bh[u][0] = tf32(w0);
          bh[u][1] = tf32(w1);
          bl[u][0] = tf32(w0 - __uint_as_float(bh[u][0]));
          bl[u][1] = tf32(w1 - __uint_as_float(bh[u][1]));
        }
        // the pair's 2 MR tiles as independent chains, each product round
        // issued for all of them before the next
        float tile[2][MR][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int mt = 0; mt < MR; ++mt)
#pragma unroll
            for (int i = 0; i < 4; ++i) tile[u][mt][i] = 0.f;
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int mt = 0; mt < MR; ++mt) mma_tf32(tile[u][mt], lo[mt], bh[u][0], bh[u][1]);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int mt = 0; mt < MR; ++mt) mma_tf32(tile[u][mt], hi[mt], bl[u][0], bl[u][1]);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int mt = 0; mt < MR; ++mt) mma_tf32(tile[u][mt], hi[mt], bh[u][0], bh[u][1]);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int mt = 0; mt < MR; ++mt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][2 * pp + u][i] += tile[u][mt][i];
      }
    }
  }
}

// One wide layer's products over the tile into the warps' accumulators, a
// ring group at a time; returns after every warp has read its last input,
// so the epilogue may overwrite h in place. One call site, so the products'
// code exists once per kernel.
template <bool BF16, int MR>
__device__ __forceinline__ void layer_mma(Tiles<MR>& acc, const Smem& m, Ring& ring,
                                          const Layer& L, const Band& bd) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MR; ++mt)
#pragma unroll
    for (int j = 0; j < 2 * pairs_of<MR>(); ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < L.ks; k0 += ring.kg) {
    __syncthreads();                    // the previous group's slot and inputs are free
    const uint4* wc = ring.next();
    if (bd.npw > 0) {
      const int n = min(ring.kg, L.ks - k0);
#pragma unroll 1
      for (int s = 0; s < n; ++s)
        step_mma<BF16, MR>(acc, m, L, k0 + s, wc + s * L.units, bd, lane);
    }
  }
  __syncthreads();                      // every warp has read its inputs
}

// epi(row, column, value at column, value at column + 1, the two pts_bias
// registers of those outputs) for the warp's outputs below np columns
template <int MR, class Epi>
__device__ __forceinline__ void each_output(Tiles<MR>& acc, Tiles<MR>& bias, const Band& bd,
                                            int np, Epi epi) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MR; ++mt)
#pragma unroll
    for (int pp = 0; pp < pairs_of<MR>(); ++pp)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = 16 * (bd.p0 + pp) + 8 * u + 2 * t;
        if (pp < bd.npw && c < np) {
          const int r = bd.r0 + 16 * mt + g;
          float* o = acc[mt][2 * pp + u];
          float* b = bias[mt][2 * pp + u];
          epi(r, c, o[0], o[1], b[0], b[1]);
          epi(r + 8, c, o[2], o[3], b[2], b[3]);
        }
      }
}

// Encoding row j (0 .. E8 - 1) of the point or direction x at L frequencies:
// x itself, then legacy [sin(2^l x_c)] (l-major, 3L), [cos] (3L); or
// standard, per coordinate c: [sin(pi 2^l x_c)]_l, [cos(pi 2^l x_c)]_l;
// zero past 3 + 6L.
__device__ __forceinline__ float encode(const float (&x)[3], int j, int L, int legacy) {
  if (j < 3) return x[j];
  j -= 3;
  if (j >= 6 * L) return 0.f;
  int c, l, s;
  float f;
  if (legacy) {
    s = j / (3 * L);
    const int r = j - s * 3 * L;
    l = r / 3;
    c = r - 3 * l;
    f = (float)(1 << l);
  } else {
    c = j / (2 * L);
    const int r = j - c * 2 * L;
    s = r / L;
    l = r - s * L;
    f = 3.14159265358979323846f * (float)(1 << l);
  }
  const float v = x[c] * f;
  return s == 0 ? sinf(v) : cosf(v);
}

// The MLP over one tile of ray n's samples row0 .. row0 + T - 1: writes tok,
// rgb, nv and depth of the tile's samples.
template <bool BF16, int MR>
__device__ void mlp_tile(const Args& a, const Smem& m, Ring& ring, int n, int row0) {
  const int tid = threadIdx.x, T = m.T, S = a.S, Gf = a.Gf, V = a.V, CD = Gf + 4 * V;
  const Plan& p = a.p;
  const int nrows = min(T, S - row0);
  const size_t base = (size_t)n * S + row0;
  auto st = [](float v) { return BF16 ? bf16_round(v) : v; };

  __syncthreads();                      // the previous tile's readers are done
  // conditioning [feat, color, mask] into H (columns CD .. CD8 - 1 and
  // samples past the ray's end zero), nv and depth of the samples
  for (int i = tid; i < p.CD8 * T; i += THREADS) {
    const int t = i / p.CD8, j = i - t * p.CD8;
    float v = 0.f;
    if (t < nrows && j < CD) {
      const size_t s = base + t;
      v = j < Gf ? __ldg(a.feat + s * Gf + j)
                 : (j < Gf + 3 * V ? __ldg(a.color + s * 3 * V + j - Gf)
                                   : __ldg(a.mask + s * V + j - Gf - 3 * V));
    }
    m.H[t * m.SH + j] = st(v);
  }
  // the point and direction encodings into E and R
  for (int i = tid; i < (p.E8 + p.Ev8) * T; i += THREADS) {
    const bool pt = i < p.E8 * T;
    const int ii = pt ? i : i - p.E8 * T, width = pt ? p.E8 : p.Ev8;
    const int t = ii / width, j = ii - t * width;
    float v = 0.f;
    if (t < nrows) {
      const float* src = (pt ? a.pts : a.ray_unit) + (base + t) * 3;
      const float x[3] = {__ldg(src), __ldg(src + 1), __ldg(src + 2)};
      v = encode(x, j, pt ? a.L3 : a.Lv, a.legacy);
    }
    if (pt) m.E[t * m.SE + j] = st(v);
    else m.R[t * m.SR + j] = st(v);
  }
  for (int t = tid; t < nrows; t += THREADS) {
    const size_t s = base + t;
    float cnt = 0.f;
    for (int k = 0; k < V; ++k) cnt += __ldg(a.mask + s * V + k);
    m.nv[row0 + t] = cnt;
    m.dep[row0 + t] = __ldg(a.depth + s);
  }

  const float* sp = a.small;
  Tiles<MR> pb;                         // pts_bias(cond) of the warp's outputs
  for (int li = 0; li < p.n_layers; ++li) {
    const Layer& L = p.layer[li];
    const float* b = sp + L.boff;
    const Band bd = Band::of<MR>(T, L);
    Tiles<MR> acc;
    layer_mma<BF16, MR>(acc, m, ring, L, bd);
    switch (L.kind) {
      case K_BIAS:
        each_output<MR>(acc, pb, bd, L.np, [&](int, int c, float v0, float v1, float& b0,
                                               float& b1) {
          const float2 bb = __ldg(reinterpret_cast<const float2*>(b + c));
          b0 = v0 + bb.x;
          b1 = v1 + bb.y;
        });
        break;
      case K_PTS:
        each_output<MR>(acc, pb, bd, L.np, [&](int r, int c, float v0, float v1, float& b0,
                                               float& b1) {
          const float2 bb = __ldg(reinterpret_cast<const float2*>(b + c));
          *reinterpret_cast<float2*>(m.H + r * m.SH + c) =
              make_float2(st(fmaxf((v0 + bb.x) * b0, 0.f)), st(fmaxf((v1 + bb.y) * b1, 0.f)));
        });
        break;
      case K_ALPHA:
        each_output<MR>(acc, pb, bd, L.np, [&](int r, int c, float v0, float v1, float&,
                                               float&) {
          if (r < nrows) {
            const int s = row0 + r;
            float x0 = activate(v0 + __ldg(b + c), a.act);
            float x1 = activate(v1 + __ldg(b + c + 1), a.act);
            if (a.postab != nullptr) {
              x0 += __ldg(a.postab + s * 16 + c);
              x1 += __ldg(a.postab + s * 16 + c + 1);
            }
            m.tok[s * 16 + c] = x0;
            m.tok[s * 16 + c + 1] = x1;
          }
        });
        break;
      case K_FEATURE:
      case K_VIEWS: {
        const bool relu = L.kind == K_VIEWS;
        each_output<MR>(acc, pb, bd, L.np, [&](int r, int c, float v0, float v1, float&,
                                               float&) {
          const float2 bb = __ldg(reinterpret_cast<const float2*>(b + c));
          const float x0 = v0 + bb.x, x1 = v1 + bb.y;
          *reinterpret_cast<float2*>(m.H + r * m.SH + c) =
              make_float2(st(relu ? fmaxf(x0, 0.f) : x0), st(relu ? fmaxf(x1, 0.f) : x1));
        });
        break;
      }
      default:                          // K_RGB
        each_output<MR>(acc, pb, bd, L.np, [&](int r, int c, float v0, float v1, float&,
                                               float&) {
          if (r < nrows && c < 3) {
            const int s = row0 + r;
            m.rgb[s * 4 + c] = 1.f / (1.f + expf(-(v0 + __ldg(b + c))));
            if (c + 1 < 3) m.rgb[s * 4 + c + 1] = 1.f / (1.f + expf(-(v1 + __ldg(b + c + 1))));
          }
        });
        break;
    }
  }
}

// the shared-memory plan of a tile of T samples: the activation buffers'
// strides and floats, the ring's bytes, the whole block's bytes
struct SmemPlan {
  int SH, SE, SR, act_floats, overlay_floats, ring_bytes;
  size_t total;
  __host__ __device__ SmemPlan(const Plan& p, int T, int stages, int kg, int S) {
    const int Sp = (S + 3) & ~3;
    SH = row_stride(p.HR);
    SE = row_stride(p.E8);
    SR = row_stride(p.Ev8);
    act_floats = (SH + SE + SR) * T;
    overlay_floats = act_floats > 48 * Sp ? act_floats : 48 * Sp;
    ring_bytes = stages * kg * p.max_units * 16;
    total = (size_t)ring_bytes + BAR_BYTES +
            ((size_t)overlay_floats + (size_t)RAY_FLOATS_PER_SAMPLE * Sp) * sizeof(float);
  }
};

template <bool BF16, int MR>
__global__ void __launch_bounds__(THREADS, 1) cond_nerf_decode_any_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& p = a.p;
  const int S = a.S, Sp = (S + 3) & ~3, T = a.T;
  const SmemPlan sp(p, T, a.stages, a.kg, S);
  uint4* slots = reinterpret_cast<uint4*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + sp.ring_bytes);
  float* act = reinterpret_cast<float*>(smem + sp.ring_bytes + BAR_BYTES);
  Smem m;
  m.T = T;
  m.SH = sp.SH; m.SE = sp.SE; m.SR = sp.SR;
  m.H = act;
  m.E = m.H + m.SH * T;
  m.R = m.E + m.SE * T;
  m.tok = act + sp.overlay_floats;
  m.rgb = m.tok + Sp * 16;
  m.nv = m.rgb + Sp * 4;
  m.dep = m.nv + Sp;
  m.alpha = m.dep + Sp;

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int groups = 0;                       // ring groups a tile
  for (int li = 0; li < p.n_layers; ++li) groups += (p.layer[li].ks + a.kg - 1) / a.kg;
  const int ntiles = (S + T - 1) / T;
  const int my_rays = (a.N - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  Ring ring;
  ring.slots = slots;
  ring.full = full;
  ring.src = a.frag;
  ring.p = &a.p;
  ring.stages = a.stages;
  ring.slot_units = a.kg * p.max_units;
  ring.kg = a.kg;
  ring.total = my_rays * ntiles * groups;
  ring.issued = ring.consumed = ring.il = ring.is = 0;
  for (int i = 0; i + 1 < a.stages; ++i) ring.issue();

  for (int n = blockIdx.x; n < a.N; n += gridDim.x) {
    for (int row0 = 0; row0 < S; row0 += T) mlp_tile<BF16, MR>(a, m, ring, n, row0);
    __syncthreads();
    ray_tail(a, TailBuffers{a.small, act, m.tok, m.rgb, m.nv, m.dep, m.alpha}, n, Sp);
    __syncthreads();                    // the tail is done before the next ray's staging
  }
}

template <bool BF16, int MR>
int launch_mr(const Args& a, size_t smem, cudaStream_t stream) {
  auto kernel = cond_nerf_decode_any_kernel<BF16, MR>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = a.N < sms * per_sm ? a.N : sms * per_sm;
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool BF16>
int launch(Args a, int n_small, int n_units, int W, int D, int skip_mask, cudaStream_t stream) {
  const int CD = a.Gf + 4 * a.V;
  if (a.N < 0 || a.S < 1 || a.S > S_MAX || a.Gf < 0 || a.V < 1 || CD > CD_MAX || W < W_MIN ||
      W > W_MAX || (W & 1) || D < 1 || D > D_MAX || a.L3 < 0 || a.L3 > L_MAX || a.Lv < 0 ||
      a.Lv > L_MAX || a.act < 0 || a.act > 2 || (skip_mask & 1) || skip_mask >> D)
    return (int)cudaErrorInvalidValue;
  a.p = make_plan(W, D, skip_mask, 3 + 6 * a.L3, 3 + 6 * a.Lv, CD, BF16);
  if (a.p.n_small != n_small || a.p.n_units != n_units) return (int)cudaErrorInvalidValue;
  if (a.N == 0) return (int)cudaGetLastError();
  cudaError_t err;
  int dev = 0, optin = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return (int)err;
  // the tile: the most samples whose outputs the warps hold (8 / MR n16
  // pairs of MR m16 tiles a warp across WARPS / (T / 16 MR) column bands)
  // and whose buffers fit, but no larger than the ray needs; then the ring:
  // the most k-steps a group (fewer barriers, more bytes in flight) with 3
  // stages, else 2
  const int plans[][2] = {{4, 3}, {2, 3}, {4, 2}, {2, 2}, {1, 3}, {1, 2}};   // kg, stages
  a.T = a.stages = a.kg = 0;
  for (int T = 128; T >= 16 && a.T == 0; T >>= 1) {
    const int MR = tile_mr(T), CG = WARPS / (T / (16 * MR));
    if (a.p.max_nt / 2 > 8 / MR * CG || !(T == 16 || T / 2 < a.S)) continue;
    for (const auto& kp : plans)
      if (a.T == 0 && SmemPlan(a.p, T, kp[1], kp[0], a.S).total <= (size_t)optin) {
        a.T = T;
        a.kg = kp[0];
        a.stages = kp[1];
      }
  }
  if (a.T == 0) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = SmemPlan(a.p, a.T, a.stages, a.kg, a.S).total;
  return tile_mr(a.T) == 2 ? launch_mr<BF16, 2>(a, smem, stream)
                           : launch_mr<BF16, 1>(a, smem, stream);
}

Args make_args(const void* pts, const void* ray_unit, const void* feat, const void* color,
               const void* mask, const void* depth, const void* ray, const void* small,
               const void* frag, const void* postab, void* out, int N, int S, int Gf, int V,
               int L3, int Lv, int legacy, int act, int maskfill, int wo_interval, int setbg) {
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
  a.N = N; a.S = S; a.Gf = Gf; a.V = V; a.L3 = L3; a.Lv = Lv; a.legacy = legacy;
  a.act = act; a.maskfill = maskfill; a.wo_interval = wo_interval; a.setbg = setbg;
  a.T = a.stages = a.kg = 0;
  return a;
}

}  // namespace

// pts, ray_unit, feat, color, mask, depth, ray, small (n_small f32),
// fragments (n_units 16-byte units of the route), postab [S][16] or NULL,
// out [N][5]; n_small, n_units, N, S, Gf, V, net_width, net_depth,
// skip_mask (bit l: pts_linears[l] reads [enc, h]), L_3D, L_view, legacy,
// act (0 ReLU, 1 ELU, 2 GELU tanh), maskfill, wo_render_interval, setbg;
// returns cudaGetLastError().
#define COND_NERF_DECODE_ANY_ENTRY(NAME, BF16)                                                   \
  extern "C" int NAME(const void* pts, const void* ray_unit, const void* feat,                  \
                      const void* color, const void* mask, const void* depth, const void* ray,  \
                      const void* small, const void* frag, const void* postab, void* out,       \
                      int n_small, int n_units, int N, int S, int Gf, int V, int W, int D,      \
                      int skip_mask, int L3, int Lv, int legacy, int act, int maskfill,         \
                      int wo_interval, int setbg, void* stream) {                               \
    return launch<BF16>(make_args(pts, ray_unit, feat, color, mask, depth, ray, small, frag,    \
                                  postab, out, N, S, Gf, V, L3, Lv, legacy, act, maskfill,      \
                                  wo_interval, setbg),                                          \
                        n_small, n_units, W, D, skip_mask, static_cast<cudaStream_t>(stream));  \
  }

COND_NERF_DECODE_ANY_ENTRY(cond_nerf_decode_any_f32, false)
COND_NERF_DECODE_ANY_ENTRY(cond_nerf_decode_any_bf16, true)
