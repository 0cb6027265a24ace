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
// `pack_any`).
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
// Both operand routes run every product as f32 fused multiply-adds on the
// CUDA cores: the f32 route multiplies the f32 values (true f32 products);
// the bf16 route (precision.decoder_matmul_dtype: bf16) reads weights the
// host rounded to bf16 and rounds every activation that enters a wide
// product (pts_bias, pts_linears, alpha_linear, feature_linear,
// views_linears.0, rgb_linear) to bf16 as it is written to shared memory;
// a product of two bf16 values is exact in f32, so the sums are those of
// bf16 operands with f32 accumulation.
//
// What bounds it: arithmetic. At the NeRF MLP (256x8, L_view 4) the wide
// products are 1.2 MFLOP a sample, all on the f32 CUDA cores (67 TFLOP/s).
// Design (simple on purpose; the shipped shape keeps Kernel C):
// - One persistent block of 256 threads per SM walks over rays; a ray's
//   samples go through the MLP in tiles of T samples: 128, 64 or 32, the
//   most whose micro-tiles the threads cover and whose buffers fit (128 up
//   to width 128 at S = 128, 64 up to width 256, 32 up to 512), no more
//   than the ray needs. The activations live in shared memory transposed ([channel]
//   [T]): the tile's h (or its conditioning, before pts_bias), pts_bias's
//   output, the point and direction encodings.
// - Every wide layer is one tiled product: each thread owns a micro-tile of
//   8 samples x 8 outputs (at most 256 of them),
//   reading per input channel two float4 of activations (a broadcast across
//   the warp) and two float4 of weights, for 64 fused multiply-adds. The
//   weights stream from L2 through shared memory in chunks
//   of 8 input rows, double-buffered with cp.async. A layer's outputs stay
//   in registers until its last chunk is read, then overwrite h in place.
// - Padding makes every width a multiple of 8 with zero weights and biases,
//   so padded channels stay exactly 0 through the layers.
// - Only what the ray's attention and composite need outlives a tile: the
//   16-wide token, rgb, the number of views that see the sample and its
//   depth (92 bytes per sample). The ray tail is a copy of Kernel C's
//   (cond_nerf_decode.cu stays as it is, the shipped decoder's kernel): q, k, v on two
//   threads a sample; attention one head of two samples per thread with an
//   online base-2 softmax; fc/LayerNorm/density on two lanes a sample; the
//   composite as a warp scan; the 16-wide weights read through L1.
// Shared memory: ((max(W8, CD8) + W8 + E8 + Ev8) T + 16 W8 (the weight
// chunks), at least 48 Sp) + 23 Sp floats, W8 = W rounded up to 8 and Sp =
// S rounded up to 4: 227,328 bytes at W = 256 or 512 with S = 512 (T = 64
// and 32).
//
// Parameter buffers (the layout `pack_any` writes):
// - small (f32): w_qs, w_ks, w_vs, fc as [in][out], the LayerNorm weight and
//   bias, out_alpha_linear.0 [in][out] and bias, out_alpha_linear.2 [16] and
//   bias (SM_* offsets), then from SM_BIAS the biases of pts_bias [W8], the D
//   pts_linears [W8 each], alpha_linear [16], feature_linear [W8],
//   views_linears.0 [H8 = W/2 rounded up to 8] and rgb_linear [8].
// - weights (f32, bf16 values on the bf16 route): each wide layer as a
//   row-major [K][Np] matrix (input rows, padded output columns), in the
//   order pts_bias (K = CD8), pts_linears 0 .. D-1 (layer 0: E8; a layer
//   after a skip: E8 encoding rows then W8 h rows; else W8), alpha_linear
//   (W8 x 16), feature_linear (W8 x W8), views_linears.0 (W8 feature rows
//   then Ev8 direction rows, x H8), rgb_linear (H8 x 8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int KC = 8;                   // weight rows per staged chunk
constexpr int S_MAX = 512;
constexpr int W_MIN = 32, W_MAX = 512, D_MAX = 16, L_MAX = 10, CD_MAX = 128;
constexpr int MAX_LAYERS = D_MAX + 5;
constexpr int RAY_FLOATS_PER_SAMPLE = 16 + 4 + 3;   // tok, rgb, nv/depth/alpha

// small-parameter offsets (floats)
constexpr int SM_WQ = 0, SM_WK = 256, SM_WV = 512, SM_FC = 768, SM_LN_W = 1024, SM_LN_B = 1040,
              SM_O0_W = 1056, SM_O0_B = 1312, SM_O1_W = 1328, SM_O1_B = 1344, SM_BIAS = 1348;

// what a layer's epilogue does with its sums
enum Kind { K_BIAS, K_PTS, K_ALPHA, K_FEATURE, K_VIEWS, K_RGB };
// the shared-memory buffers a layer reads
enum Src { B_H, B_E, B_R };

struct Layer {
  int k1, k2;       // input rows from src1, then from src2 (multiples of KC)
  int src1, src2;
  int np;           // padded outputs (a multiple of 8)
  int kind;
  int woff, boff;   // offsets (floats) of the [k1 + k2][np] matrix and of the bias
};

struct Plan {
  int W8, H8, E8, Ev8, CD8, HR;
  int n_layers, n_wts, n_small;
  Layer layer[MAX_LAYERS];
};

__host__ __device__ inline int ceil8(int x) { return (x + 7) & ~7; }

// The layers in stream order and the two buffers' sizes, from the decoder's
// shape; skip_mask bit l: pts_linears[l] reads [enc, h] (l - 1 is in skip).
inline Plan make_plan(int W, int D, int skip_mask, int E, int Ev, int CD) {
  Plan p;
  p.W8 = ceil8(W);
  p.H8 = ceil8(W / 2);
  p.E8 = ceil8(E);
  p.Ev8 = ceil8(Ev);
  p.CD8 = ceil8(CD);
  p.HR = p.W8 > p.CD8 ? p.W8 : p.CD8;
  int n = 0, woff = 0, boff = SM_BIAS;
  auto add = [&](int k1, int src1, int k2, int src2, int np, int kind) {
    Layer& l = p.layer[n++];
    l.k1 = k1; l.src1 = src1; l.k2 = k2; l.src2 = src2;
    l.np = np; l.kind = kind; l.woff = woff; l.boff = boff;
    woff += (k1 + k2) * np;
    boff += np;
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
  p.n_wts = woff;
  p.n_small = boff;
  return p;
}

struct Args {
  const float *pts, *ray_unit, *feat, *color, *mask, *depth, *ray;
  const float *small, *wts;
  const float* postab;
  float* out;
  int N, S, Gf, V, L3, Lv, legacy, act, maskfill, wo_interval, setbg, T;
  Plan p;
};

__device__ __forceinline__ float activate(float x, int act) {
  if (act == 1) return x > 0.f ? x : expm1f(x);
  if (act == 2) {                       // jax.nn.gelu (approximate=True)
    const float cdf = 0.5f * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * (x * x * x))));
    return x * cdf;
  }
  return fmaxf(x, 0.f);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Smem {
  float *H, *B, *E, *R, *wbuf;
  float *tok, *rgb, *nv, *dep, *alpha;
  int T, W8;
  __device__ __forceinline__ const float* buf(int id) const {
    return id == B_E ? E : (id == B_R ? R : H);
  }
};

// One wide layer over the tile: sums[t][n] = sum_k x[k][t] w[k][n] for the
// T samples t and np outputs n, with x the rows of src1 then src2. A thread
// owns a micro-tile of 8 samples (8 rg ..) x 8 outputs: 4 from the first
// half of the columns (c0 = 4 cg ..) and 4 from the second (c1 = np/2 +
// 4 cg ..), so that the warp's weight reads are consecutive float4 (no bank
// conflict) and its activation reads broadcasts; (T / 8) (np / 8) <= 256
// micro-tiles. Then epi(rg, c0, c1, sums), after every thread has read its
// last input, so the epilogue may overwrite the input in place.
template <class Epi>
__device__ __forceinline__ void run_layer(const Args& a, const Smem& m, const Layer& L, Epi epi) {
  const int tid = threadIdx.x, T = m.T, np = L.np, cgn = np >> 3;
  const bool active = tid < (T >> 3) * cgn;
  const int rg = active ? tid / cgn : 0, cg = active ? tid % cgn : 0;
  const int c0 = 4 * cg, c1 = (np >> 1) + 4 * cg;
  const float* s1 = m.buf(L.src1);
  const float* s2 = m.buf(L.src2);
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
  const int nc = (L.k1 + L.k2) / KC;
  const int units = KC * np / 4;                    // 16-byte units per chunk
  const int stage = KC * m.W8;
  const float* wl = a.wts + L.woff;
  auto issue = [&](int c) {
    float* dst = m.wbuf + (c & 1) * stage;
    const float* src = wl + (size_t)c * KC * np;
    for (int u = tid; u < units; u += THREADS) cp_async16(dst + 4 * u, src + 4 * u);
    cp_async_commit();
  };
  issue(0);
#pragma unroll 1
  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc) {
      issue(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const float* wc = m.wbuf + (c & 1) * stage;
      const int k0 = c * KC;
      const float* x = (k0 < L.k1 ? s1 + k0 * T : s2 + (k0 - L.k1) * T) + 8 * rg;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float4 x0 = *reinterpret_cast<const float4*>(x + kk * T);
        const float4 x1 = *reinterpret_cast<const float4*>(x + kk * T + 4);
        const float4 w0 = *reinterpret_cast<const float4*>(wc + kk * np + c0);
        const float4 w1 = *reinterpret_cast<const float4*>(wc + kk * np + c1);
        const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(xv[r], wv[q], acc[r][q]);
      }
    }
    __syncthreads();
  }
  if (active) epi(rg, c0, c1, acc);
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
template <bool BF16>
__device__ void mlp_tile(const Args& a, const Smem& m, int n, int row0) {
  const int tid = threadIdx.x, T = m.T, S = a.S, Gf = a.Gf, V = a.V, CD = Gf + 4 * V;
  const Plan& p = a.p;
  const int nrows = min(T, S - row0);
  const size_t base = (size_t)n * S + row0;
  auto st = [](float v) { return BF16 ? bf16_round(v) : v; };

  __syncthreads();                      // the previous tile's readers are done
  // conditioning [feat, color, mask] into H (rows CD .. CD8 - 1 and samples
  // past the ray's end zero), nv and depth of the samples
  for (int i = tid; i < p.CD8 * T; i += THREADS) {
    const int t = i / p.CD8, j = i - t * p.CD8;
    float v = 0.f;
    if (t < nrows && j < CD) {
      const size_t s = base + t;
      v = j < Gf ? __ldg(a.feat + s * Gf + j)
                 : (j < Gf + 3 * V ? __ldg(a.color + s * 3 * V + j - Gf)
                                   : __ldg(a.mask + s * V + j - Gf - 3 * V));
    }
    m.H[j * T + t] = st(v);
  }
  // the point and direction encodings into E and R
  for (int i = tid; i < (p.E8 + p.Ev8) * T; i += THREADS) {
    const bool pt = i < p.E8 * T;
    const int ii = pt ? i : i - p.E8 * T;
    const int j = ii / T, t = ii - j * T;
    float v = 0.f;
    if (t < nrows) {
      const float* src = (pt ? a.pts : a.ray_unit) + (base + t) * 3;
      const float x[3] = {__ldg(src), __ldg(src + 1), __ldg(src + 2)};
      v = encode(x, j, pt ? a.L3 : a.Lv, a.legacy);
    }
    (pt ? m.E : m.R)[j * T + t] = st(v);
  }
  for (int t = tid; t < nrows; t += THREADS) {
    const size_t s = base + t;
    float cnt = 0.f;
    for (int k = 0; k < V; ++k) cnt += __ldg(a.mask + s * V + k);
    m.nv[row0 + t] = cnt;
    m.dep[row0 + t] = __ldg(a.depth + s);
  }

  const float* sp = a.small;
  for (int li = 0; li < p.n_layers; ++li) {
    const Layer& L = p.layer[li];
    const float* b = sp + L.boff;
    switch (L.kind) {
      case K_BIAS:
        run_layer(a, m, L, [&](int rg, int c0, int c1, float (&acc)[8][8]) {
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int c = q < 4 ? c0 + q : c1 + q - 4;
            const float bb = __ldg(b + c);
#pragma unroll
            for (int r = 0; r < 8; ++r) m.B[c * T + 8 * rg + r] = acc[r][q] + bb;
          }
        });
        break;
      case K_PTS:
        run_layer(a, m, L, [&](int rg, int c0, int c1, float (&acc)[8][8]) {
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int c = q < 4 ? c0 + q : c1 + q - 4;
            const float bb = __ldg(b + c);
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const int i = c * T + 8 * rg + r;
              m.H[i] = st(fmaxf((acc[r][q] + bb) * m.B[i], 0.f));
            }
          }
        });
        break;
      case K_ALPHA:
        run_layer(a, m, L, [&](int rg, int c0, int c1, float (&acc)[8][8]) {
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int c = q < 4 ? c0 + q : c1 + q - 4;
            const float bb = __ldg(b + c);
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const int t = 8 * rg + r;
              if (t < nrows) {
                const int s = row0 + t;
                float v = activate(acc[r][q] + bb, a.act);
                if (a.postab != nullptr) v += __ldg(a.postab + s * 16 + c);
                m.tok[s * 16 + c] = v;
              }
            }
          }
        });
        break;
      case K_FEATURE:
      case K_VIEWS: {
        const bool relu = L.kind == K_VIEWS;
        run_layer(a, m, L, [&](int rg, int c0, int c1, float (&acc)[8][8]) {
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int c = q < 4 ? c0 + q : c1 + q - 4;
            const float bb = __ldg(b + c);
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const float v = acc[r][q] + bb;
              m.H[c * T + 8 * rg + r] = st(relu ? fmaxf(v, 0.f) : v);
            }
          }
        });
        break;
      }
      default:                          // K_RGB
        run_layer(a, m, L, [&](int rg, int c0, int c1, float (&acc)[8][8]) {
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const float bb = __ldg(b + q);
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const int t = 8 * rg + r;
              if (t < nrows) m.rgb[(row0 + t) * 4 + q] = 1.f / (1.f + expf(-(acc[r][q] + bb)));
            }
          }
        });
        break;
    }
  }
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

// 8 consecutive floats from 16-byte aligned memory
__device__ __forceinline__ void load8(const float* p, float (&r)[8]) {
  const float4 x = *reinterpret_cast<const float4*>(p), y = *reinterpret_cast<const float4*>(p + 4);
  r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
  r[4] = y.x; r[5] = y.y; r[6] = y.z; r[7] = y.w;
}

// The ray transformer, the density head and the composite of ray n (Kernel
// C's ray tail; the 16-wide weights are read from the small buffer).
__device__ void ray_tail(const Args& a, const Smem& m, float* qb, int n, int Sp) {
  const int tid = threadIdx.x, S = a.S;
  const float* w = a.small;
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

  // ---- attention: a lane takes one head of two samples (s and s + 32), an
  // online softmax over blocks of 8 keys; the output replaces q.
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

  // ---- composite: exclusive transmittance scan, one warp, 32 samples a step
  if (tid < 32) {
    const int lane = tid;
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

// floats of the tile buffers (H, B, E, R, the two weight chunks) and of the
// region they share with the ray tail's q, k, v
__host__ __device__ inline int tile_floats(const Plan& p, int T) {
  return (p.HR + p.W8 + p.E8 + p.Ev8) * T + 2 * KC * p.W8;
}
__host__ __device__ inline int overlay_floats(const Plan& p, int T, int Sp) {
  const int t = tile_floats(p, T);
  return t > 48 * Sp ? t : 48 * Sp;
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1) cond_nerf_decode_any_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const Plan& p = a.p;
  const int S = a.S, Sp = (S + 3) & ~3, T = a.T;
  Smem m;
  m.T = T;
  m.W8 = p.W8;
  m.H = sm;
  m.B = m.H + p.HR * T;
  m.E = m.B + p.W8 * T;
  m.R = m.E + p.E8 * T;
  m.wbuf = m.R + p.Ev8 * T;
  m.tok = sm + overlay_floats(p, T, Sp);
  m.rgb = m.tok + Sp * 16;
  m.nv = m.rgb + Sp * 4;
  m.dep = m.nv + Sp;
  m.alpha = m.dep + Sp;

  for (int n = blockIdx.x; n < a.N; n += gridDim.x) {
    for (int row0 = 0; row0 < S; row0 += T) mlp_tile<BF16>(a, m, n, row0);
    __syncthreads();
    ray_tail(a, m, sm, n, Sp);
    __syncthreads();                    // the tail is done before the next ray's staging
  }
}

template <bool BF16>
int launch(Args a, int n_small, int n_wts, int W, int D, int skip_mask, cudaStream_t stream) {
  const int CD = a.Gf + 4 * a.V;
  if (a.N < 0 || a.S < 1 || a.S > S_MAX || a.Gf < 0 || a.V < 1 || CD > CD_MAX || W < W_MIN ||
      W > W_MAX || (W & 1) || D < 1 || D > D_MAX || a.L3 < 0 || a.L3 > L_MAX || a.Lv < 0 ||
      a.Lv > L_MAX || a.act < 0 || a.act > 2 || (skip_mask & 1) || skip_mask >> D)
    return (int)cudaErrorInvalidValue;
  a.p = make_plan(W, D, skip_mask, 3 + 6 * a.L3, 3 + 6 * a.Lv, CD);
  if (a.p.n_small != n_small || a.p.n_wts != n_wts) return (int)cudaErrorInvalidValue;
  if (a.N == 0) return (int)cudaGetLastError();
  cudaError_t err;
  int dev = 0, sms = 0, per_sm = 0, optin = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return (int)err;
  // the tile: the most samples whose micro-tiles the 256 threads cover
  // ((T / 8) (W8 / 8) <= 256) and whose buffers fit the shared memory, but
  // no larger than the ray needs (32 at least)
  const int Sp = (a.S + 3) & ~3;
  auto smem_of = [&](int T) {
    return ((size_t)overlay_floats(a.p, T, Sp) + (size_t)RAY_FLOATS_PER_SAMPLE * Sp) *
           sizeof(float);
  };
  a.T = 0;
  for (int T = 128; T >= 32 && a.T == 0; T >>= 1)
    if ((T >> 3) * (a.p.W8 >> 3) <= THREADS && smem_of(T) <= (size_t)optin &&
        (T == 32 || T / 2 < a.S))
      a.T = T;
  if (a.T == 0) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = smem_of(a.T);
  if ((err = cudaFuncSetAttribute(cond_nerf_decode_any_kernel<BF16>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, cond_nerf_decode_any_kernel<BF16>, THREADS, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = a.N < sms * per_sm ? a.N : sms * per_sm;
  cond_nerf_decode_any_kernel<BF16><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

Args make_args(const void* pts, const void* ray_unit, const void* feat, const void* color,
               const void* mask, const void* depth, const void* ray, const void* small,
               const void* wts, const void* postab, void* out, int N, int S, int Gf, int V,
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
  a.wts = static_cast<const float*>(wts);
  a.postab = static_cast<const float*>(postab);
  a.out = static_cast<float*>(out);
  a.N = N; a.S = S; a.Gf = Gf; a.V = V; a.L3 = L3; a.Lv = Lv; a.legacy = legacy;
  a.act = act; a.maskfill = maskfill; a.wo_interval = wo_interval; a.setbg = setbg;
  a.T = 0;
  return a;
}

}  // namespace

// pts, ray_unit, feat, color, mask, depth, ray, small (n_small f32), weights
// (n_wts f32), postab [S][16] or NULL, out [N][5]; n_small, n_wts, N, S, Gf,
// V, net_width, net_depth, skip_mask (bit l: pts_linears[l] reads [enc, h]),
// L_3D, L_view, legacy, act (0 ReLU, 1 ELU, 2 GELU tanh), maskfill,
// wo_render_interval, setbg; returns cudaGetLastError().
#define COND_NERF_DECODE_ANY_ENTRY(NAME, BF16)                                                   \
  extern "C" int NAME(const void* pts, const void* ray_unit, const void* feat,                  \
                      const void* color, const void* mask, const void* depth, const void* ray,  \
                      const void* small, const void* wts, const void* postab, void* out,        \
                      int n_small, int n_wts, int N, int S, int Gf, int V, int W, int D,        \
                      int skip_mask, int L3, int Lv, int legacy, int act, int maskfill,         \
                      int wo_interval, int setbg, void* stream) {                               \
    return launch<BF16>(make_args(pts, ray_unit, feat, color, mask, depth, ray, small, wts,     \
                                  postab, out, N, S, Gf, V, L3, Lv, legacy, act, maskfill,      \
                                  wo_interval, setbg),                                          \
                        n_small, n_wts, W, D, skip_mask, static_cast<cudaStream_t>(stream));    \
  }

COND_NERF_DECODE_ANY_ENTRY(cond_nerf_decode_any_f32, false)
COND_NERF_DECODE_ANY_ENTRY(cond_nerf_decode_any_bf16, true)
