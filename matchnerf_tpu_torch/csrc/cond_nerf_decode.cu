// Kernel C: the CondNeRF decoder with the emission-absorption composite.
//
// Replaces matchnerf_tpu/ops/pallas_decoder.py::cond_nerf_decode with
// fold_composite=True (the decoder megakernel of the eval render). Plain
// version and wrapper: matchnerf_tpu_torch/ops/decoder.py.
//
// Per ray of S <= 128 samples, f32 throughout:
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
// What bounds it: arithmetic. The 9 width-128 products take ~2.1 MFMA per
// sample (~35 MFLOP per ray) against ~150 bytes of inputs per sample, far
// above the card's bytes-to-flops balance. Design: one block of 256 threads
// per ray. The ray's activations stay in shared memory for the whole
// decoder ([128][197] f32, 99 KB: enc | h | direction), so nothing between
// layers reaches device memory; each thread owns an 8 x 8 tile of every
// width-128 product in registers, and the per-sample bias pts_bias(cond) is
// computed once into the same register tile and reused by all 6 layers
// (so it costs no shared memory). Weights stream through a 16 KB shared
// stage in 32-row chunks from L2. The small 16-wide attention and the heads
// run one sample (or sample-head pair) per thread; the composite's
// transmittance scan is one thread's serial loop over the S samples. Shared
// memory: 160 KB per block, above the 48 KB default, so the launcher raises
// the limit with cudaFuncSetAttribute. The products use CUDA-core FMAs;
// tensor cores are left for a later change.
//
// Weight buffer (f32, every linear as its [in][out] matrix, then its bias):
//   pts_bias [CD][128] (CD = Gf + 4V), [128]
//   pts_linears l = 0..5: [63|128|128|128|128|191][128], [128]
//   alpha_linear [128][16], [16]
//   w_qs, w_ks, w_vs, fc: [16][16] each (no bias)
//   layer_norm weight [16], bias [16]
//   out_alpha_linear.0 [16][16], [16]; out_alpha_linear.2 [16][1], [1]
//   feature_linear [128][128], [128]; views_linears.0 [131][64], [64]
//   rgb_linear [64][3], [3]

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int S_MAX = 128;
constexpr int THREADS = 256;
constexpr int WD = 128;                 // net width
constexpr int ENC = 63;                 // 3 + 6 * 10
constexpr int H0 = ENC;                 // first column of h in X
constexpr int DIR0 = ENC + WD;          // first column of the ray direction
constexpr int XS = 197;                 // X row stride (odd: no bank conflicts)
constexpr int KT = 32;                  // weight rows per shared stage
constexpr int TS = 17;                  // stride of the 16-wide per-sample rows
constexpr int CD_MAX = 64;
constexpr size_t SMEM_FLOATS =
    (size_t)S_MAX * XS + KT * WD + 5 * S_MAX * TS + 3 * S_MAX + 3 * S_MAX;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

struct DecWeights {
  const float *pb_w, *pb_b;
  const float *lw[6], *lb[6];
  const float *a_w, *a_b;
  const float *wq, *wk, *wv, *fc, *ln_w, *ln_b;
  const float *o0_w, *o0_b, *o1_w, *o1_b;
  const float *f_w, *f_b, *v_w, *v_b, *r_w, *r_b;
};

DecWeights split_weights(const float* w, int CD) {
  DecWeights d;
  const float* p = w;
  auto take = [&p](int n) { const float* r = p; p += n; return r; };
  d.pb_w = take(CD * WD); d.pb_b = take(WD);
  const int in_dim[6] = {ENC, WD, WD, WD, WD, ENC + WD};
  for (int l = 0; l < 6; ++l) { d.lw[l] = take(in_dim[l] * WD); d.lb[l] = take(WD); }
  d.a_w = take(WD * 16); d.a_b = take(16);
  d.wq = take(256); d.wk = take(256); d.wv = take(256); d.fc = take(256);
  d.ln_w = take(16); d.ln_b = take(16);
  d.o0_w = take(256); d.o0_b = take(16); d.o1_w = take(16); d.o1_b = take(1);
  d.f_w = take(WD * WD); d.f_b = take(WD);
  d.v_w = take((WD + 3) * 64); d.v_b = take(64);
  d.r_w = take(64 * 3); d.r_b = take(3);
  return d;
}

__device__ __forceinline__ float activate(float x, int act) {
  return act == 1 ? (x > 0.f ? x : expm1f(x)) : fmaxf(x, 0.f);
}

// acc[i][j] += sum_k X[rg + 16 i][xcol + k] * W[k][cg * NC + j], k < K.
// W is [K][16 NC] row-major in device memory; rows stream through `stage`.
// Begins and ends with a barrier, so callers may write X right after.
template <int NC>
__device__ __forceinline__ void gemm(float (&acc)[8][NC], const float* X,
                                     int xcol, int K,
                                     const float* __restrict__ W, float* stage) {
  constexpr int N = 16 * NC;
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  for (int k0 = 0; k0 < K; k0 += KT) {
    const int kn = min(KT, K - k0);
    __syncthreads();
    for (int i = tid; i < kn * N; i += THREADS) stage[i] = __ldg(W + (size_t)k0 * N + i);
    __syncthreads();
    for (int kk = 0; kk < kn; ++kk) {
      float w[NC];
#pragma unroll
      for (int j = 0; j < NC; j += 4) {
        const float4 t = *reinterpret_cast<const float4*>(stage + kk * N + cg * NC + j);
        w[j] = t.x; w[j + 1] = t.y; w[j + 2] = t.z; w[j + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = X[(rg + 16 * i) * XS + xcol + k0 + kk];
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(x, w[j], acc[i][j]);
      }
    }
  }
  __syncthreads();
}

template <int NC>
__device__ __forceinline__ void zero(float (&a)[8][NC]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) a[i][j] = 0.f;
}

__global__ void __launch_bounds__(THREADS, 1)
cond_nerf_decode_kernel(const float* __restrict__ pts, const float* __restrict__ ray_unit,
                        const float* __restrict__ feat, const float* __restrict__ color,
                        const float* __restrict__ mask, const float* __restrict__ depth,
                        const float* __restrict__ ray, DecWeights Wt,
                        const float* __restrict__ postab, float* __restrict__ out,
                        int S, int Gf, int V, int act, int maskfill, int wo_interval,
                        int setbg) {
  extern __shared__ float sm[];
  float* X = sm;                          // [S_MAX][XS]: enc | h | direction
  float* stage = X + S_MAX * XS;          // [KT][WD]
  float* tok = stage + KT * WD;           // [S_MAX][TS] alpha tokens
  float* qs = tok + S_MAX * TS;           // [S_MAX][TS] queries, pre-scaled by 1/2
  float* ks = qs + S_MAX * TS;
  float* vs = ks + S_MAX * TS;
  float* att = vs + S_MAX * TS;           // [S_MAX][TS] attention output
  float* nv = att + S_MAX * TS;           // [S_MAX] views that see the sample
  float* dep = nv + S_MAX;                // [S_MAX] depth
  float* alpha = dep + S_MAX;             // [S_MAX] density
  float* rgb = alpha + S_MAX;             // [S_MAX][3]

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const size_t rs = (size_t)blockIdx.x * S;
  const int CD = Gf + 4 * V;

  // ---- inputs: posenc, conditioning (into h's columns until layer 0), dir
  if (tid < S_MAX) {
    float* xr = X + tid * XS;
    if (tid < S) {
      const size_t n = rs + tid;
      float p[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) { p[d] = pts[n * 3 + d]; xr[d] = p[d]; }
#pragma unroll
      for (int l = 0; l < 10; ++l) {
        const float f = (float)(1 << l);
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float sp = p[d] * f;
          xr[3 + l * 3 + d] = sinf(sp);
          xr[33 + l * 3 + d] = cosf(sp);
        }
      }
      for (int g = 0; g < Gf; ++g) xr[H0 + g] = feat[n * Gf + g];
      for (int c = 0; c < 3 * V; ++c) xr[H0 + Gf + c] = color[n * 3 * V + c];
      float cnt = 0.f;
      for (int v = 0; v < V; ++v) {
        const float m = mask[n * V + v];
        xr[H0 + Gf + 3 * V + v] = m;
        cnt += m;
      }
      nv[tid] = cnt;
#pragma unroll
      for (int d = 0; d < 3; ++d) xr[DIR0 + d] = ray_unit[n * 3 + d];
      dep[tid] = depth[n];
    } else {
      for (int c = 0; c < DIR0 + 3; ++c) xr[c] = 0.f;
      nv[tid] = 0.f;
      dep[tid] = 0.f;
    }
  }

  // ---- bias = pts_bias(cond), kept in registers for all six layers
  float bias[8][8], acc[8][8];
  zero(bias);
  gemm<8>(bias, X, H0, CD, Wt.pb_w, stage);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) bias[i][j] += Wt.pb_b[cg * 8 + j];

  // ---- the MLP: layer 0 reads enc, 1-4 read h, 5 reads [enc, h]
#pragma unroll 1
  for (int l = 0; l < 6; ++l) {
    const int xcol = (l == 0 || l == 5) ? 0 : H0;
    const int K = l == 0 ? ENC : (l == 5 ? ENC + WD : WD);
    zero(acc);
    gemm<8>(acc, X, xcol, K, Wt.lw[l], stage);
    const float* b = Wt.lb[l];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        X[(rg + 16 * i) * XS + H0 + cg * 8 + j] =
            fmaxf((acc[i][j] + b[cg * 8 + j]) * bias[i][j], 0.f);
  }
  __syncthreads();

  // ---- alpha token: sample tid/2, outputs (tid%2)*8 .. +7
  {
    const int s = tid >> 1, o0 = (tid & 1) * 8;
    float a[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = Wt.a_b[o0 + j];
    for (int k = 0; k < WD; ++k) {
      const float x = X[s * XS + H0 + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] = fmaf(x, __ldg(Wt.a_w + k * 16 + o0 + j), a[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float t = activate(a[j], act);
      if (postab != nullptr && s < S) t += postab[s * 16 + o0 + j];
      tok[s * TS + o0 + j] = t;
    }
  }

  // ---- rgb branch: feature = feature_linear(h) replaces h in X
  zero(acc);
  gemm<8>(acc, X, H0, WD, Wt.f_w, stage);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      X[(rg + 16 * i) * XS + H0 + cg * 8 + j] = acc[i][j] + Wt.f_b[cg * 8 + j];
  // hv = relu(views_linear([feature, dir])) -> X[:, 0:64] (enc is done)
  float acc4[8][4];
  zero(acc4);
  gemm<4>(acc4, X, H0, WD + 3, Wt.v_w, stage);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      X[(rg + 16 * i) * XS + cg * 4 + j] = fmaxf(acc4[i][j] + Wt.v_b[cg * 4 + j], 0.f);
  __syncthreads();

  if (tid < S_MAX) {
    // rgb head of sample tid
    const int s = tid;
    float z[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) z[c] = Wt.r_b[c];
    for (int k = 0; k < 64; ++k) {
      const float x = X[s * XS + k];
#pragma unroll
      for (int c = 0; c < 3; ++c) z[c] = fmaf(x, __ldg(Wt.r_w + k * 3 + c), z[c]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[s * 3 + c] = 1.f / (1.f + expf(-z[c]));
  } else {
    // q, k, v projections of sample tid - 128
    const int s = tid - S_MAX;
    float t[16];
#pragma unroll
    for (int d = 0; d < 16; ++d) t[d] = tok[s * TS + d];
#pragma unroll 4
    for (int o = 0; o < 16; ++o) {
      float q = 0.f, k = 0.f, v = 0.f;
#pragma unroll
      for (int d = 0; d < 16; ++d) {
        q = fmaf(t[d], __ldg(Wt.wq + d * 16 + o), q);
        k = fmaf(t[d], __ldg(Wt.wk + d * 16 + o), k);
        v = fmaf(t[d], __ldg(Wt.wv + d * 16 + o), v);
      }
      qs[s * TS + o] = q * 0.5f;          // q / sqrt(d_k), d_k = 4
      ks[s * TS + o] = k;
      vs[s * TS + o] = v;
    }
  }
  __syncthreads();

  // ---- ray attention: one (sample, head) per task
  for (int task = tid; task < S_MAX * 4; task += THREADS) {
    const int s = task >> 2, h = task & 3;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    if (s < S) {
      if (nv[s] > 1.f) {
        float qv[4];
#pragma unroll
        for (int d = 0; d < 4; ++d) qv[d] = qs[s * TS + h * 4 + d];
        float mx = -INFINITY;
        for (int m = 0; m < S; ++m) {
          float sc = 0.f;
#pragma unroll
          for (int d = 0; d < 4; ++d) sc = fmaf(qv[d], ks[m * TS + h * 4 + d], sc);
          mx = fmaxf(mx, sc);
        }
        float sum = 0.f;
        for (int m = 0; m < S; ++m) {
          float sc = 0.f;
#pragma unroll
          for (int d = 0; d < 4; ++d) sc = fmaf(qv[d], ks[m * TS + h * 4 + d], sc);
          const float e = expf(sc - mx);
          sum += e;
#pragma unroll
          for (int d = 0; d < 4; ++d) o[d] = fmaf(e, vs[m * TS + h * 4 + d], o[d]);
        }
#pragma unroll
        for (int d = 0; d < 4; ++d) o[d] /= sum;
      } else {
        // masked query: uniform attention = mean of the values
        for (int m = 0; m < S; ++m)
#pragma unroll
          for (int d = 0; d < 4; ++d) o[d] += vs[m * TS + h * 4 + d];
#pragma unroll
        for (int d = 0; d < 4; ++d) o[d] /= (float)S;
      }
    }
#pragma unroll
    for (int d = 0; d < 4; ++d) att[s * TS + h * 4 + d] = o[d];
  }
  __syncthreads();

  // ---- fc + residual, LayerNorm, density head
  if (tid < S) {
    const int s = tid;
    float a[16], y[16];
#pragma unroll
    for (int d = 0; d < 16; ++d) a[d] = att[s * TS + d];
    float mu = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      float z = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) z = fmaf(a[k], __ldg(Wt.fc + k * 16 + c), z);
      y[c] = z + tok[s * TS + c];
      mu += y[c];
    }
    mu /= 16.f;
    float var = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) var += (y[c] - mu) * (y[c] - mu);
    var /= 16.f;
    const float sd = sqrtf(var + 1e-6f);
#pragma unroll
    for (int c = 0; c < 16; ++c) y[c] = (y[c] - mu) / sd * Wt.ln_w[c] + Wt.ln_b[c];
    float al = Wt.o1_b[0];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      float z = Wt.o0_b[c];
#pragma unroll
      for (int k = 0; k < 16; ++k) z = fmaf(y[k], __ldg(Wt.o0_w + k * 16 + c), z);
      al = fmaf(activate(z, act), Wt.o1_w[c], al);
    }
    al = fmaxf(al, 0.f);
    if (maskfill && nv[s] < 1.f) al = 0.f;
    alpha[s] = al;
  }
  __syncthreads();

  // ---- composite (exclusive transmittance scan over the samples)
  if (tid == 0) {
    float rl = 1.f;
    if (!wo_interval) {
      const float* rr = ray + (size_t)blockIdx.x * 3;
      rl = sqrtf(rr[0] * rr[0] + rr[1] * rr[1] + rr[2] * rr[2]);
    }
    float cum = 0.f, cr = 0.f, cgr = 0.f, cb = 0.f, cd = 0.f, co = 0.f;
    for (int s = 0; s < S; ++s) {
      float sdelta = alpha[s];
      if (!wo_interval) {
        const float intv = (s + 1 < S) ? dep[s + 1] - dep[s] : 1e10f;
        sdelta = alpha[s] * (intv * rl);
      }
      const float prob = expf(-cum) * (1.f - expf(-sdelta));
      cum += sdelta;
      cr = fmaf(rgb[s * 3 + 0], prob, cr);
      cgr = fmaf(rgb[s * 3 + 1], prob, cgr);
      cb = fmaf(rgb[s * 3 + 2], prob, cb);
      cd = fmaf(dep[s], prob, cd);
      co += prob;
    }
    if (setbg) { cr += 1.f - co; cgr += 1.f - co; cb += 1.f - co; }
    float* o = out + (size_t)blockIdx.x * 5;
    o[0] = cr; o[1] = cgr; o[2] = cb; o[3] = cd; o[4] = co;
  }
}

}  // namespace

extern "C" int cond_nerf_decode_f32(const void* pts, const void* ray_unit,
                                    const void* feat, const void* color,
                                    const void* mask, const void* depth,
                                    const void* ray, const void* weights,
                                    const void* postab, void* out, int N, int S,
                                    int Gf, int V, int act, int maskfill,
                                    int wo_interval, int setbg, void* stream) {
  const int CD = Gf + 4 * V;
  if (N < 0 || S < 1 || S > S_MAX || Gf < 0 || V < 1 || CD > CD_MAX ||
      (act != 0 && act != 1))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  cudaError_t err = cudaFuncSetAttribute(
      cond_nerf_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const DecWeights w = split_weights(static_cast<const float*>(weights), CD);
  cond_nerf_decode_kernel<<<N, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(ray_unit),
      static_cast<const float*>(feat), static_cast<const float*>(color),
      static_cast<const float*>(mask), static_cast<const float*>(depth),
      static_cast<const float*>(ray), w, static_cast<const float*>(postab),
      static_cast<float*>(out), S, Gf, V, act, maskfill, wo_interval, setbg);
  return (int)cudaGetLastError();
}
