// The ray tail shared by Kernel C (cond_nerf_decode.cu) and Kernel Cg
// (cond_nerf_decode_any.cu): after the MLP has left each sample's 16-wide
// alpha token, rgb, number of views that see it and depth in shared
// memory, the 4-head ray transformer over the ray's samples (w_qs, w_ks,
// w_vs, the attention, fc, the residual and LayerNorm eps 1e-6), the
// density head (out_alpha_linear, relu, the optional maskfill) and the
// emission-absorption composite, as matchnerf_tpu/ops/pallas_decoder.py's
// kernel computes them. Include it inside the kernel's anonymous namespace
// after defining THREADS (the block's threads) and, for phase marks,
// PHASE(k).
#pragma once

#ifndef PHASE
#define PHASE(k)
#endif

// the tail's 16-wide parameters (ops/decoder.py::_tail), offsets in floats
// from w_qs: w_qs, w_ks, w_vs and fc as [in][out], the LayerNorm weight and
// bias, out_alpha_linear.0 [in][out] and bias, out_alpha_linear.2 [16] and
// bias
constexpr int TW_Q = 0, TW_K = 256, TW_V = 512, TW_FC = 768, TW_LN_W = 1024, TW_LN_B = 1040,
              TW_O0_W = 1056, TW_O0_B = 1312, TW_O1_W = 1328, TW_O1_B = 1344,
              TW_FLOATS = 1345;

// raytrans_act: 0 ReLU, 1 ELU, 2 GELU in its tanh form (jax.nn.gelu)
__device__ __forceinline__ float activate(float x, int act) {
  if (act == 1) return x > 0.f ? x : expm1f(x);
  if (act == 2) {
    const float cdf = 0.5f * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * (x * x * x))));
    return x * cdf;
  }
  return fmaxf(x, 0.f);
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

// what the tail reads and writes (float pointers into shared memory, the
// weights in shared or global memory)
struct TailBuffers {
  const float* w;
  float *qb, *tok, *rgb, *nv, *dep, *alpha;
};

// The ray transformer, the density head and the composite of ray n: the
// 16-wide weights at m.w (offsets TW_*), q, k and v from m.qb (3 x 16 Sp
// floats), what the MLP left per sample in m.tok, m.rgb, m.nv and m.dep;
// alpha into m.alpha, the ray's rgb, depth and opacity into a.out[n].
// `Args` holds the ray's S, ray and out, and the flags act, maskfill,
// wo_interval and setbg.
template <class Args>
__device__ __forceinline__ void ray_tail(const Args& a, const TailBuffers& m, int n, int Sp) {
  const int tid = threadIdx.x, lane = tid & 31, S = a.S;
  const float* w = m.w;
  float* qb = m.qb;                       // q * log2(e) / 2, then the output
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
      load8(w + TW_Q + d * 16 + o0, wq);
      load8(w + TW_K + d * 16 + o0, wk);
      load8(w + TW_V + d * 16 + o0, wv);
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
      load8(w + TW_FC + k * 16 + c0, wr);
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
    load8(w + TW_LN_W + c0, lw);
    load8(w + TW_LN_B + c0, lb);
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
      load8(w + TW_O0_W + k * 16 + c0, wr);
#pragma unroll
      for (int c = 0; c < 8; ++c) z[c] = fmaf(yn[k], wr[c], z[c]);
    }
    float ob[8], o1[8], al = 0.f;
    load8(w + TW_O0_B + c0, ob);
    load8(w + TW_O1_W + c0, o1);
#pragma unroll
    for (int c = 0; c < 8; ++c) al = fmaf(activate(z[c] + ob[c], a.act), o1[c], al);
    al += __shfl_xor_sync(0xffffffffu, al, 1);
    al = fmaxf(al + w[TW_O1_B], 0.f);
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

