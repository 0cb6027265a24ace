// The pair-mean grouped-cosine backward of one group, shared by B'
// (cosine_prior.cu) and D''s backward (block_cosine_prior.cu), as
// matchnerf_tpu/ops/pallas_banded.py::_grouped_cosine_bwd computes it.
#pragma once

// d(cos)/d(dot), d(cos)/d|a|^2 and d(cos)/d|b|^2 of one group from its dot
// product and squared norms, dcos the group's cotangent; zero where the norm
// is clamped at eps = 1e-8 (no gradient through the clamp); the norms'
// reciprocals as reciprocal square roots of max(|a|^2, eps^2), as the
// forward's cosine
__device__ __forceinline__ void cosine_bwd(float dcos, float dot, float na2, float nb2,
                                           float& d_dot, float& d_na2, float& d_nb2) {
  const float ra = rsqrtf(fmaxf(na2, 1e-16f)), rb = rsqrtf(fmaxf(nb2, 1e-16f));
  d_dot = dcos * ra * rb;
  const float h = -0.5f * d_dot * dot;
  d_na2 = na2 > 1e-16f ? h * ra * ra : 0.f;
  d_nb2 = nb2 > 1e-16f ? h * rb * rb : 0.f;
}
