// Shared device code of the marginal kernels: kernels 3 and 4
// (marglik.cu) and their matmul forms 3m and 4m (marglik_mm.cu).
//
// phi_interval_scaled is a line-for-line copy of
// base_tpu_torch/ops/special.py (and base_tpu/ops/special.py): the A-S
// 7.1.26 erf, the +-3.5 Mills switch and the min(unear_sq, 13) clamp;
// core_width is base_tpu/ops/pallas_marglik.py `_core_width_of`.  The
// library is built without --use_fast_math: the erf polynomial, expf in the
// far tails and the 1e-15 / 1e-12 floors need IEEE float32.
#pragma once

#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float SQRT_2PI = 2.5066282746310002f;
constexpr float INV_SQRT2 = 0.7071067811865476f;
constexpr float INV_SQRT_2PI = 0.3989422804014327f;
constexpr float ALPHA_EPS = 1e-12f;
constexpr float FLAT_EPS = 3e-7f;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ float erf_poly_from_e(float ax, float e) {
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return 1.0f - poly * e;
}

__device__ __forceinline__ float mills_scaled(float u_abs, float extra_log) {
  const float u = fmaxf(u_abs, 1.0f);
  const float iu2 = 1.0f / (u * u);
  const float series = 1.0f - iu2 + 3.0f * iu2 * iu2;
  return INV_SQRT_2PI / u * series * expf(fminf(extra_log, 0.0f));
}

__device__ __forceinline__ void phi_interval_scaled(float u0, float u1,
                                                    float* d,
                                                    float* unear_sq) {
  const float x0 = u0 * INV_SQRT2;
  const float x1 = u1 * INV_SQRT2;
  const float e0 = expf(-x0 * x0);
  const float e1 = expf(-x1 * x1);
  const float erf0 = signf(x0) * erf_poly_from_e(fabsf(x0), e0);
  const float erf1 = signf(x1) * erf_poly_from_e(fabsf(x1), e1);
  const float d_erf = fmaxf(0.5f * (erf1 - erf0), 0.0f);

  const bool one_sided = (u0 * u1) > 0.0f;
  const float un = one_sided ? fminf(u0 * u0, u1 * u1) : 0.0f;
  const float erf_scale = expf(0.5f * fminf(un, 13.0f));

  const bool right = u0 > 3.5f;
  const bool left = u1 < -3.5f;
  const float au0 = fabsf(u0);
  const float au1 = fabsf(u1);
  const float u_near = right ? au0 : au1;
  const float u_far = right ? au1 : au0;
  const float m_near = mills_scaled(u_near, 0.0f);
  const float m_far = mills_scaled(u_far, 0.5f * (un - u_far * u_far));
  const float d_asym = fmaxf(m_near - m_far, 0.0f);
  *d = (right || left) ? d_asym : d_erf * erf_scale;
  *unear_sq = un;
}

// The per-(star, segment) pieces shared by forward and backward
// (base_tpu/ops/pallas_marglik.py `_core_width_of`).
struct Segment {
  float core, width, u0, u1, width_s, unear_sq, mu, rsq;
  bool live;
};

__device__ __forceinline__ Segment core_width(float alpha, float beta,
                                              float gamma, float logw) {
  Segment g;
  const float ac = fmaxf(alpha, ALPHA_EPS);
  g.rsq = rsqrtf(ac);
  const float inv_a = g.rsq * g.rsq;
  g.mu = beta * inv_a;
  const float resid = fmaxf(gamma - beta * g.mu, 0.0f);
  const float sq = ac * g.rsq;
  g.u0 = -g.mu * sq;
  g.u1 = sq - g.mu * sq;
  phi_interval_scaled(g.u0, g.u1, &g.width_s, &g.unear_sq);
  g.live = alpha > FLAT_EPS;
  const float mid = gamma - beta + 0.25f * alpha;
  g.core = (g.live ? -0.5f * (resid + g.unear_sq) : -0.5f * mid) + logw;
  g.width = g.live ? SQRT_2PI * g.rsq * g.width_s : 1.0f;
  return g;
}

__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float M = fmaxf(m, m2);
  s = __fadd_rn(__fmul_rn(s, expf(m - M)), __fmul_rn(s2, expf(m2 - M)));
  m = M;
}

// The [0,1]-truncated Gaussian moments <t> and <t^2> of a segment, for the
// analytic d log I / d(alpha, beta, gamma) = (-<t^2>/2, <t>, -1/2).
__device__ __forceinline__ void moments(const Segment& g, float* t1,
                                        float* t2) {
  // unear_sq is u0 * u0 or u1 * u1 rounded, so one of these exponents
  // must come out exactly 0: without FMA contraction.  An FMA leaves
  // the rounding error of u0^2 (~1e-3 at u0 ~ 150, a star before a
  // steep WD segment), and <t> = mu + sigma r1, which cancels to
  // ~sigma / u0 there, moves by ~|mu| times that.
  const float phi_s0 = INV_SQRT_2PI *
      expf(0.5f * fminf(__fsub_rn(g.unear_sq, __fmul_rn(g.u0, g.u0)), 0.0f));
  const float phi_s1 = INV_SQRT_2PI *
      expf(0.5f * fminf(__fsub_rn(g.unear_sq, __fmul_rn(g.u1, g.u1)), 0.0f));
  const float zs = fmaxf(g.width_s, 1e-12f);
  const float r1 = (phi_s0 - phi_s1) / zs;
  const float sigma = g.rsq;
  *t1 = btt::clamp01(g.mu + sigma * r1);
  const float t2v =
      sigma * sigma * (1.0f + (g.u0 * phi_s0 - g.u1 * phi_s1) / zs) +
      g.mu * g.mu + 2.0f * g.mu * sigma * r1;
  *t2 = btt::clamp01(t2v);
  if (!g.live) {  // midpoint branch: the t -> 1/2 point moments
    *t1 = 0.5f;
    *t2 = 0.25f;
  }
}

}  // namespace
