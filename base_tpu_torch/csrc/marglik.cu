// Segment-exact per-star marginal likelihood: kernels 3 (forward) and 4
// (backward).
//
// Replaces base_tpu/ops/pallas_marglik.py `_fwd_kernel` (launched from
// `_fwd`) and `_bwd_kernel` (launched from `_bwd_rule`), residual-form band
// loop only (the `matmul=True` variant is not ported).  Per chain c, star s
// and segment t, with chi2(u) = alpha u^2 - 2 beta u + gamma on u in [0, 1]:
//   term = exp(core - m) * width,  core = -chi2_min/2 + logw
//   out[c, s] = m + log(sum_t term + 1e-15) + log_norm[s]
// The backward recomputes core and width, takes the softmax weights from the
// saved output and the analytic d log I / d(alpha, beta, gamma) from the
// [0,1]-truncated Gaussian moments, and sums over stars into dlo, dhi, dlogw.
//
// What bounds it on the H100: per (chain, star, segment) ~11 flops per band
// for the band contraction plus core_width's rsqrt, ~5 exp and 2-4
// divisions (~190 flops at B = 8); at the bench shapes (C = 64, S = 100,
// T = 504) that is ~3.2M elements and ~0.6 GFLOP per call against ~2.3 MB
// of inputs, so FP32 throughput bounds it (~9 us at 67 TFLOP/s).  Each
// element is a long dependent chain, so the design is about latency and
// filling the card.
//
// Forward (kernel 3), redesigned for Hopper: one warp per (chain, star),
// FWD_WARPS stars of one chain per block, grid (star groups, chains) -- 832
// blocks of 256 threads at config-1.  The block stages the chain's table
// (lo, d = hi - lo, logw, mask) in shared memory, band-major with a padded
// row so that lanes read consecutive words; tiles of up to `fwd_tile`
// segments (all of T = 504 at B = 8, three tiles at T = 2016) fit in 48 KB.
// Lane l takes segments t = l (mod 32) in order and keeps its own online
// (max, sum); the 32 partial (m, s) then merge through a fixed xor-shuffle
// tree, (m, s) + (m', s') = (M, s e^(m - M) + s' e^(m' - M)), written without
// FMA contraction so that the merge is symmetric.  No atomics: the result is
// bit-identical from run to run, and independent of the tile size.
//
// Backward (kernel 4, unchanged since the first port): grid (segment tiles
// of 64, chains), one thread per segment looping over all stars in order
// (star tiles staged through shared memory), so the sum over stars has a
// fixed order with no atomics and same-seed runs stay bit-identical.
//
// phi_interval_scaled below is a line-for-line copy of
// base_tpu_torch/ops/special.py (and base_tpu/ops/special.py): the A-S
// 7.1.26 erf, the +-3.5 Mills switch and the min(unear_sq, 13) clamp.  The
// library is built without --use_fast_math: the erf polynomial, expf in the
// far tails and the 1e-15 / 1e-12 floors need IEEE float32.
#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float SQRT_2PI = 2.5066282746310002f;
constexpr float INV_SQRT2 = 0.7071067811865476f;
constexpr float INV_SQRT_2PI = 0.3989422804014327f;
constexpr float ALPHA_EPS = 1e-12f;
constexpr float FLAT_EPS = 3e-7f;
constexpr int FWD_WARPS = 8;      // stars (warps) per forward block
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int BWD_SEGS = 64;      // segments (threads) per backward block
constexpr int BWD_STAR_TILE = 128;

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

// Segments per staged tile: a multiple of 32 (so lane l keeps t = l mod 32
// across tiles) whose band-major rows, padded by one word, fit in 48 KB.
int fwd_tile(int T, int B) {
  const int fit = (48 * 1024 / static_cast<int>(sizeof(float)) - 2 * B) /
                  (2 * B + 2) / 32 * 32;
  const int whole = (T + 31) / 32 * 32;
  return whole < fit ? whole : fit;
}

__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float M = fmaxf(m, m2);
  s = __fadd_rn(__fmul_rn(s, expf(m - M)), __fmul_rn(s2, expf(m2 - M)));
  m = M;
}

// At most 64 registers a thread, so that four blocks (32 warps) fit an SM.
__global__ void __launch_bounds__(FWD_WARPS * 32, 4)
marglik_fwd_kernel(const float* __restrict__ obs,
                                   const float* __restrict__ iv,
                                   const float* __restrict__ log_norm,
                                   const float* __restrict__ lo,
                                   const float* __restrict__ hi,
                                   const float* __restrict__ logw,
                                   const float* __restrict__ mask,
                                   float* __restrict__ out, int S, int T,
                                   int B, int TS) {
  extern __shared__ float sh[];
  const int TP = TS + 1;                    // padded row: no bank conflicts
  float* s_lo = sh;                         // [B, TP]
  float* s_d = s_lo + B * TP;               // [B, TP]
  float* s_lw = s_d + B * TP;               // [TS]
  float* s_mk = s_lw + TS;                  // [TS]
  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * FWD_WARPS + (threadIdx.x >> 5);
  const bool active = s < S;                // warp-uniform
  float o[btt::MAX_B], w[btt::MAX_B];
#pragma unroll
  for (int b = 0; b < btt::MAX_B; ++b) {
    o[b] = (active && b < B) ? obs[static_cast<size_t>(s) * B + b] : 0.0f;
    w[b] = (active && b < B) ? iv[static_cast<size_t>(s) * B + b] : 0.0f;
  }
  const size_t tb0 = static_cast<size_t>(c) * T * B;
  const size_t t0c = static_cast<size_t>(c) * T;
  float m = NEG_INF;
  float acc = 0.0f;
  for (int t0 = 0; t0 < T; t0 += TS) {
    const int nt = min(TS, T - t0);
    __syncthreads();  // previous tile fully consumed
    for (int i = threadIdx.x; i < nt * B; i += blockDim.x) {
      const int tt = i / B;
      const int b = i - tt * B;
      const size_t k = tb0 + static_cast<size_t>(t0) * B + i;
      const float l = lo[k];
      s_lo[b * TP + tt] = l;
      s_d[b * TP + tt] = hi[k] - l;
    }
    for (int i = threadIdx.x; i < nt; i += blockDim.x) {
      s_lw[i] = logw[t0c + t0 + i];
      s_mk[i] = mask[t0c + t0 + i];
    }
    __syncthreads();
    if (!active) continue;
    for (int tt = lane; tt < nt; tt += 32) {
      if (!(s_mk[tt] > 0.5f)) continue;  // masked segments add exactly 0
      float alpha = 0.0f, beta = 0.0f, gamma = 0.0f;
#pragma unroll
      for (int b = 0; b < btt::MAX_B; ++b) {
        if (b < B) {
          const float d = s_d[b * TP + tt];
          const float r = o[b] - s_lo[b * TP + tt];
          alpha += w[b] * d * d;
          beta += w[b] * r * d;
          gamma += w[b] * r * r;
        }
      }
      const Segment g = core_width(alpha, beta, gamma, s_lw[tt]);
      if (g.core > m) {
        acc = acc * expf(m - g.core) + g.width;
        m = g.core;
      } else {
        acc += expf(g.core - m) * g.width;
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(FULL_MASK, m, off);
    const float a2 = __shfl_xor_sync(FULL_MASK, acc, off);
    merge(m, acc, m2, a2);
  }
  if (lane != 0) return;
  const float v = acc > 0.0f ? m + logf(acc + 1e-15f) : NEG_INF;
  out[static_cast<size_t>(c) * S + s] = v + log_norm[s];
}

__global__ void marglik_bwd_kernel(
    const float* __restrict__ obs, const float* __restrict__ iv,
    const float* __restrict__ log_norm, const float* __restrict__ lo,
    const float* __restrict__ hi, const float* __restrict__ logw,
    const float* __restrict__ mask, const float* __restrict__ out,
    const float* __restrict__ gout, float* __restrict__ dlo,
    float* __restrict__ dhi, float* __restrict__ dlogw, int S, int T,
    int B) {
  extern __shared__ float sh[];
  float* s_o = sh;                          // [BWD_STAR_TILE, B]
  float* s_w = s_o + BWD_STAR_TILE * B;     // [BWD_STAR_TILE, B]
  float* s_out = s_w + BWD_STAR_TILE * B;   // [BWD_STAR_TILE] out - log_norm
  float* s_g = s_out + BWD_STAR_TILE;       // [BWD_STAR_TILE]
  const int c = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = t < T;
  const size_t row = (static_cast<size_t>(c) * T + (active ? t : 0)) * B;
  float l[btt::MAX_B], d[btt::MAX_B], a_lo[btt::MAX_B], a_hi[btt::MAX_B];
#pragma unroll
  for (int b = 0; b < btt::MAX_B; ++b) {
    l[b] = (active && b < B) ? lo[row + b] : 0.0f;
    d[b] = (active && b < B) ? hi[row + b] - l[b] : 0.0f;
    a_lo[b] = 0.0f;
    a_hi[b] = 0.0f;
  }
  const size_t tc = static_cast<size_t>(c) * T + t;
  const bool live_seg = active && mask[tc] > 0.5f;
  const float lw = active ? logw[tc] : 0.0f;
  float a_lw = 0.0f;
  for (int s0 = 0; s0 < S; s0 += BWD_STAR_TILE) {
    const int ns = min(BWD_STAR_TILE, S - s0);
    __syncthreads();
    for (int i = threadIdx.x; i < ns * B; i += blockDim.x) {
      s_o[i] = obs[static_cast<size_t>(s0) * B + i];
      s_w[i] = iv[static_cast<size_t>(s0) * B + i];
    }
    for (int i = threadIdx.x; i < ns; i += blockDim.x) {
      const size_t k = static_cast<size_t>(c) * S + s0 + i;
      s_out[i] = out[k] - log_norm[s0 + i];
      s_g[i] = gout[k];
    }
    __syncthreads();
    if (!live_seg) continue;  // masked segments get exactly 0
    for (int ss = 0; ss < ns; ++ss) {
      float alpha = 0.0f, beta = 0.0f, gamma = 0.0f;
#pragma unroll
      for (int b = 0; b < btt::MAX_B; ++b) {
        if (b < B) {
          const float wb = s_w[ss * B + b];
          const float r = s_o[ss * B + b] - l[b];
          alpha += wb * d[b] * d[b];
          beta += wb * r * d[b];
          gamma += wb * r * r;
        }
      }
      const Segment g = core_width(alpha, beta, gamma, lw);
      // exp(core - out') * width = term / sum: the softmax weight.
      const float gw = s_g[ss] * expf(g.core - s_out[ss]) * g.width;
      const float phi_s0 =
          INV_SQRT_2PI * expf(0.5f * fminf(g.unear_sq - g.u0 * g.u0, 0.0f));
      const float phi_s1 =
          INV_SQRT_2PI * expf(0.5f * fminf(g.unear_sq - g.u1 * g.u1, 0.0f));
      const float zs = fmaxf(g.width_s, 1e-12f);
      const float r1 = (phi_s0 - phi_s1) / zs;
      const float sigma = g.rsq;
      float t1 = btt::clamp01(g.mu + sigma * r1);
      float t2 = sigma * sigma * (1.0f + (g.u0 * phi_s0 - g.u1 * phi_s1) / zs) +
                 g.mu * g.mu + 2.0f * g.mu * sigma * r1;
      t2 = btt::clamp01(t2);
      if (!g.live) {  // midpoint branch: the t -> 1/2 point moments
        t1 = 0.5f;
        t2 = 0.25f;
      }
      const float ga = gw * (-0.5f) * t2;
      const float gb = gw * t1;
      const float gc = gw * (-0.5f);
#pragma unroll
      for (int b = 0; b < btt::MAX_B; ++b) {
        if (b < B) {
          const float wb = s_w[ss * B + b];
          const float r = s_o[ss * B + b] - l[b];
          a_lo[b] += wb * (-2.0f * ga * d[b] - gb * (d[b] + r) - 2.0f * gc * r);
          a_hi[b] += wb * (2.0f * ga * d[b] + gb * r);
        }
      }
      a_lw += gw;
    }
  }
  if (!active) return;
#pragma unroll
  for (int b = 0; b < btt::MAX_B; ++b) {
    if (b < B) {
      dlo[row + b] = a_lo[b];
      dhi[row + b] = a_hi[b];
    }
  }
  dlogw[tc] = a_lw;
}

}  // namespace

extern "C" int btt_marglik_fwd(const float* obs, const float* iv,
                               const float* log_norm, const float* lo,
                               const float* hi, const float* logw,
                               const float* mask, float* out, int C, int S,
                               int T, int B, int device, void* stream) {
  cudaSetDevice(device);
  const int TS = fwd_tile(T, B);
  dim3 grid((S + FWD_WARPS - 1) / FWD_WARPS, C);
  const size_t smem =
      (static_cast<size_t>(2 * B) * (TS + 1) + 2 * TS) * sizeof(float);
  marglik_fwd_kernel<<<grid, FWD_WARPS * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      obs, iv, log_norm, lo, hi, logw, mask, out, S, T, B, TS);
  return static_cast<int>(cudaGetLastError());  // launch status
}

extern "C" int btt_marglik_bwd(const float* obs, const float* iv,
                               const float* log_norm, const float* lo,
                               const float* hi, const float* logw,
                               const float* mask, const float* out,
                               const float* gout, float* dlo, float* dhi,
                               float* dlogw, int C, int S, int T, int B,
                               int device, void* stream) {
  cudaSetDevice(device);
  dim3 grid((T + BWD_SEGS - 1) / BWD_SEGS, C);
  const size_t smem = static_cast<size_t>(BWD_STAR_TILE) * (2 * B + 2) * sizeof(float);
  marglik_bwd_kernel<<<grid, BWD_SEGS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      obs, iv, log_norm, lo, hi, logw, mask, out, gout, dlo, dhi, dlogw, S, T,
      B);
  return static_cast<int>(cudaGetLastError());  // launch status
}
