// The matmul form of the segment-exact marginal likelihood: kernels 3m
// (forward) and 4m (backward).
//
// Replaces base_tpu/ops/pallas_marglik.py `_fwd_kernel` and `_bwd_kernel`
// under `mm=True`: `_abg_matmul` (:107) expands chi2's band contractions
// into five [S_t, B] @ [B, T_t] products,
//   alpha = iv @ d^2
//   beta  = (iv obs) @ d - iv @ (lo d)
//   gamma = max(c0 - 2 (iv obs) @ lo + iv @ lo^2, 0),  c0 = sum_b iv obs^2
// and the backward takes its cotangents by five star-axis products (:261-289)
//   A1 = iv^T ga, B1 = iv^T gb, B2 = (iv obs)^T gb, C1 = iv^T gc,
//   C2 = (iv obs)^T gc                                        [B, T_t] each
//   dhi = 2 d A1 + (B2 - lo B1)
//   dlo = -2 d A1 - (d B1 + B2 - lo B1) - 2 (C2 - lo C1)
// The caller (ops/marglik.py `fused_log_marginals(..., matmul=True)`)
// centers obs, lo and hi per band first, as base_tpu does.  Everything after
// the contractions -- core_width, the online (max, sum), the softmax weights
// and the truncated-Gaussian moments -- is kernel 3's and 4's
// (marglik_core.cuh).  Full float32 FFMA: no TF32, no bf16.
//
// Kernel 3m: one block of 8 warps per (32 stars, chain), grid (star tiles,
// chains); the block walks the chain's segments in tiles of 128.  Per star
// tile the vectors iv and iv obs are staged star-minor [B, 32] (a warp
// reads its 4 stars as one float4) with c0 beside them; per segment tile lo
// and d are staged band-major [B, 128], and d^2, lo d, lo^2 are formed in
// registers.  Thread (warp w, lane l) holds a register tile of 4 stars (4w
// .. 4w + 3) x 4 segments (l + 32 j) and its 5 x 16 accumulators: per band
// 2 float4 + 8 scalar shared loads feed 80 FMAs.  Then, per element,
// core_width and the lane's online (max, sum) per star, segments in
// ascending order; the 32 lanes merge by kernel 3's fixed xor-shuffle tree.
//
// Kernel 4m: one block of 8 warps per (group of 32 segments, chain), lane =
// segment, as kernel 4; lo and d of the group staged [B, 32] once.  Per tile
// of 32 stars: thread (w, l) contracts its 4 stars x 1 segment over the
// bands, computes the softmax weight gw and the moments and stores ga, gb,
// gc in shared [32, 33]; then each thread owns up to 4 (band, segment)
// outputs and adds the tile's stars into its 5 products in star order.  At
// the end it assembles dlo and dhi; dlogw is summed per thread over its
// stars and over the warps in warp order.  No atomics: reruns are
// bit-identical.  Kernel 4's skip rules are not applied: the expanded
// alpha, beta and gamma carry the expansion's cancellation, which the
// rules' 1e-5 slack does not cover.
#include "marglik_core.cuh"

namespace {

constexpr int MM_WARPS = 8;
constexpr int MM_THREADS = MM_WARPS * 32;
constexpr int MM_SPW = 4;                    // stars a warp (a thread's rows)
constexpr int MM_STARS = MM_WARPS * MM_SPW;  // stars a tile: 32
constexpr int MM_SEGS = 4;                   // segments a lane (kernel 3m)
constexpr int MM_TILE = 32 * MM_SEGS;        // segments a 3m tile: 128
constexpr int MM_PITCH = 33;                 // padded row of 4m's weights
// (band, segment) outputs a 4m thread owns: B * 32 over the block.
constexpr int MM_PAIRS = btt::MAX_B * 32 / MM_THREADS;

// Stage the star tile's iv and iv obs star-minor [B, MM_STARS] and c0 =
// sum_b (iv obs) obs, an FMA a band in band order (zeros past the last
// star).
__device__ void stage_stars(float* s_iv, float* s_ivo, float* s_c0,
                            const float* obs, const float* iv, int s0, int S,
                            int B) {
  for (int i = threadIdx.x; i < B * MM_STARS; i += blockDim.x) {
    const int b = i / MM_STARS;
    const int s = s0 + i - b * MM_STARS;
    const size_t k = static_cast<size_t>(s) * B + b;
    const float w = s < S ? iv[k] : 0.0f;
    s_iv[i] = w;
    s_ivo[i] = w * (s < S ? obs[k] : 0.0f);
  }
  for (int i = threadIdx.x; i < MM_STARS; i += blockDim.x) {
    const int s = s0 + i;
    float c0 = 0.0f;
    for (int b = 0; s < S && b < B; ++b) {
      const size_t k = static_cast<size_t>(s) * B + b;
      c0 = fmaf(iv[k] * obs[k], obs[k], c0);
    }
    s_c0[i] = c0;
  }
}

// The five band contractions of one (star, segment) element, expanded:
// one explicit FMA a band, bands in order from 0, which ops/marglik.py
// `_abg_mm` reproduces rounding for rounding.
struct Abg {
  float a, b1, b2, g1, g2;  // iv d^2, ivo d, iv lo d, ivo lo, iv lo^2
};

__device__ __forceinline__ void add_band(Abg& x, float w, float v, float l,
                                         float d, float dd, float ld,
                                         float ll) {
  x.a = fmaf(w, dd, x.a);
  x.b1 = fmaf(v, d, x.b1);
  x.b2 = fmaf(w, ld, x.b2);
  x.g1 = fmaf(v, l, x.g1);
  x.g2 = fmaf(w, ll, x.g2);
}

__device__ __forceinline__ Segment expanded_core_width(const Abg& x, float c0,
                                                       float logw) {
  const float gamma = fmaxf(c0 - 2.0f * x.g1 + x.g2, 0.0f);
  return core_width(x.a, x.b1 - x.b2, gamma, logw);
}

__device__ __forceinline__ float4 warp_stars(const float* row, int warp) {
  return reinterpret_cast<const float4*>(row)[warp];
}

__global__ void __launch_bounds__(MM_THREADS, 2)
marglik_mm_fwd_kernel(const float* __restrict__ obs,
                      const float* __restrict__ iv,
                      const float* __restrict__ log_norm,
                      const float* __restrict__ lo,
                      const float* __restrict__ hi,
                      const float* __restrict__ logw,
                      const float* __restrict__ mask,
                      float* __restrict__ out, int S, int T, int B) {
  extern __shared__ float sh[];
  float* s_iv = sh;                          // [B, MM_STARS]
  float* s_ivo = s_iv + B * MM_STARS;        // [B, MM_STARS]
  float* s_c0 = s_ivo + B * MM_STARS;        // [MM_STARS]
  float* s_lo = s_c0 + MM_STARS;             // [B, MM_TILE]
  float* s_d = s_lo + B * MM_TILE;           // [B, MM_TILE]
  float* s_lw = s_d + B * MM_TILE;           // [MM_TILE]
  float* s_mk = s_lw + MM_TILE;              // [MM_TILE]
  const int c = blockIdx.y;
  const int s0 = blockIdx.x * MM_STARS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  stage_stars(s_iv, s_ivo, s_c0, obs, iv, s0, S, B);
  float m[MM_SPW], acc[MM_SPW];
#pragma unroll
  for (int k = 0; k < MM_SPW; ++k) {
    m[k] = NEG_INF;
    acc[k] = 0.0f;
  }
  const size_t tb0 = static_cast<size_t>(c) * T * B;
  const size_t t0c = static_cast<size_t>(c) * T;
  for (int t0 = 0; t0 < T; t0 += MM_TILE) {
    const int nt = min(MM_TILE, T - t0);
    __syncthreads();  // previous tile fully consumed (and the stars staged)
    for (int i = threadIdx.x; i < B * MM_TILE; i += blockDim.x) {
      const int b = i / MM_TILE;
      const int tt = i - b * MM_TILE;
      const size_t k = tb0 + static_cast<size_t>(t0 + tt) * B + b;
      const float l = tt < nt ? lo[k] : 0.0f;
      s_lo[i] = l;
      s_d[i] = tt < nt ? hi[k] - l : 0.0f;
    }
    for (int i = threadIdx.x; i < MM_TILE; i += blockDim.x) {
      s_lw[i] = i < nt ? logw[t0c + t0 + i] : 0.0f;
      s_mk[i] = i < nt ? mask[t0c + t0 + i] : 0.0f;
    }
    __syncthreads();
    Abg x[MM_SPW][MM_SEGS] = {};
    for (int b = 0; b < B; ++b) {
      const float4 w4 = warp_stars(s_iv + b * MM_STARS, warp);
      const float4 v4 = warp_stars(s_ivo + b * MM_STARS, warp);
      const float w[MM_SPW] = {w4.x, w4.y, w4.z, w4.w};
      const float v[MM_SPW] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int j = 0; j < MM_SEGS; ++j) {
        const float l = s_lo[b * MM_TILE + lane + 32 * j];
        const float d = s_d[b * MM_TILE + lane + 32 * j];
        const float dd = d * d, ld = l * d, ll = l * l;
#pragma unroll
        for (int k = 0; k < MM_SPW; ++k)
          add_band(x[k][j], w[k], v[k], l, d, dd, ld, ll);
      }
    }
#pragma unroll
    for (int j = 0; j < MM_SEGS; ++j) {
      const int tt = lane + 32 * j;
      if (!(s_mk[tt] > 0.5f)) continue;  // masked or past T: adds exactly 0
#pragma unroll
      for (int k = 0; k < MM_SPW; ++k) {
        const Segment g = expanded_core_width(
            x[k][j], s_c0[warp * MM_SPW + k], s_lw[tt]);
        if (g.core > m[k]) {
          acc[k] = acc[k] * expf(m[k] - g.core) + g.width;
          m[k] = g.core;
        } else {
          acc[k] += expf(g.core - m[k]) * g.width;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < MM_SPW; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(FULL_MASK, m[k], off);
      const float a2 = __shfl_xor_sync(FULL_MASK, acc[k], off);
      merge(m[k], acc[k], m2, a2);
    }
    const int s = s0 + warp * MM_SPW + k;
    if (lane == 0 && s < S) {
      const float v = acc[k] > 0.0f ? m[k] + logf(acc[k] + 1e-15f) : NEG_INF;
      out[static_cast<size_t>(c) * S + s] = v + log_norm[s];
    }
  }
}

size_t fwd_smem(int B) {
  return (static_cast<size_t>(2 * B) * (MM_STARS + MM_TILE) + MM_STARS +
          2 * MM_TILE) * sizeof(float);
}

struct MmBwdArgs {
  const float *obs, *iv, *log_norm, *lo, *hi, *logw, *mask, *out, *gout;
  float *dlo, *dhi, *dlogw;
  int S, T, B;
};

__global__ void __launch_bounds__(MM_THREADS, 2)
marglik_mm_bwd_kernel(const MmBwdArgs a) {
  extern __shared__ float sh[];
  const int S = a.S, T = a.T, B = a.B;
  float* s_lo = sh;                          // [B, 32] the group's segments
  float* s_d = s_lo + B * 32;                // [B, 32]
  float* s_iv = s_d + B * 32;                // [B, MM_STARS]
  float* s_ivo = s_iv + B * MM_STARS;        // [B, MM_STARS]
  float* s_c0 = s_ivo + B * MM_STARS;        // [MM_STARS]
  float* s_out = s_c0 + MM_STARS;            // [MM_STARS] out - log_norm
  float* s_g = s_out + MM_STARS;             // [MM_STARS]
  float* s_ga = s_g + MM_STARS;              // [MM_STARS, MM_PITCH]
  float* s_gb = s_ga + MM_STARS * MM_PITCH;  // [MM_STARS, MM_PITCH]
  float* s_gc = s_gb + MM_STARS * MM_PITCH;  // [MM_STARS, MM_PITCH]
  float* s_lw = s_gc + MM_STARS * MM_PITCH;  // [MM_WARPS, 32]
  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * 32;
  const int nt = min(32, T - t0);
  const size_t tc = static_cast<size_t>(c) * T + t0;
  const bool live_seg = lane < nt && a.mask[tc + lane] > 0.5f;
  const float lw = lane < nt ? a.logw[tc + lane] : 0.0f;
  for (int i = threadIdx.x; i < B * 32; i += blockDim.x) {
    const int b = i >> 5;
    const int tt = i & 31;
    const size_t k = (tc + tt) * B + b;
    const float l = tt < nt ? a.lo[k] : 0.0f;
    s_lo[i] = l;
    s_d[i] = tt < nt ? a.hi[k] - l : 0.0f;
  }
  float acc[MM_PAIRS][5] = {};
  float a_lw = 0.0f;
  // Masked segments get exactly 0; a block with none live stages no star.
  const bool any_live = __syncthreads_or(live_seg);
  for (int s0 = 0; any_live && s0 < S; s0 += MM_STARS) {
    __syncthreads();  // previous tile fully consumed
    stage_stars(s_iv, s_ivo, s_c0, a.obs, a.iv, s0, S, B);
    for (int i = threadIdx.x; i < MM_STARS; i += blockDim.x) {
      const int s = s0 + i;
      const size_t k = static_cast<size_t>(c) * S + s;
      s_out[i] = s < S ? a.out[k] - a.log_norm[s] : 0.0f;
      s_g[i] = s < S ? a.gout[k] : 0.0f;
    }
    __syncthreads();
    // This thread's stars 4 warp + k against its segment: the expanded
    // contraction, then the weights.
    Abg x[MM_SPW] = {};
    for (int b = 0; b < B; ++b) {
      const float4 w4 = warp_stars(s_iv + b * MM_STARS, warp);
      const float4 v4 = warp_stars(s_ivo + b * MM_STARS, warp);
      const float w[MM_SPW] = {w4.x, w4.y, w4.z, w4.w};
      const float v[MM_SPW] = {v4.x, v4.y, v4.z, v4.w};
      const float l = s_lo[b * 32 + lane];
      const float d = s_d[b * 32 + lane];
      const float dd = d * d, ld = l * d, ll = l * l;
#pragma unroll
      for (int k = 0; k < MM_SPW; ++k)
        add_band(x[k], w[k], v[k], l, d, dd, ld, ll);
    }
#pragma unroll
    for (int k = 0; k < MM_SPW; ++k) {
      const int ss = warp * MM_SPW + k;
      float ga = 0.0f, gb = 0.0f, gc = 0.0f, gw = 0.0f;
      if (live_seg && s0 + ss < S) {
        const Segment g = expanded_core_width(x[k], s_c0[ss], lw);
        // exp(core - out') * width = term / sum: the softmax weight.
        gw = s_g[ss] * expf(g.core - s_out[ss]) * g.width;
        float t1, t2;
        moments(g, &t1, &t2);
        ga = gw * (-0.5f) * t2;
        gb = gw * t1;
        gc = gw * (-0.5f);
      }
      s_ga[ss * MM_PITCH + lane] = ga;
      s_gb[ss * MM_PITCH + lane] = gb;
      s_gc[ss * MM_PITCH + lane] = gc;
      a_lw += gw;
    }
    __syncthreads();
    // The star-axis products: (band b, segment tt) outputs, stars in order.
    const int ns = min(MM_STARS, S - s0);
#pragma unroll
    for (int r = 0; r < MM_PAIRS; ++r) {
      const int p = threadIdx.x + r * MM_THREADS;
      if (p >= B * 32) break;  // warp-uniform
      const int b = p >> 5;
      const int tt = p & 31;
      for (int ss = 0; ss < ns; ++ss) {
        const float w = s_iv[b * MM_STARS + ss];
        const float v = s_ivo[b * MM_STARS + ss];
        const float ga = s_ga[ss * MM_PITCH + tt];
        const float gb = s_gb[ss * MM_PITCH + tt];
        const float gc = s_gc[ss * MM_PITCH + tt];
        acc[r][0] += w * ga;   // A1
        acc[r][1] += w * gb;   // B1
        acc[r][2] += v * gb;   // B2
        acc[r][3] += w * gc;   // C1
        acc[r][4] += v * gc;   // C2
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MM_PAIRS; ++r) {
    const int p = threadIdx.x + r * MM_THREADS;
    if (p >= B * 32) break;
    const int b = p >> 5;
    const int tt = p & 31;
    if (tt >= nt) continue;
    const float l = s_lo[p], d = s_d[p];
    const float A1 = acc[r][0], B1 = acc[r][1], B2 = acc[r][2];
    const float C1 = acc[r][3], C2 = acc[r][4];
    const size_t k = (tc + tt) * B + b;
    a.dhi[k] = 2.0f * d * A1 + (B2 - l * B1);
    a.dlo[k] = -2.0f * d * A1 - (d * B1 + B2 - l * B1) - 2.0f * (C2 - l * C1);
  }
  s_lw[warp * 32 + lane] = a_lw;
  __syncthreads();
  if (threadIdx.x < nt) {  // the warps' dlogw partials in warp order
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < MM_WARPS; ++k) v += s_lw[k * 32 + threadIdx.x];
    a.dlogw[tc + threadIdx.x] = v;
  }
}

size_t bwd_smem(int B) {
  return (static_cast<size_t>(4 * B) * 32 + 3 * MM_STARS +
          3 * MM_STARS * MM_PITCH + MM_WARPS * 32) * sizeof(float);
}

}  // namespace

extern "C" int btt_marglik_mm_fwd(const float* obs, const float* iv,
                                  const float* log_norm, const float* lo,
                                  const float* hi, const float* logw,
                                  const float* mask, float* out, int C, int S,
                                  int T, int B, int device, void* stream) {
  cudaSetDevice(device);
  if (B < 1 || B > btt::MAX_B) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_smem(B);
  const int err = btt::allow_smem(marglik_mm_fwd_kernel, smem);
  if (err != 0) return err;
  const dim3 grid((S + MM_STARS - 1) / MM_STARS, C);
  marglik_mm_fwd_kernel<<<grid, MM_THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      obs, iv, log_norm, lo, hi, logw, mask, out, S, T, B);
  return static_cast<int>(cudaGetLastError());  // launch status
}

extern "C" int btt_marglik_mm_bwd(const float* obs, const float* iv,
                                  const float* log_norm, const float* lo,
                                  const float* hi, const float* logw,
                                  const float* mask, const float* out,
                                  const float* gout, float* dlo, float* dhi,
                                  float* dlogw, int C, int S, int T, int B,
                                  int device, void* stream) {
  cudaSetDevice(device);
  if (B < 1 || B > btt::MAX_B) return static_cast<int>(cudaErrorInvalidValue);
  const MmBwdArgs a{obs, iv, log_norm, lo, hi, logw, mask, out, gout,
                    dlo, dhi, dlogw, S, T, B};
  const size_t smem = bwd_smem(B);
  const int err = btt::allow_smem(marglik_mm_bwd_kernel, smem);
  if (err != 0) return err;
  const dim3 grid((T + 31) / 32, C);
  marglik_mm_bwd_kernel<<<grid, MM_THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());  // launch status
}
