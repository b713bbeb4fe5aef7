// Segment-exact per-star marginal likelihood: kernels 3 (forward) and 4
// (backward).
//
// Replaces base_tpu/ops/pallas_marglik.py `_fwd_kernel` (launched from
// `_fwd`) and `_bwd_kernel` (launched from `_bwd_rule`), residual-form band
// loop (the `matmul=True` form is kernels 3m and 4m, marglik_mm.cu).  Per
// chain c, star s and segment t, with chi2(u) = alpha u^2 - 2 beta u +
// gamma on u in [0, 1]:
//   term = exp(core - m) * width,  core = -chi2_min/2 + logw
//   out[c, s] = m + log(sum_t term + 1e-15) + log_norm[s]
// The backward recomputes core and width, takes the softmax weights from the
// saved output and the analytic d log I / d(alpha, beta, gamma) from the
// [0,1]-truncated Gaussian moments, and sums over stars into dlo, dhi, dlogw.
//
// What bounds the forward on the H100: per (chain, star, segment) ~11
// flops per band for the band contraction plus core_width's rsqrt, ~5 exp
// and 2-4 divisions (~190 flops at B = 8); at the bench shapes (C = 64,
// S = 100, T = 504) that is ~3.2M elements and ~0.6 GFLOP per call against
// ~2.3 MB of inputs, so FP32 throughput bounds it (~9 us at 67 TFLOP/s).
// Each element is a long dependent chain, so the design is about latency
// and filling the card.
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
// Backward (kernel 4), redesigned for Hopper.  It sums over stars, and
// almost every term of that sum is an exact zero: the softmax weight
// exp(core - out') * width underflows to 0.0f for 98% of the live elements
// at config-1 (99% at upsample 4), and a zero weight zeroes every
// cotangent.  So it is bound by the work the zeros still cost -- finding
// them -- and by the full path (core_width, the moments, ~140 flops + 14 a
// band) of the ~2% that are kept, plus each block's fixed cost (loads,
// merge); no longer by the band contraction of every element.
// - Two skip rules, stated once in ops/marglik.py and held by
//   tests/test_torch_kernels_plain.py to never drop a non-zero weight; the
//   kernel repeats their float32 operations in order, without FMA
//   contraction.  `marglik_bwd_group_skip` (`skip_group`): per band the 32
//   segments of a group span [mn_b, mx_b], so chi2 >= sum_b iv_b dist(o_b,
//   [mn_b, mx_b])^2; with the group's largest logw this marks whole (group,
//   star) pairs before any band contraction (89% at config-1).
//   `marglik_bwd_skip` (`skip_element`), after the contraction: chi2c =
//   (alpha u - 2 beta) u + gamma at u = clamp(beta/alpha, 0, 1) is the
//   on-segment minimum of chi2, so core <= -chi2c/2 + logw.  Both skip when
//   that bound, minus out', plus a log-width margin (16) and a rounding
//   slack (1e-5 (|gamma| + 2|beta| + alpha), or its group bound), is below
//   -105, where expf gives 0.0f.
// - Parallel star sum with a fixed-order merge: a block of BWD_WARPS warps
//   covers one group of 32 segments of one chain (lane = segment; grid
//   (T/32, chains), 1024 blocks at config-1).  Stars are staged in tiles of
//   BWD_STAR_TILE in shared memory; warp w takes the w-th run of
//   consecutive stars of a tile, tests them against the group rule one
//   star a lane, and walks the stars it keeps in order: band contraction,
//   element rule, and the full path only if some lane needs it.  Each lane
//   keeps its own a_lo[B], a_hi[B], a_lw in registers.  At the end the
//   warps' partials meet in shared memory and each (output, segment) is
//   summed over the warps in warp order.  No atomics: same-seed runs are
//   bit-identical.
// - B is a template argument (B = 1..32 behind one switch), so the band
//   arrays live in registers.  From B = 23 the warps' partials pass 48 KB
//   of shared memory, which the launch asks for (`allow_smem`).
//
// Bands in kernel 3: o[] and w[] are sized by a band class (common.cuh),
// one instance for B <= 16 and one for 17..32; the staged tile is sized
// for 48 KB at any B up to 32 (`fwd_tile`).
//
// core_width, phi_interval_scaled, the online merge and the moments are in
// marglik_core.cuh, shared with the matmul forms (marglik_mm.cu).
#include "marglik_core.cuh"

namespace {

constexpr int FWD_WARPS = 8;      // stars (warps) per forward block
constexpr int BWD_WARPS = 8;      // star slices (warps) per backward block
constexpr int BWD_STAR_TILE = 128;  // stars staged at a time
// Kernel 4's skip rule (ops/marglik.py `marglik_bwd_skip`).
constexpr float SKIP_BELOW = -105.0f;
constexpr float SKIP_LOG_WIDTH = 16.0f;
constexpr float SKIP_REL = 1e-5f;

// Segments per staged tile: a multiple of 32 (so lane l keeps t = l mod 32
// across tiles) whose band-major rows, padded by one word, fit in 48 KB.
int fwd_tile(int T, int B) {
  const int fit = (48 * 1024 / static_cast<int>(sizeof(float)) - 2 * B) /
                  (2 * B + 2) / 32 * 32;
  const int whole = (T + 31) / 32 * 32;
  return whole < fit ? whole : fit;
}

// MB: the band class (common.cuh).  At most 64 registers a thread for the
// narrow class, so that four blocks (32 warps) fit an SM; 128 for the wide
// one, whose o[] and w[] alone take 64.
template <int MB>
__global__ void __launch_bounds__(FWD_WARPS * 32,
                                  MB <= btt::NARROW_B ? 4 : 2)
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
  float o[MB], w[MB];
#pragma unroll
  for (int b = 0; b < MB; ++b) {
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
      for (int b = 0; b < MB; ++b) {
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

// ops/marglik.py `_zero_weight`: the softmax weight of an element whose
// chi2 is at least `chi2` is certain to be 0.0.  A NaN bound compares false.
__device__ __forceinline__ bool zero_weight(float chi2, float logw, float outp,
                                            float scale) {
  const float slack = __fmul_rn(SKIP_REL, scale);
  const float bound = __fadd_rn(
      __fadd_rn(__fsub_rn(__fadd_rn(-0.5f * chi2, logw), outp),
                SKIP_LOG_WIDTH),
      slack);
  return bound < SKIP_BELOW;
}

// ops/marglik.py `marglik_bwd_skip` for one element, operation for
// operation and without FMA contraction.
__device__ __forceinline__ bool skip_element(float alpha, float beta,
                                             float gamma, float logw,
                                             float outp) {
  const float u = btt::clamp01(__fdiv_rn(beta, fmaxf(alpha, ALPHA_EPS)));
  const float chi2c = __fadd_rn(
      __fmul_rn(__fsub_rn(__fmul_rn(alpha, u), 2.0f * beta), u), gamma);
  return zero_weight(
      chi2c, logw, outp,
      __fadd_rn(__fadd_rn(fabsf(gamma), 2.0f * fabsf(beta)), alpha));
}

// ops/marglik.py `marglik_bwd_group_skip` for one (group, star), from the
// group's band ranges [mn_b, mx_b] and largest live logw: its float32
// operations in band order, without FMA contraction.
template <int B>
__device__ __forceinline__ bool skip_group(const float* o, const float* w,
                                           const float* mn, const float* mx,
                                           float mlw, float outp) {
  float lb = 0.0f, gm = 0.0f, bt = 0.0f, aw = 0.0f;
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const float dist =
        fmaxf(fmaxf(__fsub_rn(mn[b], o[b]), __fsub_rn(o[b], mx[b])), 0.0f);
    const float r = fmaxf(fabsf(__fsub_rn(o[b], mn[b])),
                          fabsf(__fsub_rn(o[b], mx[b])));
    const float width = __fsub_rn(mx[b], mn[b]);
    lb = __fadd_rn(lb, __fmul_rn(__fmul_rn(w[b], dist), dist));
    gm = __fadd_rn(gm, __fmul_rn(__fmul_rn(w[b], r), r));
    bt = __fadd_rn(bt, __fmul_rn(__fmul_rn(w[b], r), width));
    aw = __fadd_rn(aw, __fmul_rn(__fmul_rn(w[b], width), width));
  }
  return zero_weight(lb, mlw, outp, __fadd_rn(__fadd_rn(gm, 2.0f * bt), aw));
}

struct BwdArgs {
  const float *obs, *iv, *log_norm, *lo, *hi, *logw, *mask, *out, *gout;
  float *dlo, *dhi, *dlogw;
  int S, T;
};

// Floats of shared memory: the staged star tile and the group's band
// ranges and largest logw, then (reused) the warps' partial sums,
// [BWD_WARPS, 2B + 1, 33] with a padded row.
constexpr int BWD_PITCH = 33;
constexpr size_t bwd_smem_floats(int B) {
  return BWD_STAR_TILE * (2 * B + 2) + 2 * B + 1 >
                 BWD_WARPS * (2 * B + 1) * BWD_PITCH
             ? BWD_STAR_TILE * (2 * B + 2) + 2 * B + 1
             : BWD_WARPS * (2 * B + 1) * BWD_PITCH;
}

// One block per (group of 32 segments, chain); lane = segment, warp w
// takes the w-th of BWD_WARPS runs of consecutive stars of each staged
// tile (at most 16, one a lane for the group rule).  Four blocks an SM up
// to 8 bands (64 registers a thread), two up to 16, one above (l, d, a_lo
// and a_hi take 4B registers).
template <int B>
__global__ void __launch_bounds__(BWD_WARPS * 32,
                                  B <= 8 ? 4 : (B <= btt::NARROW_B ? 2 : 1))
marglik_bwd_kernel(const BwdArgs a) {
  extern __shared__ float sh[];
  float* s_o = sh;                          // [BWD_STAR_TILE, B]
  float* s_w = s_o + BWD_STAR_TILE * B;     // [BWD_STAR_TILE, B]
  float* s_out = s_w + BWD_STAR_TILE * B;   // [BWD_STAR_TILE] out - log_norm
  float* s_g = s_out + BWD_STAR_TILE;       // [BWD_STAR_TILE]
  float* s_mn = s_g + BWD_STAR_TILE;        // [B] group's band ranges
  float* s_mx = s_mn + B;                   // [B]
  float* s_mlw = s_mx + B;                  // [1] group's largest logw
  const int S = a.S, T = a.T;
  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * 32;
  const int t = t0 + lane;
  const bool active = t < T;
  const size_t tc = static_cast<size_t>(c) * T + (active ? t : 0);
  const bool live_seg = active && a.mask[tc] > 0.5f;
  const float lw = active ? a.logw[tc] : 0.0f;
  float l[B], d[B], a_lo[B], a_hi[B];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    l[b] = active ? a.lo[tc * B + b] : 0.0f;
    const float h = active ? a.hi[tc * B + b] : 0.0f;
    d[b] = h - l[b];
    a_lo[b] = 0.0f;
    a_hi[b] = 0.0f;
    if (warp == 0) {  // the group's range of band b over its live segments
      float vmin = live_seg ? fminf(l[b], h) : INFINITY;
      float vmax = live_seg ? fmaxf(l[b], h) : -INFINITY;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        vmin = fminf(vmin, __shfl_xor_sync(FULL_MASK, vmin, off));
        vmax = fmaxf(vmax, __shfl_xor_sync(FULL_MASK, vmax, off));
      }
      if (lane == 0) {
        s_mn[b] = vmin;
        s_mx[b] = vmax;
      }
    }
  }
  if (warp == 0) {
    float v = live_seg ? lw : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, off));
    if (lane == 0) s_mlw[0] = v;
  }
  float a_lw = 0.0f;
  // Masked segments get exactly 0; a block with none live stages nothing.
  const bool any_live = __syncthreads_or(live_seg);
  for (int s0 = 0; any_live && s0 < S; s0 += BWD_STAR_TILE) {
    const int ns = min(BWD_STAR_TILE, S - s0);
    __syncthreads();  // previous tile fully consumed
    for (int i = threadIdx.x; i < ns * B; i += blockDim.x) {
      s_o[i] = a.obs[static_cast<size_t>(s0) * B + i];
      s_w[i] = a.iv[static_cast<size_t>(s0) * B + i];
    }
    for (int i = threadIdx.x; i < ns; i += blockDim.x) {
      const size_t k = static_cast<size_t>(c) * S + s0 + i;
      s_out[i] = a.out[k] - a.log_norm[s0 + i];
      s_g[i] = a.gout[k];
    }
    __syncthreads();
    // The group rule, one star a lane, then the stars it keeps in order.
    const int per = (ns + BWD_WARPS - 1) / BWD_WARPS;
    const int first = warp * per;
    const int count = min(ns - first, per);
    bool test = false;
    if (lane < count) {
      const int ss = first + lane;
      test = !skip_group<B>(s_o + ss * B, s_w + ss * B, s_mn, s_mx,
                            s_mlw[0], s_out[ss]);
    }
    unsigned todo = __ballot_sync(FULL_MASK, test);
    while (todo != 0) {  // warp-uniform
      const int ss = first + __ffs(todo) - 1;
      todo &= todo - 1;
      const float* o = s_o + ss * B;
      const float* w = s_w + ss * B;
      float alpha = 0.0f, beta = 0.0f, gamma = 0.0f;
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float r = o[b] - l[b];
        alpha += w[b] * d[b] * d[b];
        beta += w[b] * r * d[b];
        gamma += w[b] * r * r;
      }
      const float outp = s_out[ss];
      const bool need =
          live_seg && !skip_element(alpha, beta, gamma, lw, outp);
      if (!__any_sync(FULL_MASK, need)) continue;  // the whole warp skips
      if (!need) continue;
      const Segment g = core_width(alpha, beta, gamma, lw);
      // exp(core - out') * width = term / sum: the softmax weight.
      const float gw = s_g[ss] * expf(g.core - outp) * g.width;
      float t1, t2;
      moments(g, &t1, &t2);
      const float ga = gw * (-0.5f) * t2;
      const float gb = gw * t1;
      const float gc = gw * (-0.5f);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float r = o[b] - l[b];
        a_lo[b] += w[b] * (-2.0f * ga * d[b] - gb * (d[b] + r) - 2.0f * gc * r);
        a_hi[b] += w[b] * (2.0f * ga * d[b] + gb * r);
      }
      a_lw += gw;
    }
  }

  // The warps' partials through shared memory, summed in warp order.
  __syncthreads();
  float* mine = sh + warp * (2 * B + 1) * BWD_PITCH + lane;
#pragma unroll
  for (int b = 0; b < B; ++b) {
    mine[b * BWD_PITCH] = a_lo[b];
    mine[(B + b) * BWD_PITCH] = a_hi[b];
  }
  mine[2 * B * BWD_PITCH] = a_lw;
  __syncthreads();
  const int nt = min(32, T - t0);
  const size_t row0 = (static_cast<size_t>(c) * T + t0) * B;
  for (int i = threadIdx.x; i < nt * B; i += blockDim.x) {
    const int tt = i / B;
    const int b = i - tt * B;
    float vlo = 0.0f, vhi = 0.0f;
#pragma unroll
    for (int k = 0; k < BWD_WARPS; ++k) {
      const float* p = sh + k * (2 * B + 1) * BWD_PITCH + tt;
      vlo += p[b * BWD_PITCH];
      vhi += p[(B + b) * BWD_PITCH];
    }
    a.dlo[row0 + i] = vlo;
    a.dhi[row0 + i] = vhi;
  }
  for (int i = threadIdx.x; i < nt; i += blockDim.x) {
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < BWD_WARPS; ++k)
      v += sh[(k * (2 * B + 1) + 2 * B) * BWD_PITCH + i];
    a.dlogw[static_cast<size_t>(c) * T + t0 + i] = v;
  }
}

// The band count is a template argument (registers, unrolled loops): B = 1
// .. MAX_B behind one runtime switch.
template <int B>
int launch_bwd(const BwdArgs& a, int C, cudaStream_t st) {
  const dim3 grid((a.T + 31) / 32, C);
  const size_t smem = bwd_smem_floats(B) * sizeof(float);
  const int err = btt::allow_smem(marglik_bwd_kernel<B>, smem);
  if (err != 0) return err;
  marglik_bwd_kernel<B><<<grid, BWD_WARPS * 32, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());  // launch status
}

template <int B>
int dispatch_bwd(int bands, const BwdArgs& a, int C, cudaStream_t st) {
  if (bands == B) return launch_bwd<B>(a, C, st);
  if constexpr (B < btt::MAX_B) return dispatch_bwd<B + 1>(bands, a, C, st);
  return static_cast<int>(cudaErrorInvalidValue);
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
  const auto st = static_cast<cudaStream_t>(stream);
  if (B <= btt::NARROW_B)
    marglik_fwd_kernel<btt::NARROW_B><<<grid, FWD_WARPS * 32, smem, st>>>(
        obs, iv, log_norm, lo, hi, logw, mask, out, S, T, B, TS);
  else
    marglik_fwd_kernel<btt::MAX_B><<<grid, FWD_WARPS * 32, smem, st>>>(
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
  const BwdArgs a{obs, iv, log_norm, lo, hi, logw, mask, out, gout,
                  dlo, dhi, dlogw, S, T};
  return dispatch_bwd<1>(B, a, C, static_cast<cudaStream_t>(stream));
}
