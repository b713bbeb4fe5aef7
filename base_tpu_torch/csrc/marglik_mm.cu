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
// (marglik_core.cuh).  Full float32 FFMA on the CUDA cores: no TF32, no
// bf16, no tensor cores, which would round the contraction otherwise.  Each
// element's five contractions are one FFMA a band, bands in order from 0,
// which ops/marglik.py `_abg_mm` reproduces rounding for rounding.
//
// What bounds them on the H100: per live (chain, star, segment) element
// 5B FFMA of contraction and core_width's ~200 instructions (rsqrt, ~6
// expf, ~5 IEEE divisions), so both are bound by operations; the inputs are
// a few MB.  Kernel 3m at the CLI's 29 bands (C 64, S 96, T 5056) is ~3e7
// elements; kernel 4m's work depends on the data (below).
//
// Kernel 3m, redesigned for Hopper: the segment axis is split across
// blocks as well as the stars, so that the grid fills the card at both
// widths.  A block of 8 warps (4 star warps x 2 segment warps) takes 16
// stars of one chain against one chunk of that chain's segments; a thread
// holds a register tile of 4 stars x 2 segments and its 5 x 8 accumulators
// (per band: two broadcast float4 loads of iv and iv obs, 4 scalar loads
// of lo and hi, 48 FP instructions; the band loop unrolled by 4).  Three
// blocks an SM (80 registers a thread).  The chunk is walked in tiles of 128
// segments staged by cp.async into a double buffer while the previous tile
// is computed; a warp copies whole [tile, B] rows of lo and hi (coalesced)
// into rows of odd pitch, so that the lanes' reads of one band across
// their segments hit distinct banks.  Each thread keeps an online (max,
// sum) per star over its segments in order; the 32 lanes merge by kernel
// 3's fixed xor-shuffle tree, the two segment warps in order, and where
// the segments span more than one chunk, a second launch merges the
// chunks' partial (max, sum) in chunk order (`merge_kernel`): no atomics,
// reruns are bit-identical.  The chunk count depends on the shapes alone
// (`fwd_plan`: about three waves of 3 blocks on 132 SMs), so the rounding
// does not depend on the card.  16 stars a block wastes 12 of 112 rows at
// S = 100 and none at S = 96.  Measured on the card (PERF.md): with the
// core_width of each element replaced by a few adds, the kernel keeps 70%
// of its time at B = 29: the contraction, at about half the FFMA issue
// rate; other tiles (8 stars x 1 or 2 segments, 32 stars a block, 128
// threads) and scalar star loads timed within 4% or slower.
//
// Kernel 4m, redesigned for Hopper: one block of 8 warps per (group of 32
// segments, chain), lane = segment, as kernel 4; the group's lo and d
// staged band-major once.  Almost every softmax weight is an exact zero
// (98% of the live elements on the bench shapes), and its work is finding
// them:
// - The group rule, stated once in ops/marglik.py
//   `marglik_mm_bwd_group_skip` and repeated here operation for operation
//   without FMA contraction (`skip_group`): kernel 4's bound on chi2 from
//   the group's band ranges, with a slack widened to the expansion's
//   rounding.  It marks a (group, star) pair before any contraction (89% of
//   them on the bench shapes, 94% at 29 bands).
// - Stars are staged 64 at a time, by cp.async into a double buffer while
//   the previous tile is consumed; one thread a star applies the rule, and
//   the stars it keeps are packed in star order.  A warp takes a kept star
//   at a time against its 32 segments: the expanded contraction, core_width,
//   the softmax weight gw and the moments, whose cotangents ga, gb, gc go to
//   shared memory; `__any_sync` on gw marks the star rows with a non-zero
//   weight.
// - The star-axis products skip every row whose weights are all exact
//   zeros: an FFMA by a zero product returns its accumulator, so every
//   output is the same bit for bit.  They are register-tiled: a thread owns
//   4 bands x 2 segments (5 x 8 accumulators; per row two float4 loads of
//   iv and iv obs and three float2 loads of ga, gb, gc feed 40 FFMA), and
//   the block's threads split the rows into star parts, each in star order;
//   at the end the parts are summed in part order through shared memory
//   and dlogw over the warps in warp order.  No atomics: reruns are
//   bit-identical.
// Three blocks an SM for up to 16 bands, two above (shared memory).
#include "marglik_core.cuh"

namespace {

// ---- cp.async (sm_80+): 4-byte copies global -> shared -------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, nrows) of B floats, contiguous at src, into rows of `pitch` at
// dst (rows nrows .. cap - 1 zeroed), by cp.async: a warp copies 32 / B
// whole rows a pass, so that its lanes read consecutive words.
__device__ __forceinline__ void stage_rows(float* dst, int pitch,
                                           const float* src, int nrows,
                                           int cap, int B) {
  const int lane = threadIdx.x & 31;
  const int rpp = 32 / B;
  const int r = lane / B;
  const int b = lane - r * B;
  if (r >= rpp) return;
  const int step = (blockDim.x >> 5) * rpp;
  for (int row = (threadIdx.x >> 5) * rpp + r; row < cap; row += step) {
    if (row < nrows)
      cp_async4(dst + row * pitch + b, src + static_cast<size_t>(row) * B + b);
    else
      dst[row * pitch + b] = 0.0f;
  }
}

// n floats at src into dst[0 .. cap) by cp.async (zeros past n).
__device__ __forceinline__ void stage_vec(float* dst, const float* src, int n,
                                          int cap) {
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    if (i < n)
      cp_async4(dst + i, src + i);
    else
      dst[i] = 0.0f;
  }
}

// ---- The expanded contraction ---------------------------------------------

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

// ---- Kernel 3m -------------------------------------------------------------

constexpr int F_SW = 4;                       // star warps
constexpr int F_TW = 2;                       // segment warps
constexpr int F_SPT = 4;                      // stars a thread
constexpr int F_TPT = 2;                      // segments a thread
constexpr int F_STARS = F_SW * F_SPT;         // stars a block: 16
constexpr int F_TILE = F_TW * 32 * F_TPT;     // segments a staged tile: 128
constexpr int F_THREADS = F_SW * F_TW * 32;   // 256
constexpr int F_MINB = 3;                     // blocks an SM (85 registers)
// Blocks to aim at: about three waves of three blocks on the H100's 132
// SMs (of 1, 2, 3 and 4 waves this timed best at B = 8, and within 1% of
// the best at B = 29: PERF.md).  A constant, so that the chunking (and
// the rounding) depends on the shapes alone.
constexpr long F_TARGET_BLOCKS = 3 * 3 * 132;

struct FwdPlan {
  int chunks;  // segment chunks a (star tile, chain)
  int per;     // tiles of F_TILE segments a chunk
};

FwdPlan fwd_plan(int C, int S, int T) {
  const int tiles = T > 0 ? (T + F_TILE - 1) / F_TILE : 1;
  const long base = static_cast<long>((S + F_STARS - 1) / F_STARS) * C;
  long want = (F_TARGET_BLOCKS + base - 1) / base;
  want = want < 1 ? 1 : (want > tiles ? tiles : want);
  const int per = static_cast<int>((tiles + want - 1) / want);
  return {(tiles + per - 1) / per, per};
}

// Odd pitch of a staged segment row: lanes reading one band of consecutive
// rows hit distinct banks.
__host__ __device__ __forceinline__ int odd_pitch(int B) { return B | 1; }

size_t fwd_smem(int B) {
  const int P = odd_pitch(B);
  return (static_cast<size_t>(3 * B) * F_STARS + F_STARS +
          2 * (2 * static_cast<size_t>(F_TILE) * P + 2 * F_TILE) +
          2 * F_TW * F_STARS) * sizeof(float);
}

struct MmFwdArgs {
  const float *obs, *iv, *log_norm, *lo, *hi, *logw, *mask;
  float *out, *part;  // part: [2, chunks, C, S] partial (max, sum)
  int C, S, T, B, chunks, per;
};

__global__ void __launch_bounds__(F_THREADS, F_MINB)
marglik_mm_fwd_kernel(const MmFwdArgs a) {
  extern __shared__ __align__(16) float sh[];
  const int S = a.S, T = a.T, B = a.B, P = odd_pitch(B);
  float* s_iv = sh;                            // [B, F_STARS] star-minor
  float* s_ivo = s_iv + B * F_STARS;           // [B, F_STARS]
  float* s_o = s_ivo + B * F_STARS;            // [B, F_STARS] obs
  float* s_c0 = s_o + B * F_STARS;             // [F_STARS]
  float* s_stage = s_c0 + F_STARS;             // 2 x (lo, hi, logw, mask)
  const int stage_floats = 2 * F_TILE * P + 2 * F_TILE;
  float* s_pm = s_stage + 2 * stage_floats;    // [F_TW, F_STARS]
  float* s_pa = s_pm + F_TW * F_STARS;         // [F_TW, F_STARS]
  const int c = blockIdx.y;
  const int nst = (S + F_STARS - 1) / F_STARS;
  const int chunk = blockIdx.x / nst;
  const int s0 = (blockIdx.x - chunk * nst) * F_STARS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sw = warp / F_TW;                  // star warp: stars 4 sw ..
  const int tw = warp % F_TW;                  // segment warp
  const int t_begin = chunk * a.per * F_TILE;
  const int t_end = min(T, t_begin + a.per * F_TILE);
  const int ntiles = max(0, (t_end - t_begin + F_TILE - 1) / F_TILE);
  const size_t tb0 = static_cast<size_t>(c) * T;

  auto issue = [&](int it) {
    float* st = s_stage + (it & 1) * stage_floats;
    const int t0 = t_begin + it * F_TILE;
    const int nt = min(F_TILE, t_end - t0);
    stage_rows(st, P, a.lo + (tb0 + t0) * B, nt, F_TILE, B);
    stage_rows(st + F_TILE * P, P, a.hi + (tb0 + t0) * B, nt, F_TILE, B);
    stage_vec(st + 2 * F_TILE * P, a.logw + tb0 + t0, nt, F_TILE);
    stage_vec(st + 2 * F_TILE * P + F_TILE, a.mask + tb0 + t0, nt, F_TILE);
  };
  if (ntiles > 0) issue(0);
  cp_async_commit();

  // The star tile: iv, iv obs and obs star-minor (zeros past the last
  // star), then c0 = sum_b (iv obs) obs, an FMA a band in band order.
  for (int i = threadIdx.x; i < F_STARS * B; i += F_THREADS) {
    const int s = i / B;
    const int b = i - s * B;
    const size_t k = static_cast<size_t>(s0) * B + i;
    const float w = s0 + s < S ? a.iv[k] : 0.0f;
    const float o = s0 + s < S ? a.obs[k] : 0.0f;
    s_iv[b * F_STARS + s] = w;
    s_ivo[b * F_STARS + s] = w * o;
    s_o[b * F_STARS + s] = o;
  }
  __syncthreads();
  if (threadIdx.x < F_STARS) {
    float c0 = 0.0f;
    for (int b = 0; b < B; ++b) {
      const int k = b * F_STARS + threadIdx.x;
      c0 = fmaf(s_ivo[k], s_o[k], c0);
    }
    s_c0[threadIdx.x] = c0;
  }

  float m[F_SPT], acc[F_SPT];
#pragma unroll
  for (int k = 0; k < F_SPT; ++k) {
    m[k] = NEG_INF;
    acc[k] = 0.0f;
  }
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (the next may be in flight)
    __syncthreads();     // ... and everyone's, and the star tile
    const float* s_lo = s_stage + (it & 1) * stage_floats;
    const float* s_hi = s_lo + F_TILE * P;
    const float* s_lw = s_hi + F_TILE * P;
    const float* s_mk = s_lw + F_TILE;
    Abg x[F_SPT][F_TPT] = {};
#pragma unroll 4
    for (int b = 0; b < B; ++b) {
      float w[F_SPT], v[F_SPT];
#pragma unroll
      for (int q = 0; q < F_SPT / 4; ++q) {
        const int i = sw * (F_SPT / 4) + q;
        const float4 w4 =
            reinterpret_cast<const float4*>(s_iv + b * F_STARS)[i];
        const float4 v4 =
            reinterpret_cast<const float4*>(s_ivo + b * F_STARS)[i];
        w[4 * q] = w4.x, w[4 * q + 1] = w4.y, w[4 * q + 2] = w4.z;
        w[4 * q + 3] = w4.w;
        v[4 * q] = v4.x, v[4 * q + 1] = v4.y, v[4 * q + 2] = v4.z;
        v[4 * q + 3] = v4.w;
      }
#pragma unroll
      for (int j = 0; j < F_TPT; ++j) {
        const int tt = tw * 32 * F_TPT + lane + 32 * j;
        const float l = s_lo[tt * P + b];
        const float d = s_hi[tt * P + b] - l;
        const float dd = d * d, ld = l * d, ll = l * l;
#pragma unroll
        for (int k = 0; k < F_SPT; ++k)
          add_band(x[k][j], w[k], v[k], l, d, dd, ld, ll);
      }
    }
    // Per element the online (max, sum), without branches: a masked
    // segment (or one past T) leaves it as it is.
#pragma unroll
    for (int j = 0; j < F_TPT; ++j) {
      const int tt = tw * 32 * F_TPT + lane + 32 * j;
      const bool live = s_mk[tt] > 0.5f;
#pragma unroll
      for (int k = 0; k < F_SPT; ++k) {
        const Segment g = expanded_core_width(
            x[k][j], s_c0[sw * F_SPT + k], s_lw[tt]);
        const bool up = g.core > m[k];
        const float e = expf(up ? m[k] - g.core : g.core - m[k]);
        const float grown = up ? fmaf(acc[k], e, g.width)
                               : fmaf(e, g.width, acc[k]);
        acc[k] = live ? grown : acc[k];
        m[k] = live && up ? g.core : m[k];
      }
    }
    __syncthreads();  // the buffer is refilled two tiles on
  }
  // Lanes by the fixed xor tree, then the segment warps in order.
#pragma unroll
  for (int k = 0; k < F_SPT; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(FULL_MASK, m[k], off);
      const float a2 = __shfl_xor_sync(FULL_MASK, acc[k], off);
      merge(m[k], acc[k], m2, a2);
    }
    if (lane == 0) {
      s_pm[tw * F_STARS + sw * F_SPT + k] = m[k];
      s_pa[tw * F_STARS + sw * F_SPT + k] = acc[k];
    }
  }
  __syncthreads();
  const int s = s0 + threadIdx.x;
  if (threadIdx.x >= F_STARS || s >= S) return;
  float mm = s_pm[threadIdx.x], aa = s_pa[threadIdx.x];
#pragma unroll
  for (int w = 1; w < F_TW; ++w)
    merge(mm, aa, s_pm[w * F_STARS + threadIdx.x],
          s_pa[w * F_STARS + threadIdx.x]);
  const size_t k = static_cast<size_t>(c) * S + s;
  if (a.chunks == 1) {
    const float v = aa > 0.0f ? mm + logf(aa + 1e-15f) : NEG_INF;
    a.out[k] = v + a.log_norm[s];
  } else {
    const size_t cs = static_cast<size_t>(a.C) * S;
    a.part[chunk * cs + k] = mm;
    a.part[(a.chunks + chunk) * cs + k] = aa;
  }
}

// The chunks' partial (max, sum) of each (chain, star), merged in chunk
// order.
__global__ void marglik_mm_merge_kernel(const float* __restrict__ part,
                                        const float* __restrict__ log_norm,
                                        float* __restrict__ out, int C, int S,
                                        int chunks) {
  const size_t cs = static_cast<size_t>(C) * S;
  const size_t k = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= cs) return;
  float m = part[k], acc = part[chunks * cs + k];
  for (int i = 1; i < chunks; ++i)
    merge(m, acc, part[i * cs + k], part[(chunks + i) * cs + k]);
  const float v = acc > 0.0f ? m + logf(acc + 1e-15f) : NEG_INF;
  out[k] = v + log_norm[k % S];
}

// ---- Kernel 4m -------------------------------------------------------------

constexpr int G_WARPS = 8;
constexpr int G_THREADS = G_WARPS * 32;
constexpr int G_ST = 64;     // stars a staged tile (two warps apply the rule)
constexpr int G_LP = 33;     // pitch of the group's band-major lo and d
constexpr int G_GP = 34;     // pitch of a cotangent row (float2 aligned)
constexpr int G_MP = 41;     // pitch of a thread's 40 partial products
constexpr int G_NACC = 40;   // 4 bands x 2 segments x 5 products
// Kernel 4's skip threshold and log-width margin (ops/marglik.py).
constexpr float SKIP_BELOW = -105.0f;
constexpr float SKIP_LOG_WIDTH = 16.0f;

__host__ __device__ __forceinline__ int up4(int n) { return (n + 3) & ~3; }

__host__ __device__ __forceinline__ int quad_pitch(int B) { return up4(B); }

// ops/marglik.py `_zero_weight` with a slack of rel * scale, operation for
// operation.  A NaN bound compares false.
__device__ __forceinline__ bool zero_weight(float chi2, float logw, float outp,
                                            float scale, float rel) {
  const float slack = __fmul_rn(rel, scale);
  const float bound = __fadd_rn(
      __fadd_rn(__fsub_rn(__fadd_rn(-0.5f * chi2, logw), outp),
                SKIP_LOG_WIDTH),
      slack);
  return bound < SKIP_BELOW;
}

struct MmBwdArgs {
  const float *obs, *iv, *log_norm, *lo, *hi, *logw, *mask, *out, *gout;
  float *dlo, *dhi, *dlogw;
  int S, T, B;
  float rel;  // the rule's slack factor (marglik_mm_bwd_group_skip)
};

// Shared memory (floats) of kernel 4m, at 16-byte offsets: the group's lo,
// d and hi [B, 33] and band ranges; then a region that holds, in the star
// loop, the star tiles (two raw buffers: obs, iv [G_ST, P], out, log_norm,
// g [G_ST]), the tile's c0, the kept stars packed (iv, iv obs [G_ST, Q];
// c0, out', g) and their cotangent rows [G_ST, 34] x 3, and after it the
// threads' partial products [G_THREADS, 41]; then the dlogw partials and
// the rows' non-zero flags.
struct BwdLayout {
  int P, Q, raw;  // raw star row pitch, packed row pitch, a raw buffer
  int l, d, h, mn, mx, L, W, misc, stars, c0, kw, kv, kc0, koutp, kg, krow, ga,
      gb, gc, alw, nz, total;
  __host__ __device__ explicit BwdLayout(int B) {
    P = odd_pitch(B);
    Q = quad_pitch(B);
    raw = up4(2 * G_ST * P + 3 * G_ST);
    l = 0;
    d = up4(l + B * G_LP);
    h = up4(d + B * G_LP);
    mn = up4(h + B * G_LP);
    mx = mn + up4(B);
    L = mx + up4(B);
    W = L + up4(B);
    misc = W + up4(B);                        // mlw, the two keep masks
    stars = misc + 4;
    c0 = stars + 2 * raw;
    kw = c0 + G_ST;
    kv = kw + G_ST * Q;
    kc0 = kv + G_ST * Q;
    koutp = kc0 + G_ST;
    kg = koutp + G_ST;
    krow = kg + G_ST;
    ga = krow + G_ST;
    gb = ga + G_ST * G_GP;
    gc = gb + G_ST * G_GP;
    const int loop_end = gc + G_ST * G_GP;
    const int merge_end = stars + G_THREADS * G_MP;
    alw = up4(loop_end > merge_end ? loop_end : merge_end);
    nz = alw + G_WARPS * 32;
    total = nz + G_ST;
  }
};

size_t bwd_smem(int B) {
  return static_cast<size_t>(BwdLayout(B).total) * sizeof(float);
}

// ops/marglik.py `marglik_mm_bwd_group_skip` for one (group, star), from
// the group's band ranges and largest live logw: its float32 operations in
// band order, without FMA contraction.  Also c0 = sum_b (iv obs) obs, an
// FMA a band, for the contraction of a kept star.
__device__ __forceinline__ bool skip_group(const float* o, const float* w,
                                           const float* mn, const float* mx,
                                           const float* L, const float* W,
                                           int B, float mlw, float outp,
                                           float rel, float* c0) {
  float lb = 0.0f, e = 0.0f, cc = 0.0f;
  for (int b = 0; b < B; ++b) {
    const float ob = o[b], wb = w[b];
    const float dist =
        fmaxf(fmaxf(__fsub_rn(mn[b], ob), __fsub_rn(ob, mx[b])), 0.0f);
    const float span = __fadd_rn(__fadd_rn(fabsf(ob), L[b]), W[b]);
    lb = __fadd_rn(lb, __fmul_rn(__fmul_rn(wb, dist), dist));
    e = __fadd_rn(e, __fmul_rn(__fmul_rn(wb, span), span));
    cc = fmaf(wb * ob, ob, cc);
  }
  *c0 = cc;
  return zero_weight(lb, mlw, outp, e, rel);
}

// MB: the band class (common.cuh).  Three blocks an SM for the narrow
// class (85 registers a thread), two for the wide one, whose larger star
// and band tiles would not fit three in shared memory.
template <int MB>
__global__ void __launch_bounds__(G_THREADS, MB <= btt::NARROW_B ? 3 : 2)
marglik_mm_bwd_kernel(const MmBwdArgs a) {
  extern __shared__ __align__(16) float sh[];
  const int S = a.S, T = a.T, B = a.B;
  const BwdLayout lay(B);
  const int P = lay.P, Q = lay.Q;
  float* s_l = sh + lay.l;        // [B, 33] the group's lo
  float* s_d = sh + lay.d;        // [B, 33] and hi - lo
  float* s_mn = sh + lay.mn;      // [B] the group's band ranges
  float* s_mx = sh + lay.mx;
  float* s_L = sh + lay.L;        // [B] max(|mn|, |mx|)
  float* s_W = sh + lay.W;        // [B] mx - mn
  float* s_mlw = sh + lay.misc;   // the group's largest live logw
  unsigned* s_keep = reinterpret_cast<unsigned*>(sh + lay.misc + 1);  // [2]
  float* s_c0 = sh + lay.c0;      // [G_ST] c0 of the tile's stars
  float* s_kw = sh + lay.kw;      // [G_ST, Q] kept stars: iv
  float* s_kv = sh + lay.kv;      // [G_ST, Q] iv obs
  float* s_kc0 = sh + lay.kc0;
  float* s_koutp = sh + lay.koutp;
  float* s_kg = sh + lay.kg;
  int* s_krow = reinterpret_cast<int*>(sh + lay.krow);  // [G_ST] their rows
  float* s_ga = sh + lay.ga;      // [G_ST, 34] cotangents of kept stars
  float* s_gb = sh + lay.gb;
  float* s_gc = sh + lay.gc;
  float* s_alw = sh + lay.alw;    // [G_WARPS, 32] dlogw partials
  int* s_nz = reinterpret_cast<int*>(sh + lay.nz);      // [G_ST]
  float* s_mrg = sh + lay.stars;  // [G_THREADS, 41], after the star loop
  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * 32;
  const int nt = min(32, T - t0);
  const size_t tc = static_cast<size_t>(c) * T + t0;
  const bool live_seg = lane < nt && a.mask[tc + lane] > 0.5f;
  const float lw = lane < nt ? a.logw[tc + lane] : 0.0f;
  const size_t cS = static_cast<size_t>(c) * S;

  // Star tile it's raw obs, iv [G_ST, P] and out, log_norm, g [G_ST].
  auto issue = [&](int it) {
    float* st = sh + lay.stars + (it & 1) * lay.raw;
    const int s0 = it * G_ST;
    const int ns = min(G_ST, S - s0);
    stage_rows(st, P, a.obs + static_cast<size_t>(s0) * B, ns, G_ST, B);
    stage_rows(st + G_ST * P, P, a.iv + static_cast<size_t>(s0) * B, ns,
               G_ST, B);
    float* sv = st + 2 * G_ST * P;
    stage_vec(sv, a.out + cS + s0, ns, G_ST);
    stage_vec(sv + G_ST, a.log_norm + s0, ns, G_ST);
    stage_vec(sv + 2 * G_ST, a.gout + cS + s0, ns, G_ST);
  };
  // Masked segments get exactly 0; a block with none live stages no star.
  const bool any_live = __syncthreads_or(live_seg);
  const int ntiles = any_live ? (S + G_ST - 1) / G_ST : 0;
  if (ntiles > 0) issue(0);
  cp_async_commit();

  // The group: lo and d band-major, and per band the range of its live
  // segments' lo and hi.
  float* s_h = sh + lay.h;                  // [B, 33] the group's hi
  for (int i = threadIdx.x; i < 32 * B; i += G_THREADS) {
    const int tt = i / B;
    const int b = i - tt * B;
    const float l = tt < nt ? a.lo[tc * B + i] : 0.0f;
    const float h = tt < nt ? a.hi[tc * B + i] : 0.0f;
    s_l[b * G_LP + tt] = l;
    s_d[b * G_LP + tt] = h - l;
    s_h[b * G_LP + tt] = h;
  }
  __syncthreads();
  for (int b = warp; b < B; b += G_WARPS) {
    const float l = s_l[b * G_LP + lane], h = s_h[b * G_LP + lane];
    float vmin = live_seg ? fminf(l, h) : INFINITY;
    float vmax = live_seg ? fmaxf(l, h) : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      vmin = fminf(vmin, __shfl_xor_sync(FULL_MASK, vmin, off));
      vmax = fmaxf(vmax, __shfl_xor_sync(FULL_MASK, vmax, off));
    }
    if (lane == 0) {
      s_mn[b] = vmin;
      s_mx[b] = vmax;
      s_L[b] = fmaxf(fabsf(vmin), fabsf(vmax));
      s_W[b] = __fsub_rn(vmax, vmin);
    }
  }
  if (warp == G_WARPS - 1) {
    float v = live_seg ? lw : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, off));
    if (lane == 0) s_mlw[0] = v;
  }

  // The products' tiling: thread (part r, tile tau) owns bands 4q .. 4q + 3
  // and segments 2p, 2p + 1, and sums the rows r, r + R, ... of each tile.
  const int tiles = quad_pitch(B) / 4 * 16;
  const int R = G_THREADS / tiles;
  const int tau = threadIdx.x % tiles;
  const int r = threadIdx.x / tiles;
  const int q = tau >> 4;
  const int p = tau & 15;
  float acc[G_NACC];
#pragma unroll
  for (int i = 0; i < G_NACC; ++i) acc[i] = 0.0f;
  float a_lw = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile (and, first, the group) in shared memory
    const float* st = sh + lay.stars + (it & 1) * lay.raw;
    const float* r_o = st;
    const float* r_w = st + G_ST * P;
    const float* r_out = st + 2 * G_ST * P;
    const float* r_ln = r_out + G_ST;
    const float* r_g = r_ln + G_ST;
    const int ns = min(G_ST, S - it * G_ST);
    // The group rule, one star a thread; kept stars packed in star order.
    bool keep = false;
    if (warp < G_ST / 32) {
      const int ss = threadIdx.x;
      if (ss < ns) {
        float c0;
        const float outp = __fsub_rn(r_out[ss], r_ln[ss]);
        keep = !skip_group(r_o + ss * P, r_w + ss * P, s_mn, s_mx, s_L, s_W,
                           B, s_mlw[0], outp, a.rel, &c0);
        s_c0[ss] = c0;
      }
      const unsigned ballot = __ballot_sync(FULL_MASK, keep);
      if (lane == 0) s_keep[warp] = ballot;
    }
    __syncthreads();
    const unsigned k0 = s_keep[0];
    const int nk = __popc(k0) + __popc(s_keep[1]);
    if (keep) {
      const unsigned below = s_keep[warp] & ((1u << lane) - 1u);
      s_krow[(warp ? __popc(k0) : 0) + __popc(below)] = threadIdx.x;
    }
    __syncthreads();
    // Pack the kept stars: iv, iv obs [nk, Q] (zeros past B), c0, out', g.
    for (int k = warp; k < nk; k += G_WARPS) {
      const int row = s_krow[k];
      for (int b = lane; b < Q; b += 32) {
        const float w = b < B ? r_w[row * P + b] : 0.0f;
        const float o = b < B ? r_o[row * P + b] : 0.0f;
        s_kw[k * Q + b] = w;
        s_kv[k * Q + b] = w * o;
      }
      if (lane == 0) {
        s_kc0[k] = s_c0[row];
        s_koutp[k] = __fsub_rn(r_out[row], r_ln[row]);
        s_kg[k] = r_g[row];
      }
    }
    __syncthreads();
    // A kept star a warp against the group's 32 segments: the expanded
    // contraction, the softmax weight and the cotangents.
    for (int k = warp; k < nk; k += G_WARPS) {
      Abg x = {};
      for (int b = 0; b < B; ++b) {
        const float w = s_kw[k * Q + b];
        const float v = s_kv[k * Q + b];
        const float l = s_l[b * G_LP + lane];
        const float d = s_d[b * G_LP + lane];
        add_band(x, w, v, l, d, d * d, l * d, l * l);
      }
      float ga = 0.0f, gb = 0.0f, gc = 0.0f, gw = 0.0f;
      if (live_seg) {
        const Segment g = expanded_core_width(x, s_kc0[k], lw);
        // exp(core - out') * width = term / sum: the softmax weight.
        gw = s_kg[k] * expf(g.core - s_koutp[k]) * g.width;
        float t1, t2;
        moments(g, &t1, &t2);
        ga = gw * (-0.5f) * t2;
        gb = gw * t1;
        gc = gw * (-0.5f);
      }
      s_ga[k * G_GP + lane] = ga;
      s_gb[k * G_GP + lane] = gb;
      s_gc[k * G_GP + lane] = gc;
      a_lw += gw;
      const bool nz = __any_sync(FULL_MASK, gw != 0.0f);
      if (lane == 0) s_nz[k] = nz;
    }
    __syncthreads();
    // The star-axis products over the rows with a non-zero weight.
    if (r < R) {
      for (int k = r; k < nk; k += R) {
        if (!s_nz[k]) continue;  // every weight 0.0: adds exactly nothing
        const float4 w4 =
            *reinterpret_cast<const float4*>(s_kw + k * Q + 4 * q);
        const float4 v4 =
            *reinterpret_cast<const float4*>(s_kv + k * Q + 4 * q);
        const int g = k * G_GP + 2 * p;
        const float2 ga2 = *reinterpret_cast<const float2*>(s_ga + g);
        const float2 gb2 = *reinterpret_cast<const float2*>(s_gb + g);
        const float2 gc2 = *reinterpret_cast<const float2*>(s_gc + g);
        const float w[4] = {w4.x, w4.y, w4.z, w4.w};
        const float v[4] = {v4.x, v4.y, v4.z, v4.w};
        const float fa[2] = {ga2.x, ga2.y};
        const float fb[2] = {gb2.x, gb2.y};
        const float fc[2] = {gc2.x, gc2.y};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int e = (i * 2 + j) * 5;
            acc[e] = fmaf(w[i], fa[j], acc[e]);          // A1
            acc[e + 1] = fmaf(w[i], fb[j], acc[e + 1]);  // B1
            acc[e + 2] = fmaf(v[i], fb[j], acc[e + 2]);  // B2
            acc[e + 3] = fmaf(w[i], fc[j], acc[e + 3]);  // C1
            acc[e + 4] = fmaf(v[i], fc[j], acc[e + 4]);  // C2
          }
        }
      }
    }
    __syncthreads();  // the packed rows and the raw buffer are refilled
  }
  cp_async_wait<0>();
  __syncthreads();

  // The parts' products, summed in part order, then dlo and dhi.
#pragma unroll
  for (int i = 0; i < G_NACC; ++i) s_mrg[threadIdx.x * G_MP + i] = acc[i];
  s_alw[warp * 32 + lane] = a_lw;
  __syncthreads();
  const size_t row0 = tc * B;
  for (int o = threadIdx.x; o < nt * B; o += G_THREADS) {
    const int tt = o / B;
    const int b = o - tt * B;
    const int e = ((b & 3) * 2 + (tt & 1)) * 5;
    const int t_of = (b >> 2) * 16 + (tt >> 1);
    float A1 = 0.0f, B1 = 0.0f, B2 = 0.0f, C1 = 0.0f, C2 = 0.0f;
    for (int rr = 0; rr < R; ++rr) {
      const float* src = s_mrg + (rr * tiles + t_of) * G_MP + e;
      A1 += src[0];
      B1 += src[1];
      B2 += src[2];
      C1 += src[3];
      C2 += src[4];
    }
    const float l = s_l[b * G_LP + tt], d = s_d[b * G_LP + tt];
    a.dhi[row0 + o] = 2.0f * d * A1 + (B2 - l * B1);
    a.dlo[row0 + o] =
        -2.0f * d * A1 - (d * B1 + B2 - l * B1) - 2.0f * (C2 - l * C1);
  }
  if (threadIdx.x < nt) {  // the warps' dlogw partials in warp order
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < G_WARPS; ++k) v += s_alw[k * 32 + threadIdx.x];
    a.dlogw[tc + threadIdx.x] = v;
  }
}

}  // namespace

// Floats of scratch kernel 3m needs for C chains, S stars, T segments: the
// chunks' partial (max, sum), none where one chunk covers the segments.
extern "C" long long btt_marglik_mm_fwd_scratch(int C, int S, int T) {
  const FwdPlan pl = fwd_plan(C, S, T);
  return pl.chunks > 1 ? 2LL * pl.chunks * C * S : 0;
}

// Kernel 3m: one launch of the main kernel and, where the segments span
// more than one chunk, a second that merges the chunks (one call of the
// wrapper).
extern "C" int btt_marglik_mm_fwd(const float* obs, const float* iv,
                                  const float* log_norm, const float* lo,
                                  const float* hi, const float* logw,
                                  const float* mask, float* out, float* part,
                                  int C, int S, int T, int B, int device,
                                  void* stream) {
  cudaSetDevice(device);
  if (B < 1 || B > btt::MAX_B) return static_cast<int>(cudaErrorInvalidValue);
  const FwdPlan pl = fwd_plan(C, S, T);
  const MmFwdArgs a{obs, iv, log_norm, lo, hi, logw, mask, out, part,
                    C, S, T, B, pl.chunks, pl.per};
  const size_t smem = fwd_smem(B);
  int err = btt::allow_smem(marglik_mm_fwd_kernel, smem);
  if (err != 0) return err;
  const auto st = static_cast<cudaStream_t>(stream);
  const int nst = (S + F_STARS - 1) / F_STARS;
  const dim3 grid(nst * pl.chunks, C);
  marglik_mm_fwd_kernel<<<grid, F_THREADS, smem, st>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || pl.chunks == 1) return err;
  const long long cs = static_cast<long long>(C) * S;
  marglik_mm_merge_kernel<<<static_cast<unsigned>((cs + 255) / 256), 256, 0,
                            st>>>(part, log_norm, out, C, S, pl.chunks);
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
  // ops/marglik.py: _SKIP_REL + (B + _MM_SKIP_ULPS) * 2^-24, in double,
  // then to float32 as torch takes a Python float.
  const float rel =
      static_cast<float>(1e-5 + (B + 8) * 5.9604644775390625e-08);
  const MmBwdArgs a{obs, iv, log_norm, lo, hi, logw, mask, out, gout,
                    dlo, dhi, dlogw, S, T, B, rel};
  const size_t smem = bwd_smem(B);
  const dim3 grid((T + 31) / 32, C);
  const auto st = static_cast<cudaStream_t>(stream);
  int err;
  if (B <= btt::NARROW_B) {
    err = btt::allow_smem(marglik_mm_bwd_kernel<btt::NARROW_B>, smem);
    if (err != 0) return err;
    marglik_mm_bwd_kernel<btt::NARROW_B><<<grid, G_THREADS, smem, st>>>(a);
  } else {
    err = btt::allow_smem(marglik_mm_bwd_kernel<btt::MAX_B>, smem);
    if (err != 0) return err;
    marglik_mm_bwd_kernel<btt::MAX_B><<<grid, G_THREADS, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());  // launch status
}
