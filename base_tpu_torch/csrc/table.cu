// Combined-magnitude node table: kernels 1 (forward) and 2 (backward).
//
// Replaces base_tpu/ops/pallas_table.py `_fwd_kernel` (launched from `_fwd`)
// and `_bwd_kernel` (launched from `_bwd_rule`).  For every chain c and node
// n = (EEP e, mass ratio q):
//   W[e2, n] = smoothstep hat weight of m2[n] on the base mass axis
//   mags2    = secT @ W                       (secondary apparent mags)
//   comb     = -1/(0.4 ln10) log(10^(-0.4 app1) + lit 10^(-0.4 mags2))
// The backward carries the cotangent through the flux combine and the
// smoothstep weights into m2, lit, app1, secT and the four base-axis vectors.
//
// What bounds it on the H100: at the bench shapes (C = 64, B = 8, N = 512,
// E2 = 64) each kernel moves ~2-4 MB and, counting only the non-zero
// weights, does a few MFLOP, so the bound is HBM bandwidth at ~1 us; what
// holds them back is latency and how many SMs they fill.
//
// Sparse weights, in both kernels.  A node's weight on axis entry e and
// the factors 6u(1-u) that carry the axis gradients are exactly zero unless
// the node lies in the entry's support.  The rule is ops/table.py
// `hat_zero_bounds` and `hat_window` (held to the dense weights on config-1
// and adversarial axes by tests/test_torch_kernels_plain.py): per entry,
// bounds lz < rz outside which every term is an exact 0.0 in float32 --
// found by `probe`, the same float32 operations as the Python rule -- made
// monotone by a suffix minimum / prefix maximum, so a node's entries are the
// one run lo..hi found by two binary searches.  On config-1 axes that run is
// at most 3 of 64 entries.  Skipped terms are exact zeros, so the per-node
// outputs equal the dense loop's, e in order.  Each block stages the
// chain's table and axis and computes the bounds once.
//
// Kernel 1, redesigned for Hopper: `stage_windows`, then one thread per
// node over its window (`window_mags`) and the flux combine; grid (node
// tiles of FWD_NODES, chains), 128 blocks at config-1 and 512 at upsample
// 4, one wave.  With the dense E2 loop gone, the block's prologue (staging,
// probes, scans) and launch latency set its time.  (Kernel 2's node pass
// does the same steps written out in its body: calling these two helpers
// there made it half again as slow on the H100, PERF.md.)
//
// Kernel 2, redesigned for Hopper, two launches behind one entry point:
// - More than C blocks.  Pass 1 runs on a grid (node tiles of BWD_NODES,
//   chains): one thread per node computes dapp1, dlit, dm2 and keeps d mags2,
//   q and its window in shared memory; then the block sums its nodes'
//   contributions to dsecT [B, E2] and the four axis vectors, each (axis
//   entry, node group) in node order, the groups in order, into one partial
//   per tile (scratch from the wrapper).  Pass 2 (one block per chain) sums
//   the tiles' partials in tile order.  No float atomics, so same-seed runs
//   are bit-identical.
//
// Bands: the per-thread arrays (mags2, d mags2, the node sums) are sized by
// a band class (common.cuh), one instance of each kernel for B <= 16 and
// one for 17..32, picked at launch.  A launch whose shared memory passes 48
// KB asks for it first (`allow_smem`), up to Hopper's 227 KB a block;
// ops/table.py refuses a shape past that.
#include "common.cuh"

namespace {

constexpr float LN10_04 = 0.9210340371976184f;
constexpr float INV_LN10_04 = 1.0857362047581294f;
constexpr int FWD_NODES = 256;   // nodes (threads) per kernel-1 block
constexpr int BWD_NODES = 128;   // nodes (threads) per kernel-2 pass-1 block
constexpr int AXIS_THREADS = 256;

__device__ __forceinline__ float smoothstep(float u) {
  return u * u * (3.0f - 2.0f * u);
}

// Stage the chain's secondary table [B, E2] and base axis [E2] x 4.
__device__ void stage_axis(float* sh, const float* secT, const float* xl,
                           const float* idl, const float* xr,
                           const float* idr, int c, int B, int E2) {
  const size_t sec0 = static_cast<size_t>(c) * B * E2;
  const size_t ax0 = static_cast<size_t>(c) * E2;
  for (int i = threadIdx.x; i < B * E2; i += blockDim.x) sh[i] = secT[sec0 + i];
  float* s_ax = sh + B * E2;
  for (int i = threadIdx.x; i < E2; i += blockDim.x) {
    s_ax[i] = xl[ax0 + i];
    s_ax[E2 + i] = idl[ax0 + i];
    s_ax[2 * E2 + i] = xr[ax0 + i];
    s_ax[3 * E2 + i] = idr[ax0 + i];
  }
}

// The window rule of ops/table.py: probe steps and first-step scale 2^-23.
constexpr int PROBE_STEPS = 64;
constexpr float PROBE_SCALE = 1.1920928955078125e-7f;
constexpr unsigned FULL_MASK = 0xffffffffu;

// ops/table.py `_probe`: from the entry's left edge xl (kLeft) step down
// until dn = (xr - c) idr >= 1, or from xr step up until up = (c - xl) idl
// >= 1, doubling the step; -inf / +inf when PROBE_STEPS steps do not do.
template <bool kLeft>
__device__ float probe(float xl, float idl, float xr, float idr) {
  float c = kLeft ? xl : xr;
  if ((kLeft ? (xr - c) * idr : (c - xl) * idl) >= 1.0f) return c;
  float d = (fabsf(c) + 1.0f / (kLeft ? idr : idl)) * PROBE_SCALE;
#pragma unroll 1
  for (int k = 0; k < PROBE_STEPS; ++k) {
    c = kLeft ? c - d : c + d;
    d = d + d;
    if ((kLeft ? (xr - c) * idr : (c - xl) * idl) >= 1.0f) return c;
  }
  return kLeft ? -INFINITY : INFINITY;
}

// lz becomes its suffix minimum (warp 0), rz its prefix maximum (warp 1).
__device__ void monotone_bounds(float* lz, float* rz, int E2) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == 0) {
    float carry = INFINITY;
    for (int base = E2 - 1; base >= 0; base -= 32) {
      const int i = base - lane;
      float v = i >= 0 ? lz[i] : INFINITY;
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(FULL_MASK, v, off);
        if (lane >= off) v = fminf(v, o);
      }
      v = fminf(v, carry);
      if (i >= 0) lz[i] = v;
      carry = __shfl_sync(FULL_MASK, v, 31);
    }
  } else if (warp == 1) {
    float carry = -INFINITY;
    for (int base = 0; base < E2; base += 32) {
      const int i = base + lane;
      float v = i < E2 ? rz[i] : -INFINITY;
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(FULL_MASK, v, off);
        if (lane >= off) v = fmaxf(v, o);
      }
      v = fmaxf(v, carry);
      if (i < E2) rz[i] = v;
      carry = __shfl_sync(FULL_MASK, v, 31);
    }
  }
}

// Number of entries of the non-decreasing a[0:n] below q (or <= q).
template <bool kOrEqual>
__device__ __forceinline__ int count_below(const float* a, int n, float q) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (kOrEqual ? a[mid] <= q : a[mid] < q) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void hat(float q, float xl, float idl, float xr,
                                    float idr, float* up, float* dn) {
  *up = btt::clamp01((q - xl) * idl);
  *dn = btt::clamp01((xr - q) * idr);
}

// Stage the chain's table and axis (stage_axis), then the window bounds lz,
// rz [E2] behind them: `probe` per entry, made monotone.  Shared layout
// [secT B*E2 | xl, idl, xr, idr | lz | rz], (B + 6) * E2 floats.  Needs at
// least 64 threads (monotone_bounds).
__device__ void stage_windows(float* sh, const float* secT, const float* xl,
                              const float* idl, const float* xr,
                              const float* idr, int c, int B, int E2) {
  stage_axis(sh, secT, xl, idl, xr, idr, c, B, E2);
  const float* s_xl = sh + B * E2;
  const float* s_idl = s_xl + E2;
  const float* s_xr = s_xl + 2 * E2;
  const float* s_idr = s_xl + 3 * E2;
  float* s_lz = sh + (B + 4) * E2;
  float* s_rz = s_lz + E2;
  __syncthreads();
  for (int e = threadIdx.x; e < E2; e += blockDim.x) {
    const bool ok = s_idl[e] > 0.0f && s_idr[e] > 0.0f;
    s_lz[e] = ok ? probe<true>(s_xl[e], s_idl[e], s_xr[e], s_idr[e])
                 : -INFINITY;
    s_rz[e] = ok ? probe<false>(s_xl[e], s_idl[e], s_xr[e], s_idr[e])
                 : INFINITY;
  }
  __syncthreads();
  monotone_bounds(s_lz, s_rz, E2);
  __syncthreads();
}

size_t window_smem(int B, int E2) {
  return static_cast<size_t>(B + 6) * E2 * sizeof(float);
}

// The node's window lo..hi (ops/table.py `hat_window`: two binary searches;
// a NaN query takes the whole axis) and mags2[b] = sum_e secT[b, e] W[e](q)
// over it, e in order.  Entries outside it add s_sec * 0.0, so mags2 is the
// dense loop's to the bit.  MB is the band class (common.cuh).
template <int MB>
__device__ __forceinline__ void window_mags(const float* sh, float q, int B,
                                            int E2, float (&mags2)[MB]) {
  const float* s_xl = sh + B * E2;
  const float* s_idl = s_xl + E2;
  const float* s_xr = s_xl + 2 * E2;
  const float* s_idr = s_xl + 3 * E2;
  const float* s_lz = sh + (B + 4) * E2;
  const float* s_rz = s_lz + E2;
  const int lo = isnan(q) ? 0 : count_below<true>(s_rz, E2, q);
  const int hi = isnan(q) ? E2 - 1 : count_below<false>(s_lz, E2, q) - 1;
#pragma unroll
  for (int b = 0; b < MB; ++b) mags2[b] = 0.0f;
  for (int e = lo; e <= hi; ++e) {
    float up, dn;
    hat(q, s_xl[e], s_idl[e], s_xr[e], s_idr[e], &up, &dn);
    const float w = smoothstep(up) + smoothstep(dn) - 1.0f;
#pragma unroll
    for (int b = 0; b < MB; ++b)
      if (b < B) mags2[b] += sh[b * E2 + e] * w;
  }
}

// --- Kernel 1 -------------------------------------------------------------

// MB: the band class, NARROW_B or MAX_B (one instance each).
template <int MB>
__global__ void table_fwd_kernel(const float* __restrict__ app1,
                                 const float* __restrict__ m2,
                                 const float* __restrict__ lit,
                                 const float* __restrict__ secT,
                                 const float* __restrict__ xl,
                                 const float* __restrict__ idl,
                                 const float* __restrict__ xr,
                                 const float* __restrict__ idr,
                                 float* __restrict__ out, int B, int N,
                                 int E2) {
  extern __shared__ float sh[];
  const int c = blockIdx.y;
  stage_windows(sh, secT, xl, idl, xr, idr, c, B, E2);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t node = static_cast<size_t>(c) * N + n;
  float mags2[MB];
  window_mags<MB>(sh, m2[node], B, E2, mags2);
  const float l = lit[node];
#pragma unroll
  for (int b = 0; b < MB; ++b) {
    if (b < B) {
      const size_t o = (static_cast<size_t>(c) * B + b) * N + n;
      const float f1 = expf(-LN10_04 * app1[o]);
      const float f2 = l * expf(-LN10_04 * mags2[b]);
      out[o] = -INV_LN10_04 * logf(f1 + f2);
    }
  }
}

// --- Kernel 2 -------------------------------------------------------------

// Node groups that share the partial sums of one axis entry in pass 1.
__host__ __device__ __forceinline__ int node_groups(int E2) {
  return E2 < BWD_NODES ? BWD_NODES / E2 : 1;
}

size_t bwd_node_smem(int B, int E2) {
  const int G = node_groups(E2);
  size_t floats = static_cast<size_t>(B + 6) * E2           // table, axis, lz, rz
                  + static_cast<size_t>(B + 2) * BWD_NODES;  // q, d mags2, window
  if (G > 1) floats += static_cast<size_t>(G) * (B + 4) * E2;
  return floats * sizeof(float);
}

template <int MB>
__global__ void table_bwd_node_kernel(
    const float* __restrict__ app1, const float* __restrict__ m2,
    const float* __restrict__ lit, const float* __restrict__ secT,
    const float* __restrict__ xl, const float* __restrict__ idl,
    const float* __restrict__ xr, const float* __restrict__ idr,
    const float* __restrict__ g, float* __restrict__ dapp1,
    float* __restrict__ dm2, float* __restrict__ dlit,
    float* __restrict__ part, int B, int N, int E2) {
  extern __shared__ float sh[];
  const int c = blockIdx.y;
  const int tile = blockIdx.x;
  stage_axis(sh, secT, xl, idl, xr, idr, c, B, E2);
  const float* s_sec = sh;
  const float* s_xl = sh + B * E2;
  const float* s_idl = s_xl + E2;
  const float* s_xr = s_xl + 2 * E2;
  const float* s_idr = s_xl + 3 * E2;
  float* s_lz = sh + (B + 4) * E2;
  float* s_rz = s_lz + E2;
  float* s_q = s_rz + E2;                    // [BWD_NODES]
  float* s_dm = s_q + BWD_NODES;             // [B, BWD_NODES] d mags2
  int* s_win = reinterpret_cast<int*>(s_dm + B * BWD_NODES);  // lo<<16 | hi+1
  float* s_part = reinterpret_cast<float*>(s_win + BWD_NODES);
  __syncthreads();
  for (int e = threadIdx.x; e < E2; e += blockDim.x) {
    const bool ok = s_idl[e] > 0.0f && s_idr[e] > 0.0f;
    s_lz[e] = ok ? probe<true>(s_xl[e], s_idl[e], s_xr[e], s_idr[e])
                 : -INFINITY;
    s_rz[e] = ok ? probe<false>(s_xl[e], s_idl[e], s_xr[e], s_idr[e])
                 : INFINITY;
  }
  __syncthreads();
  monotone_bounds(s_lz, s_rz, E2);
  __syncthreads();

  // Per node: dapp1, dlit, dm2 over the node's window lo..hi, e in order.
  const int t = threadIdx.x;
  const int n = tile * BWD_NODES + t;
  int lo = 1, hi = 0;  // empty window for threads past the last node
  if (n < N) {
    const size_t cN = static_cast<size_t>(c) * N;
    const size_t cBN = static_cast<size_t>(c) * B * N;
    const float q = m2[cN + n];
    lo = isnan(q) ? 0 : count_below<true>(s_rz, E2, q);
    hi = isnan(q) ? E2 - 1 : count_below<false>(s_lz, E2, q) - 1;
    float mags2[MB];
#pragma unroll
    for (int b = 0; b < MB; ++b) mags2[b] = 0.0f;
    for (int e = lo; e <= hi; ++e) {
      float up, dn;
      hat(q, s_xl[e], s_idl[e], s_xr[e], s_idr[e], &up, &dn);
      const float w = smoothstep(up) + smoothstep(dn) - 1.0f;
#pragma unroll
      for (int b = 0; b < MB; ++b)
        if (b < B) mags2[b] += s_sec[b * E2 + e] * w;
    }
    const float l = lit[cN + n];
    float dmv[MB];
    float dl = 0.0f;
#pragma unroll
    for (int b = 0; b < MB; ++b) {
      dmv[b] = 0.0f;
      if (b < B) {
        const size_t o = cBN + static_cast<size_t>(b) * N + n;
        const float f1 = expf(-LN10_04 * app1[o]);
        const float f2m = expf(-LN10_04 * mags2[b]);
        const float F = f1 + l * f2m;
        const float gg = g[o];
        dapp1[o] = gg * f1 / F;
        dmv[b] = gg * l * f2m / F;
        s_dm[b * BWD_NODES + t] = dmv[b];
        dl += gg * (-INV_LN10_04) * f2m / F;
      }
    }
    dlit[cN + n] = dl;
    float dq = 0.0f;
    for (int e = lo; e <= hi; ++e) {
      float up, dn;
      hat(q, s_xl[e], s_idl[e], s_xr[e], s_idr[e], &up, &dn);
      float dW = 0.0f;
#pragma unroll
      for (int b = 0; b < MB; ++b)
        if (b < B) dW += s_sec[b * E2 + e] * dmv[b];
      const float dup = dW * (6.0f * up * (1.0f - up));
      const float ddn = dW * (6.0f * dn * (1.0f - dn));
      dq += dup * s_idl[e] - ddn * s_idr[e];
    }
    dm2[cN + n] = dq;
    s_q[t] = q;
  }
  s_win[t] = (lo << 16) | (hi + 1);  // E2 < 2^15: the wrapper's limit
  __syncthreads();

  // The tile's node sums: item (group, e) walks its group's nodes in order,
  // 64 at a time: a bit mask of the nodes whose window holds e, then only
  // those nodes, lowest first.
  const int G = node_groups(E2);
  const int per = (BWD_NODES + G - 1) / G;
  const int nb = B + 4;
  const int tiles = gridDim.x;
  float* tile_part = part + (static_cast<size_t>(c) * tiles + tile) * nb * E2;
  for (int item = threadIdx.x; item < G * E2; item += blockDim.x) {
    const int grp = item / E2;
    const int e = item - grp * E2;
    const float xl_e = s_xl[e], idl_e = s_idl[e];
    const float xr_e = s_xr[e], idr_e = s_idr[e];
    float acc[MB];
#pragma unroll
    for (int b = 0; b < MB; ++b) acc[b] = 0.0f;
    float a_xl = 0.0f, a_idl = 0.0f, a_xr = 0.0f, a_idr = 0.0f;
    const int t_end = min((grp + 1) * per, BWD_NODES);
    for (int c0 = grp * per; c0 < t_end; c0 += 64) {
      const int cn = min(64, t_end - c0);
      unsigned long long members = 0;
#pragma unroll 8
      for (int k = 0; k < cn; ++k) {
        const int win = s_win[c0 + k];
        if ((win >> 16) <= e && e < (win & 0xffff)) members |= 1ull << k;
      }
      while (members != 0) {
        const int tt = c0 + __ffsll(static_cast<long long>(members)) - 1;
        members &= members - 1;
        const float q = s_q[tt];
        float up, dn;
        hat(q, xl_e, idl_e, xr_e, idr_e, &up, &dn);
        const float w = smoothstep(up) + smoothstep(dn) - 1.0f;
        float dW = 0.0f;
#pragma unroll
        for (int b = 0; b < MB; ++b) {
          if (b < B) {
            const float dmb = s_dm[b * BWD_NODES + tt];
            dW += s_sec[b * E2 + e] * dmb;
            acc[b] += dmb * w;
          }
        }
        const float dup = dW * (6.0f * up * (1.0f - up));
        const float ddn = dW * (6.0f * dn * (1.0f - dn));
        a_xl += dup * (-idl_e);
        a_idl += dup * (q - xl_e);
        a_xr += ddn * idr_e;
        a_idr += ddn * (xr_e - q);
      }
    }
    float* dst = G > 1 ? s_part + static_cast<size_t>(grp) * nb * E2
                       : tile_part;
#pragma unroll
    for (int b = 0; b < MB; ++b)
      if (b < B) dst[b * E2 + e] = acc[b];
    dst[B * E2 + e] = a_xl;
    dst[(B + 1) * E2 + e] = a_idl;
    dst[(B + 2) * E2 + e] = a_xr;
    dst[(B + 3) * E2 + e] = a_idr;
  }
  if (G > 1) {  // groups in order
    __syncthreads();
    for (int i = threadIdx.x; i < nb * E2; i += blockDim.x) {
      float v = s_part[i];
      for (int grp = 1; grp < G; ++grp) v += s_part[grp * nb * E2 + i];
      tile_part[i] = v;
    }
  }
}

// Pass 2: per chain, the tiles' partials summed in tile order.
__global__ void table_bwd_axis_kernel(const float* __restrict__ part,
                                      float* __restrict__ dsec,
                                      float* __restrict__ dxl,
                                      float* __restrict__ didl,
                                      float* __restrict__ dxr,
                                      float* __restrict__ didr, int B,
                                      int E2, int tiles) {
  const int c = blockIdx.x;
  const int nb = B + 4;
  const float* p = part + static_cast<size_t>(c) * tiles * nb * E2;
  for (int i = threadIdx.x; i < nb * E2; i += blockDim.x) {
    float v = 0.0f;
#pragma unroll 4
    for (int k = 0; k < tiles; ++k) v += p[static_cast<size_t>(k) * nb * E2 + i];
    const int j = i / E2;
    const int e = i - j * E2;
    const size_t o = static_cast<size_t>(c) * E2 + e;
    if (j < B) dsec[static_cast<size_t>(c) * B * E2 + i] = v;
    else if (j == B) dxl[o] = v;
    else if (j == B + 1) didl[o] = v;
    else if (j == B + 2) dxr[o] = v;
    else didr[o] = v;
  }
}

template <int MB>
int launch_table_fwd(const float* app1, const float* m2, const float* lit,
                     const float* secT, const float* xl, const float* idl,
                     const float* xr, const float* idr, float* out, int C,
                     int B, int N, int E2, cudaStream_t st) {
  const size_t smem = window_smem(B, E2);
  const int err = btt::allow_smem(table_fwd_kernel<MB>, smem);
  if (err != 0) return err;
  dim3 grid((N + FWD_NODES - 1) / FWD_NODES, C);
  table_fwd_kernel<MB><<<grid, FWD_NODES, smem, st>>>(
      app1, m2, lit, secT, xl, idl, xr, idr, out, B, N, E2);
  return static_cast<int>(cudaGetLastError());  // launch status
}

template <int MB>
int launch_table_bwd(const float* app1, const float* m2, const float* lit,
                     const float* secT, const float* xl, const float* idl,
                     const float* xr, const float* idr, const float* g,
                     float* dapp1, float* dm2, float* dlit, float* part,
                     int C, int B, int N, int E2, cudaStream_t st) {
  const int tiles = (N + BWD_NODES - 1) / BWD_NODES;
  const size_t smem = bwd_node_smem(B, E2);
  const int err = btt::allow_smem(table_bwd_node_kernel<MB>, smem);
  if (err != 0) return err;
  table_bwd_node_kernel<MB><<<dim3(tiles, C), BWD_NODES, smem, st>>>(
      app1, m2, lit, secT, xl, idl, xr, idr, g, dapp1, dm2, dlit, part, B, N,
      E2);
  return static_cast<int>(cudaGetLastError());  // launch status
}

}  // namespace

extern "C" int btt_table_fwd(const float* app1, const float* m2,
                             const float* lit, const float* secT,
                             const float* xl, const float* idl,
                             const float* xr, const float* idr, float* out,
                             int C, int B, int N, int E2, int device,
                             void* stream) {
  cudaSetDevice(device);
  const auto st = static_cast<cudaStream_t>(stream);
  if (B <= btt::NARROW_B)
    return launch_table_fwd<btt::NARROW_B>(app1, m2, lit, secT, xl, idl, xr,
                                           idr, out, C, B, N, E2, st);
  return launch_table_fwd<btt::MAX_B>(app1, m2, lit, secT, xl, idl, xr, idr,
                                      out, C, B, N, E2, st);
}

extern "C" long long btt_table_bwd_scratch(int C, int B, int N, int E2) {
  const long long tiles = (N + BWD_NODES - 1) / BWD_NODES;
  return static_cast<long long>(C) * tiles * (B + 4) * E2;
}

extern "C" int btt_table_bwd(const float* app1, const float* m2,
                             const float* lit, const float* secT,
                             const float* xl, const float* idl,
                             const float* xr, const float* idr,
                             const float* g, float* dapp1, float* dm2,
                             float* dlit, float* dsec, float* dxl,
                             float* didl, float* dxr, float* didr,
                             float* part, int C, int B, int N, int E2,
                             int device, void* stream) {
  cudaSetDevice(device);
  const auto st = static_cast<cudaStream_t>(stream);
  const int tiles = (N + BWD_NODES - 1) / BWD_NODES;
  const int err =
      B <= btt::NARROW_B
          ? launch_table_bwd<btt::NARROW_B>(app1, m2, lit, secT, xl, idl, xr,
                                            idr, g, dapp1, dm2, dlit, part, C,
                                            B, N, E2, st)
          : launch_table_bwd<btt::MAX_B>(app1, m2, lit, secT, xl, idl, xr,
                                         idr, g, dapp1, dm2, dlit, part, C, B,
                                         N, E2, st);
  if (err != 0) return err;
  table_bwd_axis_kernel<<<C, AXIS_THREADS, 0, st>>>(part, dsec, dxl, didl,
                                                    dxr, didr, B, E2, tiles);
  return static_cast<int>(cudaGetLastError());  // launch status
}
