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
// E2 = 64) the forward is ~60 MFLOP and ~2 MB of traffic, so neither the
// FP32 rate nor HBM bandwidth is the limit; latency of the dense E2 loop and
// launch overhead are.  Design: the chain's secondary table and base axis
// (B + 4) * E2 floats are staged once per block in shared memory, and every
// thread owns one node and runs the dense E2 loop from shared memory (only
// two weights are non-zero, but the dense form keeps the axis gradients of
// the backward straightforward).  The backward's sums over nodes (dsecT and
// the four axis vectors) run in a fixed order inside one block per chain --
// phase 1 writes d mags2 per node to a scratch buffer, phase 2 gives each
// thread one output element and loops over all nodes in order -- so there
// are no atomics and the result is bit-identical from run to run.
#include "common.cuh"

namespace {

constexpr float LN10_04 = 0.9210340371976184f;
constexpr float INV_LN10_04 = 1.0857362047581294f;
constexpr int FWD_THREADS = 128;
constexpr int BWD_THREADS = 256;

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

// mags2[b] = sum_e secT[b, e] * W[e](q), e in order.
__device__ __forceinline__ void secondary_mags(const float* s_sec,
                                               const float* s_ax, float q,
                                               int B, int E2,
                                               float (&acc)[btt::MAX_B]) {
  const float* s_xl = s_ax;
  const float* s_idl = s_ax + E2;
  const float* s_xr = s_ax + 2 * E2;
  const float* s_idr = s_ax + 3 * E2;
#pragma unroll
  for (int b = 0; b < btt::MAX_B; ++b) acc[b] = 0.0f;
  for (int e = 0; e < E2; ++e) {
    const float up = btt::clamp01((q - s_xl[e]) * s_idl[e]);
    const float dn = btt::clamp01((s_xr[e] - q) * s_idr[e]);
    const float w = smoothstep(up) + smoothstep(dn) - 1.0f;
#pragma unroll
    for (int b = 0; b < btt::MAX_B; ++b)
      if (b < B) acc[b] += s_sec[b * E2 + e] * w;
  }
}

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
  stage_axis(sh, secT, xl, idl, xr, idr, c, B, E2);
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t node = static_cast<size_t>(c) * N + n;
  float mags2[btt::MAX_B];
  secondary_mags(sh, sh + B * E2, m2[node], B, E2, mags2);
  const float l = lit[node];
#pragma unroll
  for (int b = 0; b < btt::MAX_B; ++b) {
    if (b < B) {
      const size_t o = (static_cast<size_t>(c) * B + b) * N + n;
      const float f1 = expf(-LN10_04 * app1[o]);
      const float f2 = l * expf(-LN10_04 * mags2[b]);
      out[o] = -INV_LN10_04 * logf(f1 + f2);
    }
  }
}

__global__ void table_bwd_kernel(
    const float* __restrict__ app1, const float* __restrict__ m2,
    const float* __restrict__ lit, const float* __restrict__ secT,
    const float* __restrict__ xl, const float* __restrict__ idl,
    const float* __restrict__ xr, const float* __restrict__ idr,
    const float* __restrict__ g, float* __restrict__ dapp1,
    float* __restrict__ dm2, float* __restrict__ dlit,
    float* __restrict__ dsec, float* __restrict__ dxl,
    float* __restrict__ didl, float* __restrict__ dxr,
    float* __restrict__ didr, float* __restrict__ dmags2, int B, int N,
    int E2) {
  extern __shared__ float sh[];
  const int c = blockIdx.x;
  stage_axis(sh, secT, xl, idl, xr, idr, c, B, E2);
  __syncthreads();
  const float* s_sec = sh;
  const float* s_xl = sh + B * E2;
  const float* s_idl = s_xl + E2;
  const float* s_xr = s_xl + 2 * E2;
  const float* s_idr = s_xl + 3 * E2;
  const size_t cN = static_cast<size_t>(c) * N;
  const size_t cBN = static_cast<size_t>(c) * B * N;

  // Phase 1: per-node cotangents (dapp1, dlit, dm2) and d mags2 to scratch.
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float q = m2[cN + n];
    float mags2[btt::MAX_B];
    secondary_mags(s_sec, s_xl, q, B, E2, mags2);
    const float l = lit[cN + n];
    float dmv[btt::MAX_B];
    float dl = 0.0f;
#pragma unroll
    for (int b = 0; b < btt::MAX_B; ++b) {
      dmv[b] = 0.0f;
      if (b < B) {
        const size_t o = cBN + static_cast<size_t>(b) * N + n;
        const float f1 = expf(-LN10_04 * app1[o]);
        const float f2m = expf(-LN10_04 * mags2[b]);
        const float F = f1 + l * f2m;
        const float gg = g[o];
        dapp1[o] = gg * f1 / F;
        dmv[b] = gg * l * f2m / F;
        dmags2[o] = dmv[b];
        dl += gg * (-INV_LN10_04) * f2m / F;
      }
    }
    dlit[cN + n] = dl;
    float dq = 0.0f;
    for (int e = 0; e < E2; ++e) {
      const float up = btt::clamp01((q - s_xl[e]) * s_idl[e]);
      const float dn = btt::clamp01((s_xr[e] - q) * s_idr[e]);
      float dW = 0.0f;
#pragma unroll
      for (int b = 0; b < btt::MAX_B; ++b)
        if (b < B) dW += s_sec[b * E2 + e] * dmv[b];
      const float dup = dW * (6.0f * up * (1.0f - up));
      const float ddn = dW * (6.0f * dn * (1.0f - dn));
      dq += dup * s_idl[e] - ddn * s_idr[e];
    }
    dm2[cN + n] = dq;
  }
  __syncthreads();  // d mags2 of every node is visible to the whole block

  // Phase 2: sums over nodes, one output element per thread, n in order.
  for (int i = threadIdx.x; i < (B + 1) * E2; i += blockDim.x) {
    if (i < B * E2) {  // dsecT[b, e] = sum_n dmags2[b, n] W[e, n]
      const int b = i / E2;
      const int e = i % E2;
      float acc = 0.0f;
      for (int n = 0; n < N; ++n) {
        const float q = m2[cN + n];
        const float up = btt::clamp01((q - s_xl[e]) * s_idl[e]);
        const float dn = btt::clamp01((s_xr[e] - q) * s_idr[e]);
        const float w = smoothstep(up) + smoothstep(dn) - 1.0f;
        acc += dmags2[cBN + static_cast<size_t>(b) * N + n] * w;
      }
      dsec[static_cast<size_t>(c) * B * E2 + i] = acc;
    } else {  // the four base-axis vectors at node e
      const int e = i - B * E2;
      float a_xl = 0.0f, a_idl = 0.0f, a_xr = 0.0f, a_idr = 0.0f;
      for (int n = 0; n < N; ++n) {
        const float q = m2[cN + n];
        const float up = btt::clamp01((q - s_xl[e]) * s_idl[e]);
        const float dn = btt::clamp01((s_xr[e] - q) * s_idr[e]);
        float dW = 0.0f;
#pragma unroll
        for (int b = 0; b < btt::MAX_B; ++b)
          if (b < B)
            dW += s_sec[b * E2 + e] * dmags2[cBN + static_cast<size_t>(b) * N + n];
        const float dup = dW * (6.0f * up * (1.0f - up));
        const float ddn = dW * (6.0f * dn * (1.0f - dn));
        a_xl += dup * (-s_idl[e]);
        a_idl += dup * (q - s_xl[e]);
        a_xr += ddn * s_idr[e];
        a_idr += ddn * (s_xr[e] - q);
      }
      const size_t o = static_cast<size_t>(c) * E2 + e;
      dxl[o] = a_xl;
      didl[o] = a_idl;
      dxr[o] = a_xr;
      didr[o] = a_idr;
    }
  }
}

size_t axis_smem(int B, int E2) {
  return static_cast<size_t>(B + 4) * E2 * sizeof(float);
}

}  // namespace

extern "C" int btt_table_fwd(const float* app1, const float* m2,
                             const float* lit, const float* secT,
                             const float* xl, const float* idl,
                             const float* xr, const float* idr, float* out,
                             int C, int B, int N, int E2, int device,
                             void* stream) {
  cudaSetDevice(device);
  dim3 grid((N + FWD_THREADS - 1) / FWD_THREADS, C);
  table_fwd_kernel<<<grid, FWD_THREADS, axis_smem(B, E2),
                     static_cast<cudaStream_t>(stream)>>>(
      app1, m2, lit, secT, xl, idl, xr, idr, out, B, N, E2);
  return static_cast<int>(cudaGetLastError());  // launch status
}

extern "C" int btt_table_bwd(const float* app1, const float* m2,
                             const float* lit, const float* secT,
                             const float* xl, const float* idl,
                             const float* xr, const float* idr,
                             const float* g, float* dapp1, float* dm2,
                             float* dlit, float* dsec, float* dxl,
                             float* didl, float* dxr, float* didr,
                             float* dmags2, int C, int B, int N, int E2,
                             int device, void* stream) {
  cudaSetDevice(device);
  table_bwd_kernel<<<C, BWD_THREADS, axis_smem(B, E2),
                     static_cast<cudaStream_t>(stream)>>>(
      app1, m2, lit, secT, xl, idl, xr, idr, g, dapp1, dm2, dlit, dsec, dxl,
      didl, dxr, didr, dmags2, B, N, E2);
  return static_cast<int>(cudaGetLastError());  // launch status
}
