// Shared helpers of the port's CUDA kernels (plain C ABI, loaded with ctypes).
#pragma once

#include <cuda_runtime.h>

namespace btt {

// Bands are held per thread in unrolled register arrays sized by a band
// class: NARROW_B for B <= 16 (the instances every config up to eight bands
// runs) and MAX_B for 17..32.  The Python wrappers refuse B > MAX_B.
constexpr int NARROW_B = 16;
constexpr int MAX_B = 32;

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

// A launch that needs more than 48 KB of shared memory has to ask first
// (Hopper allows up to 227 KB a block).
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace btt
