// Shared helpers of the port's CUDA kernels (plain C ABI, loaded with ctypes).
#pragma once

#include <cuda_runtime.h>

namespace btt {

// Bands are held per thread in unrolled register arrays; the Python
// wrappers refuse B > MAX_B.
constexpr int MAX_B = 16;

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

}  // namespace btt
