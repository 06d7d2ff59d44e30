// Constants and launch helpers shared by every kernel library of the port.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr float kNegInf = -1e30f;     // finite "minus infinity", as the TPU kernels
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;      // bytes a block may use on sm_90

// Lets `kern` take `smem` bytes of dynamic shared memory: above 48 KB only
// when opted in, above kMaxSmem never.
template <typename Kern>
cudaError_t opt_in_smem(Kern kern, int smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
             : cudaSuccess;
}

inline bool aligned(const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

}  // namespace sm90
