// Shared device helpers of the port's hand-written Hopper kernels.
//
// Every phase is carried in CYCLES and reduced mod 1 before trig, as in the
// JAX package: sincospif(2 q) with q in [-0.5, 0.5] keeps float32 phases
// accurate without --use_fast_math (which this build must not use).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace llsm {

// x reduced to the representative in [-0.5, 0.5].
__device__ __forceinline__ float frac_c(float x) { return x - rintf(x); }

// (k * r) mod 1 in [-0.5, 0.5] with the product's rounding error added
// back (fmaf gives it exactly), so harmonic k of a cycle offset r keeps
// float32 accuracy even at k = 80.
__device__ __forceinline__ float kmul_c(float k, float r) {
  float p = k * r;
  float e = fmaf(k, r, -p);
  return (p - rintf(p)) + e;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the warp, returned to every lane.
__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel k, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace llsm
