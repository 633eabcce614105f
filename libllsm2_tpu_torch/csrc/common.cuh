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

// 4 bytes from global src to shared dst without the registers; zero where
// !in (src-size 0)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

// 16 bytes from global src to shared dst (both 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// 16 bytes from global src to shared dst, or zeros where !in (src-size 0)
__device__ __forceinline__ void cp_async16z(void* dst, const void* src,
                                            bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// Sums v[0..NV) over a block of NWARPS warps; every thread gets the totals.
// `red` holds NWARPS * NV floats; lane 0 of each warp deposits, then all
// read.  Both barriers are inside, so it also orders earlier shared-memory
// writes.
template <int NV, int NWARPS>
__device__ __forceinline__ void block_sums(float* v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float s = warp_sum(v[i]);
    if (lane == 0) red[warp * NV + i] = s;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < NWARPS; ++q) s += red[q * NV + i];
    v[i] = s;
  }
  __syncthreads();
}

// Cosine-series window c0 + sum_m c_m cos(2 pi m u) (ncoef terms), zero
// outside u in [0, 1].
__device__ __forceinline__ float cosine_window(float u, float c0, float c1,
                                               float c2, float c3,
                                               int ncoef) {
  if (!(u >= 0.0f && u <= 1.0f)) return 0.0f;
  float w = c0;
  if (ncoef > 1) w = fmaf(c1, cospif(2.0f * u), w);
  if (ncoef > 2) w = fmaf(c2, cospif(4.0f * u), w);
  if (ncoef > 3) w = fmaf(c3, cospif(6.0f * u), w);
  return w;
}

// One noise channel's temporal envelope at one sample, before max(., 0):
//   lerp(edc) + sum_k lerp(ar_k) cos(2 pi k cyc) - lerp(ai_k) sin(2 pi k cyc)
// for k = 1..Ke, lerp(a) = a0 + (a1 - a0) s between the coefficients of
// frames i (ar0, ai0: the channel's Ke values) and i + 1 (ar1, ai1), with
// (c1, s1) = (cos, sin)(2 pi cyc) seeding the rotation recurrence.  Shared
// by noise_mod_ola.cu and env_render.cu, so both render the same envelope.
__device__ __forceinline__ float envelope_sample(
    float edc0, float edc1, const float* ar0, const float* ar1,
    const float* ai0, const float* ai1, int Ke, float s, float c1,
    float s1) {
  float env = edc0 + (edc1 - edc0) * s;
  float wr = c1, wi = s1;
  for (int k = 0; k < Ke; ++k) {
    const float rl = ar0[k] + (ar1[k] - ar0[k]) * s;
    const float il = ai0[k] + (ai1[k] - ai0[k]) * s;
    env += rl * wr - il * wi;
    const float nwr = wr * c1 - wi * s1;
    wi = wr * s1 + wi * c1;
    wr = nwr;
  }
  return env;
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel k, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace llsm
