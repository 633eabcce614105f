// Noise spectra keyed by frame, drawn as jax.random draws them: frame f's
// (re, im) bins are normal(kr, (nbin,)) and normal(ki, (nbin,)) with
// kr, ki = split(fold_in(PRNGKey(seed), f)), threefry-2x32 in JAX's
// partitionable mode (jax/_src/prng.py): bin b's 32 bits are the xor of the
// two words of threefry(key, (0, b)); the normal is sqrt(2) erf_inv(u) of
// the uniform u in (-1, 1) those bits give, with XLA's float32 erf_inv
// (M. Giles' polynomials).
//
// Not the counterpart of a Pallas kernel: it replaces the random draw that
// XLA makes with its own built-in kernel in libllsm2_tpu/models/layer0.py
// (_synth_noise, jax.random.fold_in / split / normal).  Bound on the H100:
// integer operations -- ~5 threefry hashes of 20 rounds per bin against 8
// bytes written.  Design: one thread per (frame, bin) hashes its frame's key
// (fold_in, then the split word it needs) and its own bin; every float
// operation is a separately rounded __fmul_rn / __fadd_rn, as the plain
// version (ops/kernels.py noise_bins_ref) computes it.
#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds: (x0, x1) hashed under key (k0, k1).
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__device__ __forceinline__ float normal_from_bits(uint32_t bits) {
  const float f = __fadd_rn(__uint_as_float((bits >> 9) | 0x3F800000u), -1.0f);
  const float lo = -0.99999994f;  // nextafter(-1, 0)
  const float u = fmaxf(__fadd_rn(__fmul_rn(f, 2.0f), lo), lo);
  float w = -log1pf(-__fmul_rn(u, u));
  const bool small = w < 5.0f;
  w = small ? __fadd_rn(w, -2.5f) : __fadd_rn(__fsqrt_rn(w), -3.0f);
  const float lo_c[9] = {2.81022636e-08f,  3.43273939e-07f, -3.5233877e-06f,
                         -4.39150654e-06f, 0.00021858087f,  -0.00125372503f,
                         -0.00417768164f,  0.246640727f,    1.50140941f};
  const float hi_c[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                         -0.00367342844f,  0.00573950773f,  -0.0076224613f,
                         0.00943887047f,   1.00167406f,     2.83297682f};
  float p = small ? lo_c[0] : hi_c[0];
#pragma unroll
  for (int i = 1; i < 9; ++i)
    p = __fadd_rn(small ? lo_c[i] : hi_c[i], __fmul_rn(p, w));
  return __fmul_rn(1.41421354f, __fmul_rn(p, u));
}

__global__ void noise_bins_kernel(float* __restrict__ re,
                                  float* __restrict__ im,
                                  int* __restrict__ bits_re,
                                  int* __restrict__ bits_im, uint32_t seed,
                                  uint32_t frame_base, int N, int nbin) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)N * nbin) return;
  const int f = (int)(idx / nbin);
  const uint32_t b = (uint32_t)(idx - (int64_t)f * nbin);
  // fold_in(PRNGKey(seed) = (0, seed), frame)
  uint32_t fk0 = 0u, fk1 = frame_base + (uint32_t)f;
  threefry(0u, seed, fk0, fk1);
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    // split: key `part` is threefry(folded key, (0, part))
    uint32_t k0 = 0u, k1 = (uint32_t)part;
    threefry(fk0, fk1, k0, k1);
    uint32_t x0 = 0u, x1 = b;
    threefry(k0, k1, x0, x1);
    const uint32_t bits = x0 ^ x1;
    (part ? im : re)[idx] = normal_from_bits(bits);
    int* raw = part ? bits_im : bits_re;
    if (raw) raw[idx] = (int)bits;
  }
}

}  // namespace

extern "C" int llsm_noise_bins(float* re, float* im, int* bits_re,
                               int* bits_im, unsigned int seed,
                               unsigned int frame_base, int N, int nbin,
                               void* stream) {
  if (N <= 0 || nbin <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  const int64_t total = (int64_t)N * nbin;
  noise_bins_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                      (cudaStream_t)stream>>>(re, im, bits_re, bits_im, seed,
                                              frame_base, N, nbin);
  return (int)cudaGetLastError();
}
