// Oscillator bank: seg[n, t] = sum_{k < kl[n]} ar[n,k] cos(2 pi (k+1) dc[n,t])
//                                            - ai[n,k] sin(2 pi (k+1) dc[n,t])
// with ar = a m cos(phi), ai = a m sin(phi) formed by the wrapper.
//
// Replaces libllsm2_tpu/ops/pallas_osc.py: osc_bank_pallas (_osc_kernel).
// Bound on the H100: arithmetic -- per output sample 4 FMAs of rotation
// and 2 of accumulation per live harmonic (up to 80), against 4 bytes read
// and 4 written.  Design: one block per frame row; the row's coefficients
// sit in shared memory and are read as warp-wide broadcasts; one thread per
// sample runs the complex-rotation recurrence z^{k+1} = z^k z (no per-k
// transcendentals), re-seeded exactly every 8 harmonics so rounding does
// not grow with k; the loop stops at the frame's own live count kl[n].
#include "common.cuh"

namespace {

constexpr int kReseed = 8;

__global__ void osc_bank_kernel(const float* __restrict__ dc,
                                const float* __restrict__ ar,
                                const float* __restrict__ ai,
                                const int* __restrict__ kl,
                                float* __restrict__ out, int T, int K) {
  extern __shared__ float coef[];  // [2K]: ar row, then ai row
  const int64_t n = blockIdx.x;
  const int kn = min(max(kl[n], 0), K);
  for (int k = threadIdx.x; k < kn; k += blockDim.x) {
    coef[k] = ar[n * K + k];
    coef[K + k] = ai[n * K + k];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const float r = llsm::frac_c(dc[n * T + t]);
    float zs, zc;
    sincospif(2.0f * r, &zs, &zc);
    float acc = 0.0f, wr = zc, wi = zs;
    for (int k0 = 0; k0 < kn; k0 += kReseed) {
      if (k0 > 0) sincospif(2.0f * llsm::kmul_c((float)(k0 + 1), r), &wi, &wr);
      const int k1 = min(k0 + kReseed, kn);
      for (int k = k0; k < k1; ++k) {
        acc = fmaf(coef[k], wr, acc);
        acc = fmaf(-coef[K + k], wi, acc);
        const float nwr = wr * zc - wi * zs;
        wi = wr * zs + wi * zc;
        wr = nwr;
      }
    }
    out[n * T + t] = acc;
  }
}

}  // namespace

extern "C" int llsm_osc_bank(const float* dc, const float* ar, const float* ai,
                             const int* kl, float* out, long long R, int T,
                             int K, void* stream) {
  if (R <= 0 || T <= 0) return (int)cudaGetLastError();
  const int threads = min(((T + 31) / 32) * 32, 256);
  const size_t smem = 2 * (size_t)K * sizeof(float);
  cudaError_t e = llsm::allow_smem(osc_bank_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  osc_bank_kernel<<<(unsigned)R, threads, smem, (cudaStream_t)stream>>>(
      dc, ar, ai, kl, out, T, K);
  return (int)cudaGetLastError();
}
