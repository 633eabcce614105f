// Fused pitch-synchronous window + chirped harmonic projection.
//
//   re[n,k] + j im[n,k] = sum_w fr[n,w] win_n(w) e^{-2 pi j (k+1) dc[n,w]}
//   wsum[n] = sum_w win_n(w),  xsum[n] = sum_w fr[n,w] win_n(w)  (k = 0 row)
//
// win_n is the cosine-series window c0 + sum_m c_m cos(2 pi m u),
// u = ((w - center)/hw[n] + 1)/2, zero outside u in [0, 1].  Only columns
// in [lo[n], hi[n]) are visited (the window's support); slots k >= kl[n]
// are written as exact zeros.
//
// Replaces libllsm2_tpu/ops/pallas_osc.py: harmonic_project_win_pallas
// (_proj_win_kernel).  Bound on the H100: arithmetic on the live
// (window x harmonic) rectangle, ~hw x fnyq/f0 complex rotations per
// frame; the [N, W] frame buffers it reads are the memory side (8 bytes a
// column).  Design: one block per frame; a first pass evaluates the
// window once per column and keeps x*win and the reduced cycle offset in
// shared memory; then per chunk of 8 harmonics every thread seeds
// z^{k0+1} exactly with sincospif, rotates 8 times over its columns, and
// one block reduction (warp shuffles + shared memory) yields the chunk's
// 16 sums.  Chunks at or above kl[n] are never computed.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;

__global__ void __launch_bounds__(kThreads)
proj_win_kernel(const float* __restrict__ dc, const float* __restrict__ fr,
                const float* __restrict__ hw, const int* __restrict__ lo,
                const int* __restrict__ hi, const int* __restrict__ kl,
                float* __restrict__ re, float* __restrict__ im,
                float* __restrict__ wsum, float* __restrict__ xsum, int W,
                int K, int center, float c0, float c1, float c2, float c3,
                int ncoef) {
  extern __shared__ float sm[];
  float* xw_s = sm;        // [W] x * window over the active columns
  float* r_s = sm + W;     // [W] reduced cycle offsets
  __shared__ float red[kWarps * 2 * kChunk];
  const int64_t n = blockIdx.x;
  const float* dcn = dc + n * W;
  const float* frn = fr + n * W;
  const float h = hw[n];
  const int a = max(lo[n], 0), b = min(hi[n], W), len = max(b - a, 0);
  const int kn = min(max(kl[n], 0), K);

  float sums[2 * kChunk];
  sums[0] = 0.0f;
  sums[1] = 0.0f;
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const int w = a + i;
    const float u = ((float)(w - center) / h + 1.0f) * 0.5f;
    const float win = llsm::cosine_window(u, c0, c1, c2, c3, ncoef);
    const float xw = frn[w] * win;
    xw_s[i] = xw;
    r_s[i] = llsm::frac_c(dcn[w]);
    sums[0] += win;
    sums[1] += xw;
  }
  // also orders the shared-memory writes above
  llsm::block_sums<2, kWarps>(sums, red);
  if (threadIdx.x == 0) {
    wsum[n] = sums[0];
    xsum[n] = sums[1];
  }

  for (int k0 = 0; k0 < kn; k0 += kChunk) {
#pragma unroll
    for (int j = 0; j < 2 * kChunk; ++j) sums[j] = 0.0f;
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const float r = r_s[i], xw = xw_s[i];
      float zs, zc, wr, wi;
      sincospif(2.0f * r, &zs, &zc);
      sincospif(2.0f * llsm::kmul_c((float)(k0 + 1), r), &wi, &wr);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        sums[2 * j] = fmaf(xw, wr, sums[2 * j]);
        sums[2 * j + 1] = fmaf(-xw, wi, sums[2 * j + 1]);
        const float nwr = wr * zc - wi * zs;
        wi = wr * zs + wi * zc;
        wr = nwr;
      }
    }
    llsm::block_sums<2 * kChunk, kWarps>(sums, red);
    if (threadIdx.x == 0) {  // static indices keep sums[] in registers
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int k = k0 + j;
        if (k < K) {
          re[n * K + k] = k < kn ? sums[2 * j] : 0.0f;
          im[n * K + k] = k < kn ? sums[2 * j + 1] : 0.0f;
        }
      }
    }
  }
  const int kz = ((kn + kChunk - 1) / kChunk) * kChunk;
  for (int k = kz + threadIdx.x; k < K; k += kThreads) {
    re[n * K + k] = 0.0f;
    im[n * K + k] = 0.0f;
  }
}

}  // namespace

extern "C" int llsm_harmonic_project_win(
    const float* dc, const float* fr, const float* hw, const int* lo,
    const int* hi, const int* kl, float* re, float* im, float* wsum,
    float* xsum, long long R, int W, int K, int center, float c0, float c1,
    float c2, float c3, int ncoef, void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  if (ncoef < 1 || ncoef > 4) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)W * sizeof(float);
  cudaError_t e = llsm::allow_smem(proj_win_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  proj_win_kernel<<<(unsigned)R, kThreads, smem, (cudaStream_t)stream>>>(
      dc, fr, hw, lo, hi, kl, re, im, wsum, xsum, W, K, center, c0, c1, c2,
      c3, ncoef);
  return (int)cudaGetLastError();
}
