// Unframed chirped harmonic projection at uniform frame centers f*nhop.
//
//   re[b,f,k] + j im[b,f,k] = sum_n w_f(n) x(n) e^{-2 pi j (k+1) cyc(n)}
//   wsum[b,f] = sum_n w_f(n),  xsum[b,f] = sum_n w_f(n) x(n)
//
// over every sample n of utterance b, x zero outside [0, nx) (the ones
// row of wsum is not); w_f is the cosine-series window of halfwidth
// hw[b,f] centred at f*nhop, cut at |n - f*nhop| <= reach.  cyc is the
// absolute mod-1 cycle track: the caller rotates by e^{+2 pi j (k+1)
// cyc(f*nhop)} to get phases at the frame centre.
//
// Replaces libllsm2_tpu/ops/pallas_osc.py: harmonic_project_mxu
// (_proj_mxu_kernel), the hm_kernel="matmul" main harmonic pass: the TPU
// kernel generates the frame-independent modulated signal g_k(n) = x(n)
// e^{-2 pi j k cyc(n)} per span chunk and contracts it with banded window
// rows on the MXU, so no [N, W] frame buffer ever exists.  Bound on the
// H100: arithmetic, not bytes -- it reads only x and cyc (8 bytes a
// sample) and writes [B, N, 2K+2]; the work is one sincospif per (span
// sample, harmonic) for g and 2 FMAs per (window sample, harmonic) for
// the contraction, all in fp32 (the JAX call runs at Precision.HIGHEST, so
// no TF32 or bf16 tensor-core math).  Design: one block per tile of kFT
// frames of one utterance; thread j owns harmonic j (j = 0: the ones and
// x rows) and keeps its kFT complex sums in registers.  A loop over span
// chunks of kSC samples (the TPU's sequential grid axis) stages x and cyc
// and evaluates the window rows of only the frames whose support meets the
// chunk in shared memory; each thread then makes g_j for 8 samples in
// registers (k*cyc reduced mod 1 exactly, as the other kernels do) and
// adds them into every frame whose support meets those 8 samples.  G is
// never stored: each thread is the only reader of its own row.
#include "common.cuh"

namespace {

constexpr int kFT = 16;       // frames per block tile
constexpr int kSC = 256;      // span samples per chunk
constexpr int kG = 8;         // samples per register group
constexpr int kMaxThreads = 256;
constexpr int kEmpty = 1 << 30;

__global__ void __launch_bounds__(kMaxThreads)
proj_mxu_kernel(const float* __restrict__ x, const float* __restrict__ cyc,
                const float* __restrict__ hw, float* __restrict__ re,
                float* __restrict__ im, float* __restrict__ wsum,
                float* __restrict__ xsum, int nx, int N, int K, int nhop,
                int reach, float c0, float c1, float c2, float c3,
                int ncoef) {
  __shared__ __align__(16) float w_s[kFT][kSC];
  __shared__ float x_s[kSC], cyc_s[kSC], hw_s[kFT];
  __shared__ int lo_s[kFT], hi_s[kFT];   // support [lo, hi), absolute
  const int64_t b = blockIdx.y;
  const int f0 = blockIdx.x * kFT;
  const float* xb = x + b * nx;
  const float* cb = cyc + b * nx;
  const int j = threadIdx.x;
  if (j < kFT) {
    const int f = f0 + j;
    if (f < N) {
      const float h = hw[b * N + f];
      const int r = min((int)ceilf(h), reach);
      hw_s[j] = h;
      lo_s[j] = f * nhop - r;
      hi_s[j] = f * nhop + r + 1;
    } else {  // beyond the utterance: meets no sample
      hw_s[j] = 1.0f;
      lo_s[j] = kEmpty;
      hi_s[j] = -kEmpty;
    }
  }
  __syncthreads();
  int s_lo = kEmpty, s_hi = -kEmpty;
#pragma unroll
  for (int f = 0; f < kFT; ++f) {
    s_lo = min(s_lo, lo_s[f]);
    s_hi = max(s_hi, hi_s[f]);
  }

  float ar[kFT], ai[kFT];
#pragma unroll
  for (int f = 0; f < kFT; ++f) {
    ar[f] = 0.0f;
    ai[f] = 0.0f;
  }
  const bool live = j <= K;
  const float kj = (float)j;
  for (int c0n = s_lo; c0n < s_hi; c0n += kSC) {
    __syncthreads();  // the previous chunk's reads are done
    for (int i = j; i < kSC; i += blockDim.x) {
      const int n = c0n + i;
      const bool in = n >= 0 && n < nx;
      x_s[i] = in ? xb[n] : 0.0f;
      cyc_s[i] = in ? cb[n] : 0.0f;
    }
    for (int idx = j; idx < kFT * kSC; idx += blockDim.x) {
      const int f = idx / kSC, i = idx % kSC, n = c0n + i;
      const int lo = lo_s[f], hi = hi_s[f];
      if (lo < c0n + kSC && hi > c0n) {  // rows of other frames: never read
        const float u = ((float)(n - (f0 + f) * nhop) / hw_s[f] + 1.0f)
                        * 0.5f;
        w_s[f][i] = (n >= lo && n < hi)
                        ? llsm::cosine_window(u, c0, c1, c2, c3, ncoef)
                        : 0.0f;
      }
    }
    __syncthreads();
    if (!live) continue;
    const int ngroups = (min(kSC, s_hi - c0n) + kG - 1) / kG;
    for (int g = 0; g < ngroups; ++g) {
      const int n0 = c0n + g * kG;
      float gr[kG], gi[kG];
#pragma unroll
      for (int q = 0; q < kG; ++q) {
        const float xv = x_s[g * kG + q];
        if (j == 0) {
          gr[q] = 1.0f;
          gi[q] = xv;
        } else {
          float s, c;
          sincospif(2.0f * llsm::kmul_c(kj, cyc_s[g * kG + q]), &s, &c);
          gr[q] = xv * c;
          gi[q] = -xv * s;
        }
      }
#pragma unroll
      for (int f = 0; f < kFT; ++f) {
        if (lo_s[f] < n0 + kG && hi_s[f] > n0) {
          const float4 wa = *reinterpret_cast<const float4*>(&w_s[f][g * kG]);
          const float4 wb =
              *reinterpret_cast<const float4*>(&w_s[f][g * kG + 4]);
          float sr = ar[f], si = ai[f];
          sr = fmaf(wa.x, gr[0], sr);
          si = fmaf(wa.x, gi[0], si);
          sr = fmaf(wa.y, gr[1], sr);
          si = fmaf(wa.y, gi[1], si);
          sr = fmaf(wa.z, gr[2], sr);
          si = fmaf(wa.z, gi[2], si);
          sr = fmaf(wa.w, gr[3], sr);
          si = fmaf(wa.w, gi[3], si);
          sr = fmaf(wb.x, gr[4], sr);
          si = fmaf(wb.x, gi[4], si);
          sr = fmaf(wb.y, gr[5], sr);
          si = fmaf(wb.y, gi[5], si);
          sr = fmaf(wb.z, gr[6], sr);
          si = fmaf(wb.z, gi[6], si);
          sr = fmaf(wb.w, gr[7], sr);
          si = fmaf(wb.w, gi[7], si);
          ar[f] = sr;
          ai[f] = si;
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int f = 0; f < kFT; ++f) {
    const int F = f0 + f;
    if (F < N) {
      const int64_t row = b * N + F;
      if (j == 0) {
        wsum[row] = ar[f];
        xsum[row] = ai[f];
      } else {
        re[row * K + j - 1] = ar[f];
        im[row * K + j - 1] = ai[f];
      }
    }
  }
}

}  // namespace

extern "C" int llsm_harmonic_project_mxu(
    const float* x, const float* cyc, const float* hw, float* re, float* im,
    float* wsum, float* xsum, int B, int nx, int N, int K, int nhop,
    int reach, float c0, float c1, float c2, float c3, int ncoef,
    void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  if (ncoef < 1 || ncoef > 4 || K < 0 || K + 1 > kMaxThreads || nhop <= 0
      || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int threads = ((K + 1 + 31) / 32) * 32;
  const dim3 grid((unsigned)((N + kFT - 1) / kFT), (unsigned)B);
  proj_mxu_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      x, cyc, hw, re, im, wsum, xsum, nx, N, K, nhop, reach, c0, c1, c2, c3,
      ncoef);
  return (int)cudaGetLastError();
}
