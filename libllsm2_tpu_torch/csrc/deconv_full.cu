// Amplitude-track deconvolution: one Neumann step c' <- 2c - S c on the
// phase-aligned complex harmonic tracks, S = T (frames) + X (k -> k+1)
// + conj(X) (k -> k-1), all banded over +-D frames.
//
// Per frame f and band offset d in [-D, D], at the stride-quadrature
// points r_q = -nhop + (q + 1/2) stride of the render crossfade:
//   P[f,d,q] = hann_hw[f](d nhop + r_q) * w_ola(r_q)
//   T[f,d] = sum_q P / tot[f],  X[f,d] = sum_q P eq[f+d, q] / tot[f],
//   tot[f] = sum_{d,q} P,  eq = e^{2 pi j cyc} at the quadrature points.
// Aligned tracks c[f,k] = a e^{j phi} e^{-2 pi j (k+1) cyc_c[f]}; frames
// outside [0, N) of the SAME utterance are zero.  Output: the corrected
// track un-aligned (times e^{+2 pi j (k+1) cyc_c}) as (re, im).
//
// Replaces libllsm2_tpu/ops/pallas_osc.py: deconv_full_pallas
// (_deconv_full_kernel).  Bound on the H100: memory -- per frame it reads
// 2K + 2 nq + 2 floats and writes 2K, against ~(2D+1)*6 FMAs per output
// plus the band build; the TPU kernel's banded MXU matmuls are not needed.
// Design: one block per (tile of 32 frames, utterance).  The block builds
// its 32 x (2D+1) T/X taps and the aligned tracks of its frames plus a
// +-D halo in shared memory (the halo stops at the utterance's ends, so no
// block ever reads another batch row), then one thread per (f, k) sums
// the 2D+1 taps x 3 terms and un-aligns.
#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
deconv_kernel(const float* __restrict__ ampl, const float* __restrict__ phse,
              const float* __restrict__ cyc_c, const float* __restrict__ hw,
              const float* __restrict__ eq_re,
              const float* __restrict__ eq_im, float* __restrict__ out_re,
              float* __restrict__ out_im, int N, int K, int D, int nhop,
              int stride, int nq) {
  extern __shared__ float sm[];
  const int nb = 2 * D + 1;
  const int FH = kTile + 2 * D;
  float* vre = sm;                  // [FH, K] aligned track, halo rows
  float* vim = vre + FH * K;
  float* tb = vim + FH * K;         // [kTile, nb] taps
  float* xr = tb + kTile * nb;
  float* xi = xr + kTile * nb;
  float* inv = xi + kTile * nb;     // [kTile] 1 / tot
  const int64_t row0 = (int64_t)blockIdx.y * N;  // this utterance's frame 0
  const int f0 = blockIdx.x * kTile;
  const float inv2pi = 0.15915494309189535f;

  for (int idx = threadIdx.x; idx < FH * K; idx += kThreads) {
    const int fh = idx / K, k = idx - fh * K;
    const int f = f0 - D + fh;
    float vr = 0.0f, vi = 0.0f;
    if (f >= 0 && f < N) {
      const int64_t o = (row0 + f) * K + k;
      const float ph = llsm::frac_c(phse[o] * inv2pi -
                                    llsm::kmul_c((float)(k + 1),
                                                 cyc_c[row0 + f]));
      float s, c;
      sincospif(2.0f * ph, &s, &c);
      vr = ampl[o] * c;
      vi = ampl[o] * s;
    }
    vre[idx] = vr;
    vim[idx] = vi;
  }
  for (int idx = threadIdx.x; idx < kTile * nb; idx += kThreads) {
    const int fl = idx / nb, j = idx - fl * nb;
    const int f = f0 + fl, d = j - D, fd = f + d;
    float t = 0.0f, sr = 0.0f, si = 0.0f;
    if (f < N) {
      const float h = hw[row0 + f];
      const bool nb_in = fd >= 0 && fd < N;
      for (int q = 0; q < nq; ++q) {
        const float r = -(float)nhop + ((float)q + 0.5f) * (float)stride;
        const float wola = 0.5f + 0.5f * cospif(r / (float)nhop);
        const float u = (((float)(d * nhop) + r) / h + 1.0f) * 0.5f;
        const float w = (u >= 0.0f && u <= 1.0f)
                            ? 0.5f - 0.5f * cospif(2.0f * u) : 0.0f;
        const float P = w * wola;
        t += P;
        if (nb_in) {
          sr = fmaf(P, eq_re[(row0 + fd) * nq + q], sr);
          si = fmaf(P, eq_im[(row0 + fd) * nq + q], si);
        }
      }
    }
    tb[idx] = t;
    xr[idx] = sr;
    xi[idx] = si;
  }
  __syncthreads();
  for (int fl = threadIdx.x; fl < kTile; fl += kThreads) {
    float s = 0.0f;
    for (int j = 0; j < nb; ++j) s += tb[fl * nb + j];
    inv[fl] = 1.0f / fmaxf(s, 1e-9f);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < kTile * K; idx += kThreads) {
    const int fl = idx / K, k = idx - fl * K;
    const int f = f0 + fl;
    if (f >= N) continue;
    float smr = 0.0f, smi = 0.0f;
    for (int j = 0; j < nb; ++j) {
      const int h = (fl + j) * K + k;  // halo row of frame f + (j - D)
      const float Tt = tb[fl * nb + j], Xr = xr[fl * nb + j],
                  Xi = xi[fl * nb + j];
      smr = fmaf(Tt, vre[h], smr);
      smi = fmaf(Tt, vim[h], smi);
      if (k + 1 < K) {  // X c_{k+1}
        const float ur = vre[h + 1], ui = vim[h + 1];
        smr += Xr * ur - Xi * ui;
        smi += Xr * ui + Xi * ur;
      }
      if (k >= 1) {     // conj(X) c_{k-1}
        const float dr = vre[h - 1], di = vim[h - 1];
        smr += Xr * dr + Xi * di;
        smi += Xr * di - Xi * dr;
      }
    }
    const float iv = inv[fl];
    const int hc = (fl + D) * K + k;
    const float c2r = 2.0f * vre[hc] - smr * iv;
    const float c2i = 2.0f * vim[hc] - smi * iv;
    float s, c;
    sincospif(2.0f * llsm::kmul_c((float)(k + 1), cyc_c[row0 + f]), &s, &c);
    const int64_t o = (row0 + f) * K + k;
    out_re[o] = c2r * c - c2i * s;
    out_im[o] = c2r * s + c2i * c;
  }
}

}  // namespace

extern "C" int llsm_deconv_full(const float* ampl, const float* phse,
                                const float* cyc_c, const float* hw,
                                const float* eq_re, const float* eq_im,
                                float* out_re, float* out_im, int B, int N,
                                int K, int D, int nhop, int stride, int nq,
                                void* stream) {
  if (B <= 0 || N <= 0 || K <= 0) return (int)cudaGetLastError();
  const int nb = 2 * D + 1, FH = kTile + 2 * D;
  const size_t smem =
      ((size_t)2 * FH * K + (size_t)3 * kTile * nb + kTile) * sizeof(float);
  cudaError_t e = llsm::allow_smem(deconv_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + kTile - 1) / kTile, B);
  deconv_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      ampl, phse, cyc_c, hw, eq_re, eq_im, out_re, out_im, N, K, D, nhop,
      stride, nq);
  return (int)cudaGetLastError();
}
