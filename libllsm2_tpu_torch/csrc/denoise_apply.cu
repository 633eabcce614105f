// Track denoiser, pass B: per frame row, reload pass A's aligned track c and
// slow track c_s, redo the coherent across-k fit r ~ (m0 + m1 (k+1)) c_s of
// r = c - c_s weighted by wmul[k] m[f,k] (both sides of the normal
// equations), gate the incoherent residual r_inc by the Wiener gain
// g = clip(1 - strength v[k] / (|r_inc|^2 + 1e-20), 0, 1), keep c where the
// guard fails, and un-align by e^{+2 pi j (k+1) cyc_c[f]}:
//   out = (c_s + r_coh + g r_inc) e^{2 pi j (k+1) cyc_c}   -> (o_r, o_i)
// emit != 0 also writes where(guard, c_s + r_inc, 0) (fr, fi) and the
// un-align factors (ur, ui) for the spectral gate.  v and wmul are per
// utterance ([B, K]).
//
// Replaces libllsm2_tpu/ops/pallas_osc.py: denoise_apply_pallas
// (_denoise_apply_kernel and _denoise_apply_spec_kernel, sharing
// _denoise_apply_body).  Bound on the H100: memory -- per (frame, k) it
// reads 5 floats and writes 2 or 6, against ~40 flops and one sincospif.
// Design: one warp per frame row (8 rows per block), lanes over k; the 7
// fit sums are reduced by warp shuffles, so no shared memory and no
// synchronisation; the second sweep over k re-reads the row from L1.  The
// row never reads another frame, so there is no halo.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
denoise_apply_kernel(const float* __restrict__ v,
                     const float* __restrict__ wm,
                     const float* __restrict__ cre,
                     const float* __restrict__ cim,
                     const float* __restrict__ csr,
                     const float* __restrict__ csi,
                     const float* __restrict__ cyc_c,
                     const float* __restrict__ mask,
                     const float* __restrict__ guard, float* __restrict__ o_r,
                     float* __restrict__ o_i, float* __restrict__ fr,
                     float* __restrict__ fi, float* __restrict__ ur,
                     float* __restrict__ ui, int64_t rows, int N, int K,
                     float strength, int emit) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int64_t b = row / N;
  const float* vb = v + b * K;
  const float* wb = wm + b * K;
  const int64_t base = row * K;
  const bool g = guard[row] > 0.5f;

  float a00 = 0.0f, a01 = 0.0f, a11 = 0.0f;
  float b0r = 0.0f, b0i = 0.0f, b1r = 0.0f, b1i = 0.0f;
  for (int k = lane; k < K; k += 32) {
    const float kh = (float)(k + 1);
    const float w = wb[k] * mask[base + k];
    const float sr = csr[base + k], si = csi[base + k];
    const float rr = cre[base + k] - sr, ri = cim[base + k] - si;
    const float pw = (sr * sr + si * si) * w;
    const float crr = (sr * rr + si * ri) * w;  // Re(conj(c_s) r)
    const float cri = (sr * ri - si * rr) * w;  // Im(conj(c_s) r)
    a00 += pw;
    a01 += kh * pw;
    a11 += kh * kh * pw;
    b0r += crr;
    b0i += cri;
    b1r += kh * crr;
    b1i += kh * cri;
  }
  a00 = llsm::warp_allsum(a00);
  a01 = llsm::warp_allsum(a01);
  a11 = llsm::warp_allsum(a11);
  b0r = llsm::warp_allsum(b0r);
  b0i = llsm::warp_allsum(b0i);
  b1r = llsm::warp_allsum(b1r);
  b1i = llsm::warp_allsum(b1i);
  const float det = a00 * a11 - a01 * a01;
  const float inv = 1.0f / (det + 1e-5f * a00 * a11 + 1e-12f);
  const float m0r = (a11 * b0r - a01 * b1r) * inv;
  const float m0i = (a11 * b0i - a01 * b1i) * inv;
  const float m1r = (a00 * b1r - a01 * b0r) * inv;
  const float m1i = (a00 * b1i - a01 * b0i) * inv;
  const float cy = cyc_c[row];

  for (int k = lane; k < K; k += 32) {
    const float kh = (float)(k + 1);
    const float wr = m0r + m1r * kh, wi = m0i + m1i * kh;
    const float cr = cre[base + k], ci = cim[base + k];
    const float sr = csr[base + k], si = csi[base + k];
    const float rcr = wr * sr - wi * si, rci = wr * si + wi * sr;
    const float rir = (cr - sr) - rcr, rii = (ci - si) - rci;
    const float pw = rir * rir + rii * rii;
    const float gain =
        fminf(fmaxf(1.0f - strength * vb[k] / (pw + 1e-20f), 0.0f), 1.0f);
    const float outr = g ? sr + rcr + gain * rir : cr;
    const float outi = g ? si + rci + gain * rii : ci;
    float su, cu;
    sincospif(2.0f * llsm::kmul_c(kh, cy), &su, &cu);
    o_r[base + k] = outr * cu - outi * su;
    o_i[base + k] = outr * su + outi * cu;
    if (emit) {
      fr[base + k] = g ? sr + rir : 0.0f;
      fi[base + k] = g ? si + rii : 0.0f;
      ur[base + k] = cu;
      ui[base + k] = su;
    }
  }
}

}  // namespace

extern "C" int llsm_denoise_apply(const float* v, const float* wm,
                                  const float* cre, const float* cim,
                                  const float* csr, const float* csi,
                                  const float* cyc_c, const float* mask,
                                  const float* guard, float* o_r, float* o_i,
                                  float* fr, float* fi, float* ur, float* ui,
                                  int B, int N, int K, float strength,
                                  int emit, void* stream) {
  if (emit && !(fr && fi && ur && ui)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || N <= 0 || K <= 0) return (int)cudaGetLastError();
  const int64_t rows = (int64_t)B * N;
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  denoise_apply_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      v, wm, cre, cim, csr, csi, cyc_c, mask, guard, o_r, o_i, fr, fi, ur, ui,
      rows, N, K, strength, emit);
  return (int)cudaGetLastError();
}
