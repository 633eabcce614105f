// Track denoiser, pass A: per utterance and frame, the phase-aligned complex
// harmonic track c[f,k] (from (ampl, phse), or from the raw complex track
// (re, im) with complex_input), its slow part c_s = taps1 * c along frames,
// the voicing guard (taps1 * voiced > 0.999), the per-frame coherent fit
// r ~ (m0 + m1 (k+1)) c_s of r = c - c_s across k, the incoherent residual
// r_inc, and the probe power pp = |r_inc - taps2 * r_inc|^2.
// Frames outside [0, N) of the SAME utterance enter as zeros; their c_s (the
// FIR's tail) and r_inc = -c_s (zero mask, zero fit) still reach the probe
// FIR of the last h2 frames, as in the TPU kernel.
//
// Replaces libllsm2_tpu/ops/pallas_osc.py: denoise_stats_pallas
// (_denoise_stats_kernel, _denoise_body).  Bound on the H100: memory -- per
// (frame, k) it reads 3 floats and writes 5, against ~13 + 7 taps of FIR
// and a 7-term reduction over k.  Design: one block per (tile of 32 frames,
// utterance).  The block stages the aligned track of its frames plus a
// +-(h1 + h2) halo in shared memory (zero beyond the utterance, so no block
// reads another batch row), runs the slow-track FIR for the +-h2 rows the
// probe needs, fits each row with one warp (warp-shuffle sums over k), keeps
// r_inc in shared memory for the probe FIR, and writes only its own frames.
#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kMaxTaps = 31;

struct Taps {
  float t1[kMaxTaps];
  float t2[kMaxTaps];
  int n1, n2;
};

__global__ void __launch_bounds__(kThreads)
denoise_stats_kernel(const float* __restrict__ a, const float* __restrict__ p,
                     const float* __restrict__ cyc_c,
                     const float* __restrict__ mask,
                     const float* __restrict__ voiced, float* __restrict__ pp,
                     float* __restrict__ gd, float* __restrict__ o_cre,
                     float* __restrict__ o_cim, float* __restrict__ o_csr,
                     float* __restrict__ o_csi, int N, int K, Taps taps,
                     int complex_input) {
  extern __shared__ float sm[];
  const int n1 = taps.n1, n2 = taps.n2;
  const int h1 = n1 / 2, h2 = n2 / 2;
  const int RA = kTile + 2 * (h1 + h2);  // aligned rows: frames [-h1-h2, F+h1+h2)
  const int R = kTile + 2 * h2;          // fit rows: frames [-h2, F+h2)
  float* cre = sm;                       // [RA, K]
  float* cim = cre + RA * K;
  float* csr = cim + RA * K;             // [R, K]
  float* csi = csr + R * K;
  float* rir = csi + R * K;              // [R, K]
  float* rii = rir + R * K;
  float* vo = rii + R * K;               // [RA]
  float* t1 = vo + RA;                   // [n1]
  float* t2 = t1 + n1;                   // [n2]
  const int64_t row0 = (int64_t)blockIdx.y * N;  // this utterance's frame 0
  const int f0 = blockIdx.x * kTile;
  const int fa = f0 - h1 - h2;           // frame of aligned row 0
  const float inv2pi = 0.15915494309189535f;

  for (int j = threadIdx.x; j < n1; j += kThreads) t1[j] = taps.t1[j];
  for (int j = threadIdx.x; j < n2; j += kThreads) t2[j] = taps.t2[j];
  for (int idx = threadIdx.x; idx < RA * K; idx += kThreads) {
    const int r = idx / K, k = idx - r * K;
    const int f = fa + r;
    float cr = 0.0f, ci = 0.0f;
    if (f >= 0 && f < N) {
      const int64_t o = (row0 + f) * K + k;
      const float kc = llsm::kmul_c((float)(k + 1), cyc_c[row0 + f]);
      float s, c;
      if (complex_input) {  // (re, im) rotated by e^{-2 pi j (k+1) cyc}
        sincospif(-2.0f * kc, &s, &c);
        const float x = a[o], y = p[o];
        cr = x * c - y * s;
        ci = x * s + y * c;
      } else {              // a e^{j (phi - 2 pi (k+1) cyc)}
        sincospif(2.0f * llsm::frac_c(p[o] * inv2pi - kc), &s, &c);
        cr = a[o] * c;
        ci = a[o] * s;
      }
    }
    cre[idx] = cr;
    cim[idx] = ci;
  }
  for (int r = threadIdx.x; r < RA; r += kThreads) {
    const int f = fa + r;
    vo[r] = (f >= 0 && f < N) ? voiced[row0 + f] : 0.0f;
  }
  __syncthreads();

  // slow track of frame f0 - h2 + r: aligned rows r .. r + n1 - 1
  for (int idx = threadIdx.x; idx < R * K; idx += kThreads) {
    const int r = idx / K, k = idx - r * K;
    float sr = 0.0f, si = 0.0f;
    for (int j = 0; j < n1; ++j) {
      sr = fmaf(t1[j], cre[(r + j) * K + k], sr);
      si = fmaf(t1[j], cim[(r + j) * K + k], si);
    }
    csr[idx] = sr;
    csi[idx] = si;
  }
  __syncthreads();

  // coherent fit, one warp per fit row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += kThreads / 32) {
    const int f = f0 - h2 + r;
    const bool in = f >= 0 && f < N;
    const int ra = r + h1;               // aligned row of the same frame
    float a00 = 0.0f, a01 = 0.0f, a11 = 0.0f;
    float b0r = 0.0f, b0i = 0.0f, b1r = 0.0f, b1i = 0.0f;
    for (int k = lane; k < K; k += 32) {
      const float m = in ? mask[(row0 + f) * K + k] : 0.0f;
      const float kh = (float)(k + 1);
      const float sr = csr[r * K + k], si = csi[r * K + k];
      const float rr = cre[ra * K + k] - sr, ri = cim[ra * K + k] - si;
      const float pw = (sr * sr + si * si) * m;
      const float crr = (sr * rr + si * ri) * m;  // Re(conj(c_s) r)
      const float cri = (sr * ri - si * rr) * m;  // Im(conj(c_s) r)
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
    for (int k = lane; k < K; k += 32) {
      const float kh = (float)(k + 1);
      const float wr = m0r + m1r * kh, wi = m0i + m1i * kh;
      const float sr = csr[r * K + k], si = csi[r * K + k];
      rir[r * K + k] = (cre[ra * K + k] - sr) - (wr * sr - wi * si);
      rii[r * K + k] = (cim[ra * K + k] - si) - (wr * si + wi * sr);
    }
  }
  __syncthreads();

  // probe FIR and the outputs of this tile's own frames
  for (int idx = threadIdx.x; idx < kTile * K; idx += kThreads) {
    const int fl = idx / K, k = idx - fl * K;
    const int f = f0 + fl;
    if (f >= N) continue;
    float lr = 0.0f, li = 0.0f;
    for (int j = 0; j < n2; ++j) {
      lr = fmaf(t2[j], rir[(fl + j) * K + k], lr);
      li = fmaf(t2[j], rii[(fl + j) * K + k], li);
    }
    const float pr = rir[(fl + h2) * K + k] - lr;
    const float pi = rii[(fl + h2) * K + k] - li;
    const int64_t o = (row0 + f) * K + k;
    pp[o] = pr * pr + pi * pi;
    o_cre[o] = cre[(fl + h1 + h2) * K + k];
    o_cim[o] = cim[(fl + h1 + h2) * K + k];
    o_csr[o] = csr[(fl + h2) * K + k];
    o_csi[o] = csi[(fl + h2) * K + k];
  }
  for (int fl = threadIdx.x; fl < kTile; fl += kThreads) {
    const int f = f0 + fl;
    if (f >= N) continue;
    float g = 0.0f;
    for (int j = 0; j < n1; ++j) g = fmaf(t1[j], vo[fl + h2 + j], g);
    gd[row0 + f] = g > 0.999f ? 1.0f : 0.0f;
  }
}

}  // namespace

extern "C" int llsm_denoise_stats(const float* a, const float* p,
                                  const float* cyc_c, const float* mask,
                                  const float* voiced, float* pp, float* gd,
                                  float* cre, float* cim, float* csr,
                                  float* csi, int B, int N, int K,
                                  const float* taps1, int n1,
                                  const float* taps2, int n2,
                                  int complex_input, void* stream) {
  if (n1 < 1 || n2 < 1 || n1 > kMaxTaps || n2 > kMaxTaps ||
      n1 / 2 + 2 * (n2 / 2) >= kTile)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || N <= 0 || K <= 0) return (int)cudaGetLastError();
  Taps taps{};
  for (int j = 0; j < n1; ++j) taps.t1[j] = taps1[j];
  for (int j = 0; j < n2; ++j) taps.t2[j] = taps2[j];
  taps.n1 = n1;
  taps.n2 = n2;
  const int h1 = n1 / 2, h2 = n2 / 2;
  const int RA = kTile + 2 * (h1 + h2), R = kTile + 2 * h2;
  const size_t smem =
      ((size_t)(2 * RA + 4 * R) * K + RA + n1 + n2) * sizeof(float);
  cudaError_t e = llsm::allow_smem(denoise_stats_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + kTile - 1) / kTile, B);
  denoise_stats_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      a, p, cyc_c, mask, voiced, pp, gd, cre, cim, csr, csi, N, K, taps,
      complex_input);
  return (int)cudaGetLastError();
}
