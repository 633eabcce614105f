// Track denoiser, pass A: per utterance and frame, the phase-aligned complex
// harmonic track c[f,k] (from (ampl, phse), or from the raw complex track
// (re, im) with complex_input), its slow part c_s = taps1 * c along frames,
// the voicing guard (taps1 * voiced > 0.999), the per-frame coherent fit
// r ~ (m0 + m1 (k+1)) c_s of r = c - c_s across k, the incoherent residual
// r_inc, the probe power pp = |r_inc - taps2 * r_inc|^2, and the powers
// |c_s|^2 and |c - c_s|^2 that the floor statistics read.
// Frames outside [0, N) of the SAME utterance enter as zeros; their c_s (the
// FIR's tail) and r_inc = -c_s (zero mask, zero fit) still reach the probe
// FIR of the last h2 frames, as in the TPU kernel.
//
// Replaces libllsm2_tpu/ops/pallas_osc.py: denoise_stats_pallas
// (_denoise_stats_kernel, _denoise_body) and the power terms its caller
// derives (pallas_osc.py:1229-1232).  Bound on the H100: memory -- per
// (frame, k) it reads 3 floats and writes 7, against ~13 + 7 taps of FIR
// and a 7-term reduction over k.  Design: one block per (tile of 64 frames,
// utterance), 16 warps, each warp two rows of 16 lanes, a lane ceil(K/16)
// columns (K = 80: every lane busy).  The block stages the aligned track of
// its frames plus a +-(h1 + h2) halo in shared memory as float2 (zero
// beyond the utterance, so no block reads another batch row; 28% halo at the
// default taps); each fit row then takes its slow track from that buffer
// into registers, reduces its 7 sums over its 16 lanes (4 shuffles each, the
// two rows of a warp together), and writes the row's aligned and slow
// tracks, both powers and r_inc (to a second float2 buffer) at once; the
// probe FIR reads r_inc.  Two barriers; ~98 KB of shared memory a block at
// K = 80, two blocks (32 warps) an SM; no integer division.
//
// denoise_stats_kernel takes K <= 128 and at most 31 taps each with h1 +
// 2 h2 < 64.  Past that (creaky voice's K = 160, a 2 ms hop's 33 + 17
// taps) denoise_stats_wide_kernel runs: the same block, rows and lanes, the
// taps copied into shared memory from device memory, and the K axis in
// chunks of KC <= 128 columns (kernels._denoise_geometry: the widest that
// fits in shared memory beside the halo).  The fit needs a frame's sums
// over all of K before any r_inc, so the block sweeps the chunks twice:
// the first stages each chunk's aligned track, takes its slow track and
// adds the chunk's 7 sums (each reduced over the 16 lanes as above) to the
// row's, chunk by chunk; the second stages each chunk again and writes the
// outputs, r_inc and the probe FIR.  At K <= KC one chunk: the sums'
// order is denoise_stats_kernel's.
#include "common.cuh"

namespace {

constexpr int kTile = 64;                  // frames per block
constexpr int kThreads = 512;
constexpr int kSlots = kThreads / 16;      // rows in flight: 16 lanes a row
constexpr int kMaxTaps = 31;

struct Taps {
  float t1[kMaxTaps];
  float t2[kMaxTaps];
  int n1, n2;
};

// Sum over the 16 lanes of a half warp (every lane of the warp takes part).
__device__ __forceinline__ float half_allsum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int CPL>
__global__ void __launch_bounds__(kThreads, 2)
denoise_stats_kernel(const float* __restrict__ a, const float* __restrict__ p,
                     const float* __restrict__ cyc_c,
                     const float* __restrict__ mask,
                     const float* __restrict__ voiced, float* __restrict__ pp,
                     float* __restrict__ o_cs2, float* __restrict__ o_r2,
                     bool* __restrict__ guard, float* __restrict__ o_cre,
                     float* __restrict__ o_cim, float* __restrict__ o_csr,
                     float* __restrict__ o_csi, int N, int K, Taps taps,
                     int complex_input) {
  extern __shared__ float2 sm2[];
  const int n1 = taps.n1, n2 = taps.n2;
  const int h1 = n1 / 2, h2 = n2 / 2;
  const int RA = kTile + 2 * (h1 + h2);  // aligned rows: frames [-h1-h2, F+h1+h2)
  const int R = kTile + 2 * h2;          // fit rows: frames [-h2, F+h2)
  float2* cbuf = sm2;                    // [RA, K] aligned track
  float2* rbuf = cbuf + RA * K;          // [R, K] incoherent residual
  float* vo = reinterpret_cast<float*>(rbuf + R * K);  // [RA]
  float* t1 = vo + RA;                   // [n1]
  float* t2 = t1 + n1;                   // [n2]
  const int64_t row0 = (int64_t)blockIdx.y * N;  // this utterance's frame 0
  const int f0 = blockIdx.x * kTile;
  const int fa = f0 - h1 - h2;           // frame of aligned row 0
  const int warp = threadIdx.x >> 5, half = (threadIdx.x >> 4) & 1;
  const int sub = threadIdx.x & 15;
  const float inv2pi = 0.15915494309189535f;

  for (int j = threadIdx.x; j < n1; j += kThreads) t1[j] = taps.t1[j];
  for (int j = threadIdx.x; j < n2; j += kThreads) t2[j] = taps.t2[j];
  for (int r = threadIdx.x; r < RA; r += kThreads) {
    const int f = fa + r;
    vo[r] = (f >= 0 && f < N) ? voiced[row0 + f] : 0.0f;
  }
  for (int r = 2 * warp + half; r < RA; r += kSlots) {
    const int f = fa + r;
    const bool in = f >= 0 && f < N;
    const float cy = in ? cyc_c[row0 + f] : 0.0f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int k = sub + 16 * j;
      if (k >= K) continue;
      float2 c = make_float2(0.0f, 0.0f);
      if (in) {
        const int64_t o = (row0 + f) * K + k;
        const float kc = llsm::kmul_c((float)(k + 1), cy);
        float s, cs;
        if (complex_input) {  // (re, im) rotated by e^{-2 pi j (k+1) cyc}
          sincospif(-2.0f * kc, &s, &cs);
          const float x = a[o], y = p[o];
          c = make_float2(x * cs - y * s, x * s + y * cs);
        } else {              // a e^{j (phi - 2 pi (k+1) cyc)}
          sincospif(2.0f * llsm::frac_c(p[o] * inv2pi - kc), &s, &cs);
          c = make_float2(a[o] * cs, a[o] * s);
        }
      }
      cbuf[r * K + k] = c;
    }
  }
  __syncthreads();

  // the fit, two rows a warp: slow track into registers, the 7 sums over
  // the row's 16 lanes, then every per-(frame, k) output of the row
  for (int rb = 2 * warp; rb < R; rb += kSlots) {
    const int r = rb + half;
    const bool act = r < R;
    const int f = f0 - h2 + r;
    const bool in = act && f >= 0 && f < N;
    const bool own = act && r >= h2 && r < h2 + kTile && f < N;
    float sr[CPL], si[CPL], xr[CPL], xi[CPL];
    float a00 = 0.0f, a01 = 0.0f, a11 = 0.0f;
    float b0r = 0.0f, b0i = 0.0f, b1r = 0.0f, b1i = 0.0f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int k = sub + 16 * j;
      sr[j] = si[j] = xr[j] = xi[j] = 0.0f;
      if (!act || k >= K) continue;
      float s_r = 0.0f, s_i = 0.0f;
      for (int t = 0; t < n1; ++t) {
        const float2 v = cbuf[(r + t) * K + k];
        s_r = fmaf(t1[t], v.x, s_r);
        s_i = fmaf(t1[t], v.y, s_i);
      }
      const float2 c = cbuf[(r + h1) * K + k];
      sr[j] = s_r;
      si[j] = s_i;
      xr[j] = c.x;
      xi[j] = c.y;
      const float m = in ? mask[(row0 + f) * K + k] : 0.0f;
      const float kh = (float)(k + 1);
      const float rr = c.x - s_r, ri = c.y - s_i;
      const float pw = (s_r * s_r + s_i * s_i) * m;
      const float crr = (s_r * rr + s_i * ri) * m;  // Re(conj(c_s) r)
      const float cri = (s_r * ri - s_i * rr) * m;  // Im(conj(c_s) r)
      a00 += pw;
      a01 += kh * pw;
      a11 += kh * kh * pw;
      b0r += crr;
      b0i += cri;
      b1r += kh * crr;
      b1i += kh * cri;
    }
    a00 = half_allsum(a00);
    a01 = half_allsum(a01);
    a11 = half_allsum(a11);
    b0r = half_allsum(b0r);
    b0i = half_allsum(b0i);
    b1r = half_allsum(b1r);
    b1i = half_allsum(b1i);
    if (!act) continue;
    const float det = a00 * a11 - a01 * a01;
    const float inv = 1.0f / (det + 1e-5f * a00 * a11 + 1e-12f);
    const float m0r = (a11 * b0r - a01 * b1r) * inv;
    const float m0i = (a11 * b0i - a01 * b1i) * inv;
    const float m1r = (a00 * b1r - a01 * b0r) * inv;
    const float m1i = (a00 * b1i - a01 * b0i) * inv;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int k = sub + 16 * j;
      if (k >= K) continue;
      const float kh = (float)(k + 1);
      const float wr = m0r + m1r * kh, wi = m0i + m1i * kh;
      const float rr = xr[j] - sr[j], ri = xi[j] - si[j];
      rbuf[r * K + k] = make_float2(rr - (wr * sr[j] - wi * si[j]),
                                    ri - (wr * si[j] + wi * sr[j]));
      if (own) {
        const int64_t o = (row0 + f) * K + k;
        o_cre[o] = xr[j];
        o_cim[o] = xi[j];
        o_csr[o] = sr[j];
        o_csi[o] = si[j];
        o_cs2[o] = sr[j] * sr[j] + si[j] * si[j];
        o_r2[o] = rr * rr + ri * ri;
      }
    }
    if (own && sub == 0) {
      float g = 0.0f;
      for (int t = 0; t < n1; ++t) g = fmaf(t1[t], vo[r + t], g);
      guard[row0 + f] = g > 0.999f;
    }
  }
  __syncthreads();

  // probe FIR: this tile's own frames
  for (int fl = 2 * warp + half; fl < kTile; fl += kSlots) {
    const int f = f0 + fl;
    if (f >= N) break;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int k = sub + 16 * j;
      if (k >= K) continue;
      float lr = 0.0f, li = 0.0f;
      for (int t = 0; t < n2; ++t) {
        const float2 v = rbuf[(fl + t) * K + k];
        lr = fmaf(t2[t], v.x, lr);
        li = fmaf(t2[t], v.y, li);
      }
      const float2 c = rbuf[(fl + h2) * K + k];
      const float pr = c.x - lr, pi = c.y - li;
      pp[(row0 + f) * K + k] = pr * pr + pi * pi;
    }
  }
}

// The wide kernel: taps1, taps2 in device memory; KC columns a chunk (a
// multiple of 16).  Dynamic shared memory: cbuf [RA, KC] and rbuf [R, KC]
// float2, then the rows' sums [R, 7] and fit [R, 4], vo [RA], t1 [n1],
// t2 [n2] floats.
__global__ void __launch_bounds__(kThreads)
denoise_stats_wide_kernel(
    const float* __restrict__ a, const float* __restrict__ p,
    const float* __restrict__ cyc_c, const float* __restrict__ mask,
    const float* __restrict__ voiced, float* __restrict__ pp,
    float* __restrict__ o_cs2, float* __restrict__ o_r2,
    bool* __restrict__ guard, float* __restrict__ o_cre,
    float* __restrict__ o_cim, float* __restrict__ o_csr,
    float* __restrict__ o_csi, int N, int K,
    const float* __restrict__ taps1, int n1,
    const float* __restrict__ taps2, int n2, int KC, int complex_input) {
  extern __shared__ float2 sm2[];
  const int h1 = n1 / 2, h2 = n2 / 2;
  const int RA = kTile + 2 * (h1 + h2);
  const int R = kTile + 2 * h2;
  float2* cbuf = sm2;                    // [RA, KC] aligned track
  float2* rbuf = cbuf + RA * KC;         // [R, KC] incoherent residual
  float* sums = reinterpret_cast<float*>(rbuf + R * KC);  // [R, 7]
  float* fit = sums + 7 * R;             // [R, 4]: m0r, m0i, m1r, m1i
  float* vo = fit + 4 * R;               // [RA]
  float* t1 = vo + RA;                   // [n1]
  float* t2 = t1 + n1;                   // [n2]
  const int64_t row0 = (int64_t)blockIdx.y * N;
  const int f0 = blockIdx.x * kTile;
  const int fa = f0 - h1 - h2;
  const int warp = threadIdx.x >> 5, half = (threadIdx.x >> 4) & 1;
  const int sub = threadIdx.x & 15;
  const int cpl = KC / 16;
  const float inv2pi = 0.15915494309189535f;

  for (int j = threadIdx.x; j < n1; j += kThreads) t1[j] = taps1[j];
  for (int j = threadIdx.x; j < n2; j += kThreads) t2[j] = taps2[j];
  for (int j = threadIdx.x; j < 7 * R; j += kThreads) sums[j] = 0.0f;
  for (int r = threadIdx.x; r < RA; r += kThreads) {
    const int f = fa + r;
    vo[r] = (f >= 0 && f < N) ? voiced[row0 + f] : 0.0f;
  }
  // the aligned track of columns [k0, k0 + KC) into cbuf (zero past K and
  // outside the utterance)
  auto stage = [&](int k0) {
    for (int r = 2 * warp + half; r < RA; r += kSlots) {
      const int f = fa + r;
      const bool in = f >= 0 && f < N;
      const float cy = in ? cyc_c[row0 + f] : 0.0f;
      for (int j = 0; j < cpl; ++j) {
        const int kl = sub + 16 * j, k = k0 + kl;
        float2 c = make_float2(0.0f, 0.0f);
        if (in && k < K) {
          const int64_t o = (row0 + f) * K + k;
          const float kc = llsm::kmul_c((float)(k + 1), cy);
          float sn, cs;
          if (complex_input) {
            sincospif(-2.0f * kc, &sn, &cs);
            const float x = a[o], y = p[o];
            c = make_float2(x * cs - y * sn, x * sn + y * cs);
          } else {
            sincospif(2.0f * llsm::frac_c(p[o] * inv2pi - kc), &sn, &cs);
            c = make_float2(a[o] * cs, a[o] * sn);
          }
        }
        cbuf[r * KC + kl] = c;
      }
    }
  };
  // fit row r's slow track at chunk column kl
  auto slow = [&](int r, int kl) {
    float s_r = 0.0f, s_i = 0.0f;
    for (int t = 0; t < n1; ++t) {
      const float2 v = cbuf[(r + t) * KC + kl];
      s_r = fmaf(t1[t], v.x, s_r);
      s_i = fmaf(t1[t], v.y, s_i);
    }
    return make_float2(s_r, s_i);
  };

  // sweep 1: the 7 sums of every fit row, chunk by chunk
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();
    stage(k0);
    __syncthreads();
    for (int rb = 2 * warp; rb < R; rb += kSlots) {
      const int r = rb + half;
      const bool act = r < R;
      const int f = f0 - h2 + r;
      const bool in = act && f >= 0 && f < N;
      float q[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int j = 0; act && j < cpl; ++j) {
        const int kl = sub + 16 * j, k = k0 + kl;
        if (k >= K) break;
        const float2 cs = slow(r, kl);
        const float2 c = cbuf[(r + h1) * KC + kl];
        const float m = in ? mask[(row0 + f) * K + k] : 0.0f;
        const float kh = (float)(k + 1);
        const float rr = c.x - cs.x, ri = c.y - cs.y;
        const float pw = (cs.x * cs.x + cs.y * cs.y) * m;
        const float crr = (cs.x * rr + cs.y * ri) * m;
        const float cri = (cs.x * ri - cs.y * rr) * m;
        q[0] += pw;
        q[1] += kh * pw;
        q[2] += kh * kh * pw;
        q[3] += crr;
        q[4] += cri;
        q[5] += kh * crr;
        q[6] += kh * cri;
      }
#pragma unroll
      for (int i = 0; i < 7; ++i) q[i] = half_allsum(q[i]);
      if (act && sub == 0) {
#pragma unroll
        for (int i = 0; i < 7; ++i) sums[7 * r + i] += q[i];
        const bool own = r >= h2 && r < h2 + kTile && f < N;
        if (own && k0 == 0) {
          float g = 0.0f;
          for (int t = 0; t < n1; ++t) g = fmaf(t1[t], vo[r + t], g);
          guard[row0 + f] = g > 0.999f;
        }
      }
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const float* q = sums + 7 * r;
    const float a00 = q[0], a01 = q[1], a11 = q[2];
    const float det = a00 * a11 - a01 * a01;
    const float inv = 1.0f / (det + 1e-5f * a00 * a11 + 1e-12f);
    fit[4 * r] = (a11 * q[3] - a01 * q[5]) * inv;
    fit[4 * r + 1] = (a11 * q[4] - a01 * q[6]) * inv;
    fit[4 * r + 2] = (a00 * q[5] - a01 * q[3]) * inv;
    fit[4 * r + 3] = (a00 * q[6] - a01 * q[4]) * inv;
  }

  // sweep 2: every output, r_inc and the probe FIR, chunk by chunk
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();
    stage(k0);
    __syncthreads();
    for (int r = 2 * warp + half; r < R; r += kSlots) {
      const int f = f0 - h2 + r;
      const bool own = r >= h2 && r < h2 + kTile && f < N;
      const float m0r = fit[4 * r], m0i = fit[4 * r + 1];
      const float m1r = fit[4 * r + 2], m1i = fit[4 * r + 3];
      for (int j = 0; j < cpl; ++j) {
        const int kl = sub + 16 * j, k = k0 + kl;
        if (k >= K) break;
        const float2 cs = slow(r, kl);
        const float2 c = cbuf[(r + h1) * KC + kl];
        const float kh = (float)(k + 1);
        const float wr = m0r + m1r * kh, wi = m0i + m1i * kh;
        const float rr = c.x - cs.x, ri = c.y - cs.y;
        rbuf[r * KC + kl] = make_float2(rr - (wr * cs.x - wi * cs.y),
                                        ri - (wr * cs.y + wi * cs.x));
        if (own) {
          const int64_t o = (row0 + f) * K + k;
          o_cre[o] = c.x;
          o_cim[o] = c.y;
          o_csr[o] = cs.x;
          o_csi[o] = cs.y;
          o_cs2[o] = cs.x * cs.x + cs.y * cs.y;
          o_r2[o] = rr * rr + ri * ri;
        }
      }
    }
    __syncthreads();
    for (int fl = 2 * warp + half; fl < kTile; fl += kSlots) {
      const int f = f0 + fl;
      if (f >= N) break;
      for (int j = 0; j < cpl; ++j) {
        const int kl = sub + 16 * j, k = k0 + kl;
        if (k >= K) break;
        float lr = 0.0f, li = 0.0f;
        for (int t = 0; t < n2; ++t) {
          const float2 v = rbuf[(fl + t) * KC + kl];
          lr = fmaf(t2[t], v.x, lr);
          li = fmaf(t2[t], v.y, li);
        }
        const float2 c = rbuf[(fl + h2) * KC + kl];
        const float pr = c.x - lr, pi = c.y - li;
        pp[(row0 + f) * K + k] = pr * pr + pi * pi;
      }
    }
  }
}

template <int CPL>
int launch(const float* a, const float* p, const float* cyc_c,
           const float* mask, const float* voiced, float* pp, float* cs2,
           float* r2, bool* gd, float* cre, float* cim, float* csr,
           float* csi, int B, int N, int K, const Taps& taps,
           int complex_input, cudaStream_t stream) {
  const int h1 = taps.n1 / 2, h2 = taps.n2 / 2;
  const int RA = kTile + 2 * (h1 + h2), R = kTile + 2 * h2;
  const size_t smem = (size_t)(RA + R) * K * sizeof(float2) +
                      (size_t)(RA + taps.n1 + taps.n2) * sizeof(float);
  cudaError_t e = llsm::allow_smem(denoise_stats_kernel<CPL>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + kTile - 1) / kTile, B);
  denoise_stats_kernel<CPL><<<grid, kThreads, smem, stream>>>(
      a, p, cyc_c, mask, voiced, pp, cs2, r2, gd, cre, cim, csr, csi, N, K,
      taps, complex_input);
  return (int)cudaGetLastError();
}

}  // namespace

// taps1, taps2: the float32 taps on the host (denoise_stats_kernel reads
// them as a kernel argument) and the same in device memory (taps1_d,
// taps2_d: the wide kernel's); kc: the wide kernel's chunk
// (kernels._denoise_geometry), 0 for denoise_stats_kernel
extern "C" int llsm_denoise_stats(const float* a, const float* p,
                                  const float* cyc_c, const float* mask,
                                  const float* voiced, float* pp, float* cs2,
                                  float* r2, bool* gd, float* cre, float* cim,
                                  float* csr, float* csi, int B, int N, int K,
                                  const float* taps1, int n1,
                                  const float* taps2, int n2,
                                  const float* taps1_d, const float* taps2_d,
                                  int kc, int complex_input, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (kc > 0) {
    if (n1 < 1 || n2 < 1 || kc % 16 || kc > 128 || !taps1_d || !taps2_d)
      return (int)cudaErrorInvalidValue;
    if (B <= 0 || N <= 0 || K <= 0) return (int)cudaGetLastError();
    const int h1 = n1 / 2, h2 = n2 / 2;
    const int RA = kTile + 2 * (h1 + h2), R = kTile + 2 * h2;
    const size_t smem = (size_t)(RA + R) * kc * sizeof(float2) +
                        (size_t)(11 * R + RA + n1 + n2) * sizeof(float);
    cudaError_t e = llsm::allow_smem(denoise_stats_wide_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((N + kTile - 1) / kTile, B);
    denoise_stats_wide_kernel<<<grid, kThreads, smem, st>>>(
        a, p, cyc_c, mask, voiced, pp, cs2, r2, gd, cre, cim, csr, csi, N, K,
        taps1_d, n1, taps2_d, n2, kc, complex_input);
    return (int)cudaGetLastError();
  }
  if (n1 < 1 || n2 < 1 || n1 > kMaxTaps || n2 > kMaxTaps ||
      n1 / 2 + 2 * (n2 / 2) >= kTile || K > 16 * 8)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || N <= 0 || K <= 0) return (int)cudaGetLastError();
  Taps taps{};
  for (int j = 0; j < n1; ++j) taps.t1[j] = taps1[j];
  for (int j = 0; j < n2; ++j) taps.t2[j] = taps2[j];
  taps.n1 = n1;
  taps.n2 = n2;
#define LLSM_DS(C)                                                          \
  case C:                                                                   \
    return launch<C>(a, p, cyc_c, mask, voiced, pp, cs2, r2, gd, cre, cim,  \
                     csr, csi, B, N, K, taps, complex_input, st)
  switch ((K + 15) / 16) {
    LLSM_DS(1); LLSM_DS(2); LLSM_DS(3); LLSM_DS(4);
    LLSM_DS(5); LLSM_DS(6); LLSM_DS(7); LLSM_DS(8);
  }
#undef LLSM_DS
  return (int)cudaErrorInvalidValue;
}
