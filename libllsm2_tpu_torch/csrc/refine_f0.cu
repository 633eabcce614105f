// F0 refinement by the fundamental's phase slope on a lowpass-decimated
// signal (harmonics.refine_f0, its decimated branch; kernels.refine_f0_dec):
//   xd[b, m]  = sum_{t = 0..ntaps-1} h[t] x[b, m D + t - g]   (x zero outside
//               [0, nx); xd[m] zero where m D lies outside [lo, hi): a frame
//               shard's halo past the signal's edge)
//   frame n   = xd[n nhop_d - C + j], j in [0, Wf), zero outside [0, nxd)
//   probe(o)  = sum_j w((j - o) / hw) xd_j e^{-2 pi i ((j - o) f0s / fs_d)
//               mod 1} at o = C -+ delta_d, w the analysis window of
//               halfwidth hw = clamp(rel_winsize fs_d / (2 f0s), 2, H_d)
//   each of `iters` iterations moves f0s by the wrapped phase error of the
//   two probes over 2 delta_d samples, clamped to f0 (1 +- max_rel_dev) +- 1;
//   the last one also takes harmonic 2's power by the double angle, and a
//   frame whose fundamental lies 12 dB under harmonic 2 (below pass_hz)
//   keeps its F0; unvoiced frames give 0.
//
// The JAX package has no Pallas kernel here (libllsm2_tpu/ops/harmonics.py:
// 372-468, jnp that XLA fuses).  The plain version's FIR is Qh batched
// products, which cuBLAS orders by the shape of the call, and its probe
// sums are PyTorch reductions over [B, N, Wf]: a row's F0 then depends on
// its batch and a frame shard's block on its length.  Here every sum runs
// in an order set by the row and the frame alone: a row alone, a row in
// any batch and a frame of a shard's block give the same bits.
//
// Bound on the H100: the probes' arithmetic (a window and a sincos a
// sample of each probe's window support, 2 iters x 2 probes a voiced frame,
// 204800 frames at the bench shape) and the FIR's (97 taps an output), then
// reading x once.  Design, two kernels in one call:
//   - FIR: a block of 256 outputs of one row stages the x samples they
//     read (255 D + ntaps) and the taps in shared memory, one word of
//     padding after every 32 (a warp's reads at stride D then fall in
//     distinct banks); a thread sums its output's taps in increasing t, in
//     float32.
//   - Probes: one warp a (row, frame), 4 warps a block.  The warp stages
//     its frame's Wf decimated samples in shared memory and runs every
//     iteration there, each probe over its window's support [coff -
//     ceil(hw), coff + ceil(hw)] only: lane l sums that span's samples l,
//     l + 32, ... in that order,
//     then a fixed shuffle tree (warp_sum) gives lane 0 the totals, which
//     every lane reads back, so all lanes carry the same F0.  Phases are
//     cycles reduced mod 1 before the trig (rintf: round half to even, as
//     torch.round); the window is windows.window_eval's cosine series (or
//     sine) with its cosines as cospif.
#include "common.cuh"

namespace {

constexpr int kFirOut = 256;        // outputs (threads) a block of the FIR
constexpr int kWarps = 4;           // frames (warps) a block of the probes
constexpr float kTwoPi = 6.283185307179586f;

// Shared-memory slot of staged sample i: a word of padding every 32.
__device__ __forceinline__ int skew(int i) { return i + (i >> 5); }

__global__ void __launch_bounds__(kFirOut)
decimate_kernel(const float* __restrict__ x, const float* __restrict__ taps,
                float* __restrict__ xd, int nx, int nxd, int D, int g,
                int ntaps, long long lo, long long hi) {
  extern __shared__ float sm[];
  float* h = sm;                    // [ntaps]
  float* xs = sm + ntaps;           // (kFirOut - 1) D + ntaps, skewed
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kFirOut;
  const long long s0 = (long long)m0 * D - g;
  const int span = (kFirOut - 1) * D + ntaps;
  const float* xb = x + (long long)b * nx;
  for (int i = threadIdx.x; i < ntaps; i += kFirOut) h[i] = taps[i];
  for (int i = threadIdx.x; i < span; i += kFirOut) {
    const long long s = s0 + i;
    xs[skew(i)] = (s >= 0 && s < nx) ? xb[s] : 0.0f;
  }
  __syncthreads();
  const int m = m0 + threadIdx.x;
  if (m >= nxd) return;
  const int i0 = threadIdx.x * D;
  float acc = 0.0f;
  for (int t = 0; t < ntaps; ++t) acc = fmaf(h[t], xs[skew(i0 + t)], acc);
  const long long pos = (long long)m * D;
  xd[(long long)b * nxd + m] = (pos >= lo && pos < hi) ? acc : 0.0f;
}

struct Probe {
  int Wf, C, delta_d, iters;
  float H_d, fs_d, dt_d, two_pi_dt, rel_fs, lo_mul, hi_mul, pass_hz;
  float a0, a1, a2, a3;             // cosine-series coefficients
  int ncoef;                        // terms of the series; 0: mltsine
};

// windows.window_eval(name, (n / hw + 1) / 2): a0 + sum_m a_m cos(2 pi m
// u), or sin(pi u) for mltsine
__device__ __forceinline__ float window_at(const Probe& p, float noff,
                                           float hw) {
  const float u = (noff / hw + 1.0f) * 0.5f;
  if (p.ncoef == 0) return (u >= 0.0f && u <= 1.0f) ? sinpif(u) : 0.0f;
  return llsm::cosine_window(u, p.a0, p.a1, p.a2, p.a3, p.ncoef);
}

// Lane 0's warp_sum, read back by every lane.
__device__ __forceinline__ float warp_total(float v) {
  return __shfl_sync(0xffffffffu, llsm::warp_sum(v), 0);
}

// One probe centred at column coff of the staged frame fr -> (phase, power)
// and, with dbl, harmonic 2's power by the double angle.
__device__ __forceinline__ void probe(const Probe& p, const float* fr,
                                      int coff, float d, float hw, bool dbl,
                                      float* ph, float* pw, float* pw2) {
  const int lane = threadIdx.x & 31;
  float re = 0.0f, im = 0.0f, re2 = 0.0f, im2 = 0.0f;
  // the window's support |j - coff| <= hw (the columns past it weigh 0)
  const int reach = (int)ceilf(hw);
  const int j1 = min(p.Wf, coff + reach + 1);
  for (int j = max(coff - reach, 0) + lane; j < j1; j += 32) {
    const float noff = (float)(j - coff);
    const float xw = fr[j] * window_at(p, noff, hw);
    const float q = noff * d;
    float s, c;
    sincospif(2.0f * (q - rintf(q)), &s, &c);
    re = fmaf(c, xw, re);
    im = fmaf(-s, xw, im);
    if (dbl) {
      re2 = fmaf(2.0f * c * c - 1.0f, xw, re2);
      im2 = fmaf(-2.0f * s * c, xw, im2);
    }
  }
  re = warp_total(re);
  im = warp_total(im);
  *ph = atan2f(im, re);
  *pw = re * re + im * im;
  if (dbl) {
    re2 = warp_total(re2);
    im2 = warp_total(im2);
    *pw2 = re2 * re2 + im2 * im2;
  }
}

__global__ void __launch_bounds__(32 * kWarps)
probe_kernel(const float* __restrict__ xd, const float* __restrict__ f0,
             float* __restrict__ out, long long frames, int N, int nxd,
             int nhop_d, Probe p) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long idx = (long long)blockIdx.x * kWarps + warp;
  if (idx >= frames) return;        // the whole warp leaves together
  const long long b = idx / N;
  const int n = (int)(idx - b * N);
  const float f0v = f0[idx];
  if (!(f0v > 0.0f)) {              // unvoiced: the plain version's zero
    if (lane == 0) out[idx] = 0.0f;
    return;
  }
  float* fr = sm + warp * p.Wf;
  const float* xb = xd + b * nxd;
  const long long m0 = (long long)n * nhop_d - p.C;
  for (int j = lane; j < p.Wf; j += 32) {
    const long long m = m0 + j;
    fr[j] = (m >= 0 && m < nxd) ? xb[m] : 0.0f;
  }
  __syncwarp();
  float f0s = f0v, p1 = 0.0f, p2 = 0.0f;
  for (int it = 0; it < p.iters; ++it) {
    const float hw = fminf(fmaxf(p.rel_fs / (2.0f * f0s), 2.0f), p.H_d);
    const float d = f0s / p.fs_d;
    float ph_m, ph_p, pw;
    probe(p, fr, p.C - p.delta_d, d, hw, false, &ph_m, &pw, &p2);
    probe(p, fr, p.C + p.delta_d, d, hw, it == p.iters - 1, &ph_p, &p1,
          &p2);
    const float expected = (kTwoPi * f0s) * p.dt_d;
    float err = ph_p - ph_m - expected;
    err = atan2f(sinf(err), cosf(err));
    const float f0_new = f0s + err / p.two_pi_dt;
    f0s = fminf(fmaxf(f0_new, f0v * p.lo_mul - 1.0f), f0v * p.hi_mul + 1.0f);
  }
  const bool keep = (p1 > 0.0625f * p2) || (2.0f * f0s >= p.pass_hz);
  if (lane == 0) out[idx] = keep ? f0s : f0v;
}

}  // namespace

extern "C" int llsm_refine_f0_dec(
    const float* x, const float* f0, const float* taps, float* xd,
    float* out, int B, int nx, int N, int D, int g, int ntaps, int nhop_d,
    int C, int Wf, int delta_d, int iters, float H_d, float fs_d, float dt_d,
    float two_pi_dt, float rel_fs, float lo_mul, float hi_mul, float pass_hz,
    long long lo, long long hi, float a0, float a1, float a2, float a3,
    int ncoef, void* stream) {
  if (D < 1 || ntaps < 1 || nhop_d < 1 || Wf < 1 || ncoef < 0 || ncoef > 4)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int nxd = nx / D;
  const int span = (kFirOut - 1) * D + ntaps;
  const size_t fir_smem = (size_t)(ntaps + span + span / 32 + 1) *
                          sizeof(float);
  cudaError_t e = llsm::allow_smem(decimate_kernel, fir_smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 fir_grid((unsigned)((nxd + kFirOut - 1) / kFirOut), (unsigned)B);
  decimate_kernel<<<fir_grid, kFirOut, fir_smem, s>>>(x, taps, xd, nx, nxd,
                                                      D, g, ntaps, lo, hi);
  Probe p{Wf,     C,       delta_d, iters,  H_d, fs_d, dt_d, two_pi_dt,
          rel_fs, lo_mul,  hi_mul,  pass_hz, a0,  a1,   a2,   a3,
          ncoef};
  const long long frames = (long long)B * N;
  const size_t probe_smem = (size_t)kWarps * Wf * sizeof(float);
  e = llsm::allow_smem(probe_kernel, probe_smem);
  if (e != cudaSuccess) return (int)e;
  probe_kernel<<<(unsigned)((frames + kWarps - 1) / kWarps), 32 * kWarps,
                 probe_smem, s>>>(xd, f0, out, frames, N, nxd, nhop_d, p);
  return (int)cudaGetLastError();
}
