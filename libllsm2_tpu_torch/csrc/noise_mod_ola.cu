// Noise synthesis from the shaped spectra to the signal: per-band inverse
// real DFT with the sqrt-Hann synthesis window, hop-pair OLA, temporal-
// envelope modulation and band sum, in one launch.
//
// For utterance b, frame i, band c, segment sample u in [0, T), T = 2 nhop,
// nbin = nhop + 1 (bins of band c form one contiguous range [lo_c, hi_c)):
//   S_i[k]     = (re[k] sc[k] + j im[k] sc'[k]) gain[b, i, k] wb[k]
//   seg_ic[u]  = w[u] Re sum_{k in c} S_i[k] e^{2 pi j k u / T}
//   ola_ic[t]  = seg_ic[nhop + t] + (i + 1 < N ? seg_(i+1)c[t] : 0)
//   y[b, i nhop + t] = sum_c ola_ic[t] max(env_c, 0) / max(lerp(base_c), 1e-8)
// with sc = sqrt(T/2) (sqrt(T) at DC and Nyquist), sc' = sc but 0 at DC and
// Nyquist, wb = 2/T (1/T at DC and Nyquist), w[u] = sqrt(0.5 - 0.5 cos(2 pi
// (u + 1/2) / T)), and env_c the band's temporal envelope at the sample
// (lerp of edc, ar, ai between frames i and i + 1 against z^k = e^{2 pi j k
// cyc}, k = 1..Ke; the last frame holds constant), as env_render.cu.
//
// Replaces libllsm2_tpu/ops/pallas_osc.py: noise_mod_ola_pallas
// (_noise_mod_kernel) together with the band iDFT that feeds it
// (libllsm2_tpu/models/layer0.py: _band_segments, matmul branch): the
// [B, C, N, T] segments never reach device memory.  Bound on the H100:
// float32 operations (the iDFT's nbin terms a segment sample, the
// envelope's C (Ke + 1) lerp-and-rotate steps a sample) against reading
// the spectra, gains and coefficients and writing y once.
//
// Design: one block per (tile of kHops hops, utterance); the block stages
// the kHops + 1 frames' spectra (pre-scaled, each band's bins from an even
// bin, zero-padded), their envelope coefficients, the T-entry table of
// e^{2 pi j m / T} and the window in shared memory.  Pass 1 takes the
// half-period symmetry e^{2 pi j k (t + nhop) / T} = (-1)^k e^{2 pi j k t /
// T}: for t < nhop a thread sums a band's even bins (E) and odd bins (O) of
// 4 frames at two samples t, so seg[t] = w[t] (E + O) and seg[nhop + t] =
// w[nhop + t] (E - O) come from nbin terms of 2 FMAs each; its z = e^{2 pi
// j k t / T} steps by one rotation a bin and restarts every 16 bins from
// the table at the exact integer index (k t) mod T.  Pass 2, a thread 4
// samples of one hop: each band's lerp coefficients loaded once for the 4,
// z^k by rotation from e^{2 pi j cyc}, the OLA from pass 1's (E, O), the
// modulation and the band sum; coalesced stores.  The register blocking
// of both passes is there because shared-memory loads, not arithmetic,
// bound a layout of one t and one sample a thread (a load a bin a frame,
// ~90 loads a sample).  No 64-bit division.
//
// noise_mod_kernel takes nhop <= 256 (a pass-1 thread a sample pair of a
// frame group), C <= 8 bands and Ke <= 8 (its band table is a kernel
// argument).  Past any of them (48 kHz at a 10 ms hop: nhop = 480)
// noise_wide_kernel runs the same two passes with F frames a block (F - 1
// output hops; kernels._noise_geometry takes the largest F of 16, 12, 8, 4
// whose [F, C, nhop] (E, O) buffer and staged spectra fit in shared
// memory), each thread looping over pass 1's sample pairs, and the band
// table (each band's bins, first even bin, first slot and slot count) in
// shared memory, made from the 2 C band ranges in device memory.
#include "common.cuh"

// LLSM_SKIP_PASS_{A,B} = 1 compiles pass 1 or pass 2 out, for the pass
// timings of scripts/port_kernel_passes.py; the library leaves both 0.
#ifndef LLSM_SKIP_PASS_A
#define LLSM_SKIP_PASS_A 0
#endif
#ifndef LLSM_SKIP_PASS_B
#define LLSM_SKIP_PASS_B 0
#endif

namespace {

constexpr int kHops = 15;           // output hops a block
constexpr int kFrames = kHops + 1;  // frames whose segments they need
constexpr int kGroup = 4;           // frames a pass-1 thread
constexpr int kGroups = kFrames / kGroup;
constexpr int kSamples = 4;         // samples a pass-2 thread
constexpr int kMaxC = 8;
constexpr int kMaxKe = 8;
constexpr int kRestart = 16;        // bins between exact table restarts
constexpr int kMaxThreads = 512;    // kGroups x ceil(nhop / 2), nhop <= 256

struct Bands {
  int C;
  int Ltot;                 // staged slots a frame
  int base[kMaxC];          // first (even) bin of each band's slots
  int lo[kMaxC], hi[kMaxC]; // the band's bins [lo, hi)
  int off[kMaxC];           // its first slot
  int plen[kMaxC];          // its slot count (even)
};

__device__ __forceinline__ void rotate(float& zr, float& zi, float rr,
                                       float ri) {
  const float nr = zr * rr - zi * ri;
  zi = zr * ri + zi * rr;
  zr = nr;
}

__global__ void __launch_bounds__(kMaxThreads)
noise_mod_kernel(const float* __restrict__ cyc, const float* __restrict__ edc,
                 const float* __restrict__ ar, const float* __restrict__ ai,
                 const float* __restrict__ base, const float* __restrict__ re,
                 const float* __restrict__ im, int64_t spec_bstride,
                 const float* __restrict__ gain, float* __restrict__ y, int N,
                 int nhop, int Ke, Bands bd) {
  extern __shared__ float sm[];
  const int C = bd.C, T = 2 * nhop, nbin = nhop + 1, L = bd.Ltot;
  const int CK = C * Ke;
  float2* spec = reinterpret_cast<float2*>(sm);       // [kFrames, L]
  float2* eo = spec + kFrames * L;                     // [kFrames, C, nhop]
  float* tc = reinterpret_cast<float*>(eo + kFrames * C * nhop);  // [T]
  float* ts = tc + T;                                  // [T]
  float* win = ts + T;                                 // [T]
  float* s_edc = win + T;                              // [kFrames, C]
  float* s_base = s_edc + kFrames * C;
  float* s_ar = s_base + kFrames * C;                  // [kFrames, C, Ke]
  float* s_ai = s_ar + kFrames * CK;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kHops;
  const int64_t row0 = (int64_t)b * N;

  for (int m = threadIdx.x; m < T; m += blockDim.x) {
    float s, c;
    sincospif(__fdiv_rn(2.0f * (float)m, (float)T), &s, &c);
    tc[m] = c;
    ts[m] = s;
    win[m] = sqrtf(0.5f - 0.5f * cospif(__fdiv_rn(2.0f * (float)m + 1.0f,
                                                  (float)T)));
  }
  // each staged slot's bin (-1 outside its band), then the spectra and
  // coefficients of the kFrames frames, every thread's loads in flight
  // together (unrolled; no frame-by-frame latency)
  int* s_bin = reinterpret_cast<int*>(s_ai + kFrames * CK);     // [L]
  for (int slot = threadIdx.x; slot < L; slot += blockDim.x) {
    int c = 0;
    while (c + 1 < C && slot >= bd.off[c + 1]) ++c;
    const int k = bd.base[c] + slot - bd.off[c];
    s_bin[slot] = (k >= bd.lo[c] && k < bd.hi[c]) ? k : -1;
  }
  const int W = 2 * C + 2 * CK;
  {
    const int dj = blockDim.x / W, dq = blockDim.x - dj * W;
    int j = threadIdx.x / W, q = threadIdx.x - j * W;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < kFrames * W; idx += blockDim.x) {
      const int64_t fr = row0 + min(f0 + j, N - 1);
      float* dst;
      const float* src;
      if (q < C) {
        dst = s_edc + j * C + q;
        src = edc + fr * C + q;
      } else if (q < 2 * C) {
        dst = s_base + j * C + q - C;
        src = base + fr * C + q - C;
      } else if (q < 2 * C + CK) {
        dst = s_ar + j * CK + q - 2 * C;
        src = ar + fr * CK + q - 2 * C;
      } else {
        dst = s_ai + j * CK + q - 2 * C - CK;
        src = ai + fr * CK + q - 2 * C - CK;
      }
      *dst = __ldg(src);
      j += dj;
      q += dq;
      if (q >= W) {
        q -= W;
        ++j;
      }
    }
  }
  __syncthreads();
  const float ends = 1.0f / sqrtf((float)T);     // (1/T) sqrt(T)
  const float mid = sqrtf(2.0f / (float)T);      // (2/T) sqrt(T/2)
  if (L > 0) {
    const int dj = blockDim.x / L, ds = blockDim.x - dj * L;
    int j = threadIdx.x / L, slot = threadIdx.x - j * L;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < kFrames * L; idx += blockDim.x) {
      const int f = f0 + j, k = s_bin[slot];
      float2 v = make_float2(0.0f, 0.0f);
      if (f < N && k >= 0) {
        const int64_t o = spec_bstride * b + (int64_t)f * nbin + k;
        const float g = __ldg(gain + (row0 + f) * nbin + k);
        const bool edge = k == 0 || k == nbin - 1;
        v.x = __ldg(re + o) * g * (edge ? ends : mid);
        v.y = edge ? 0.0f : __ldg(im + o) * g * mid;
      }
      spec[idx] = v;
      j += dj;
      slot += ds;
      if (slot >= L) {
        slot -= L;
        ++j;
      }
    }
  }
  __syncthreads();

  // pass 1: (E, O) of kGroup frames at two samples ta, tb = ta + half of
  // the first half-segment, band by band; each staged bin feeds 4 FMAs
  const int half = (nhop + 1) >> 1;
  if (!LLSM_SKIP_PASS_A && threadIdx.x < kGroups * half) {
    const int g = threadIdx.x / half, ta = threadIdx.x - g * half;
    const bool has_b = ta + half < nhop;
    const int tb = has_b ? ta + half : ta;    // odd nhop: a duplicate
    const float rar = tc[ta], rai = ts[ta];   // e^{2 pi j t / T}
    const float rbr = tc[tb], rbi = ts[tb];
    const int stepa = (kRestart * ta) % T, stepb = (kRestart * tb) % T;
    const float2* sp = spec + g * kGroup * L;
    for (int c = 0; c < C; ++c) {
      float ea[kGroup], oa[kGroup], eb[kGroup], ob[kGroup];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) ea[q] = oa[q] = eb[q] = ob[q] = 0.0f;
      int ma = (bd.base[c] * ta) % T, mb = (bd.base[c] * tb) % T;
      const int off = bd.off[c], plen = bd.plen[c];
      for (int s0 = 0; s0 < plen; s0 += kRestart) {
        float zar = tc[ma], zai = ts[ma], zbr = tc[mb], zbi = ts[mb];
        const int n = min(kRestart, plen - s0);
        for (int p = 0; p < n; p += 2) {
          const int sl = off + s0 + p;
#pragma unroll
          for (int q = 0; q < kGroup; ++q) {
            const float2 v = sp[q * L + sl];
            ea[q] = fmaf(v.x, zar, fmaf(-v.y, zai, ea[q]));
            eb[q] = fmaf(v.x, zbr, fmaf(-v.y, zbi, eb[q]));
          }
          rotate(zar, zai, rar, rai);
          rotate(zbr, zbi, rbr, rbi);
#pragma unroll
          for (int q = 0; q < kGroup; ++q) {
            const float2 v = sp[q * L + sl + 1];
            oa[q] = fmaf(v.x, zar, fmaf(-v.y, zai, oa[q]));
            ob[q] = fmaf(v.x, zbr, fmaf(-v.y, zbi, ob[q]));
          }
          rotate(zar, zai, rar, rai);
          rotate(zbr, zbi, rbr, rbi);
        }
        ma += stepa;
        if (ma >= T) ma -= T;
        mb += stepb;
        if (mb >= T) mb -= T;
      }
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        float2* e = eo + ((g * kGroup + q) * C + c) * nhop;
        e[ta] = make_float2(ea[q], oa[q]);
        if (has_b) e[tb] = make_float2(eb[q], ob[q]);
      }
    }
  }
  __syncthreads();

  // pass 2: a thread kSamples samples t0 + r q4 of one hop, each band's
  // lerp coefficients loaded once for them; z^k by rotation from z
  const int nh = min(kHops, N - f0);
  const int q4 = (nhop + kSamples - 1) / kSamples;
  const float inv_hop = 1.0f / (float)nhop;
  for (int idx = threadIdx.x; !LLSM_SKIP_PASS_B && idx < nh * q4;
       idx += blockDim.x) {
    const int i = idx / q4, t0 = idx - i * q4;
    const bool partner = f0 + i + 1 < N;
    const int64_t g0 = (row0 + f0 + i) * nhop;
    float c1[kSamples], s1[kSamples], sv[kSamples], acc[kSamples];
    float wa[kSamples], wb[kSamples];
    int tt[kSamples];
#pragma unroll
    for (int r = 0; r < kSamples; ++r) {
      const int t = t0 + r * q4;
      tt[r] = t < nhop ? t : t0;
      sincospif(2.0f * llsm::frac_c(cyc[g0 + tt[r]]), &s1[r], &c1[r]);
      sv[r] = (float)tt[r] * inv_hop;
      wa[r] = win[nhop + tt[r]];
      wb[r] = partner ? win[tt[r]] : 0.0f;
      acc[r] = 0.0f;
    }
    for (int c = 0; c < C; ++c) {
      const float e0 = s_edc[i * C + c], de = s_edc[(i + 1) * C + c] - e0;
      const float b0 = s_base[i * C + c], db = s_base[(i + 1) * C + c] - b0;
      float env[kSamples], zr[kSamples], zi[kSamples];
#pragma unroll
      for (int r = 0; r < kSamples; ++r) {
        env[r] = fmaf(de, sv[r], e0);
        zr[r] = c1[r];
        zi[r] = s1[r];
      }
      const float* a0 = s_ar + i * CK + c * Ke;
      const float* p0 = s_ai + i * CK + c * Ke;
      for (int k = 0; k < Ke; ++k) {
        const float a = a0[k], da = a0[CK + k] - a;
        const float p = p0[k], dp = p0[CK + k] - p;
#pragma unroll
        for (int r = 0; r < kSamples; ++r) {
          env[r] += fmaf(da, sv[r], a) * zr[r] - fmaf(dp, sv[r], p) * zi[r];
          rotate(zr[r], zi[r], c1[r], s1[r]);
        }
      }
      const float2* e = eo + (i * C + c) * nhop;
#pragma unroll
      for (int r = 0; r < kSamples; ++r) {
        const float2 cur = e[tt[r]];
        float ola = wa[r] * (cur.x - cur.y);
        if (partner) {
          const float2 nxt = e[C * nhop + tt[r]];
          ola = fmaf(wb[r], nxt.x + nxt.y, ola);
        }
        const float bl = fmaf(db, sv[r], b0);
        acc[r] = fmaf(ola, __fdividef(fmaxf(env[r], 0.0f), fmaxf(bl, 1e-8f)),
                      acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kSamples; ++r)
      if (t0 + r * q4 < nhop) y[g0 + t0 + r * q4] = acc[r];
  }
}

constexpr int kWideThreads = 512;

// nhop > 256, C > 8 or Ke > 8: noise_mod_kernel's passes at F frames a
// block (F - 1 output hops, F a multiple of kGroup), L staged slots a frame;
// bands [2 C] in device memory.  Dynamic shared memory as noise_mod_kernel's
// at F frames, then the band table [5, C] ints.
__global__ void __launch_bounds__(kWideThreads)
noise_wide_kernel(const float* __restrict__ cyc, const float* __restrict__ edc,
                  const float* __restrict__ ar, const float* __restrict__ ai,
                  const float* __restrict__ base,
                  const float* __restrict__ re, const float* __restrict__ im,
                  int64_t spec_bstride, const float* __restrict__ gain,
                  const int* __restrict__ bands, float* __restrict__ y,
                  int N, int nhop, int C, int Ke, int L, int F) {
  extern __shared__ float sm[];
  const int T = 2 * nhop, nbin = nhop + 1, CK = C * Ke, H = F - 1;
  float2* spec = reinterpret_cast<float2*>(sm);       // [F, L]
  float2* eo = spec + F * L;                           // [F, C, nhop]
  float* tc = reinterpret_cast<float*>(eo + F * C * nhop);  // [T]
  float* ts = tc + T;                                  // [T]
  float* win = ts + T;                                 // [T]
  float* s_edc = win + T;                              // [F, C]
  float* s_base = s_edc + F * C;
  float* s_ar = s_base + F * C;                        // [F, C, Ke]
  float* s_ai = s_ar + F * CK;
  int* s_bin = reinterpret_cast<int*>(s_ai + F * CK);  // [L]
  int* b_lo = s_bin + L;                               // [C] each
  int* b_hi = b_lo + C;
  int* b_base = b_hi + C;
  int* b_off = b_base + C;
  int* b_plen = b_off + C;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * H;
  const int64_t row0 = (int64_t)b * N;

  if (threadIdx.x == 0) {
    int off = 0;
    for (int c = 0; c < C; ++c) {
      const int lo = bands[2 * c], hi = bands[2 * c + 1];
      b_lo[c] = lo;
      b_hi[c] = hi;
      b_base[c] = lo & ~1;
      b_off[c] = off;
      b_plen[c] = hi > lo ? ((hi - b_base[c] + 1) & ~1) : 0;
      off += b_plen[c];
    }
  }
  for (int m = threadIdx.x; m < T; m += blockDim.x) {
    float sn, c;
    sincospif(__fdiv_rn(2.0f * (float)m, (float)T), &sn, &c);
    tc[m] = c;
    ts[m] = sn;
    win[m] = sqrtf(0.5f - 0.5f * cospif(__fdiv_rn(2.0f * (float)m + 1.0f,
                                                  (float)T)));
  }
  for (int idx = threadIdx.x; idx < F * C; idx += blockDim.x) {
    const int64_t fr = row0 + min(f0 + idx / C, N - 1);
    const int c = idx % C;
    s_edc[idx] = __ldg(edc + fr * C + c);
    s_base[idx] = __ldg(base + fr * C + c);
  }
  for (int idx = threadIdx.x; idx < F * CK; idx += blockDim.x) {
    const int64_t fr = row0 + min(f0 + idx / CK, N - 1);
    const int q = idx % CK;
    s_ar[idx] = __ldg(ar + fr * CK + q);
    s_ai[idx] = __ldg(ai + fr * CK + q);
  }
  __syncthreads();
  for (int slot = threadIdx.x; slot < L; slot += blockDim.x) {
    int c = 0;
    while (c + 1 < C && slot >= b_off[c + 1]) ++c;
    const int k = b_base[c] + slot - b_off[c];
    s_bin[slot] = (k >= b_lo[c] && k < b_hi[c]) ? k : -1;
  }
  __syncthreads();
  const float ends = 1.0f / sqrtf((float)T);
  const float mid = sqrtf(2.0f / (float)T);
  for (int idx = threadIdx.x; idx < F * L; idx += blockDim.x) {
    const int j = idx / L, slot = idx - j * L;
    const int f = f0 + j, k = s_bin[slot];
    float2 v = make_float2(0.0f, 0.0f);
    if (f < N && k >= 0) {
      const int64_t o = spec_bstride * b + (int64_t)f * nbin + k;
      const float g = __ldg(gain + (row0 + f) * nbin + k);
      const bool edge = k == 0 || k == nbin - 1;
      v.x = __ldg(re + o) * g * (edge ? ends : mid);
      v.y = edge ? 0.0f : __ldg(im + o) * g * mid;
    }
    spec[idx] = v;
  }
  __syncthreads();

  // pass 1 as noise_mod_kernel's, each thread looping over the (frame
  // group, sample pair) items
  const int half = (nhop + 1) >> 1;
  for (int w = threadIdx.x; !LLSM_SKIP_PASS_A && w < (F / kGroup) * half;
       w += blockDim.x) {
    const int g = w / half, ta = w - g * half;
    const bool has_b = ta + half < nhop;
    const int tb = has_b ? ta + half : ta;
    const float rar = tc[ta], rai = ts[ta];
    const float rbr = tc[tb], rbi = ts[tb];
    const int stepa = (kRestart * ta) % T, stepb = (kRestart * tb) % T;
    const float2* sp = spec + g * kGroup * L;
    for (int c = 0; c < C; ++c) {
      float ea[kGroup], oa[kGroup], eb[kGroup], ob[kGroup];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) ea[q] = oa[q] = eb[q] = ob[q] = 0.0f;
      int ma = (int)(((int64_t)b_base[c] * ta) % T);
      int mb = (int)(((int64_t)b_base[c] * tb) % T);
      const int off = b_off[c], plen = b_plen[c];
      for (int s0 = 0; s0 < plen; s0 += kRestart) {
        float zar = tc[ma], zai = ts[ma], zbr = tc[mb], zbi = ts[mb];
        const int n = min(kRestart, plen - s0);
        for (int p = 0; p < n; p += 2) {
          const int sl = off + s0 + p;
#pragma unroll
          for (int q = 0; q < kGroup; ++q) {
            const float2 v = sp[q * L + sl];
            ea[q] = fmaf(v.x, zar, fmaf(-v.y, zai, ea[q]));
            eb[q] = fmaf(v.x, zbr, fmaf(-v.y, zbi, eb[q]));
          }
          rotate(zar, zai, rar, rai);
          rotate(zbr, zbi, rbr, rbi);
#pragma unroll
          for (int q = 0; q < kGroup; ++q) {
            const float2 v = sp[q * L + sl + 1];
            oa[q] = fmaf(v.x, zar, fmaf(-v.y, zai, oa[q]));
            ob[q] = fmaf(v.x, zbr, fmaf(-v.y, zbi, ob[q]));
          }
          rotate(zar, zai, rar, rai);
          rotate(zbr, zbi, rbr, rbi);
        }
        ma += stepa;
        if (ma >= T) ma -= T;
        mb += stepb;
        if (mb >= T) mb -= T;
      }
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        float2* e = eo + ((g * kGroup + q) * C + c) * nhop;
        e[ta] = make_float2(ea[q], oa[q]);
        if (has_b) e[tb] = make_float2(eb[q], ob[q]);
      }
    }
  }
  __syncthreads();

  // pass 2 as noise_mod_kernel's
  const int nh = min(H, N - f0);
  const int q4 = (nhop + kSamples - 1) / kSamples;
  const float inv_hop = 1.0f / (float)nhop;
  for (int idx = threadIdx.x; !LLSM_SKIP_PASS_B && idx < nh * q4;
       idx += blockDim.x) {
    const int i = idx / q4, t0 = idx - i * q4;
    const bool partner = f0 + i + 1 < N;
    const int64_t g0 = (row0 + f0 + i) * nhop;
    float c1[kSamples], s1[kSamples], sv[kSamples], acc[kSamples];
    float wa[kSamples], wb[kSamples];
    int tt[kSamples];
#pragma unroll
    for (int r = 0; r < kSamples; ++r) {
      const int t = t0 + r * q4;
      tt[r] = t < nhop ? t : t0;
      sincospif(2.0f * llsm::frac_c(cyc[g0 + tt[r]]), &s1[r], &c1[r]);
      sv[r] = (float)tt[r] * inv_hop;
      wa[r] = win[nhop + tt[r]];
      wb[r] = partner ? win[tt[r]] : 0.0f;
      acc[r] = 0.0f;
    }
    for (int c = 0; c < C; ++c) {
      const float e0 = s_edc[i * C + c], de = s_edc[(i + 1) * C + c] - e0;
      const float b0 = s_base[i * C + c], db = s_base[(i + 1) * C + c] - b0;
      float env[kSamples], zr[kSamples], zi[kSamples];
#pragma unroll
      for (int r = 0; r < kSamples; ++r) {
        env[r] = fmaf(de, sv[r], e0);
        zr[r] = c1[r];
        zi[r] = s1[r];
      }
      const float* a0 = s_ar + i * CK + c * Ke;
      const float* p0 = s_ai + i * CK + c * Ke;
      for (int k = 0; k < Ke; ++k) {
        const float a = a0[k], da = a0[CK + k] - a;
        const float p = p0[k], dp = p0[CK + k] - p;
#pragma unroll
        for (int r = 0; r < kSamples; ++r) {
          env[r] += fmaf(da, sv[r], a) * zr[r] - fmaf(dp, sv[r], p) * zi[r];
          rotate(zr[r], zi[r], c1[r], s1[r]);
        }
      }
      const float2* e = eo + (i * C + c) * nhop;
#pragma unroll
      for (int r = 0; r < kSamples; ++r) {
        const float2 cur = e[tt[r]];
        float ola = wa[r] * (cur.x - cur.y);
        if (partner) {
          const float2 nxt = e[C * nhop + tt[r]];
          ola = fmaf(wb[r], nxt.x + nxt.y, ola);
        }
        const float bl = fmaf(db, sv[r], b0);
        acc[r] = fmaf(ola, __fdividef(fmaxf(env[r], 0.0f), fmaxf(bl, 1e-8f)),
                      acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kSamples; ++r)
      if (t0 + r * q4 < nhop) y[g0 + t0 + r * q4] = acc[r];
  }
}

}  // namespace

// bands: 2 C ints on the host, each band's bin range [lo, hi) (lo = hi for
// an empty band), and the same in device memory (bands_d, read by the wide
// kernel); F: the wide kernel's frames a block (kernels._noise_geometry),
// 0 for noise_mod_kernel.
extern "C" int llsm_noise_mod_ola(const float* cyc, const float* edc,
                                  const float* ar, const float* ai,
                                  const float* base, const float* re,
                                  const float* im, long long spec_bstride,
                                  const float* gain, const int* bands,
                                  const int* bands_d, float* y, int B, int N,
                                  int nhop, int C, int Ke, int F,
                                  void* stream) {
  if (F > 0) {
    if (nhop <= 0 || C <= 0 || Ke < 0 || F % kGroup || !bands_d)
      return (int)cudaErrorInvalidValue;
    if (B <= 0 || N <= 0) return (int)cudaGetLastError();
    int L = 0;
    for (int c = 0; c < C; ++c) {
      const int lo = bands[2 * c], hi = bands[2 * c + 1];
      L += hi > lo ? ((hi - (lo & ~1) + 1) & ~1) : 0;
    }
    const int T = 2 * nhop;
    const size_t smem = (size_t)F * L * sizeof(float2) +
                        (size_t)F * C * nhop * sizeof(float2) +
                        (size_t)3 * T * sizeof(float) +
                        (size_t)F * (2 * C + 2 * C * Ke) * sizeof(float) +
                        (size_t)(L + 5 * C) * sizeof(int);
    cudaError_t e = llsm::allow_smem(noise_wide_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((N + F - 2) / (F - 1), B);
    noise_wide_kernel<<<grid, kWideThreads, smem, (cudaStream_t)stream>>>(
        cyc, edc, ar, ai, base, re, im, (int64_t)spec_bstride, gain, bands_d,
        y, N, nhop, C, Ke, L, F);
    return (int)cudaGetLastError();
  }
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  if (nhop <= 0 || kGroups * ((nhop + 1) / 2) > kMaxThreads || C <= 0 ||
      C > kMaxC || Ke < 0 ||
      Ke > kMaxKe)
    return (int)cudaErrorInvalidValue;
  Bands bd{};
  bd.C = C;
  int L = 0;
  for (int c = 0; c < C; ++c) {
    bd.lo[c] = bands[2 * c];
    bd.hi[c] = bands[2 * c + 1];
    bd.base[c] = bd.lo[c] & ~1;
    bd.off[c] = L;
    bd.plen[c] = bd.hi[c] > bd.lo[c] ? ((bd.hi[c] - bd.base[c] + 1) & ~1) : 0;
    L += bd.plen[c];
  }
  bd.Ltot = L;
  const int T = 2 * nhop;
  const size_t smem = (size_t)kFrames * L * sizeof(float2) +
                      (size_t)kFrames * C * nhop * sizeof(float2) +
                      (size_t)3 * T * sizeof(float) +
                      (size_t)kFrames * (2 * C + 2 * C * Ke) * sizeof(float) +
                      (size_t)L * sizeof(int);
  cudaError_t e = llsm::allow_smem(noise_mod_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = (kGroups * ((nhop + 1) / 2) + 31) / 32 * 32;
  dim3 grid((N + kHops - 1) / kHops, B);
  noise_mod_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      cyc, edc, ar, ai, base, re, im, (int64_t)spec_bstride, gain, y, N, nhop,
      Ke, bd);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The segment-input entry: OLA, envelope modulation and band sum of given
// windowed band segments seg [B, C, N, T] (the noise_idft="fft" path, whose
// channel-paired inverse FFTs make the segments outside the kernel):
//   y[b, i nhop + t] = sum_c (seg[b, c, i, nhop + t]
//                             + (i + 1 < N ? seg[b, c, i + 1, t] : 0))
//                      max(env_c, 0) / max(lerp(base_c), 1e-8)
// with env_c as above (envelope_sample).  Replaces the same
// noise_mod_ola_pallas (libllsm2_tpu/ops/pallas_osc.py), which the JAX
// package feeds the FFT branch's segments.  Bound on the H100: the bytes
// of the segments, read once (each sample of a segment feeds one output
// sample), against the envelope's C (Ke + 1) lerp-and-rotate steps a
// sample.  Design: one block per (tile of kHops hops, utterance) stages
// its kFrames frames' coefficients in shared memory; a thread a sample,
// consecutive threads on consecutive samples, so the segment loads and
// the stores are coalesced.
namespace {

constexpr int kSegThreads = 256;

__global__ void __launch_bounds__(kSegThreads)
noise_seg_kernel(const float* __restrict__ cyc, const float* __restrict__ edc,
                 const float* __restrict__ ar, const float* __restrict__ ai,
                 const float* __restrict__ base,
                 const float* __restrict__ seg, float* __restrict__ y, int N,
                 int nhop, int C, int Ke) {
  extern __shared__ float sm[];
  const int CK = C * Ke, T = 2 * nhop;
  float* s_edc = sm;                        // [kFrames, C]
  float* s_base = s_edc + kFrames * C;      // [kFrames, C]
  float* s_ar = s_base + kFrames * C;       // [kFrames, C, Ke]
  float* s_ai = s_ar + kFrames * CK;        // [kFrames, C, Ke]
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kHops;
  const int64_t row0 = (int64_t)b * N;
  for (int idx = threadIdx.x; idx < kFrames * C; idx += blockDim.x) {
    const int64_t fr = row0 + min(f0 + idx / C, N - 1);
    const int c = idx % C;
    s_edc[idx] = __ldg(edc + fr * C + c);
    s_base[idx] = __ldg(base + fr * C + c);
  }
  for (int idx = threadIdx.x; idx < kFrames * CK; idx += blockDim.x) {
    const int64_t fr = row0 + min(f0 + idx / CK, N - 1);
    const int q = idx % CK;
    s_ar[idx] = __ldg(ar + fr * CK + q);
    s_ai[idx] = __ldg(ai + fr * CK + q);
  }
  __syncthreads();

  const int nh = min(kHops, N - f0);
  const float inv_hop = 1.0f / (float)nhop;
  const float* sb = seg + (int64_t)b * C * N * T;
  for (int idx = threadIdx.x; idx < nh * nhop; idx += blockDim.x) {
    const int i = idx / nhop, t = idx - i * nhop;
    const bool partner = f0 + i + 1 < N;
    const int64_t g = (row0 + f0 + i) * nhop + t;
    float s1, c1;
    sincospif(2.0f * llsm::frac_c(__ldg(cyc + g)), &s1, &c1);
    const float sv = (float)t * inv_hop;
    float acc = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float env = llsm::envelope_sample(
          s_edc[i * C + c], s_edc[(i + 1) * C + c], s_ar + i * CK + c * Ke,
          s_ar + (i + 1) * CK + c * Ke, s_ai + i * CK + c * Ke,
          s_ai + (i + 1) * CK + c * Ke, Ke, sv, c1, s1);
      const float* sc = sb + ((int64_t)c * N + f0 + i) * T;
      float ola = __ldg(sc + nhop + t);
      if (partner) ola += __ldg(sc + T + t);
      const float b0 = s_base[i * C + c];
      const float bl = fmaf(s_base[(i + 1) * C + c] - b0, sv, b0);
      acc = fmaf(ola, __fdividef(fmaxf(env, 0.0f), fmaxf(bl, 1e-8f)), acc);
    }
    y[g] = acc;
  }
}

}  // namespace

extern "C" int llsm_noise_mod_ola_seg(const float* cyc, const float* edc,
                                      const float* ar, const float* ai,
                                      const float* base, const float* seg,
                                      float* y, int B, int N, int nhop, int C,
                                      int Ke, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  if (nhop <= 0 || C <= 0 || Ke < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kFrames * (2 * C + 2 * C * Ke) * sizeof(float);
  cudaError_t e = llsm::allow_smem(noise_seg_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + kHops - 1) / kHops, B);
  noise_seg_kernel<<<grid, kSegThreads, smem, (cudaStream_t)stream>>>(
      cyc, edc, ar, ai, base, seg, y, N, nhop, C, Ke);
  return (int)cudaGetLastError();
}
