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
// noise_wide_kernel runs the same arithmetic, every bit the same, laid out
// otherwise: a thread a sample pair of all 16 frames of its block (15
// output hops; kernels._noise_geometry gives the threads), one band at a
// time, its OLA and envelope finished in the same thread, so no (E, O)
// buffer; the band table (each band's bins, first even bin, first slot and
// slot count) in shared memory, made from the 2 C band ranges in device
// memory.  Where its 16-frame block would not leave room for two an SM
// (from hop ~500 with 4 bands: 44.1 / 48 kHz at 20 ms and every longer hop)
// noise_long_kernel runs it, a thread 4 columns of 16 frames, each
// band's slots pre-scaled once into device memory (noise_long_prep) and
// staged by cp.async in chunks, every output bit the wide kernel's.
#include "common.cuh"

// LLSM_SKIP_PASS_{A,B} = 1 compiles pass 1 or pass 2 out (in the segment
// entry the envelope or the segment loads), for the pass timings of
// scripts/port_kernel_passes.py; the library leaves both 0.
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

// nhop > 256, C > 8 or Ke > 8 (48 kHz at a 10 ms hop: nhop = 480):
// noise_mod_kernel's arithmetic at F = 16 frames a block (15 output hops),
// every output bit the same, laid out for a block of up to kWideThreads
// threads and two blocks an SM.  A thread takes a sample pair (ta, tb =
// ta + half) of ALL F frames, one band at a time: pass 1 sums the band's
// (E, O) of the F frames in registers (each rotation of the two z chains
// feeds 8 F FMAs; a slot pair of a frame is one 16-byte load, the F
// frames' at fixed offsets from one address: the spectra are staged slot
// pair by slot pair, [L / 2, F + 1] float4, the pad keeping the staging's
// stores free of bank conflicts), then the same thread finishes the
// band's OLA, envelope and modulation for its F - 1 hops at both samples
// and adds them, band after band in c order, to y accumulators it keeps in
// shared memory.  No (E, O) buffer and no barrier after the staging.  The
// staging as noise_mod_kernel's (spectra pre-scaled, each band's bins from
// an even bin, zero-padded; the coefficients; the three tables), plus the
// band table made from the 2 C band ranges in device memory.  Dynamic
// shared memory (kernels._noise_geometry): spectra [L / 2, F + 1] float4,
// the three [2 nhop] tables, the accumulators [F - 1, 2, threads], the
// coefficients [F, 2 C (Ke + 1)], the slots' bins [L] and the band table
// [5, C] ints.
constexpr int kWideThreads = 256;

// z e^{j t} with the products fused as the compiled noise_mod_kernel fuses
// rotate()'s (its SASS), so the wide kernel keeps its bits: the real part
// fma(zr, rr, -zi ri); the imaginary fma(zi, rr, zr ri) in pass 1 after an
// even slot (rotate_e), fma(zr, ri, zi rr) after an odd slot and in pass 2
// (rotate_o)
__device__ __forceinline__ void rotate_e(float& zr, float& zi, float rr,
                                         float ri) {
  const float nr = __fmaf_rn(zr, rr, -__fmul_rn(zi, ri));
  zi = __fmaf_rn(zi, rr, __fmul_rn(zr, ri));
  zr = nr;
}

__device__ __forceinline__ void rotate_o(float& zr, float& zi, float rr,
                                         float ri) {
  const float nr = __fmaf_rn(zr, rr, -__fmul_rn(zi, ri));
  zi = __fmaf_rn(zr, ri, __fmul_rn(zi, rr));
  zr = nr;
}

template <int F>
__global__ void __launch_bounds__(kWideThreads, 2)
noise_wide_kernel(const float* __restrict__ cyc, const float* __restrict__ edc,
                  const float* __restrict__ ar, const float* __restrict__ ai,
                  const float* __restrict__ base,
                  const float* __restrict__ re, const float* __restrict__ im,
                  int64_t spec_bstride, const float* __restrict__ gain,
                  const int* __restrict__ bands, float* __restrict__ y,
                  int N, int nhop, int C, int Ke, int L) {
  extern __shared__ float4 sm4[];
  constexpr int H = F - 1, FP = F + 1;
  const int T = 2 * nhop, nbin = nhop + 1, CK = C * Ke, L2 = L / 2;
  const int nt = blockDim.x, tid = threadIdx.x;
  float4* spec = sm4;                                  // [L / 2, F + 1]
  float* tc = reinterpret_cast<float*>(spec + L2 * FP);  // [T]
  float* ts = tc + T;                                  // [T]
  float* win = ts + T;                                 // [T]
  float* acc = win + T;                                // [H, 2, nt]
  float* s_edc = acc + H * 2 * nt;                     // [F, C]
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

  if (tid == 0) {
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
  for (int m = tid; m < T; m += nt) {
    float sn, c;
    sincospif(__fdiv_rn(2.0f * (float)m, (float)T), &sn, &c);
    tc[m] = c;
    ts[m] = sn;
    win[m] = sqrtf(0.5f - 0.5f * cospif(__fdiv_rn(2.0f * (float)m + 1.0f,
                                                  (float)T)));
  }
  for (int idx = tid; idx < F * C; idx += nt) {
    const int64_t fr = row0 + min(f0 + idx / C, N - 1);
    const int c = idx % C;
    s_edc[idx] = __ldg(edc + fr * C + c);
    s_base[idx] = __ldg(base + fr * C + c);
  }
  for (int idx = tid; idx < F * CK; idx += nt) {
    const int64_t fr = row0 + min(f0 + idx / CK, N - 1);
    const int q = idx % CK;
    s_ar[idx] = __ldg(ar + fr * CK + q);
    s_ai[idx] = __ldg(ai + fr * CK + q);
  }
  __syncthreads();
  for (int slot = tid; slot < L; slot += nt) {
    int c = 0;
    while (c + 1 < C && slot >= b_off[c + 1]) ++c;
    const int k = b_base[c] + slot - b_off[c];
    s_bin[slot] = (k >= b_lo[c] && k < b_hi[c]) ? k : -1;
  }
  __syncthreads();
  const float ends = 1.0f / sqrtf((float)T);
  const float mid = sqrtf(2.0f / (float)T);
  if (L2 > 0) {   // a thread a slot pair of a frame; every load made (at a
                  // clamped index where the slot is empty), so the unrolled
                  // iterations' loads are in flight together
    const int dj = nt / L2, ds = nt - dj * L2;
    int j = tid / L2, sp = tid - j * L2;
#pragma unroll 4
    for (int idx = tid; idx < F * L2; idx += nt) {
      const int f = min(f0 + j, N - 1);
      float v[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kb = s_bin[2 * sp + e], k = max(kb, 0);
        const int64_t o = spec_bstride * b + (int64_t)f * nbin + k;
        const float g = __ldg(gain + (row0 + f) * nbin + k);
        const float vr = __ldg(re + o), vi = __ldg(im + o);
        const bool live = f0 + j < N && kb >= 0;
        const bool edge = k == 0 || k == nbin - 1;
        v[2 * e] = live ? vr * g * (edge ? ends : mid) : 0.0f;
        v[2 * e + 1] = live && !edge ? vi * g * mid : 0.0f;
      }
      spec[sp * FP + j] = make_float4(v[0], v[1], v[2], v[3]);
      j += dj;
      sp += ds;
      if (sp >= L2) {
        sp -= L2;
        ++j;
      }
    }
  }
  __syncthreads();

  const int half = (nhop + 1) >> 1;
  const int nh = min(H, N - f0);
  const float inv_hop = 1.0f / (float)nhop;
  for (int ta = tid; ta < half; ta += nt) {
    const bool has_b = ta + half < nhop;
    const int tb = has_b ? ta + half : ta;    // odd nhop: a duplicate
    const int tt[2] = {ta, tb};
    const float rar = tc[ta], rai = ts[ta];   // e^{2 pi j t / T}
    const float rbr = tc[tb], rbi = ts[tb];
    const int stepa = (kRestart * ta) % T, stepb = (kRestart * tb) % T;
    const float sv[2] = {(float)ta * inv_hop, (float)tb * inv_hop};
    const float wa[2] = {win[nhop + ta], win[nhop + tb]};
    const float wb[2] = {win[ta], win[tb]};
    for (int i = 0; i < 2 * H; ++i) acc[i * nt + tid] = 0.0f;
    for (int c = 0; c < C; ++c) {
      // pass 1: the band's (E, O) of the F frames at ta and tb
      float ea[F], oa[F], eb[F], ob[F];
#pragma unroll
      for (int q = 0; q < F; ++q) ea[q] = oa[q] = eb[q] = ob[q] = 0.0f;
      int ma = (int)(((int64_t)b_base[c] * ta) % T);
      int mb = (int)(((int64_t)b_base[c] * tb) % T);
      const int off = b_off[c], plen = b_plen[c];
      for (int s0 = 0; !LLSM_SKIP_PASS_A && s0 < plen; s0 += kRestart) {
        float zar = tc[ma], zai = ts[ma], zbr = tc[mb], zbi = ts[mb];
        const int n = min(kRestart, plen - s0);
        const float4* sp = spec + ((off + s0) >> 1) * FP;
        for (int p = 0; p < n; p += 2, sp += FP) {
          // z of the odd slot: one rotation past the even slot's
          float yar = zar, yai = zai, ybr = zbr, ybi = zbi;
          rotate_e(yar, yai, rar, rai);
          rotate_e(ybr, ybi, rbr, rbi);
#pragma unroll
          for (int q = 0; q < F; ++q) {
            const float4 v = sp[q];
            ea[q] = fmaf(v.x, zar, fmaf(-v.y, zai, ea[q]));
            eb[q] = fmaf(v.x, zbr, fmaf(-v.y, zbi, eb[q]));
            oa[q] = fmaf(v.z, yar, fmaf(-v.w, yai, oa[q]));
            ob[q] = fmaf(v.z, ybr, fmaf(-v.w, ybi, ob[q]));
          }
          zar = yar;
          zai = yai;
          zbr = ybr;
          zbi = ybi;
          rotate_o(zar, zai, rar, rai);
          rotate_o(zbr, zbi, rbr, rbi);
        }
        ma += stepa;
        if (ma >= T) ma -= T;
        mb += stepb;
        if (mb >= T) mb -= T;
      }
      if (LLSM_SKIP_PASS_B) {   // keeps pass 1's sums
        float sink = 0.0f;
#pragma unroll
        for (int q = 0; q < F; ++q) sink += ea[q] + oa[q] + eb[q] + ob[q];
        if (sink == 1e30f) y[0] = sink;
        continue;
      }
      // pass 2: the band's OLA, envelope and modulation of each hop at
      // both samples, added to the accumulators; each hop's cycles loaded
      // a hop ahead
      float cy[2] = {cyc[(row0 + f0) * nhop + ta],
                     cyc[(row0 + f0) * nhop + tb]};
#pragma unroll
      for (int i = 0; i < H; ++i) {
        if (i >= nh) break;
        const bool partner = f0 + i + 1 < N;
        float c1[2], s1[2], env[2], zr[2], zi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          sincospif(2.0f * llsm::frac_c(cy[r]), &s1[r], &c1[r]);
        if (i + 1 < nh) {
          const int64_t g1 = (row0 + f0 + i + 1) * nhop;
          cy[0] = cyc[g1 + ta];
          cy[1] = cyc[g1 + tb];
        }
        const float e0 = s_edc[i * C + c], de = s_edc[(i + 1) * C + c] - e0;
        const float b0 = s_base[i * C + c];
        const float db = s_base[(i + 1) * C + c] - b0;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
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
          for (int r = 0; r < 2; ++r) {   // fused as noise_mod_kernel's
            env[r] = __fadd_rn(env[r],
                               __fmaf_rn(fmaf(da, sv[r], a), zr[r],
                                         -__fmul_rn(fmaf(dp, sv[r], p),
                                                    zi[r])));
            rotate_o(zr[r], zi[r], c1[r], s1[r]);
          }
        }
        const float cur[2][2] = {{ea[i], oa[i]}, {eb[i], ob[i]}};
        const float nxt[2][2] = {{ea[i + 1], oa[i + 1]},
                                 {eb[i + 1], ob[i + 1]}};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float ola = __fmul_rn(wa[r], __fsub_rn(cur[r][0], cur[r][1]));
          if (partner)
            ola = fmaf(wb[r], __fadd_rn(nxt[r][0], nxt[r][1]), ola);
          const float bl = fmaf(db, sv[r], b0);
          float* a_ = acc + (2 * i + r) * nt + tid;
          *a_ = fmaf(ola, __fdividef(fmaxf(env[r], 0.0f), fmaxf(bl, 1e-8f)),
                     *a_);
        }
      }
    }
    for (int i = 0; i < nh; ++i) {
      const int64_t g0 = (row0 + f0 + i) * nhop;
      y[g0 + ta] = acc[2 * i * nt + tid];
      if (has_b) y[g0 + tb] = acc[(2 * i + 1) * nt + tid];
    }
  }
}

template <int F>
cudaError_t launch_wide(const float* cyc, const float* edc, const float* ar,
                        const float* ai, const float* base, const float* re,
                        const float* im, int64_t spec_bstride,
                        const float* gain, const int* bands_d, float* y,
                        int B, int N, int nhop, int C, int Ke, int L,
                        int threads, cudaStream_t st) {
  const int T = 2 * nhop;
  const size_t smem = (size_t)(L / 2) * (F + 1) * sizeof(float4) +
                      (size_t)3 * T * sizeof(float) +
                      (size_t)(F - 1) * 2 * threads * sizeof(float) +
                      (size_t)F * (2 * C + 2 * C * Ke) * sizeof(float) +
                      (size_t)(L + 5 * C) * sizeof(int);
  cudaError_t e = llsm::allow_smem(noise_wide_kernel<F>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + F - 2) / (F - 1), B);
  noise_wide_kernel<F><<<grid, threads, smem, st>>>(
      cyc, edc, ar, ai, base, re, im, spec_bstride, gain, bands_d, y, N,
      nhop, C, Ke, L);
  return cudaGetLastError();
}

// Where the wide kernel's 16-frame block would not leave room for two an SM
// (from hop ~500 with 4 bands: 44.1 / 48 kHz at 20 ms, 48 kHz at 30-50 ms,
// every hop past; at hop 480 with 9 bands of 9 harmonics), noise_long_kernel
// runs its arithmetic, every output bit the same, laid out for long hops.
// There the wide kernel would run one block an SM, or (as first written)
// fewer frames a block, sharing its rotation ladders and table restarts
// over 8 or 4 frames and computing F frames for F - 1 hops; and each
// 16-byte slot pair it loads from shared memory feeds 8 FMAs.
//   - noise_long_prep writes each frame's slot pairs once for the whole
//     grid, pre-scaled as the wide kernel stages them, [B, N, L / 2] float4
//     in device memory (each band's bins from an even bin, zero-padded),
//     and the three [2 nhop] tables (e^{2 pi j m / T}, the window) beside
//     them, by the wide kernel's expressions.
//   - A block of kLongThreads threads takes F = 16 frames (15 output hops)
//     of one row and kLongThreads x kLongCols consecutive columns t (the
//     segment samples t and nhop + t), grid (column groups, tiles, rows),
//     so a tile's column groups run together and read its chunks from L2;
//     a thread takes kLongCols neighbouring columns of all F frames, so
//     each slot pair loaded (one address for the whole warp) feeds 4
//     kLongCols FMAs and each rotation 2 F.
//   - Each band's slots come in chunks of LC (a multiple of kRestart: 64,
//     or the largest of 48, 32 and 16 that leaves room for two blocks an SM
//     where the coefficients take it), [LC / 2, F + 1] float4, copied by
//     cp.async into one of two buffers
//     while the block sums the other; the sums walk them in the wide
//     kernel's order, carried across the chunks in registers.
//   - A column's rotation restarts every 16 slots from its table entry,
//     computed in the thread by the table's own expression (the same bits):
//     a table read there is a load from a scattered address a column,
//     which at hop 19200 (a 300 KB table) misses L1 and waits on L2.
//   - Pass 2's sincospif of each sample is taken once, before the bands,
//     into shared memory [F - 1, kLongCols, threads] float2; the y
//     accumulators [F - 1, kLongCols, threads], the coefficients [F, 2 C
//     (Ke + 1)] and the band table [5, C] ints are there too.
// A column past nhop computes on column nhop - 1 and stores nothing.
constexpr int kLongThreads = 128;
constexpr int kLongCols = 4;

// the staged spectra [B, N, L / 2] float4 and the tables tab [3, T]
__global__ void noise_long_prep(const float* __restrict__ re,
                                const float* __restrict__ im,
                                int64_t spec_bstride,
                                const float* __restrict__ gain,
                                const int* __restrict__ bands,
                                float* __restrict__ tab,
                                float4* __restrict__ spec, int B, int N,
                                int nhop, int C, int L2) {
  extern __shared__ int sb[];                 // lo, hi, base, off [C] each
  int* b_lo = sb;
  int* b_hi = b_lo + C;
  int* b_base = b_hi + C;
  int* b_off = b_base + C;
  if (threadIdx.x == 0) {
    int off = 0;
    for (int c = 0; c < C; ++c) {
      const int lo = bands[2 * c], hi = bands[2 * c + 1];
      b_lo[c] = lo;
      b_hi[c] = hi;
      b_base[c] = lo & ~1;
      b_off[c] = off;
      off += hi > lo ? ((hi - (lo & ~1) + 1) & ~1) : 0;
    }
  }
  __syncthreads();
  const int T = 2 * nhop, nbin = nhop + 1;
  for (int m = blockIdx.x * blockDim.x + threadIdx.x; m < T;
       m += gridDim.x * blockDim.x) {
    float sn, c;
    sincospif(__fdiv_rn(2.0f * (float)m, (float)T), &sn, &c);
    tab[m] = c;
    tab[T + m] = sn;
    tab[2 * T + m] = sqrtf(0.5f - 0.5f * cospif(__fdiv_rn(
                                             2.0f * (float)m + 1.0f, (float)T)));
  }
  const float ends = 1.0f / sqrtf((float)T);
  const float mid = sqrtf(2.0f / (float)T);
  for (int64_t fr = blockIdx.x; fr < (int64_t)B * N; fr += gridDim.x) {
    const int b = (int)(fr / N);
    const int64_t o0 = spec_bstride * b + (fr - (int64_t)b * N) * nbin;
    for (int sp = threadIdx.x; sp < L2; sp += blockDim.x) {
      int c = 0;
      while (c + 1 < C && 2 * sp >= b_off[c + 1]) ++c;
      float v[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = b_base[c] + 2 * sp + e - b_off[c];
        v[2 * e] = v[2 * e + 1] = 0.0f;
        if (k >= b_lo[c] && k < b_hi[c]) {
          const float g = __ldg(gain + fr * nbin + k);
          const bool edge = k == 0 || k == nbin - 1;
          v[2 * e] = __ldg(re + o0 + k) * g * (edge ? ends : mid);
          v[2 * e + 1] = edge ? 0.0f : __ldg(im + o0 + k) * g * mid;
        }
      }
      spec[fr * L2 + sp] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// two blocks an SM of 128 threads, up to 255 registers each
template <int F>
__global__ void __launch_bounds__(kLongThreads, 2)
noise_long_kernel(const float* __restrict__ cyc,
                  const float* __restrict__ edc,
                  const float* __restrict__ ar, const float* __restrict__ ai,
                  const float* __restrict__ base,
                  const float4* __restrict__ spec,
                  const float* __restrict__ tab,
                  const int* __restrict__ bands, float* __restrict__ y,
                  int N, int nhop, int C, int Ke, int L2, int LC) {
  extern __shared__ float4 sm4[];
  constexpr int H = F - 1, FP = F + 1, NT = kLongThreads, M = kLongCols;
  const int T = 2 * nhop, CK = C * Ke, P2 = LC / 2;
  const int tid = threadIdx.x;
  float4* buf = sm4;                                    // [2, LC / 2, F + 1]
  float2* cs = reinterpret_cast<float2*>(buf + 2 * P2 * FP);  // [H, M, NT]
  float* acc = reinterpret_cast<float*>(cs + H * M * NT);     // [H, M, NT]
  float* s_edc = acc + H * M * NT;                      // [F, C]
  float* s_base = s_edc + F * C;
  float* s_ar = s_base + F * C;                         // [F, C, Ke]
  float* s_ai = s_ar + F * CK;
  int* b_lo = reinterpret_cast<int*>(s_ai + F * CK);    // [C] each
  int* b_hi = b_lo + C;
  int* b_base = b_hi + C;
  int* b_off = b_base + C;
  int* b_plen = b_off + C;
  const float* tc = tab;                                // [T] each
  const float* ts = tab + T;
  const float* win = tab + 2 * T;
  const int b = blockIdx.z;
  const int f0 = blockIdx.y * H;
  const int64_t row0 = (int64_t)b * N;
  const float4* srow = spec + row0 * L2;
  const int nh = min(H, N - f0);
  const int t0 = (blockIdx.x * NT + tid) * M;           // the first column
  int tt[M];
#pragma unroll
  for (int m = 0; m < M; ++m) tt[m] = min(t0 + m, nhop - 1);

  if (tid == 0) {
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
  for (int idx = tid; idx < F * C; idx += NT) {
    const int64_t fr = row0 + min(f0 + idx / C, N - 1);
    const int c = idx % C;
    s_edc[idx] = __ldg(edc + fr * C + c);
    s_base[idx] = __ldg(base + fr * C + c);
  }
  for (int idx = tid; idx < F * CK; idx += NT) {
    const int64_t fr = row0 + min(f0 + idx / CK, N - 1);
    const int q = idx % CK;
    s_ar[idx] = __ldg(ar + fr * CK + q);
    s_ai[idx] = __ldg(ai + fr * CK + q);
  }
  // each sample's e^{2 pi j cyc}, once for every band
  for (int i = 0; i < nh; ++i) {
    const int64_t g0 = (row0 + f0 + i) * nhop;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float s1, c1;
      sincospif(2.0f * llsm::frac_c(__ldg(cyc + g0 + tt[m])), &s1, &c1);
      cs[(i * M + m) * NT + tid] = make_float2(c1, s1);
      acc[(i * M + m) * NT + tid] = 0.0f;
    }
  }
  __syncthreads();

  // chunk (c, q) of the block's frames into dst: slot pairs from (off_c +
  // q) / 2, zeros for frames past the row's last
  auto stage = [&](int c, int q, float4* dst) {
    const int n2 = min(LC, b_plen[c] - q) >> 1, p0 = (b_off[c] + q) >> 1;
    for (int idx = tid; idx < F * n2; idx += NT) {
      const int j = idx / n2, sp = idx - j * n2;
      const bool live = f0 + j < N;
      llsm::cp_async16z(dst + sp * FP + j,
                        srow + (int64_t)(live ? f0 + j : 0) * L2 + p0 + sp,
                        live);
    }
  };
  // the next chunk to stage: band nc from slot nq
  int nc = 0, nq = 0;
  while (nc < C && nq >= b_plen[nc]) {
    ++nc;
    nq = 0;
  }
  if (nc < C) stage(nc, nq, buf);
  llsm::cp_async_commit();
  int cur = 0;
  const float inv_hop = 1.0f / (float)nhop;
  float rr[M], ri[M];                                  // e^{2 pi j t / T}
  int step[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    rr[m] = __ldg(tc + tt[m]);
    ri[m] = __ldg(ts + tt[m]);
    step[m] = (kRestart * tt[m]) % T;
  }
  for (int c = 0; c < C; ++c) {
    // pass 1: the band's (E, O) of the F frames at the thread's columns
    float e[M][F], o[M][F];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int q = 0; q < F; ++q) e[m][q] = o[m][q] = 0.0f;
    const int plen = b_plen[c];
    int ma[M];                                         // the next restart
#pragma unroll
    for (int m = 0; m < M; ++m)
      ma[m] = (int)(((int64_t)b_base[c] * tt[m]) % T);
    for (int q0 = 0; q0 < plen; q0 += LC) {
      nq += LC;
      while (nc < C && nq >= b_plen[nc]) {
        ++nc;
        nq = 0;
      }
      if (nc < C) stage(nc, nq, buf + (cur ^ 1) * P2 * FP);
      llsm::cp_async_commit();
      llsm::cp_async_wait<1>();
      __syncthreads();
      const int nk = min(LC, plen - q0);
      const float4* sp = buf + cur * P2 * FP;
      for (int s0 = 0; !LLSM_SKIP_PASS_A && s0 < nk; s0 += kRestart) {
        float zr[M], zi[M];
#pragma unroll
        for (int m = 0; m < M; ++m) {
          // the table's entry ma, by its own expression
          sincospif(__fdiv_rn(2.0f * (float)ma[m], (float)T), &zi[m], &zr[m]);
          ma[m] += step[m];
          if (ma[m] >= T) ma[m] -= T;
        }
        const int n = min(kRestart, nk - s0);
        for (int p = 0; p < n; p += 2, sp += FP) {
          // z of the odd slot: one rotation past the even slot's
          float yr[M], yi[M];
#pragma unroll
          for (int m = 0; m < M; ++m) {
            yr[m] = zr[m];
            yi[m] = zi[m];
            rotate_e(yr[m], yi[m], rr[m], ri[m]);
          }
#pragma unroll
          for (int q = 0; q < F; ++q) {
            const float4 v = sp[q];
#pragma unroll
            for (int m = 0; m < M; ++m) {
              e[m][q] = fmaf(v.x, zr[m], fmaf(-v.y, zi[m], e[m][q]));
              o[m][q] = fmaf(v.z, yr[m], fmaf(-v.w, yi[m], o[m][q]));
            }
          }
#pragma unroll
          for (int m = 0; m < M; ++m) {
            zr[m] = yr[m];
            zi[m] = yi[m];
            rotate_o(zr[m], zi[m], rr[m], ri[m]);
          }
        }
      }
      __syncthreads();                 // this buffer is staged next
      cur ^= 1;
    }
    if (LLSM_SKIP_PASS_B) {   // keeps pass 1's sums
      float sink = 0.0f;
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int q = 0; q < F; ++q) sink += e[m][q] + o[m][q];
      if (sink == 1e30f) y[0] = sink;
      continue;
    }
    // pass 2: the band's OLA, envelope and modulation of each hop at the
    // thread's columns, added to the accumulators
    float sv[M], wa[M], wb[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      sv[m] = (float)tt[m] * inv_hop;
      wa[m] = __ldg(win + nhop + tt[m]);
      wb[m] = __ldg(win + tt[m]);
    }
#pragma unroll
    for (int i = 0; i < H; ++i) {
      if (i >= nh) break;
      const bool partner = f0 + i + 1 < N;
      const float e0 = s_edc[i * C + c], de = s_edc[(i + 1) * C + c] - e0;
      const float b0 = s_base[i * C + c];
      const float db = s_base[(i + 1) * C + c] - b0;
      float c1[M], s1[M], env[M], zr[M], zi[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float2 w = cs[(i * M + m) * NT + tid];
        c1[m] = w.x;
        s1[m] = w.y;
        env[m] = fmaf(de, sv[m], e0);
        zr[m] = c1[m];
        zi[m] = s1[m];
      }
      const float* a0 = s_ar + i * CK + c * Ke;
      const float* p0 = s_ai + i * CK + c * Ke;
      for (int k = 0; k < Ke; ++k) {
        const float a = a0[k], da = a0[CK + k] - a;
        const float p = p0[k], dp = p0[CK + k] - p;
#pragma unroll
        for (int m = 0; m < M; ++m) {   // fused as noise_mod_kernel's
          env[m] = __fadd_rn(env[m],
                             __fmaf_rn(fmaf(da, sv[m], a), zr[m],
                                       -__fmul_rn(fmaf(dp, sv[m], p),
                                                  zi[m])));
          rotate_o(zr[m], zi[m], c1[m], s1[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float ola = __fmul_rn(wa[m], __fsub_rn(e[m][i], o[m][i]));
        if (partner)
          ola = fmaf(wb[m], __fadd_rn(e[m][i + 1], o[m][i + 1]), ola);
        const float bl = fmaf(db, sv[m], b0);
        float* a_ = acc + (i * M + m) * NT + tid;
        *a_ = fmaf(ola, __fdividef(fmaxf(env[m], 0.0f), fmaxf(bl, 1e-8f)),
                   *a_);
      }
    }
  }
  llsm::cp_async_wait<0>();
  for (int i = 0; i < nh; ++i) {
    const int64_t g0 = (row0 + f0 + i) * nhop;
#pragma unroll
    for (int m = 0; m < M; ++m)
      if (t0 + m < nhop) y[g0 + t0 + m] = acc[(i * M + m) * NT + tid];
  }
}

// the staged spectra's offset in the scratch, in floats: after the tables,
// 16-byte aligned
int long_spec_offset(int nhop) { return (3 * 2 * nhop + 3) / 4 * 4; }

template <int F>
cudaError_t launch_long(const float* cyc, const float* edc, const float* ar,
                        const float* ai, const float* base, const float* re,
                        const float* im, int64_t spec_bstride,
                        const float* gain, const int* bands_d, float* tab,
                        float* y, int B, int N, int nhop, int C, int Ke,
                        int L, int LC, cudaStream_t st) {
  const int L2 = L / 2;
  float4* spec = reinterpret_cast<float4*>(tab + long_spec_offset(nhop));
  const int64_t frames = (int64_t)B * N;
  const int pblocks = (int)(frames < 4096 ? frames : 4096);
  noise_long_prep<<<pblocks, 256, 4 * C * sizeof(int), st>>>(
      re, im, spec_bstride, gain, bands_d, tab, spec, B, N, nhop, C, L2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem = (size_t)2 * (LC / 2) * (F + 1) * sizeof(float4) +
                      (size_t)(F - 1) * kLongCols * kLongThreads *
                          (sizeof(float2) + sizeof(float)) +
                      (size_t)F * (2 * C + 2 * C * Ke) * sizeof(float) +
                      (size_t)5 * C * sizeof(int);
  e = llsm::allow_smem(noise_long_kernel<F>, smem);
  if (e != cudaSuccess) return e;
  const int cols = kLongThreads * kLongCols;
  // a tile's column groups launch together, so its chunks stay in L2
  dim3 grid((nhop + cols - 1) / cols, (N + F - 2) / (F - 1), B);
  noise_long_kernel<F><<<grid, kLongThreads, smem, st>>>(
      cyc, edc, ar, ai, base, spec, tab, bands_d, y, N, nhop, C, Ke, L2, LC);
  return cudaGetLastError();
}

}  // namespace

// bands: 2 C ints on the host, each band's bin range [lo, hi) (lo = hi for
// an empty band), and the same in device memory (bands_d, read by the wide
// and long kernels); F, wide_threads: the wide kernel's frames (16) and
// threads a block (kernels._noise_geometry), F = 0 for noise_mod_kernel;
// chunk > 0: noise_long_kernel at F = 16 frames a block with chunks of that
// many slots, tab its scratch (the [3, 2 nhop] tables, then 16-byte
// aligned the staged spectra [B, N, L / 2] float4; null otherwise).
extern "C" int llsm_noise_mod_ola(const float* cyc, const float* edc,
                                  const float* ar, const float* ai,
                                  const float* base, const float* re,
                                  const float* im, long long spec_bstride,
                                  const float* gain, const int* bands,
                                  const int* bands_d, float* y, int B, int N,
                                  int nhop, int C, int Ke, int F,
                                  int wide_threads, int chunk, float* tab,
                                  void* stream) {
  if (F > 0) {
    if (nhop <= 0 || C <= 0 || Ke < 0 || !bands_d ||
        F != 16 ||
        (chunk ? chunk < 0 || chunk % kRestart || !tab
               : wide_threads <= 0 || wide_threads > kWideThreads))
      return (int)cudaErrorInvalidValue;
    if (B <= 0 || N <= 0) return (int)cudaGetLastError();
    int L = 0;
    for (int c = 0; c < C; ++c) {
      const int lo = bands[2 * c], hi = bands[2 * c + 1];
      L += hi > lo ? ((hi - (lo & ~1) + 1) & ~1) : 0;
    }
    const cudaStream_t st = (cudaStream_t)stream;
    if (chunk)
      return (int)launch_long<16>(cyc, edc, ar, ai, base, re, im,
                                  (int64_t)spec_bstride, gain, bands_d, tab,
                                  y, B, N, nhop, C, Ke, L, chunk, st);
    return (int)launch_wide<16>(cyc, edc, ar, ai, base, re, im,
                                (int64_t)spec_bstride, gain, bands_d, y, B, N,
                                nhop, C, Ke, L, wide_threads, st);
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
// with env_c as above (envelope_sample's operations, in its order).
// Replaces the same noise_mod_ola_pallas (libllsm2_tpu/ops/pallas_osc.py),
// which the JAX package feeds the FFT branch's segments.
//
// Bound on the H100: the bytes of the segments, read once (each sample of a
// segment feeds one output sample: 524 MB at 16 kHz, [128, 4, 1600, 160]),
// against the envelope's C (Ke + 1) lerp-and-accumulate steps and Ke
// rotations a sample.  Design: a block of kSegThreads threads takes a tile of
// H hops of one row (H = 32, or 15 where 33 frames' coefficients would
// overflow shared memory: the wrapper admits any C and Ke whose 16 frames
// fit) and stages its H + 1 frames' coefficients in shared memory; a thread
// takes kSegS = 4 consecutive samples of a hop (VEC, nhop a multiple of 4:
// 16-byte loads of the segments and the cycle track and 16-byte stores; else
// single loads, a hop's last run cut at its end), its runs stepping through
// the tile by the block's stride, the hop tracked by adding the stride's
// quotient and remainder (no divide a sample).
//   - The rotation ladder z^k = e^{2 pi j k cyc}, k = 1..Ke, is made once
//     a sample and used by every band (made a band at a time it would
//     cost C Ke rotations where Ke do); past kSegKC harmonics it is
//     made in chunks of kSegChunk, bands kSegCG at a time, their envelopes
//     in registers between chunks.
//   - Each band's coefficients are read from shared memory once a thread
//     (4 samples), their differences taken once, their lerps a sample.
//   - Where VEC, the next band's segment samples, and after the last band
//     the next run's first band and cycle samples, are loaded while this
//     band's envelope is made (not in the chunked layout, whose registers
//     go to the envelopes, nor with single loads, which time faster
//     without).
// Every product is spelled out as nvcc contracts envelope_sample's loop
// (its SASS): a term fma(rl, wr, -(il wi)) added to the envelope, the
// rotation (fma(wr, c1, -(wi s1)), fma(wr, s1, wi c1)), the lerps fma(a1
// - a0, s, a0), so the outputs keep the bits of a band-at-a-time render.
// LLSM_SKIP_PASS_A = 1 compiles the envelope out (the ladder and the
// lerps: an envelope of 1), LLSM_SKIP_PASS_B = 1 the segment loads (an OLA
// of 1), for scripts/port_kernel_passes.py (only=seg).
namespace {

constexpr int kSegThreads = 128;
constexpr int kSegHops = 32;   // hops a tile where their frames fit
constexpr int kSegS = 4;       // samples a thread
constexpr int kSegKC = 8;      // harmonics of a ladder in registers
constexpr int kSegChunk = 4;   // harmonics of a chunk past kSegKC
constexpr int kSegCG = 4;      // bands a group past kSegKC

// blocks an SM each instance is compiled for: the most whose register
// budget holds it without spilling (5: 102 registers, 4: 128, 3: 170)
constexpr int seg_min_blocks(bool vec, int KC, bool chunked) {
  return chunked ? 4 : KC <= 4 ? (vec ? 5 : 4) : (vec ? 4 : 3);
}

// n <= 4 floats from p to v (16 bytes where VEC: n = 4), 0 past n
template <bool VEC>
__device__ __forceinline__ void seg_load4(float* v, const float* p, int n) {
  if (VEC) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else {
#pragma unroll
    for (int s = 0; s < kSegS; ++s) v[s] = s < n ? __ldg(p + s) : 0.0f;
  }
}

// band c's two segment runs at the thread's n samples: seg[c, i, nhop + t
// + s] and, where frame i + 1 exists, seg[c, i + 1, t + s] (else 0)
template <bool VEC>
__device__ __forceinline__ void seg_load(float* lo, float* hi,
                                         const float* sc, int nhop, int T,
                                         bool partner, int n) {
#pragma unroll
  for (int s = 0; s < kSegS; ++s) lo[s] = hi[s] = 0.0f;
  if (LLSM_SKIP_PASS_B) return;
  seg_load4<VEC>(lo, sc + nhop, n);
  if (partner) seg_load4<VEC>(hi, sc + T, n);
}

// z <- z e^{2 pi j cyc}, as nvcc compiles envelope_sample's rotation
__device__ __forceinline__ void seg_rotate(float& wr, float& wi, float c1,
                                           float s1) {
  const float nwr = __fmaf_rn(wr, c1, -__fmul_rn(wi, s1));
  wi = __fmaf_rn(wr, s1, __fmul_rn(wi, c1));
  wr = nwr;
}

// env += sum over the ladder's harmonics k0 .. k0 + n - 1 of lerp(ar)
// Re z^k - lerp(ai) Im z^k at the 4 samples; ar0 / ai0 frame i's
// coefficients of the band, ar1 / ai1 frame i + 1's
template <int KC>
__device__ __forceinline__ void seg_terms(float* env, float (*wr)[KC],
                                          float (*wi)[KC],
                                          const float* ar0, const float* ar1,
                                          const float* ai0, const float* ai1,
                                          int k0, int n, const float* sv) {
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    if (k >= n) break;
    const float a0 = ar0[k0 + k], da = __fsub_rn(ar1[k0 + k], a0);
    const float b0 = ai0[k0 + k], db = __fsub_rn(ai1[k0 + k], b0);
#pragma unroll
    for (int s = 0; s < kSegS; ++s) {
      const float rl = __fmaf_rn(sv[s], da, a0);
      const float il = __fmaf_rn(sv[s], db, b0);
      env[s] = __fadd_rn(env[s], __fmaf_rn(rl, wr[s][k],
                                           -__fmul_rn(il, wi[s][k])));
    }
  }
}

// acc += OLA max(env, 0) / max(lerp(base), 1e-8) at the 4 samples
__device__ __forceinline__ void seg_accumulate(float* acc, const float* lo,
                                               const float* hi,
                                               const float* env, float b0,
                                               float b1, const float* sv) {
#pragma unroll
  for (int s = 0; s < kSegS; ++s) {
    const float ola = LLSM_SKIP_PASS_B ? 1.0f : __fadd_rn(lo[s], hi[s]);
    const float e = LLSM_SKIP_PASS_A ? 1.0f : env[s];
    const float bl = fmaf(b1 - b0, sv[s], b0);
    acc[s] = fmaf(ola, __fdividef(fmaxf(e, 0.0f), fmaxf(bl, 1e-8f)), acc[s]);
  }
}

// VEC: nhop % 4 == 0; the ladder in registers to KC harmonics (Ke <= KC),
// or CHUNKED in chunks of KC (Ke > kSegKC)
template <bool VEC, int KC, bool CHUNKED>
__global__ void __launch_bounds__(kSegThreads,
                                  seg_min_blocks(VEC, KC, CHUNKED))
noise_seg_kernel(const float* __restrict__ cyc, const float* __restrict__ edc,
                 const float* __restrict__ ar, const float* __restrict__ ai,
                 const float* __restrict__ base,
                 const float* __restrict__ seg, float* __restrict__ y, int N,
                 int nhop, int C, int Ke, int H) {
  constexpr int S = kSegS;
  constexpr bool PF = !CHUNKED && VEC;
  extern __shared__ float sm[];
  const int CK = C * Ke, T = 2 * nhop, F = H + 1;
  float* s_edc = sm;                        // [F, C]
  float* s_base = s_edc + F * C;            // [F, C]
  float* s_ar = s_base + F * C;             // [F, C, Ke]
  float* s_ai = s_ar + F * CK;              // [F, C, Ke]
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * H;
  const int64_t row0 = (int64_t)b * N;
  for (int idx = threadIdx.x; idx < F * C; idx += kSegThreads) {
    const int64_t fr = row0 + min(f0 + idx / C, N - 1);
    const int c = idx % C;
    s_edc[idx] = __ldg(edc + fr * C + c);
    s_base[idx] = __ldg(base + fr * C + c);
  }
  for (int idx = threadIdx.x; idx < F * CK; idx += kSegThreads) {
    const int64_t fr = row0 + min(f0 + idx / CK, N - 1);
    const int q = idx % CK;
    s_ar[idx] = __ldg(ar + fr * CK + q);
    s_ai[idx] = __ldg(ai + fr * CK + q);
  }

  // runs of 4 samples: nq a hop, the last cut at the hop's end
  const int nh = min(H, N - f0), nq = (nhop + S - 1) / S, items = nh * nq;
  const float inv_hop = 1.0f / (float)nhop;
  const float* sb = seg + (int64_t)b * C * N * T;
  const int64_t g0 = (row0 + f0) * nhop;
  const int64_t bstride = (int64_t)N * T;
  // the thread's first run (hop i, samples q S ...), then the block's
  // stride as a quotient and remainder of hops
  int i = threadIdx.x / nq, q = threadIdx.x - i * nq;
  const int di = kSegThreads / nq, dq = kSegThreads - di * nq;
  // a run's cycle samples and band 0's segment runs are loaded one run
  // ahead (PF), each band's next one band ahead
  float lo[S], hi[S], cv[S];
  if (PF && threadIdx.x < items) {
    const int n = min(S, nhop - q * S);
    seg_load<VEC>(lo, hi, sb + ((int64_t)f0 + i) * T + q * S, nhop, T,
                  f0 + i + 1 < N, n);
    seg_load4<VEC>(cv, cyc + g0 + (int64_t)i * nhop + q * S, n);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < items; e += kSegThreads) {
    const int t = q * S, n = min(S, nhop - t);
    const bool partner = f0 + i + 1 < N;
    const float* sf = sb + ((int64_t)f0 + i) * T + t;   // band 0, frame i
    const float* e0 = s_edc + i * C;
    const float* bs0 = s_base + i * C;
    const float* ar0 = s_ar + i * CK;
    const float* ai0 = s_ai + i * CK;
    if (!PF) {
      if (!CHUNKED) seg_load<VEC>(lo, hi, sf, nhop, T, partner, n);
      seg_load4<VEC>(cv, cyc + g0 + (int64_t)i * nhop + t, n);
    }
    // the next run (hop i2, samples q2 S ...)
    int i2 = i + di, q2 = q + dq;
    if (q2 >= nq) {
      q2 -= nq;
      ++i2;
    }
    const bool more = PF && e + kSegThreads < items;
    float c1[S], s1[S], sv[S], acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      sincospif(2.0f * llsm::frac_c(cv[s]), &s1[s], &c1[s]);
      sv[s] = (float)(t + s) * inv_hop;
      acc[s] = 0.0f;
    }
    if (more)
      seg_load4<VEC>(cv, cyc + g0 + (int64_t)i2 * nhop + q2 * S,
                     min(S, nhop - q2 * S));
    if (!CHUNKED) {
      // the ladder z^(k + 1), k < Ke, once for every band
      float wr[S][KC], wi[S][KC];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        wr[s][0] = c1[s];
        wi[s][0] = s1[s];
#pragma unroll
        for (int k = 1; k < KC; ++k) {
          wr[s][k] = wr[s][k - 1];
          wi[s][k] = wi[s][k - 1];
          if (k < Ke) seg_rotate(wr[s][k], wi[s][k], c1[s], s1[s]);
        }
      }
      for (int c = 0; c < C; ++c) {
        float clo[S], chi[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          clo[s] = lo[s];
          chi[s] = hi[s];
        }
        if (c + 1 < C)                 // the next band's, in flight
          seg_load<VEC>(lo, hi, sf + (c + 1) * bstride, nhop, T, partner, n);
        else if (more)                 // the next run's band 0
          seg_load<VEC>(lo, hi, sb + ((int64_t)f0 + i2) * T + q2 * S, nhop,
                        T, f0 + i2 + 1 < N, min(S, nhop - q2 * S));
        float env[S];
        const float ed0 = e0[c], ded = __fsub_rn(e0[C + c], ed0);
#pragma unroll
        for (int s = 0; s < S; ++s) env[s] = __fmaf_rn(sv[s], ded, ed0);
        if (!LLSM_SKIP_PASS_A)
          seg_terms<KC>(env, wr, wi, ar0 + c * Ke, ar0 + CK + c * Ke,
                        ai0 + c * Ke, ai0 + CK + c * Ke, 0, Ke, sv);
        seg_accumulate(acc, clo, chi, env, bs0[c], bs0[C + c], sv);
      }
    } else {
      // bands kSegCG at a time; for each group the ladder in chunks of
      // KC harmonics, each chunk's terms added to the group's envelopes
      // (each band's terms in the order of k)
      for (int c0 = 0; c0 < C; c0 += kSegCG) {
        const int nc = min(kSegCG, C - c0);
        float env[kSegCG][S];
#pragma unroll
        for (int u = 0; u < kSegCG; ++u) {
          if (u >= nc) break;
          const float ed0 = e0[c0 + u];
          const float ded = __fsub_rn(e0[C + c0 + u], ed0);
#pragma unroll
          for (int s = 0; s < S; ++s) env[u][s] = __fmaf_rn(sv[s], ded, ed0);
        }
        float zr[S], zi[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          zr[s] = c1[s];
          zi[s] = s1[s];
        }
        for (int k0 = 0; !LLSM_SKIP_PASS_A && k0 < Ke; k0 += KC) {
          const int nk = min(KC, Ke - k0);
          float wr[S][KC], wi[S][KC];
#pragma unroll
          for (int s = 0; s < S; ++s) {
#pragma unroll
            for (int k = 0; k < KC; ++k) {
              wr[s][k] = zr[s];
              wi[s][k] = zi[s];
              if (k0 + k + 1 < Ke) seg_rotate(zr[s], zi[s], c1[s], s1[s]);
            }
          }
#pragma unroll
          for (int u = 0; u < kSegCG; ++u) {
            if (u >= nc) break;
            const int c = c0 + u;
            seg_terms<KC>(env[u], wr, wi, ar0 + c * Ke, ar0 + CK + c * Ke,
                          ai0 + c * Ke, ai0 + CK + c * Ke, k0, nk, sv);
          }
        }
#pragma unroll
        for (int u = 0; u < kSegCG; ++u) {
          if (u >= nc) break;
          const int c = c0 + u;
          float clo[S], chi[S];
          seg_load<VEC>(clo, chi, sf + c * bstride, nhop, T, partner, n);
          seg_accumulate(acc, clo, chi, env[u], bs0[c], bs0[C + c], sv);
        }
      }
    }
    float* yg = y + g0 + (int64_t)i * nhop + t;
    if (VEC) {
      *reinterpret_cast<float4*>(yg) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (s < n) yg[s] = acc[s];
    }
    i = i2;
    q = q2;
  }
}

template <bool VEC, int KC, bool CHUNKED>
cudaError_t launch_seg(const float* cyc, const float* edc, const float* ar,
                       const float* ai, const float* base, const float* seg,
                       float* y, int B, int N, int nhop, int C, int Ke,
                       cudaStream_t st) {
  // kSegHops hops a tile where their frames' coefficients fit, else 15
  // (16 frames: any C and Ke the wrapper admits)
  int dev = 0, cap = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return e;
  const size_t per = (size_t)(2 * C + 2 * C * Ke) * sizeof(float);
  const int H = (size_t)(kSegHops + 1) * per <= (size_t)cap ? kSegHops : 15;
  const size_t smem = (size_t)(H + 1) * per;
  e = llsm::allow_smem(noise_seg_kernel<VEC, KC, CHUNKED>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + H - 1) / H, B);
  noise_seg_kernel<VEC, KC, CHUNKED><<<grid, kSegThreads, smem, st>>>(
      cyc, edc, ar, ai, base, seg, y, N, nhop, C, Ke, H);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_seg_ke(const float* cyc, const float* edc,
                          const float* ar, const float* ai, const float* base,
                          const float* seg, float* y, int B, int N, int nhop,
                          int C, int Ke, cudaStream_t st) {
  if (Ke <= 4)
    return launch_seg<VEC, 4, false>(cyc, edc, ar, ai, base, seg, y, B, N,
                                     nhop, C, Ke, st);
  if (Ke <= kSegKC)
    return launch_seg<VEC, kSegKC, false>(cyc, edc, ar, ai, base, seg, y, B,
                                          N, nhop, C, Ke, st);
  return launch_seg<VEC, kSegChunk, true>(cyc, edc, ar, ai, base, seg, y, B,
                                          N, nhop, C, Ke, st);
}

}  // namespace

extern "C" int llsm_noise_mod_ola_seg(const float* cyc, const float* edc,
                                      const float* ar, const float* ai,
                                      const float* base, const float* seg,
                                      float* y, int B, int N, int nhop, int C,
                                      int Ke, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  if (nhop <= 0 || C <= 0 || Ke < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // 16-byte accesses where every run of 4 samples starts on a 16-byte
  // boundary (the wrapper passes 16-byte aligned tensors)
  const cudaError_t e =
      nhop % kSegS == 0
          ? launch_seg_ke<true>(cyc, edc, ar, ai, base, seg, y, B, N, nhop, C,
                                Ke, st)
          : launch_seg_ke<false>(cyc, edc, ar, ai, base, seg, y, B, N, nhop,
                                 C, Ke, st);
  return (int)e;
}
