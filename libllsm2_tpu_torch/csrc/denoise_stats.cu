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
// taps, full band's K = 200 / 600) the wide path runs in two launches, the
// taps in device memory and the K axis in chunks of KC <= 128 columns.
// The fit needs a frame's 7 sums over all of K before any r_inc, and that
// is the only coupling across K, so the path splits there:
// denoise_rows_kernel stages each (tile, chunk) once and writes every
// output but pp and the chunk's 7 partial sums a frame;
// denoise_probe_kernel adds a row's partials chunk by chunk from 0, solves
// the fit, forms r_inc from the first launch's tracks and runs the probe
// FIR.  A fit row's slow track, sums and probe take denoise_stats_kernel's
// order (lane sub the columns sub + 16 j, j ascending; 16 lanes by
// half_allsum; chunks in order): forced onto K <= KC the path gives that
// kernel's bits but in pp (see below).  A thread takes kRB fit rows of a
// column, so a staged value feeds kRB FIR outputs from one load.
#include <algorithm>

#include "common.cuh"

// LLSM_SKIP_PASS_{A,B} = 1 leaves the wide path's first or second launch
// out, for the pass timings of scripts/port_kernel_passes.py; the library
// leaves both 0.
#ifndef LLSM_SKIP_PASS_A
#define LLSM_SKIP_PASS_A 0
#endif
#ifndef LLSM_SKIP_PASS_B
#define LLSM_SKIP_PASS_B 0
#endif

namespace {

constexpr int kTile = 64;                  // frames per block
constexpr int kThreads = 512;
constexpr int kSlots = kThreads / 16;      // rows in flight: 16 lanes a row
constexpr int kMaxTaps = 31;
constexpr size_t kSmemMax = 232448;        // the H100's shared memory a block

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

// The wide path: two launches, taps1 and taps2 in device memory, K in
// chunks of KC columns (a multiple of 16, kernels._denoise_geometry).  A
// block takes one (64-frame tile, chunk, utterance) and walks the chunk
// cw = 1 << sl columns at a time (64, or 32 or 16 where a halo past ~150
// frames fills shared memory); kRowThreads threads, 16 lanes a row group
// of kRB fit rows.  Lane sub of a row takes the chunk's columns sub + 16
// j, j ascending, as denoise_stats_kernel's lanes, so every sum runs in
// that kernel's order; every output is the bits of the one-block wide
// kernel the path replaced, whose r_inc products (and so pp) the compiler
// contracted otherwise than the first kernel's: here they are spelled out.
constexpr int kRB = 2;                     // fit rows a thread (slow_rows')
constexpr int kRowThreads = 16 * kTile / kRB;
constexpr int kBatch = 4;                  // staged elements a thread loads
                                           // at once

// The slow track of two consecutive fit rows at column kl of a [*, ld]
// float2 buffer whose row t is the first one's t-th tap and row t + 1 the
// second one's (t ascending, each output's fmaf chain as
// denoise_stats_kernel's), and their centres (rows h and h + 1): the two
// windows share their loads, two taps a step (t1 8-byte aligned, read in
// pairs).
__device__ __forceinline__ void slow_rows(const float2* buf, int ld, int kl,
                                          const float* t1, int n1, int h,
                                          float (&sr)[2], float (&si)[2],
                                          float2 (&c)[2]) {
  sr[0] = si[0] = sr[1] = si[1] = 0.0f;
  const float2* col = buf + kl;
  const float2* tp2 = reinterpret_cast<const float2*>(t1);
  float2 w0 = col[0];                       // row t
  int t = 0;
  for (; t + 1 < n1; t += 2) {
    const float2 tp = tp2[t / 2];
    const float2 w1 = col[(t + 1) * ld];    // row t + 1
    sr[0] = fmaf(tp.x, w0.x, sr[0]);
    si[0] = fmaf(tp.x, w0.y, si[0]);
    sr[1] = fmaf(tp.x, w1.x, sr[1]);
    si[1] = fmaf(tp.x, w1.y, si[1]);
    w0 = col[(t + 2) * ld];                 // row t + 2
    sr[0] = fmaf(tp.y, w1.x, sr[0]);
    si[0] = fmaf(tp.y, w1.y, si[0]);
    sr[1] = fmaf(tp.y, w0.x, sr[1]);
    si[1] = fmaf(tp.y, w0.y, si[1]);
  }
  if (t < n1) {
    const float tp = t1[t];
    const float2 w1 = col[(t + 1) * ld];
    sr[0] = fmaf(tp, w0.x, sr[0]);
    si[0] = fmaf(tp, w0.y, si[0]);
    sr[1] = fmaf(tp, w1.x, sr[1]);
    si[1] = fmaf(tp, w1.y, si[1]);
  }
  c[0] = col[h * ld];
  c[1] = col[(h + 1) * ld];
}

// First launch: the chunk's aligned track of the tile's frames and a +-h1
// halo, staged once cw columns at a time (sincospif once an element);
// every own frame's slow track, outputs (cre, cim, csr, csi, cs2, r2; guard
// from chunk 0) and the chunk's 7 fit sums, each reduced over the row's 16
// lanes, into part [B, N, chunks, 7]; the first and last tiles also the
// slow track of the h2 frames beyond their end of the utterance (their
// r_inc = -c_s reaches the probe FIR of the last h2 frames) into edge
// [B, 2 h2, K] float2.  Shared memory: cbuf [64 + 2 h1, cw] float2, then
// vo [64 + 2 h1] and t1 [n1].
__global__ void __launch_bounds__(kRowThreads, 2)
denoise_rows_kernel(const float* __restrict__ a, const float* __restrict__ p,
                    const float* __restrict__ cyc_c,
                    const float* __restrict__ mask,
                    const float* __restrict__ voiced,
                    float* __restrict__ o_cs2, float* __restrict__ o_r2,
                    bool* __restrict__ guard, float* __restrict__ o_cre,
                    float* __restrict__ o_cim, float* __restrict__ o_csr,
                    float* __restrict__ o_csi, float* __restrict__ part,
                    float2* __restrict__ edge, int N, int K,
                    const float* __restrict__ taps1, int n1, int n2, int KC,
                    int sl, int complex_input) {
  extern __shared__ float2 sm2[];
  const int cw = 1 << sl;
  const int h1 = n1 / 2, h2 = n2 / 2;
  const int SR = kTile + 2 * h1;         // staged rows: frames [-h1, 64 + h1)
  float2* cbuf = sm2;                    // [SR, cw]
  float* vo = reinterpret_cast<float*>(cbuf + SR * cw);  // [SR]
  float* t1 = vo + SR;                   // [n1]
  const int b = blockIdx.z, chunk = blockIdx.y, nch = gridDim.y;
  const int64_t row0 = (int64_t)b * N;
  const int f0 = blockIdx.x * kTile;
  const int fs = f0 - h1;                // frame of staged row 0
  const int k0 = chunk * KC, kc = min(KC, K - k0);
  const bool first = f0 == 0, last = f0 + kTile >= N;
  const float inv2pi = 0.15915494309189535f;

  for (int j = threadIdx.x; j < n1; j += kRowThreads) t1[j] = taps1[j];
  for (int r = threadIdx.x; r < SR; r += kRowThreads) {
    const int f = fs + r;
    vo[r] = (f >= 0 && f < N) ? voiced[row0 + f] : 0.0f;
  }
  const int sub = threadIdx.x & 15, i0 = (threadIdx.x >> 4) * kRB;
  float q[kRB][7];
#pragma unroll
  for (int r = 0; r < kRB; ++r)
#pragma unroll
    for (int i = 0; i < 7; ++i) q[r][i] = 0.0f;

  for (int s0 = 0; s0 < kc; s0 += cw) {
    __syncthreads();
    // columns k0 + s0 .. k0 + s0 + cw - 1 of the chunk (zero past it and
    // outside the utterance): a thread's kBatch elements' loads first, all
    // in flight, then their rotations
    for (int base = 0; base < SR * cw; base += kBatch * kRowThreads) {
      float xv[kBatch], yv[kBatch], cyv[kBatch];
      bool live[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kRowThreads + threadIdx.x;
        const int r = idx >> sl, cl = idx & (cw - 1);
        const int f = fs + r;
        live[u] = idx < SR * cw && f >= 0 && f < N && s0 + cl < kc;
        xv[u] = yv[u] = cyv[u] = 0.0f;
        if (live[u]) {
          const int64_t o = (row0 + f) * K + k0 + s0 + cl;
          cyv[u] = cyc_c[row0 + f];
          xv[u] = a[o];
          yv[u] = p[o];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kRowThreads + threadIdx.x;
        const int k = k0 + s0 + (idx & (cw - 1));
        float2 c = make_float2(0.0f, 0.0f);
        if (live[u]) {
          const float kc = llsm::kmul_c((float)(k + 1), cyv[u]);
          float sn, cs;
          if (complex_input) {
            sincospif(-2.0f * kc, &sn, &cs);
            const float x = xv[u], y = yv[u];
            c = make_float2(x * cs - y * sn, x * sn + y * cs);
          } else {
            sincospif(2.0f * llsm::frac_c(yv[u] * inv2pi - kc), &sn, &cs);
            c = make_float2(xv[u] * cs, xv[u] * sn);
          }
        }
        if (idx < SR * cw) cbuf[idx] = c;
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int jj = 0; jj < cw / 16; ++jj) {
      const int cl = sub + 16 * jj, k = k0 + s0 + cl;
      if (s0 + cl >= kc || f0 + i0 >= N) break;
      float m[kRB];
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        const int f = f0 + i0 + r;
        m[r] = f < N ? mask[(row0 + f) * K + k] : 0.0f;
      }
      float sr[kRB], si[kRB];
      float2 c[kRB];
      slow_rows(cbuf + i0 * cw, cw, cl, t1, n1, h1, sr, si, c);
      const float kh = (float)(k + 1);
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        const int f = f0 + i0 + r;
        const bool in = f < N;
        const float rr = c[r].x - sr[r], ri = c[r].y - si[r];
        const float pw = (sr[r] * sr[r] + si[r] * si[r]) * m[r];
        const float crr = (sr[r] * rr + si[r] * ri) * m[r];
        const float cri = (sr[r] * ri - si[r] * rr) * m[r];
        q[r][0] += pw;
        q[r][1] += kh * pw;
        q[r][2] += kh * kh * pw;
        q[r][3] += crr;
        q[r][4] += cri;
        q[r][5] += kh * crr;
        q[r][6] += kh * cri;
        if (in) {
          const int64_t o = (row0 + f) * K + k;
          o_cre[o] = c[r].x;
          o_cim[o] = c[r].y;
          o_csr[o] = sr[r];
          o_csi[o] = si[r];
          // the one-block kernel's contractions, spelled out: the compiler
          // would merge these products with pw's and contract otherwise
          o_cs2[o] = fmaf(sr[r], sr[r], si[r] * si[r]);
          o_r2[o] = fmaf(rr, rr, ri * ri);
        }
      }
    }
    // the frames beyond the utterance's ends: staged rows outside the
    // buffer are frames outside [0, N), zero
    if (h2 == 0 || !(first || last)) continue;
    const int sw = min(cw, kc - s0);
    for (int idx = threadIdx.x; idx < 2 * h2 * sw; idx += kRowThreads) {
      const int e = idx / sw, cl = idx - e * sw;
      const int f = e < h2 ? e - h2 : N + e - h2;
      if (f < 0 ? !first : !last) continue;
      const int i = f - f0;              // staged row i + t is tap t's
      float s_r = 0.0f, s_i = 0.0f;
      for (int t = 0; t < n1; ++t) {
        const int sr = i + t;
        const float2 v = (sr >= 0 && sr < SR) ? cbuf[sr * cw + cl]
                                              : make_float2(0.0f, 0.0f);
        s_r = fmaf(t1[t], v.x, s_r);
        s_i = fmaf(t1[t], v.y, s_i);
      }
      edge[((int64_t)b * 2 * h2 + e) * K + k0 + s0 + cl] =
          make_float2(s_r, s_i);
    }
  }
#pragma unroll
  for (int r = 0; r < kRB; ++r)
#pragma unroll
    for (int i = 0; i < 7; ++i) q[r][i] = half_allsum(q[r][i]);
  if (sub != 0) return;
#pragma unroll
  for (int r = 0; r < kRB; ++r) {
    const int f = f0 + i0 + r;
    if (f >= N) break;
#pragma unroll
    for (int i = 0; i < 7; ++i)
      part[((row0 + f) * nch + chunk) * 7 + i] = q[r][i];
    if (chunk == 0) {
      float g = 0.0f;
      for (int t = 0; t < n1; ++t) g = fmaf(t1[t], vo[i0 + r + t], g);
      guard[row0 + f] = g > 0.999f;
    }
  }
}

// Second launch: every fit row of the tile and its +-h2 halo sums its
// chunks' partial sums in chunk order from 0 (the one-block kernel's order)
// and solves the fit; then, cw columns at a time, r_inc of those rows
// from the first launch's aligned and slow tracks (the edge rows': zero and
// edge's) and the probe FIR to pp.  Shared memory: rbuf [64 + 2 h2, cw]
// float2, then the fit [64 + 2 h2, 4] and t2 [n2].
__global__ void __launch_bounds__(kRowThreads, 2)
denoise_probe_kernel(const float* __restrict__ cre,
                     const float* __restrict__ cim,
                     const float* __restrict__ csr,
                     const float* __restrict__ csi,
                     const float* __restrict__ part,
                     const float2* __restrict__ edge, float* __restrict__ pp,
                     int N, int K, const float* __restrict__ taps2, int n2,
                     int KC, int sl) {
  extern __shared__ float2 sm2[];
  const int cw = 1 << sl;
  const int h2 = n2 / 2;
  const int R = kTile + 2 * h2;          // fit rows: frames [-h2, 64 + h2)
  float2* rbuf = sm2;                    // [R, cw]
  float* fit = reinterpret_cast<float*>(rbuf + R * cw);  // [R, 4]
  float* t2 = fit + 4 * R;               // [n2]
  const int b = blockIdx.z, chunk = blockIdx.y, nch = gridDim.y;
  const int64_t row0 = (int64_t)b * N;
  const int f0 = blockIdx.x * kTile;
  const int k0 = chunk * KC, kc = min(KC, K - k0);

  for (int j = threadIdx.x; j < n2; j += kRowThreads) t2[j] = taps2[j];
  for (int r = threadIdx.x; r < R; r += kRowThreads) {
    const int f = f0 - h2 + r;
    float q[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (f >= 0 && f < N) {
      const float* pr = part + (row0 + f) * nch * 7;
      for (int c = 0; c < nch; ++c)
#pragma unroll
        for (int i = 0; i < 7; ++i) q[i] += pr[7 * c + i];
    }
    const float a00 = q[0], a01 = q[1], a11 = q[2];
    const float det = a00 * a11 - a01 * a01;
    const float inv = 1.0f / (det + 1e-5f * a00 * a11 + 1e-12f);
    fit[4 * r] = (a11 * q[3] - a01 * q[5]) * inv;
    fit[4 * r + 1] = (a11 * q[4] - a01 * q[6]) * inv;
    fit[4 * r + 2] = (a00 * q[5] - a01 * q[3]) * inv;
    fit[4 * r + 3] = (a00 * q[6] - a01 * q[4]) * inv;
  }
  const int sub = threadIdx.x & 15, i0 = (threadIdx.x >> 4) * kRB;
  const bool own = f0 + i0 < N;
  for (int s0 = 0; s0 < kc; s0 += cw) {
    __syncthreads();
    // r_inc of columns k0 + s0 .. k0 + s0 + cw - 1 of the chunk (zero
    // past it): a thread's kBatch elements' loads first, then the rest
    for (int base = 0; base < R * cw; base += kBatch * kRowThreads) {
      float2 cv[kBatch], sv[kBatch];
      bool live[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kRowThreads + threadIdx.x;
        const int r = idx >> sl, cl = (idx & (cw - 1));
        const int f = f0 - h2 + r, k = k0 + s0 + cl;
        live[u] = idx < R * cw && s0 + cl < kc && f < N + h2;
        cv[u] = sv[u] = make_float2(0.0f, 0.0f);
        if (live[u]) {
          if (f >= 0 && f < N) {
            const int64_t o = (row0 + f) * K + k;
            cv[u] = make_float2(cre[o], cim[o]);
            sv[u] = make_float2(csr[o], csi[o]);
          } else {
            sv[u] = edge[((int64_t)b * 2 * h2 + (f < 0 ? f + h2 : f - N + h2))
                         * K + k];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = base + u * kRowThreads + threadIdx.x;
        const int r = idx >> sl, k = k0 + s0 + (idx & (cw - 1));
        float2 ri2 = make_float2(0.0f, 0.0f);
        if (live[u]) {
          const float2 c = cv[u], cs = sv[u];
          const float m0r = fit[4 * r], m0i = fit[4 * r + 1];
          const float m1r = fit[4 * r + 2], m1i = fit[4 * r + 3];
          const float kh = (float)(k + 1);
          // the one-block kernel's contractions, spelled out
          const float wr = fmaf(m1r, kh, m0r), wi = fmaf(m1i, kh, m0i);
          const float rr = c.x - cs.x, ri = c.y - cs.y;
          ri2 = make_float2(rr - fmaf(wr, cs.x, -(wi * cs.y)),
                            ri - fmaf(wi, cs.x, wr * cs.y));
        }
        if (idx < R * cw) rbuf[idx] = ri2;
      }
    }
    __syncthreads();
    if (!own) continue;
#pragma unroll
    for (int jj = 0; jj < cw / 16; ++jj) {
      const int cl = sub + 16 * jj, k = k0 + s0 + cl;
      if (s0 + cl >= kc) break;
      float lr[kRB], li[kRB];
      float2 c[kRB];
      slow_rows(rbuf + i0 * cw, cw, cl, t2, n2, h2, lr, li, c);
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        const int f = f0 + i0 + r;
        if (f >= N) break;
        const float pr = c[r].x - lr[r], pi = c[r].y - li[r];
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
// taps2_d: the wide path's); kc, cw: the wide path's chunk and the columns
// its launches walk at a time (kernels._denoise_geometry), kc 0 for
// denoise_stats_kernel; part, edge:
// the wide path's scratch, [B, N, chunks, 7] and [B, 2 h2, K] float2
// (null for the first kernel)
extern "C" int llsm_denoise_stats(const float* a, const float* p,
                                  const float* cyc_c, const float* mask,
                                  const float* voiced, float* pp, float* cs2,
                                  float* r2, bool* gd, float* cre, float* cim,
                                  float* csr, float* csi, int B, int N, int K,
                                  const float* taps1, int n1,
                                  const float* taps2, int n2,
                                  const float* taps1_d, const float* taps2_d,
                                  int kc, int cw, float* part, void* edge,
                                  int complex_input, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (kc > 0) {
    if (n1 < 1 || n2 < 1 || kc % 16 || kc > 128 || !taps1_d || !taps2_d ||
        !part || (n2 > 1 && !edge) || B > 65535)
      return (int)cudaErrorInvalidValue;
    if (B <= 0 || N <= 0 || K <= 0) return (int)cudaGetLastError();
    const int h1 = n1 / 2, h2 = n2 / 2;
    const int SR = kTile + 2 * h1, R = kTile + 2 * h2;
    const int sl = cw == 64 ? 6 : cw == 32 ? 5 : cw == 16 ? 4 : 0;
    const size_t smem1 = (size_t)SR * cw * sizeof(float2) +
                         (size_t)(SR + n1) * sizeof(float);
    const size_t smem2 = (size_t)R * cw * sizeof(float2) +
                         (size_t)(4 * R + n2) * sizeof(float);
    if (!sl || std::max(smem1, smem2) > kSmemMax)
      return (int)cudaErrorInvalidValue;
    cudaError_t e = llsm::allow_smem(denoise_rows_kernel, smem1);
    if (e == cudaSuccess) e = llsm::allow_smem(denoise_probe_kernel, smem2);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((N + kTile - 1) / kTile, (K + kc - 1) / kc, B);
    float2* ed = static_cast<float2*>(edge);
    if (!LLSM_SKIP_PASS_A)
      denoise_rows_kernel<<<grid, kRowThreads, smem1, st>>>(
          a, p, cyc_c, mask, voiced, cs2, r2, gd, cre, cim, csr, csi, part,
          ed, N, K, taps1_d, n1, n2, kc, sl, complex_input);
    e = cudaGetLastError();
    if (e != cudaSuccess || LLSM_SKIP_PASS_B) return (int)e;
    denoise_probe_kernel<<<grid, kRowThreads, smem2, st>>>(
        cre, cim, csr, csi, part, ed, pp, N, K, taps2_d, n2, kc, sl);
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
