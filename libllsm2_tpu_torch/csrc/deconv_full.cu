// Amplitude-track deconvolution: one Neumann step c' <- 2c - S c on the
// phase-aligned complex harmonic tracks, S = T (frames) + X (k -> k+1)
// + conj(X) (k -> k-1), all banded over +-D frames, then the mask.
//
// Per utterance, frame f and band offset d in [-D, D], at the stride-
// quadrature points r_q = -nhop + (q + 1/2) stride of the render crossfade:
//   P[f,d,q] = hann_hw[f](d nhop + r_q) * w_ola(r_q)
//   T[f,d] = sum_q P / tot[f],  X[f,d] = sum_q P eq[f+d, q] / tot[f],
//   tot[f] = sum_{d,q} P,  eq[g, q] = e^{2 pi j cyc[s]} at sample
//   s = clamp((g - 1) nhop + stride/2 + q stride, 0, nx - 1) of the cycle
//   track (frame_hops(mode="edge")'s quadrature points).
// Aligned tracks c[f,k] = a e^{j phi} e^{-2 pi j (k+1) cyc[f nhop]}; frames
// outside [0, N) of the SAME utterance are zero.  Output: the corrected
// track un-aligned (times e^{+2 pi j (k+1) cyc[f nhop]}) times the mask, as
// (re, im), or as (|c|, angle c) (sqrtf / atan2f) for the callers that take
// the polar track.
//
// Replaces libllsm2_tpu/ops/pallas_osc.py: deconv_full_pallas
// (_deconv_full_kernel) and the glue of its caller (libllsm2_tpu/models/
// layer0.py: _deconv_correction): the quadrature field, the centre cycles
// and the mask are the kernel's, so only (ampl, phse, mask), the cycle
// track's quadrature samples and the halfwidths are read, and the output is
// written once.  Bound on the H100: the bytes of those reads and writes at
// D = 7 (~(2D+1) x 12 flops an output against ~20 bytes).
// Design: one block per (tile of 64 frames, utterance), 8 warps.  The
// block stages the halo rows' quadrature field e^{2 pi j cyc} (float2)
// and builds the taps from it: half a warp a frame, a lane an offset d with
// its nq points in order, the row sum by four shuffles, 1/tot folded into
// the taps (one float4 a tap).  Then the aligned track of its frames plus a
// +-D halo (22% at D = 7; the halo stops at the utterance's ends, so no
// block reads another row) goes where the field was.  The output: a thread
// a harmonic k of 4 consecutive frames walks the 4 + 2D halo rows once,
// each row's (c_{k-1}, c_k, c_{k+1}) feeding the taps of the 4 frames that
// reach it (~1.9 shared loads a tap against 4 for a thread a (frame, k),
// a layout those loads bound), then un-aligns, masks and converts.  No
// integer division in a loop.
//
// Past the block's shared memory (full-band analysis: K = 600 at 48 kHz,
// 342 at 48 kHz with a 2 ms hop, 200 at 16 kHz with a 2 ms hop, or D past
// 56 at K = 80) the wide path takes the shapes, in two launches.
// deconv_taps_kernel builds every frame's taps once, to build_taps's bits
// (from the staged field, or where its rows do not fit, from the cycle
// track itself: the same values), into a device scratch [B, Np, 2 D + 1]
// float4.  The output couples only c_{k-1}, c_k and c_{k+1}, so
// deconv_out_kernel<KF> cuts K into chunks of KC <= 64 columns staged with
// one halo column each side, a block a (chunk, tile of 8 KF frames,
// utterance): the tile's taps copied in, no block builds them again, and
// the blocks small enough for two or three an SM.  A thread takes two
// adjacent harmonics of KF frames, so one tap load feeds both and one
// row's loads feed KF frames.  Each output's sums run in deconv_kernel's
// order (the same halo rows in order, the same fmaf chain), so where both
// kernels take a shape they give the same bits.
#include <algorithm>

#include "common.cuh"

// LLSM_SKIP_PASS_{A,B} = 1 compiles the tap build (the wide path: its first
// launch) or the output pass out, for the pass timings of
// scripts/port_kernel_passes.py; the library leaves both 0.
#ifndef LLSM_SKIP_PASS_A
#define LLSM_SKIP_PASS_A 0
#endif
#ifndef LLSM_SKIP_PASS_B
#define LLSM_SKIP_PASS_B 0
#endif

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kHalf = 16;           // lanes a frame in the tap build
constexpr int kF = 4;               // frames a thread in the output pass
constexpr int kTapsUnroll = 4;      // quadrature points a step, tap build
constexpr size_t kSmemMax = 232448; // the H100's shared memory a block

// deconv_kernel stages the centre cycles and builds the taps through the
// functions below (field_point is the wide path's too); it keeps its own
// field staging and output pass: through device functions shared with the
// wide path ptxas gave it 56 registers against its 55.
//
// The centre cycles cyc_c [FH] of halo rows fh0 .. fh0 + FH - 1 and the
// crossfade wola [nq].
__device__ __forceinline__ void stage_cycles(float* cyc_c, float* wola,
                                             const float* __restrict__ cy,
                                             int fh0, int FH, int N, int nhop,
                                             int stride, int nq) {
  for (int r = threadIdx.x; r < FH; r += kThreads) {
    const int f = fh0 + r;
    cyc_c[r] = (f >= 0 && f < N) ? cy[(int64_t)f * nhop] : 0.0f;
  }
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    const float r = -(float)nhop + ((float)q + 0.5f) * (float)stride;
    wola[q] = 0.5f + 0.5f * cospif(r / (float)nhop);
  }
}

// e^{2 pi j cyc} at quadrature point q of the hop pair of frame f
// (edge-clamped), f in [0, N).
__device__ __forceinline__ float2 field_point(const float* __restrict__ cy,
                                              int f, int q, int nhop,
                                              int stride, int64_t nx) {
  int64_t s = (int64_t)(f - 1) * nhop + stride / 2 + (int64_t)q * stride;
  s = s < 0 ? 0 : (s >= nx ? nx - 1 : s);
  float2 e;
  sincospif(2.0f * __ldg(cy + s), &e.y, &e.x);
  return e;
}

// The taps [FT, nb] float4 (T, Re X, Im X, 0) / tot of frames f0 .. f0 +
// FT - 1: half a warp a frame, a lane an offset d with its nq points in
// order, the row sum by four shuffles.  The field's point is read from eq
// where `stage`, else computed from the cycle track (the same value).
__device__ __forceinline__ void build_taps(
    float4* taps, const float2* eq, const float* wola,
    const float* __restrict__ hw, const float* __restrict__ cy, int64_t row0,
    int f0, int FT, int N, int D, int nhop, int stride, int nq, int64_t nx,
    bool stage) {
  const int nb = 2 * D + 1;
  const int lane = threadIdx.x & 31, half = lane / kHalf, hl = lane % kHalf;
  const int pairs = kThreads / 32 * 2;
  for (int fl = (threadIdx.x / 32) * 2 + half;
       !LLSM_SKIP_PASS_A && fl < FT; fl += pairs) {
    const int f = f0 + fl;
    const bool live = f < N;
    const float ih = 1.0f / (live ? hw[row0 + f] : 2.0f);
    float tsum = 0.0f;
    for (int j = hl; j < nb; j += kHalf) {
      const int d = j - D, fd = f + d;
      const bool in = live && fd >= 0 && fd < N;
      const float2* e = eq + (fl + j) * nq;   // halo row of frame f + d
      float t = 0.0f, sr = 0.0f, si = 0.0f;
      for (int q = 0; q < nq; ++q) {
        const float r = -(float)nhop + ((float)q + 0.5f) * (float)stride;
        const float u = (((float)(d * nhop) + r) * ih + 1.0f) * 0.5f;
        if (u >= 0.0f && u <= 1.0f) {
          const float P = (0.5f - 0.5f * cospif(2.0f * u)) * wola[q];
          t += P;
          if (in) {
            const float2 z =
                stage ? e[q] : field_point(cy, fd, q, nhop, stride, nx);
            sr = fmaf(P, z.x, sr);
            si = fmaf(P, z.y, si);
          }
        }
      }
      tsum += t;
      taps[fl * nb + j] = make_float4(t, sr, si, 0.0f);
    }
#pragma unroll
    for (int o = kHalf / 2; o > 0; o >>= 1)
      tsum += __shfl_xor_sync(0xffffffffu, tsum, o);
    const float iv = 1.0f / fmaxf(tsum, 1e-9f);
    for (int j = hl; j < nb; j += kHalf) {
      float4 tp = taps[fl * nb + j];
      tp.x *= iv;
      tp.y *= iv;
      tp.z *= iv;
      taps[fl * nb + j] = tp;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 3)
deconv_kernel(const float* __restrict__ ampl, const float* __restrict__ phse,
              const float* __restrict__ cyc, const float* __restrict__ hw,
              const float* __restrict__ mask, float* __restrict__ out_a,
              float* __restrict__ out_b, int N, int K, int D, int nhop,
              int stride, int nq, int polar) {
  extern __shared__ float4 sm4[];
  const int nb = 2 * D + 1;
  const int FH = kTile + 2 * D;
  float4* taps = sm4;                                     // [kTile, nb]
  float2* v = reinterpret_cast<float2*>(taps + kTile * nb);  // [FH, K]
  float2* eq = v;                      // [FH, nq], before v is built
  float* cyc_c = reinterpret_cast<float*>(
      v + max(FH * K, FH * nq));                          // [FH]
  float* wola = cyc_c + FH;                               // [nq]
  const int b = blockIdx.y;
  const int64_t row0 = (int64_t)b * N;
  const int64_t nx = (int64_t)N * nhop;
  const float* cy = cyc + (int64_t)b * nx;
  const int f0 = blockIdx.x * kTile;
  const int fh0 = f0 - D;                          // frame of halo row 0

  stage_cycles(cyc_c, wola, cy, fh0, FH, N, nhop, stride, nq);
  // the field's staging loop; the staging loops are unrolled so that
  // a thread's global loads are in flight together
  const int dq = kThreads / nq, dqq = kThreads - dq * nq;
  int rq = threadIdx.x / nq, qq = threadIdx.x - rq * nq;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < FH * nq; idx += kThreads) {
    const int f = fh0 + rq;
    float2 e = make_float2(0.0f, 0.0f);
    if (f >= 0 && f < N) {
      int64_t s = (int64_t)(f - 1) * nhop + stride / 2 + (int64_t)qq * stride;
      s = s < 0 ? 0 : (s >= nx ? nx - 1 : s);
      sincospif(2.0f * __ldg(cy + s), &e.y, &e.x);
    }
    eq[idx] = e;
    rq += dq;
    qq += dqq;
    if (qq >= nq) {
      qq -= nq;
      ++rq;
    }
  }
  __syncthreads();
  build_taps(taps, eq, wola, hw, cy, row0, f0, kTile, N, D, nhop, stride, nq,
             nx, true);
  __syncthreads();                  // the field is read; v takes its place

  const float inv2pi = 0.15915494309189535f;
  const int dr = kThreads / K, dk = kThreads - dr * K;
  int r = threadIdx.x / K, k = threadIdx.x - r * K;
#pragma unroll 8
  for (int idx = threadIdx.x; idx < FH * K; idx += kThreads) {
    const int f = fh0 + r;
    float2 c = make_float2(0.0f, 0.0f);
    if (f >= 0 && f < N) {
      const int64_t o = (row0 + f) * K + k;
      const float ph = llsm::frac_c(__ldg(phse + o) * inv2pi -
                                    llsm::kmul_c((float)(k + 1), cyc_c[r]));
      float s, co;
      sincospif(2.0f * ph, &s, &co);
      const float a = __ldg(ampl + o);
      c = make_float2(a * co, a * s);
    }
    v[idx] = c;
    r += dr;
    k += dk;
    if (k >= K) {
      k -= K;
      ++r;
    }
  }
  __syncthreads();

  // output: harmonic k of frames fl0 .. fl0 + kF - 1
  const int groups = kTile / kF;
  int grp = threadIdx.x / K;
  k = threadIdx.x - grp * K;
  for (int idx = threadIdx.x; !LLSM_SKIP_PASS_B && idx < groups * K;
       idx += kThreads) {
    const int fl0 = grp * kF;
    if (f0 + fl0 >= N) break;
    const int kk = k;
    grp += dr;
    k += dk;
    if (k >= K) {
      k -= K;
      ++grp;
    }
    float smr[kF], smi[kF];
#pragma unroll
    for (int q = 0; q < kF; ++q) smr[q] = smi[q] = 0.0f;
    const bool up = kk + 1 < K, dn = kk >= 1;
    const float2 zero = make_float2(0.0f, 0.0f);
    for (int hr = 0; hr < kF - 1 + nb; ++hr) {      // halo row fl0 + hr
      const int h = (fl0 + hr) * K + kk;
      const float2 c = v[h];
      const float2 u = up ? v[h + 1] : zero;      // c_{k+1}
      const float2 w = dn ? v[h - 1] : zero;      // c_{k-1}
      // X c_{k+1} + conj(X) c_{k-1}
      const float pr = u.x + w.x, pi = u.y + w.y;
      const float mr = u.x - w.x, mi = u.y - w.y;
#pragma unroll
      for (int q = 0; q < kF; ++q) {
        const int j = hr - q;
        if (j >= 0 && j < nb) {
          const float4 tp = taps[(fl0 + q) * nb + j];
          smr[q] = fmaf(tp.x, c.x, fmaf(tp.y, pr, fmaf(-tp.z, mi, smr[q])));
          smi[q] = fmaf(tp.x, c.y, fmaf(tp.y, pi, fmaf(tp.z, mr, smi[q])));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kF; ++q) {
      const int fl = fl0 + q, f = f0 + fl;
      if (f >= N) break;
      const float2 cc = v[(fl + D) * K + kk];
      const float c2r = 2.0f * cc.x - smr[q];
      const float c2i = 2.0f * cc.y - smi[q];
      float s, co;
      sincospif(2.0f * llsm::kmul_c((float)(kk + 1), cyc_c[fl + D]), &s, &co);
      const int64_t o = (row0 + f) * K + kk;
      const float m = mask[o];
      const float zr = c2r * co - c2i * s, zi = c2r * s + c2i * co;
      if (polar) {
        out_a[o] = sqrtf(zr * zr + zi * zi) * m;
        out_b[o] = atan2f(zi, zr) * m;
      } else {
        out_a[o] = zr * m;
        out_b[o] = zi * m;
      }
    }
  }
}

// The wide path's first launch: the taps [Np, nb] float4 of a utterance's
// frames (Np: N rounded up to the 64-frame tile) into device memory, a
// block TT frames.  The values are build_taps's: each (frame, offset)'s
// three sums over the quadrature points in order, spread evenly over the
// block's threads (build_taps leaves a half warp's lanes idle past nb = 16,
// 23 of 32 lane slots busy at D = 11), then each frame's row sum as
// build_taps takes it (lane hl the offsets hl, hl + 16, ... in order, then
// four shuffles over 16 lanes) and the taps scaled by its inverse.  Shared
// memory: the unscaled taps [TT, nb] float4, the field [TT + 2 D, nq + 1]
// float2 where `stage` (a padded row: no bank conflicts between offsets),
// else computed from the cycle track (the same values), the crossfade [nq].
__global__ void __launch_bounds__(kThreads)
deconv_taps_kernel(const float* __restrict__ cyc, const float* __restrict__ hw,
                   float4* __restrict__ taps_g, int N, int Np, int D,
                   int nhop, int stride, int nq, int TT, int stage) {
  extern __shared__ float4 sm4[];
  const int nb = 2 * D + 1;
  const int FH = TT + 2 * D, ld = nq + 1;
  float4* raw = sm4;                                        // [TT, nb]
  float2* eq = reinterpret_cast<float2*>(raw + TT * nb);    // [FH, ld]
  float* wola = reinterpret_cast<float*>(eq + (stage ? FH * ld : 0));
  const int b = blockIdx.y;
  const int64_t row0 = (int64_t)b * N;
  const int64_t nx = (int64_t)N * nhop;
  const float* cy = cyc + (int64_t)b * nx;
  const int f0 = blockIdx.x * TT;
  const int fh0 = f0 - D;

  for (int q = threadIdx.x; q < nq; q += kThreads) {
    const float r = -(float)nhop + ((float)q + 0.5f) * (float)stride;
    wola[q] = 0.5f + 0.5f * cospif(r / (float)nhop);
  }
  if (stage) {
    for (int idx = threadIdx.x; idx < FH * nq; idx += kThreads) {
      const int r = idx / nq, q = idx - r * nq, f = fh0 + r;
      eq[r * ld + q] = (f >= 0 && f < N)
                           ? field_point(cy, f, q, nhop, stride, nx)
                           : make_float2(0.0f, 0.0f);
    }
  }
  __syncthreads();
  // a warp's lanes take one offset of 32 frames: their windows cover
  // nearly the same quadrature points, so the lanes branch alike
  for (int idx = threadIdx.x; idx < TT * nb; idx += kThreads) {
    const int j = idx / TT, fl = idx - j * TT;
    const int f = f0 + fl;
    const bool live = f < N;
    const float ih = 1.0f / (live ? hw[row0 + f] : 2.0f);
    const int d = j - D, fd = f + d;
    const bool in = live && fd >= 0 && fd < N;
    const float2* e = eq + (fl + j) * ld;    // halo row of frame f + d
    float t = 0.0f, sr = 0.0f, si = 0.0f;
#pragma unroll kTapsUnroll
    for (int q = 0; q < nq; ++q) {
      const float r = -(float)nhop + ((float)q + 0.5f) * (float)stride;
      const float u = (((float)(d * nhop) + r) * ih + 1.0f) * 0.5f;
      if (u >= 0.0f && u <= 1.0f) {
        const float P = (0.5f - 0.5f * cospif(2.0f * u)) * wola[q];
        t += P;
        if (in) {
          const float2 z =
              stage ? e[q] : field_point(cy, fd, q, nhop, stride, nx);
          sr = fmaf(P, z.x, sr);
          si = fmaf(P, z.y, si);
        }
      }
    }
    raw[fl * nb + j] = make_float4(t, sr, si, 0.0f);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, half = lane / kHalf, hl = lane % kHalf;
  float4* tg = taps_g + ((int64_t)b * Np + f0) * nb;
  for (int fl = (threadIdx.x / 32) * 2 + half; fl < TT;
       fl += kThreads / 32 * 2) {
    float tsum = 0.0f;
    for (int j = hl; j < nb; j += kHalf) tsum += raw[fl * nb + j].x;
#pragma unroll
    for (int o = kHalf / 2; o > 0; o >>= 1)
      tsum += __shfl_xor_sync(0xffffffffu, tsum, o);
    const float iv = 1.0f / fmaxf(tsum, 1e-9f);
    for (int j = hl; j < nb; j += kHalf) {
      float4 tp = raw[fl * nb + j];
      tp.x *= iv;
      tp.y *= iv;
      tp.z *= iv;
      tg[fl * nb + j] = tp;
    }
  }
}

// The output of harmonic kk (v's staged column kk - k0 + 2, v a row's
// columns) of one frame: its sums (smr, smi) over the halo rows, then the
// correction, un-aligned, masked and converted: deconv_kernel's epilogue.
__device__ __forceinline__ void emit(const float2* v, float smr, float smi,
                                     float cyc_c, const float* __restrict__ mask,
                                     float* __restrict__ out_a,
                                     float* __restrict__ out_b, int64_t o,
                                     int kk, int polar) {
  const float2 cc = *v;
  const float c2r = 2.0f * cc.x - smr;
  const float c2i = 2.0f * cc.y - smi;
  float s, co;
  sincospif(2.0f * llsm::kmul_c((float)(kk + 1), cyc_c), &s, &co);
  const float m = mask[o];
  const float zr = c2r * co - c2i * s, zi = c2r * s + c2i * co;
  if (polar) {
    out_a[o] = sqrtf(zr * zr + zi * zi) * m;
    out_b[o] = atan2f(zi, zr) * m;
  } else {
    out_a[o] = zr * m;
    out_b[o] = zi * m;
  }
}

// One halo row hr of a thread's walk: the row's c_{k-1} .. c_{k+2} (a
// float4 of its two columns and a float2 each side) feed the taps of the KF
// frames that reach it, both harmonics, each sum's fmaf chain as
// deconv_kernel's.  ALL: every frame reaches the row (no bounds test).
template <int KF, bool ALL>
__device__ __forceinline__ void walk_row(const float2* v, const float4* tp0,
                                         int hr, int nb, float (&smr)[KF][2],
                                         float (&smi)[KF][2]) {
  const float4 cc = *reinterpret_cast<const float4*>(v + 2);
  const float2 w = v[1], u = v[4];
  // harmonic k: c = cc.xy, c_{k+1} = cc.zw, c_{k-1} = w
  const float pr0 = cc.z + w.x, pi0 = cc.w + w.y;
  const float mr0 = cc.z - w.x, mi0 = cc.w - w.y;
  // harmonic k + 1: c = cc.zw, c_{k+2} = u, c_k = cc.xy
  const float pr1 = u.x + cc.x, pi1 = u.y + cc.y;
  const float mr1 = u.x - cc.x, mi1 = u.y - cc.y;
#pragma unroll
  for (int q = 0; q < KF; ++q) {
    const int j = hr - q;
    if (ALL || (j >= 0 && j < nb)) {
      const float4 tp = tp0[q * nb + j];
      smr[q][0] = fmaf(tp.x, cc.x, fmaf(tp.y, pr0, fmaf(-tp.z, mi0, smr[q][0])));
      smi[q][0] = fmaf(tp.x, cc.y, fmaf(tp.y, pi0, fmaf(tp.z, mr0, smi[q][0])));
      smr[q][1] = fmaf(tp.x, cc.z, fmaf(tp.y, pr1, fmaf(-tp.z, mi1, smr[q][1])));
      smi[q][1] = fmaf(tp.x, cc.w, fmaf(tp.y, pi1, fmaf(tp.z, mr1, smi[q][1])));
    }
  }
}

// Second launch: a block takes FT = 8 KF frames of one utterance and one
// chunk of KC (even, <= 64) columns, blockIdx.x the chunk (a tile's chunks
// run side by side and share its taps in L2).  Shared memory: the tile's
// taps [FT, nb] float4 (copied from the first launch's), the chunk's
// aligned track with a halo column each side [FH, KC + 4] float2 (column
// k0 + w - 2 at w; zero outside [0, K), outside the chunk and its halo, and
// outside the utterance), the centre cycles [FH].  Warp w takes frames
// w KF .. w KF + KF - 1, lane l harmonics k0 + 2 l and k0 + 2 l + 1: each
// tap load feeds both, each row's loads the KF frames.
template <int KF>
__global__ void __launch_bounds__(kThreads, 3)
deconv_out_kernel(const float* __restrict__ ampl,
                  const float* __restrict__ phse,
                  const float* __restrict__ cyc, const float* __restrict__ mask,
                  const float4* __restrict__ taps_g, float* __restrict__ out_a,
                  float* __restrict__ out_b, int N, int Np, int K, int D,
                  int nhop, int polar, int KC) {
  extern __shared__ float4 sm4[];
  constexpr int FT = kThreads / 32 * KF;
  const int nb = 2 * D + 1;
  const int FH = FT + 2 * D;
  const int W = KC + 4;
  float4* taps = sm4;                                     // [FT, nb]
  float2* v = reinterpret_cast<float2*>(taps + FT * nb);  // [FH, W]
  float* cyc_c = reinterpret_cast<float*>(v + FH * W);    // [FH]
  const int b = blockIdx.z;
  const int64_t row0 = (int64_t)b * N;
  const float* cy = cyc + row0 * nhop;
  const int f0 = blockIdx.y * FT;
  const int fh0 = f0 - D;                          // frame of halo row 0
  const int k0 = blockIdx.x * KC, kc = min(KC, K - k0);

  for (int r = threadIdx.x; r < FH; r += kThreads) {
    const int f = fh0 + r;
    cyc_c[r] = (f >= 0 && f < N) ? cy[(int64_t)f * nhop] : 0.0f;
  }
  // the tile's taps and the chunk's (ampl, phse) with its halo columns
  // into shared memory, every load in flight at once (cp.async; zero
  // outside [0, K), outside the chunk and its halo, and outside the
  // utterance), then each thread rotates the elements it copied in place
  const float4* tg = taps_g + ((int64_t)b * Np + f0) * nb;
  for (int i = threadIdx.x; i < FT * nb; i += kThreads)
    llsm::cp_async16(taps + i, tg + i);
  const int dr = kThreads / W, dw = kThreads - dr * W;
  const int r0 = threadIdx.x / W, w0 = threadIdx.x - r0 * W;
  {
    int r = r0, w = w0;
    for (int idx = threadIdx.x; idx < FH * W; idx += kThreads) {
      const int f = fh0 + r, k = k0 - 2 + w;
      const bool live = f >= 0 && f < N && w >= 1 && w <= kc + 2 && k >= 0 &&
                        k < K;
      const int64_t o = live ? (row0 + f) * K + k : 0;
      float* e = reinterpret_cast<float*>(v + idx);
      llsm::cp_async4(e, ampl + o, live);
      llsm::cp_async4(e + 1, phse + o, live);
      r += dr;
      w += dw;
      if (w >= W) {
        w -= W;
        ++r;
      }
    }
  }
  llsm::cp_async_commit();
  llsm::cp_async_wait<0>();
  __syncthreads();
  // deconv_kernel's aligned track
  const float inv2pi = 0.15915494309189535f;
  {
    int r = r0, w = w0;
    for (int idx = threadIdx.x; idx < FH * W; idx += kThreads) {
      const int f = fh0 + r, k = k0 - 2 + w;
      if (f >= 0 && f < N && w >= 1 && w <= kc + 2 && k >= 0 && k < K) {
        const float2 ap = v[idx];
        const float ph = llsm::frac_c(
            ap.y * inv2pi - llsm::kmul_c((float)(k + 1), cyc_c[r]));
        float sn, co;
        sincospif(2.0f * ph, &sn, &co);
        v[idx] = make_float2(ap.x * co, ap.x * sn);
      }
      r += dr;
      w += dw;
      if (w >= W) {
        w -= W;
        ++r;
      }
    }
  }
  __syncthreads();

  const int fl0 = (threadIdx.x >> 5) * KF, kl = 2 * (threadIdx.x & 31);
  if (LLSM_SKIP_PASS_B || f0 + fl0 >= N || kl >= kc) return;
  float smr[KF][2], smi[KF][2];
#pragma unroll
  for (int q = 0; q < KF; ++q)
    smr[q][0] = smr[q][1] = smi[q][0] = smi[q][1] = 0.0f;
  const float2* vr = v + fl0 * W + kl;             // halo row fl0, column kl
  const float4* tp0 = taps + fl0 * nb;
  // halo rows fl0 + hr in order: those only some of the KF frames reach,
  // then those all reach, then the rest
  int hr = 0;
  for (; hr < KF - 1; ++hr)
    walk_row<KF, false>(vr + hr * W, tp0, hr, nb, smr, smi);
  for (; hr < nb; ++hr)
    walk_row<KF, true>(vr + hr * W, tp0, hr, nb, smr, smi);
  for (; hr < KF - 1 + nb; ++hr)
    walk_row<KF, false>(vr + hr * W, tp0, hr, nb, smr, smi);
#pragma unroll
  for (int q = 0; q < KF; ++q) {
    const int fl = fl0 + q, f = f0 + fl;
    if (f >= N) break;
    const int64_t o = (row0 + f) * K + k0 + kl;
    const float2* vc = v + (fl + D) * W + kl + 2;
    emit(vc, smr[q][0], smi[q][0], cyc_c[fl + D], mask, out_a, out_b, o,
         k0 + kl, polar);
    if (kl + 1 < kc)
      emit(vc + 1, smr[q][1], smi[q][1], cyc_c[fl + D], mask, out_a, out_b,
           o + 1, k0 + kl + 1, polar);
  }
}

template <int KF>
cudaError_t launch_out(const float* ampl, const float* phse, const float* cyc,
                       const float* mask, const float4* taps, float* out_a,
                       float* out_b, int B, int N, int Np, int K, int D,
                       int nhop, int polar, int KC, cudaStream_t stream) {
  constexpr int FT = kThreads / 32 * KF;
  const int FH = FT + 2 * D;
  const size_t smem = (size_t)FT * (2 * D + 1) * sizeof(float4) +
                      (size_t)FH * (KC + 4) * sizeof(float2) +
                      (size_t)FH * sizeof(float);
  cudaError_t e = llsm::allow_smem(deconv_out_kernel<KF>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((K + KC - 1) / KC, (N + FT - 1) / FT, B);
  deconv_out_kernel<KF><<<grid, kThreads, smem, stream>>>(
      ampl, phse, cyc, mask, taps, out_a, out_b, N, Np, K, D, nhop, polar,
      KC);
  return cudaGetLastError();
}

}  // namespace

// taps: the wide path's scratch [B, Np, 2 D + 1] float4, Np = N rounded up
// to 64 (null for the first kernel); FT, KC, TT, stage:
// kernels._deconv_geometry's frames a block and columns a chunk of the
// output (KC = 0: the first kernel), frames a block of the tap build and
// whether it stages the quadrature field
extern "C" int llsm_deconv_full(const float* ampl, const float* phse,
                                const float* cyc, const float* hw,
                                const float* mask, float* out_a,
                                float* out_b, void* taps, int B, int N, int K,
                                int D, int nhop, int stride, int polar,
                                int FT, int KC, int TT, int stage,
                                void* stream) {
  if (B <= 0 || N <= 0 || K <= 0) return (int)cudaGetLastError();
  if (D < 0 || nhop <= 0 || stride <= 0) return (int)cudaErrorInvalidValue;
  const int nq = 2 * nhop / stride;
  const int nb = 2 * D + 1;
  cudaStream_t st = (cudaStream_t)stream;
  if (KC > 0) {
    // the wide path: the taps into device memory, then the output
    if (KC % 2 || KC > 64 || !taps || B > 65535 || TT < 8 ||
        kTile % TT || (stage != 0 && stage != 1))
      return (int)cudaErrorInvalidValue;
    const int Np = (N + kTile - 1) / kTile * kTile;
    // the taps: unscaled [TT, nb] and the crossfade, the field beside them
    // where staged (kernels._deconv_taps_tile)
    const size_t smem =
        (size_t)TT * nb * sizeof(float4) + nq * sizeof(float) +
        (stage ? (size_t)(TT + 2 * D) * (nq + 1) * sizeof(float2) : 0);
    if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
    cudaError_t e = llsm::allow_smem(deconv_taps_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    float4* tg = static_cast<float4*>(taps);
    if (!LLSM_SKIP_PASS_A)
      deconv_taps_kernel<<<dim3(Np / TT, B), kThreads, smem, st>>>(
          cyc, hw, tg, N, Np, D, nhop, stride, nq, TT, stage);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    switch (FT) {
      case 64: e = launch_out<8>(ampl, phse, cyc, mask, tg, out_a, out_b, B,
                                 N, Np, K, D, nhop, polar, KC, st); break;
      case 32: e = launch_out<4>(ampl, phse, cyc, mask, tg, out_a, out_b, B,
                                 N, Np, K, D, nhop, polar, KC, st); break;
      case 16: e = launch_out<2>(ampl, phse, cyc, mask, tg, out_a, out_b, B,
                                 N, Np, K, D, nhop, polar, KC, st); break;
      case 8: e = launch_out<1>(ampl, phse, cyc, mask, tg, out_a, out_b, B,
                                N, Np, K, D, nhop, polar, KC, st); break;
      default: e = cudaErrorInvalidValue;
    }
    return (int)e;
  }
  const int FH = kTile + 2 * D;
  // kernels._deconv_smem mirrors this (the first kernel's bytes)
  const size_t smem = (size_t)kTile * nb * sizeof(float4) +
                      (size_t)FH * std::max(K, nq) * sizeof(float2) +
                      ((size_t)FH + nq) * sizeof(float);
  cudaError_t e = llsm::allow_smem(deconv_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + kTile - 1) / kTile, B);
  deconv_kernel<<<grid, kThreads, smem, st>>>(
      ampl, phse, cyc, hw, mask, out_a, out_b, N, K, D, nhop, stride, nq,
      polar);
  return (int)cudaGetLastError();
}
