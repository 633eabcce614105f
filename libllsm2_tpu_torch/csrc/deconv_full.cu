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
// 56 at K = 80) deconv_wide_kernel takes the shapes: the output couples
// only c_{k-1}, c_k and c_{k+1}, so K is cut into chunks of KC columns
// staged with one halo column each side, and the frame tile shrinks to 32,
// 16 or 8 frames where the taps of 64 frames alone fill shared memory (D
// past 113).  A block builds its frames' taps once, as deconv_kernel
// builds them (from the staged field, or where the field's [FH, nq] rows
// do not fit beside the taps, from the cycle track itself: the same
// values), then walks the chunks of its share (gridDim.y blocks share a
// tile's chunks: 1 builds the taps once a tile, one a chunk rebuilds them
// a chunk; kernels._deconv_geometry picks).  Both kernels build the taps
// through one device function (build_taps) and take each output's sums in
// the same order (output_step is deconv_kernel's output pass), so where
// both take a shape they give the same bits.
#include <algorithm>

#include "common.cuh"

// LLSM_SKIP_PASS_{A,B} = 1 compiles the tap build or the output pass out,
// for the pass timings of scripts/port_kernel_passes.py; the library leaves
// both 0.
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
constexpr size_t kSmemMax = 232448; // the H100's shared memory a block

// Both kernels stage the centre cycles and build the taps through the
// functions below; stage_field and output_step are the wide kernel's, and
// deconv_kernel keeps its own copies of their code: through them ptxas
// gives it 56 registers against its 55, the code otherwise the same.
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

// The quadrature field eq [FH, nq] of the halo rows (zero outside the
// utterance).  The loop is unrolled so that a thread's global loads are in
// flight together.
__device__ __forceinline__ void stage_field(float2* eq,
                                            const float* __restrict__ cy,
                                            int fh0, int FH, int N, int nhop,
                                            int stride, int nq, int64_t nx) {
  const int dq = kThreads / nq, dqq = kThreads - dq * nq;
  int rq = threadIdx.x / nq, qq = threadIdx.x - rq * nq;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < FH * nq; idx += kThreads) {
    const int f = fh0 + rq;
    float2 e = make_float2(0.0f, 0.0f);
    if (f >= 0 && f < N) e = field_point(cy, f, qq, nhop, stride, nx);
    eq[idx] = e;
    rq += dq;
    qq += dqq;
    if (qq >= nq) {
      qq -= nq;
      ++rq;
    }
  }
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

// The output of harmonic kk (staged in column wk of v's rows of W columns)
// for frames fl0 .. fl0 + kF - 1 of the tile at f0: the walk of the kF - 1
// + nb halo rows, each row's (c_{k-1}, c_k, c_{k+1}) feeding the taps of
// the kF frames that reach it, then un-aligned, masked and converted.
__device__ __forceinline__ void output_step(
    const float2* v, const float4* taps, const float* cyc_c,
    const float* __restrict__ mask, float* __restrict__ out_a,
    float* __restrict__ out_b, int64_t row0, int f0, int fl0, int kk, int wk,
    int W, int K, int N, int D, int polar) {
  const int nb = 2 * D + 1;
  float smr[kF], smi[kF];
#pragma unroll
  for (int q = 0; q < kF; ++q) smr[q] = smi[q] = 0.0f;
  const bool up = kk + 1 < K, dn = kk >= 1;
  const float2 zero = make_float2(0.0f, 0.0f);
  for (int hr = 0; hr < kF - 1 + nb; ++hr) {      // halo row fl0 + hr
    const int h = (fl0 + hr) * W + wk;
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
    const float2 cc = v[(fl + D) * W + wk];
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
  // stage_field's loop (see above); the staging loops are unrolled so that
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

  // output: harmonic k of frames fl0 .. fl0 + kF - 1 (output_step's code)
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

// The second path (see the header): a block takes FT frames of one
// utterance and the K chunks c = blockIdx.y, blockIdx.y + gridDim.y, ...
// of KC columns each.  Shared memory: taps [FT, 2D + 1] float4, then the
// field [FH, nq] (where `stage`) and, once the taps are built, a chunk's
// columns with their halo [FH, KC + 2] float2 in its place, then the
// centre cycles [FH] and the crossfade [nq].
__global__ void __launch_bounds__(kThreads)
deconv_wide_kernel(const float* __restrict__ ampl,
                   const float* __restrict__ phse,
                   const float* __restrict__ cyc, const float* __restrict__ hw,
                   const float* __restrict__ mask, float* __restrict__ out_a,
                   float* __restrict__ out_b, int N, int K, int D, int nhop,
                   int stride, int nq, int polar, int FT, int KC,
                   int stage) {
  extern __shared__ float4 sm4[];
  const int nb = 2 * D + 1;
  const int FH = FT + 2 * D;
  const int W = KC + 2;                 // a chunk's columns with its halo
  float4* taps = sm4;                                     // [FT, nb]
  float2* v = reinterpret_cast<float2*>(taps + FT * nb);  // [FH, W]
  float2* eq = v;                      // [FH, nq], before v is built
  float* cyc_c =
      reinterpret_cast<float*>(v + (stage ? max(FH * W, FH * nq) : FH * W));
  float* wola = cyc_c + FH;                               // [nq]
  const int b = blockIdx.z;
  const int64_t row0 = (int64_t)b * N;
  const int64_t nx = (int64_t)N * nhop;
  const float* cy = cyc + (int64_t)b * nx;
  const int f0 = blockIdx.x * FT;
  const int fh0 = f0 - D;                          // frame of halo row 0

  stage_cycles(cyc_c, wola, cy, fh0, FH, N, nhop, stride, nq);
  if (stage) stage_field(eq, cy, fh0, FH, N, nhop, stride, nq, nx);
  __syncthreads();
  build_taps(taps, eq, wola, hw, cy, row0, f0, FT, N, D, nhop, stride, nq,
             nx, stage);
  __syncthreads();                  // the field is read; v takes its place

  const float inv2pi = 0.15915494309189535f;
  const int groups = FT / kF;
  for (int c = blockIdx.y; c * KC < K; c += gridDim.y) {
    const int k0 = c * KC, kc = min(KC, K - k0);
    const int w0 = kc + 2;          // staged columns k0 - 1 .. k0 + kc
    // the chunk's aligned track and its halo columns (zero outside [0, K)
    // and outside the utterance)
    {
      const int dr = kThreads / w0, dw = kThreads - dr * w0;
      int r = threadIdx.x / w0, w = threadIdx.x - r * w0;
#pragma unroll 8
      for (int idx = threadIdx.x; idx < FH * w0; idx += kThreads) {
        const int f = fh0 + r, k = k0 - 1 + w;
        float2 cv = make_float2(0.0f, 0.0f);
        if (f >= 0 && f < N && k >= 0 && k < K) {
          const int64_t o = (row0 + f) * K + k;
          const float ph = llsm::frac_c(
              __ldg(phse + o) * inv2pi -
              llsm::kmul_c((float)(k + 1), cyc_c[r]));
          float s, co;
          sincospif(2.0f * ph, &s, &co);
          const float a = __ldg(ampl + o);
          cv = make_float2(a * co, a * s);
        }
        v[r * W + w] = cv;
        r += dr;
        w += dw;
        if (w >= w0) {
          w -= w0;
          ++r;
        }
      }
    }
    __syncthreads();

    // output: harmonic k0 + kl of frames fl0 .. fl0 + kF - 1, the sums of
    // deconv_kernel's output pass
    const int dg = kThreads / kc, dkl = kThreads - dg * kc;
    int grp = threadIdx.x / kc, kl = threadIdx.x - grp * kc;
    for (int idx = threadIdx.x; !LLSM_SKIP_PASS_B && idx < groups * kc;
         idx += kThreads) {
      const int fl0 = grp * kF;
      if (f0 + fl0 >= N) break;
      const int kk = k0 + kl, wk = kl + 1;   // its staged column
      grp += dg;
      kl += dkl;
      if (kl >= kc) {
        kl -= kc;
        ++grp;
      }
      output_step(v, taps, cyc_c, mask, out_a, out_b, row0, f0, fl0, kk, wk,
                  W, K, N, D, polar);
    }
    __syncthreads();                // before the next chunk's columns
  }
}

}  // namespace

extern "C" int llsm_deconv_full(const float* ampl, const float* phse,
                                const float* cyc, const float* hw,
                                const float* mask, float* out_a,
                                float* out_b, int B, int N, int K, int D,
                                int nhop, int stride, int polar, int FT,
                                int KC, int chunk_blocks, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0) return (int)cudaGetLastError();
  if (D < 0 || nhop <= 0 || stride <= 0) return (int)cudaErrorInvalidValue;
  const int nq = 2 * nhop / stride;
  const int nb = 2 * D + 1;
  if (KC > 0) {
    // deconv_wide_kernel: FT frames a block, chunks of KC columns shared by
    // chunk_blocks blocks a tile (kernels._deconv_geometry mirrors the
    // bytes)
    if (FT < kF || FT % kF || KC > kThreads / 2 || chunk_blocks < 1 ||
        B > 65535)
      return (int)cudaErrorInvalidValue;
    const int FH = FT + 2 * D;
    const size_t fixed = (size_t)FT * nb * sizeof(float4) +
                         ((size_t)FH + nq) * sizeof(float);
    // the field is staged where its rows fit beside the taps
    const int stage = fixed + (size_t)FH * std::max(KC + 2, nq) *
                                  sizeof(float2) <= kSmemMax;
    const size_t smem =
        fixed + (size_t)FH * (stage ? std::max(KC + 2, nq) : KC + 2) *
                    sizeof(float2);
    cudaError_t e = llsm::allow_smem(deconv_wide_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    const int nchunks = (K + KC - 1) / KC;
    dim3 grid((N + FT - 1) / FT, std::min(chunk_blocks, nchunks), B);
    deconv_wide_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        ampl, phse, cyc, hw, mask, out_a, out_b, N, K, D, nhop, stride, nq,
        polar, FT, KC, stage);
    return (int)cudaGetLastError();
  }
  const int FH = kTile + 2 * D;
  // kernels._deconv_smem mirrors this (the first kernel's bytes)
  const size_t smem = (size_t)kTile * nb * sizeof(float4) +
                      (size_t)FH * std::max(K, nq) * sizeof(float2) +
                      ((size_t)FH + nq) * sizeof(float);
  cudaError_t e = llsm::allow_smem(deconv_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + kTile - 1) / kTile, B);
  deconv_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      ampl, phse, cyc, hw, mask, out_a, out_b, N, K, D, nhop, stride, nq,
      polar);
  return (int)cudaGetLastError();
}
