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

  for (int r = threadIdx.x; r < FH; r += kThreads) {
    const int f = fh0 + r;
    cyc_c[r] = (f >= 0 && f < N) ? cy[(int64_t)f * nhop] : 0.0f;
  }
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    const float r = -(float)nhop + ((float)q + 0.5f) * (float)stride;
    wola[q] = 0.5f + 0.5f * cospif(r / (float)nhop);
  }
  // the staging loops below are unrolled so that a thread's global loads
  // are in flight together
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

  // taps: half a warp a frame, a lane an offset
  const int lane = threadIdx.x & 31, half = lane / kHalf, hl = lane % kHalf;
  const int pairs = kThreads / 32 * 2;
  for (int fl = (threadIdx.x / 32) * 2 + half;
       !LLSM_SKIP_PASS_A && fl < kTile; fl += pairs) {
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
            const float2 z = e[q];
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

}  // namespace

extern "C" int llsm_deconv_full(const float* ampl, const float* phse,
                                const float* cyc, const float* hw,
                                const float* mask, float* out_a,
                                float* out_b, int B, int N, int K, int D,
                                int nhop, int stride, int polar,
                                void* stream) {
  if (B <= 0 || N <= 0 || K <= 0) return (int)cudaGetLastError();
  if (D < 0 || nhop <= 0 || stride <= 0) return (int)cudaErrorInvalidValue;
  const int nq = 2 * nhop / stride;
  const int nb = 2 * D + 1, FH = kTile + 2 * D;
  // kernels._deconv_smem mirrors this (the wrapper's bound on D)
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
