// F0 refinement by the fundamental's phase slope on a lowpass-decimated
// signal (harmonics.refine_f0, its decimated branch; kernels.refine_f0_dec):
//   xd[b, m]  = sum_{t = 0..ntaps-1} h[t] x[b, m D + t - g]   (x zero outside
//               [0, nx); xd[m] zero outside [0, nxd) and where m D lies
//               outside [lo, hi): a frame shard's halo past the signal's edge)
//   frame n   = xd[n nhop_d - C + j], j in [0, Wf)
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
// Bound on the H100: operations -- a window and a sincos a column of the
// window's support (|noff| <= hw) an iteration, shared by both probes, two
// FMAs a probe, 2 iters a voiced frame (204800 frames at the bench shape),
// and the FIR's 97 taps a decimated output; reading x once takes under
// half of that.  Design: ONE launch, a block a run of F consecutive frames
// of one row, G lanes a frame (kernels._refine_geometry: F = 128 and G = 1
// -- a thread a frame -- where the batch gives two blocks an SM; else F =
// 8, 4 or 2 and G = 16, as for a one-file analyze()
// or a RTAnalyzer block, whose frames a lone thread each would leave the
// card waiting on one frame's serial work).
//   - FIR (pass A): the block computes the S = (F - 1) nhop_d + Wf
//     decimated samples its frames read straight from x, in chunks of 2T
//     outputs (T = F G threads, two outputs each).  A chunk's x samples
//     come into shared memory by cp.async while the block sums the chunk
//     before it (two buffers), as D rows of PQ words, sample i at (i mod D)
//     PQ + i / D: output o's tap t = q D + r sits at r PQ + o + q, so a
//     warp's loads of one tap fall on consecutive words (the old skew of a
//     word in 32 left a 2-way conflict at some taps; PQ = 32 / D mod 32
//     also spreads the staging writes over the banks); the taps are read D
//     at a time as vectors.  Each output sums its taps in increasing t in
//     float32, as the old decimate_kernel did, so blocks that overlap
//     compute equal values (the overlap recomputes (Wf - nhop_d) / (F
//     nhop_d) of the outputs, 10% at F = 128).  No xd tensor.
//   - G = 1 stages the samples as a polyphase table too, nhop_d rows of P:
//     the frames of a warp read column c of their windows at col[c] + f, on
//     consecutive words (at stride nhop_d = 10 they would fall 2 to a bank);
//     G = 16 keeps them in a row, where a frame's lanes read consecutive
//     columns.
//   - Probes (pass B): a frame's lanes run its iterations with no other
//     frame.  Each column noff of the support |noff| <= hw has its window
//     w(noff / hw) and (cos, sin) of its phase reduced mod 1 computed once,
//     for both probes (and, in the last iteration, the +delta probe's
//     double angle): half the window and trig work of a probe at a time.
//     Every sum has one order, the frame's alone: 16 partial sums, partial
//     l over the columns noff = l mod 16 in increasing noff, inside [0, Wf)
//     (the +delta probe's last column can fall at Wf: dropped, as the plain
//     version drops it), then added left to right, ((P0 + P1) + P2) + ...
//     + P15.  With G = 16 lane l sums partial l and 15 shuffles hand every
//     lane the partials in that order; with G = 1 the thread sums them one
//     after another.  So F, G, the batch and the block do not enter any
//     sum.  The column loop's bounds are the warp's widest support
//     (__reduce_max_sync): with G = 1 the lanes walk the columns together
//     and the table reads broadcast; a lane adds only its own support's.
//   Against the old kernel's arithmetic: the probe sums' order above (it
//   took 32 lane-strided partials from the support's first column and a
//   shuffle tree, which a lone thread could follow only by holding 32
//   partials, or 4 subtotals of a tree at 78 registers); u = (noff / hw +
//   1) / 2 is now fmaf(noff * (1 / hw), 0.5, 0.5) (a reciprocal an
//   iteration, not a division a column), and the support test is |noff|
//   <= hw on the integer offsets; phases stay cycles reduced mod 1 with
//   rintf (torch's half-to-even) before sincospif, the window the cosine
//   series (its cosines as cospif; the series' length a template argument,
//   as D) or mltsine's sinpif.
//
// The full-rate refine (harmonics.refine_f0 where no D in 8/4/2 divides
// the hop, e.g. 11 kHz at hop 55; kernels.refine_f0_full) is a second
// kernel here, refine_full_kernel.  It replaces the JAX package's
// full-rate probes (libllsm2_tpu/ops/harmonics.py:494-543), whose five
// harmonic_project_pallas K = 1 calls (pallas_osc.py:1388 -> :1417) each
// projected a [B N, 2 H + 1] tensor of gathered, windowed frames and
// cycle offsets built around the call:
//   probe(c, f, hw) = sum_{|noff| <= hw} w(noff / hw) x[c + noff]
//                     e^{-2 pi i ((noff f / fs) mod 1)}, x zero outside
//                     [0, nx), hw = clamp(rel_winsize fs / (2 f0s), 2, H)
//   each of `iters` iterations takes the probes at n nhop -+ delta (delta
//   = max(H / 8, 2)) at f = f0s and moves f0s by their wrapped phase error
//   over 2 delta samples, clamped as above; then the gate: a probe at n
//   nhop + delta and f = 2 f0s with hw from the final f0s, and a frame
//   keeps f0s only where the last +delta probe's power exceeds 1/16 of
//   the gate's.  No pass_hz clause (nothing is lowpassed).
// Bound on the H100: operations -- a window and a sincos a column of the
// support an iteration (shared by both probes, two FMAs each) and a
// window and sincos a column for the gate; x is read once, under a tenth
// of that.  Design: the decimated kernel's with D = 1 and no FIR.  A
// block takes F frames of one row (kernels._refine_geometry), copies the
// (F - 1) nhop + 2 (H + delta) + 1 samples they read from x into shared
// memory by cp.async (zero past the row's ends: the zero padding the
// plain version reads), in a row: with a thread a frame, a warp's frames
// read one column at a stride of nhop words, on 32 distinct banks when
// nhop is odd (the geometry gives an even hop 16 lanes a frame, whose
// lanes read consecutive words).  Each column's window and phasor serve
// both probes; the gate has its own at 2 f0s.  Every probe sum is 16
// fixed-order partials as above, so F, G, the batch and the block enter
// no sum.  No [B, N, W] tensor is made.
#include "common.cuh"

// LLSM_SKIP_PASS_{A,B} = 1 compiles the decimation into shared memory
// (pass A: the staged samples are zeros; the full-rate kernel's copy) or
// the probes (pass B: each frame writes its input F0) out, for the pass
// timings of scripts/port_kernel_passes.py; the library leaves both 0.
#ifndef LLSM_SKIP_PASS_A
#define LLSM_SKIP_PASS_A 0
#endif
#ifndef LLSM_SKIP_PASS_B
#define LLSM_SKIP_PASS_B 0
#endif

namespace {

constexpr int kMaxThreads = 128;    // threads a block, at most
constexpr int kOut = 2;             // FIR outputs a thread a chunk
constexpr int kParts = 16;          // partial sums of a probe quantity
constexpr float kTwoPi = 6.283185307179586f;

struct Probe {
  int Wf, C, delta_d, iters;
  float H_d, fs_d, dt_d, two_pi_dt, rel_fs, lo_mul, hi_mul, pass_hz;
  float a0, a1, a2, a3;             // cosine-series coefficients
};

using llsm::cp_async4;
using llsm::cp_async_commit;
using llsm::cp_async_wait;

// windows.window_eval(name, u) inside the support: a0 + sum_m a_m cos(2 pi
// m u) over NCOEF terms, or sin(pi u) for mltsine (NCOEF = 0)
template <int NCOEF>
__device__ __forceinline__ float window_u(const Probe& p, float u) {
  if (NCOEF == 0) return sinpif(u);
  float w = p.a0;
  if (NCOEF > 1) w = fmaf(p.a1, cospif(2.0f * u), w);
  if (NCOEF > 2) w = fmaf(p.a2, cospif(4.0f * u), w);
  if (NCOEF > 3) w = fmaf(p.a3, cospif(6.0f * u), w);
  return w;
}

// A probe iteration's six sums: the -delta probe's (re, im), the +delta
// probe's and its double angle's.
struct Sums {
  float rm, im, rp, ip, r2, i2;
};

__device__ __forceinline__ Sums operator+(const Sums& a, const Sums& b) {
  return {a.rm + b.rm, a.im + b.im, a.rp + b.rp,
          a.ip + b.ip, a.r2 + b.r2, a.i2 + b.i2};
}

// Every lane of a 16-lane group gets ((v_0 + v_1) + v_2) + ... + v_15, v_l
// lane l's value: the order in which a lone thread adds the partials.
__device__ __forceinline__ float group_chain(float v) {
  float total = __shfl_sync(0xffffffffu, v, 0, kParts);
#pragma unroll
  for (int l = 1; l < kParts; ++l)
    total += __shfl_sync(0xffffffffu, v, l, kParts);
  return total;
}

template <int D, int NCOEF>
__global__ void __launch_bounds__(kMaxThreads)
refine_kernel(const float* __restrict__ x, const float* __restrict__ f0,
              const float* __restrict__ taps, float* __restrict__ out,
              int nx, int N, int ntaps, int g, int nhop_d, int G, int P,
              int PQ, long long lo, long long hi, Probe p) {
  extern __shared__ __align__(16) float sm[];
  const int T = blockDim.x, t = threadIdx.x;
  const int gs = __ffs(G) - 1;             // G = 1 or kParts: log2 G
  const int F = T >> gs, f = t >> gs, j = t & (G - 1);
  const int ntaps4 = (ntaps + 3) & ~3;
  float* h = sm;                           // [ntaps]
  float* xq = h + ntaps4;                  // 2 x D rows of PQ: x's chunks
  float* xs = xq + 2 * D * PQ;             // staged xd (see poly)
  const bool poly = G == 1;                // the staged table's layout
  int* col = reinterpret_cast<int*>(xs + (poly ? nhop_d * P : (F - 1) *
                                          nhop_d + p.Wf));   // [Wf]
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * F, n = n0 + f;
  const int S = (F - 1) * nhop_d + p.Wf;
  const long long m0 = (long long)n0 * nhop_d - p.C;   // staged sample 0
  for (int i = t; i < ntaps; i += T) h[i] = taps[i];
  // staged sample i at slot(i): G = 1, nhop_d rows of P (i mod nhop_d,
  // i / nhop_d); G = kParts, in a row
  auto slot = [&](int i) { return poly ? (i % nhop_d) * P + i / nhop_d : i; };
  for (int c = t; c < p.Wf; c += T) col[c] = slot(c);
#if LLSM_SKIP_PASS_A
  for (int i = t; i < S; i += T) xs[slot(i)] = 0.0f;
#else
  const float* xb = x + (long long)b * nx;
  const long long nxd = nx / D;
  const int Q = kOut * T, qfull = ntaps / D, nchunk = (S + Q - 1) / Q;
  // chunk c's x samples into buffer c & 1, asynchronously (cp.async: no
  // registers held; 0 written where x has no sample)
  auto stage = [&](int c) {
    const int k0 = c * Q, span = (min(Q, S - k0) - 1) * D + ntaps;
    const int s0 = (int)((m0 + k0) * D - g);   // x's index of sample 0
    float* buf = xq + (c & 1) * D * PQ;
    for (int i = t; i < span; i += T) {
      const int s = s0 + i;
      const bool in = (unsigned)s < (unsigned)nx;
      cp_async4(buf + (i % D) * PQ + i / D, in ? xb + s : xb, in);
    }
    cp_async_commit();
  };
  stage(0);
  for (int c = 0; c < nchunk; ++c) {
    const int k0 = c * Q, nout = min(Q, S - k0);
    if (c + 1 < nchunk) {
      stage(c + 1);                        // overlaps this chunk's sums
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                       // chunk c is in for every thread
    // outputs o0 = t and o1 = t + T of the chunk; o1 may lie past nout (its
    // loads stay inside the chunk's rows, its sum is not stored)
    const float* r0 = xq + (c & 1) * D * PQ + t;
    float acc0 = 0.0f, acc1 = 0.0f;
    int q = 0;
    for (; q < qfull; ++q) {
      float hq[D];                         // taps q D .. q D + D - 1
      if (D == 2) {
        const float2 v = reinterpret_cast<const float2*>(h)[q];
        hq[0] = v.x;
        hq[1] = v.y;
      } else {
#pragma unroll
        for (int r = 0; r < D; r += 4) {
          const float4 v = reinterpret_cast<const float4*>(h + q * D + r)[0];
          hq[r] = v.x;
          hq[r + 1] = v.y;
          hq[r + 2] = v.z;
          hq[r + 3] = v.w;
        }
      }
#pragma unroll
      for (int r = 0; r < D; ++r) {
        acc0 = fmaf(hq[r], r0[r * PQ + q], acc0);
        acc1 = fmaf(hq[r], r0[r * PQ + q + T], acc1);
      }
    }
    for (int r = 0; q * D + r < ntaps; ++r) {
      acc0 = fmaf(h[q * D + r], r0[r * PQ + q], acc0);
      acc1 = fmaf(h[q * D + r], r0[r * PQ + q + T], acc1);
    }
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      const int o = t + k * T;
      if (o >= nout) break;
      const int i = k0 + o;
      const long long m = m0 + i, pos = m * D;
      const bool in = m >= 0 && m < nxd && pos >= lo && pos < hi;
      xs[slot(i)] = in ? (k == 0 ? acc0 : acc1) : 0.0f;
    }
    __syncthreads();                       // buffer c & 1 is free again
  }
#endif
  __syncthreads();
  const bool valid = n < N;
  const long long idx = (long long)b * N + n;
  const float f0v = valid ? f0[idx] : 0.0f;
#if LLSM_SKIP_PASS_B
  if (valid && j == 0) out[idx] = f0v;
#else
  const bool voiced = f0v > 0.0f;
  // T is a multiple of 32: every warp is whole here, and a group's lanes
  // leave together
  if (!__any_sync(0xffffffffu, voiced)) {
    if (valid && j == 0) out[idx] = 0.0f;
    return;
  }
  // column c of this frame: fr[col[c]] (G = 1: the polyphase table; G =
  // 16: col[c] = c, the frame's samples in a row)
  const float* fr = xs + (G == 1 ? f : f * nhop_d);
  const int cm = p.C - p.delta_d, cp = p.C + p.delta_d;
  float f0s = voiced ? f0v : 100.0f, p1 = 0.0f, p2 = 0.0f;
  for (int it = 0; it < p.iters; ++it) {
    const float hw = fminf(fmaxf(p.rel_fs / (2.0f * f0s), 2.0f), p.H_d);
    const float d = f0s / p.fs_d;
    const float rhw = 1.0f / hw;
    const int R = voiced ? (int)hw : -1;   // the support |noff| <= hw
    const int Rw = __reduce_max_sync(0xffffffffu, R);
    const bool dbl = it == p.iters - 1;
    const int k0 = max(-Rw, -cp), k1 = min(Rw, p.Wf - 1 - cm);
    const int kb = k0 & ~(kParts - 1);
    // partial l of the sums: the columns noff = l mod kParts in [k0, k1]
    // and the frame's support, in increasing noff
    auto partial = [&](int l) {
      Sums a{};
      // the partial's first column at or after k0
      for (int k = kb + l + (kb + l < k0 ? kParts : 0); k <= k1;
           k += kParts) {
        if (abs(k) > R) continue;
        const float nf = (float)k;
        const float w = window_u<NCOEF>(p, fmaf(nf * rhw, 0.5f, 0.5f));
        const float q = nf * d;
        float s, c;
        sincospif(2.0f * (q - rintf(q)), &s, &c);
        if (k >= -cm) {                    // k <= Wf - 1 - cm by k1
          const float xw = fr[col[cm + k]] * w;
          a.rm = fmaf(c, xw, a.rm);
          a.im = fmaf(-s, xw, a.im);
        }
        if (k >= -cp && k <= p.Wf - 1 - cp) {
          const float xw = fr[col[cp + k]] * w;
          a.rp = fmaf(c, xw, a.rp);
          a.ip = fmaf(-s, xw, a.ip);
          if (dbl) {
            a.r2 = fmaf(2.0f * c * c - 1.0f, xw, a.r2);
            a.i2 = fmaf(-2.0f * s * c, xw, a.i2);
          }
        }
      }
      return a;
    };
    Sums tot{};
    if (G == 1) {                          // the partials in order
      tot = partial(0);
      for (int l = 1; l < kParts; ++l) tot = tot + partial(l);
    } else {                               // lane l sums partial l
      tot = partial(j);
      tot = {group_chain(tot.rm), group_chain(tot.im), group_chain(tot.rp),
             group_chain(tot.ip), group_chain(tot.r2), group_chain(tot.i2)};
    }
    const float ph_m = atan2f(tot.im, tot.rm), ph_p = atan2f(tot.ip, tot.rp);
    p1 = tot.rp * tot.rp + tot.ip * tot.ip;
    if (dbl) p2 = tot.r2 * tot.r2 + tot.i2 * tot.i2;
    const float expected = (kTwoPi * f0s) * p.dt_d;
    float err = ph_p - ph_m - expected;
    err = atan2f(sinf(err), cosf(err));
    const float f0_new = f0s + err / p.two_pi_dt;
    f0s = fminf(fmaxf(f0_new, f0v * p.lo_mul - 1.0f), f0v * p.hi_mul + 1.0f);
  }
  const bool keep = (p1 > 0.0625f * p2) || (2.0f * f0s >= p.pass_hz);
  if (valid && j == 0) out[idx] = voiced ? (keep ? f0s : f0v) : 0.0f;
#endif
}

using Kernel = void (*)(const float*, const float*, const float*, float*,
                        int, int, int, int, int, int, int, int, long long,
                        long long, Probe);

template <int D>
Kernel pick(int ncoef) {
  switch (ncoef) {
    case 0: return refine_kernel<D, 0>;
    case 2: return refine_kernel<D, 2>;
    case 3: return refine_kernel<D, 3>;
    case 4: return refine_kernel<D, 4>;
    default: return nullptr;
  }
}

// The full-rate iteration's four sums: the -delta probe's (re, im) and
// the +delta probe's.
struct Quad {
  float rm, im, rp, ip;
};

__device__ __forceinline__ Quad operator+(const Quad& a, const Quad& b) {
  return {a.rm + b.rm, a.im + b.im, a.rp + b.rp, a.ip + b.ip};
}

// Partial l's first column at or after k0: the columns noff = l mod
// kParts, in increasing noff.
__device__ __forceinline__ int first_col(int k0, int l) {
  const int k = (k0 & ~(kParts - 1)) + l;
  return k < k0 ? k + kParts : k;
}

// Column k's window weight w(k / hw) (rhw = 1 / hw) and phasor (c, s) of
// its phase k d cycles reduced mod 1.
template <int NCOEF>
__device__ __forceinline__ void column(const Probe& p, int k, float rhw,
                                       float d, float& w, float& c,
                                       float& s) {
  const float nf = (float)k;
  w = window_u<NCOEF>(p, fmaf(nf * rhw, 0.5f, 0.5f));
  const float q = nf * d;
  sincospif(2.0f * (q - rintf(q)), &s, &c);
}

// Probe's fields at the full rate (D = 1): Wf = 2 C + 1, C = H + delta,
// delta_d = delta, H_d = H, fs_d = fs, dt_d = 2 delta / fs; pass_hz unused.
template <int NCOEF>
__global__ void __launch_bounds__(kMaxThreads)
refine_full_kernel(const float* __restrict__ x, const float* __restrict__ f0,
                   float* __restrict__ out, int nx, int N, int nhop, int G,
                   Probe p) {
  extern __shared__ __align__(16) float sm[];
  const int T = blockDim.x, t = threadIdx.x;
  const int gs = __ffs(G) - 1;             // G = 1 or kParts: log2 G
  const int F = T >> gs, f = t >> gs, j = t & (G - 1);
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * F, n = n0 + f;
  const int S = (F - 1) * nhop + p.Wf;
#if LLSM_SKIP_PASS_A
  for (int i = t; i < S; i += T) sm[i] = 0.0f;
#else
  // staged sample i is x[n0 nhop - C + i] (0 past the row's ends)
  const long long m0 = (long long)n0 * nhop - p.C;
  const float* xb = x + (long long)b * nx;
  for (int i = t; i < S; i += T) {
    const long long s = m0 + i;
    const bool in = s >= 0 && s < nx;
    cp_async4(sm + i, in ? xb + s : xb, in);
  }
  cp_async_commit();
  cp_async_wait<0>();
#endif
  __syncthreads();
  const bool valid = n < N;
  const long long idx = (long long)b * N + n;
  const float f0v = valid ? f0[idx] : 0.0f;
#if LLSM_SKIP_PASS_B
  if (valid && j == 0) out[idx] = f0v;
#else
  const bool voiced = f0v > 0.0f;
  // T is a multiple of 32: every warp is whole here, and a group's lanes
  // leave together
  if (!__any_sync(0xffffffffu, voiced)) {
    if (valid && j == 0) out[idx] = 0.0f;
    return;
  }
  // x[n nhop - delta + k] at xm[k] and x[n nhop + delta + k] at xp[k],
  // |k| <= H
  const float* xm = sm + f * nhop + (p.C - p.delta_d);
  const float* xp = xm + 2 * p.delta_d;
  float f0s = voiced ? f0v : 100.0f, p1 = 0.0f;
  for (int it = 0; it < p.iters; ++it) {
    const float hw = fminf(fmaxf(p.rel_fs / (2.0f * f0s), 2.0f), p.H_d);
    const float d = f0s / p.fs_d, rhw = 1.0f / hw;
    const int R = voiced ? (int)hw : -1;   // the support |noff| <= hw
    // the lanes walk the warp's widest support together
    const int Rw = __reduce_max_sync(0xffffffffu, R);
    auto partial = [&](int l) {
      Quad a{};
      for (int k = first_col(-Rw, l); k <= Rw; k += kParts) {
        if (abs(k) > R) continue;
        float w, c, s;
        column<NCOEF>(p, k, rhw, d, w, c, s);
        const float vm = xm[k] * w, vp = xp[k] * w;
        a.rm = fmaf(c, vm, a.rm);
        a.im = fmaf(-s, vm, a.im);
        a.rp = fmaf(c, vp, a.rp);
        a.ip = fmaf(-s, vp, a.ip);
      }
      return a;
    };
    Quad tot{};
    if (G == 1) {                          // the partials in order
      tot = partial(0);
      for (int l = 1; l < kParts; ++l) tot = tot + partial(l);
    } else {                               // lane l sums partial l
      tot = partial(j);
      tot = {group_chain(tot.rm), group_chain(tot.im), group_chain(tot.rp),
             group_chain(tot.ip)};
    }
    const float ph_m = atan2f(tot.im, tot.rm), ph_p = atan2f(tot.ip, tot.rp);
    p1 = tot.rp * tot.rp + tot.ip * tot.ip;
    float err = ph_p - ph_m - (kTwoPi * f0s) * p.dt_d;
    err = atan2f(sinf(err), cosf(err));
    const float f0_new = f0s + err / p.two_pi_dt;
    f0s = fminf(fmaxf(f0_new, f0v * p.lo_mul - 1.0f), f0v * p.hi_mul + 1.0f);
  }
  // the gate: the +delta probe at 2 f0s, its window from the final f0s
  const float hw = fminf(fmaxf(p.rel_fs / (2.0f * f0s), 2.0f), p.H_d);
  const float d = (2.0f * f0s) / p.fs_d, rhw = 1.0f / hw;
  const int R = voiced ? (int)hw : -1;
  const int Rw = __reduce_max_sync(0xffffffffu, R);
  auto partial = [&](int l) {
    float2 a = make_float2(0.0f, 0.0f);
    for (int k = first_col(-Rw, l); k <= Rw; k += kParts) {
      if (abs(k) > R) continue;
      float w, c, s;
      column<NCOEF>(p, k, rhw, d, w, c, s);
      const float v = xp[k] * w;
      a.x = fmaf(c, v, a.x);
      a.y = fmaf(-s, v, a.y);
    }
    return a;
  };
  float2 g2;
  if (G == 1) {
    g2 = partial(0);
    for (int l = 1; l < kParts; ++l) {
      const float2 v = partial(l);
      g2.x += v.x;
      g2.y += v.y;
    }
  } else {
    g2 = partial(j);
    g2 = make_float2(group_chain(g2.x), group_chain(g2.y));
  }
  const float p2 = g2.x * g2.x + g2.y * g2.y;
  const bool keep = p1 > 0.0625f * p2;
  if (valid && j == 0) out[idx] = voiced ? (keep ? f0s : f0v) : 0.0f;
#endif
}

using FullKernel = void (*)(const float*, const float*, float*, int, int,
                            int, int, Probe);

FullKernel pick_full(int ncoef) {
  switch (ncoef) {
    case 0: return refine_full_kernel<0>;
    case 2: return refine_full_kernel<2>;
    case 3: return refine_full_kernel<3>;
    case 4: return refine_full_kernel<4>;
    default: return nullptr;
  }
}

}  // namespace

// F, G, P, PQ: kernels._refine_geometry's frames a block, lanes a frame,
// rows of the staged samples' table and of the x chunk's
extern "C" int llsm_refine_f0_dec(
    const float* x, const float* f0, const float* taps, float* out, int B,
    int nx, int N, int D, int g, int ntaps, int nhop_d, int C, int Wf,
    int delta_d, int iters, float H_d, float fs_d, float dt_d,
    float two_pi_dt, float rel_fs, float lo_mul, float hi_mul, float pass_hz,
    long long lo, long long hi, float a0, float a1, float a2, float a3,
    int ncoef, int F, int G, int P, int PQ, void* stream) {
  const Kernel k = D == 2 ? pick<2>(ncoef) : D == 4 ? pick<4>(ncoef)
                 : D == 8 ? pick<8>(ncoef) : nullptr;
  const int T = F * G;
  const long long S = (long long)(F - 1) * nhop_d + Wf;
  if (!k || ntaps < 1 || nhop_d < 1 || Wf < 1 || F < 1 ||
      (G != 1 && G != kParts) || T % 32 || T > kMaxThreads ||
      (G == 1 && (long long)P * nhop_d < S) ||
      PQ < kOut * T + (ntaps + D - 1) / D - 1)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)(((ntaps + 3) & ~3) + 2 * D * PQ +
                               (G == 1 ? nhop_d * P : S) + Wf) *
                      sizeof(float);
  cudaError_t e = llsm::allow_smem(k, smem);
  if (e != cudaSuccess) return (int)e;
  const Probe p{Wf,      C,      delta_d, iters,  H_d, fs_d, dt_d, two_pi_dt,
                rel_fs, lo_mul, hi_mul,  pass_hz, a0,  a1,   a2,   a3};
  const dim3 grid((unsigned)((N + F - 1) / F), (unsigned)B);
  k<<<grid, T, smem, (cudaStream_t)stream>>>(x, f0, taps, out, nx, N, ntaps,
                                             g, nhop_d, G, P, PQ, lo, hi, p);
  return (int)cudaGetLastError();
}

// The full-rate refine: F, G kernels._refine_geometry's frames a block and
// lanes a frame (D = 1); H the window's largest halfwidth, delta the
// probes' offset, dt = 2 delta / fs, rel_fs = rel_winsize fs
extern "C" int llsm_refine_f0_full(
    const float* x, const float* f0, float* out, int B, int nx, int N,
    int nhop, int H, int delta, int iters, float fs, float dt,
    float two_pi_dt, float rel_fs, float lo_mul, float hi_mul, float a0,
    float a1, float a2, float a3, int ncoef, int F, int G, void* stream) {
  const FullKernel k = pick_full(ncoef);
  const int T = F * G;
  const long long C = (long long)H + delta, Wf = 2 * C + 1;
  const long long S = (long long)(F - 1) * nhop + Wf;
  if (!k || nhop < 1 || H < 0 || delta < 1 || F < 1 ||
      (G != 1 && G != kParts) || T % 32 || T > kMaxThreads || B > 65535 ||
      S > (1 << 20))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)S * sizeof(float);
  cudaError_t e = llsm::allow_smem(k, smem);
  if (e != cudaSuccess) return (int)e;
  const Probe p{(int)Wf, (int)C,  delta,  iters,  (float)H, fs,  dt,
                two_pi_dt, rel_fs, lo_mul, hi_mul, 0.0f,     a0,  a1,
                a2,        a3};
  const dim3 grid((unsigned)((N + F - 1) / F), (unsigned)B);
  k<<<grid, T, smem, (cudaStream_t)stream>>>(x, f0, out, nx, N, nhop, G, p);
  return (int)cudaGetLastError();
}
