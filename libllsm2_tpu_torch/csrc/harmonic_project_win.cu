// Fused pitch-synchronous framing + cosine window + chirped harmonic
// projection, read straight from the signal and its cycle track:
//
//   re[n,k] + j im[n,k] = sum_w x_n(w) win_n(w) e^{-2 pi j (k+1) dc_n(w)}
//   wsum[n] = sum_w win_n(w),  xsum[n] = sum_w x_n(w) win_n(w)  (k = 0 row)
//
// Frame n of row b covers samples s = n nhop - C + w, w in [0, 2C), C the
// center column: x_n(w) = x[b, s] (zero outside [0, nx)), dc_n(w) =
// cyc[b', clamp(s)] - cyc[b', n nhop] (the same float32 subtraction as
// framing the edge-padded track), b' = b / rep the cycle row of x row b.
// win_n is the cosine-series window c0 + sum_m c_m cos(2 pi m u),
// u = ((w - C)/hw[n] + 1)/2, zero outside |w - C| <= hw[n].  Only columns in
// [lo[n], hi[n]) are visited (the window's support); slots k >= kl[n]
// are written as exact zeros.
//
// Replaces libllsm2_tpu/ops/pallas_osc.py: harmonic_project_win_pallas
// (_proj_win_kernel), together with the framing its callers did.  Bound
// on the H100: arithmetic on the live (window x harmonic) rectangle,
// ~hw x fnyq/f0 complex rotate-and-accumulate steps per frame; memory is
// one read of x and cyc per row (frames overlap 2C / nhop = 12 times).
// Design: a block takes a tile of kTile consecutive frames of one row and
// stages the tile's span of x and cyc, (kTile - 1) nhop + 2C samples,
// once in shared memory by cp.async, all its loads in flight together
// with the frames' parameters -- no [R, W] frame buffers.  One warp per
// frame: each lane takes every 32nd live column, evaluates the window and
// the reduced offset r there, and computes z = e^{2 pi j r} once; the
// harmonics run through register accumulators in chunks of CH (the
// rotation recurrence w <- w z inside a chunk, the chunk start carried by
// z^CH, itself exact from sincospif), so a column's trig is two or three
// sincospif for all K harmonics.  The frame's live chunk count picks a
// loop whose body is one branch-free block that, with 16 or more live
// slots, sets up the next column while it rotates the current one (the
// setup is ~200 dependent instructions, the rotations 97 independent ones
// a chunk).  Each
// chunk's 2 CH sums are then reduced by a warp reduce-scatter (2 CH - 1
// shuffles for 2 CH values, no block barrier), and lane l stores value
// l: consecutive lanes write a frame's re and im slots.  Chunks at or
// above kl[n] are never computed; unvoiced frames (kl = 0) sum the window
// only.
//
// Wherever kTile frames' span would not leave room for two blocks an SM
// (kernels._proj_win_geometry: 48 kHz from a 20 ms hop, 96 kHz at 200 ms)
// proj_win_warp_kernel runs the same frames, every bit the same, with no
// tile: a warp a frame, two frames a block (a block is freed as soon as
// its two frames are done, however unequal the frames' spans and live
// slots), each warp staging only its frame's live columns, by cp.async in
// chunks through two buffers of its own, the next chunk in flight while
// the current one rotates.  Where frames overlap most (2C / nhop up to 20
// at 96 kHz / 5 ms) each sample is restaged once a frame that reads it,
// from L2, where the tile staged it once; the warp kernel still wins
// there at K 80, and at K 4 where the tile fits only one block an SM
// (scripts/port_proj_route.py): eight warps an SM where the tile held
// four.  A lane takes the same columns in the same order in every layout,
// so a frame's sums do not depend on it.
#include "common.cuh"

// LLSM_SKIP_PASS_{A,B} = 1 compiles the warp kernel's harmonics (every
// frame's slots treated as dead: only the window and x sums walk the
// columns) or its whole column walk out (scripts/port_kernel_passes.py
// only=proj_part); the 16-frame tile is built the same either way.
#ifndef LLSM_SKIP_PASS_A
#define LLSM_SKIP_PASS_A 0
#endif
#ifndef LLSM_SKIP_PASS_B
#define LLSM_SKIP_PASS_B 0
#endif

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;          // frames a block
constexpr int kWarpWarps = 2;     // frames a block of the warp kernel

// 4-byte asynchronous copy global -> shared (cp.async): a thread issues
// all its copies before any of them has to land.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// One butterfly step of a reduce-scatter: lanes with bit O set keep the
// upper half of v[0..V), the others the lower, each adding its partner's
// copy of the half it keeps; then the next step on the kept half.
template <int V, int O>
__device__ __forceinline__ void reduce_scatter_step(float* v, int lane) {
  if constexpr (V > 1) {
    constexpr int half = V / 2;
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? v[i] : v[i + half];
      const float keep = up ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    reduce_scatter_step<half, O / 2>(v, lane);
  }
}

// Reduce-scatter of V = 2^m <= 32 values (v[0..V), registers) over the
// warp: returns the warp sum of value lane / (32 / V) (for V = 32, value
// lane), in V - 1 + log2(32 / V) shuffles.
template <int V>
__device__ __forceinline__ float warp_reduce_scatter(float* v) {
  static_assert(V >= 1 && V <= 32 && (V & (V - 1)) == 0, "V: 2^m <= 32");
  const int lane = threadIdx.x & 31;
  reduce_scatter_step<V, 16>(v, lane);
  float r = v[0];
#pragma unroll
  for (int o = 16 / V; o > 0; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
  return r;
}

struct Geom {
  int N, K, C, nhop, nx, rep, ntiles;
  float c0, c1, c2, c3;    // window coefficients, absent ones 0
};

// One column of a frame: its window value, x times the window, and for
// the harmonics z = e^{2 pi j r} (r the reduced cycle offset), the seed
// z^{k0+1} of the group's first slot k0 and the chunk carry z^CH.
struct Column {
  float win, xw, zc, zs, sr, si, cr, ci;
};

// The window at column offset d = w - C of a frame of halfwidth h (hr =
// 0.5 / h): the cosine series c0 + sum_m c_m cos(2 pi m u), u = d hr +
// 1/2, on the exact support |d| <= h.  cos(4 pi u) and cos(6 pi u) come
// from cos(2 pi u) by the Chebyshev recurrence (absent terms have c_m =
// 0), so the setup has no branch and the compiler can interleave it.
__device__ __forceinline__ float window(float d, float h, float hr,
                                        const Geom& g) {
  const float t1 = cospif(2.0f * fmaf(d, hr, 0.5f));
  const float t2 = fmaf(2.0f * t1, t1, -1.0f);
  const float t3 = t1 * fmaf(2.0f, t2, -1.0f);
  const float w = fmaf(g.c3, t3, fmaf(g.c2, t2, fmaf(g.c1, t1, g.c0)));
  return fabsf(d) <= h ? w : 0.0f;
}

// Column w's setup for NC live chunks; GROUPS: harmonics beyond one group
// (K > CH NCH) seed group kg's first slot exactly.
template <int CH, int NC, bool GROUPS>
__device__ __forceinline__ Column column(const float* xf, const float* cf,
                                         float cc, int w, float h, float hr,
                                         int kg, const Geom& g) {
  Column c{};
  c.win = window((float)(w - g.C), h, hr, g);
  c.xw = xf[w] * c.win;
  if constexpr (NC > 0) {
    const float r = llsm::frac_c(cf[w] - cc);
    sincospif(2.0f * r, &c.zs, &c.zc);
    c.sr = c.zc;
    c.si = c.zs;
    if constexpr (GROUPS) {
      if (kg > 0)
        sincospif(2.0f * llsm::kmul_c((float)(kg + 1), r), &c.si, &c.sr);
    }
    if constexpr (NC > 1)
      sincospif(2.0f * llsm::kmul_c((float)CH, r), &c.ci, &c.cr);
  }
  return c;
}

// acc[j] += xw Re w_j, acc[CH + j] -= xw Im w_j for the chunk's CH slots,
// w_0 = (sr, si), w_{j+1} = w_j z; then, with CARRY, the seed moves on by
// z^CH.
template <int CH, bool CARRY>
__device__ __forceinline__ void accumulate(float* acc, Column& c) {
  float wr = c.sr, wi = c.si;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    acc[j] = fmaf(c.xw, wr, acc[j]);
    acc[CH + j] = fmaf(-c.xw, wi, acc[CH + j]);
    if (j + 1 < CH) {
      const float nwr = wr * c.zc - wi * c.zs;
      wi = wr * c.zs + wi * c.zc;
      wr = nwr;
    }
  }
  if constexpr (CARRY) {
    const float nsr = c.sr * c.cr - c.si * c.ci;
    c.si = c.sr * c.ci + c.si * c.cr;
    c.sr = nsr;
  }
}

template <int CH, int NC, int k = 0>
__device__ __forceinline__ void accumulate_chunks(float* acc, Column& c) {
  if constexpr (k < NC) {
    accumulate<CH, k + 1 < NC>(acc + 2 * CH * k, c);
    accumulate_chunks<CH, NC, k + 1>(acc, c);
  }
}

// A lane's columns w = a + lane, a + lane + 32, ... < e of a frame with NC
// live chunks (a template constant, so the loop body is one branch-free
// block).  With 16 or more live slots each iteration sets up the NEXT
// column (clamped to the last) before it rotates the current one, so the
// setup's dependent trig chains overlap the rotations' independent FMAs
// even at the 2 warps a scheduler that K = 80's registers leave; below
// that (the K = 4 envelope pass: ~4 columns a lane) the extra setup at a
// frame's end would cost more than it hides.  FIRST: also sum the window
// and x win into ws and xs.
template <int CH, int NC, bool GROUPS>
__device__ __forceinline__ void columns(float* acc, const float* xf,
                                        const float* cf, float cc, int a,
                                        int e, float h, float hr, int kg,
                                        bool first, float& ws, float& xs,
                                        const Geom& g) {
  int w = a + (threadIdx.x & 31);
  if constexpr (NC * CH < 16) {
    for (; w < e; w += 32) {
      Column c = column<CH, NC, GROUPS>(xf, cf, cc, w, h, hr, kg, g);
      ws += first ? c.win : 0.0f;
      xs += first ? c.xw : 0.0f;
      accumulate_chunks<CH, NC>(acc, c);
    }
  } else {
    if (w >= e) return;
    Column cur = column<CH, NC, GROUPS>(xf, cf, cc, w, h, hr, kg, g);
    for (;;) {
      const int wn = w + 32;
      Column nxt =
          column<CH, NC, GROUPS>(xf, cf, cc, min(wn, e - 1), h, hr, kg, g);
      ws += first ? cur.win : 0.0f;
      xs += first ? cur.xw : 0.0f;
      accumulate_chunks<CH, NC>(acc, cur);
      if (wn >= e) break;
      cur = nxt;
      w = wn;
    }
  }
}

// columns<NC> for the frame's live chunk count nc in [0, NCH].
template <int CH, int NCH, bool GROUPS, int NC = 0>
__device__ __forceinline__ void columns_live(int nc, float* acc,
                                             const float* xf, const float* cf,
                                             float cc, int a, int e, float h,
                                             float hr, int kg, bool first,
                                             float& ws, float& xs,
                                             const Geom& g) {
  if constexpr (NC < NCH) {
    if (nc == NC) {
      columns<CH, NC, GROUPS>(acc, xf, cf, cc, a, e, h, hr, kg, first, ws,
                              xs, g);
      return;
    }
    columns_live<CH, NCH, GROUPS, NC + 1>(nc, acc, xf, cf, cc, a, e, h, hr,
                                          kg, first, ws, xs, g);
  } else {
    columns<CH, NCH, GROUPS>(acc, xf, cf, cc, a, e, h, hr, kg, first, ws,
                             xs, g);
  }
}

// The staged parameters of a frame.
struct Frame {
  float hw;
  int lo, hi, kl;
};

// One frame (index fi = b N + n) by one warp; xf, cf are the staged
// samples of its columns.  CH harmonics a chunk, NCH chunks a group.
template <int CH, int NCH, bool GROUPS>
__device__ __forceinline__ void project_frame(const float* xf,
                                              const float* cf, int64_t fi,
                                              const Frame& fr, float* re,
                                              float* im, float* wsum,
                                              float* xsum, const Geom& g) {
  constexpr int V = 2 * CH, KG = CH * NCH;
  const int lane = threadIdx.x & 31;
  const float h = fr.hw, hr = 0.5f / fr.hw;
  const int a = max(fr.lo, 0), e = min(fr.hi, 2 * g.C);
  const int kn = min(max(fr.kl, 0), g.K);
  const float cc = cf[g.C];
  const int ngroups = GROUPS ? max((kn + KG - 1) / KG, 1) : 1;
  float ws = 0.0f, xs = 0.0f;
  for (int grp = 0; grp < ngroups; ++grp) {
    const int kg = grp * KG;
    const int nc = kn > kg ? min(NCH, (kn - kg + CH - 1) / CH) : 0;
    float acc[NCH * V];
#pragma unroll
    for (int i = 0; i < NCH * V; ++i) acc[i] = 0.0f;
    columns_live<CH, NCH, GROUPS>(nc, acc, xf, cf, cc, a, e, h, hr, kg,
                                  grp == 0, ws, xs, g);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (c < nc) {
        const float v = warp_reduce_scatter<V>(acc + c * V);
        constexpr int stride = 32 / V;
        const int idx = lane / stride, k = kg + c * CH + idx % CH;
        if (lane % stride == 0 && k < g.K)
          (idx < CH ? re : im)[fi * g.K + k] = k < kn ? v : 0.0f;
      }
    }
  }
  ws = llsm::warp_sum(ws);
  xs = llsm::warp_sum(xs);
  if (lane == 0) {
    wsum[fi] = ws;
    xsum[fi] = xs;
  }
  for (int k = min((kn + CH - 1) / CH * CH, g.K) + lane; k < g.K; k += 32) {
    re[fi * g.K + k] = 0.0f;
    im[fi * g.K + k] = 0.0f;
  }
}

template <int CH, int NCH, bool GROUPS>
__global__ void __launch_bounds__(kThreads)
proj_win_kernel(const float* __restrict__ x, const float* __restrict__ cyc,
                const float* __restrict__ hw, const int* __restrict__ lo,
                const int* __restrict__ hi, const int* __restrict__ kl,
                float* __restrict__ re, float* __restrict__ im,
                float* __restrict__ wsum, float* __restrict__ xsum, Geom g) {
  extern __shared__ float sm[];
  __shared__ Frame frames[kTile];
  const int span = (kTile - 1) * g.nhop + 2 * g.C;
  float* xs = sm;
  float* cs = sm + span;
  const int b = blockIdx.x / g.ntiles;
  const int n0 = (blockIdx.x - b * g.ntiles) * kTile;
  const int64_t s0 = (int64_t)n0 * g.nhop - g.C;
  const float* xb = x + (int64_t)b * g.nx;
  const float* cb = cyc + (int64_t)(b / g.rep) * g.nx;
  // every load of the tile in flight at once: the span by cp.async, the
  // frames' parameters by the first kTile threads meanwhile
  for (int i = threadIdx.x; i < span; i += kThreads) {
    const int64_t s = s0 + i;
    copy_async(cs + i, cb + (s < 0 ? 0 : (s >= g.nx ? g.nx - 1 : s)));
    if (s >= 0 && s < g.nx)
      copy_async(xs + i, xb + s);
    else
      xs[i] = 0.0f;
  }
  asm volatile("cp.async.commit_group;\n" ::);
  if (threadIdx.x < kTile && n0 + (int)threadIdx.x < g.N) {
    const int64_t fi = (int64_t)b * g.N + n0 + threadIdx.x;
    frames[threadIdx.x] = Frame{hw[fi], lo[fi], hi[fi], kl[fi]};
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  for (int f = threadIdx.x >> 5; f < kTile; f += kWarps) {
    const int n = n0 + f;
    if (n >= g.N) break;
    project_frame<CH, NCH, GROUPS>(xs + f * g.nhop, cs + f * g.nhop,
                           (int64_t)b * g.N + n, frames[f], re, im, wsum,
                           xsum, g);
  }
}

// One frame (row b, index n; fi = b N + n) by one warp, wherever the
// 16-frame tile would not leave room for two blocks an SM.  The warp
// stages its live columns [a, e) in chunks of Q (a multiple of 32) by
// cp.async into two buffers of its own, buf [2][2][Q] (x, then cyc; x zero
// and cyc edge-clamped outside [0, nx), as the tile stages them), chunk q
// + 1 in flight while chunk q rotates.  Lane l takes columns a + l, a + l
// + 32, ... in order, with the accumulators, ws and xs carried across the
// chunks, so every sum is the 16-frame tile's; each group of harmonics
// (GROUPS: past 80, whose accumulators take the registers) walks the
// columns again.
template <int CH, int NCH, bool GROUPS>
__device__ __forceinline__ void project_frame_warp(
    const float* __restrict__ xb, const float* __restrict__ cb, int n,
    int64_t fi, const Frame& fr, float* buf, int Q, float* re, float* im,
    float* wsum, float* xsum, const Geom& g) {
  constexpr int V = 2 * CH, KG = CH * NCH;
  const int lane = threadIdx.x & 31;
  const float h = fr.hw, hr = 0.5f / fr.hw;
  const int a = max(fr.lo, 0);
  const int e = LLSM_SKIP_PASS_B ? a : min(fr.hi, 2 * g.C);
  const int kn = LLSM_SKIP_PASS_A ? 0 : min(max(fr.kl, 0), g.K);
  const int64_t s0 = (int64_t)n * g.nhop - g.C;
  const float cc = __ldg(cb + (int64_t)n * g.nhop);   // column C: < nx
  const int ngroups = GROUPS ? max((kn + KG - 1) / KG, 1) : 1;
  // chunk [q, min(q + Q, e)) into xbuf [Q] and the cyc buffer after it
  auto stage = [&](int q, float* xbuf) {
    for (int i = lane; i < min(Q, e - q); i += 32) {
      const int64_t s = s0 + q + i;
      const bool in = s >= 0 && s < g.nx;
      const float* src = cb + (s < 0 ? 0 : (s >= g.nx ? g.nx - 1 : s));
      llsm::cp_async4(xbuf + Q + i, src, true);
      llsm::cp_async4(xbuf + i, in ? xb + s : xb, in);
    }
    llsm::cp_async_commit();
  };
  float ws = 0.0f, xs = 0.0f;
  for (int grp = 0; grp < ngroups; ++grp) {
    const int kg = grp * KG;
    const int nc = kn > kg ? min(NCH, (kn - kg + CH - 1) / CH) : 0;
    float acc[NCH * V];
#pragma unroll
    for (int i = 0; i < NCH * V; ++i) acc[i] = 0.0f;
    if (a < e) {
      __syncwarp();                     // the last group's reads are done
      stage(a, buf);
      for (int q = a, i = 0; q < e; q += Q, ++i) {
        float* cur = buf + (i & 1) * 2 * Q;
        if (q + Q < e)
          stage(q + Q, buf + ((i + 1) & 1) * 2 * Q);
        else
          llsm::cp_async_commit();      // an empty group: one wait for all
        llsm::cp_async_wait<1>();
        __syncwarp();
        columns_live<CH, NCH, GROUPS>(nc, acc, cur - q, cur + Q - q, cc, q,
                                      min(q + Q, e), h, hr, kg, grp == 0, ws,
                                      xs, g);
        __syncwarp();                   // chunk q's reads are done
      }
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (c < nc) {
        const float v = warp_reduce_scatter<V>(acc + c * V);
        constexpr int stride = 32 / V;
        const int idx = lane / stride, k = kg + c * CH + idx % CH;
        if (lane % stride == 0 && k < g.K)
          (idx < CH ? re : im)[fi * g.K + k] = k < kn ? v : 0.0f;
      }
    }
  }
  ws = llsm::warp_sum(ws);
  xs = llsm::warp_sum(xs);
  if (lane == 0) {
    wsum[fi] = ws;
    xsum[fi] = xs;
  }
  for (int k = min((kn + CH - 1) / CH * CH, g.K) + lane; k < g.K; k += 32) {
    re[fi * g.K + k] = 0.0f;
    im[fi * g.K + k] = 0.0f;
  }
}

// kWarpWarps frames a block, a warp a frame (any row), frames in order:
// frame fi = b N + n of the Bx N.
template <int CH, int NCH, bool GROUPS>
__global__ void __launch_bounds__(32 * kWarpWarps)
proj_win_warp_kernel(const float* __restrict__ x,
                     const float* __restrict__ cyc,
                     const float* __restrict__ hw, const int* __restrict__ lo,
                     const int* __restrict__ hi, const int* __restrict__ kl,
                     float* __restrict__ re, float* __restrict__ im,
                     float* __restrict__ wsum, float* __restrict__ xsum,
                     Geom g, long long frames, int Q) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x >> 5;
  const int64_t fi = (int64_t)blockIdx.x * kWarpWarps + warp;
  if (fi >= frames) return;             // the whole warp leaves together
  const int b = (int)(fi / g.N), n = (int)(fi - (int64_t)b * g.N);
  const Frame fr{hw[fi], lo[fi], hi[fi], kl[fi]};
  project_frame_warp<CH, NCH, GROUPS>(
      x + (int64_t)b * g.nx, cyc + (int64_t)(b / g.rep) * g.nx, n, fi, fr,
      sm + 4 * warp * Q, Q, re, im, wsum, xsum, g);
}

template <int CH, int NCH, bool GROUPS = false>
cudaError_t launch_warp(const float* x, const float* cyc, const float* hw,
                        const int* lo, const int* hi, const int* kl,
                        float* re, float* im, float* wsum, float* xsum,
                        int Bx, const Geom& g, int Q, cudaStream_t stream) {
  const long long frames = (long long)Bx * g.N;
  const size_t smem = 4 * (size_t)kWarpWarps * Q * sizeof(float);
  cudaError_t e = llsm::allow_smem(proj_win_warp_kernel<CH, NCH, GROUPS>,
                                   smem);
  if (e != cudaSuccess) return e;
  proj_win_warp_kernel<CH, NCH, GROUPS>
      <<<(unsigned)((frames + kWarpWarps - 1) / kWarpWarps),
         32 * kWarpWarps, smem,
         stream>>>(x, cyc, hw, lo, hi, kl, re, im, wsum, xsum, g, frames, Q);
  return cudaGetLastError();
}

template <int CH, int NCH, bool GROUPS = false>
cudaError_t launch(const float* x, const float* cyc, const float* hw,
                   const int* lo, const int* hi, const int* kl, float* re,
                   float* im, float* wsum, float* xsum, int Bx,
                   const Geom& g, cudaStream_t stream) {
  const size_t smem =
      2 * (size_t)((kTile - 1) * g.nhop + 2 * g.C) * sizeof(float);
  cudaError_t e = llsm::allow_smem(proj_win_kernel<CH, NCH, GROUPS>, smem);
  if (e != cudaSuccess) return e;
  proj_win_kernel<CH, NCH, GROUPS><<<(unsigned)((int64_t)Bx * g.ntiles), kThreads,
                             smem, stream>>>(x, cyc, hw, lo, hi, kl, re, im,
                                             wsum, xsum, g);
  return cudaGetLastError();
}

}  // namespace

// x [Bx, nx], cyc [Bx / rep, nx]; hw, lo, hi, kl [Bx, N]; re, im
// [Bx, N, K]; wsum, xsum [Bx, N].  K > 80 runs in groups of 80 harmonics,
// each group's first harmonic seeded exactly.  F, Q
// (kernels._proj_win_geometry): F = 16 (kTile) proj_win_kernel; F = 0
// proj_win_warp_kernel, a warp a frame, its columns staged in chunks of Q.
extern "C" int llsm_harmonic_project_win(
    const float* x, const float* cyc, const float* hw, const int* lo,
    const int* hi, const int* kl, float* re, float* im, float* wsum,
    float* xsum, int Bx, int rep, int nx, int N, int K, int nhop, int center,
    float c0, float c1, float c2, float c3, int ncoef, int F, int Q,
    void* stream) {
  if (Bx <= 0 || N <= 0) return (int)cudaGetLastError();
  if (ncoef < 1 || ncoef > 4 || rep < 1 || nx < 1 || nhop < 1 ||
      center < 0 || K < 1 || (F != 0 && F != kTile) ||
      (F == 0 && (Q < 32 || Q % 32)))
    return (int)cudaErrorInvalidValue;
  const Geom g{N, K, center, nhop, nx, rep, (N + kTile - 1) / kTile,
               c0, c1, c2, c3};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (F == 0) {
#define LLSM_WARP(CH, NCH, GROUPS) \
  launch_warp<CH, NCH, GROUPS>(x, cyc, hw, lo, hi, kl, re, im, wsum, xsum, \
                               Bx, g, Q, s)
    if (K <= 4)
      e = LLSM_WARP(4, 1, false);
    else if (K <= 8)
      e = LLSM_WARP(8, 1, false);
    else if (K <= 16)
      e = LLSM_WARP(16, 1, false);
    else if (K <= 32)
      e = LLSM_WARP(16, 2, false);
    else if (K <= 48)
      e = LLSM_WARP(16, 3, false);
    else if (K <= 64)
      e = LLSM_WARP(16, 4, false);
    else if (K <= 80)
      e = LLSM_WARP(16, 5, false);
    else
      e = LLSM_WARP(16, 5, true);
#undef LLSM_WARP
    return (int)e;
  }
  if (K <= 4)
    e = launch<4, 1>(x, cyc, hw, lo, hi, kl, re, im, wsum, xsum, Bx, g, s);
  else if (K <= 8)
    e = launch<8, 1>(x, cyc, hw, lo, hi, kl, re, im, wsum, xsum, Bx, g, s);
  else if (K <= 16)
    e = launch<16, 1>(x, cyc, hw, lo, hi, kl, re, im, wsum, xsum, Bx, g, s);
  else if (K <= 32)
    e = launch<16, 2>(x, cyc, hw, lo, hi, kl, re, im, wsum, xsum, Bx, g, s);
  else if (K <= 48)
    e = launch<16, 3>(x, cyc, hw, lo, hi, kl, re, im, wsum, xsum, Bx, g, s);
  else if (K <= 64)
    e = launch<16, 4>(x, cyc, hw, lo, hi, kl, re, im, wsum, xsum, Bx, g, s);
  else if (K <= 80)
    e = launch<16, 5>(x, cyc, hw, lo, hi, kl, re, im, wsum, xsum, Bx, g, s);
  else
    e = launch<16, 5, true>(x, cyc, hw, lo, hi, kl, re, im, wsum, xsum, Bx,
                            g, s);
  return (int)e;
}
