// Track denoiser, pass B, in two launches of this source.
//
// Launch A (denoise_apply_kernel), per frame row: read pass A's aligned
// track c and slow track c_s once, redo the coherent across-k fit
// r ~ (m0 + m1 (k+1)) c_s of r = c - c_s weighted by wmul[k] m[f,k] (both
// sides of the normal equations), gate the incoherent residual r_inc by the
// Wiener gain g = clip(1 - strength v[k] / (|r_inc|^2 + 1e-20), 0, 1), and
// keep c where the guard fails:
//   a = guard ? c_s + r_coh + g r_inc : c        (the aligned output)
// POLAR (the time gate alone) un-aligns by e^{+2 pi j (k+1) cyc_c[f]} and
// writes (|.| m, arg(.) m); otherwise (the spectral gate follows) it
// writes a and full = guard ? c_s + r_inc : 0, both complex64 (interleaved
// float2), in the aligned domain.  v and wmul are per utterance ([B, K]).
//
// Launch B (denoise_finish_kernel), per slot: (a + delta) e^{+2 pi j (k+1)
// cyc_c[f]} -> (|.| m, arg(.) m), delta the spectral gate's complex
// subtraction delta: the host's combine, rotation, polar form and mask in
// one pass.
//
// Replaces libllsm2_tpu/ops/pallas_osc.py: denoise_apply_pallas
// (_denoise_apply_kernel and _denoise_apply_spec_kernel, sharing
// _denoise_apply_body) and the host combine after it (libllsm2_tpu/models/
// layer0.py:680-681 and 699-702).  Bound on the H100: memory -- a slot
// reads 20 bytes (c, c_s, m) and writes 16 (a, full) or 8 (ampl, phse)
// against ~40 flops; launch B reads 20 and writes 8.  Design: half a warp a
// row (two rows a warp), so K = 80 keeps all 16 lanes busy: one float4 of
// k a lane over k < 64 (16 bytes a load) and one scalar a lane over
// 64 <= k < 80; the row lives in registers between the fit and the gate,
// so it is read once.  The seven fit sums are reduced by one 4-step xor
// shuffle each inside the half warp (no shared memory, no barrier).  K
// not a multiple of 4, or outside (64, 80], takes the scalar layout
// (k = lane + 16 t, up to 8 slots a lane: K <= 128).  Past K = 128
// (creaky voice's K = 160, full band's 200 and 600)
// denoise_apply_wide_kernel keeps that layout and order with the row pair
// staged in shared memory, so each slot is still read once.  Launch B
// takes two slots a thread by float4 loads of the complex planes; it has
// no limit on K.
#include "common.cuh"

// LLSM_SKIP_PASS_{A,B} = 1 compiles the wide kernel's fit sums or its gate
// and stores out, for the pass timings of scripts/port_kernel_passes.py;
// the library leaves both 0.
#ifndef LLSM_SKIP_PASS_A
#define LLSM_SKIP_PASS_A 0
#endif
#ifndef LLSM_SKIP_PASS_B
#define LLSM_SKIP_PASS_B 0
#endif

namespace {

constexpr int kRows = 16;      // rows a block: 8 warps, half a warp a row
constexpr int kLanes = 16;

// slot s of lane l: the float4 passes first (k = 64 p + 4 l + e), then
// scalar passes (k = 64 NP4 + 16 t + l)
template <int NP4>
__device__ __forceinline__ int slot_k(int s, int l) {
  return s < 4 * NP4 ? 64 * (s / 4) + 4 * l + (s % 4)
                     : 64 * NP4 + kLanes * (s - 4 * NP4) + l;
}

template <int S, int NP4>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         int K, int l, float (&d)[S]) {
#pragma unroll
  for (int q = 0; q < NP4; ++q) {
    const float4 v =
        *reinterpret_cast<const float4*>(p + 64 * q + 4 * l);
    d[4 * q] = v.x;
    d[4 * q + 1] = v.y;
    d[4 * q + 2] = v.z;
    d[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int s = 4 * NP4; s < S; ++s) {
    const int k = slot_k<NP4>(s, l);
    d[s] = k < K ? p[k] : 0.0f;
  }
}

__device__ __forceinline__ float half_allsum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (re, im) e^{+2 pi j kh cy} -> (|.| m, arg(.) m)
__device__ __forceinline__ float2 unalign_polar(float re, float im, float kh,
                                                float cy, float m) {
  float su, cu;
  sincospif(2.0f * llsm::kmul_c(kh, cy), &su, &cu);
  const float r = re * cu - im * su, i = re * su + im * cu;
  return make_float2(sqrtf(r * r + i * i) * m, atan2f(i, r) * m);
}

template <int S, int NP4, bool POLAR>
__global__ void __launch_bounds__(kRows * kLanes)
denoise_apply_kernel(const float* __restrict__ v, const float* __restrict__ wm,
                     const float* __restrict__ cre,
                     const float* __restrict__ cim,
                     const float* __restrict__ csr,
                     const float* __restrict__ csi,
                     const float* __restrict__ cyc_c,
                     const float* __restrict__ mask,
                     const unsigned char* __restrict__ guard,
                     float* __restrict__ o0, float* __restrict__ o1,
                     int64_t rows, int N, int K, float strength) {
  const int l = threadIdx.x & (kLanes - 1);
  const int64_t row0 = (int64_t)blockIdx.x * kRows + (threadIdx.x / kLanes);
  // rows past the end read row 0 and store nothing: every lane of the warp
  // takes part in the shuffles
  const bool live = row0 < rows;
  const int64_t row = live ? row0 : 0;
  const int64_t b = row / N;
  const int64_t base = row * K;
  float cr[S], ci[S], sr[S], si[S], m[S], vb[S], wb[S];
  load_row<S, NP4>(cre + base, K, l, cr);
  load_row<S, NP4>(cim + base, K, l, ci);
  load_row<S, NP4>(csr + base, K, l, sr);
  load_row<S, NP4>(csi + base, K, l, si);
  load_row<S, NP4>(mask + base, K, l, m);
  load_row<S, NP4>(v + b * K, K, l, vb);
  load_row<S, NP4>(wm + b * K, K, l, wb);
  const bool g = guard[row] != 0;
  const float cy = cyc_c[row];

  float a00 = 0.0f, a01 = 0.0f, a11 = 0.0f;
  float b0r = 0.0f, b0i = 0.0f, b1r = 0.0f, b1i = 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) {   // slots past K hold zeros: they add 0
    const float kh = (float)(slot_k<NP4>(s, l) + 1);
    const float w = wb[s] * m[s];
    const float rr = cr[s] - sr[s], ri = ci[s] - si[s];
    const float pw = (sr[s] * sr[s] + si[s] * si[s]) * w;
    const float crr = (sr[s] * rr + si[s] * ri) * w;  // Re(conj(c_s) r)
    const float cri = (sr[s] * ri - si[s] * rr) * w;  // Im(conj(c_s) r)
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
  if (!live) return;
  const float det = a00 * a11 - a01 * a01;
  const float inv = 1.0f / (det + 1e-5f * a00 * a11 + 1e-12f);
  const float m0r = (a11 * b0r - a01 * b1r) * inv;
  const float m0i = (a11 * b0i - a01 * b1i) * inv;
  const float m1r = (a00 * b1r - a01 * b0r) * inv;
  const float m1i = (a00 * b1i - a01 * b0i) * inv;

  float2 r0[S], r1[S];   // POLAR: (ampl, phse) pairs; else a and full
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float kh = (float)(slot_k<NP4>(s, l) + 1);
    const float wr = m0r + m1r * kh, wi = m0i + m1i * kh;
    const float rcr = wr * sr[s] - wi * si[s], rci = wr * si[s] + wi * sr[s];
    const float rir = (cr[s] - sr[s]) - rcr, rii = (ci[s] - si[s]) - rci;
    const float pw = rir * rir + rii * rii;
    const float gain =
        fminf(fmaxf(1.0f - strength * vb[s] / (pw + 1e-20f), 0.0f), 1.0f);
    const float ar = g ? sr[s] + rcr + gain * rir : cr[s];
    const float ai = g ? si[s] + rci + gain * rii : ci[s];
    if (POLAR) {
      const float2 ap = unalign_polar(ar, ai, kh, cy, m[s]);
      r0[s] = make_float2(ap.x, 0.0f);
      r1[s] = make_float2(ap.y, 0.0f);
    } else {
      r0[s] = make_float2(ar, ai);
      r1[s] = g ? make_float2(sr[s] + rir, si[s] + rii)
                : make_float2(0.0f, 0.0f);
    }
  }
#pragma unroll
  for (int q = 0; q < NP4; ++q) {
    const int64_t k = base + 64 * q + 4 * l;
    if (POLAR) {
      *reinterpret_cast<float4*>(o0 + k) = make_float4(
          r0[4 * q].x, r0[4 * q + 1].x, r0[4 * q + 2].x, r0[4 * q + 3].x);
      *reinterpret_cast<float4*>(o1 + k) = make_float4(
          r1[4 * q].x, r1[4 * q + 1].x, r1[4 * q + 2].x, r1[4 * q + 3].x);
    } else {
      float4* a = reinterpret_cast<float4*>(o0 + 2 * k);
      float4* f = reinterpret_cast<float4*>(o1 + 2 * k);
      a[0] = make_float4(r0[4 * q].x, r0[4 * q].y, r0[4 * q + 1].x,
                         r0[4 * q + 1].y);
      a[1] = make_float4(r0[4 * q + 2].x, r0[4 * q + 2].y, r0[4 * q + 3].x,
                         r0[4 * q + 3].y);
      f[0] = make_float4(r1[4 * q].x, r1[4 * q].y, r1[4 * q + 1].x,
                         r1[4 * q + 1].y);
      f[1] = make_float4(r1[4 * q + 2].x, r1[4 * q + 2].y, r1[4 * q + 3].x,
                         r1[4 * q + 3].y);
    }
  }
#pragma unroll
  for (int s = 4 * NP4; s < S; ++s) {
    const int k = slot_k<NP4>(s, l);
    if (k >= K) continue;
    if (POLAR) {
      o0[base + k] = r0[s].x;
      o1[base + k] = r1[s].x;
    } else {
      reinterpret_cast<float2*>(o0)[base + k] = r0[s];
      reinterpret_cast<float2*>(o1)[base + k] = r1[s];
    }
  }
}

// K > 128 (creaky voice's K = 160, full band's 200 and 600):
// denoise_apply_kernel's scalar layout and order (slot t of lane l is k =
// l + 16 t; lane l sums its slots in t order, then half_allsum), every
// output bit the replaced kernel's, which read each slot from device
// memory twice, for the sums and again for the gate.  Here each slot is
// read once: a warp takes a contiguous run of `per` row pairs (half a warp
// a row), stages each pair's c, c_s and mask into shared memory by
// cp.async (4-byte copies up to a row's first 16-byte boundary and after
// its last, 16-byte copies between), then its sums and gate read the
// staged rows.  The two rows of a plane lie row_floats(K) apart, 16 banks
// modulo 32, so the two half warps' loads meet in a bank only where the
// rows' misalignments differ (at most 3 lanes).  Each half
// warp keeps its utterance's v and wmul rows beside them, loaded where the
// row's utterance changes (read from device memory on every slot they
// missed the L1 cache, whose room the staging takes).  The guard and the
// cycle are loaded before the wait for the copies.  Stores as the replaced
// kernel's (a half warp writes 16 consecutive slots).  No block barrier:
// each warp's buffer is its own, so blocks of one warp fill an SM as far as
// its shared memory allows; the card hides each warp's copies behind the
// others' arithmetic.  STAGE = false (K past ~4100, a warp's buffer past a
// block's shared memory): the slots read from device memory twice, as the
// replaced kernel did.  kernels._apply_geometry chooses warps, blocks, per
// and STAGE.
constexpr int kApplyMaxWarps = 4;
constexpr int kPlanes = 5;     // cre, cim, csr, csi, mask

// floats between a plane's two staged rows (a row and up to 3 floats of
// misalignment): at least n, 16 modulo 32
__host__ __device__ __forceinline__ int odd16(int n) {
  return (n + 15) / 32 * 32 + 16;
}
__host__ __device__ __forceinline__ int row_floats(int K) {
  return odd16(K + 3);
}

// n floats from src to dst + (src's misalignment in floats) (dst 16-byte
// aligned, src's array too), by the warp's 32 lanes
__device__ __forceinline__ void stage_span(float* dst, const float* src,
                                           int n, int lane) {
  const int mis = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  float* d = dst + mis;
  const int head = min((4 - mis) & 3, n);
  const int body = (n - head) >> 2;
  for (int e = lane; e < head; e += 32) llsm::cp_async4(d + e, src + e, true);
  for (int q = lane; q < body; q += 32)
    llsm::cp_async16(d + head + 4 * q, src + head + 4 * q);
  for (int e = head + 4 * body + lane; e < n; e += 32)
    llsm::cp_async4(d + e, src + e, true);
}

template <bool POLAR, bool STAGE>
__global__ void __launch_bounds__(kApplyMaxWarps * 32)
denoise_apply_wide_kernel(
    const float* __restrict__ v, const float* __restrict__ wm,
    const float* __restrict__ cre, const float* __restrict__ cim,
    const float* __restrict__ csr, const float* __restrict__ csi,
    const float* __restrict__ cyc_c, const float* __restrict__ mask,
    const unsigned char* __restrict__ guard, float* __restrict__ o0,
    float* __restrict__ o1, int64_t rows, int N, int K, float strength,
    int per) {
  extern __shared__ float4 sm4[];
  const int lane = threadIdx.x & 31, l = lane & (kLanes - 1),
            h = lane / kLanes;
  const int RS = row_floats(K), US = odd16(K);
  // the warp's buffer: [5 planes, 2 rows, RS], then [v, wmul][2 rows, US]
  float* buf = reinterpret_cast<float*>(sm4) +
               (size_t)(threadIdx.x / 32) * (2 * kPlanes * RS + 4 * US);
  float* ut = buf + 2 * kPlanes * RS + h * US;
  const float* const planes[kPlanes] = {cre, cim, csr, csi, mask};
  const int64_t gw = (int64_t)blockIdx.x * (blockDim.x / 32) +
                     threadIdx.x / 32;
  const int64_t p0 = gw * per, p1 = min((rows + 1) / 2, p0 + per);
  auto stage = [&](int64_t p) {   // pair p's rows, each plane
    for (int r = 0; r < 2 && 2 * p + r < rows; ++r)
#pragma unroll
      for (int q = 0; q < kPlanes; ++q)
        stage_span(buf + (2 * q + r) * RS, planes[q] + (2 * p + r) * K, K,
                   lane);
    llsm::cp_async_commit();
  };
  if (STAGE && p0 < p1) stage(p0);
  int64_t ub = -1;
  for (int64_t p = p0; p < p1; ++p) {
    // rows past the end read row 0 (or a stale staged row) and store
    // nothing: every lane of the warp takes part in the shuffles
    const int64_t row0 = 2 * p + h;
    const bool live = row0 < rows;
    const int64_t row = live ? row0 : 0;
    const int64_t b = row / N;
    const int64_t base = row * K;
    const bool g = guard[row] != 0;
    const float cy = cyc_c[row];
    if (STAGE) {
      llsm::cp_async_wait<0>();
      if (b != ub) {
        for (int k = l; k < K; k += kLanes) {
          ut[k] = __ldg(v + b * K + k);
          ut[2 * US + k] = __ldg(wm + b * K + k);
        }
        ub = b;
      }
      __syncwarp();
    }
    const int at = h * RS + (int)((row * K) & 3);   // the row in a plane
    const float* rc = STAGE ? buf + at : cre + base;
    const float* ri_ = STAGE ? buf + 2 * RS + at : cim + base;
    const float* rs = STAGE ? buf + 4 * RS + at : csr + base;
    const float* rsi = STAGE ? buf + 6 * RS + at : csi + base;
    const float* rm = STAGE ? buf + 8 * RS + at : mask + base;
    const float* vb = STAGE ? ut : v + b * K;
    const float* wb = STAGE ? ut + 2 * US : wm + b * K;

    float a00 = 0.0f, a01 = 0.0f, a11 = 0.0f;
    float b0r = 0.0f, b0i = 0.0f, b1r = 0.0f, b1i = 0.0f;
    for (int k = l; !LLSM_SKIP_PASS_A && k < K; k += kLanes) {
      const float sr = rs[k], si = rsi[k];
      const float kh = (float)(k + 1);
      const float w = wb[k] * rm[k];
      const float rr = rc[k] - sr, ri = ri_[k] - si;
      const float pw = (sr * sr + si * si) * w;
      const float crr = (sr * rr + si * ri) * w;
      const float cri = (sr * ri - si * rr) * w;
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
    if (live) {
      const float det = a00 * a11 - a01 * a01;
      const float inv = 1.0f / (det + 1e-5f * a00 * a11 + 1e-12f);
      const float m0r = (a11 * b0r - a01 * b1r) * inv;
      const float m0i = (a11 * b0i - a01 * b1i) * inv;
      const float m1r = (a00 * b1r - a01 * b0r) * inv;
      const float m1i = (a00 * b1i - a01 * b0i) * inv;
      if (LLSM_SKIP_PASS_B && m0r == 1e30f) o0[base] = m1i;  // keeps the sums
      for (int k = l; !LLSM_SKIP_PASS_B && k < K; k += kLanes) {
        const float cr = rc[k], ci = ri_[k];
        const float sr = rs[k], si = rsi[k];
        const float kh = (float)(k + 1);
        const float wr = m0r + m1r * kh, wi = m0i + m1i * kh;
        const float rcr = wr * sr - wi * si, rci = wr * si + wi * sr;
        const float rir = (cr - sr) - rcr, rii = (ci - si) - rci;
        const float pw = rir * rir + rii * rii;
        const float gain =
            fminf(fmaxf(1.0f - strength * vb[k] / (pw + 1e-20f),
                        0.0f),
                  1.0f);
        const float ar = g ? sr + rcr + gain * rir : cr;
        const float ai = g ? si + rci + gain * rii : ci;
        if (POLAR) {
          const float2 ap = unalign_polar(ar, ai, kh, cy, rm[k]);
          o0[base + k] = ap.x;
          o1[base + k] = ap.y;
        } else {
          reinterpret_cast<float2*>(o0)[base + k] = make_float2(ar, ai);
          reinterpret_cast<float2*>(o1)[base + k] =
              g ? make_float2(sr + rir, si + rii) : make_float2(0.0f, 0.0f);
        }
      }
    }
    if (STAGE) {
      __syncwarp();   // the buffer takes the next pair
      if (p + 1 < p1) stage(p + 1);
    }
  }
}

template <bool POLAR, bool STAGE>
cudaError_t launch_apply_wide(const float* v, const float* wm,
                              const float* cre, const float* cim,
                              const float* csr, const float* csi,
                              const float* cyc_c, const float* mask,
                              const unsigned char* guard, float* o0,
                              float* o1, int64_t rows, int N, int K,
                              float strength, int warps, int blocks, int per,
                              cudaStream_t st) {
  const size_t smem =
      STAGE ? (size_t)warps * (2 * kPlanes * row_floats(K) + 4 * odd16(K)) *
                  sizeof(float)
            : 0;
  cudaError_t e =
      llsm::allow_smem(denoise_apply_wide_kernel<POLAR, STAGE>, smem);
  if (e != cudaSuccess) return e;
  denoise_apply_wide_kernel<POLAR, STAGE><<<blocks, warps * 32, smem, st>>>(
      v, wm, cre, cim, csr, csi, cyc_c, mask, guard, o0, o1, rows, N, K,
      strength, per);
  return cudaGetLastError();
}

// I: the slot index type, 32-bit below 2^31 slots (its divisions are the
// cheap ones), 64-bit above
template <typename I>
__global__ void __launch_bounds__(256)
denoise_finish_kernel(const float4* __restrict__ a,
                      const float4* __restrict__ delta,
                      const float* __restrict__ cyc_c,
                      const float* __restrict__ mask,
                      float* __restrict__ ampl, float* __restrict__ phse,
                      I total, I K) {
  const I p = (I)blockIdx.x * blockDim.x + threadIdx.x;
  const I i = 2 * p;
  if (i >= total) return;
  I row = i / K, k = i - row * K;
  if (i + 1 < total) {
    const float4 av = a[p], dv = delta[p];
    const float2 mv = reinterpret_cast<const float2*>(mask)[p];
    const float2 s0 = unalign_polar(av.x + dv.x, av.y + dv.y,
                                    (float)(k + 1), cyc_c[row], mv.x);
    if (++k == K) {
      k = 0;
      ++row;
    }
    const float2 s1 = unalign_polar(av.z + dv.z, av.w + dv.w,
                                    (float)(k + 1), cyc_c[row], mv.y);
    reinterpret_cast<float2*>(ampl)[p] = make_float2(s0.x, s1.x);
    reinterpret_cast<float2*>(phse)[p] = make_float2(s0.y, s1.y);
  } else {   // an odd total: the last slot alone
    const float2 av = reinterpret_cast<const float2*>(a)[i];
    const float2 dv = reinterpret_cast<const float2*>(delta)[i];
    const float2 s0 = unalign_polar(av.x + dv.x, av.y + dv.y,
                                    (float)(k + 1), cyc_c[row], mask[i]);
    ampl[i] = s0.x;
    phse[i] = s0.y;
  }
}

template <int S, int NP4>
cudaError_t launch_apply(bool polar, const float* v, const float* wm,
                         const float* cre, const float* cim, const float* csr,
                         const float* csi, const float* cyc_c,
                         const float* mask, const unsigned char* guard,
                         float* o0, float* o1, int64_t rows, int N, int K,
                         float strength, cudaStream_t st) {
  const unsigned blocks = (unsigned)((rows + kRows - 1) / kRows);
  if (polar)
    denoise_apply_kernel<S, NP4, true><<<blocks, kRows * kLanes, 0, st>>>(
        v, wm, cre, cim, csr, csi, cyc_c, mask, guard, o0, o1, rows, N, K,
        strength);
  else
    denoise_apply_kernel<S, NP4, false><<<blocks, kRows * kLanes, 0, st>>>(
        v, wm, cre, cim, csr, csi, cyc_c, mask, guard, o0, o1, rows, N, K,
        strength);
  return cudaGetLastError();
}

}  // namespace

// polar != 0: o0, o1 = (ampl, phse) [B, N, K] float32; else o0, o1 = the
// aligned output and full, [B, N, K] complex64 (interleaved float2).
// warps, blocks, per, stage: the wide kernel's launch
// (kernels._apply_geometry), warps = 0 for denoise_apply_kernel (K <= 128).
extern "C" int llsm_denoise_apply(const float* v, const float* wm,
                                  const float* cre, const float* cim,
                                  const float* csr, const float* csi,
                                  const float* cyc_c, const float* mask,
                                  const unsigned char* guard, float* o0,
                                  float* o1, int B, int N, int K,
                                  float strength, int polar, int warps,
                                  int blocks, int per, int stage,
                                  void* stream) {
  if (B <= 0 || N <= 0 || K <= 0) return (int)cudaGetLastError();
  const int64_t rows = (int64_t)B * N;
  const cudaStream_t st = (cudaStream_t)stream;
  if (warps > 0) {
    if (warps > kApplyMaxWarps || blocks <= 0 || per <= 0 ||
        (int64_t)blocks * warps * per < (rows + 1) / 2)
      return (int)cudaErrorInvalidValue;
    const bool p = polar != 0, s = stage != 0;
    const auto launch = p ? (s ? launch_apply_wide<true, true>
                               : launch_apply_wide<true, false>)
                          : (s ? launch_apply_wide<false, true>
                               : launch_apply_wide<false, false>);
    return (int)launch(v, wm, cre, cim, csr, csi, cyc_c, mask, guard, o0, o1,
                       rows, N, K, strength, warps, blocks, per, st);
  }
  if (K > 8 * kLanes) return (int)cudaErrorInvalidValue;
  if (K % 4 == 0 && K > 64 && K <= 80)   // the 16 kHz default, K = 80
    return (int)launch_apply<5, 1>(polar, v, wm, cre, cim, csr, csi, cyc_c,
                                   mask, guard, o0, o1, rows, N, K, strength,
                                   st);
  return (int)launch_apply<8, 0>(polar, v, wm, cre, cim, csr, csi, cyc_c,
                                 mask, guard, o0, o1, rows, N, K, strength,
                                 st);
}

// a, delta [B, N, K] complex64; cyc_c [B, N]; mask [B, N, K] ->
// ampl, phse [B, N, K].  a and delta 16-byte aligned, mask 8.
extern "C" int llsm_denoise_finish(const float* a, const float* delta,
                                   const float* cyc_c, const float* mask,
                                   float* ampl, float* phse, int B, int N,
                                   int K, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0) return (int)cudaGetLastError();
  const int64_t total = (int64_t)B * N * K;
  const int64_t blocks = ((total + 1) / 2 + 255) / 256;
  const cudaStream_t st = (cudaStream_t)stream;
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* d4 = reinterpret_cast<const float4*>(delta);
  if (total < ((int64_t)1 << 31))
    denoise_finish_kernel<unsigned><<<(unsigned)blocks, 256, 0, st>>>(
        a4, d4, cyc_c, mask, ampl, phse, (unsigned)total, (unsigned)K);
  else
    denoise_finish_kernel<int64_t><<<(unsigned)blocks, 256, 0, st>>>(
        a4, d4, cyc_c, mask, ampl, phse, total, (int64_t)K);
  return (int)cudaGetLastError();
}
