// Unframed chirped harmonic projection at uniform frame centers f*nhop,
// returned at the frame centres:
//
//   re[b,f,k] + j im[b,f,k] = sum_n w_f(n) x(n) e^{-2 pi j (k+1) (cyc(n) -
//                                                     cyc(f nhop))}
//   wsum[b,f] = sum_n w_f(n),  xsum[b,f] = sum_n w_f(n) x(n)
//
// over every sample n of utterance b, x zero outside [0, nx) (the ones
// row of wsum is not); w_f is the cosine-series window of halfwidth
// hw[b,f] centred at f*nhop, cut at |n - f*nhop| <= min(ceil(hw), reach).
// cyc is the mod-1 cycle track.  What harmonic_project_win returns.
//
// Replaces libllsm2_tpu/ops/pallas_osc.py: harmonic_project_mxu
// (_proj_mxu_kernel), the hm_kernel="matmul" main harmonic pass, and the
// centre rotation its caller does (libllsm2_tpu/ops/harmonics.py:206-210).
// The TPU kernel factors the chirped basis through the frame-independent
// modulated rows G[n, :] = [1, x, x e^{-2 pi j k cyc(n)}] and contracts
// them with banded window rows on the MXU: out = W G.  Bound on the H100:
// arithmetic -- 4 flops a window sample a column pair for the product and
// ~8 a signal sample a harmonic to make G, all in float32 (the JAX call
// runs at Precision.HIGHEST: no TF32 or bf16 tensor-core math); it reads
// only x and cyc.  Design: a block takes a tile of kFT frames of one
// utterance and walks its span in chunks of kSC samples.  For each chunk
// it makes G once into shared memory by the rotation ladder: each chain of
// kHC harmonics starts at x z (z^kHC)^q and steps by z = e^{-2 pi j cyc},
// z and z^kHC made exactly once a sample (2 sincospif a sample instead of
// K, the chains carried as harmonic_project_win carries its chunks).  It
// makes the window rows only of the frames whose supports meet the chunk
// (every warp ballots their range itself, no barrier), each by a rotation
// started exactly every 8 samples (one sincospif for 8 values; the step a
// frame made once a block).  The
// product is register-tiled: a thread takes TF frames (the live ones
// rounded up to even, or tiles of 16 above 12) x one column pair, so each
// G value read from shared memory serves TF frames and each window value
// two columns; the sums live in shared memory, read and written once a
// chunk.  The next chunk's x and cyc are loaded into registers a chunk
// ahead, so no barrier waits on device memory.  The epilogue rotates each
// frame's sums to its centre by e^{+2 pi j k cyc(f nhop)}.  What is left
// is mostly the product, co-limited by its shared-memory reads (a G value
// and the TF window values a sample) and its FMAs (passes timed apart by
// scripts/port_kernel_passes.py).
#include "common.cuh"

namespace {

constexpr int kFT = 32;       // frames a block tile (one ballot)
constexpr int kSC = 32;       // span samples a chunk (one warp stages it)
constexpr int kThreads = 128;
constexpr int kHC = 20;       // harmonics a rotation chain: K = 80 is 4 x 32
                              // chains, one pass of the block
constexpr int kWP = 36;       // window row stride (frames, float4 reads)
constexpr int kEmpty = 1 << 30;
static_assert(kSC == 32 && kFT == 32, "one warp stages, one ballot");
// LLSM_SKIP_PASS_{A,B} = 1 compiles the making of G and the window rows, or
// the product, out, for the pass timings of scripts/port_kernel_passes.py
#ifndef LLSM_SKIP_PASS_A
#define LLSM_SKIP_PASS_A 0
#endif
#ifndef LLSM_SKIP_PASS_B
#define LLSM_SKIP_PASS_B 0
#endif

// row stride of G and of the sums: column pairs (1, x), x z^1 .. x z^K,
// padded to 2 mod 32 floats, so consecutive samples' float2 writes fall in
// distinct banks
__host__ __device__ inline int col_stride(int K) {
  const int c = 2 * (K + 1);
  return c + ((2 - c) % 32 + 32) % 32;
}

inline size_t smem_bytes(int K) {
  const int cc = col_stride(K);
  return sizeof(float) * ((size_t)kSC * cc + kSC * kWP + (size_t)kFT * cc);
}

// the sums of frames fa + ft TF + r (r < TF) and column pair ct, += the
// chunk's W G; rows past the tile have zero windows and are not kept
template <int TF>
__device__ __forceinline__ void product(const float* __restrict__ G,
                                        const float* __restrict__ W,
                                        float* __restrict__ acc, int CC,
                                        int fa, int nft, int tid) {
  const int npair = CC / 2;
  for (int it = tid; it < nft * npair; it += kThreads) {
    const int ft = it / npair, ct = it % npair;
    const int r0 = fa + ft * TF;
    float2 a[TF];
#pragma unroll
    for (int r = 0; r < TF; ++r)
      a[r] = r0 + r < kFT
                 ? reinterpret_cast<const float2*>(acc + (r0 + r) * CC)[ct]
                 : make_float2(0.0f, 0.0f);
    const float* wp = W + ft * TF;
    const float2* gp = reinterpret_cast<const float2*>(G) + ct;
#pragma unroll 8
    for (int n = 0; n < kSC; ++n) {
      float wv[TF];
#pragma unroll
      for (int q = 0; q < TF / 4; ++q) {
        const float4 w4 =
            *reinterpret_cast<const float4*>(wp + n * kWP + 4 * q);
        wv[4 * q] = w4.x;
        wv[4 * q + 1] = w4.y;
        wv[4 * q + 2] = w4.z;
        wv[4 * q + 3] = w4.w;
      }
      if (TF % 4) {
        const float2 w2 = *reinterpret_cast<const float2*>(
            wp + n * kWP + TF - 2);
        wv[TF - 2] = w2.x;
        wv[TF - 1] = w2.y;
      }
      const float2 g = gp[n * (CC / 2)];
#pragma unroll
      for (int r = 0; r < TF; ++r) {
        a[r].x = fmaf(wv[r], g.x, a[r].x);
        a[r].y = fmaf(wv[r], g.y, a[r].y);
      }
    }
#pragma unroll
    for (int r = 0; r < TF; ++r)
      if (r0 + r < kFT)
        reinterpret_cast<float2*>(acc + (r0 + r) * CC)[ct] = a[r];
  }
}

__global__ void __launch_bounds__(kThreads, 4)
proj_mxu_kernel(const float* __restrict__ x, const float* __restrict__ cyc,
                const float* __restrict__ hw, float* __restrict__ re,
                float* __restrict__ im, float* __restrict__ wsum,
                float* __restrict__ xsum, int nx, int N, int K, int nhop,
                int reach, float c0, float c1, float c2, float c3) {
  extern __shared__ __align__(16) float smem[];
  const int CC = col_stride(K);
  float* G = smem;                   // [kSC][CC]
  float* W = G + kSC * CC;           // [kSC][kWP]: sample-major
  float* acc = W + kSC * kWP;        // [kFT][CC]
  __shared__ float xs[2][kSC], rhw_s[kFT];
  __shared__ float2 wstep_s[kFT];    // e^{2 pi j / (2 hw)}: u's step
  __shared__ float2 zs[2][kSC];      // z = e^{-2 pi j cyc} a sample
  __shared__ float2 zhs[2][kSC];     // z^kHC, exact
  __shared__ int lo_s[kFT], hi_s[kFT];
  const int64_t b = blockIdx.y;
  const int f0 = blockIdx.x * kFT;
  const float* xb = x + b * nx;
  const float* cb = cyc + b * nx;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < kFT) {
    const int f = f0 + tid;
    if (f < N) {
      const float h = hw[b * N + f];
      const int r = min((int)ceilf(h), reach);
      rhw_s[tid] = 1.0f / h;
      float s, c;
      sincospif(rhw_s[tid], &s, &c);
      wstep_s[tid] = make_float2(c, s);
      lo_s[tid] = f * nhop - r;
      hi_s[tid] = f * nhop + r + 1;
    } else {  // beyond the utterance: meets no sample
      rhw_s[tid] = 1.0f;
      wstep_s[tid] = make_float2(1.0f, 0.0f);
      lo_s[tid] = kEmpty;
      hi_s[tid] = -kEmpty;
    }
  }
  for (int i = tid; i < kFT * CC; i += kThreads) acc[i] = 0.0f;
  __syncthreads();
  int s_lo = kEmpty, s_hi = -kEmpty;
#pragma unroll 8
  for (int f = 0; f < kFT; ++f) {
    s_lo = min(s_lo, lo_s[f]);
    s_hi = max(s_hi, hi_s[f]);
  }
  const int nq = (K + kHC - 1) / kHC;   // rotation chains a sample
  // warp 0 stages chunk c + 1 from registers loaded a chunk before
  auto fetch = [&](int n, float& xv, float& cv) {
    const bool in = n >= 0 && n < nx;
    xv = in ? xb[n] : 0.0f;
    cv = in ? cb[n] : 0.0f;
  };
  auto stage = [&](int bf, float xv, float cv) {
    float s, c;
    sincospif(2.0f * llsm::frac_c(cv), &s, &c);
    xs[bf][tid] = xv;
    zs[bf][tid] = make_float2(c, -s);
    sincospif(2.0f * llsm::kmul_c((float)kHC, cv), &s, &c);
    zhs[bf][tid] = make_float2(c, -s);
  };
  float xn = 0.0f, cn = 0.0f;
  if (tid < kSC) {
    fetch(s_lo + tid, xn, cn);
    stage(0, xn, cn);
    fetch(s_lo + kSC + tid, xn, cn);
  }
  __syncthreads();

  int buf = 0;
  for (int ch = s_lo; ch < s_hi; ch += kSC, buf ^= 1) {
    // the frames whose supports meet the chunk, by every warp alike
    const bool lv = lo_s[lane] < ch + kSC && hi_s[lane] > ch;
    const unsigned m = __ballot_sync(0xffffffffu, lv);
    const int fa = m ? __ffs(m) - 1 : 0;
    const int nl = m ? 32 - __clz(m) - fa : 0;
    const int tf = nl <= 12 ? (nl + 1) / 2 * 2 : 16;
    const int nlp = (nl + tf - 1) / tf * tf;
    if (nl > 0 && !LLSM_SKIP_PASS_A) {
      // G: chain (n, q) covers harmonics k0 = q kHC + 1 .. k0 + kHC - 1,
      // started at x z (z^kHC)^q and stepped by z, both exact a sample
      for (int it = tid; it < kSC * nq; it += kThreads) {
        const int n = it % kSC, q = it / kSC;
        const int k0 = q * kHC + 1;
        const float xv = xs[buf][n];
        const float2 z = zs[buf][n], zh = zhs[buf][n];
        float zr = xv * z.x, zi = xv * z.y;
        for (int p = 0; p < q; ++p) {
          const float nr = zr * zh.x - zi * zh.y;
          zi = zr * zh.y + zi * zh.x;
          zr = nr;
        }
        float2* g = reinterpret_cast<float2*>(G + n * CC) + k0;
        if (k0 + kHC - 1 <= K) {
#pragma unroll
          for (int j = 0; j < kHC; ++j) {
            g[j] = make_float2(zr, zi);
            const float nr = zr * z.x - zi * z.y;
            zi = zr * z.y + zi * z.x;
            zr = nr;
          }
        } else {
          for (int j = 0; k0 + j <= K; ++j) {
            g[j] = make_float2(zr, zi);
            const float nr = zr * z.x - zi * z.y;
            zi = zr * z.y + zi * z.x;
            zr = nr;
          }
        }
        if (q == 0) reinterpret_cast<float2*>(G + n * CC)[0] =
            make_float2(1.0f, xv);
      }
      // window rows of the live range, padded to whole frame tiles: a
      // thread a frame and 8 samples, cos 2 pi u by a rotation started
      // exactly at the first sample (cos 4 pi u, cos 6 pi u from it by
      // Chebyshev); zero off the support and outside u in [0, 1]
      // (on the top warps: warp 0 also stages the next chunk)
      for (int it = kThreads - 1 - tid; it < 4 * nlp; it += kThreads) {
        const int fl = it >> 2, n0 = 8 * (it & 3);
        float* wp = W + n0 * kWP + fl;
        if (fl >= nl) {
#pragma unroll
          for (int i = 0; i < 8; ++i) wp[i * kWP] = 0.0f;
          continue;
        }
        const int f = fa + fl, lo = lo_s[f], hi = hi_s[f];
        const float rhw = rhw_s[f];
        const float2 st = wstep_s[f];
        const int d0 = ch + n0 - (f0 + f) * nhop;
        float sn, cs;
        sincospif(2.0f * (((float)d0 * rhw + 1.0f) * 0.5f), &sn, &cs);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int sm = ch + n0 + i;
          const float u = ((float)(d0 + i) * rhw + 1.0f) * 0.5f;
          const float t2 = 2.0f * cs * cs - 1.0f;
          const float t3 = cs * (2.0f * t2 - 1.0f);
          const float w = fmaf(c3, t3, fmaf(c2, t2, fmaf(c1, cs, c0)));
          wp[i * kWP] = sm >= lo && sm < hi && u >= 0.0f && u <= 1.0f
                            ? w : 0.0f;
          const float nc = cs * st.x - sn * st.y;
          sn = cs * st.y + sn * st.x;
          cs = nc;
        }
      }
    }
    if (tid < kSC) {   // chunk c + 1 into the other buffer, c + 2 in flight
      stage(buf ^ 1, xn, cn);
      fetch(ch + 2 * kSC + tid, xn, cn);
    }
    __syncthreads();
    if (nl > 0 && !LLSM_SKIP_PASS_B) {
      switch (tf) {
        case 2: product<2>(G, W, acc, CC, fa, 1, tid); break;
        case 4: product<4>(G, W, acc, CC, fa, 1, tid); break;
        case 6: product<6>(G, W, acc, CC, fa, 1, tid); break;
        case 8: product<8>(G, W, acc, CC, fa, 1, tid); break;
        case 10: product<10>(G, W, acc, CC, fa, 1, tid); break;
        case 12: product<12>(G, W, acc, CC, fa, 1, tid); break;
        default: product<16>(G, W, acc, CC, fa, nlp / 16, tid);
      }
    }
    __syncthreads();   // the chunk's reads are done before the next writes
  }

  // epilogue: pair 0 -> (wsum, xsum); pair k -> rotated to the centre
  for (int it = tid; it < kFT * (K + 1); it += kThreads) {
    const int f = it / (K + 1), p = it % (K + 1);
    const int F = f0 + f;
    if (F >= N) continue;
    const int64_t row = b * N + F;
    const float sr = acc[f * CC + 2 * p], si = acc[f * CC + 2 * p + 1];
    if (p == 0) {
      wsum[row] = sr;
      xsum[row] = si;
    } else {
      float s, c;
      sincospif(2.0f * llsm::kmul_c((float)p, cb[(int64_t)F * nhop]), &s,
                &c);
      re[row * K + p - 1] = sr * c - si * s;
      im[row * K + p - 1] = sr * s + si * c;
    }
  }
}

}  // namespace

extern "C" int llsm_harmonic_project_mxu(
    const float* x, const float* cyc, const float* hw, float* re, float* im,
    float* wsum, float* xsum, int B, int nx, int N, int K, int nhop,
    int reach, float c0, float c1, float c2, float c3, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  if (K < 0 || nhop <= 0 || B > 65535
      || (int64_t)N * nhop > nx || smem_bytes(K) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K);
  const cudaError_t e = llsm::allow_smem(proj_mxu_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((N + kFT - 1) / kFT), (unsigned)B);
  proj_mxu_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, cyc, hw, re, im, wsum, xsum, nx, N, K, nhop, reach, c0, c1, c2, c3);
  return (int)cudaGetLastError();
}
