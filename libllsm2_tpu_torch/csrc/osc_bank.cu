// Oscillator bank with its Hann overlap-add, in one launch: for sample
// s = i nhop + t of an utterance (t in [0, nhop)),
//   y[s] = w(nhop + t) seg_i(s) + w(t) seg_{i+1}(s),
//   seg_n(s) = sum_{k < kl[n]} a m cos(2 pi (k+1) dc_n(s) + phi),
//   dc_n(s) = cyc[s] - cyc[n nhop],  w(u) = 0.5 - 0.5 cos(2 pi (u + .5) / 2nhop)
// (frame N does not exist: the last hop block takes frame N-1 alone), or
// x[s] - y[s] with the residual input x.  That is the framed segments of the
// TPU kernel times the OLA window, overlap-added (harmonics.oscillator_bank
// and overlap_add_half compose it in plain PyTorch).
//
// Replaces libllsm2_tpu/ops/pallas_osc.py: osc_bank_pallas (_osc_kernel),
// with the framing, the coefficients, the window and the OLA of
// libllsm2_tpu/ops/harmonics.py: oscillator_bank / overlap_add_half.  Bound on
// the H100: arithmetic -- per output sample two segments of up to 80 live
// harmonics against 4 bytes of cyc (and 4 of x) read and 4 written.
// Design: a block takes 16 hop blocks of one utterance and forms the 17
// frames' coefficients and live counts in shared memory; a half warp takes
// one hop block (16 lanes x 5 samples = the 80 of the 16 kHz hop, every lane
// busy), the warp's loop over harmonics bounded by its three frames' live
// counts.  Each sample runs ONE rotation chain z^{k+1}, z = e^{2 pi j dc_i}
// with dc_i the framed path's float32 difference, bit for bit, and feeds
// both segments: frame i+1's coefficients are staged already rotated by
// e^{-2 pi j (k+1) (cyc[c_{i+1}] - cyc[c_i])} (its phase in cycles, the
// product error of (k+1) times that offset added back), so its term is
// a cos(2 pi (k+1) dc_{i+1} + phi) to float32 rounding.  That is 8 FP32
// instructions a harmonic a sample (a complex rotation, four FMAs) where
// two chains took 12.  The chain restarts every 16 harmonics from a chunk
// start carried by an exact z^16 (sincospif), so rounding does not grow
// with k.  No frame buffer exists.
#include "common.cuh"

namespace {

constexpr int kHops = 16;              // hop blocks per block, two a warp
constexpr int kThreads = kHops * 16;
constexpr int kChunk = 16;             // harmonics per chunk-start carry
// samples a lane: 16 lanes x 5 cover the 80 of the 16 kHz hop; other hops
// take ceil(nhop / 80) sample groups, the last one partly idle
constexpr int S = 5;

struct Chain {
  float zc, zs;      // e^{2 pi j dc}
  float qc, qs;      // e^{2 pi j 16 dc}
  float sc, ss;      // chunk start e^{2 pi j (k0 + 1) dc}
};

__device__ __forceinline__ void chain_init(Chain& c, float dc) {
  const float r = llsm::frac_c(dc);
  sincospif(2.0f * r, &c.zs, &c.zc);
  sincospif(2.0f * llsm::frac_c(16.0f * r), &c.qs, &c.qc);
  c.sc = c.zc;
  c.ss = c.zs;
}

__global__ void __launch_bounds__(kThreads)
osc_bank_kernel(const float* __restrict__ cyc, const float* __restrict__ ampl,
                const float* __restrict__ phse, const float* __restrict__ mask,
                const float* __restrict__ x, float* __restrict__ y, int N,
                int K, int Kp, int nhop) {
  // [kHops + 1][Kp] (a m cos phi, a m sin phi) of frame i0 + r, then the
  // same rows rotated to the previous frame's center
  extern __shared__ float2 coef[];
  __shared__ int kl[kHops + 1];
  float2* own = coef;
  float2* nxt = coef + (kHops + 1) * Kp;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kHops;
  const int64_t nx = (int64_t)N * nhop;
  const float* cy = cyc + b * nx;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv2pi = 0.15915494309189535f;
  // a warp stages a frame's row and takes its live count (highest live
  // slot + 1) as one warp max
  for (int r = warp; r <= kHops; r += kThreads / 32) {
    const int n = i0 + r;
    const bool in = n < N;
    const float dl = (in && n > 0)
        ? cy[(int64_t)n * nhop] - cy[(int64_t)(n - 1) * nhop] : 0.0f;
    int live = 0;
    for (int k = lane; k < Kp; k += 32) {
      float2 c = make_float2(0.0f, 0.0f), cr = c;
      if (in && k < K) {
        const int64_t o = ((int64_t)b * N + n) * K + k;
        const float m = mask[o];
        if (m > 0.0f) live = k + 1;
        const float a = ampl[o] * m, ph = phse[o];
        float sp, cp;
        sincosf(ph, &sp, &cp);
        c = make_float2(a * cp, a * sp);
        sincospif(2.0f * llsm::frac_c(ph * inv2pi -
                                      llsm::kmul_c((float)(k + 1), dl)),
                  &sp, &cp);
        cr = make_float2(a * cp, a * sp);
      }
      own[r * Kp + k] = c;
      nxt[r * Kp + k] = cr;
    }
    live = __reduce_max_sync(0xffffffffu, live);
    if (lane == 0) kl[r] = live;
  }
  __syncthreads();

  const int h = threadIdx.x >> 4, sub = threadIdx.x & 15;
  if (i0 + 2 * warp >= N) return;            // both half warps past the end
  const int i = i0 + h;
  const bool act = i < N;
  const int ic = act ? i : N - 1;            // reads stay in the utterance
  int kmax = act ? max(kl[h], kl[h + 1]) : 0;
  kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, 16));
  const float2* c0 = own + h * Kp;           // frame i at its own center
  const float2* c1 = nxt + (h + 1) * Kp;     // frame i + 1 at frame i's
  const float cc = cy[(int64_t)ic * nhop];
  const float inv_t = 1.0f / (float)nhop;    // (2u + 1) / (2 nhop) cycles

  for (int tg = 0; tg < nhop; tg += 16 * S) {
    Chain ch[S];
    float acc0[S], acc1[S];
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int t = min(tg + sub + 16 * q, nhop - 1);
      chain_init(ch[q], cy[(int64_t)ic * nhop + t] - cc);
      acc0[q] = acc1[q] = 0.0f;
    }
    for (int k0 = 0; k0 < kmax; k0 += kChunk) {
      float wr[S], wi[S];
#pragma unroll
      for (int q = 0; q < S; ++q) {
        Chain& c = ch[q];
        if (k0 > 0) {   // next chunk start: z^{k0+1} = z^{k0-15} z^16
          const float nc = c.sc * c.qc - c.ss * c.qs;
          c.ss = c.sc * c.qs + c.ss * c.qc;
          c.sc = nc;
        }
        wr[q] = c.sc;
        wi[q] = c.ss;
      }
      const int k1 = min(k0 + kChunk, kmax);
      for (int kb = k0; kb < k1; kb += 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 a0 = c0[kb + j], a1 = c1[kb + j];
#pragma unroll
          for (int q = 0; q < S; ++q) {
            acc0[q] = fmaf(a0.x, wr[q], acc0[q]);
            acc0[q] = fmaf(-a0.y, wi[q], acc0[q]);
            acc1[q] = fmaf(a1.x, wr[q], acc1[q]);
            acc1[q] = fmaf(-a1.y, wi[q], acc1[q]);
            const float nr = wr[q] * ch[q].zc - wi[q] * ch[q].zs;
            wi[q] = wr[q] * ch[q].zs + wi[q] * ch[q].zc;
            wr[q] = nr;
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int t = tg + sub + 16 * q;
      if (!act || t >= nhop) continue;
      const int64_t s = b * nx + (int64_t)i * nhop + t;
      const float w1 = 0.5f - 0.5f * cospif((float)(nhop + t) * inv_t +
                                            0.5f * inv_t);
      const float w0 = 0.5f - 0.5f * cospif((float)t * inv_t + 0.5f * inv_t);
      const float v = w1 * acc0[q] + w0 * acc1[q];
      y[s] = x ? x[s] - v : v;
    }
  }
}

}  // namespace

extern "C" int llsm_osc_bank(const float* cyc, const float* ampl,
                             const float* phse, const float* mask,
                             const float* x, float* y, int B, int N, int K,
                             int nhop, void* stream) {
  if (B <= 0 || N <= 0 || nhop <= 0) return (int)cudaGetLastError();
  if (K <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const int Kp = (K + 3) / 4 * 4;
  const size_t smem = 2 * (size_t)(kHops + 1) * Kp * sizeof(float2);
  cudaError_t e = llsm::allow_smem(osc_bank_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + kHops - 1) / kHops, B);
  osc_bank_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      cyc, ampl, phse, mask, x, y, N, K, Kp, nhop);
  return (int)cudaGetLastError();
}
