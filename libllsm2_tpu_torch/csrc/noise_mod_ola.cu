// Fused noise-band OLA + temporal-envelope modulation + band sum.
//
// For utterance b, hop i, sample t (s = t / nhop, i1 = min(i + 1, N - 1)):
//   lerp(a) = a[i] + (a[i1] - a[i]) s
//   env_c   = lerp(edc_c) + sum_k lerp(ar_ck) cos(2 pi (k+1) cyc)
//                                 - lerp(ai_ck) sin(2 pi (k+1) cyc)
//   ola_c   = segs[b,c,i,nhop+t] + (i + 1 < N ? segs[b,c,i+1,t] : 0)
//   y[b, i nhop + t] = sum_c ola_c max(env_c, 0) / max(lerp(base_c), 1e-8)
//
// Replaces libllsm2_tpu/ops/pallas_osc.py: noise_mod_ola_pallas
// (_noise_mod_kernel).  Bound on the H100: memory -- each output sample
// reads 2C segment values (8 floats at C = 4) and writes one; the
// envelope math is ~C (Ke + 2) complex steps.  Design: one thread per
// output sample over the whole batch; the hop-pair OLA and the
// next-frame lerp partners are read straight from the [B, C, N, 2 nhop]
// segments and [B, N, ...] coefficients (no cur/nxt or pair copies);
// threads of one hop share their coefficient loads through the cache.
// The envelope itself is common.cuh's envelope_sample (env_render.cu's too).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
noise_mod_kernel(const float* __restrict__ cyc, const float* __restrict__ edc,
                 const float* __restrict__ ar, const float* __restrict__ ai,
                 const float* __restrict__ base,
                 const float* __restrict__ segs, float* __restrict__ y,
                 int B, int N, int nhop, int C, int Ke) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t total = (int64_t)B * N * nhop;
  if (g >= total) return;
  const int64_t row = g / nhop;           // b * N + i
  const int t = (int)(g - row * nhop);
  const int b = (int)(row / N), i = (int)(row - (int64_t)b * N);
  const int64_t row1 = (int64_t)b * N + min(i + 1, N - 1);
  const float s = (float)t * (1.0f / (float)nhop);
  float s1, c1;
  sincospif(2.0f * llsm::frac_c(cyc[g]), &s1, &c1);
  const int T = 2 * nhop;
  float acc = 0.0f;
  for (int c = 0; c < C; ++c) {
    const int64_t o0 = row * C * Ke + c * Ke, o1 = row1 * C * Ke + c * Ke;
    const float env = llsm::envelope_sample(
        edc[row * C + c], edc[row1 * C + c], ar + o0, ar + o1, ai + o0,
        ai + o1, Ke, s, c1, s1);
    const float b0 = base[row * C + c];
    const float bl = b0 + (base[row1 * C + c] - b0) * s;
    const int64_t sg = (((int64_t)b * C + c) * N + i) * T;
    float ola = segs[sg + nhop + t];
    if (i + 1 < N) ola += segs[sg + T + t];
    acc += ola * (fmaxf(env, 0.0f) / fmaxf(bl, 1e-8f));
  }
  y[g] = acc;
}

}  // namespace

extern "C" int llsm_noise_mod_ola(const float* cyc, const float* edc,
                                  const float* ar, const float* ai,
                                  const float* base, const float* segs,
                                  float* y, int B, int N, int nhop, int C,
                                  int Ke, void* stream) {
  const int64_t total = (int64_t)B * N * nhop;
  if (total <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  noise_mod_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      cyc, edc, ar, ai, base, segs, y, B, N, nhop, C, Ke);
  return (int)cudaGetLastError();
}
