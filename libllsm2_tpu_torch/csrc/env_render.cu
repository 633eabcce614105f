// Per-channel temporal noise envelopes and their baselines, per utterance b,
// hop i, sample t (s = t / nhop, frame i + 1 clamped to N - 1, so the last
// frame holds constant), for the first nx <= N nhop samples of each
// utterance (a cut render stops early):
//   env[b, c, i nhop + t]  = max(envelope_sample(...), 0)   (common.cuh)
//   base[b, c, i nhop + t] = max(lerp(base_c), 1e-8)
//
// Replaces libllsm2_tpu/ops/pallas_osc.py: env_render_pallas (_env_kernel).
// Bound on the H100: memory -- each sample reads one cycle value and writes
// 2 C floats, against C (Ke + 1) complex lerp-and-rotate steps.  Design: one
// block per tile of kFrames frames of one utterance.  The block stages the
// coefficient rows of its frames and the next one (edc, base [C]; ar, ai
// [C, Ke]) in shared memory once; then one thread per sample takes one
// sincospif of its cycle (mod 1) and runs the same lerp + rotation
// recurrence as noise_mod_ola.cu for every channel, writing each channel's
// row coalesced along samples.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 16;

__global__ void __launch_bounds__(kThreads)
env_render_kernel(const float* __restrict__ cyc, const float* __restrict__ edc,
                  const float* __restrict__ ar, const float* __restrict__ ai,
                  const float* __restrict__ base, float* __restrict__ env,
                  float* __restrict__ base_o, int N, int nhop, int64_t nx,
                  int C, int Ke) {
  extern __shared__ float sm[];
  const int CK = C * Ke;
  const int W = 2 * C + 2 * CK;            // floats per staged frame row
  float* s_edc = sm;                        // [kFrames + 1, C]
  float* s_base = s_edc + (kFrames + 1) * C;
  float* s_ar = s_base + (kFrames + 1) * C; // [kFrames + 1, C, Ke]
  float* s_ai = s_ar + (kFrames + 1) * CK;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const int64_t row0 = (int64_t)b * N;
  for (int idx = threadIdx.x; idx < (kFrames + 1) * W; idx += kThreads) {
    const int r = idx / W, q = idx - r * W;
    const int64_t fr = row0 + min(f0 + r, N - 1);
    if (q < C) {
      s_edc[r * C + q] = edc[fr * C + q];
    } else if (q < 2 * C) {
      s_base[r * C + q - C] = base[fr * C + q - C];
    } else if (q < 2 * C + CK) {
      s_ar[r * CK + q - 2 * C] = ar[fr * CK + q - 2 * C];
    } else {
      s_ai[r * CK + q - 2 * C - CK] = ai[fr * CK + q - 2 * C - CK];
    }
  }
  __syncthreads();
  const int64_t g0 = (int64_t)f0 * nhop;
  const int ns = (int)min((int64_t)kFrames * nhop, nx - g0);
  const float inv_hop = 1.0f / (float)nhop;
  for (int idx = threadIdx.x; idx < ns; idx += kThreads) {
    const int r = idx / nhop, t = idx - r * nhop;
    const int64_t g = g0 + idx;
    const float s = (float)t * inv_hop;
    float s1, c1;
    sincospif(2.0f * llsm::frac_c(cyc[(int64_t)b * nx + g]), &s1, &c1);
    for (int c = 0; c < C; ++c) {
      const float e = llsm::envelope_sample(
          s_edc[r * C + c], s_edc[(r + 1) * C + c], s_ar + r * CK + c * Ke,
          s_ar + (r + 1) * CK + c * Ke, s_ai + r * CK + c * Ke,
          s_ai + (r + 1) * CK + c * Ke, Ke, s, c1, s1);
      const float b0 = s_base[r * C + c];
      const float bl = b0 + (s_base[(r + 1) * C + c] - b0) * s;
      const int64_t o = ((int64_t)b * C + c) * nx + g;
      env[o] = fmaxf(e, 0.0f);
      base_o[o] = fmaxf(bl, 1e-8f);
    }
  }
}

}  // namespace

extern "C" int llsm_env_render(const float* cyc, const float* edc,
                               const float* ar, const float* ai,
                               const float* base, float* env, float* base_o,
                               int B, int N, int nhop, int nx, int C,
                               int Ke, void* stream) {
  if (B <= 0 || N <= 0 || nhop <= 0 || nx <= 0 || C <= 0)
    return (int)cudaGetLastError();
  if ((int64_t)nx > (int64_t)N * nhop) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(kFrames + 1) * (2 * C + 2 * C * Ke) * sizeof(float);
  cudaError_t e = llsm::allow_smem(env_render_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t tile = (int64_t)kFrames * nhop;
  dim3 grid((unsigned)((nx + tile - 1) / tile), B);
  env_render_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      cyc, edc, ar, ai, base, env, base_o, N, nhop, (int64_t)nx, C, Ke);
  return (int)cudaGetLastError();
}
