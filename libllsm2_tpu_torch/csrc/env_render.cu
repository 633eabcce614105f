// Per-channel temporal noise envelopes and their baselines, per utterance b,
// hop i, sample t (s = t / nhop, frame i + 1 clamped to N - 1, so the last
// frame holds constant), for the first nx <= N nhop samples of each
// utterance (a cut render stops early):
//   env[b, c, i nhop + t]  = max(lerp(edc_c) + sum_k lerp(ar_ck) cos(2 pi k
//                                cyc) - lerp(ai_ck) sin(2 pi k cyc), 0)
//   base[b, c, i nhop + t] = max(lerp(base_c), 1e-8)
// with lerp(a) = a_i + (a_{i+1} - a_i) s, k = 1..Ke.
//
// Replaces libllsm2_tpu/ops/pallas_osc.py: env_render_pallas (_env_kernel).
// Bound on the H100: memory -- each sample reads one cycle value and writes
// 2 C floats (36 bytes at C = 4), against one sincospif, Ke - 1 complex
// rotations and C (4 Ke + 2) fused multiply-adds.  Design: a block per
// tile of kFrames frames of one utterance stages each frame's coefficients
// once in slope form (a_i, a_{i+1} - a_i: edc, base [C]; ar, ai [C, Ke]),
// so a lerp is one FMA.  Each sample runs ONE rotation ladder
// (cos, sin)(2 pi k cyc), k = 1..Ke, from one sincospif of its cycle mod 1,
// and every channel uses it: the products and sums of common.cuh's
// envelope_sample (which noise_mod_ola.cu keeps), taken once a sample
// instead of once a channel.  At C = Ke = 4 with nhop and nx multiples of 4
// a thread takes 4 consecutive samples of one frame: one float4 of cycles
// in, the coefficients as float4 (k along a vector), a float4 of each
// channel's env and base out, as streaming stores; at most 64 registers,
// so four blocks of 256 threads share an SM.  Other shapes take the same
// code a sample at a time with scalar loads and stores.  Threads walk the
// tile's (frame, run) pairs in order, the pair advanced by adding the
// stride's quotient and remainder (one divide a thread, none a sample).
// Past Ke = 8 (maxnhar_e >= 9) env_render_wide_kernel takes a sample a
// thread, its ladder a rotation at a time inside each channel's sum
// (common.cuh's envelope_sample, as noise_mod_ola.cu renders it): no
// register arrays sized by Ke, so any Ke whose coefficients fit in shared
// memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;          // an SM's blocks: at most 64 registers
constexpr int kFrames = 32;
constexpr int kMaxKe = 8;

// n consecutive floats of shared memory into v (float4 loads when n is 4)
template <int KM>
__device__ __forceinline__ void load_k(const float* p, int n, float* v) {
  if constexpr (KM == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < KM; ++k) v[k] = k < n ? p[k] : 0.0f;
  }
}

// CT, KT: compile-time C and Ke (0: the runtime C_, Ke_ <= kMaxKe); V: the
// samples a thread takes at once (4: float4 along samples, nhop % 4 == 0,
// nx % 4 == 0, cyc 16-byte aligned)
template <int CT, int KT, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
env_render_kernel(const float* __restrict__ cyc, const float* __restrict__ edc,
                  const float* __restrict__ ar, const float* __restrict__ ai,
                  const float* __restrict__ base, float* __restrict__ env,
                  float* __restrict__ base_o, int N, int nhop, int64_t nx,
                  int C_, int Ke_) {
  constexpr int KM = KT ? KT : kMaxKe;
  const int C = CT ? CT : C_;
  const int Ke = KT ? KT : Ke_;
  const int CK = C * Ke;
  extern __shared__ float4 sm4[];
  float* s_e0 = reinterpret_cast<float*>(sm4);   // [kFrames, C]: edc_i
  float* s_ed = s_e0 + kFrames * C;              // edc_{i+1} - edc_i
  float* s_b0 = s_ed + kFrames * C;              // base, the same
  float* s_bd = s_b0 + kFrames * C;
  float* s_r0 = s_bd + kFrames * C;              // [kFrames, C, Ke]: ar
  float* s_rd = s_r0 + kFrames * CK;
  float* s_i0 = s_rd + kFrames * CK;             // ai
  float* s_id = s_i0 + kFrames * CK;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const int64_t row0 = (int64_t)b * N;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < kFrames; r += kThreads / 32) {
    const int64_t fa = row0 + min(f0 + r, N - 1);
    const int64_t fb = row0 + min(f0 + r + 1, N - 1);
    for (int q = lane; q < C; q += 32) {
      const float e = edc[fa * C + q], bs = base[fa * C + q];
      s_e0[r * C + q] = e;
      s_ed[r * C + q] = edc[fb * C + q] - e;
      s_b0[r * C + q] = bs;
      s_bd[r * C + q] = base[fb * C + q] - bs;
    }
    for (int q = lane; q < CK; q += 32) {
      const float re = ar[fa * CK + q], im = ai[fa * CK + q];
      s_r0[r * CK + q] = re;
      s_rd[r * CK + q] = ar[fb * CK + q] - re;
      s_i0[r * CK + q] = im;
      s_id[r * CK + q] = ai[fb * CK + q] - im;
    }
  }
  __syncthreads();

  const int U = nhop / V;                        // runs a frame
  const int dr = kThreads / U, du = kThreads - dr * U;
  int r = threadIdx.x / U, u = threadIdx.x - r * U;
  const float inv_hop = 1.0f / (float)nhop;
  const float* cycr = cyc + (int64_t)b * nx;
  for (; r < kFrames; r += dr, u += du) {
    if (u >= U) { u -= U; ++r; }
    if (r >= kFrames) break;
    const int64_t g = (int64_t)(f0 + r) * nhop + u * V;
    if (g >= nx) break;                          // later pairs lie further
    float cv[V], s[V], wr[V][KM], wi[V][KM];
    if constexpr (V == 4) {
      const float4 q = *reinterpret_cast<const float4*>(cycr + g);
      cv[0] = q.x; cv[1] = q.y; cv[2] = q.z; cv[3] = q.w;
    } else {
      cv[0] = cycr[g];
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s[i] = (float)(u * V + i) * inv_hop;
      float s1, c1;
      sincospif(2.0f * llsm::frac_c(cv[i]), &s1, &c1);
      wr[i][0] = c1;
      wi[i][0] = s1;
#pragma unroll
      for (int k = 1; k < KM; ++k) {
        wr[i][k] = wr[i][k - 1] * c1 - wi[i][k - 1] * s1;
        wi[i][k] = wr[i][k - 1] * s1 + wi[i][k - 1] * c1;
      }
    }
    for (int c = 0; c < C; ++c) {
      const int rc = r * C + c;
      float a0[KM], ad[KM], p0[KM], pd[KM];
      load_k<KM>(s_r0 + rc * Ke, Ke, a0);
      load_k<KM>(s_rd + rc * Ke, Ke, ad);
      load_k<KM>(s_i0 + rc * Ke, Ke, p0);
      load_k<KM>(s_id + rc * Ke, Ke, pd);
      const float e0 = s_e0[rc], ed = s_ed[rc];
      const float b0 = s_b0[rc], bd = s_bd[rc];
      float ev[V], bv[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float e = e0 + ed * s[i];
#pragma unroll
        for (int k = 0; k < KM; ++k) {
          if (KT == 0 && k >= Ke) break;
          const float rl = a0[k] + ad[k] * s[i];
          const float il = p0[k] + pd[k] * s[i];
          e += rl * wr[i][k] - il * wi[i][k];
        }
        ev[i] = fmaxf(e, 0.0f);
        bv[i] = fmaxf(b0 + bd * s[i], 1e-8f);
      }
      const int64_t o = ((int64_t)b * C + c) * nx + g;
      // streaming stores: the outputs are not read again here
      if constexpr (V == 4) {
        __stcs(reinterpret_cast<float4*>(env + o),
               make_float4(ev[0], ev[1], ev[2], ev[3]));
        __stcs(reinterpret_cast<float4*>(base_o + o),
               make_float4(bv[0], bv[1], bv[2], bv[3]));
      } else {
        __stcs(env + o, ev[0]);
        __stcs(base_o + o, bv[0]);
      }
    }
  }
}

// Ke > kMaxKe: a sample a thread, coefficients staged per frame as
// env_render_kernel stages them (here as (a_i, a_{i+1}) pairs), each
// channel's envelope by envelope_sample
__global__ void __launch_bounds__(kThreads)
env_render_wide_kernel(const float* __restrict__ cyc,
                       const float* __restrict__ edc,
                       const float* __restrict__ ar,
                       const float* __restrict__ ai,
                       const float* __restrict__ base,
                       float* __restrict__ env, float* __restrict__ base_o,
                       int N, int nhop, int64_t nx, int C, int Ke) {
  const int CK = C * Ke;
  extern __shared__ float sm[];
  float* s_e = sm;                                // [kFrames + 1, C]
  float* s_b = s_e + (kFrames + 1) * C;
  float* s_r = s_b + (kFrames + 1) * C;           // [kFrames + 1, C, Ke]
  float* s_i = s_r + (kFrames + 1) * CK;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const int64_t row0 = (int64_t)b * N;
  for (int idx = threadIdx.x; idx < (kFrames + 1) * C; idx += kThreads) {
    const int64_t fr = row0 + min(f0 + idx / C, N - 1);
    s_e[idx] = edc[fr * C + idx % C];
    s_b[idx] = base[fr * C + idx % C];
  }
  for (int idx = threadIdx.x; idx < (kFrames + 1) * CK; idx += kThreads) {
    const int64_t fr = row0 + min(f0 + idx / CK, N - 1);
    s_r[idx] = ar[fr * CK + idx % CK];
    s_i[idx] = ai[fr * CK + idx % CK];
  }
  __syncthreads();
  const float inv_hop = 1.0f / (float)nhop;
  const float* cycr = cyc + (int64_t)b * nx;
  for (int e = threadIdx.x; e < kFrames * nhop; e += kThreads) {
    const int r = e / nhop, t = e - r * nhop;
    const int64_t g = (int64_t)(f0 + r) * nhop + t;
    if (g >= nx) break;
    const float sv = (float)t * inv_hop;
    float s1, c1;
    sincospif(2.0f * llsm::frac_c(cycr[g]), &s1, &c1);
    for (int c = 0; c < C; ++c) {
      const int rc = r * C + c;
      const float v = llsm::envelope_sample(
          s_e[rc], s_e[rc + C], s_r + rc * Ke, s_r + (rc + C) * Ke,
          s_i + rc * Ke, s_i + (rc + C) * Ke, Ke, sv, c1, s1);
      const float b0 = s_b[rc];
      const int64_t o = ((int64_t)b * C + c) * nx + g;
      __stcs(env + o, fmaxf(v, 0.0f));
      __stcs(base_o + o, fmaxf(b0 + (s_b[rc + C] - b0) * sv, 1e-8f));
    }
  }
}

template <int CT, int KT, int V>
cudaError_t launch(const float* cyc, const float* edc, const float* ar,
                   const float* ai, const float* base, float* env,
                   float* base_o, int B, int N, int nhop, int nx, int C,
                   int Ke, cudaStream_t st) {
  const size_t smem = (size_t)kFrames * 4 * (C + C * Ke) * sizeof(float);
  cudaError_t e = llsm::allow_smem(env_render_kernel<CT, KT, V>, smem);
  if (e != cudaSuccess) return e;
  const int64_t tile = (int64_t)kFrames * nhop;
  dim3 grid((unsigned)((nx + tile - 1) / tile), B);
  env_render_kernel<CT, KT, V><<<grid, kThreads, smem, st>>>(
      cyc, edc, ar, ai, base, env, base_o, N, nhop, (int64_t)nx, C, Ke);
  return cudaGetLastError();
}

}  // namespace

extern "C" int llsm_env_render(const float* cyc, const float* edc,
                               const float* ar, const float* ai,
                               const float* base, float* env, float* base_o,
                               int B, int N, int nhop, int nx, int C,
                               int Ke, void* stream) {
  if (B <= 0 || N <= 0 || nhop <= 0 || nx <= 0 || C <= 0)
    return (int)cudaGetLastError();
  if ((int64_t)nx > (int64_t)N * nhop || Ke < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (Ke > kMaxKe) {
    const size_t smem =
        (size_t)(kFrames + 1) * 2 * (C + C * Ke) * sizeof(float);
    cudaError_t e = llsm::allow_smem(env_render_wide_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    const int64_t tile = (int64_t)kFrames * nhop;
    dim3 grid((unsigned)((nx + tile - 1) / tile), B);
    env_render_wide_kernel<<<grid, kThreads, smem, st>>>(
        cyc, edc, ar, ai, base, env, base_o, N, nhop, (int64_t)nx, C, Ke);
    return (int)cudaGetLastError();
  }
  const bool aligned = ((uintptr_t)cyc | (uintptr_t)env |
                        (uintptr_t)base_o) % 16 == 0;
  if (C == 4 && Ke == 4 && nhop % 4 == 0 && nx % 4 == 0 && aligned)
    return (int)launch<4, 4, 4>(cyc, edc, ar, ai, base, env, base_o, B, N,
                                nhop, nx, C, Ke, st);
  return (int)launch<0, 0, 1>(cyc, edc, ar, ai, base, env, base_o, B, N,
                              nhop, nx, C, Ke, st);
}
