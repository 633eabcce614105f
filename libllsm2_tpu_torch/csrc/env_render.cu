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
// Past Ke = 8 (maxnhar_e >= 9) env_render_wide_kernel keeps that design
// for any Ke: a block per tile of H frames of one utterance (64, 32 or 16:
// of those whose coefficients fit shared memory, the one that makes the
// fewest waves of blocks x runs of the busiest thread, by the kernel's
// occupancy; 16 fit every C and Ke the wrapper admits)
// stages each frame's coefficients once in slope form, as float4s (a_i,
// a_{i+1} - a_i, the same for ai; edc with base), so one 16-byte load a
// harmonic feeds four samples.  A thread takes runs of 4 consecutive
// samples of a hop (16-byte loads of the cycle track and 16-byte streaming
// stores where nhop and nx are multiples of 4 and the pointers aligned,
// else single ones, a run cut at the hop's end and at nx), walking the
// tile's (hop, run) pairs by the stride's quotient and remainder, the next
// run's cycles loaded while this one is made.  The rotation ladder is made
// once a sample for a group of up to 8 channels (4 where C <= 4: one
// ladder for every channel up to C = 8, fewer registers at C <= 4), a
// rotation at a time, each step used by every channel of the group before
// the next: envelope_sample's recurrence, each channel's terms added in
// the order of k, in registers of the group's envelopes alone.  Every
// product is spelled out as nvcc contracts envelope_sample (its SASS: the
// lerps fma(a1 - a0, s, a0), a term fma(rl, wr, -(il wi)) added to the
// envelope, the rotation (fma(wr, c1, -(wi s1)), fma(wr, s1, wi c1))), so
// the outputs are those of the wide kernel it replaced (a sample a
// thread, a ladder a channel) bit for bit.  Bound: the bytes (36 a sample
// at C = 4, 28 at C = 3) against 5 C Ke + 4 Ke float32 operations a
// sample; a budget of 64 registers at up to 4 channels (four blocks an
// SM), 85 past them (three).
// LLSM_SKIP_PASS_A = 1 compiles the wide kernel's harmonic terms out (the
// ladder and the coefficients' lerps), LLSM_SKIP_PASS_B = 1 its
// coefficient staging (zeros staged), for scripts/port_kernel_passes.py
// (only=env_wide).
#include <map>
#include <mutex>
#include <utility>

#include "common.cuh"

#ifndef LLSM_SKIP_PASS_A
#define LLSM_SKIP_PASS_A 0
#endif
#ifndef LLSM_SKIP_PASS_B
#define LLSM_SKIP_PASS_B 0
#endif
// LLSM_ENV_TILE = 16, 32 or 64 forces the wide kernel's frames a tile
// where they fit (scripts/port_kernel_passes.py only=env_tiles)
#ifndef LLSM_ENV_TILE
#define LLSM_ENV_TILE 0
#endif

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

// Past kMaxKe harmonics: env_render_wide_kernel (the header says how)
constexpr int kWideThreads = 256;
constexpr int kWideS = 4;      // samples a thread
constexpr int kWideTiles[] = {64, 32, 16};   // frames a tile, tried in order

// blocks an SM each channel group is compiled for: the most whose register
// budget holds it (4: 64 registers, 3: 85); LLSM_ENV_BLOCKS forces it
// (scripts/port_kernel_passes.py only=env_tiles)
#ifndef LLSM_ENV_BLOCKS
#define LLSM_ENV_BLOCKS 0
#endif
constexpr int wide_min_blocks(int CG) {
  return LLSM_ENV_BLOCKS ? LLSM_ENV_BLOCKS : CG <= 4 ? 4 : 3;
}

// z <- z e^{2 pi j cyc}, as nvcc compiles envelope_sample's rotation
__device__ __forceinline__ void wide_rotate(float& wr, float& wi, float c1,
                                            float s1) {
  const float nwr = __fmaf_rn(wr, c1, -__fmul_rn(wi, s1));
  wi = __fmaf_rn(wr, s1, __fmul_rn(wi, c1));
  wr = nwr;
}

// VEC: runs of 4 samples by 16-byte loads and stores (nhop % 4 == 0, nx %
// 4 == 0, cyc / env / base_o 16-byte aligned); CG: channels a group (the
// ladder made once a sample for each group)
template <bool VEC, int CG>
__global__ void __launch_bounds__(kWideThreads, wide_min_blocks(CG))
env_render_wide_kernel(const float* __restrict__ cyc,
                       const float* __restrict__ edc,
                       const float* __restrict__ ar,
                       const float* __restrict__ ai,
                       const float* __restrict__ base,
                       float* __restrict__ env, float* __restrict__ base_o,
                       int N, int nhop, int64_t nx, int C, int Ke, int H) {
  constexpr int S = kWideS;
  extern __shared__ float4 smw[];
  const int CK = C * Ke;
  // [H, C]: (edc_i, edc_{i+1} - edc_i, base_i, base_{i+1} - base_i)
  float4* s_eb = smw;
  // [H, C, Ke]: (ar_i, ar_{i+1} - ar_i, ai_i, ai_{i+1} - ai_i)
  float4* s_ri = smw + H * C;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * H;
  const int64_t row0 = (int64_t)b * N;
  for (int idx = threadIdx.x; idx < H * C; idx += kWideThreads) {
    const int r = idx / C, c = idx - r * C;
    const int64_t fa = (row0 + min(f0 + r, N - 1)) * C + c;
    const int64_t fb = (row0 + min(f0 + r + 1, N - 1)) * C + c;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (!LLSM_SKIP_PASS_B) {
      const float e = __ldg(edc + fa), bs = __ldg(base + fa);
      v = make_float4(e, __fsub_rn(__ldg(edc + fb), e), bs,
                      __fsub_rn(__ldg(base + fb), bs));
    }
    s_eb[idx] = v;
  }
  for (int idx = threadIdx.x; idx < H * CK; idx += kWideThreads) {
    const int r = idx / CK, q = idx - r * CK;
    const int64_t fa = (row0 + min(f0 + r, N - 1)) * CK + q;
    const int64_t fb = (row0 + min(f0 + r + 1, N - 1)) * CK + q;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (!LLSM_SKIP_PASS_B) {
      const float re = __ldg(ar + fa), im = __ldg(ai + fa);
      v = make_float4(re, __fsub_rn(__ldg(ar + fb), re), im,
                      __fsub_rn(__ldg(ai + fb), im));
    }
    s_ri[idx] = v;
  }
  __syncthreads();

  // runs of S samples: nq a hop, the last cut at the hop's end (and at nx)
  const int nh = min(H, N - f0), nq = (nhop + S - 1) / S, items = nh * nq;
  const float inv_hop = 1.0f / (float)nhop;
  const float* cycr = cyc + (int64_t)b * nx;
  // the thread's first run (hop i, samples q S ...), then the block's
  // stride as a quotient and remainder of hops
  int i = threadIdx.x / nq, q = threadIdx.x - i * nq;
  const int di = kWideThreads / nq, dq = kWideThreads - di * nq;
  // a run's cycle samples, loaded one run ahead
  float cv[S];
  auto load = [&](int ii, int qq) {
    const int64_t g = (int64_t)(f0 + ii) * nhop + qq * S;
    const int n = (int)min((int64_t)min(S, nhop - qq * S), nx - g);
    if (VEC) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(cycr + g));
      cv[0] = u.x; cv[1] = u.y; cv[2] = u.z; cv[3] = u.w;
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) cv[s] = s < n ? __ldg(cycr + g + s) : 0.0f;
    }
  };
  if (threadIdx.x < items && (int64_t)(f0 + i) * nhop + q * S < nx) load(i, q);
  for (int e = threadIdx.x; e < items; e += kWideThreads) {
    const int t = q * S;
    const int64_t g = (int64_t)(f0 + i) * nhop + t;
    if (g >= nx) break;                          // later runs lie further
    const int n = (int)min((int64_t)min(S, nhop - t), nx - g);
    float c1[S], s1[S], sv[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      sincospif(2.0f * llsm::frac_c(cv[s]), &s1[s], &c1[s]);
      sv[s] = (float)(t + s) * inv_hop;
    }
    // the next run (hop i2, samples q2 S ...), its cycles in flight
    int i2 = i + di, q2 = q + dq;
    if (q2 >= nq) {
      q2 -= nq;
      ++i2;
    }
    if (e + kWideThreads < items && (int64_t)(f0 + i2) * nhop + q2 * S < nx)
      load(i2, q2);
    const float4* eb = s_eb + i * C;
    const float4* ri = s_ri + i * CK;
    for (int c0 = 0; c0 < C; c0 += CG) {
      const int nc = min(CG, C - c0);
      float ev[CG][S];
#pragma unroll
      for (int u = 0; u < CG; ++u) {
        if (u >= nc) break;
        const float4 w = eb[c0 + u];
#pragma unroll
        for (int s = 0; s < S; ++s) ev[u][s] = __fmaf_rn(sv[s], w.y, w.x);
      }
      // the ladder z^(k + 1), k < Ke, a rotation at a time, each step used
      // by every channel of the group (each channel's terms in the order
      // of k)
      float zr[S], zi[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        zr[s] = c1[s];
        zi[s] = s1[s];
      }
      for (int k = 0; !LLSM_SKIP_PASS_A && k < Ke; ++k) {
#pragma unroll
        for (int u = 0; u < CG; ++u) {
          if (u >= nc) break;
          const float4 w = ri[(c0 + u) * Ke + k];
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const float rl = __fmaf_rn(sv[s], w.y, w.x);
            const float il = __fmaf_rn(sv[s], w.w, w.z);
            ev[u][s] = __fadd_rn(ev[u][s],
                                 __fmaf_rn(rl, zr[s], -__fmul_rn(il, zi[s])));
          }
        }
#pragma unroll
        for (int s = 0; s < S; ++s) wide_rotate(zr[s], zi[s], c1[s], s1[s]);
      }
#pragma unroll
      for (int u = 0; u < CG; ++u) {
        if (u >= nc) break;
        const float4 w = eb[c0 + u];
        float ov[S], bv[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          ov[s] = fmaxf(ev[u][s], 0.0f);
          bv[s] = fmaxf(__fmaf_rn(sv[s], w.w, w.z), 1e-8f);
        }
        const int64_t o = ((int64_t)b * C + c0 + u) * nx + g;
        // streaming stores: the outputs are not read again here
        if (VEC) {
          __stcs(reinterpret_cast<float4*>(env + o),
                 make_float4(ov[0], ov[1], ov[2], ov[3]));
          __stcs(reinterpret_cast<float4*>(base_o + o),
                 make_float4(bv[0], bv[1], bv[2], bv[3]));
        } else {
#pragma unroll
          for (int s = 0; s < S; ++s) {
            if (s < n) {
              __stcs(env + o + s, ov[s]);
              __stcs(base_o + o + s, bv[s]);
            }
          }
        }
      }
    }
    i = i2;
    q = q2;
  }
}

// Blocks of `kernel` an SM holds at `smem` dynamic bytes on device `dev`,
// asked of the runtime once a (device, bytes) and kept (its queries cost
// more host time than a launch)
template <typename Kernel>
cudaError_t wide_occupancy(Kernel kernel, int dev, size_t smem, int* out) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, int> seen;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(dev, smem);
  const auto it = seen.find(key);
  if (it != seen.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  cudaError_t e = llsm::allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                      kWideThreads, smem);
  if (e == cudaSuccess) seen[key] = *out;
  return e;
}

// The wide kernel's frames a tile H: of kWideTiles, those whose
// coefficients fit the card's shared memory, the one that makes the least
// of (waves of blocks) x (runs the busiest thread of a block takes), the
// blocks resident at once from the kernel's occupancy at that H (the
// larger H of a tie); LLSM_ENV_TILE forces H
template <bool VEC, int CG>
cudaError_t launch_wide(const float* cyc, const float* edc, const float* ar,
                        const float* ai, const float* base, float* env,
                        float* base_o, int B, int N, int nhop, int nx, int C,
                        int Ke, cudaStream_t st) {
  auto kernel = env_render_wide_kernel<VEC, CG>;
  int dev = 0, cap = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int nq = (nhop + kWideS - 1) / kWideS;
  int H = 0;
  long long cost = 0;
  for (int h : kWideTiles) {
    const size_t smem = (size_t)h * (C + (size_t)C * Ke) * sizeof(float4);
    if (smem > (size_t)cap || (LLSM_ENV_TILE && h != LLSM_ENV_TILE))
      continue;
    int per_sm = 0;
    e = wide_occupancy(kernel, dev, smem, &per_sm);
    if (e != cudaSuccess) return e;
    const long long tile = (long long)h * nhop;
    const long long blocks = (long long)B * ((nx + tile - 1) / tile);
    const long long resident = (long long)max(per_sm, 1) * sms;
    const long long c = (blocks + resident - 1) / resident *
                        (((long long)h * nq + kWideThreads - 1) / kWideThreads);
    if (H == 0 || c < cost) {
      H = h;
      cost = c;
    }
  }
  if (H == 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)H * (C + (size_t)C * Ke) * sizeof(float4);
  e = llsm::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int64_t tile = (int64_t)H * nhop;
  dim3 grid((unsigned)((nx + tile - 1) / tile), B);
  kernel<<<grid, kWideThreads, smem, st>>>(cyc, edc, ar, ai, base, env,
                                           base_o, N, nhop, (int64_t)nx, C,
                                           Ke, H);
  return cudaGetLastError();
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
  const bool aligned = ((uintptr_t)cyc | (uintptr_t)env |
                        (uintptr_t)base_o) % 16 == 0;
  if (Ke > kMaxKe) {
    const bool vec = nhop % kWideS == 0 && nx % kWideS == 0 && aligned;
    cudaError_t e;
    if (C <= 4)
      e = vec ? launch_wide<true, 4>(cyc, edc, ar, ai, base, env, base_o, B,
                                     N, nhop, nx, C, Ke, st)
              : launch_wide<false, 4>(cyc, edc, ar, ai, base, env, base_o,
                                      B, N, nhop, nx, C, Ke, st);
    else
      e = vec ? launch_wide<true, 8>(cyc, edc, ar, ai, base, env, base_o, B,
                                     N, nhop, nx, C, Ke, st)
              : launch_wide<false, 8>(cyc, edc, ar, ai, base, env, base_o,
                                      B, N, nhop, nx, C, Ke, st);
    return (int)e;
  }
  if (C == 4 && Ke == 4 && nhop % 4 == 0 && nx % 4 == 0 && aligned)
    return (int)launch<4, 4, 4>(cyc, edc, ar, ai, base, env, base_o, B, N,
                                nhop, nx, C, Ke, st);
  return (int)launch<0, 0, 1>(cyc, edc, ar, ai, base, env, base_o, B, N,
                              nhop, nx, C, Ke, st);
}
