// Chirped harmonic projection of pre-windowed frames.
//
//   re[n,k] + j im[n,k] = sum_{w in [lo[n], hi[n])} xw[n,w] e^{-2 pi j (k+1) dc[n,w]}
//
// xw is already windowed and zero outside [lo, hi); dc is any
// representative of the cycle offset (reduced mod 1 here before any trig).
//
// Replaces libllsm2_tpu/ops/pallas_osc.py: harmonic_project_pallas
// (_proj_kernel).  Its caller is the harmonic analysis with a window
// outside the cosine series or at given centres (K = maxnhar).  The
// non-decimated F0 refine's probes (K = 1, five calls per analysis on
// [B*N, 2*halfwin_max + 1]) now run in refine_f0.cu's full-rate kernel;
// the K <= 8 path below stays for any small K.
// Bound on the H100: at K = 1, the bytes of the two [R, W] inputs (8 a
// live column, one sincospif each); at K = maxnhar, the arithmetic of
// the live (column x harmonic) rectangle.  Design: K <= 8 runs one warp
// per row, each lane striding over the live columns straight from device
// memory (coalesced), seeding z = e^{-2 pi j r} with one sincospif and
// rotating for the further harmonics, then warp shuffles -- no shared
// memory and no block barrier, so the K = 1 probe runs at the memory rate.
// K > 8 runs one block per row (proj_rows_kernel): the row's live columns
// [lo, hi) staged once in shared memory (xw and the reduced offset; the
// block's room sized by a live span, kernels._project_geometry, not by W),
// then passes over them of G groups of 8 harmonics, each column's z =
// e^{2 pi j r} once a pass and each group's first harmonic seeded exactly,
// z^{k0+1} by its own sincospif, and rotated 7 times: the groups'
// independent rotation chains fill the cycles one group's dependent chain
// left idle.  G is 5 on rows past 2048 columns (80 sums in 128 registers,
// four blocks an SM) and 2 on shorter ones, whose few columns a thread
// leave a block's staging, barriers and sums to hide: eight blocks an SM
// hide them better than five groups' shared trig saves.  A span past the block's room streams through
// two chunk buffers, the next chunk in flight by cp.async.  A thread takes
// the same columns in the same order in every layout, and each group's
// operations and block reduction are those of a walk of its own, so the
// sums keep the bits of the one-group kernel this replaced.
#include "common.cuh"

// LLSM_SKIP_PASS_{A,B} = 1 compiles the row kernel's harmonics (no group
// in a pass: the walk, block sums and stores left) or its staging (the
// walk reads whatever shared memory holds) out
// (scripts/port_kernel_passes.py only=project_rows).
#ifndef LLSM_SKIP_PASS_A
#define LLSM_SKIP_PASS_A 0
#endif
#ifndef LLSM_SKIP_PASS_B
#define LLSM_SKIP_PASS_B 0
#endif

namespace {

constexpr int kWarpRows = 4;        // rows per block of the warp kernel
constexpr int kThreads = 128;       // threads per block of the row kernel
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;            // harmonics a group

// The row kernel's blocks an SM at G groups a pass (kernels._project_
// geometry picks 2 or 5): five groups' 80 sums take 128 registers, two
// groups' 32 sums 64
constexpr int row_blocks(int G) { return G >= 5 ? 4 : 8; }

template <int KC>
__global__ void __launch_bounds__(32 * kWarpRows)
proj_warp_kernel(const float* __restrict__ dc, const float* __restrict__ xw,
                 const int* __restrict__ lo, const int* __restrict__ hi,
                 float* __restrict__ re, float* __restrict__ im, long long R,
                 int W, int K) {
  const long long n = (long long)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (n >= R) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const float* dcn = dc + n * W;
  const float* xwn = xw + n * W;
  const int a = max(lo[n], 0), b = min(hi[n], W);
  float sr[KC], si[KC];
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    sr[j] = 0.0f;
    si[j] = 0.0f;
  }
  for (int w = a + lane; w < b; w += 32) {
    const float x = xwn[w];
    float zs, zc;
    sincospif(2.0f * llsm::frac_c(dcn[w]), &zs, &zc);
    float wr = zc, wi = zs;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      sr[j] = fmaf(x, wr, sr[j]);
      si[j] = fmaf(-x, wi, si[j]);
      const float nwr = wr * zc - wi * zs;
      wi = wr * zs + wi * zc;
      wr = nwr;
    }
  }
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    sr[j] = llsm::warp_sum(sr[j]);
    si[j] = llsm::warp_sum(si[j]);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      if (j < K) {
        re[n * K + j] = sr[j];
        im[n * K + j] = si[j];
      }
    }
  }
}

// One column of a pass of at most G groups: z = e^{2 pi j r} once, then
// for each of the pass's ng groups its first harmonic k0 + 1 seeded exactly,
// sincospif(2 kmul_c(k0 + 1, r)), and rotated kChunk - 1 times, the
// slots' sums fmaf'd into sums[2 (q kChunk + j) + {0, 1}] -- per group the
// operations of one group's walk, so its sums are the same.  The rotation
// is spelled out as the one-group kernel's compiled code contracted it:
// w' = (fma(wr, zc, -(wi zs)), fma(wr, zs, wi zc)).
template <int G>
__device__ __forceinline__ void pass_column(float x, float r, int g0, int ng,
                                            float* sums) {
  float zs, zc;
  sincospif(2.0f * r, &zs, &zc);
#pragma unroll
  for (int q = 0; q < G; ++q) {
    if (q < ng) {
      float wr, wi;
      sincospif(2.0f * llsm::kmul_c((float)((g0 + q) * kChunk + 1), r), &wi,
                &wr);
      float* s = sums + 2 * kChunk * q;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[2 * j] = fmaf(x, wr, s[2 * j]);
        s[2 * j + 1] = fmaf(-x, wi, s[2 * j + 1]);
        const float nwr = __fmaf_rn(wr, zc, -__fmul_rn(wi, zs));
        wi = __fmaf_rn(wr, zs, __fmul_rn(wi, zc));
        wr = nwr;
      }
    }
  }
}

// Row n (a block) past K = kChunk: its live columns [a, b), thread t
// columns a + t, a + t + kThreads, ... in order.  Where the span fits the
// block's S staged columns it is staged once (xw and the reduced offset)
// and each pass of G groups walks it; else two buffers of S / 2
// columns (a multiple of kThreads) take it in chunks, chunk q + 1 in
// flight by cp.async while chunk q is walked, once a pass.  Each pass's
// sums are reduced by one block_sums, each value as the one-group walk
// reduced it.
template <int G>
__global__ void __launch_bounds__(kThreads, row_blocks(G))
proj_rows_kernel(const float* __restrict__ dc, const float* __restrict__ xw,
                 const int* __restrict__ lo, const int* __restrict__ hi,
                 float* __restrict__ re, float* __restrict__ im, int W, int K,
                 int S) {
  extern __shared__ float sm[];
  constexpr int kSums = 2 * kChunk * G;
  __shared__ float red[kWarps * kSums];
  const int64_t n = blockIdx.x;
  const float* dcn = dc + n * W;
  const float* xwn = xw + n * W;
  const int a = max(lo[n], 0), b = min(hi[n], W), len = max(b - a, 0);
  const int ngroups = (K + kChunk - 1) / kChunk;
  const bool whole = len <= S;
  if (whole) {
    for (int i = threadIdx.x; !LLSM_SKIP_PASS_B && i < len; i += kThreads) {
      sm[i] = xwn[a + i];
      sm[S + i] = llsm::frac_c(dcn[a + i]);
    }
    __syncthreads();
  }
  const int Qc = S / 2;
  // chunk [c0, c0 + Qc) of the span into buffer buf: xw, then dc
  auto stage = [&](int c0, float* buf) {
    for (int i = threadIdx.x; !LLSM_SKIP_PASS_B && i < min(Qc, len - c0);
         i += kThreads) {
      llsm::cp_async4(buf + i, xwn + a + c0 + i, true);
      llsm::cp_async4(buf + Qc + i, dcn + a + c0 + i, true);
    }
    llsm::cp_async_commit();
  };
  for (int g0 = 0; g0 < ngroups; g0 += G) {
    const int ng = LLSM_SKIP_PASS_A ? 0 : min(G, ngroups - g0);
    float sums[kSums];
#pragma unroll
    for (int j = 0; j < kSums; ++j) sums[j] = 0.0f;
    if (whole) {
      for (int i = threadIdx.x; i < len; i += kThreads)
        pass_column<G>(sm[i], sm[S + i], g0, ng, sums);
    } else {
      stage(0, sm);
      for (int c0 = 0, q = 0; c0 < len; c0 += Qc, ++q) {
        const float* cur = sm + (q & 1) * S;
        if (c0 + Qc < len)
          stage(c0 + Qc, sm + ((q + 1) & 1) * S);
        else
          llsm::cp_async_commit();      // an empty group: one wait for all
        llsm::cp_async_wait<1>();
        __syncthreads();
        for (int i = threadIdx.x; i < min(Qc, len - c0); i += kThreads)
          pass_column<G>(cur[i], llsm::frac_c(cur[Qc + i]), g0, ng, sums);
        __syncthreads();                // chunk q's reads are done
      }
    }
    // a two-group pass with one live group (the last of an odd count, K 24
    // on short rows) reduces that group's sums alone: at ~7 columns a
    // thread the dead group's would cost ~13%; five groups reduce all
    // (fewer spill their 128 registers)
    if (G == 2 && ng == 1)
      llsm::block_sums<2 * kChunk, kWarps>(sums, red);
    else
      llsm::block_sums<kSums, kWarps>(sums, red);
    if (threadIdx.x == 0) {  // static indices keep sums[] in registers
#pragma unroll
      for (int j = 0; j < G * kChunk; ++j) {
        const int k = g0 * kChunk + j;
        if (j < ng * kChunk && k < K) {
          re[n * K + k] = sums[2 * j];
          im[n * K + k] = sums[2 * j + 1];
        }
      }
    }
  }
}

// The row kernel at G groups a pass: its shared-memory opt-in (counting
// the block sums' static bytes too), then the launch
template <int G>
int launch_rows(const float* dc, const float* xw, const int* lo,
                const int* hi, float* re, float* im, long long R, int W,
                int K, int S, cudaStream_t s) {
  const size_t smem = 2 * (size_t)S * sizeof(float);
  cudaError_t e = llsm::allow_smem(
      proj_rows_kernel<G>, smem + kWarps * 2 * kChunk * G * sizeof(float));
  if (e != cudaSuccess) return (int)e;
  proj_rows_kernel<G><<<(unsigned)R, kThreads, smem, s>>>(dc, xw, lo, hi, re,
                                                          im, W, K, S);
  return (int)cudaGetLastError();
}

}  // namespace

// S, G (K > kChunk): the row kernel's staged columns and groups a pass
// (kernels._project_geometry; G 2 or 5): a row whose live span fits is
// staged once, a longer one in chunks of S / 2, which must then be a
// multiple of kThreads
extern "C" int llsm_harmonic_project(const float* dc, const float* xw,
                                     const int* lo, const int* hi, float* re,
                                     float* im, long long R, int W, int K,
                                     int S, int G, void* stream) {
  if (R <= 0 || K <= 0) return (int)cudaGetLastError();
  if (K > kChunk && (S < 1 || (W > S && S % (2 * kThreads)) ||
                     (G != 2 && G != 5)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned wblocks = (unsigned)((R + kWarpRows - 1) / kWarpRows);
  if (K == 1) {
    proj_warp_kernel<1><<<wblocks, 32 * kWarpRows, 0, s>>>(dc, xw, lo, hi,
                                                           re, im, R, W, K);
  } else if (K <= kChunk) {
    proj_warp_kernel<kChunk><<<wblocks, 32 * kWarpRows, 0, s>>>(
        dc, xw, lo, hi, re, im, R, W, K);
  } else if (G == 2) {
    return launch_rows<2>(dc, xw, lo, hi, re, im, R, W, K, S, s);
  } else {
    return launch_rows<5>(dc, xw, lo, hi, re, im, R, W, K, S, s);
  }
  return (int)cudaGetLastError();
}
