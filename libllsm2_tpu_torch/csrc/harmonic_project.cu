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
// K > 8 runs one block per row with the structure of
// harmonic_project_win.cu: stage xw and the reduced offset of the live
// columns in shared memory, then per chunk of 8 harmonics seed z^{k0+1}
// exactly and rotate 8 times; one block reduction per chunk.  Past a
// row's 2 W floats of shared memory (kernels._project_geometry: W = 2C past
// ~14500 samples, 96 kHz at a 200 ms hop) proj_row_chunk_kernel stages the
// live columns in chunks of Q (a multiple of the block) in turn, each
// thread's sums carried across them: a thread takes the same columns in
// the same order, so the sums keep proj_row_kernel's bits.
#include "common.cuh"

namespace {

constexpr int kWarpRows = 4;        // rows per block of the warp kernel
constexpr int kThreads = 128;       // threads per block of the row kernel
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;

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

__global__ void __launch_bounds__(kThreads)
proj_row_kernel(const float* __restrict__ dc, const float* __restrict__ xw,
                const int* __restrict__ lo, const int* __restrict__ hi,
                float* __restrict__ re, float* __restrict__ im, int W,
                int K) {
  extern __shared__ float sm[];
  float* xw_s = sm;        // [W] xw over the live columns
  float* r_s = sm + W;     // [W] reduced cycle offsets
  __shared__ float red[kWarps * 2 * kChunk];
  const int64_t n = blockIdx.x;
  const float* dcn = dc + n * W;
  const float* xwn = xw + n * W;
  const int a = max(lo[n], 0), b = min(hi[n], W), len = max(b - a, 0);
  for (int i = threadIdx.x; i < len; i += kThreads) {
    xw_s[i] = xwn[a + i];
    r_s[i] = llsm::frac_c(dcn[a + i]);
  }
  __syncthreads();

  float sums[2 * kChunk];
  for (int k0 = 0; k0 < K; k0 += kChunk) {
#pragma unroll
    for (int j = 0; j < 2 * kChunk; ++j) sums[j] = 0.0f;
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const float r = r_s[i], x = xw_s[i];
      float zs, zc, wr, wi;
      sincospif(2.0f * r, &zs, &zc);
      sincospif(2.0f * llsm::kmul_c((float)(k0 + 1), r), &wi, &wr);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        sums[2 * j] = fmaf(x, wr, sums[2 * j]);
        sums[2 * j + 1] = fmaf(-x, wi, sums[2 * j + 1]);
        const float nwr = wr * zc - wi * zs;
        wi = wr * zs + wi * zc;
        wr = nwr;
      }
    }
    llsm::block_sums<2 * kChunk, kWarps>(sums, red);
    if (threadIdx.x == 0) {  // static indices keep sums[] in registers
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int k = k0 + j;
        if (k < K) {
          re[n * K + k] = sums[2 * j];
          im[n * K + k] = sums[2 * j + 1];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
proj_row_chunk_kernel(const float* __restrict__ dc,
                      const float* __restrict__ xw,
                      const int* __restrict__ lo, const int* __restrict__ hi,
                      float* __restrict__ re, float* __restrict__ im, int W,
                      int K, int Q) {
  extern __shared__ float sm[];
  float* xw_s = sm;        // [Q] xw over a chunk of the live columns
  float* r_s = sm + Q;     // [Q] their reduced cycle offsets
  __shared__ float red[kWarps * 2 * kChunk];
  const int64_t n = blockIdx.x;
  const float* dcn = dc + n * W;
  const float* xwn = xw + n * W;
  const int a = max(lo[n], 0), b = min(hi[n], W), len = max(b - a, 0);
  float sums[2 * kChunk];
  for (int k0 = 0; k0 < K; k0 += kChunk) {
#pragma unroll
    for (int j = 0; j < 2 * kChunk; ++j) sums[j] = 0.0f;
    for (int c0 = 0; c0 < len; c0 += Q) {
      const int m = min(Q, len - c0);
      __syncthreads();                  // the last chunk's reads are done
      for (int i = threadIdx.x; i < m; i += kThreads) {
        xw_s[i] = xwn[a + c0 + i];
        r_s[i] = llsm::frac_c(dcn[a + c0 + i]);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < m; i += kThreads) {
        const float r = r_s[i], x = xw_s[i];
        float zs, zc, wr, wi;
        sincospif(2.0f * r, &zs, &zc);
        sincospif(2.0f * llsm::kmul_c((float)(k0 + 1), r), &wi, &wr);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          sums[2 * j] = fmaf(x, wr, sums[2 * j]);
          sums[2 * j + 1] = fmaf(-x, wi, sums[2 * j + 1]);
          const float nwr = wr * zc - wi * zs;
          wi = wr * zs + wi * zc;
          wr = nwr;
        }
      }
    }
    llsm::block_sums<2 * kChunk, kWarps>(sums, red);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int k = k0 + j;
        if (k < K) {
          re[n * K + k] = sums[2 * j];
          im[n * K + k] = sums[2 * j + 1];
        }
      }
    }
  }
}

}  // namespace

// Q: 0 stages a row's live columns whole (proj_row_kernel), else in chunks
// of Q columns (kernels._project_geometry; a multiple of kThreads)
extern "C" int llsm_harmonic_project(const float* dc, const float* xw,
                                     const int* lo, const int* hi, float* re,
                                     float* im, long long R, int W, int K,
                                     int Q, void* stream) {
  if (R <= 0 || K <= 0) return (int)cudaGetLastError();
  if (Q < 0 || Q % kThreads) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned wblocks = (unsigned)((R + kWarpRows - 1) / kWarpRows);
  if (K == 1) {
    proj_warp_kernel<1><<<wblocks, 32 * kWarpRows, 0, s>>>(dc, xw, lo, hi,
                                                           re, im, R, W, K);
  } else if (K <= kChunk) {
    proj_warp_kernel<kChunk><<<wblocks, 32 * kWarpRows, 0, s>>>(
        dc, xw, lo, hi, re, im, R, W, K);
  } else if (Q > 0) {
    const size_t smem = 2 * (size_t)Q * sizeof(float);
    cudaError_t e = llsm::allow_smem(proj_row_chunk_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    proj_row_chunk_kernel<<<(unsigned)R, kThreads, smem, s>>>(
        dc, xw, lo, hi, re, im, W, K, Q);
  } else {
    const size_t smem = 2 * (size_t)W * sizeof(float);
    cudaError_t e = llsm::allow_smem(proj_row_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    proj_row_kernel<<<(unsigned)R, kThreads, smem, s>>>(dc, xw, lo, hi, re,
                                                        im, W, K);
  }
  return (int)cudaGetLastError();
}
