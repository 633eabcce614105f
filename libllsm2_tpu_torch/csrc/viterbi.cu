// The most likely state path of each row of per-frame log scores obs [B, N,
// S] under log transitions lt [S, S] (from row i, to column j):
//   score_0[j] = obs[0, j]
//   score_t[j] = max_i (score_{t-1}[i] + lt[i, j]) + obs[t, j]
//   bp_t[j]    = the first i that reaches that maximum
//   path[N-1]  = the first argmax of score_{N-1}, path[t] = bp_{t+1}[path[t+1]]
// With renorm every score_t (score_0 too) has its maximum subtracted, as the
// F0 tracker does; without, as layer 1's Rd path does.
//
// The JAX package has no Pallas kernel here: both Viterbis are a lax.scan
// forward and a reverse lax.scan backtrace that XLA compiles into device
// loops (libllsm2_tpu/ops/f0.py:203-222, the tracker, S = nbins + 1 = 97;
// libllsm2_tpu/models/layer1.py:161-172, the Rd grid, S = 64).  This kernel
// is both scans, backtrace included, in one launch.
//
// Exactness: each step takes the same float32 operations in the same order
// as the plain loop (kernels.viterbi_scan_ref): the candidates score + lt
// and the maximum + obs are single rounded adds (__fadd_rn keeps them out
// of any contraction), the inner maximum runs over i in ascending order
// with a strict > (ties to the first maximum, as torch.max(dim) and
// jnp.argmax break them), and the row maximum of the renormalisation is a
// block reduction, whose order cannot change a maximum.  So the scores and
// the path are the plain version's bit for bit.
//
// Bound on the H100: B (N - 1) S^2 adds and compares, ~0.03 ms of the
// card's float32 rate at 64 x 1600 x 97; the bytes (obs read once, the
// uint8 backpointers) less.  Neither is what limits it: a row is a chain
// of N - 1 dependent steps, each an S-long dependent compare chain, a
// barrier and (renorm) a block reduction, then N - 1 dependent loads of the
// backtrace.  Design, simple first: a block a row, a thread a destination
// state j (S <= 256, so a backpointer is a byte); the two score buffers, lt
// (where S^2 floats fit) and the backpointers (where (N - 1) S bytes fit
// beside them: 155 KB at N = 1600, S = 97) in shared memory, else lt and
// the backpointers in device memory; obs prefetched two steps ahead into
// registers; after the last step thread 0 walks the backpointers and writes
// the path.  No host synchronisation: the wrapper allocates, launches once
// and returns.
#include "common.cuh"

namespace {

constexpr int kMaxStates = 256;
constexpr int kMaxWarps = kMaxStates / 32;

// Maximum of v over the block, returned to every thread.  `red` holds
// kMaxWarps floats; the barrier inside orders it, and a caller must pass a
// barrier before `red` is written again.
__device__ __forceinline__ float block_max(float v, float* red, int nwarps) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < nwarps; ++w) m = fmaxf(m, red[w]);
  return m;
}

// LT_SMEM, BP_SMEM: lt and the backpointers in shared memory (else device
// memory).  Dynamic shared memory: the two score rows and the reduction
// words, then lt [S * S] if LT_SMEM, then the backpointers [(N - 1) * S]
// bytes if BP_SMEM.
template <bool LT_SMEM, bool BP_SMEM>
__global__ void __launch_bounds__(kMaxStates) viterbi_kernel(
    const float* __restrict__ obs, const float* __restrict__ lt_g,
    long long* __restrict__ path, float* __restrict__ final_score,
    unsigned char* bp_g, int N, int S, int renorm) {
  extern __shared__ __align__(16) float smem[];
  float* s = smem;                              // [2][S]
  float* red = s + 2 * S;                       // [kMaxWarps]
  float* lt_s = red + kMaxWarps;                // [S * S] if LT_SMEM
  unsigned char* bp_s =
      reinterpret_cast<unsigned char*>(lt_s + (LT_SMEM ? S * S : 0));

  const int j = threadIdx.x, b = blockIdx.x;
  const int nwarps = blockDim.x >> 5;
  const bool live = j < S;
  const float* o = obs + (long long)b * N * S;
  unsigned char* bp = BP_SMEM ? bp_s : bp_g + (long long)b * (N - 1) * S;
  if (LT_SMEM)
    for (int k = threadIdx.x; k < S * S; k += blockDim.x) lt_s[k] = lt_g[k];
  const float* L = LT_SMEM ? lt_s : lt_g;

  float v = live ? o[j] : -INFINITY;
  if (renorm) v = __fsub_rn(v, block_max(v, red, nwarps));
  if (live) s[j] = v;
  // the next two steps' observations, in flight while a step runs
  float o1 = (live && N > 1) ? o[S + j] : 0.0f;
  float o2 = (live && N > 2) ? o[2 * S + j] : 0.0f;
  __syncthreads();

  for (int t = 1; t < N; ++t) {
    const float* sp = s + ((t - 1) & 1) * S;
    const float ob = o1;
    o1 = o2;
    if (live && t + 2 < N) o2 = o[(long long)(t + 2) * S + j];
    v = -INFINITY;
    if (live) {
      float best = __fadd_rn(sp[0], L[j]);
      int arg = 0;
#pragma unroll 4
      for (int i = 1; i < S; ++i) {
        const float c = __fadd_rn(sp[i], L[i * S + j]);
        if (c > best) {
          best = c;
          arg = i;
        }
      }
      bp[(long long)(t - 1) * S + j] = (unsigned char)arg;
      v = __fadd_rn(best, ob);
    }
    if (renorm) v = __fsub_rn(v, block_max(v, red, nwarps));
    if (live) s[(t & 1) * S + j] = v;
    __syncthreads();
  }

  // the last scores out; the backtrace (the barrier above made every
  // backpointer of the block visible, in shared or device memory)
  const float* sf = s + ((N - 1) & 1) * S;
  if (live) final_score[(long long)b * S + j] = sf[j];
  if (threadIdx.x == 0) {
    int g = 0;
    float m = sf[0];
    for (int i = 1; i < S; ++i)
      if (sf[i] > m) {
        m = sf[i];
        g = i;
      }
    long long* p = path + (long long)b * N;
    p[N - 1] = g;
    for (int t = N - 2; t >= 0; --t) {
      g = bp[(long long)t * S + g];
      p[t] = g;
    }
  }
}

using Kernel = void (*)(const float*, const float*, long long*, float*,
                        unsigned char*, int, int, int);

Kernel pick(int lt_smem, int bp_smem) {
  if (lt_smem)
    return bp_smem ? viterbi_kernel<true, true> : viterbi_kernel<true, false>;
  return bp_smem ? viterbi_kernel<false, true> : viterbi_kernel<false, false>;
}

}  // namespace

// obs [B, N, S], lt [S, S], path [B, N] int64, final_score [B, S], bp (a
// [B, N - 1, S] uint8 scratch where bp_smem is 0, else null); lt_smem,
// bp_smem as kernels._viterbi_geometry chose them
extern "C" int llsm_viterbi_scan(const float* obs, const float* lt,
                                 long long* path, float* final_score,
                                 unsigned char* bp, int B, int N, int S,
                                 int renorm, int lt_smem, int bp_smem,
                                 void* stream) {
  if (N < 1 || S < 1 || S > kMaxStates || (!bp_smem && N > 1 && !bp))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  const size_t smem =
      (size_t)(2 * S + kMaxWarps) * sizeof(float) +
      (lt_smem ? (size_t)S * S * sizeof(float) : 0) +
      (bp_smem ? (size_t)(N - 1) * S : 0);
  const Kernel k = pick(lt_smem, bp_smem);
  cudaError_t e = llsm::allow_smem(k, smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = (S + 31) / 32 * 32;
  k<<<B, threads, smem, (cudaStream_t)stream>>>(obs, lt, path, final_score,
                                                bp, N, S, renorm);
  return (int)cudaGetLastError();
}
