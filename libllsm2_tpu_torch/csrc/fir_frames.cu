// Frame-axis FIR with zero edges, per utterance:
//   out[b, i, c] = sum_j taps[j] v[b, i + j - h, c],  h = ntaps / 2,
// with v[b, f, c] = 0 for f outside [0, N) of the SAME utterance b.
//
// Replaces libllsm2_tpu/ops/pallas_osc.py: fir_frames_pallas
// (_fir_frames_kernel).  Bound on the H100: memory -- one read and one
// write of v per output against <= 2 ntaps flops (ntaps <= 31 on the
// port's paths).  Design: one thread per output element (b, i, c), the
// channel axis fastest, so a warp reads 32 neighbouring floats of one
// frame row for each tap (coalesced; the ntaps rows a thread needs are
// shared with its neighbours through L1/L2).  The taps travel by value in
// the kernel's parameter block.  The sum runs in tap order with separate
// float32 multiply and add (no FMA contraction), which is exactly the
// plain version's shift-and-add chain.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 256;

struct FirTaps {
  float t[kMaxTaps];
  int n;
};

__global__ void __launch_bounds__(kThreads)
fir_frames_kernel(const float* __restrict__ v, float* __restrict__ out,
                  int B, int N, int C, FirTaps taps) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t total = (int64_t)B * N * C;
  if (g >= total) return;
  const int64_t row = g / C;               // b * N + i
  const int c = (int)(g - row * C);
  const int b = (int)(row / N), i = (int)(row - (int64_t)b * N);
  const int h = taps.n / 2;
  const float* vb = v + (int64_t)b * N * C + c;
  float acc = 0.0f;
  for (int j = 0; j < taps.n; ++j) {
    const int f = i + j - h;
    if (f >= 0 && f < N)
      acc = __fadd_rn(acc, __fmul_rn(taps.t[j], vb[(int64_t)f * C]));
  }
  out[g] = acc;
}

}  // namespace

extern "C" int llsm_fir_frames(const float* v, float* out, int B, int N,
                               int C, const float* taps, int ntaps,
                               void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)B * N * C;
  if (total <= 0) return (int)cudaGetLastError();
  FirTaps t{};
  for (int j = 0; j < ntaps; ++j) t.t[j] = taps[j];
  t.n = ntaps;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  fir_frames_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      v, out, B, N, C, t);
  return (int)cudaGetLastError();
}
