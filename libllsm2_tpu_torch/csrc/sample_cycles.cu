// Fundamental phase in cycles mod 1 at every sample of each utterance, from
// its F0 track at the frame centres (harmonics.sample_cycles):
//   f0s      = max(f0, 0) (unvoiced frames contribute nothing)
//   d[s]     = lerp(f0s[i0], f0s[i0 + 1], t) / fs,  pos = s / nhop,
//              i0 = clamp(floor(pos), 0, N - 2), t = clamp(pos - i0, 0, 1)
//   within_j = the running sum of d over hop j's nhop samples, each partial
//              rounded to float32
//   off_j    = (sum over hops j' < j of (within_j' total mod 1)) mod 1, the
//              prefix sum taken in float64
//   c[s]     = (off_j + within_j[s]) mod 1;  out[0] = 0, out[s] = c[s - 1]
//
// The JAX package has no Pallas kernel here (libllsm2_tpu/ops/harmonics.py:
// sample_cycles, a mod-1 associative scan under XLA).  The port's plain
// version takes two torch.cumsum calls, and PyTorch's CUDA scan orders a
// row's sum by the tensor's shape, so a row's track depended on the other
// rows of its batch.  Here every sum has an order set by the row alone, in
// three launches: a thread a hop sums its nhop samples sequentially in
// float64, rounding each partial to float32, as PyTorch's CPU cumsum does
// for float32 (the hop totals, mod 1, as float64), so the kernel equals the
// plain version run on the CPU; a block a row takes the float64 exclusive
// prefix of its totals by a two-level scan whose tree depends only on the
// hop count (each thread a contiguous run of hops, one thread over the
// runs' sums); a thread a hop again sums its samples and adds its offset,
// staged in shared memory so that the block writes its samples coalesced.
// The lerp's products and sum are rounded separately (__fmul_rn /
// __fadd_rn), as the plain version rounds them, so no FMA contraction moves
// them.  Bound on the H100: the [B, nx] output written once; the two
// sequential passes over each hop's samples are spread over B x N / 128
// blocks.
#include "common.cuh"

namespace {

constexpr int kHopsBlock = 128;     // hops a block (a thread each)
constexpr int kScan = 512;          // threads of the prefix scan

// F0 at sample s of row f0r (clamped at 0), divided by fs: the twin's
// float32 operations.
__device__ __forceinline__ float f0_over_fs(const float* __restrict__ f0r,
                                            int s, float nhop_f, int N,
                                            float fs) {
  const float pos = __fdiv_rn((float)s, nhop_f);
  const int i0 = min(max((int)floorf(pos), 0), N - 2);
  const float t = fminf(fmaxf(__fadd_rn(pos, -(float)i0), 0.0f), 1.0f);
  const float a = fmaxf(__ldg(f0r + i0), 0.0f);
  const float b = fmaxf(__ldg(f0r + i0 + 1), 0.0f);
  const float v = __fadd_rn(__fmul_rn(a, __fadd_rn(1.0f, -t)),
                            __fmul_rn(b, t));
  return __fdiv_rn(v, fs);
}

// hop j's total mod 1: tot[b, j]
__global__ void __launch_bounds__(kHopsBlock)
hop_totals_kernel(const float* __restrict__ f0, double* __restrict__ tot,
                  int N, int nhop, int H, float fs) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * kHopsBlock + threadIdx.x;
  if (j >= H) return;
  const float* f0r = f0 + (int64_t)b * N;
  const float nhop_f = (float)nhop;
  double acc = 0.0;
  for (int t = 0; t < nhop; ++t)
    acc += (double)f0_over_fs(f0r, j * nhop + t, nhop_f, N, fs);
  const float w = __double2float_rn(acc);
  tot[(int64_t)b * H + j] = (double)(w - floorf(w));
}

// tot[b, :] <- its exclusive prefix sum, mod 1 (float64, fixed order)
__global__ void __launch_bounds__(kScan)
hop_offsets_kernel(double* __restrict__ tot, int H) {
  __shared__ double part[kScan];
  double* r = tot + (int64_t)blockIdx.x * H;
  const int per = (H + kScan - 1) / kScan;
  const int j0 = min((int)threadIdx.x * per, H), j1 = min(j0 + per, H);
  double s = 0.0;
  for (int j = j0; j < j1; ++j) s += r[j];
  part[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double run = 0.0;
    for (int i = 0; i < kScan; ++i) {
      const double v = part[i];
      part[i] = run;
      run += v;
    }
  }
  __syncthreads();
  double run = part[threadIdx.x];
  for (int j = j0; j < j1; ++j) {
    const double v = r[j];
    r[j] = run - floor(run);
    run += v;
  }
}

// the samples of a block of hops: out[s + 1] = (off_j + within_j[s]) mod 1
__global__ void __launch_bounds__(kHopsBlock)
cycles_kernel(const float* __restrict__ f0, const double* __restrict__ off,
              float* __restrict__ out, int N, int nhop, int H, float fs) {
  extern __shared__ float stage[];          // [kHopsBlock, nhop | 1]
  const int b = blockIdx.y;
  const int jb = blockIdx.x * kHopsBlock;
  const int j = jb + threadIdx.x;
  const float* f0r = f0 + (int64_t)b * N;
  const int64_t nx = (int64_t)H * nhop;
  float* outr = out + (int64_t)b * nx;
  if (j < H) {
    const float nhop_f = (float)nhop;
    const float o = (float)off[(int64_t)b * H + j];
    // an odd row stride: the threads of a warp hit different banks
    float* st = stage + threadIdx.x * (nhop | 1);
    double acc = 0.0;
    for (int t = 0; t < nhop; ++t) {
      acc += (double)f0_over_fs(f0r, j * nhop + t, nhop_f, N, fs);
      const float c = __fadd_rn(o, __double2float_rn(acc));
      st[t] = c - floorf(c);
    }
  }
  __syncthreads();
  const int nh = min(kHopsBlock, H - jb);
  const int64_t s0 = (int64_t)jb * nhop;
  for (int e = threadIdx.x; e < nh * nhop; e += kHopsBlock) {
    const int h = e / nhop;
    if (s0 + e + 1 < nx)
      outr[s0 + e + 1] = stage[h * (nhop | 1) + e - h * nhop];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) outr[0] = 0.0f;
}

}  // namespace

extern "C" int llsm_sample_cycles(const float* f0, float* out, double* hop,
                                  int B, int N, int nhop, int nx, float fs,
                                  void* stream) {
  if (B <= 0 || nx <= 0) return (int)cudaGetLastError();
  if (N < 2 || nhop <= 0 || nx % nhop) return (int)cudaErrorInvalidValue;
  const int H = nx / nhop;
  const size_t smem = (size_t)kHopsBlock * (nhop | 1) * sizeof(float);
  cudaError_t e = llsm::allow_smem(cycles_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((H + kHopsBlock - 1) / kHopsBlock, B);
  hop_totals_kernel<<<grid, kHopsBlock, 0, st>>>(f0, hop, N, nhop, H, fs);
  hop_offsets_kernel<<<B, kScan, 0, st>>>(hop, H);
  cycles_kernel<<<grid, kHopsBlock, smem, st>>>(f0, hop, out, N, nhop, H,
                                                fs);
  return (int)cudaGetLastError();
}
