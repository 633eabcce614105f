// Frame-axis FIR with zero edges, per utterance, over one or two tensors
// of the same leading [B, N] in one launch:
//   out[b, i, c] = sum_j taps[j] v[b, i + j - h, c],  h = ntaps / 2,
// with v[b, f, c] = 0 for f outside [0, N) of the SAME utterance b.
//
// Replaces libllsm2_tpu/ops/pallas_osc.py: fir_frames_pallas
// (_fir_frames_kernel).  Bound on the H100: memory -- one read and one
// write of v per output against <= 2 ntaps flops (ntaps <= 31 on the
// port's paths); at the main path's [128, 200, 80] the device work is a
// few microseconds, so the launch and its host path are the cost.
// Design: the taps live in a device buffer the wrapper caches per tap
// tuple (no per-launch parameter block beyond the pointers); a pair of
// tensors (the spectral gate's numerator and denominator, the track
// lowpass's voicing column and track) is one launch, its items laid end
// to end.  A thread owns kFrames consecutive frames of one column group
// -- 4 channels as one float4 where C % 4 == 0 and the pointers allow,
// else one channel -- and walks the rows its frames need once, in order,
// adding each row into every frame that row reaches: each input value is
// loaded once, and each output still sums its taps in tap order with
// separate float32 multiply and add (no FMA contraction), exactly the
// plain version's shift-and-add chain.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 256;
constexpr int kFrames = 8;
constexpr int kMaxSegs = 2;

struct Seg {
  const float* in;
  float* out;
  int C;             // floats per frame row
  int vec;           // 4 (float4 groups) or 1
  long long start;   // first item of this segment
};

struct Segs {
  Seg s[kMaxSegs];
  int n;
};

template <typename T>
__device__ __forceinline__ T scaled(float t, T v);

template <>
__device__ __forceinline__ float scaled(float t, float v) {
  return __fmul_rn(t, v);
}

template <>
__device__ __forceinline__ float4 scaled(float t, float4 v) {
  return make_float4(__fmul_rn(t, v.x), __fmul_rn(t, v.y), __fmul_rn(t, v.z),
                     __fmul_rn(t, v.w));
}

__device__ __forceinline__ float added(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ float4 added(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

template <typename T>
__device__ __forceinline__ T zero();

template <>
__device__ __forceinline__ float zero() { return 0.0f; }

template <>
__device__ __forceinline__ float4 zero() { return make_float4(0, 0, 0, 0); }

// The kFrames outputs of frames [i0, i0 + kFrames) of column group g of
// utterance b; G column groups of type T (float or float4) a frame row.
template <typename T>
__device__ __forceinline__ void fir_run(const T* __restrict__ v,
                                        T* __restrict__ out, int b, int N,
                                        int G, int i0, int g,
                                        const float* taps, int ntaps) {
  const int h = ntaps / 2;
  const T* vb = v + (int64_t)b * N * G + g;
  T acc[kFrames];
#pragma unroll
  for (int f = 0; f < kFrames; ++f) acc[f] = zero<T>();
  const int r0 = max(i0 - h, 0);
  const int r1 = min(i0 + kFrames - 1 + h, N - 1);
  for (int r = r0; r <= r1; ++r) {
    const T val = vb[(int64_t)r * G];
    // frame i0 + f takes row r as its tap j = r - i0 - f + h; rows come in
    // increasing order, so each frame's taps arrive in tap order
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      const int j = r - i0 - f + h;
      if (j >= 0 && j < ntaps) acc[f] = added(acc[f], scaled(taps[j], val));
    }
  }
  T* ob = out + (int64_t)b * N * G + g;
#pragma unroll
  for (int f = 0; f < kFrames; ++f)
    if (i0 + f < N) ob[(int64_t)(i0 + f) * G] = acc[f];
}

__global__ void __launch_bounds__(kThreads)
fir_frames_kernel(Segs segs, int B, int N, const float* __restrict__ taps_g,
                  int ntaps, long long total) {
  __shared__ float taps[kMaxTaps];
  for (int j = threadIdx.x; j < ntaps; j += kThreads) taps[j] = taps_g[j];
  __syncthreads();
  const long long item = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (item >= total) return;
  // field by field: a dynamically indexed segment would go to local memory
  const bool two = segs.n > 1 && item >= segs.s[1].start;
  const float* in = two ? segs.s[1].in : segs.s[0].in;
  float* out = two ? segs.s[1].out : segs.s[0].out;
  const int vec = two ? segs.s[1].vec : segs.s[0].vec;
  const int G = (two ? segs.s[1].C : segs.s[0].C) / vec;
  const int tiles = (N + kFrames - 1) / kFrames;
  const long long q = item - (two ? segs.s[1].start : 0);
  const int g = (int)(q % G);
  const long long bt = q / G;            // b * tiles + t
  const int b = (int)(bt / tiles), t = (int)(bt - (long long)b * tiles);
  if (vec == 4)
    fir_run(reinterpret_cast<const float4*>(in),
            reinterpret_cast<float4*>(out), b, N, G, t * kFrames, g, taps,
            ntaps);
  else
    fir_run(in, out, b, N, G, t * kFrames, g, taps, ntaps);
}

Seg make_seg(const float* in, float* out, int C, long long start) {
  const bool v4 = C % 4 == 0 && (uintptr_t)in % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  return Seg{in, out, C, v4 ? 4 : 1, start};
}

}  // namespace

// in1/out1 may be null (one tensor); taps is a device pointer.
extern "C" int llsm_fir_frames(const float* in0, float* out0, int C0,
                               const float* in1, float* out1, int C1, int B,
                               int N, const float* taps, int ntaps,
                               void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps) return (int)cudaErrorInvalidValue;
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  const long long tiles = (N + kFrames - 1) / kFrames;
  Segs segs{};
  segs.s[0] = make_seg(in0, out0, C0, 0);
  long long total = B * tiles * (C0 / segs.s[0].vec);
  segs.n = 1;
  if (in1 != nullptr) {
    segs.s[1] = make_seg(in1, out1, C1, total);
    total += B * tiles * (C1 / segs.s[1].vec);
    segs.n = 2;
  }
  if (total <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  fir_frames_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      segs, B, N, taps, ntaps, total);
  return (int)cudaGetLastError();
}
