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
// Exactness: the candidates score + lt and the maximum + obs are single
// rounded adds (__fadd_rn keeps them out of any contraction), and the
// renormalised score is score - max, one rounded subtract, as in the plain
// loop (kernels.viterbi_scan_ref).  Each destination's maximum is taken
// over a partition of the i range (lanes, and partials inside a lane), the
// pieces merged by the order (value, then lowest i): take b when vb > va,
// or vb == va and ib < ia.  For values that are not NaN that is the maximum
// of a total order, so every partition gives the strict-> ascending loop's
// best and arg, the first maximum that torch.max(dim) and jnp.argmax
// return: the scores and the path are the plain version's bit for bit.
// -inf entries and exact ties are inside this contract; NaN is not (the
// loop's c > best and torch.max treat a NaN differently), nor a renormalised
// step whose scores are all -inf (its max - max is NaN in both).
//
// Bound on the H100: B (N - 1) S^2 adds and compares, ~0.03 ms of the
// card's float32 rate at 64 x 1600 x 97; the bytes (obs read once, the
// uint8 backpointers) less.  Neither is what limits it: a row is a chain of
// N - 1 dependent steps on one SM, then N - 1 dependent backtrace loads, so
// a step's latency and the SM's issue rate (S^2 candidates of ~5
// instructions a step, three of them on the half-rate ALU pipe) set it.
// Design: a block a row; P lanes (consecutive threads of one warp) a
// destination state j, S <= 256 (so a backpointer is a byte) and P S <=
// 1024 threads; P = 2 (4 past S = 128), the fastest of 1-16 at both of
// the paths' shapes (kernels._viterbi_geometry).  Lane p of j covers the
// source states i = 4 (m P + p) + e, m < C / 4, e < 4 (P C >= S; the
// score rows are padded to P C with -inf), so the P lanes of a group read
// P neighbouring float4s of the previous scores a step.  Each e is its own
// partial maximum (four independent compare chains of C / 4), merged,
// then the P lanes merge by __shfl_xor_sync.  lt's column slice (C floats
// a lane) stays in registers for the whole launch (C <= 64); else (S >
// 128) lt is read from shared memory where S^2 floats fit, or from device
// memory.  One barrier a step: each step writes its raw scores into
// s[t & 1] and, with renorm, each warp's maximum (a redux.sync of
// order-preserving int keys) into red[t & 1]; after the barrier every warp
// takes the row maximum m from red (one more redux.sync) and reads
// (score_i - m) + lt_ij, the plain loop's two roundings.  Each state's
// observations come into a shared ring by cp.async kAhead steps early.
// The uint8 backpointers stay in shared memory where (N - 1) S bytes fit
// (155 KB at 1600 x 97), else in device memory; after the last barrier
// warp 0 takes the final argmax and thread 0 walks the backpointers.  No
// host synchronisation: the wrapper allocates, launches once and returns.
//
// Past S = 256 (a tracker with nbins >= 256) a state no longer fits a lane
// group of the block nor a backpointer a byte: viterbi_wide_kernel (lt mode
// 3) takes one lane a state, min(1024, S rounded up to 32) threads, each
// thread the destinations j = tid + r threads; a destination covers every
// source state in the four partial maxima i = 4 m + e of the kernel above
// at P = 1 (so the same order model holds), lt read from device memory
// (S^2 floats, 4.2 MB at S = 1025, stay in L2), the observations read a
// step at a time, the backpointers uint16.  Its limit is shared memory:
// the two score rows, 8 C bytes (C = S rounded up to 4), and the warps'
// maxima fit up to S = 29024 (kernels._VITERBI_MAX_STATES).  It is written
// to be right, not fast: S^2 candidates a step on one SM.
#include "common.cuh"

namespace {

constexpr int kMaxStates = 256;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// the observations' ring in shared memory: kRing rows, each step's row
// copied in kAhead steps before it is read (loads two steps ahead into
// registers left the Rd shape's full batch waiting on device memory, a
// step being shorter than a loaded HBM round trip)
constexpr int kRing = 16;
constexpr int kAhead = 8;

// LLSM_SKIP_PASS_B = 1 compiles the backtrace's walk out (the final argmax
// stays), for scripts/port_kernel_passes.py's split
#ifndef LLSM_SKIP_PASS_B
#define LLSM_SKIP_PASS_B 0
#endif

// threads a block of C source states a lane can have: lt's column slice in
// registers (LT 0) takes C of them a thread
constexpr int max_threads(int C, int LT) {
  return LT == 0 && C > 16 ? 16384 / C : kMaxThreads;
}

// 4-byte asynchronous copy global -> shared (cp.async), one commit group a
// step
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// (v, i) <- the larger of (v, i) and (vb, ib) by (value, then lowest index)
__device__ __forceinline__ void take_max(float& v, int& i, float vb, int ib) {
  if (vb > v || (vb == v && ib < i)) {
    v = vb;
    i = ib;
  }
}

// A float as an int of the same order (for values that are not NaN; -0
// below +0), and back: maxima of keys are one redux.sync a warp.
__device__ __forceinline__ int fkey(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float fval(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// Maximum over the warp of v where `take`, as a key (-inf's elsewhere).
__device__ __forceinline__ int warp_max_key(float v, bool take) {
  return __reduce_max_sync(kFull, fkey(take ? v : -INFINITY));
}

// Row maximum from the warps' maxima, keys red[0, kMaxWarps) (the unused
// slots hold -inf's): lane l reads slot l, one redux.sync merges them.
__device__ __forceinline__ float row_max(const int* red, int lane) {
  return fval(__reduce_max_sync(kFull, red[lane]));
}

// (v, k) <- (c, kc) where c > v: the update of a partial maximum, written
// as a compare and two predicated moves (ptxas schedules this form of the
// unrolled chains better than the same test written in C++: faster at
// layer 1's Rd shape on the H100, the same at the tracker's)
__device__ __forceinline__ void take_gt(float& v, int& k, float c, int kc) {
  asm("{\n\t.reg .pred p;\n\tsetp.gt.f32 p, %2, %0;\n\t"
      "@p mov.f32 %0, %2;\n\t@p mov.b32 %1, %3;\n\t}"
      : "+f"(v), "+r"(k)
      : "f"(c), "r"(kc));
}

// C: source states a lane (a multiple of 4); LT: 0 lt's column slice in
// registers, 1 lt in shared memory, 2 in device memory; BP_SMEM: the
// backpointers in shared memory (else device memory).  Dynamic shared
// memory: the two score rows [2][P C], the warps' maxima [2][kMaxWarps],
// the observations' ring [kRing][S], then lt [S * S] if LT == 1, then the
// backpointers [(N - 1) * S] bytes if BP_SMEM.  P, the 2 or 4 that
// kernels._viterbi_geometry takes from S, is a runtime argument.
template <int C, int LT, bool BP_SMEM, bool RENORM>
__global__ void __launch_bounds__(max_threads(C, LT))
    viterbi_kernel(const float* __restrict__ obs,
                   const float* __restrict__ lt_g, long long* __restrict__ path,
                   float* __restrict__ final_score, unsigned char* bp_g, int N,
                   int S, int P, int log2P) {
  extern __shared__ __align__(16) float smem[];
  const int SP = P * C;
  float* s = smem;                               // [2][SP]
  int* red = reinterpret_cast<int*>(s + 2 * SP);  // [2][kMaxWarps] keys
  float* ring = s + 2 * SP + 2 * kMaxWarps;      // [kRing][S]
  float* lt_s = ring + kRing * S;                // [S * S] if LT == 1
  unsigned char* bp_s =
      reinterpret_cast<unsigned char*>(lt_s + (LT == 1 ? S * S : 0));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = tid >> log2P, p = tid & (P - 1);
  const bool live = j < S, writer = live && p == 0;
  const int b = blockIdx.x;
  const float* o = obs + (long long)b * N * S;
  unsigned char* bp = BP_SMEM ? bp_s : bp_g + (long long)b * (N - 1) * S;

  for (int k = tid; k < 2 * SP; k += blockDim.x) s[k] = -INFINITY;
  for (int k = tid; k < 2 * kMaxWarps; k += blockDim.x)
    red[k] = fkey(-INFINITY);
  if (LT == 1)
    for (int k = tid; k < S * S; k += blockDim.x) lt_s[k] = lt_g[k];
  const float* L = LT == 1 ? lt_s : lt_g;
  // lane p's source state of slot k = 4 m + e
  auto src = [&](int k) { return 4 * ((k >> 2) * P + p) + (k & 3); };
  float lr[LT == 0 ? C : 1];
  if constexpr (LT == 0) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int i = src(k);
      lr[k] = (live && i < S) ? lt_g[i * S + j] : 0.0f;
    }
  }
  __syncthreads();

  float v = live ? o[j] : -INFINITY;
  if (writer) s[j] = v;
  if (RENORM) {
    const int key = warp_max_key(v, writer);
    if (lane == 0) red[warp] = key;
  }
  // each writer lane copies its state's observations of steps 1..kAhead
  // into the ring, then one step's a step, kAhead steps ahead: a step reads
  // its own row of the ring, so no load waits on device memory (only
  // lanes with p == 0 use obs: the warps' maxima merge lanes of one p)
  for (int t = 1; t <= kAhead; ++t) {
    if (writer && t < N) cp_async4(ring + t * S + j, o + (long long)t * S + j);
    cp_async_commit();
  }
  __syncthreads();

  for (int t = 1; t < N; ++t) {
    const int cur = (t - 1) & 1, nxt = t & 1;
    const float4* sp4 = reinterpret_cast<const float4*>(s + cur * SP);
    const float m = RENORM ? row_max(red + cur * kMaxWarps, lane) : 0.0f;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1));
    const float ob = writer ? ring[(t % kRing) * S + j] : 0.0f;
    // step t + kAhead's row; its slot was last read kAhead steps ago
    const int ta = t + kAhead;
    if (writer && ta < N)
      cp_async4(ring + (ta % kRing) * S + j, o + (long long)ta * S + j);
    cp_async_commit();

    // four partial maxima, one an element of the float4s; slot index k
    float bv[4];
    int bk[4];
#pragma unroll
    for (int mm = 0; mm < C / 4; ++mm) {
      const float4 q = sp4[mm * P + p];
      const float qs[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * mm + e;
        const float sc = RENORM ? __fsub_rn(qs[e], m) : qs[e];
        float l;
        if constexpr (LT == 0) {
          l = lr[k];
        } else {
          const int i = src(k);
          l = (live && i < S) ? L[i * S + j] : 0.0f;
        }
        const float c = __fadd_rn(sc, l);
        if (mm == 0) {
          bv[e] = c;
          bk[e] = k;
        } else {
          take_gt(bv[e], bk[e], c, k);
        }
      }
    }
    int bi[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) bi[e] = src(bk[e]);
    take_max(bv[0], bi[0], bv[1], bi[1]);
    take_max(bv[2], bi[2], bv[3], bi[3]);
    take_max(bv[0], bi[0], bv[2], bi[2]);
    float best = bv[0];
    int arg = bi[0];
    for (int off = 1; off < P; off <<= 1) {
      const float vb = __shfl_xor_sync(kFull, best, off);
      const int ib = __shfl_xor_sync(kFull, arg, off);
      take_max(best, arg, vb, ib);
    }

    v = live ? __fadd_rn(best, ob) : -INFINITY;
    if (writer) {
      s[nxt * SP + j] = v;
      bp[(long long)(t - 1) * S + j] = (unsigned char)arg;
    }
    if (RENORM) {
      const int key = warp_max_key(v, writer);
      if (lane == 0) red[nxt * kMaxWarps + warp] = key;
    }
    __syncthreads();
  }

  // the last scores out, renormalised; the final argmax by warp 0 (each
  // lane its states in ascending order, then the lanes merged); the
  // backtrace by thread 0 (the barrier above made every backpointer of the
  // block visible, in shared or device memory)
  const int last = (N - 1) & 1;
  const float* sf = s + last * SP;
  const float mf = RENORM ? row_max(red + last * kMaxWarps, lane) : 0.0f;
  if (writer)
    final_score[(long long)b * S + j] = RENORM ? __fsub_rn(sf[j], mf) : sf[j];
  if (warp == 0) {
    float bv = -INFINITY;
    int g = 1 << 30;
    for (int k = lane; k < S; k += 32) {
      const float f = RENORM ? __fsub_rn(sf[k], mf) : sf[k];
      if (k == lane || f > bv) {
        bv = f;
        g = k;
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float vb = __shfl_xor_sync(kFull, bv, off);
      const int ib = __shfl_xor_sync(kFull, g, off);
      take_max(bv, g, vb, ib);
    }
    if (lane == 0) {
      long long* pb = path + (long long)b * N;
      pb[N - 1] = g;
      for (int t = N - 2; !LLSM_SKIP_PASS_B && t >= 0; --t) {
        g = bp[(long long)t * S + g];
        pb[t] = g;
      }
    }
  }
}

using Kernel = void (*)(const float*, const float*, long long*, float*,
                        unsigned char*, int, int, int, int);

template <int C, int LT>
Kernel pick_bp(int bp_smem, int renorm) {
  if (bp_smem)
    return renorm ? viterbi_kernel<C, LT, true, true>
                  : viterbi_kernel<C, LT, true, false>;
  return renorm ? viterbi_kernel<C, LT, false, true>
                : viterbi_kernel<C, LT, false, false>;
}

// null where the geometry has no kernel
Kernel pick(int C, int lt_mode, int bp_smem, int renorm) {
  if (lt_mode == 0) {
    switch (C) {
      case 4: return pick_bp<4, 0>(bp_smem, renorm);
      case 8: return pick_bp<8, 0>(bp_smem, renorm);
      case 16: return pick_bp<16, 0>(bp_smem, renorm);
      case 32: return pick_bp<32, 0>(bp_smem, renorm);
      case 52: return pick_bp<52, 0>(bp_smem, renorm);
      case 64: return pick_bp<64, 0>(bp_smem, renorm);
      default: return nullptr;
    }
  }
  if (C != 64) return nullptr;
  if (lt_mode == 1) return pick_bp<64, 1>(bp_smem, renorm);
  if (lt_mode == 2) return pick_bp<64, 2>(bp_smem, renorm);
  return nullptr;
}

// lt mode 3, S > 256: one lane a state, a thread the destinations j = tid,
// tid + blockDim.x, ...; C = S rounded up to 4 source states a lane in the
// four partial maxima of viterbi_kernel at P = 1; BP the backpointers' type
// (uint16).  Dynamic shared memory: the two score rows [2][C], the warps'
// maxima [2][kMaxWarps], then the backpointers [(N - 1) * S] if BP_SMEM.
template <typename BP, bool BP_SMEM, bool RENORM>
__global__ void __launch_bounds__(kMaxThreads)
    viterbi_wide_kernel(const float* __restrict__ obs,
                        const float* __restrict__ lt,
                        long long* __restrict__ path,
                        float* __restrict__ final_score, BP* bp_g, int N,
                        int S, int C) {
  extern __shared__ __align__(16) float smem[];
  float* s = smem;                               // [2][C]
  int* red = reinterpret_cast<int*>(s + 2 * C);  // [2][kMaxWarps] keys
  BP* bp_s = reinterpret_cast<BP*>(red + 2 * kMaxWarps);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x, b = blockIdx.x;
  const float* o = obs + (long long)b * N * S;
  BP* bp = BP_SMEM ? bp_s : bp_g + (long long)b * (N - 1) * S;

  for (int k = tid; k < 2 * C; k += T) s[k] = -INFINITY;
  for (int k = tid; k < 2 * kMaxWarps; k += T) red[k] = fkey(-INFINITY);
  __syncthreads();
  int kmax = fkey(-INFINITY);
  for (int j = tid; j < S; j += T) {
    const float v = o[j];
    s[j] = v;
    kmax = max(kmax, fkey(v));
  }
  if (RENORM) {
    kmax = __reduce_max_sync(kFull, kmax);
    if (lane == 0) red[warp] = kmax;
  }
  __syncthreads();

  for (int t = 1; t < N; ++t) {
    const int cur = (t - 1) & 1, nxt = t & 1;
    const float4* sp4 = reinterpret_cast<const float4*>(s + cur * C);
    const float m = RENORM ? row_max(red + cur * kMaxWarps, lane) : 0.0f;
    kmax = fkey(-INFINITY);
    for (int j = tid; j < S; j += T) {
      const float ob = __ldg(o + (long long)t * S + j);
      float bv[4];
      int bi[4];
      for (int mm = 0; mm < C / 4; ++mm) {
        const float4 q = sp4[mm];
        const float qs[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * mm + e;
          const float sc = RENORM ? __fsub_rn(qs[e], m) : qs[e];
          const float l = i < S ? __ldg(lt + (long long)i * S + j) : 0.0f;
          const float c = __fadd_rn(sc, l);
          if (mm == 0) {
            bv[e] = c;
            bi[e] = i;
          } else {
            take_gt(bv[e], bi[e], c, i);
          }
        }
      }
      take_max(bv[0], bi[0], bv[1], bi[1]);
      take_max(bv[2], bi[2], bv[3], bi[3]);
      take_max(bv[0], bi[0], bv[2], bi[2]);
      const float v = __fadd_rn(bv[0], ob);
      s[nxt * C + j] = v;
      bp[(long long)(t - 1) * S + j] = (BP)bi[0];
      kmax = max(kmax, fkey(v));
    }
    if (RENORM) {
      kmax = __reduce_max_sync(kFull, kmax);
      if (lane == 0) red[nxt * kMaxWarps + warp] = kmax;
    }
    __syncthreads();
  }

  // as viterbi_kernel: the last scores out, the final argmax by warp 0,
  // the backtrace by thread 0
  const int last = (N - 1) & 1;
  const float* sf = s + last * C;
  const float mf = RENORM ? row_max(red + last * kMaxWarps, lane) : 0.0f;
  for (int j = tid; j < S; j += T)
    final_score[(long long)b * S + j] = RENORM ? __fsub_rn(sf[j], mf) : sf[j];
  if (warp == 0) {
    float bv = -INFINITY;
    int g = 1 << 30;
    for (int k = lane; k < S; k += 32) {
      const float f = RENORM ? __fsub_rn(sf[k], mf) : sf[k];
      if (k == lane || f > bv) {
        bv = f;
        g = k;
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float vb = __shfl_xor_sync(kFull, bv, off);
      const int ib = __shfl_xor_sync(kFull, g, off);
      take_max(bv, g, vb, ib);
    }
    if (lane == 0) {
      long long* pb = path + (long long)b * N;
      pb[N - 1] = g;
      for (int t = N - 2; !LLSM_SKIP_PASS_B && t >= 0; --t) {
        g = bp[(long long)t * S + g];
        pb[t] = g;
      }
    }
  }
}

using WideKernel = void (*)(const float*, const float*, long long*, float*,
                            uint16_t*, int, int, int);

WideKernel pick_wide(int bp_smem, int renorm) {
  if (bp_smem)
    return renorm ? viterbi_wide_kernel<uint16_t, true, true>
                  : viterbi_wide_kernel<uint16_t, true, false>;
  return renorm ? viterbi_wide_kernel<uint16_t, false, true>
                : viterbi_wide_kernel<uint16_t, false, false>;
}

}  // namespace

// obs [B, N, S], lt [S, S], path [B, N] int64, final_score [B, S], bp (a
// [B, N - 1, S] scratch of bp_bytes-wide backpointers where bp_smem is 0,
// else null); P lanes a state, C source states a lane, lt_mode, bp_smem
// and bp_bytes as kernels._viterbi_geometry chose them: modes 0-2 (S <=
// 256) viterbi_kernel with uint8 backpointers, mode 3 (S > 256)
// viterbi_wide_kernel with uint16
extern "C" int llsm_viterbi_scan(const float* obs, const float* lt,
                                 long long* path, float* final_score,
                                 void* bp, int B, int N, int S, int renorm,
                                 int P, int C, int lt_mode, int bp_smem,
                                 int bp_bytes, void* stream) {
  if (N < 1 || S < 1 || (!bp_smem && N > 1 && !bp))
    return (int)cudaErrorInvalidValue;
  if (lt_mode == 3) {
    const int threads = min(kMaxThreads, (S + 31) / 32 * 32);
    const size_t smem = (size_t)(2 * C + 2 * kMaxWarps) * sizeof(float) +
                        (bp_smem ? (size_t)(N - 1) * S * sizeof(uint16_t)
                                 : 0);
    if (S <= kMaxStates || S > 65536 || P != 1 || C % 4 || C < S ||
        bp_bytes != 2)
      return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    const WideKernel k = pick_wide(bp_smem, renorm);
    cudaError_t e = llsm::allow_smem(k, smem);
    if (e != cudaSuccess) return (int)e;
    k<<<B, threads, smem, (cudaStream_t)stream>>>(
        obs, lt, path, final_score, static_cast<uint16_t*>(bp), N, S, C);
    return (int)cudaGetLastError();
  }
  int log2P = 0;
  while ((1 << log2P) < P) ++log2P;
  const int threads = (P * S + 31) / 32 * 32;
  const Kernel k = pick(C, lt_mode, bp_smem, renorm);
  if (S > kMaxStates || P < 1 || P > 32 || (1 << log2P) != P || P * C < S ||
      !k || threads > max_threads(C, lt_mode) || bp_bytes != 1)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  const size_t smem =
      (size_t)(2 * P * C + 2 * kMaxWarps + kRing * S) * sizeof(float) +
                      (lt_mode == 1 ? (size_t)S * S * sizeof(float) : 0) +
                      (bp_smem ? (size_t)(N - 1) * S : 0);
  cudaError_t e = llsm::allow_smem(k, smem);
  if (e != cudaSuccess) return (int)e;
  k<<<B, threads, smem, (cudaStream_t)stream>>>(
      obs, lt, path, final_score, static_cast<unsigned char*>(bp), N, S, P,
      log2P);
  return (int)cudaGetLastError();
}
