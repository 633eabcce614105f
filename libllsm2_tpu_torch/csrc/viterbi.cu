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
// From 257 to 2048 states (lt mode 4) viterbi_grid_kernel takes the card:
// a step is a max-plus product of the rows' scores [B, S] with lt [S, S],
// so each block owns a slice of kGridJ = 16 destination states for the
// rows of its row groups, every step, and keeps lt's column slice in
// shared memory for the whole launch (read once, where a block a row
// would read all of lt from L2 for every row and step).  Its blocks
// (at most one an SM) run in one cooperative launch and meet at one
// grid-wide barrier a step (an arrival counter in device memory); between
// barriers the block copies its rows' previous raw scores from L2 into
// shared memory (cp.async.cg), and a warp takes 8 rows x the block's 16
// destinations over a part of the source states (a thread 2 rows x 2
// destinations; 8 or 16 warps, the parts' maxima merged in part order).
// The candidates come in groups of 8 source states: the group's maximum
// by a tree of fmaxf, then one compare with the running best (a strict >
// over ascending groups: the first group that reaches the maximum), and
// after the last group the first state of that group whose candidate
// equals it: the maximum and its lowest index, as the plain loop's,
// with ~1.25 compare instructions a candidate where a compare and two
// moves were 3.  With renorm each row's maximum is an atomicMax of
// order-preserving unsigned keys over the blocks' partial maxima (exact
// in any order), in three rotating buffers; the candidates read (score_i
// - m) + lt_ij, the plain loop's two roundings.  Backpointers uint16 in
// device memory; after the last barrier warp 0 of a block takes a row's
// final argmax and thread 0 its backtrace.  Bound: the max-plus product's
// B S^2 (N - 1) adds and compares; what sets a step is the ALU pipe's
// compares, the scores' L2 traffic (4 B S^2 / 16 bytes a step) and the
// barrier, whose fixed cost a step sets a row alone's time.
//
// Past 2048 states (lt mode 5: a tracker with nbins >= 2048, up to
// kernels._VITERBI_MAX_STATES = 29024) viterbi_stream_kernel takes the card
// the same way, with what stops the grid kernel there taken away: ceil(S /
// 16) slices would need more blocks than SMs, and lt's column slice (16 x
// (S + 4) floats) no longer fits shared memory beside the rows.  A block
// owns a slice of 32 DW destination states (DW dest warps, the fewest whose
// slices are at most one block an SM) for the rows of its row groups, and
// every step streams lt's columns of the slice and the rows' previous raw
// scores through shared memory in chunks of source states: cp.async into
// two buffers, the next chunk in flight while this one is used.  Every
// warp of the block uses each chunk (lt read once a step by the card, not
// once a row), a thread 4 neighbouring destinations x 4 rows (1 row where
// the batch has at most 4: a row alone), and the block's other warps split
// each chunk's groups of 8 source states into P parts.  Each (row,
// destination)'s running (group maximum, first group) is carried across
// the chunks in ascending order, the grid kernel's strict > over groups;
// after the last chunk the first state of the best group that reaches it
// is found by reading its 8 candidates again from device memory (its chunk
// is gone), then the parts are merged in order: by the order argument
// above, the plain loop's maximum and first index, so the scores and the
// path are the plain version's bit for bit, and those of the kernel it
// replaced (one block a row, all of lt read from device memory by every
// row at every step).  Row maxima, uint16 backpointers in device memory,
// one grid barrier a step and the backtrace as in the grid kernel.  Bound:
// B S^2 (N - 1) adds and compares; lt's 4 S^2 bytes a step (67 MB at S
// 4097, more than the L2) come from device memory once a step, under the
// compares' time at 64 rows.
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
// stays), for scripts/port_kernel_passes.py's split; LLSM_SKIP_PASS_A = 1
// the cooperative kernels' candidates (their staging, merges and barriers
// stay)
#ifndef LLSM_SKIP_PASS_A
#define LLSM_SKIP_PASS_A 0
#endif
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

// ---------------------------------------------------------------------------
// lt mode 4: viterbi_grid_kernel (see the header)

constexpr int kGridJ = 16;           // destination states a block
constexpr int kGridG = 8;            // source states a group
constexpr int kGridRows = 8;         // rows a warp
constexpr int kGridMaxWarps = 16;

// A float as an unsigned of the same order (not NaN; -0 below +0), and
// back; 0 is below every key, so a zeroed buffer starts every maximum.
__device__ __forceinline__ unsigned ukey(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float ufval(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ void cp_async16_cg(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// Every block of the cooperative grid arrives (the counter's target is
// (barrier number) x (blocks)) before any goes on; what each block wrote
// before it is visible to all after it: the release add after the block's
// barrier, the acquire load before the next (no fence around them).
__device__ __forceinline__ void grid_barrier(unsigned* ctr, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(ctr)
                 : "memory");
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(ctr)
                   : "memory");
    } while (v < target);
  }
  __syncthreads();
}

// One group's 8 candidates of one (row, destination): their maximum by a
// tree of fmaxf, taken by the running best where it is greater.
__device__ __forceinline__ void take_group(float& best, int& g,
                                           const float* s, const float* l,
                                           int i) {
  float c[kGridG];
#pragma unroll
  for (int e = 0; e < kGridG; ++e) c[e] = __fadd_rn(s[e], l[e]);
  const float m = fmaxf(fmaxf(fmaxf(c[0], c[1]), fmaxf(c[2], c[3])),
                        fmaxf(fmaxf(c[4], c[5]), fmaxf(c[6], c[7])));
  take_gt(best, g, m, i);
}

// After the last grid barrier: row r's final argmax by warp 0 of block (r
// mod blocks), its backtrace by that warp's lane 0 (the cooperative
// kernels' last raw scores `last`, their maxima's keys `mlast`)
template <bool RENORM>
__device__ __forceinline__ void argmax_backtrace(const float* last,
                                                 const unsigned* mlast,
                                                 long long* path,
                                                 const uint16_t* bp, int B,
                                                 int N, int S, int Sp) {
  const int lane = threadIdx.x & 31;
  const unsigned G = gridDim.x * gridDim.y;
  for (int r = blockIdx.y * gridDim.x + blockIdx.x; r < B; r += G) {
    const float mf = RENORM ? ufval(__ldcg(mlast + r)) : 0.0f;
    float bv = -INFINITY;
    int g = 1 << 30;
    for (int k = lane; k < S; k += 32) {
      const float raw = __ldcg(last + (long long)r * Sp + k);
      const float f = RENORM ? __fsub_rn(raw, mf) : raw;
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
      long long* pb = path + (long long)r * N;
      pb[N - 1] = g;
      for (int t = N - 2; !LLSM_SKIP_PASS_B && t >= 0; --t) {
        g = __ldcg(bp + ((long long)r * (N - 1) + t) * S + g);
        pb[t] = g;
      }
    }
  }
}

// Dynamic shared memory: lt's column slice transposed, ltT [kGridJ][Sp + 4]
// (zero past S), then the rows of raw scores [Rb][Sp + 4] (row strides of
// Sp + 4 floats: a warp's 4 rows or 8 destinations read by one float4
// instruction fall on distinct banks), then where P > 1 the partial maxima
// [P][Rb][kGridJ] (value, index).  A block's warps are Wr row warps (8 rows
// each, Rb = 8 Wr) times P parts of the source states (part p the groups g
// = p, p + P, ...), warp w = p Wr + its row warp.  Device memory (work):
// the raw scores [2][B][Sp] (-inf past S), the row maxima's keys [3][B],
// the barrier's counter.
template <bool RENORM>
__global__ void __launch_bounds__(32 * kGridMaxWarps, 1)
    viterbi_grid_kernel(const float* __restrict__ obs,
                        const float* __restrict__ lt,
                        long long* __restrict__ path,
                        float* __restrict__ final_score, uint16_t* bp,
                        float* scores, unsigned* rowmax, unsigned* ctr, int B,
                        int N, int S, int Sp, int Wr) {
  extern __shared__ __align__(16) float smem[];
  const int LS = Sp + 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x, nw = T >> 5, P = nw / Wr, Rb = kGridRows * Wr;
  const int rw = warp % Wr, part = warp / Wr;   // row warp, source part
  float* ltT = smem;
  float* srows = smem + kGridJ * LS;
  float* pval = srows + Rb * LS;                 // [P][Rb][kGridJ]
  int* pidx = reinterpret_cast<int*>(pval + P * Rb * kGridJ);
  const int j0 = blockIdx.x * kGridJ;
  const unsigned G = gridDim.x * gridDim.y;
  const int lr = lane >> 3, lj = lane & 7;     // rows lr, lr + 4; dests lj,
                                               // lj + 8 of the row warp
  for (int k = tid; k < kGridJ * Sp; k += T) {
    const int i = k / kGridJ, jj = k - i * kGridJ, j = j0 + jj;
    ltT[jj * LS + i] = (i < S && j < S) ? lt[(long long)i * S + j] : 0.0f;
  }
  const long long BS = (long long)B * Sp;

  // step 0: the raw scores (and -inf past S in both buffers), the maxima
  for (int rg = blockIdx.y; rg * Rb < B; rg += gridDim.y) {
    if (part != 0) continue;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = rg * Rb + rw * kGridRows + lr + 4 * a;
      unsigned key = 0;
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int j = j0 + lj + 8 * d;
        if (r < B && j < Sp) {
          if (j < S) {
            const float v = obs[(long long)r * N * S + j];
            scores[(long long)r * Sp + j] = v;
            key = max(key, ukey(v));
          } else {
            scores[(long long)r * Sp + j] = -INFINITY;
            scores[BS + (long long)r * Sp + j] = -INFINITY;
          }
        }
      }
      if (RENORM) {
#pragma unroll
        for (int o = 1; o < 8; o <<= 1)
          key = max(key, __shfl_xor_sync(kFull, key, o));
        if (lj == 0 && r < B) atomicMax(rowmax + r, key);
      }
    }
  }
  grid_barrier(ctr, G);

  for (int t = 1; t < N; ++t) {
    const float* prev = scores + ((t - 1) & 1) * BS;
    float* next = scores + (t & 1) * BS;
    const unsigned* mprev = rowmax + ((t - 1) % 3) * B;
    unsigned* mnext = rowmax + (t % 3) * B;
    if (RENORM && blockIdx.x == 0) {   // read at step t - 1, written at t + 1
      unsigned* mfree = rowmax + ((t + 1) % 3) * B;
      for (int rg = blockIdx.y; rg * Rb < B; rg += gridDim.y)
        for (int k = tid; k < Rb && rg * Rb + k < B; k += T)
          mfree[rg * Rb + k] = 0u;
    }
    for (int rg = blockIdx.y; rg * Rb < B; rg += gridDim.y) {
      const int r0 = rg * Rb;                      // the block's first row
      for (int rr = warp; rr < Rb && r0 + rr < B; rr += nw) {
        const float* src = prev + (long long)(r0 + rr) * Sp;
        for (int c = lane * 4; c < Sp; c += 128)
          cp_async16_cg(srows + rr * LS + c, src + c);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      int rows[2];
      float m[2], ob[2][2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        rows[a] = r0 + rw * kGridRows + lr + 4 * a;
        const bool live = rows[a] < B;
        m[a] = RENORM && live ? ufval(__ldcg(mprev + rows[a])) : 0.0f;
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const int j = j0 + lj + 8 * d;
          ob[a][d] = part == 0 && live && j < S
                         ? __ldg(obs + ((long long)rows[a] * N + t) * S + j)
                         : 0.0f;
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();

      const int rl = rw * kGridRows + lr;          // local rows rl, rl + 4
      const float* sr[2] = {srows + rl * LS, srows + (rl + 4) * LS};
      const float* lc[2] = {ltT + lj * LS, ltT + (lj + 8) * LS};
      float best[2][2];
      int grp[2][2];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          best[a][d] = -INFINITY;
          grp[a][d] = kGridG * part;
        }
      for (int i = kGridG * part; !LLSM_SKIP_PASS_A && i < Sp;
           i += kGridG * P) {
        float sv[2][kGridG], lv[2][kGridG];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float4 x = *reinterpret_cast<const float4*>(sr[a] + i);
          const float4 y = *reinterpret_cast<const float4*>(sr[a] + i + 4);
          const float q[kGridG] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
          for (int e = 0; e < kGridG; ++e)
            sv[a][e] = RENORM ? __fsub_rn(q[e], m[a]) : q[e];
        }
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const float4 x = *reinterpret_cast<const float4*>(lc[d] + i);
          const float4 y = *reinterpret_cast<const float4*>(lc[d] + i + 4);
          const float q[kGridG] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
          for (int e = 0; e < kGridG; ++e) lv[d][e] = q[e];
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int d = 0; d < 2; ++d)
            take_group(best[a][d], grp[a][d], sv[a], lv[d], i);
      }

      // the first state of each best group that reaches its maximum: the
      // part's (value, lowest index), merged over the parts in order
      int bi[2][2];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const int g0 = grp[a][d];
          bi[a][d] = g0;
          for (int e = 0; g0 < Sp && e < kGridG; ++e) {
            const float sc = RENORM ? __fsub_rn(sr[a][g0 + e], m[a])
                                    : sr[a][g0 + e];
            const float c = __fadd_rn(sc, lc[d][g0 + e]);
            if (c == best[a][d]) {
              best[a][d] = c;
              bi[a][d] = g0 + e;
              break;
            }
          }
          if (P > 1) {
            const int o = (part * Rb + rl + 4 * a) * kGridJ + lj + 8 * d;
            pval[o] = best[a][d];
            pidx[o] = bi[a][d];
          }
        }
      if (P > 1) __syncthreads();
      if (part == 0) {
        // the new raw scores, the backpointers, the rows' partial maxima
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          unsigned key = 0;
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            float bv = best[a][d];
            int bk = bi[a][d];
            for (int q = 1; q < P; ++q) {
              const int o = (q * Rb + rl + 4 * a) * kGridJ + lj + 8 * d;
              take_max(bv, bk, pval[o], pidx[o]);
            }
            const int j = j0 + lj + 8 * d;
            if (rows[a] < B && j < S) {
              const float v = __fadd_rn(bv, ob[a][d]);
              next[(long long)rows[a] * Sp + j] = v;
              bp[((long long)rows[a] * (N - 1) + t - 1) * S + j] =
                  (uint16_t)bk;
              key = max(key, ukey(v));
            }
          }
          if (RENORM) {
#pragma unroll
            for (int o = 1; o < 8; o <<= 1)
              key = max(key, __shfl_xor_sync(kFull, key, o));
            if (lj == 0 && rows[a] < B) atomicMax(mnext + rows[a], key);
          }
        }
      }
      __syncthreads();           // the rows and partials are read
    }
    grid_barrier(ctr, (unsigned)(t + 1) * G);
  }

  // the last scores out, renormalised; a row's final argmax by warp 0 of
  // block (row mod blocks), its backtrace by that warp's lane 0
  const float* last = scores + ((N - 1) & 1) * BS;
  const unsigned* mlast = rowmax + ((N - 1) % 3) * B;
  for (int rg = blockIdx.y; rg * Rb < B; rg += gridDim.y)
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = rg * Rb + rw * kGridRows + lr + 4 * a;
      if (part != 0 || r >= B) continue;
      const float mf = RENORM ? ufval(__ldcg(mlast + r)) : 0.0f;
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int j = j0 + lj + 8 * d;
        if (j < S) {
          const float raw = __ldcg(last + (long long)r * Sp + j);
          final_score[(long long)r * S + j] = RENORM ? __fsub_rn(raw, mf)
                                                     : raw;
        }
      }
    }
  if (warp == 0)
    argmax_backtrace<RENORM>(last, mlast, path, bp, B, N, S, Sp);
}

// ---------------------------------------------------------------------------
// lt mode 5: viterbi_stream_kernel (see the header)

constexpr int kStreamJ = 32;         // destination states a dest warp
constexpr int kStreamMaxWarps = 16;

// Dynamic shared memory: two chunk buffers, each lt's chunk of source
// states x the block's destinations [KC][J] (source-major, the block's
// columns of KC rows of lt) and the row group's raw scores of the chunk
// [Rb][KC + 4]; after a row group's last chunk the parts' maxima [P][Rb][J]
// (value, first group), over the buffers.  A block's warps are DW
// dest warps (32 destinations each: lane lj = lane & 7 the four j = 4 lj +
// d) times RW row warps (4 RA rows each: lane lr = lane >> 3 the rows lr +
// 4 a, a < RA) times P parts of the source states (part p the groups of 8
// states p, p + P, ... of each chunk: ascending over the chunks), warp w =
// (p RW + row warp) DW + dest warp.  Device memory (work): the raw scores
// [2][B][Sp] (-inf past S), the row maxima's keys [3][B], the barrier's
// counter.
template <bool RENORM, int RA>
__global__ void __launch_bounds__(32 * kStreamMaxWarps, 1)
    viterbi_stream_kernel(const float* __restrict__ obs,
                          const float* __restrict__ lt,
                          long long* __restrict__ path,
                          float* __restrict__ final_score, uint16_t* bp,
                          float* scores, unsigned* rowmax, unsigned* ctr,
                          int B, int N, int S, int Sp, int DW, int RW,
                          int KC) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RL = 4 * RA;                     // rows a row warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = blockDim.x, nw = T >> 5, P = nw / (DW * RW);
  const int J = kStreamJ * DW, Rb = RL * RW, LS = KC + 4;
  const int dw = warp % DW, rw = (warp / DW) % RW, part = warp / (DW * RW);
  const int lr = lane >> 3, lj = lane & 7;
  const int buf = KC * J + Rb * LS;              // floats a chunk buffer
  // the parts' maxima [P][Rb][J] after the chunk loop, over the buffers
  float* pval = smem;
  int* pidx = reinterpret_cast<int*>(pval + P * Rb * J);
  const int j0 = blockIdx.x * J;
  const int jl = kStreamJ * dw + 4 * lj;         // the thread's first dest
  const unsigned G = gridDim.x * gridDim.y;
  const long long BS = (long long)B * Sp;
  const int nch = (Sp + KC - 1) / KC;

  // step 0: the raw scores (and -inf past S in both buffers), the maxima
  for (int rg = blockIdx.y; rg * Rb < B; rg += gridDim.y) {
    if (part != 0) continue;
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int r = rg * Rb + rw * RL + lr + 4 * a;
      unsigned key = 0;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int j = j0 + jl + d;
        if (r < B && j < Sp) {
          if (j < S) {
            const float v = obs[(long long)r * N * S + j];
            scores[(long long)r * Sp + j] = v;
            key = max(key, ukey(v));
          } else {
            scores[(long long)r * Sp + j] = -INFINITY;
            scores[BS + (long long)r * Sp + j] = -INFINITY;
          }
        }
      }
      if (RENORM) {
#pragma unroll
        for (int o = 1; o < 8; o <<= 1)
          key = max(key, __shfl_xor_sync(kFull, key, o));
        if (lj == 0 && r < B) atomicMax(rowmax + r, key);
      }
    }
  }
  grid_barrier(ctr, G);

  for (int t = 1; t < N; ++t) {
    const float* prev = scores + ((t - 1) & 1) * BS;
    float* next = scores + (t & 1) * BS;
    const unsigned* mprev = rowmax + ((t - 1) % 3) * B;
    unsigned* mnext = rowmax + (t % 3) * B;
    if (RENORM && blockIdx.x == 0) {   // read at step t - 1, written at t + 1
      unsigned* mfree = rowmax + ((t + 1) % 3) * B;
      for (int rg = blockIdx.y; rg * Rb < B; rg += gridDim.y)
        for (int k = tid; k < Rb && rg * Rb + k < B; k += T)
          mfree[rg * Rb + k] = 0u;
    }
    for (int rg = blockIdx.y; rg * Rb < B; rg += gridDim.y) {
      const int r0 = rg * Rb;                      // the block's first row
      // chunk c of lt's columns and of the rows' previous raw scores into
      // buffer c & 1 (lt zero past S, the scores -inf there in device
      // memory), one commit group
      auto stage = [&](int c) {
        float* lc = smem + (c & 1) * buf;
        float* sr = lc + KC * J;
        const int i0 = c * KC, len = min(KC, Sp - i0);
        for (int ii = warp; ii < len; ii += nw) {
          const int i = i0 + ii;
          for (int jj = lane; jj < J; jj += 32) {
            const bool in = i < S && j0 + jj < S;
            llsm::cp_async4(lc + ii * J + jj,
                            in ? lt + (long long)i * S + j0 + jj : lt, in);
          }
        }
        for (int rr = warp; rr < Rb && r0 + rr < B; rr += nw) {
          const float* src = prev + (long long)(r0 + rr) * Sp + i0;
          for (int k = lane * 4; k < len; k += 128)
            cp_async16_cg(sr + rr * LS + k, src + k);
        }
        cp_async_commit();
      };
      stage(0);
      float m[RA];                                 // the rows' maxima
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const int r = r0 + rw * RL + lr + 4 * a;
        m[a] = RENORM && r < B ? ufval(__ldcg(mprev + r)) : 0.0f;
      }
      float best[RA][4];
      int grp[RA][4];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          best[a][d] = -INFINITY;
          grp[a][d] = 8 * part;
        }
      for (int c = 0; c < nch; ++c) {
        if (c + 1 < nch) {
          stage(c + 1);
          llsm::cp_async_wait<1>();
        } else {
          llsm::cp_async_wait<0>();
        }
        __syncthreads();
        const float* lc = smem + (c & 1) * buf + jl;
        const float* sr = smem + (c & 1) * buf + KC * J
                          + (rw * RL + lr) * LS;
        const int i0 = c * KC, len = min(KC, Sp - i0);
        for (int g = 8 * part; !LLSM_SKIP_PASS_A && g < len; g += 8 * P) {
          float lv[8][4];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float4 q = *reinterpret_cast<const float4*>(lc + (g + e)
                                                              * J);
            lv[e][0] = q.x; lv[e][1] = q.y; lv[e][2] = q.z; lv[e][3] = q.w;
          }
#pragma unroll
          for (int a = 0; a < RA; ++a) {
            const float4 x = *reinterpret_cast<const float4*>(sr + 4 * a * LS
                                                              + g);
            const float4 y = *reinterpret_cast<const float4*>(sr + 4 * a * LS
                                                              + g + 4);
            const float q8[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
            float sv[8];
#pragma unroll
            for (int e = 0; e < 8; ++e)
              sv[e] = RENORM ? __fsub_rn(q8[e], m[a]) : q8[e];
#pragma unroll
            for (int d = 0; d < 4; ++d) {
              const float l8[8] = {lv[0][d], lv[1][d], lv[2][d], lv[3][d],
                                   lv[4][d], lv[5][d], lv[6][d], lv[7][d]};
              take_group(best[a][d], grp[a][d], sv, l8, i0 + g);
            }
          }
        }
        __syncthreads();           // buffer c & 1 is free for chunk c + 2
      }

      // each part's (maximum, first group reaching it) into shared memory
      // (over the buffers: the loop's last barrier freed them)
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const int o = (part * Rb + rw * RL + lr + 4 * a) * J + jl + d;
          pval[o] = best[a][d];
          pidx[o] = grp[a][d];
        }
      __syncthreads();
      // a (row, destination) a thread, destinations fastest: the parts
      // merged in order by (value, then lowest group: the groups of two
      // parts are disjoint, so the lower group holds the lower states),
      // then the first state of the winning group that reaches the
      // maximum, its 8 candidates read again from device memory (its
      // chunk is gone): the maximum and its lowest index; the new raw
      // score, the backpointer, the row's partial maximum
      for (int k = tid; k < Rb * J; k += T) {
        const int rl = k / J, jj = k - rl * J;
        const int row = r0 + rl, j = j0 + jj;
        float bv = pval[k];
        int g0 = pidx[k];
        for (int q = 1; q < P; ++q)
          take_max(bv, g0, pval[q * Rb * J + k], pidx[q * Rb * J + k]);
        unsigned key = 0;
        if (row < B && j < S) {
          const float m = RENORM ? ufval(__ldcg(mprev + row)) : 0.0f;
          const float4* sp = reinterpret_cast<const float4*>(
              prev + (long long)row * Sp + g0);
          const float4 x = __ldcg(sp), y = __ldcg(sp + 1);
          const float q8[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
          float c[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int i = g0 + e;
            const float l = i < S ? __ldg(lt + (long long)i * S + j) : 0.0f;
            c[e] = __fadd_rn(RENORM ? __fsub_rn(q8[e], m) : q8[e], l);
          }
          // descending, so the last taken is the first equal
          float v = bv;
          int bk = g0;
#pragma unroll
          for (int e = 7; e >= 0; --e)
            if (c[e] == bv) {
              v = c[e];
              bk = g0 + e;
            }
          v = __fadd_rn(v, __ldg(obs + ((long long)row * N + t) * S + j));
          next[(long long)row * Sp + j] = v;
          bp[((long long)row * (N - 1) + t - 1) * S + j] = (uint16_t)bk;
          key = ukey(v);
        }
        if (RENORM) {              // a warp's 32 destinations of one row
          key = __reduce_max_sync(kFull, key);
          if (lane == 0 && row < B) atomicMax(mnext + row, key);
        }
      }
      __syncthreads();        // the partials are read before the next stage
    }
    grid_barrier(ctr, (unsigned)(t + 1) * G);
  }
  // the last scores out, renormalised; the rows' argmax and backtrace
  const float* last = scores + ((N - 1) & 1) * BS;
  const unsigned* mlast = rowmax + ((N - 1) % 3) * B;
  for (int rg = blockIdx.y; rg * Rb < B; rg += gridDim.y)
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int r = rg * Rb + rw * RL + lr + 4 * a;
      if (part != 0 || r >= B) continue;
      const float mf = RENORM ? ufval(__ldcg(mlast + r)) : 0.0f;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int j = j0 + jl + d;
        if (j < S) {
          const float raw = __ldcg(last + (long long)r * Sp + j);
          final_score[(long long)r * S + j] = RENORM ? __fsub_rn(raw, mf)
                                                     : raw;
        }
      }
    }
  if (warp == 0)
    argmax_backtrace<RENORM>(last, mlast, path, bp, B, N, S, Sp);
}

}  // namespace

// obs [B, N, S], lt [S, S], path [B, N] int64, final_score [B, S], bp (a
// [B, N - 1, S] scratch of bp_bytes-wide backpointers where bp_smem is 0,
// else null); P lanes a state, C source states a lane, lt_mode, bp_smem
// and bp_bytes as kernels._viterbi_geometry chose them: modes 0-2 (S <=
// 256) viterbi_kernel with uint8 backpointers, mode 4 (256 < S <= 2048)
// viterbi_grid_kernel: C = S rounded up to 8, `warps` warps a block of
// which row_warps take rows (the rest parts of the source states),
// ceil(S / 16) x row_blocks blocks (kernels._viterbi_grid); mode 5 (S >
// 2048) viterbi_stream_kernel: C = S rounded up to 8, `warps` warps a
// block of dest_warps x row_warps x parts, rows_a rows a thread, chunks of
// `chunk` source states, ceil(S / (32 dest_warps)) x row_blocks blocks
// (kernels._viterbi_stream); in modes 4 and 5 work is the device scratch
// of the raw scores, row maxima and barrier counter (zeroed here but the
// scores), the backpointers uint16 in device memory
extern "C" int llsm_viterbi_scan(const float* obs, const float* lt,
                                 long long* path, float* final_score,
                                 void* bp, void* work, int B, int N, int S,
                                 int renorm, int P, int C, int lt_mode,
                                 int bp_smem, int bp_bytes, int warps,
                                 int row_warps, int row_blocks,
                                 int dest_warps, int rows_a, int chunk,
                                 void* stream) {
  if (N < 1 || S < 1 || (!bp_smem && N > 1 && !bp))
    return (int)cudaErrorInvalidValue;
  if (lt_mode == 4) {
    if (S <= kMaxStates || P != 1 || C % kGridG || C < S || bp_bytes != 2 ||
        bp_smem || warps < 1 || warps > kGridMaxWarps || row_warps < 1 ||
        warps % row_warps || row_blocks < 1 || !work)
      return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    float* scores = static_cast<float*>(work);
    unsigned* rowmax =
        reinterpret_cast<unsigned*>(scores + 2 * (long long)B * C);
    unsigned* ctr = rowmax + 3 * B;
    cudaError_t e =
        cudaMemsetAsync(rowmax, 0, (3 * (size_t)B + 1) * sizeof(unsigned), st);
    if (e != cudaSuccess) return (int)e;
    // kernels._viterbi_grid mirrors the bytes
    const int Rb = kGridRows * row_warps, parts = warps / row_warps;
    const size_t smem =
        (size_t)(kGridJ + Rb) * (C + 4) * sizeof(float) +
        (parts > 1 ? (size_t)parts * Rb * kGridJ * 2 * sizeof(float) : 0);
    auto k = renorm ? viterbi_grid_kernel<true> : viterbi_grid_kernel<false>;
    e = llsm::allow_smem(k, smem);
    if (e != cudaSuccess) return (int)e;
    uint16_t* bp16 = static_cast<uint16_t*>(bp);
    int Sp = C, Wr = row_warps;
    void* args[] = {&obs,   &lt,   &path, &final_score, &bp16, &scores,
                    &rowmax, &ctr, &B,    &N,           &S,    &Sp, &Wr};
    dim3 grid((S + kGridJ - 1) / kGridJ, row_blocks);
    e = cudaLaunchCooperativeKernel((const void*)k, grid, dim3(32 * warps),
                                    args, smem, st);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  if (lt_mode == 5) {
    const int dr = dest_warps * row_warps;
    if (S <= 2048 || S > 65536 || P != 1 || C % 8 || C < S ||
        bp_bytes != 2 || bp_smem || warps < 1 || warps > kStreamMaxWarps ||
        dest_warps < 1 || row_warps < 1 || warps % dr ||
        (rows_a != 1 && rows_a != 4) || row_blocks < 1 || chunk < 8 ||
        chunk % (8 * (warps / dr)) || !work)
      return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    float* scores = static_cast<float*>(work);
    unsigned* rowmax =
        reinterpret_cast<unsigned*>(scores + 2 * (long long)B * C);
    unsigned* ctr = rowmax + 3 * B;
    cudaError_t e =
        cudaMemsetAsync(rowmax, 0, (3 * (size_t)B + 1) * sizeof(unsigned), st);
    if (e != cudaSuccess) return (int)e;
    // kernels._viterbi_stream mirrors the bytes
    const int J = kStreamJ * dest_warps, Rb = 4 * rows_a * row_warps;
    const int parts = warps / dr;
    const size_t bufs =
        2 * ((size_t)chunk * J + (size_t)Rb * (chunk + 4)) * sizeof(float);
    const size_t partials =
        parts > 1 ? (size_t)parts * Rb * J * 2 * sizeof(float) : 0;
    const size_t smem = bufs > partials ? bufs : partials;
    const void* k =
        rows_a == 4
            ? (renorm ? (const void*)viterbi_stream_kernel<true, 4>
                      : (const void*)viterbi_stream_kernel<false, 4>)
            : (renorm ? (const void*)viterbi_stream_kernel<true, 1>
                      : (const void*)viterbi_stream_kernel<false, 1>);
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    uint16_t* bp16 = static_cast<uint16_t*>(bp);
    int Sp = C, DW = dest_warps, RW = row_warps, KC = chunk;
    void* args[] = {&obs,  &lt, &path, &final_score, &bp16, &scores, &rowmax,
                    &ctr,  &B,  &N,    &S,           &Sp,   &DW,     &RW,
                    &KC};
    dim3 grid((S + J - 1) / J, row_blocks);
    e = cudaLaunchCooperativeKernel(k, grid, dim3(32 * warps), args, smem,
                                    st);
    if (e != cudaSuccess) return (int)e;
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
