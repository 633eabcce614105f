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
// A frame shard's block (parallel.seqparallel) passes the global index of
// its first hop, start, and each row's float64 base, the exact sum of the
// hop totals before it: positions are then the whole track's, s + start
// nhop (negative ones, in the first shard's halo, take the exact path
// below), off_j starts from base, out[0] = base mod 1, and the block's
// samples get the whole track's bits.
//
// The JAX package has no Pallas kernel here (libllsm2_tpu/ops/harmonics.py:
// sample_cycles, a mod-1 associative scan under XLA).  PyTorch's CUDA scan
// orders a row's sums by the tensor's shape, so this kernel sums every row
// in an order set by the row alone: a row's track is the same alone and in
// any batch, whatever its values.
//
// Exactness, which lets a parallel scan give the plain version's bits: a
// float64 running sum of float32 values is exact when every value has its
// last bit at or above 2^(e - 52), e the exponent of the largest partial.
// A hop's partials stay under 16 cycles (nhop f0 / fs <= 160 * 1000 /
// 16000), so the in-hop sums are exact whenever every positive lerped F0
// is above ~5e-4 Hz at 16 kHz (the analysis' smallest, at a voicing edge,
// is ~f0_floor / nhop ~ 0.9 Hz); the hop totals mod 1 are float32 values
// in [0, 1) summed to under 2^11 per 1600 hops, exact when each is 0 or
// above ~2^-18.  Exact sums give the same bits in any order, so on such
// tracks (every analysis track) the kernel equals the plain version run on
// the CPU, whose cumsum accumulates float32 in float64, bit for bit.  Where
// a hop mixes a tiny positive F0 with a large one the orders part in the
// last bits (tests/test_torch_ops.py shows how far); the kernel then stays
// within 1e-6 cycles of the CPU.
//
// Bound on the H100: the [B, nx] output written once (16 M samples at the
// bench shape, 49 M at 48 kHz).  What costs is each sample's arithmetic
// (the step's division and four float conversions, two float64 adds, a
// floor) and the latency between a block's phases, so the design
// evaluates each step once and keeps many independent tiles in flight
// (scripts/port_kernel_passes.py times the steps and the output pass
// compiled out: only=sample_cycles, only=cycles_long).  Design, to a
// 512-sample hop: one kernel launch after a memset of its tile words, a
// block of 4 warps a tile of T <= 128 hops of one row, grid (tiles, rows).
// Past it (48 kHz at a 20 ms hop is 960; to 2048) the long-hop kernel
// below, a hop over two or four warps; past 2048 (48 kHz at 50 ms, 96 kHz
// at 200 ms: 19200) the hop kernel at the end, a block a hop.
//   - Steps: L lanes share a hop, each a run of at most 10 consecutive
//     samples (up to nhop = 320; to 512, 32 lanes with runs of up to 16);
//     a lane evaluates each step once, in registers, with the plain
//     version's float32 operations rounded one by one (__fmul_rn /
//     __fadd_rn keep FMA contraction out; the division as below).  The
//     position s / nhop is not divided a sample: below 2^24 samples its
//     fraction in hop j is fl(j + t / nhop) - j, which depends only on t
//     and the binade of j (no tie can fall on that grid there), so a
//     table of those fractions for the tile's binades, made once a block,
//     gives the plain version's bits; hops past 2^24 samples divide as
//     the plain version does.
//   - In-hop sums: the run sums in float64, a Kogge-Stone scan over the L
//     lanes gives each run its offset, and the float32 partials go to
//     shared memory.
//   - Hop offsets: the tile's hop totals mod 1 are scanned by one fixed
//     tree (a lane's ceil(T / 32) in order, then the warp); the tile
//     publishes their sum and adds its row predecessors' sums, read in tile
//     order (lane l takes tiles l, l + 32, ..., then a fixed xor tree),
//     never in the order they arrive.  Block (x, y) is tile x of row y; blocks
//     start in linear order, so every tile it waits for has started.
//   - Output: the tile's samples are consecutive; its threads write them
//     coalesced, each sample's hop tracked by adding the stride's quotient
//     and remainder.
#include "common.cuh"

// LLSM_SKIP_PASS_{A,B} = 1 compiles the steps' lerp and divide (a step is
// then a table read) or the output pass out, for scripts/port_kernel_passes.py
// to time what is left; both 0 in the library.
#ifndef LLSM_SKIP_PASS_A
#define LLSM_SKIP_PASS_A 0
#endif
#ifndef LLSM_SKIP_PASS_B
#define LLSM_SKIP_PASS_B 0
#endif

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int64_t kExact = int64_t(1) << 24;   // float32 integers end here
constexpr int kPasses = 4;                     // a block's passes a tile
constexpr int kMaxTile = kPasses * 32;         // hops a tile, at most
constexpr int bit_length(int v) { return v ? 1 + bit_length(v >> 1) : 0; }
constexpr int kBinades = bit_length(kMaxTile - 1) + 1;   // a tile's, at most

// The plain version's lerp at fraction t of frames (a, b), over fs, with
// rfs = 1 / fs rounded to float64.  fl32(v rfs) is fl32(v / fs) for every
// float32 v: a quotient of two float32 values is a float32 or lies at
// least 2^-50 (relative) from every float32 rounding midpoint, and v rfs
// in float64 is within 2^-52 of it, so the float32 rounding cannot move
// (no FCHK branch and no slow path, unlike __fdiv_rn).
__device__ __forceinline__ double step(float a, float b, float t,
                                       double rfs) {
  if (LLSM_SKIP_PASS_A) return t;
  const float v = __fadd_rn(__fmul_rn(a, __fadd_rn(1.0f, -t)),
                            __fmul_rn(b, t));
  return (double)__double2float_rn((double)v * rfs);
}

// F0 at sample s of row f0r (clamped at 0), divided by fs: the plain
// version's float32 operations, position included.
// s is the sample's index in the whole track, start its row's first hop.
__device__ __forceinline__ double f0_over_fs(const float* __restrict__ f0r,
                                             int64_t s, float nhop_f, int N,
                                             double rfs, int start) {
  const float pos = __fdiv_rn((float)s, nhop_f);
  const int i0 = min(max((int)floorf(pos) - start, 0), N - 2);
  const float t = fminf(fmaxf(__fadd_rn(pos, -(float)(i0 + start)), 0.0f),
                        1.0f);
  return step(fmaxf(__ldg(f0r + i0), 0.0f), fmaxf(__ldg(f0r + i0 + 1), 0.0f),
              t, rfs);
}

// binade of hop j: j in [2^(c - 1), 2^c), c = 0 for j = 0
__device__ __forceinline__ int binade(int j) { return 32 - __clz(j); }

// R <= 16: the samples a lane takes in a hop at most (a template, so the
// steps stay in registers); L = 2^lg >= kWarps lanes share a hop, each a run
// of ceil(nhop / L) <= R consecutive samples of it; a warp takes 32 / L hops
// a pass, and a block kPasses passes: a tile of T = kPasses kWarps 32 / L <=
// 128 hops.  Block (x, y) is tile x of row y, so a tile's predecessors in its
// row are blocks launched before it.  word[y tiles + x] is the tile's sum of
// hop totals mod 1, published with its sign bit set (0: not yet; zeroed
// before the kernel on its stream).
template <int R>
__global__ void __launch_bounds__(kThreads)
sample_cycles_kernel(const float* __restrict__ f0, float* __restrict__ out,
                     unsigned long long* __restrict__ word,
                     const double* __restrict__ base, int start, int N,
                     int nhop, int H, float fs, int lg) {
  extern __shared__ double smem[];
  const int L = 1 << lg, G = 32 >> lg, T = kPasses * kWarps * G;
  double* tots = smem;                          // [T] totals mod 1
  float* ofs = reinterpret_cast<float*>(tots + T);       // [T] offsets
  float* part = ofs + T;                        // [T, nhop] partials
  float* frac = part + T * nhop;                // [kBinades, nhop]
  const int row = blockIdx.y, k = blockIdx.x;
  const int j0 = k * T;
  const float* f0r = f0 + (int64_t)row * N;
  const int64_t nx = (int64_t)H * nhop;
  float* outr = out + (int64_t)row * nx;
  const float nhop_f = (float)nhop;
  const double rfs = __drcp_rn((double)fs);
  // the fractions of s / nhop in hop j: fl(j + t / nhop) - j depends only
  // on t and j's binade below 2^24 samples (no tie falls on that grid
  // there); a tile spans binades c0 .. binade(j0 + T - 1) of its hops'
  // indices in the whole track (negative ones take the exact path), at
  // most kBinades
  const int c0 = binade(max(start + j0, 0));
  const int ncl = binade(max(start + j0 + T - 1, 0)) - c0 + 1;
  for (int e = threadIdx.x; e < ncl * nhop; e += kThreads) {
    const int dc = e / nhop, t = e - dc * nhop, c = c0 + dc;
    const int jc = c ? 1 << (c - 1) : 0;
    if ((int64_t)jc * nhop + t < kExact)
      frac[e] = __fadd_rn(__fdiv_rn((float)(jc * nhop + t), nhop_f),
                          -(float)jc);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> lg, r = lane & (L - 1);
  const int run = (nhop + L - 1) >> lg;
  const int t0 = min(r * run, nhop), t1 = min(t0 + run, nhop);
  for (int pass = 0; pass < kPasses; ++pass) {
    const int hh = (pass * kWarps + warp) * G + g, j = j0 + hh;
    double d[R];
    double acc = 0.0;
    if (j < H) {
      const int64_t s0 = (int64_t)(start + j) * nhop;
      if (s0 >= 0 && s0 + nhop <= kExact) {
        const int i0 = min(j, N - 2);
        const float a = fmaxf(__ldg(f0r + i0), 0.0f);
        const float b = fmaxf(__ldg(f0r + i0 + 1), 0.0f);
        const float* fr = frac + (binade(start + j) - c0) * nhop;
        const bool last = j >= N - 1;           // pos >= N - 1: t = 1
#pragma unroll
        for (int i = 0; i < R; ++i) {
          d[i] = 0.0;
          if (t0 + i < t1) {
            d[i] = step(a, b, last ? 1.0f : fr[t0 + i], rfs);
            acc += d[i];
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          d[i] = 0.0;
          if (t0 + i < t1) {
            d[i] = f0_over_fs(f0r, s0 + t0 + i, nhop_f, N, rfs, start);
            acc += d[i];
          }
        }
      }
    }
    // the runs' offsets in the hop: an inclusive scan over its L lanes,
    // by a tree fixed by the lane
    double incl = acc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, incl, o, L);
      if (o < L && r >= o) incl += u;
    }
    double p = __shfl_up_sync(0xffffffffu, incl, 1, L);
    if (r == 0) p = 0.0;
    const float w = __double2float_rn(
        __shfl_sync(0xffffffffu, incl, L - 1, L));
    if (j < H) {
      float* ph = part + hh * nhop;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (t0 + i < t1) {
          p += d[i];
          ph[t0 + i] = __double2float_rn(p);
        }
      }
    }
    if (r == 0) tots[hh] = j < H ? (double)(w - floorf(w)) : 0.0;
  }
  __syncthreads();
  if (warp == 0) {
    // the tile's exclusive prefix of its T hop totals: lane l sums hops
    // [l per, (l + 1) per) in order, per = ceil(T / 32), then the lanes by
    // a tree fixed by the lane; the tile's sum is published for the tiles
    // after it
    const int per = (T + 31) >> 5;
    double pre[kPasses], sl = 0.0;
#pragma unroll
    for (int q = 0; q < kPasses; ++q) {
      pre[q] = sl;
      if (q < per && lane * per + q < T) sl += tots[lane * per + q];
    }
    double in = sl;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, in, o);
      if (lane >= o) in += u;
    }
    double ex = __shfl_up_sync(0xffffffffu, in, 1);
    if (lane == 0) ex = 0.0;
    unsigned long long* rw = word + (int64_t)row * gridDim.x;
    if (lane == 31)
      *(volatile unsigned long long*)(rw + k) =
          (unsigned long long)__double_as_longlong(in) | (1ull << 63);
    // the tiles before this one: lane l sums tiles l, l + 32, ... in
    // order (waiting for each), then the lanes' sums by a fixed tree
    double c = 0.0;
    for (int i = lane; i < k; i += 32) {
      unsigned long long x;
      while ((x = *(volatile unsigned long long*)(rw + i)) == 0ull) {}
      c += __longlong_as_double((long long)(x & ~(1ull << 63)));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
    // the row's base joins its predecessors' sum (every sum here is exact
    // on analysis tracks, so its place in the order does not matter)
    if (base) c += base[row];
#pragma unroll
    for (int q = 0; q < kPasses; ++q) {
      if (q < per && lane * per + q < T) {
        const double o64 = c + (ex + pre[q]);
        ofs[lane * per + q] = (float)(o64 - floor(o64));
      }
    }
  }
  __syncthreads();
  // the tile's samples are consecutive: write them coalesced, each
  // sample's hop tracked by adding the stride's quotient and remainder
  const int64_t st = (int64_t)j0 * nhop;
  const int dh = kThreads / nhop, dt = kThreads - dh * nhop;
  int h = threadIdx.x / nhop, t = threadIdx.x - h * nhop;
  for (int e = threadIdx.x; e < (LLSM_SKIP_PASS_B ? 0 : T * nhop);
       e += kThreads) {
    if (st + e + 1 < nx) {
      const float cv = __fadd_rn(ofs[h], part[e]);
      outr[st + e + 1] = cv - floorf(cv);
    }
    h += dh;
    t += dt;
    if (t >= nhop) {
      t -= nhop;
      ++h;
    }
  }
  if (k == 0 && threadIdx.x == 0)
    outr[0] = base ? (float)(base[row] - floor(base[row])) : 0.0f;
}

template <int R>
cudaError_t launch(const float* f0, float* out, unsigned long long* word,
                   const double* base, int start, int B, int N, int nhop,
                   int H, float fs, int lg, cudaStream_t st) {
  const int T = kPasses * kWarps * (32 >> lg);
  const int tiles = (H + T - 1) / T;
  cudaError_t e = cudaMemsetAsync(
      word, 0, (size_t)B * tiles * sizeof(unsigned long long), st);
  if (e != cudaSuccess) return e;
  const size_t smem = (size_t)T * (sizeof(double) + sizeof(float)) +
                      ((size_t)T + kBinades) * nhop * sizeof(float);
  e = llsm::allow_smem(sample_cycles_kernel<R>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(tiles, B);
  sample_cycles_kernel<R><<<grid, kThreads, smem, st>>>(
      f0, out, word, base, start, N, nhop, H, fs, lg);
  return cudaGetLastError();
}

// lanes a hop: the fewest (at least kWarps, so a tile has at most 128
// hops) that keep a run within 10 samples
int lanes_log2(int nhop) {
  int lg = 0;
  while ((1 << lg) < kWarps) ++lg;
  while (lg < 5 && (nhop + (1 << lg) - 1) >> lg > 10) ++lg;
  return lg;
}

// ---------------------------------------------------------------------------
// Past a 512-sample hop (48 kHz at a 20 ms hop is 960; at most 2048) the
// kernel above would give a lane runs of 32 or 64 dependent steps and a block
// a per-binade fraction table of (T + 8) nhop floats (~92 KB at hop 960: two
// blocks an SM).  Here a hop's samples go over P = 64 or 128 lanes (two or
// four warps), each a run of at most kLongRun consecutive samples, a multiple
// of 4; the in-hop scan runs within each warp, then adds the sums of the
// hop's warps before it (through shared memory, in warp order); kLongPasses
// passes of G = kLongThreads / P hops make a tile of T = 8 or 4 hops a block.
// The fractions of s / nhop come from a table in device memory, one row of
// np4 floats a binade of the hop index (the 16 binades whose samples lie
// below 2^24 at nhop > 512), written with the tile words' zeroing by
// sample_cycles_prep and read as 16-byte vectors, so a block's
// shared memory holds only its tile's partials (a hop's row padded by 4
// floats every 32, so the runs' 16-byte stores do not collide: ~35 KB); the
// steps stay float32 values in registers, five blocks an SM.  Every sum is
// the kernel above's on analysis tracks (exact, whatever the partition), and
// the hop offsets, the look-back and the output pass are its own, so it gives
// its bits there.
constexpr int kLongThreads = 256;
constexpr int kLongBlocks = 5;     // blocks an SM: 51 registers a thread
constexpr int kLongRun = 16;       // samples a lane at most, a multiple of 4
constexpr int kLongPasses = 2;
constexpr int kTableBinades = 16;  // binades of j with j nhop < 2^24

// lanes a hop past 512 samples, as log2: the fewest (two warps at least)
// that keep a run within kLongRun samples
int long_lanes_log2(int nhop) {
  int lg = 6;
  while ((nhop + (1 << lg) - 1) >> lg > kLongRun) ++lg;
  return lg;
}

// samples a lane: ceil(nhop / P) rounded up to a multiple of 4
int long_run(int nhop) {
  const int P = 1 << long_lanes_log2(nhop);
  return ((nhop + P - 1) / P + 3) / 4 * 4;
}

int long_tile(int nhop) {
  return kLongPasses * (kLongThreads >> long_lanes_log2(nhop));
}

// a hop's partials in shared memory: 32 samples, then 4 floats of padding
__device__ __forceinline__ int long_slot(int t) { return t + (t >> 5) * 4; }

// zeroes the nw tile words and writes the fraction table: row c, entry t
// = fl(jc + t / nhop) - jc, jc = 2^(c - 1) (0 for c = 0), where jc nhop + t
// < 2^24 (0 elsewhere and in the padding)
__global__ void sample_cycles_prep(unsigned long long* __restrict__ word,
                                   int nw, float* __restrict__ frac, int nhop,
                                   int np4) {
  const float nhop_f = (float)nhop;
  const int n = max(nw, kTableBinades * np4);
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    if (e < nw) word[e] = 0ull;
    if (e < kTableBinades * np4) {
      const int c = e / np4, t = e - c * np4;
      const int jc = c ? 1 << (c - 1) : 0;
      float v = 0.0f;
      if (t < nhop && (int64_t)jc * nhop + t < kExact)
        v = __fadd_rn(__fdiv_rn((float)(jc * nhop + t), nhop_f),
                      -(float)jc);
      frac[e] = v;
    }
  }
}

__global__ void __launch_bounds__(kLongThreads, kLongBlocks)
sample_cycles_long_kernel(const float* __restrict__ f0,
                          float* __restrict__ out,
                          unsigned long long* __restrict__ word,
                          const float* __restrict__ frac, int np4,
                          const double* __restrict__ base, int start, int N,
                          int nhop, int H, float fs, int lgP, int run) {
  extern __shared__ double smem[];
  const int P = 1 << lgP, G = kLongThreads >> lgP, T = kLongPasses * G;
  const int W = P >> 5;                         // warps a hop
  const int PS = ((nhop + 31) >> 5) * 36;       // a hop's row of partials
  double* tots = smem;                          // [T] totals mod 1
  double* wsum = tots + T;                      // [kLongPasses, G, W]
  float* ofs = reinterpret_cast<float*>(wsum + kLongPasses * G * W);  // [T]
  float* part = ofs + (T + 3) / 4 * 4;          // [T, PS], 16-byte aligned
  const int row = blockIdx.y, k = blockIdx.x;
  const int j0 = k * T;
  const float* f0r = f0 + (int64_t)row * N;
  const int64_t nx = (int64_t)H * nhop;
  float* outr = out + (int64_t)row * nx;
  const float nhop_f = (float)nhop;
  const double rfs = __drcp_rn((double)fs);
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> lgP, r = threadIdx.x & (P - 1), wh = r >> 5;
  const int t0 = min(r * run, nhop), t1 = min(t0 + run, nhop);
  for (int pass = 0; pass < kLongPasses; ++pass) {
    const int hh = pass * G + g, j = j0 + hh;
    float d[kLongRun];                  // the steps, float32 values
    double acc = 0.0;
#pragma unroll
    for (int i = 0; i < kLongRun; ++i) d[i] = 0.0f;
    if (j < H) {
      const int64_t s0 = (int64_t)(start + j) * nhop;
      if (s0 >= 0 && s0 + nhop <= kExact) {
        const int i0 = min(j, N - 2);
        const float a = fmaxf(__ldg(f0r + i0), 0.0f);
        const float b = fmaxf(__ldg(f0r + i0 + 1), 0.0f);
        const float* fr = frac + binade(start + j) * np4 + t0;
        const bool last = j >= N - 1;           // pos >= N - 1: t = 1
#pragma unroll
        for (int q = 0; q < kLongRun / 4; ++q) {
          if (t0 + 4 * q < t1) {
            const float4 u = __ldg(reinterpret_cast<const float4*>(fr) + q);
            const float tv[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              if (t0 + 4 * q + m < t1) {
                d[4 * q + m] = step(a, b, last ? 1.0f : tv[m], rfs);
                acc += d[4 * q + m];
              }
            }
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kLongRun; ++i) {
          if (t0 + i < t1) {
            d[i] = f0_over_fs(f0r, s0 + t0 + i, nhop_f, N, rfs, start);
            acc += d[i];
          }
        }
      }
    }
    // the runs' offsets in the hop: a scan within each warp by a tree
    // fixed by the lane, then the sums of the hop's warps before it, in
    // warp order
    double incl = acc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    double p = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) p = 0.0;
    double* ws = wsum + (pass * G + g) * W;
    if (lane == 31) ws[wh] = incl;
    __syncthreads();
    double tot = ws[0];
    for (int v = 1; v < W; ++v) tot += ws[v];
    double woff = 0.0;
    for (int v = 0; v < wh; ++v) woff += ws[v];
    if (wh) p += woff;
    if (j < H) {
      float* ph = part + hh * PS;
#pragma unroll
      for (int q = 0; q < kLongRun / 4; ++q) {
        if (t0 + 4 * q < t1) {
          float v[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            p += d[4 * q + m];
            v[m] = __double2float_rn(p);
          }
          *reinterpret_cast<float4*>(ph + long_slot(t0 + 4 * q)) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    if (r == 0) {
      const float w = __double2float_rn(tot);
      tots[hh] = j < H ? (double)(w - floorf(w)) : 0.0;
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    // the tile's exclusive prefix of its T <= 32 hop totals (a lane a hop,
    // then the lanes by a tree fixed by the lane); the tile's sum is
    // published for the tiles after it
    const double sl = lane < T ? tots[lane] : 0.0;
    double in = sl;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, in, o);
      if (lane >= o) in += u;
    }
    double ex = __shfl_up_sync(0xffffffffu, in, 1);
    if (lane == 0) ex = 0.0;
    unsigned long long* rw = word + (int64_t)row * gridDim.x;
    if (lane == 31)
      *(volatile unsigned long long*)(rw + k) =
          (unsigned long long)__double_as_longlong(in) | (1ull << 63);
    // the tiles before this one: lane l sums tiles l, l + 32, ... in
    // order (waiting for each), then the lanes' sums by a fixed tree
    double c = 0.0;
    for (int i = lane; i < k; i += 32) {
      unsigned long long x;
      while ((x = *(volatile unsigned long long*)(rw + i)) == 0ull) {}
      c += __longlong_as_double((long long)(x & ~(1ull << 63)));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
    if (base) c += base[row];
    if (lane < T) {
      const double o64 = c + ex;
      ofs[lane] = (float)(o64 - floor(o64));
    }
  }
  __syncthreads();
  // the tile's samples are consecutive: write them coalesced, each
  // sample's hop tracked by adding the stride's quotient and remainder
  const int64_t st = (int64_t)j0 * nhop;
  const int dh = kLongThreads / nhop, dt = kLongThreads - dh * nhop;
  int h = threadIdx.x / nhop, t = threadIdx.x - h * nhop;
  for (int e = threadIdx.x; e < (LLSM_SKIP_PASS_B ? 0 : T * nhop);
       e += kLongThreads) {
    if (st + e + 1 < nx) {
      const float cv = __fadd_rn(ofs[h], part[h * PS + long_slot(t)]);
      outr[st + e + 1] = cv - floorf(cv);
    }
    h += dh;
    t += dt;
    if (t >= nhop) {
      t -= nhop;
      ++h;
    }
  }
  if (k == 0 && threadIdx.x == 0)
    outr[0] = base ? (float)(base[row] - floor(base[row])) : 0.0f;
}

// the fraction table's floats a row: nhop rounded up to 16 bytes
int long_np4(int nhop) { return (nhop + 3) / 4 * 4; }

// tile words and the table (16-byte aligned after them) as 8-byte words
int long_words(int B, int nhop, int H) {
  const int T = long_tile(nhop);
  return B * ((H + T - 1) / T) + kTableBinades * long_np4(nhop) / 2 + 2;
}

cudaError_t launch_long(const float* f0, float* out, unsigned long long* word,
                        const double* base, int start, int B, int N, int nhop,
                        int H, float fs, cudaStream_t st) {
  const int lgP = long_lanes_log2(nhop), T = long_tile(nhop);
  const int tiles = (H + T - 1) / T, nw = B * tiles, np4 = long_np4(nhop);
  float* frac = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(word + nw) + 15) & ~uintptr_t(15));
  const int n = max(nw, kTableBinades * np4);
  const int blocks = n < 1024 * 256 ? (n + 255) / 256 : 1024;
  sample_cycles_prep<<<blocks, 256, 0, st>>>(
      word, nw, frac, nhop, np4);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int G = kLongThreads >> lgP, W = (1 << lgP) >> 5;
  const size_t smem = (size_t)T * sizeof(double) +
                      (size_t)kLongPasses * G * W * sizeof(double) +
                      (size_t)(T + 3) / 4 * 4 * sizeof(float) +
                      (size_t)T * ((nhop + 31) / 32 * 36) * sizeof(float);
  e = llsm::allow_smem(sample_cycles_long_kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(tiles, B);
  sample_cycles_long_kernel<<<grid, kLongThreads, smem, st>>>(
      f0, out, word, frac, np4, base, start, N, nhop, H, fs, lgP,
      long_run(nhop));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Past a 2048-sample hop the long-hop kernel would need more than its 256
// lanes a hop or runs past kLongRun, and its tile's partials grow with the
// hop.  Here, after sample_cycles_prep (a word a hop of each row, zeroed,
// and the long kernel's fraction table), one launch: a block of
// kHopThreads lanes takes one hop, a lane a run of ceil(nhop /
// kHopThreads) consecutive samples.
//   - Steps: each evaluated once (the fraction table below 2^24 samples,
//     the plain version's division past it, as the long kernel does), the
//     block's threads on consecutive samples, kHopBatch of a thread's
//     table reads in flight together, into shared memory [nhop] floats;
//     a lane then sums its run's in float64.
//   - In-hop sums: each warp's tree over its lanes, then the warps in order
//     (hop_scan), give each run its offset and the hop's total; the run's
//     float32 partials replace its steps in shared memory, and the block
//     publishes the hop's total mod 1 in its word (sign bit set).
//   - Hop offset: warp 0 sums the row's hops before it as they are
//     published, lane l hops l, l + 32, ... in order (kHopLook of a lane's
//     words read at once, then each waited for in turn), then a fixed xor
//     tree, then the base.  Block (x, y) is hop x of row y; blocks start
//     in linear order, so every hop it waits for has started.
//   - Output: the hop's samples written coalesced from shared memory.
// A hop whose steps overflow the block's shared memory (past ~58000
// samples) evaluates them again in the output pass instead (stash = 0).
//
// Exactness at long hops: a float64 running sum of float32 values is exact
// while every partial stays below 2^29 times the smallest nonzero value
// added (each float32 value is a multiple of 2^-24 of itself; float64
// holds 53 bits).  Between two voiced frames a step is at least f0_floor /
// fs and a hop's partials at most f0_max nhop / fs: a ratio of (f0_max /
// f0_floor) nhop, ~3e5 at 96 kHz with a 19200 hop.  At a voicing edge the
// lerp starts from 0: the smallest step is ~f0 / (nhop fs) and the hop's
// sum ~f0 nhop / (2 fs), a ratio of nhop^2 / 2, under 2^29 for nhop <
// 32768 (1.8e8 at 19200).  So on analysis tracks the in-hop sums stay
// exact to hop 32767 and the kernel keeps the plain version's CPU bits;
// elsewhere the orders part in the float64 sums' last bits, which moves a
// float32 partial by at most one ulp of the hop's largest partial
// (2^-16 cycles at 200 cycles a hop: 1 kHz at 96 kHz over 19200 samples).
constexpr int kHopThreads = 256;
constexpr int kHopStashMax = 232448 - 1024;   // a hop's steps' bytes, at most
constexpr int kHopBatch = 8;                  // a thread's step reads at once
constexpr int kHopLook = 8;                   // a lane's words read at once

// the hop's exclusive prefix of lane r's run and its total: a scan in each
// warp by a tree fixed by the lane, then the sums of the warps before it,
// in warp order (ws: the warps' sums, kHopThreads / 32 doubles)
__device__ __forceinline__ double hop_scan(double acc, double* ws,
                                           double* tot) {
  const int lane = threadIdx.x & 31, wh = threadIdx.x >> 5;
  double incl = acc;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  double p = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) p = 0.0;
  if (lane == 31) ws[wh] = incl;
  __syncthreads();
  double t = ws[0];
  for (int v = 1; v < kHopThreads / 32; ++v) t += ws[v];
  *tot = t;
  double woff = 0.0;
  for (int v = 0; v < wh; ++v) woff += ws[v];
  return wh ? p + woff : p;
}

// the position fraction of sample t of hop j below 2^24 samples (t = 1 at
// and past the last frame), and F0 over fs there
struct HopSteps {
  bool table, last;
  float a, b;
  const float* fr;
  const float* f0r;
  int64_t s0;
  float nhop_f;
  int N, start;
  double rfs;
  __device__ __forceinline__ float frac(int t) const {
    return last ? 1.0f : __ldg(fr + t);
  }
  __device__ __forceinline__ double at(float ft, int t) const {
    return table ? step(a, b, ft, rfs)
                 : f0_over_fs(f0r, s0 + t, nhop_f, N, rfs, start);
  }
};

__global__ void __launch_bounds__(kHopThreads)
sample_cycles_hop_kernel(const float* __restrict__ f0,
                         float* __restrict__ out,
                         unsigned long long* __restrict__ word,
                         const float* __restrict__ frac, int np4,
                         const double* __restrict__ base, int start, int N,
                         int nhop, int H, float fs, int run, int stash) {
  extern __shared__ float part[];               // [nhop]: steps, partials
  __shared__ double ws[kHopThreads / 32];
  __shared__ float ofs;
  const int j = blockIdx.x, row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const float* f0r = f0 + (int64_t)row * N;
  const int64_t nx = (int64_t)H * nhop;
  float* outr = out + (int64_t)row * nx;
  const int t0 = min((int)threadIdx.x * run, nhop), t1 = min(t0 + run, nhop);
  unsigned long long* rw = word + (int64_t)row * H;
  HopSteps hs;
  hs.f0r = f0r;
  hs.nhop_f = (float)nhop;
  hs.N = N;
  hs.start = start;
  hs.rfs = __drcp_rn((double)fs);
  hs.s0 = (int64_t)(start + j) * nhop;
  hs.table = hs.s0 >= 0 && hs.s0 + nhop <= kExact;
  const int i0 = min(j, N - 2);
  hs.a = hs.table ? fmaxf(__ldg(f0r + i0), 0.0f) : 0.0f;
  hs.b = hs.table ? fmaxf(__ldg(f0r + i0 + 1), 0.0f) : 0.0f;
  hs.fr = frac + (hs.table ? binade(start + j) : 0) * np4;
  hs.last = j >= N - 1;                         // pos >= N - 1: t = 1
  double acc = 0.0;
  if (stash) {   // the steps coalesced, then each run's sum in order
    for (int tb = threadIdx.x; tb < nhop; tb += kHopBatch * kHopThreads) {
      float ft[kHopBatch];
#pragma unroll
      for (int u = 0; u < kHopBatch; ++u) {
        const int t = tb + u * kHopThreads;
        ft[u] = hs.table && t < nhop ? hs.frac(t) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kHopBatch; ++u) {
        const int t = tb + u * kHopThreads;
        if (t < nhop) part[t] = (float)hs.at(ft[u], t);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int t = t0; t < t1; ++t) acc += (double)part[t];
  } else {
    for (int t = t0; t < t1; ++t)
      acc += hs.at(hs.table ? hs.frac(t) : 0.0f, t);
  }
  double tot;
  double p = hop_scan(acc, ws, &tot);
  if (threadIdx.x < 32) {
    // publish the hop's total mod 1; then its offset: the row's totals
    // before it, lane l hops l, l + 32, ... in order (waiting for each),
    // then the lanes by a fixed tree, then the base
    if (lane == 0) {
      const float w = __double2float_rn(tot);
      *(volatile unsigned long long*)(rw + j) =
          (unsigned long long)__double_as_longlong((double)(w - floorf(w))) |
          (1ull << 63);
    }
    double c = 0.0;
    for (int ib = lane; ib < j; ib += 32 * kHopLook) {
      unsigned long long x[kHopLook];
#pragma unroll
      for (int u = 0; u < kHopLook; ++u) {
        const int i = ib + 32 * u;
        x[u] = i < j ? *(volatile unsigned long long*)(rw + i) : 0ull;
      }
#pragma unroll
      for (int u = 0; u < kHopLook; ++u) {
        const int i = ib + 32 * u;
        if (i < j) {
          while (x[u] == 0ull) x[u] = *(volatile unsigned long long*)(rw + i);
          c += __longlong_as_double((long long)(x[u] & ~(1ull << 63)));
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
    if (base) c += base[row];
    if (lane == 0) ofs = (float)(c - floor(c));
  }
  const int64_t o = (int64_t)j * nhop + 1;      // out[s + 1] = c[s]
  if (stash) {
    for (int t = t0; t < t1; ++t) {
      p += (double)part[t];
      part[t] = __double2float_rn(p);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < (LLSM_SKIP_PASS_B ? 0 : nhop);
         t += kHopThreads) {
      if (o + t < nx) {
        const float cv = __fadd_rn(ofs, part[t]);
        outr[o + t] = cv - floorf(cv);
      }
    }
  } else {
    __syncthreads();
    for (int t = t0; t < (LLSM_SKIP_PASS_B ? t0 : t1); ++t) {
      p += hs.at(hs.table ? hs.frac(t) : 0.0f, t);
      if (o + t < nx) {
        const float cv = __fadd_rn(ofs, __double2float_rn(p));
        outr[o + t] = cv - floorf(cv);
      }
    }
  }
  if (j == 0 && threadIdx.x == 0)
    outr[0] = base ? (float)(base[row] - floor(base[row])) : 0.0f;
}

// a hop's word of each row and the fraction table (16-byte aligned after
// them), as 8-byte words
int hop_words(int B, int nhop, int H) {
  return B * H + kTableBinades * long_np4(nhop) / 2 + 2;
}

cudaError_t launch_hop(const float* f0, float* out, unsigned long long* word,
                       const double* base, int start, int B, int N, int nhop,
                       int H, float fs, cudaStream_t st) {
  const int nw = B * H, np4 = long_np4(nhop);
  float* frac = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(word + nw) + 15) & ~uintptr_t(15));
  const int n = max(nw, kTableBinades * np4);
  const int blocks = n < 1024 * 256 ? (n + 255) / 256 : 1024;
  sample_cycles_prep<<<blocks, 256, 0, st>>>(word, nw, frac, nhop, np4);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int stash = (size_t)nhop * sizeof(float) <= kHopStashMax;
  const size_t smem = stash ? (size_t)nhop * sizeof(float) : 0;
  e = llsm::allow_smem(sample_cycles_hop_kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(H, B);
  sample_cycles_hop_kernel<<<grid, kHopThreads, smem, st>>>(
      f0, out, word, frac, np4, base, start, N, nhop, H, fs,
      (nhop + kHopThreads - 1) / kHopThreads, stash);
  return cudaGetLastError();
}

}  // namespace

// words the caller provides: one a tile of each row (llsm_sample_cycles
// zeroes them on its stream before the kernel); past a 512-sample hop the
// fraction table after them, and past 2048 a word a hop
extern "C" int llsm_sample_cycles_words(int B, int nhop, int nx) {
  if (B <= 0 || nhop <= 0 || nx <= 0) return 1;
  if (nhop > 2048) return hop_words(B, nhop, nx / nhop);
  if (nhop > 512) return long_words(B, nhop, nx / nhop);
  const int T = kPasses * kWarps * (32 >> lanes_log2(nhop));
  return B * ((nx / nhop + T - 1) / T);
}

extern "C" int llsm_sample_cycles(const float* f0, float* out,
                                  unsigned long long* word,
                                  const double* base, int start, int B,
                                  int N, int nhop, int nx, float fs,
                                  void* stream) {
  if (B <= 0 || nx <= 0) return (int)cudaGetLastError();
  if (N < 2 || nhop <= 0 || nx % nhop) return (int)cudaErrorInvalidValue;
  if (nhop > 2048)
    return (int)launch_hop(f0, out, word, base, start, B, N, nhop, nx / nhop,
                           fs, (cudaStream_t)stream);
  const int lg = lanes_log2(nhop);
  const int run = (nhop + (1 << lg) - 1) >> lg;
  const int H = nx / nhop;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  switch (run) {
#define LLSM_RUN(n)                                                        \
    case n:                                                                \
      e = launch<n>(f0, out, word, base, start, B, N, nhop, H, fs, lg, st); \
      break;
    LLSM_RUN(1) LLSM_RUN(2) LLSM_RUN(3) LLSM_RUN(4) LLSM_RUN(5) LLSM_RUN(6)
    LLSM_RUN(7) LLSM_RUN(8) LLSM_RUN(9) LLSM_RUN(10)
#undef LLSM_RUN
    default:
      // runs of up to 16 samples to nhop = 512; past it (48 kHz at a 20
      // ms hop) the long-hop kernel
      if (run <= 16)
        e = launch<16>(f0, out, word, base, start, B, N, nhop, H, fs, lg, st);
      else
        e = launch_long(f0, out, word, base, start, B, N, nhop, H, fs, st);
  }
  return (int)e;
}
