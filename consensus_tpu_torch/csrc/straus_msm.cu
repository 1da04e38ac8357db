// Shared-doubling Straus multi-scalar multiplication for the randomized
// Ed25519 batch verifier, for Hopper (sm_90a).
//
// Replaces the TPU kernel consensus_tpu/ops/pallas_scan.py::straus_msm (body
// _msm_kernel): the one point
//
//     sum_i [zk_i](-A_i) + sum_i [z_i](-R_i)
//                      = sum_w 16^(63 - w) * S_w,   S_w = sum_i c(w, i)
//
// over signed 4-bit windows, MSB first: c(w, i) is lane i's A entry
// [d](-A_i) for its zk digit d, plus its R entry in the last n_low windows
// (z < 2^128, so its high windows are all zero).  A lane whose digits are
// all 8 (d = 0) contributes the identity whatever its coordinates hold: that
// is how the engine masks padded and undecodable lanes.
//
// The result is the same group element as the plain torch version
// (consensus_tpu_torch/ops/scan_kernels.py::straus_msm_reference) but another
// projective representative: the tables are built by adds rather than by
// doublings, and the lanes are summed in this kernel's order (per window
// over the lanes of each chunk, then over the chunks, then a two-level
// Horner chain over the windows) rather than in the plain version's.
// Compare it in affine coordinates.
//
// What bounds it on this card: the latency of one serial chain, then
// products.  The 64 window sums S_w do not depend on each other, but their
// combination is serial: 16^63 S_0 alone takes 252 doubles in a row.  The
// products (about 750 k point adds at
// 8,192 lanes, 9 field multiplications of 25 64x64->128 products each) need
// about 0.03 ms over every SM; the bytes a tenth of that.  The first version
// (one block of 128 lanes per tile, a shared-memory halving tree per window,
// thread 0 doubling) ran about 110 serial field multiplications per window
// in each of 64 blocks and took 6.945 ms at 8,192 lanes.
//
// What the design does about it, in four kernels:
// 1. Tables (straus_msm_tables_kernel): one thread per (lane, point) builds
//    j * P for j = 1..8 by 7 sequential adds and writes them to a
//    scratch buffer in radix 2^51, one entry as 160 contiguous bytes
//    (16-byte accesses).  The identity entry is implicit.  At 8,192 lanes the
//    tables take 21 MB and stay in the 50 MB L2 for the next kernel; no
//    thread keeps a table in local memory.
// 2. Window sums (straus_msm_windows_kernel): a grid of (lane chunk,
//    window) blocks, so every SM has work.  Each thread walks its lanes of
//    the chunk strided by THREADS (coalesced digit reads), looks its entries
//    up (16-byte loads, X and T negated for d < 0), skips d = 0 and adds the
//    rest into a thread-local accumulator.  The block meets by a halving
//    tree in shared memory down to one warp, then a __shfl_xor_sync
//    butterfly, and writes one partial point per (window, chunk).
// 3. Join (straus_msm_join_kernel): one warp per window reduces its chunk
//    partials to S_w by a butterfly of log depth, on 64 SMs at once.
// 4. Chain (straus_msm_chain_kernel, one warp): sum_w 16^(63 - w) S_w by
//    Horner in two levels: each group of four lanes folds 8 windows, then
//    the 8 group sums are folded with 32 doubles each.  The 252 doubles stay
//    in a row, but the adds on that path fall from 63 to 14.  Each point
//    operation runs on four lanes: the four independent products of each
//    level of the double and the add (ed25519_field.cuh's dbl_stage1/2,
//    add_stage1/2, the stages ge_dbl and ge_add run role after role) go one
//    to a lane and __shfl_sync hands every lane all four.  That is 2
//    multiplication latencies per double and 3 per add instead of 7-8 and
//    10, 546 in all.  The chain inlines fe_mul (MUL_INLINE); the tables,
//    window sums and join add with ge_add on the out-of-line copy
//    (MUL_CALL).  Lanes 0..3 write X, Y, Z, T as canonical 8-bit limbs.
//
// Chip runs of this design (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py
// phase 6: CUDA events over 20 launches, per-kernel device times from
// torch.profiler): 0.816-0.822 ms at 8,192 lanes (tables 0.046, window sums
// 0.321, join 0.013, chain 0.381 ms) and 0.525-0.530 ms at 256 lanes (chain
// 0.372-0.392 ms), where the first version took 6.937 and 6.539 ms; with
// the stages in ed25519_field.cuh, 0.813-0.814 and 0.521-0.522 ms.  ptxas:
// 185 registers and a 104-byte stack frame for the tables, 168 for the
// window sums, 164 for the join, 130 for the chain, no spills.  The chain
// is now the largest part and bounds the narrow calls: one warp runs some
// 600 instructions per fe_mul, about 0.7 us a stage.
//
// Layout at the C boundary (batch trailing, limbs leading, as in the JAX
// package): eight (32, batch) float32 coordinates -A (X, Y, Z, T) then -R,
// weakly reduced; (64, batch) int32 zk digits and (n_low, batch) int32 z
// digits, stored as d + 8, MSB window first; an int64 scratch of
// straus_msm_scratch_words(batch, n_low) words; four (32, 1) float32 outputs.
//
// Everything above the __CUDACC__ line is __host__ __device__, so the host
// check compiles it with g++ and replays the four kernels' schedule.

#include "ed25519_field.cuh"

namespace {

constexpr int POINT_WORDS = 20;   // one ge: 4 coordinates x 5 limbs
constexpr int ENTRIES = TABLE - 1;  // j = 1..8; the identity is implicit
constexpr int SPAN = 8;             // windows per group of the chain
constexpr int GROUPS = WINDOWS / SPAN;  // groups of four lanes: a warp

struct msm_args {
  const float* a[4];   // -A: X, Y, Z, T, each (32, batch)
  const float* r[4];   // -R
  const int32_t* zk;   // (64, batch)
  const int32_t* z;    // (n_low, batch)
  long long batch;
  int n_low;
  u64* scratch;        // tables, (window, chunk) partial sums, window sums
};

// A point as 20 contiguous words (X limbs 0..4, Y, Z, T), read and written
// 16 bytes at a time on the device.
HD ge ge_read(const u64* p) {
  u64 w[POINT_WORDS];
#ifdef __CUDA_ARCH__
  const ulonglong2* s = reinterpret_cast<const ulonglong2*>(p);
#pragma unroll
  for (int i = 0; i < POINT_WORDS / 2; ++i) {
    const ulonglong2 x = s[i];
    w[2 * i] = x.x;
    w[2 * i + 1] = x.y;
  }
#else
  for (int i = 0; i < POINT_WORDS; ++i) w[i] = p[i];
#endif
  ge q;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    q.X.v[i] = w[i];
    q.Y.v[i] = w[5 + i];
    q.Z.v[i] = w[10 + i];
    q.T.v[i] = w[15 + i];
  }
  return q;
}

HD void ge_write(u64* p, const ge& q) {
  u64 w[POINT_WORDS];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    w[i] = q.X.v[i];
    w[5 + i] = q.Y.v[i];
    w[10 + i] = q.Z.v[i];
    w[15 + i] = q.T.v[i];
  }
#ifdef __CUDA_ARCH__
  ulonglong2* d = reinterpret_cast<ulonglong2*>(p);
#pragma unroll
  for (int i = 0; i < POINT_WORDS / 2; ++i) d[i] = make_ulonglong2(w[2 * i], w[2 * i + 1]);
#else
  for (int i = 0; i < POINT_WORDS; ++i) p[i] = w[i];
#endif
}

// --- scratch layout -----------------------------------------------------------
// Tables: point pt (0 = -A, 1 = -R; no R table when n_low = 0), lane, entry
// j - 1, as (points, batch, 8, 20) words.  Then the partial sums as
// (64, chunks, 20) words, then the window sums S_w as (64, 20) words.

HD int msm_points(int n_low) { return n_low > 0 ? 2 : 1; }

HD long long msm_chunks(long long batch, long long chunk) { return (batch + chunk - 1) / chunk; }

HD long long msm_table_words(long long batch, int n_low) {
  return msm_points(n_low) * batch * ENTRIES * POINT_WORDS;
}

HD long long msm_sums_offset(long long batch, int n_low, long long chunk) {
  return msm_table_words(batch, n_low) + WINDOWS * msm_chunks(batch, chunk) * POINT_WORDS;
}

HD long long msm_scratch_words(long long batch, int n_low, long long chunk) {
  return msm_sums_offset(batch, n_low, chunk) + WINDOWS * POINT_WORDS;
}

// Offset of partial (w, c) within the partial sums.
HD long long msm_slot(long long chunks, int w, long long c) { return (w * chunks + c) * POINT_WORDS; }

// --- stage 1: tables ----------------------------------------------------------

// Entries 1..8 of point pt of lane `lane`: p, then 7 sequential adds of p
// (as _msm_kernel builds them).
HD void msm_table(const msm_args& in, int pt, long long lane) {
  const float* const* c = pt ? in.r : in.a;
  const long long n = in.batch;
  const ge p = {fe_load(c[0] + lane, n), fe_load(c[1] + lane, n),
                fe_load(c[2] + lane, n), fe_load(c[3] + lane, n)};
  u64* out = in.scratch + (pt * n + lane) * ENTRIES * POINT_WORDS;
  ge cur = p;
  ge_write(out, cur);
  for (int j = 1; j < ENTRIES; ++j) {
    cur = ge_add(cur, p);
    ge_write(out + j * POINT_WORDS, cur);
  }
}

// --- stage 2: window sums -----------------------------------------------------

// [d] P for a digit stored as code = d + 8 with d != 0: entry |d| with X
// and T negated for d < 0.  A code outside [0, 16] is not a valid input; the
// clamp only keeps such a lane from reading outside its table.
HD ge msm_entry(const msm_args& in, int pt, long long lane, int code) {
  const int d = code - 8;
  int idx = d < 0 ? -d : d;
  idx = idx > ENTRIES ? ENTRIES : idx;
  ge q = ge_read(in.scratch + ((pt * in.batch + lane) * ENTRIES + idx - 1) * POINT_WORDS);
  if (d < 0) {
    q.X = fe_neg(q.X);
    q.T = fe_neg(q.T);
  }
  return q;
}

// Thread t's share of window w over the lanes [lo, hi) of one chunk: lanes
// lo + t, lo + t + threads, ...; each adds its A entry, and its R entry in
// the last n_low windows, skipping digits d = 0.
HD ge msm_thread_sum(const msm_args& in, int w, long long lo, long long hi, int t, int threads) {
  const int n_high = WINDOWS - in.n_low;
  ge acc = ge_identity();
  for (long long lane = lo + t; lane < hi; lane += threads) {
    const int a = in.zk[w * in.batch + lane];
    if (a != 8) acc = ge_add(acc, msm_entry(in, 0, lane, a));
    if (w >= n_high) {
      const int r = in.z[(w - n_high) * in.batch + lane];
      if (r != 8) acc = ge_add(acc, msm_entry(in, 1, lane, r));
    }
  }
  return acc;
}

// --- stage 3: join and chain --------------------------------------------------

// Lanes of the join's butterfly per window: the chunk count rounded up to a
// power of two, at most `warp`.
HD int msm_group(long long chunks, int warp) {
  int g = 1;
  while (g < chunks && g < warp) g <<= 1;
  return g;
}

// Lane j of a group of g: the sum of window w's partials j, j + g, ...
HD ge msm_window_share(const u64* partials, long long chunks, int w, int j, int g) {
  if (j >= chunks) return ge_identity();
  ge s = ge_read(partials + msm_slot(chunks, w, j));
  for (long long c = j + g; c < chunks; c += g) s = ge_add(s, ge_read(partials + msm_slot(chunks, w, c)));
  return s;
}

}  // namespace

#ifdef __CUDACC__

constexpr int WARP = 32;
constexpr int THREADS = 256;           // window-sum block; WARP times a power of two
constexpr int LANES_PER_THREAD = 8;
constexpr long long CHUNK = THREADS * LANES_PER_THREAD;  // lanes per window-sum block
constexpr int TABLE_THREADS = 128;

__device__ __forceinline__ ge ge_shfl_xor(const ge& p, int m) {
  ge q;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    q.X.v[i] = __shfl_xor_sync(FULL, (unsigned long long)p.X.v[i], m);
    q.Y.v[i] = __shfl_xor_sync(FULL, (unsigned long long)p.Y.v[i], m);
    q.Z.v[i] = __shfl_xor_sync(FULL, (unsigned long long)p.Z.v[i], m);
    q.T.v[i] = __shfl_xor_sync(FULL, (unsigned long long)p.T.v[i], m);
  }
  return q;
}

// Butterfly over aligned groups of `width` lanes (a power of two): lane 0
// of each group ends with the group's sum.  The whole warp must call it.
__device__ __forceinline__ ge warp_sum(ge acc, int width) {
  for (int m = width / 2; m > 0; m >>= 1) acc = ge_add(acc, ge_shfl_xor(acc, m));
  return acc;
}

// The chain's point operations on four lanes: the header's stages with fe_mul
// inlined, role lane & 3, fe_exchange4 handing every lane all four products.
__device__ __forceinline__ ge chain_dbl(const ge& p, int lane, bool need_t) {
  fe m[4], o[4];
  fe_exchange4(dbl_stage1<MUL_INLINE>(p, lane & 3), m, lane & ~3);
  fe_exchange4(dbl_stage2<MUL_INLINE>(p, m, lane & 3, need_t), o, lane & ~3);
  return ge{o[0], o[1], o[2], o[3]};
}

__device__ __forceinline__ ge chain_add(const ge& p, const ge& q, int lane) {
  fe m[4], o[4];
  const fe t1 = mul<MUL_INLINE>(p.T, fe_d2());
  fe_exchange4(add_stage1<MUL_INLINE>(p, t1, add_factor(q, lane & 3), lane & 3), m, lane & ~3);
  fe_exchange4(add_stage2<MUL_INLINE>(m, lane & 3), o, lane & ~3);
  return ge{o[0], o[1], o[2], o[3]};
}

__global__ void __launch_bounds__(TABLE_THREADS) straus_msm_tables_kernel(msm_args in) {
  const long long lane = (long long)blockIdx.x * TABLE_THREADS + threadIdx.x;
  if (lane < in.batch) msm_table(in, blockIdx.y, lane);
}

// Block (c, w): window w over the lanes of chunk c.  The threads' sums
// meet by a halving tree in shared memory down to one warp (the upper half
// of the remaining threads hands its sums to the lower half), then by a
// butterfly in that warp.
__global__ void __launch_bounds__(THREADS) straus_msm_windows_kernel(msm_args in, int chunks) {
  __shared__ __align__(16) u64 sh[THREADS / 2 * POINT_WORDS];
  const int t = threadIdx.x, c = blockIdx.x, w = blockIdx.y;
  const long long lo = c * CHUNK;
  const long long hi = lo + CHUNK < in.batch ? lo + CHUNK : in.batch;
  ge acc = msm_thread_sum(in, w, lo, hi, t, THREADS);
  for (int s = THREADS / 2; s >= WARP; s >>= 1) {
    if (t >= s && t < 2 * s) ge_write(sh + (t - s) * POINT_WORDS, acc);
    __syncthreads();
    if (t < s) acc = ge_add(acc, ge_read(sh + t * POINT_WORDS));
    __syncthreads();
  }
  if (t < WARP) {
    acc = warp_sum(acc, WARP);
    if (t == 0) ge_write(in.scratch + msm_table_words(in.batch, in.n_low) + msm_slot(chunks, w, c), acc);
  }
}

// Block w, one warp: S_w from window w's chunk partials, by a butterfly over
// the chunk count rounded up to a power of two (at most a warp; each lane
// first adds its partials j, j + 32, ... when there are more chunks).
__global__ void __launch_bounds__(WARP)
straus_msm_join_kernel(const u64* __restrict__ partials, int chunks, u64* __restrict__ sums) {
  const int lane = threadIdx.x, w = blockIdx.x;
  const int g = msm_group(chunks, WARP);
  const ge s = warp_sum(msm_window_share(partials, chunks, w, lane, g), g);
  if (lane == 0) ge_write(sums + w * POINT_WORDS, s);
}

__device__ __forceinline__ ge ge_shfl(const ge& p, int src) {
  return ge{fe_shfl(p.X, src), fe_shfl(p.Y, src), fe_shfl(p.Z, src), fe_shfl(p.T, src)};
}

// One warp, four lanes per point operation.  Group i (lanes 4i..4i+3) folds
// its SPAN windows by Horner, C_i = sum_k 16^(SPAN - 1 - k) S_(SPAN i + k);
// then every group runs acc = C_0, acc = 16^SPAN acc + C_i for i = 1..7.
// The critical path keeps its 252 doubles but has 14 adds instead of 63.
__global__ void __launch_bounds__(WARP)
straus_msm_chain_kernel(const u64* __restrict__ window_sums, float* __restrict__ ox,
                        float* __restrict__ oy, float* __restrict__ oz, float* __restrict__ ot) {
  static_assert(GROUPS * 4 == WARP, "one group of four lanes per SPAN windows");
  __shared__ __align__(16) u64 sums[WINDOWS * POINT_WORDS];
  const int lane = threadIdx.x;
  for (int i = lane; i < WINDOWS * POINT_WORDS / 2; i += WARP) {
    reinterpret_cast<ulonglong2*>(sums)[i] = reinterpret_cast<const ulonglong2*>(window_sums)[i];
  }
  __syncwarp();
  const u64* mine = sums + (lane / 4) * SPAN * POINT_WORDS;
  ge c = ge_read(mine);
  for (int k = 1; k < SPAN; ++k) {
#pragma unroll 1
    for (int d = 0; d < 4; ++d) c = chain_dbl(c, lane, d == 3);
    c = chain_add(c, ge_read(mine + k * POINT_WORDS), lane);
  }
  ge acc = ge_shfl(c, 0);
  for (int i = 1; i < GROUPS; ++i) {
#pragma unroll 1
    for (int d = 0; d < 4 * SPAN; ++d) acc = chain_dbl(acc, lane, d == 4 * SPAN - 1);
    acc = chain_add(acc, ge_shfl(c, 4 * i), lane);
  }
  if (lane < 4) {
    float* out = lane == 0 ? ox : lane == 1 ? oy : lane == 2 ? oz : ot;
    fe_store(out, 1, fe_pick(lane, acc.X, acc.Y, acc.Z, acc.T));
  }
}

// int64 words of the scratch buffer straus_msm_launch needs.
extern "C" long long straus_msm_scratch_words(long long batch, int n_low) {
  return msm_scratch_words(batch, n_low, CHUNK);
}

// Launches the four kernels on `stream` of CUDA device `device` and returns
// the first nonzero cudaGetLastError() (0 on success).
extern "C" int straus_msm_launch(const void* ax, const void* ay, const void* az,
                                 const void* at, const void* rx, const void* ry,
                                 const void* rz, const void* rt, const void* zk,
                                 const void* z, void* scratch, void* ox, void* oy,
                                 void* oz, void* ot, int batch, int n_low, int device,
                                 void* stream) {
  if (batch < 0 || n_low < 0 || n_low > WINDOWS) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  u64* const words = (u64*)scratch;
  const msm_args in = {
      {(const float*)ax, (const float*)ay, (const float*)az, (const float*)at},
      {(const float*)rx, (const float*)ry, (const float*)rz, (const float*)rt},
      (const int32_t*)zk, (const int32_t*)z, batch, n_low, words};
  const cudaStream_t s = (cudaStream_t)stream;
  const int chunks = (int)msm_chunks(batch, CHUNK);
  u64* const sums = words + msm_sums_offset(batch, n_low, CHUNK);
  if (batch > 0) {
    const dim3 tables((batch + TABLE_THREADS - 1) / TABLE_THREADS, msm_points(n_low));
    straus_msm_tables_kernel<<<tables, TABLE_THREADS, 0, s>>>(in);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    straus_msm_windows_kernel<<<dim3(chunks, WINDOWS), THREADS, 0, s>>>(in, chunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  straus_msm_join_kernel<<<WINDOWS, WARP, 0, s>>>(words + msm_table_words(batch, n_low), chunks, sums);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  straus_msm_chain_kernel<<<1, WARP, 0, s>>>(sums, (float*)ox, (float*)oy, (float*)oz, (float*)ot);
  return (int)cudaGetLastError();
}

extern "C" const char* straus_msm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
