// Trial alternative to consensus_tpu_torch/csrc/scalar25519.cu for
// scripts/e1_p1_trials.py: kernel L1's first design, one thread a lane (64 a
// block), Barrett reduction and a serial recoding carry, reading the
// challenge digest as 64 int32 byte rows (no canonical checks), kept to be
// timed beside the redesign in one call.  Its C entry point takes 8 pointers
// (the redesign's takes 12); its host replay is no longer run by the tests.
//
// The fused front end's scalar stage: scalars mod L and their signed window
// digits, for Hopper (sm_90a).
//
// Kernel L1 of the port.  It replaces no TPU kernel: the JAX package runs
// this stage on the device with plain XLA, fused into its jitted bodies
// (consensus_tpu/ops/scalar25519.py's reduce_bytes_mod_l, mul_mod_l,
// sum_mod_l and signed_window_digits, as consensus_tpu/models/fused.py
// calls them).  Run eagerly in torch (the plain versions,
// ops/scalar25519.py::scalar_challenge_reference and
// ::scalar_aggregate_reference), the stage is some four hundred small
// launches a wave: the carry passes and the recoding are Python loops of
// 32-64 steps.  L is the group order of edwards25519, 2^252 + delta.  By
// mode, per lane:
//   0 (challenge): k = digest mod L from the digest's little-endian byte
//                  rows (at most 64 bytes, the 512-bit SHA-512 range); writes
//                  k's 64 signed 4-bit window digits and/or k's 32 bytes;
//   1 (aggregate): from z (16 bytes), k (32) and, unless it is absent, s
//                  (32): the 64 digits of z k mod L and the 33 of z, and u =
//                  sum over the lanes of (z s mod L), mod L, as 32 bytes.
// Every value mod L is written canonically (bytes of the value in [0, L)),
// and a digit as d + 8, most significant window first, each digit in
// [-8, 7] carrying +1 into the next window from the least significant up
// (the top window takes the last carry): the plain version's outputs, which
// are unique, so the kernel is held to them at tolerance 0 whatever
// reduction it uses.
//
// What bounds it on this card: bytes.  A challenge lane reads 64 int32 byte
// rows and writes 64 int32 digits (512 bytes; 4.2 MB at the strict wave's
// 8,192 lanes, 1.3 us at 3.35 TB/s); an aggregate lane reads 80 and writes
// 97 (708 bytes).  The arithmetic is a few hundred 32x32->64-bit products a
// lane.  The plain version's time is its launches, not its work.
//
// What the design does: one thread a lane, 64 lanes a block, loads and
// stores coalesced (the byte rows are (rows, n) with the lanes adjacent).  A
// value is 32-bit words with 64-bit column sums (IMAD.WIDE on the card).
// Reduction mod L is Barrett's (Handbook of Applied Cryptography, 14.42,
// base 2^32, k = 8 words): for x < 2^512, q = ((x >> 224) mu) >> 288 with
// mu = floor(2^512 / L), r = x - q L mod 2^288, then at most two
// subtractions of L (0 <= r < 3L): 81 + 45 products, no division and no
// data-dependent loop.  The recoding is a serial carry over the 64 or 33
// nibbles in registers.  The aggregate sum is exact: each block sums its
// lanes' z s mod L word by word in 64-bit columns (a word below 2^32 on each
// of fewer than 2^31 lanes), warp shuffles then shared memory; a second,
// one-block launch adds the blocks' columns, carries them into a 512-bit
// value and reduces it.
//
// Layout at the C boundary (batch trailing): int32 byte rows (rows, n),
// element (i, lane) at i * n + lane, each a byte (the kernel reads the low 8
// bits): the digest (1-64 rows; mode 0), z (16), k (32) and s (32, or null;
// mode 1); int32 outputs: digits (64, n) and (33, n), bytes (32, n), u (32,
// 1); a null output is not written.  Mode 1 with s takes a scratch of one
// row of 8 uint64 a block.
//
// Everything above the __CUDACC__ line is __host__ __device__, so the same
// source compiles as plain C++ for the host check
// (tests/test_torch_scalar_kernel.py).

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD static inline
#endif

typedef uint32_t u32;
typedef uint64_t u64;

namespace {

constexpr int LANES = 64;  // lanes (threads) a block
constexpr int MODE_CHALLENGE = 0;
constexpr int MODE_AGGREGATE = 1;
constexpr int K_WINDOWS = 64;  // digits of a scalar below 2^253
constexpr int Z_WINDOWS = 33;  // digits of a 128-bit coefficient
constexpr int SUM_WORDS = 8;   // 64-bit column sums a block

// A value below 2^512 (wide) or 2^256 (scalar), little-endian 32-bit words.
struct wide {
  u32 w[16];
};

struct scalar {
  u32 w[8];
};

// L = 2^252 + 27742317777372353535851937790883648493, as 8 words.
HD u32 l_word(int i) {
  return i == 0 ? 0x5cf5d3edu : i == 1 ? 0x5812631au : i == 2 ? 0xa2f79cd6u
       : i == 3 ? 0x14def9deu : i == 7 ? 0x10000000u : 0u;
}

// mu = floor(2^512 / L), a 260-bit value, as 9 words.
HD u32 mu_word(int i) {
  return i == 0 ? 0x0a2c131bu : i == 1 ? 0xed9ce5a3u : i == 2 ? 0x086329a7u
       : i == 3 ? 0x2106215du : i == 4 ? 0xffffffebu : i == 8 ? 0x0000000fu : 0xffffffffu;
}

HD u64 mul_wide(u32 a, u32 b) { return (u64)a * (u64)b; }

HD scalar scalar_zero() {
  scalar s;
  for (int i = 0; i < 8; ++i) s.w[i] = 0;
  return s;
}

// The little-endian value of the low bytes of p[i * stride], i < rows (at
// most 64).
HD wide load_bytes(const int32_t* p, long long stride, int rows) {
  wide x;
  for (int j = 0; j < 16; ++j) x.w[j] = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i)
    if (i < rows) x.w[i >> 2] |= ((u32)p[i * stride] & 0xffu) << (8 * (i & 3));
  return x;
}

HD scalar low_words(const wide& x) {
  scalar s;
  for (int i = 0; i < 8; ++i) s.w[i] = x.w[i];
  return s;
}

// x mod L for any x < 2^512: Barrett's reduction (see the top of the file).
HD scalar reduce_wide(const wide& x) {
  // q2 = (x >> 224) mu, all 18 words; q3 = q2 >> 288 is words 9-17.
  u32 q2[18];
  for (int i = 0; i < 18; ++i) q2[i] = 0;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    u64 carry = 0;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const u64 t = mul_wide(x.w[7 + i], mu_word(j)) + q2[i + j] + carry;  // < 2^64
      q2[i + j] = (u32)t;
      carry = t >> 32;
    }
    q2[i + 9] = (u32)carry;
  }
  // r2 = q3 L mod 2^288: the 9 low words of the product.
  u32 r2[9];
  for (int i = 0; i < 9; ++i) r2[i] = 0;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    u64 carry = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (i + j >= 9) break;
      const u64 t = mul_wide(q2[9 + i], l_word(j)) + r2[i + j] + carry;
      r2[i + j] = (u32)t;
      carry = t >> 32;
    }
    if (i + 8 < 9) r2[i + 8] += (u32)carry;
  }
  // r = x - r2 mod 2^288, in [0, 3L).
  u32 r[9];
  u32 borrow = 0;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const u64 d = (u64)x.w[i] - r2[i] - borrow;
    r[i] = (u32)d;
    borrow = (u32)(d >> 63);
  }
  // Twice: r -= L where r >= L, without a branch.
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    u32 d[9];
    borrow = 0;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const u64 t = (u64)r[i] - (i < 8 ? l_word(i) : 0u) - borrow;
      d[i] = (u32)t;
      borrow = (u32)(t >> 63);
    }
    const bool ge = borrow == 0;
    for (int i = 0; i < 9; ++i) r[i] = ge ? d[i] : r[i];
  }
  scalar s;
  for (int i = 0; i < 8; ++i) s.w[i] = r[i];
  return s;
}

// a b for a, b < 2^256: the 512-bit schoolbook product, 64 products.
HD wide mul_scalars(const scalar& a, const scalar& b) {
  wide c;
  for (int i = 0; i < 16; ++i) c.w[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    u64 carry = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const u64 t = mul_wide(a.w[i], b.w[j]) + c.w[i + j] + carry;
      c.w[i + j] = (u32)t;
      carry = t >> 32;
    }
    c.w[i + 8] = (u32)carry;
  }
  return c;
}

// The WINDOWS signed 4-bit digits of s's nibbles (nibble i of s for i <
// 64; a window past them reads 0), stored as d + 8 at out[(WINDOWS - 1 - i)
// * stride] for window i: most significant first.  The carry leaves the
// top window.
template <int WINDOWS>
HD void store_digits(const scalar& s, int32_t* out, long long stride) {
  u32 carry = 0;
#pragma unroll
  for (int i = 0; i < WINDOWS; ++i) {
    const u32 nibble = i < 64 ? (s.w[(i >> 3) & 7] >> (4 * (i & 7))) & 0xfu : 0u;
    const int t = (int)(nibble + carry);
    const int over = t >= 8 ? 1 : 0;
    out[(long long)(WINDOWS - 1 - i) * stride] = t - 16 * over + 8;
    carry = (u32)over;
  }
}

// s's 32 little-endian bytes at out[i * stride].
HD void store_bytes(const scalar& s, int32_t* out, long long stride) {
#pragma unroll
  for (int i = 0; i < 32; ++i) out[i * stride] = (int32_t)((s.w[i >> 2] >> (8 * (i & 3))) & 0xffu);
}

// The kernel's arguments.
struct scalar_args {
  const int32_t* a;  // mode 0: the digest; mode 1: z
  const int32_t* b;  // mode 1: k
  const int32_t* c;  // mode 1: s, or null
  int32_t* d64;      // mode 0: k's digits; mode 1: z k's (or null in mode 0)
  int32_t* d33;      // mode 1: z's digits
  int32_t* bytes;    // mode 0: k's bytes (or null)
  int32_t* u;        // mode 1 with s: the sum's bytes
  u64* partials;     // mode 1 with s: SUM_WORDS column sums a block
  long long n;
  int mode, a_rows;
};

// The lane at column `lane`: writes its outputs and returns what it adds to
// the aggregate sum (z s mod L; zero where there is no sum).
HD scalar scalar_lane(const scalar_args& v, long long lane) {
  if (v.mode == MODE_CHALLENGE) {
    const scalar k = reduce_wide(load_bytes(v.a + lane, v.n, v.a_rows));
    if (v.d64) store_digits<K_WINDOWS>(k, v.d64 + lane, v.n);
    if (v.bytes) store_bytes(k, v.bytes + lane, v.n);
    return scalar_zero();
  }
  const scalar z = low_words(load_bytes(v.a + lane, v.n, 16));
  const scalar k = low_words(load_bytes(v.b + lane, v.n, 32));
  store_digits<K_WINDOWS>(reduce_wide(mul_scalars(z, k)), v.d64 + lane, v.n);
  store_digits<Z_WINDOWS>(z, v.d33 + lane, v.n);
  if (!v.c) return scalar_zero();
  return reduce_wide(mul_scalars(z, low_words(load_bytes(v.c + lane, v.n, 32))));
}

// The aggregate sum from its column sums (column j the sum of every lane's
// word j, below 2^63): carried into a value below 2^288 and reduced; its 32
// bytes at u[0 .. 31].
HD void sum_columns(const u64 cols[SUM_WORDS], int32_t* u) {
  wide x;
  for (int j = 0; j < 16; ++j) x.w[j] = 0;
  u64 carry = 0;
  for (int j = 0; j < SUM_WORDS; ++j) {
    const u64 t = cols[j] + carry;  // < 2^63 + 2^32
    x.w[j] = (u32)t;
    carry = t >> 32;
  }
  x.w[SUM_WORDS] = (u32)carry;
  x.w[SUM_WORDS + 1] = (u32)(carry >> 32);
  store_bytes(reduce_wide(x), u, 1);
}

}  // namespace

#ifdef __CUDACC__

constexpr int SUM_THREADS = 256;  // the sum's one block: 32 rows of 8 columns
static_assert(LANES % 32 == 0 && SUM_THREADS % SUM_WORDS == 0, "whole warps");

// One kernel a mode: with the mode a constant each holds one mode's code,
// which keeps it out of local memory (one kernel for both spilled 8 bytes).
template <int MODE>
__global__ void __launch_bounds__(LANES) scalar25519_kernel(scalar_args v) {
  v.mode = MODE;
  const long long lane = (long long)blockIdx.x * LANES + threadIdx.x;
  scalar s = scalar_zero();
  if (lane < v.n) s = scalar_lane(v, lane);
  if (!v.partials) return;  // the same on every thread of the launch
  __shared__ u64 warp_sums[LANES / 32][SUM_WORDS];
#pragma unroll
  for (int j = 0; j < SUM_WORDS; ++j) {
    u64 x = s.w[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32][j] = x;
  }
  __syncthreads();
  if (threadIdx.x < SUM_WORDS) {
    u64 t = 0;
    for (int w = 0; w < LANES / 32; ++w) t += warp_sums[w][threadIdx.x];
    v.partials[(long long)blockIdx.x * SUM_WORDS + threadIdx.x] = t;
  }
}

__global__ void __launch_bounds__(SUM_THREADS)
scalar25519_sum_kernel(const u64* __restrict__ partials, int blocks, int32_t* __restrict__ u) {
  constexpr int ROWS = SUM_THREADS / SUM_WORDS;
  __shared__ u64 rows[ROWS][SUM_WORDS];
  __shared__ u64 cols[SUM_WORDS];
  const int col = threadIdx.x % SUM_WORDS, row = threadIdx.x / SUM_WORDS;
  u64 t = 0;
  for (int b = row; b < blocks; b += ROWS) t += partials[(long long)b * SUM_WORDS + col];
  rows[row][col] = t;
  __syncthreads();
  if (threadIdx.x < SUM_WORDS) {
    u64 c = 0;
    for (int r = 0; r < ROWS; ++r) c += rows[r][threadIdx.x];
    cols[threadIdx.x] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) sum_columns(cols, u);
}

// Launches on `stream` of CUDA device `device` and returns the launch's
// cudaGetLastError() (0 on success).  Mode 1 with s launches the lanes, then
// the one-block sum over their blocks' column sums; `partials` holds a row
// of SUM_WORDS uint64 for each block of LANES lanes.
extern "C" int scalar25519_launch(const void* a, const void* b, const void* c, void* d64,
                                  void* d33, void* bytes, void* u, void* partials, int n,
                                  int mode, int a_rows, int device, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (mode == MODE_CHALLENGE) {
    if (!a || a_rows < 1 || a_rows > 64 || (!d64 && !bytes) || c || u || partials)
      return (int)cudaErrorInvalidValue;
  } else if (mode == MODE_AGGREGATE) {
    if (!a || !b || !d64 || !d33 || bytes || (c ? !(u && partials) : (u || partials)))
      return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + LANES - 1) / LANES;
  const scalar_args v = {(const int32_t*)a, (const int32_t*)b, (const int32_t*)c,
                         (int32_t*)d64, (int32_t*)d33, (int32_t*)bytes, (int32_t*)u,
                         (u64*)partials, (long long)n, mode, mode == MODE_CHALLENGE ? a_rows : 16};
  if (blocks > 0) {
    if (mode == MODE_CHALLENGE)
      scalar25519_kernel<MODE_CHALLENGE><<<blocks, LANES, 0, (cudaStream_t)stream>>>(v);
    else
      scalar25519_kernel<MODE_AGGREGATE><<<blocks, LANES, 0, (cudaStream_t)stream>>>(v);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (c) {
    scalar25519_sum_kernel<<<1, SUM_THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)partials, blocks, (int32_t*)u);
    err = cudaGetLastError();
  }
  return (int)err;
}

extern "C" const char* scalar25519_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
