// Trial variant of kernel L1 (consensus_tpu_torch/csrc/scalar25519.cu): a
// group of 8 threads a lane instead of 4, with the aggregate mode's two
// products each formed whole on every role of its half.  Kept for the group
// size's trial (scripts/e1_p1_trials.py, named on its command line); the
// port builds csrc's 4-thread design.  Same C entry point as csrc's.
//
// The fused front end's scalar stage: scalars mod L, their signed window
// digits and the strict body's canonical checks, for Hopper (sm_90a).
//
// Kernel L1 of the port.  It replaces no TPU kernel: the JAX package runs
// this stage on the device with plain XLA, fused into its jitted bodies
// (consensus_tpu/ops/scalar25519.py's reduce_bytes_mod_l, mul_mod_l,
// sum_mod_l, signed_window_digits and lt_l, and field25519's bytes_lt_p, as
// consensus_tpu/models/fused.py calls them).  Run eagerly in torch (the plain
// versions, ops/scalar25519.py::scalar_challenge_reference,
// ::scalar_challenge_checked_reference and ::scalar_aggregate_reference), the
// stage is some four hundred small launches a wave.  L is the group order of
// edwards25519, 2^252 + delta.  By mode, per lane:
//   0 (challenge): k = H mod L, H the SHA-512 digest read either from kernel
//                  S1's state words (8, 2, n) (each word big-endian, hi half
//                  first, as ops/sha512.py::digest_bytes orders the digest's
//                  bytes) or from little-endian byte rows (1-64 rows); writes
//                  k's 64 signed 4-bit window digits and/or its 32 bytes; with
//                  the signature and key rows, also ok = host_ok and S < L and
//                  y_R < p and y_A < p (each y with its sign bit masked), the
//                  fused strict body's canonical checks;
//   1 (aggregate): from z (16 bytes), k (32) and, unless it is absent, s
//                  (32): the 64 digits of z k mod L and the 33 of z, and u =
//                  sum over the lanes of (z s mod L), mod L, as 32 bytes.
// Every value mod L is written canonically, and a digit as d + 8, most
// significant window first, each digit in [-8, 7]: the plain version's
// outputs, which are unique, so the kernel is held to them at tolerance 0.
//
// What bounds it on this card: bytes.  A challenge lane of the strict body
// reads 64 state bytes, 96 signature and key bytes and host_ok, and writes
// 64 int32 digits and ok: 418 bytes, 3.4 MB at the strict wave's 8,192 lanes,
// 1.0 us at 3.35 TB/s (the first design read the digest as 64 int32 byte rows
// and left the checks to some 35 eager launches: 512 bytes a lane).  An
// aggregate lane reads 80 int32 byte rows and writes 97 digits (708 bytes).
// The arithmetic is under a hundred 32x32->64-bit products a lane.  At 8,192
// lanes the bound lies below what one launch takes, so the time that is left
// is one lane's latency: the first design (one thread a lane, 64 lanes a
// block: 128 blocks, two warps an SM) ran 81 + 45 dependent products of a
// Barrett reduction and a 64-step serial carry for the digits on one thread.
//
// What the design does:
// - A group of G threads a lane (G = 8 in this variant), 16
//   lanes a block in challenge mode: 512 blocks at 8,192 lanes, 4-8 warps
//   an SM (64 lanes a block in aggregate mode: the same warps an SM, a
//   quarter of the blocks' sums).  Every thread of a warp runs the same code;
//   a group past the batch loads and stores nothing but takes part in the
//   shuffles.
// - The reduction is a fold, not a quotient: with R_m = 2^(32m) mod L (a
//   table), H = sum of its words H_m 2^(32m) == H_low + sum_{m >= 8} H_m R_m
//   (mod L).  The rows H_m R_m are split over the roles, each role loading its
//   own words (role r rows 8 + r + G i; role 0 also the low 8 words), each
//   row 8 products into a 10-word sum in one frame of columns, so the group
//   joins its sums by G - 1 xor shuffles a word (a butterfly, every role
//   ending with the total, below 2^289).  Then every role folds at bit 252
//   (2^252 == -delta): y == lo + L - h delta, in (0, 2L), 8 products and one
//   subtraction of L selected without a branch.  No data-dependent loop.
// - Aggregate mode: the two products z k and z s go to the two halves of the
//   group (z k again where there is no s), each half splitting its product's
//   fold rows the same way and joining them over its G / 2 roles.
// - The recoding has no carry chain: over W windows the digits of a scalar s
//   are the nibbles of s + sum_{j<W} 8 16^j, each less 8 (the digit set
//   [-8, 7] is a complete residue system mod 16, so the recoding is unique;
//   k and z k mod L lie below 2^253 over 64 windows, z below 2^128 over 33,
//   so the sum leaves no carry).  After that one addition each role writes
//   its nibbles: its share of the digit rows (bytes likewise).
// - The checks: role r compares words r + G i of S, y_R and y_A with L's and
//   p's, the group ORs its bit masks of words below and above by shuffles,
//   and a value is below its bound where its mask of words below exceeds its
//   mask of words above (the most significant differing word decides).
// - The aggregate sum stays exact: each block sums its lanes' z s mod L word
//   by word in 64-bit columns (shuffles over the warp's groups, then shared
//   memory); a second, one-block kernel of the same C launch adds the blocks'
//   columns, carries them into a value below 2^289 and folds it.
// On an NVIDIA H100 80GB HBM3 at 700.00 W, launches replayed from a CUDA
// graph (scripts/e1_p1_trials.py, both designs in one call): at 8,192 lanes
// the strict body's challenge with the checks took 0.0034 ms, its digits
// alone 0.0027 and the aggregate body's bytes 0.0025, where the first design
// took 0.0055 and 0.0050 (no checks); one lane 0.0026 (first: 0.0039); 8
// threads a lane 0.0047 with the checks; an empty kernel 0.0010.  The
// aggregate with s took 0.0067 (first: 0.0068).  Without s it is slower
// than the first design, 0.0046 against 0.0036: each half of a group loads
// its product's rows and forms the whole product on every role.
//
// Layout at the C boundary (batch trailing): the state (8, 2, n) int32 or
// int32 byte rows (rows, n), element (i, lane) at i * n + lane, each a byte
// (the kernel reads the low 8 bits): z (16), k (32) and s (32, or null; mode
// 1); the signature (64, n) and key (32, n) rows as uint8, host_ok and ok as
// (n,) bytes (torch.bool), all four or none (mode 0); int32 outputs: digits
// (64, n) and (33, n), bytes (32, n), u (32, 1); a null output is not
// written.  Mode 1 with s takes a scratch of one row of 8 uint64 a block.
//
// Everything above the __CUDACC__ line is __host__ __device__, so the same
// source compiles as plain C++ for the host check, a lane's group run role by
// role on one thread (csrc's design is so checked in
// tests/test_torch_scalar_kernel.py).

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#define HD_MEMBER __host__ __device__ __forceinline__
#else
#define HD static inline
#define HD_MEMBER inline
#endif

#define L1_GROUP 8

typedef uint32_t u32;
typedef uint64_t u64;

namespace {

constexpr int G = L1_GROUP;     // threads (roles) a lane
constexpr int HALF = G / 2;     // roles a product in aggregate mode
constexpr int MODE_CHALLENGE = 0;
constexpr int MODE_AGGREGATE = 1;
constexpr int K_WINDOWS = 64;   // digits of a scalar below 2^253
constexpr int Z_WINDOWS = 33;   // digits of a 128-bit coefficient
constexpr int SUM_WORDS = 8;    // 64-bit column sums a block
constexpr int FOLD_WORDS = 10;  // a fold's sums: below 2^289
static_assert(G == 4 || G == 8, "a lane's group is 4 or 8 threads");

// Lanes (groups) a block: 16 in challenge mode, so that mid-sized batches
// spread over many SMs; 64 in aggregate mode (the same warps an SM at 8,192
// lanes), so that the sum kernel has a quarter of the blocks' column sums to
// add.
HD constexpr int lanes_a_block(int mode) { return mode == MODE_AGGREGATE ? 64 : 16; }

// A value below 2^256, little-endian 32-bit words.
struct scalar {
  u32 w[8];
};

// L = 2^252 + delta, delta = 27742317777372353535851937790883648493, as 8
// words (delta is words 0-3).
HD u32 l_word(int i) {
  return i == 0 ? 0x5cf5d3edu : i == 1 ? 0x5812631au : i == 2 ? 0xa2f79cd6u
       : i == 3 ? 0x14def9deu : i == 7 ? 0x10000000u : 0u;
}

// p = 2^255 - 19, as 8 words.
HD u32 p_word(int i) { return i == 0 ? 0xffffffedu : i == 7 ? 0x7fffffffu : 0xffffffffu; }

// Row m - 8 holds R_m = 2^(32m) mod L for m = 8 .. 15 (each below L).
#define L1_FOLD_TABLE                                                                            \
  {{0x8d98951du, 0xd6ec3174u, 0x737dcf70u, 0xc6ef5bf4u, 0xfffffffeu, 0xffffffffu, 0xffffffffu,   \
    0x0fffffffu},                                                                                \
   {0x5cf5d3edu, 0x88b5244au, 0x21d16b30u, 0xe5652c79u, 0xb2106215u, 0xfffffffeu, 0xffffffffu,   \
    0x0fffffffu},                                                                                \
   {0x5cf5d3edu, 0x5812631au, 0xd39a5e06u, 0x93b8c838u, 0xd086329au, 0xb2106215u, 0xfffffffeu,   \
    0x0fffffffu},                                                                                \
   {0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x4581bb0eu, 0x7ed9ce5au, 0xd086329au, 0xb2106215u,   \
    0x0ffffffeu},                                                                                \
   {0xa02a6271u, 0x39822129u, 0x5e4fdd95u, 0xb64a7f43u, 0x30a2c131u, 0x7ed9ce5au, 0xd086329au,   \
    0x02106215u},                                                                                \
   {0x05d275e7u, 0x8a1c1dcdu, 0xcbf616bcu, 0x7cdfa7acu, 0xb399411bu, 0x30a2c131u, 0x7ed9ce5au,   \
    0x0086329au},                                                                                \
   {0xa00acb65u, 0x79daf520u, 0x38d1d7a9u, 0xe24babbeu, 0x7c309a3du, 0xb399411bu, 0x30a2c131u,   \
    0x0ed9ce5au},                                                                                \
   {0x5b7b0f19u, 0x4d8ee174u, 0x34bfaaeau, 0x18ca0c0au, 0xceec73d2u, 0x7c309a3du, 0xb399411bu,   \
    0x00a2c131u}}

// The table in device memory for the card (each role reads its own rows, so a
// warp reads several rows at once: global memory through L1, not the constant
// bank, which serializes different addresses), and in host memory for the
// host check.
#ifdef __CUDACC__
__device__ const u32 FOLD_TABLE_DEVICE[8][8] = L1_FOLD_TABLE;
#endif
const u32 FOLD_TABLE_HOST[8][8] = L1_FOLD_TABLE;

HD u32 fold_word(int row, int j) {
#ifdef __CUDA_ARCH__
  return FOLD_TABLE_DEVICE[row][j];
#else
  return FOLD_TABLE_HOST[row][j];
#endif
}

HD u32 bswap32(u32 x) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, 0u, 0x0123u);
#else
  return __builtin_bswap32(x);
#endif
}

// The little-endian word m (bytes 4m .. 4m + 3) of int32 byte rows at
// column `lane`, rows past `rows` read as 0.
HD u32 byte_rows_word(const int32_t* p, long long n, long long lane, int m, int rows) {
  u32 w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (4 * m + b < rows) w |= ((u32)p[(long long)(4 * m + b) * n + lane] & 0xffu) << (8 * b);
  return w;
}

// The same over uint8 rows (the signature and key rows), all present.
HD u32 u8_rows_word(const uint8_t* p, long long n, long long lane, int m) {
  u32 w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) w |= (u32)p[(long long)(4 * m + b) * n + lane] << (8 * b);
  return w;
}

// acc += x R_(row + 8): 8 products into the 10-word sum (R below 2^253).
HD void fold_row(u32 (&acc)[FOLD_WORDS], u32 x, int row) {
  u64 carry = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const u64 t = (u64)x * fold_word(row, j) + acc[j] + carry;  // < 2^64
    acc[j] = (u32)t;
    carry = t >> 32;
  }
#pragma unroll
  for (int j = 8; j < FOLD_WORDS; ++j) {
    const u64 t = (u64)acc[j] + carry;
    acc[j] = (u32)t;
    carry = t >> 32;
  }
}

// acc += x for an N-word x (N <= FOLD_WORDS); the sum stays below 2^320.
template <int N>
HD void add_words(u32 (&acc)[FOLD_WORDS], const u32 (&x)[N]) {
  u64 carry = 0;
#pragma unroll
  for (int j = 0; j < FOLD_WORDS; ++j) {
    const u64 t = (u64)acc[j] + (j < N ? x[j] : 0u) + carry;
    acc[j] = (u32)t;
    carry = t >> 32;
  }
}

// y mod L for y < 2^289: y = h 2^252 + lo with h < 2^37, and 2^252 == -delta
// (mod L), so y == t = lo + L - h delta, where 0 < L - h delta (h delta <
// 2^162) and t < 2^252 + L < 2L; then t - L where t >= L, without a branch.
HD scalar fold_252(const u32 (&y)[FOLD_WORDS]) {
  const u64 h = (u64)(y[7] >> 28) | ((u64)y[8] << 4) | ((u64)y[9] << 36);
  const u32 hw[2] = {(u32)h, (u32)(h >> 32)};
  u32 hd[6] = {0, 0, 0, 0, 0, 0};  // h delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    u64 carry = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const u64 t = (u64)hw[i] * l_word(j) + hd[i + j] + carry;
      hd[i + j] = (u32)t;
      carry = t >> 32;
    }
    hd[i + 4] = (u32)carry;
  }
  u32 t[8];
  u64 carry = 0;
  u32 borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const u32 lo = j < 7 ? y[j] : (y[7] & 0x0fffffffu);
    const u64 s = (u64)lo + l_word(j) + carry;  // lo + L < 2^254
    carry = s >> 32;
    const u64 d = (s & 0xffffffffu) - (j < 6 ? hd[j] : 0u) - borrow;
    t[j] = (u32)d;
    borrow = (u32)(d >> 63);
  }
  u32 d[8];
  borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const u64 x = (u64)t[j] - l_word(j) - borrow;
    d[j] = (u32)x;
    borrow = (u32)(x >> 63);
  }
  scalar k;
#pragma unroll
  for (int j = 0; j < 8; ++j) k.w[j] = borrow ? t[j] : d[j];
  return k;
}

// Word t of sum_{j < windows} 8 16^j: the recoding's constant.
HD u32 recode_word(int t, int windows) {
  const int full = windows / 8;
  return t < full ? 0x88888888u
       : t == full ? ((1u << (4 * (windows % 8))) - 1u) & 0x88888888u : 0u;
}

// The digits of s over `windows` windows (64, or 33 for s < 2^128), the
// share of role `rho` of `roles`: nibble j of s + C, C the recoding's
// constant, is window j's digit + 8, stored at out[(windows - 1 - j) *
// stride]; role rho writes nibbles rho + roles v of every word.
HD void store_digits(const scalar& s, int windows, int rho, int roles, int32_t* out,
                     long long stride) {
  u32 sc[8];
  u64 carry = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const u64 x = (u64)s.w[t] + recode_word(t, windows) + carry;  // no carry leaves word 7
    sc[t] = (u32)x;
    carry = x >> 32;
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) {
#pragma unroll
    for (int v = 0; v < 8 / HALF; ++v) {
      if (v * roles >= 8) break;  // roles = G has 8 / G nibbles a word
      const int q = rho + roles * v, j = 8 * t + q;
      if (j < windows) out[(long long)(windows - 1 - j) * stride] = (int32_t)((sc[t] >> (4 * q)) & 0xfu);
    }
  }
}

// s's 32 little-endian bytes at out[i * stride], role r's share of G: byte
// r % 4 of words t with t % (G / 4) == r / 4.
HD void store_bytes(const scalar& s, int r, int32_t* out, long long stride) {
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    if (t % (G / 4) != r / 4) continue;
    const int q = r % 4;
    out[(long long)(4 * t + q) * stride] = (int32_t)((s.w[t] >> (8 * q)) & 0xffu);
  }
}

// The value of w[base + rho] for rho < roles, indexed by constants only (a
// register array indexed at run time would be copied to local memory).
template <int N>
HD u32 pick(const u32 (&w)[N], int base, int rho, int roles) {
  u32 x = 0;
#pragma unroll
  for (int i = 0; i < G; ++i)
    if (i < roles && i == rho && base + i < N) x = w[base + i];
  return x;
}

// The kernel's arguments.
struct scalar_args {
  const int32_t* a;        // mode 0: the state or the digest rows; mode 1: z
  const int32_t* b;        // mode 1: k
  const int32_t* c;        // mode 1: s, or null
  const uint8_t* sig;      // mode 0 with the checks: the signature rows
  const uint8_t* key;      // mode 0 with the checks: the key rows
  const uint8_t* host_ok;  // mode 0 with the checks
  int32_t* d64;            // mode 0: k's digits (or null); mode 1: z k's
  int32_t* d33;            // mode 1: z's digits
  int32_t* bytes;          // mode 0: k's bytes (or null)
  uint8_t* ok;             // mode 0 with the checks
  int32_t* u;              // mode 1 with s: the sum's bytes
  u64* partials;           // mode 1 with s: SUM_WORDS column sums a block
  long long n;
  int mode, a_rows;        // a_rows: 0 for S1's state words, else the digest's byte rows
};

// Word m of the challenge input's little-endian value at column `lane`.
HD u32 challenge_word(const scalar_args& v, long long lane, int m) {
  if (v.a_rows == 0) return bswap32((u32)v.a[(long long)m * v.n + lane]);  // state (m / 2, m % 2)
  return byte_rows_word(v.a, v.n, lane, m, v.a_rows);
}

// Role r's bits of the checks: (words below, words above) the bound of S
// (against L) and y_R (against p) in the first word, of y_A in the second,
// 8 bits each, for words r + G i.
HD void check_bits(const scalar_args& v, long long lane, int r, u32 (&bits)[2]) {
  bits[0] = bits[1] = 0;
#pragma unroll
  for (int i = 0; i < 8 / G; ++i) {
    const int t = r + G * i;
    const u32 top = t == 7 ? 0x7fffffffu : 0xffffffffu;  // y's sign bit masked
    const u32 s = u8_rows_word(v.sig, v.n, lane, 8 + t), l = l_word(t);
    const u32 yr = u8_rows_word(v.sig, v.n, lane, t) & top;
    const u32 ya = u8_rows_word(v.key, v.n, lane, t) & top, p = p_word(t);
    bits[0] |= ((u32)(s < l) << t) | ((u32)(s > l) << (8 + t))
             | ((u32)(yr < p) << (16 + t)) | ((u32)(yr > p) << (24 + t));
    bits[1] |= ((u32)(ya < p) << t) | ((u32)(ya > p) << (8 + t));
  }
}

HD bool below(u32 bits, int shift) { return ((bits >> shift) & 0xffu) > ((bits >> (shift + 8)) & 0xffu); }

// --- the group of one lane -------------------------------------------------------
// A group runs R of the lane's G roles on this thread, role(q) for q < R,
// with per-role values in arrays [R].  serial_group runs every role (R = G)
// and exchanges by indexing; on the card (warp_group below) each thread is
// one role (R = 1) and exchanges by shuffles.

struct serial_group {
  static constexpr int R = G;
  HD_MEMBER int role(int q) const { return q; }
};

// Word j of role (role q ^ off)'s x.
template <int N>
HD u32 group_xor(const serial_group&, const u32 (&x)[G][N], int q, int j, int off) {
  return x[q ^ off][j];
}

// Every role of each aligned run of `width` roles gets the run's sum (a
// butterfly of xor exchanges; the sums stay below 2^289).
template <class Grp>
HD void group_sum(const Grp& g, u32 (&acc)[Grp::R][FOLD_WORDS], int width) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    if (off >= width) break;
    u32 other[Grp::R][FOLD_WORDS];
    for (int q = 0; q < Grp::R; ++q)
#pragma unroll
      for (int j = 0; j < FOLD_WORDS; ++j) other[q][j] = group_xor(g, acc, q, j, off);
    for (int q = 0; q < Grp::R; ++q) add_words(acc[q], other[q]);
  }
}

// The same with OR over 2-word bit masks, over the whole group.
template <class Grp>
HD void group_or(const Grp& g, u32 (&bits)[Grp::R][2]) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    u32 other[Grp::R][2];
    for (int q = 0; q < Grp::R; ++q)
#pragma unroll
      for (int j = 0; j < 2; ++j) other[q][j] = group_xor(g, bits, q, j, off);
    for (int q = 0; q < Grp::R; ++q)
#pragma unroll
      for (int j = 0; j < 2; ++j) bits[q][j] |= other[q][j];
  }
}

// The lane at column `lane` on group g: writes its outputs, and sets
// contrib[q] to what role(q) adds to the aggregate sum (z s mod L on role
// HALF where there is s; zero elsewhere).  A lane past the batch reads and
// writes nothing and adds zero.
template <class Grp>
HD void scalar_group(const Grp& g, const scalar_args& v, long long lane,
                     u32 (&contrib)[Grp::R][8]) {
  constexpr int R = Grp::R;
  const bool live = lane < v.n;
  u32 acc[R][FOLD_WORDS];
  for (int q = 0; q < R; ++q) {
#pragma unroll
    for (int j = 0; j < FOLD_WORDS; ++j) acc[q][j] = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) contrib[q][j] = 0;
  }
  if (v.mode == MODE_CHALLENGE) {
    u32 bits[R][2];
    for (int q = 0; q < R; ++q) {
      const int r = g.role(q);
      bits[q][0] = bits[q][1] = 0;
      if (!live) continue;
      // The checks' loads first: their latency overlaps the fold's.
      if (v.sig) check_bits(v, lane, r, bits[q]);
#pragma unroll
      for (int i = 0; i < 8 / G; ++i) fold_row(acc[q], challenge_word(v, lane, 8 + r + G * i), r + G * i);
      if (r == 0) {
        u32 low[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) low[m] = challenge_word(v, lane, m);
        add_words(acc[q], low);
      }
    }
    group_sum(g, acc, G);
    for (int q = 0; q < R; ++q) {
      const int r = g.role(q);
      const scalar k = fold_252(acc[q]);
      if (live && v.d64) store_digits(k, K_WINDOWS, r, G, v.d64 + lane, v.n);
      if (live && v.bytes) store_bytes(k, r, v.bytes + lane, v.n);
    }
    if (!v.sig) return;  // the same on every thread of the launch
    group_or(g, bits);
    for (int q = 0; q < R; ++q)
      if (live && g.role(q) == 0)
        v.ok[lane] = v.host_ok[lane] && below(bits[q][0], 0) && below(bits[q][0], 16)
                     && below(bits[q][1], 0);
    return;
  }
  // Aggregate: half 0 takes z k, half 1 z s (z k where there is no s).
  u32 z[R][4];
  for (int q = 0; q < R; ++q) {
    const int r = g.role(q), rho = r % HALF;
#pragma unroll
    for (int i = 0; i < 4; ++i) z[q][i] = live ? byte_rows_word(v.a, v.n, lane, i, 16) : 0u;
    if (!live) continue;
    const int32_t* other = r < HALF || !v.c ? v.b : v.c;
    u32 b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = byte_rows_word(other, v.n, lane, j, 32);
    u32 w[12];  // z b, below 2^384
#pragma unroll
    for (int j = 0; j < 12; ++j) w[j] = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      u64 carry = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const u64 t = (u64)z[q][i] * b[j] + w[i + j] + carry;
        w[i + j] = (u32)t;
        carry = t >> 32;
      }
      w[i + 8] = (u32)carry;
    }
    // Fold rows 8 + rho + HALF i of the half's 4; role 0 of the half adds
    // the low 8 words.
#pragma unroll
    for (int i = 0; i < 4 / HALF; ++i) fold_row(acc[q], pick(w, 8 + HALF * i, rho, HALF), rho + HALF * i);
    if (rho == 0) {
      u32 low[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) low[j] = w[j];
      add_words(acc[q], low);
    }
  }
  group_sum(g, acc, HALF);
  for (int q = 0; q < R; ++q) {
    const int r = g.role(q), rho = r % HALF;
    const bool first = r < HALF;
    const scalar prod = fold_252(acc[q]);  // z k mod L, or z s mod L on half 1
    scalar val;
#pragma unroll
    for (int j = 0; j < 8; ++j) val.w[j] = first ? prod.w[j] : (j < 4 ? z[q][j] : 0u);
    if (live)
      store_digits(val, first ? K_WINDOWS : Z_WINDOWS, rho, HALF, (first ? v.d64 : v.d33) + lane,
                   v.n);
    if (live && v.c && r == HALF)
#pragma unroll
      for (int j = 0; j < 8; ++j) contrib[q][j] = prod.w[j];
  }
}

// The aggregate sum from its column sums (column j the sum of every lane's
// word j, below 2^63): carried into a value below 2^289 and folded; its 32
// bytes at u[0 .. 31].
HD void sum_columns(const u64 (&cols)[SUM_WORDS], int32_t* u) {
  u32 x[FOLD_WORDS];
  u64 carry = 0;
#pragma unroll
  for (int j = 0; j < SUM_WORDS; ++j) {
    const u64 t = cols[j] + carry;  // < 2^63 + 2^32
    x[j] = (u32)t;
    carry = t >> 32;
  }
  x[SUM_WORDS] = (u32)carry;
  x[SUM_WORDS + 1] = (u32)(carry >> 32);
  const scalar s = fold_252(x);
  for (int i = 0; i < 32; ++i) u[i] = (int32_t)((s.w[i >> 2] >> (8 * (i & 3))) & 0xffu);
}

}  // namespace

#ifdef __CUDACC__

constexpr int SUM_THREADS = 256;  // the sum's one block: 32 rows of 8 columns
static_assert(G * lanes_a_block(MODE_CHALLENGE) % 32 == 0 && SUM_THREADS % SUM_WORDS == 0,
              "whole warps");

// One role of a lane's group: the role is the thread's place in its group of
// G adjacent lanes of the warp.
struct warp_group {
  static constexpr int R = 1;
  int r;
  HD_MEMBER int role(int) const { return r; }
};

// The card's group functions are __host__ __device__ like the templates that
// call them; their intrinsic exists only in the device pass.  Every thread of
// every warp reaches every shuffle, so the mask is the whole warp.
template <int N>
__host__ __device__ __forceinline__ u32 group_xor(const warp_group&, const u32 (&x)[1][N], int,
                                                  int j, int off) {
#ifdef __CUDA_ARCH__
  return __shfl_xor_sync(0xffffffffu, x[0][j], off);
#else
  (void)off;
  return x[0][j];
#endif
}

// One kernel a mode: with the mode a constant each holds one mode's code.
template <int MODE>
__global__ void __launch_bounds__(G * lanes_a_block(MODE)) scalar25519_kernel(scalar_args v) {
  constexpr int THREADS = G * lanes_a_block(MODE);
  v.mode = MODE;
  const int t = threadIdx.x;
  const warp_group g = {t % G};
  const long long lane = (long long)blockIdx.x * lanes_a_block(MODE) + t / G;
  u32 contrib[1][8];
  scalar_group(g, v, lane, contrib);
  if (!v.partials) return;  // the same on every thread of the launch
  __shared__ u64 warp_sums[THREADS / 32][SUM_WORDS];
#pragma unroll
  for (int j = 0; j < SUM_WORDS; ++j) {
    u64 x = contrib[0][j];
#pragma unroll
    for (int off = G; off < 32; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    if (t % 32 == HALF) warp_sums[t / 32][j] = x;  // the warp's role-HALF sums
  }
  __syncthreads();
  if (t < SUM_WORDS) {
    u64 s = 0;
    for (int w = 0; w < THREADS / 32; ++w) s += warp_sums[w][t];
    v.partials[(long long)blockIdx.x * SUM_WORDS + t] = s;
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
// of SUM_WORDS uint64 for each block of lanes_a_block(1) lanes.
extern "C" int scalar25519_launch(const void* a, const void* b, const void* c, const void* sig,
                                  const void* key, const void* host_ok, void* d64, void* d33,
                                  void* bytes, void* ok, void* u, void* partials, int n,
                                  int mode, int a_rows, int device, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  const bool checks = sig || key || host_ok || ok;
  if (mode == MODE_CHALLENGE) {
    if (!a || a_rows < 0 || a_rows > 64 || (!d64 && !bytes) || b || c || d33 || u || partials
        || (checks && !(sig && key && host_ok && ok)))
      return (int)cudaErrorInvalidValue;
  } else if (mode == MODE_AGGREGATE) {
    if (!a || !b || !d64 || !d33 || bytes || checks
        || (c ? !(u && partials) : (u || partials)))
      return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int lanes = lanes_a_block(mode), blocks = (n + lanes - 1) / lanes;
  const scalar_args v = {(const int32_t*)a, (const int32_t*)b, (const int32_t*)c,
                         (const uint8_t*)sig, (const uint8_t*)key, (const uint8_t*)host_ok,
                         (int32_t*)d64, (int32_t*)d33, (int32_t*)bytes, (uint8_t*)ok,
                         (int32_t*)u, (u64*)partials, (long long)n, mode,
                         mode == MODE_CHALLENGE ? a_rows : 16};
  if (blocks > 0) {
    if (mode == MODE_CHALLENGE)
      scalar25519_kernel<MODE_CHALLENGE><<<blocks, G * lanes, 0, (cudaStream_t)stream>>>(v);
    else
      scalar25519_kernel<MODE_AGGREGATE><<<blocks, G * lanes, 0, (cudaStream_t)stream>>>(v);
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
