// GF(p256) and P-256 point arithmetic shared by the port's P-256 kernels
// (horner_scan_p256.cu, B2; comb_p256.cu, P1; verdict_p256.cu, P2).
//
// A field element is 8 little-endian 32-bit words holding the canonical
// value (below p = 2^256 - 2^224 + 2^192 + 2^96 - 1): the schoolbook product
// is 64 32x32->64-bit products (IMAD.WIDE.U32), the squaring 36, and the
// 512-bit result folds through FIPS 186-4 D.2.3's word assembly.
// fe_load/fe_store convert from and to the field module's weakly reduced
// 32 x 8-bit f32 limbs with exact integer arithmetic.  The point formulas are
// Renes-Costello-Batina 2015, Algorithms 4 (complete addition) and 6
// (doubling) for a = -3, in the order of consensus_tpu_torch/ops/p256.py,
// written once, as their three levels of products (add_level1..3,
// dbl_level1..3).  A group of G threads runs a level with one product a
// role (warp_group, under nvcc); serial_group runs every role in turn on one
// thread, which is what ge_add and ge_dbl and the host checks compiled with
// g++ use.  Everything is __host__ __device__ except the warp barrier.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD static inline
#endif

typedef uint32_t u32;
typedef uint64_t u64;
typedef int64_t i64;

namespace {

constexpr int LIMBS8 = 32;

// A field element as 8 little-endian 32-bit words, canonical: value < p.
struct fe {
  u32 v[8];
};

struct ge {
  fe X, Y, Z;
};

// p = 2^256 - 2^224 + 2^192 + 2^96 - 1.
HD u32 p_word(int i) {
  return (i < 3 || i == 7) ? 0xffffffffu : (i == 6 ? 1u : 0u);
}

HD fe fe_zero() { return fe{{0, 0, 0, 0, 0, 0, 0, 0}}; }
HD fe fe_one() { return fe{{1, 0, 0, 0, 0, 0, 0, 0}}; }

// b of P-256 (FIPS 186-4 D.1.2.3).
HD fe fe_b() {
  return fe{{0x27d2604bu, 0x3bce3c3eu, 0xcc53b0f6u, 0x651d06b0u,
             0x769886bcu, 0xb3ebbd55u, 0xaa3a93e7u, 0x5ac635d8u}};
}

// carry * 2^256 + t, a value below 2p, -> value mod p.
HD fe fe_csub_p(const u32 t[8], u32 carry) {
  fe d;
  u32 borrow = 0;
  for (int i = 0; i < 8; ++i) {
    const u64 acc = (u64)t[i] - p_word(i) - borrow;
    d.v[i] = (u32)acc;
    borrow = (u32)(acc >> 63);
  }
  const bool ge_p = carry != 0 || borrow == 0;
  fe r;
  for (int i = 0; i < 8; ++i) r.v[i] = ge_p ? d.v[i] : t[i];
  return r;
}

// sum_j t[j] * 2^(32 j) mod p, for signed words with |t[j]| < 2^40.
// Three rounds of carry propagation, each folding the top carry c back
// through 2^256 = 2^224 - 2^192 - 2^96 + 1 (mod p): the first leaves a
// value within 2^231 of [0, 2^256), the second lands in [0, 2^256), the
// third only normalizes the words (its carry is 0).  One conditional
// subtraction of p then gives the canonical value.
HD fe fe_reduce(i64 t[8]) {
  for (int round = 0; round < 3; ++round) {
    i64 c = 0;
    for (int j = 0; j < 8; ++j) {
      t[j] += c;
      c = t[j] >> 32;  // arithmetic shift: negative words borrow
      t[j] &= 0xffffffffll;
    }
    t[0] += c;
    t[3] -= c;
    t[6] -= c;
    t[7] += c;
  }
  u32 w[8];
  for (int j = 0; j < 8; ++j) w[j] = (u32)t[j];
  return fe_csub_p(w, 0);
}

HD fe fe_add(const fe& a, const fe& b) {
  u32 t[8];
  u64 carry = 0;
  for (int i = 0; i < 8; ++i) {
    const u64 s = (u64)a.v[i] + b.v[i] + carry;
    t[i] = (u32)s;
    carry = s >> 32;
  }
  return fe_csub_p(t, (u32)carry);
}

HD fe fe_sub(const fe& a, const fe& b) {
  fe d;
  u32 borrow = 0;
  for (int i = 0; i < 8; ++i) {
    const u64 acc = (u64)a.v[i] - b.v[i] - borrow;
    d.v[i] = (u32)acc;
    borrow = (u32)(acc >> 63);
  }
  // On a borrow, a - b + 2^256 lies in [2^256 - p, 2^256): adding p wraps
  // it to a - b + p in [0, p).
  const u32 mask = 0u - borrow;
  u64 carry = 0;
  for (int i = 0; i < 8; ++i) {
    const u64 s = (u64)d.v[i] + (p_word(i) & mask) + carry;
    d.v[i] = (u32)s;
    carry = s >> 32;
  }
  return d;
}

HD fe fe_neg(const fe& a) { return fe_sub(fe_zero(), a); }

// FIPS 186-4 D.2.3: the 512-bit value c[0..15] mod p as
// s1 + 2 s2 + 2 s3 + s4 + s5 - s6 - s7 - s8 - s9, word by word.
HD fe fe_solinas(const u32 c[16]) {
  const i64 c0 = c[0], c1 = c[1], c2 = c[2], c3 = c[3], c4 = c[4], c5 = c[5],
            c6 = c[6], c7 = c[7], c8 = c[8], c9 = c[9], c10 = c[10],
            c11 = c[11], c12 = c[12], c13 = c[13], c14 = c[14], c15 = c[15];
  i64 t[8];
  t[0] = c0 + c8 + c9 - c11 - c12 - c13 - c14;
  t[1] = c1 + c9 + c10 - c12 - c13 - c14 - c15;
  t[2] = c2 + c10 + c11 - c13 - c14 - c15;
  t[3] = c3 + 2 * c11 + 2 * c12 + c13 - c15 - c8 - c9;
  t[4] = c4 + 2 * c12 + 2 * c13 + c14 - c9 - c10;
  t[5] = c5 + 2 * c13 + 2 * c14 + c15 - c10 - c11;
  t[6] = c6 + 3 * c14 + 2 * c15 + c13 - c8 - c9;
  t[7] = c7 + 3 * c15 + c8 - c10 - c11 - c12 - c13;
  return fe_reduce(t);
}

// One 32x32->64-bit product (IMAD.WIDE.U32 on the card).
HD u64 mul_wide(u32 a, u32 b) { return (u64)a * (u64)b; }

// Operand-scanning schoolbook product: 64 32x32->64-bit products.
HD fe fe_mul(const fe& a, const fe& b) {
  u32 c[16];
  for (int i = 0; i < 16; ++i) c[i] = 0;
  for (int i = 0; i < 8; ++i) {
    u64 carry = 0;
    for (int j = 0; j < 8; ++j) {
      const u64 t = mul_wide(a.v[i], b.v[j]) + c[i + j] + carry;  // < 2^64: (2^32-1)^2 + 2(2^32-1)
      c[i + j] = (u32)t;
      carry = t >> 32;
    }
    c[i + 8] = (u32)carry;
  }
  return fe_solinas(c);
}

// Squaring: the 28 cross products once, doubled by a shift, plus the 8
// squares on the diagonal -- 36 products.
HD fe fe_sqr(const fe& a) {
  u32 c[16];
  for (int i = 0; i < 16; ++i) c[i] = 0;
  for (int i = 0; i < 7; ++i) {
    u64 carry = 0;
    for (int j = i + 1; j < 8; ++j) {
      const u64 t = mul_wide(a.v[i], a.v[j]) + c[i + j] + carry;
      c[i + j] = (u32)t;
      carry = t >> 32;
    }
    c[i + 8] = (u32)carry;
  }
  for (int i = 15; i > 0; --i) c[i] = (c[i] << 1) | (c[i - 1] >> 31);
  c[0] <<= 1;
  u64 carry = 0;
  for (int i = 0; i < 8; ++i) {
    const u64 sq = mul_wide(a.v[i], a.v[i]);
    u64 t = (u64)c[2 * i] + (u32)sq + carry;
    c[2 * i] = (u32)t;
    carry = t >> 32;
    t = (u64)c[2 * i + 1] + (sq >> 32) + carry;
    c[2 * i + 1] = (u32)t;
    carry = t >> 32;
  }
  return fe_solinas(c);
}

// 32 weakly reduced f32 limbs at p[i * stride] -> canonical fe: the limbs
// gathered into signed 32-bit-word sums, then the same reduction.
HD fe fe_load(const float* p, long long stride) {
  i64 t[8];
  for (int j = 0; j < 8; ++j) {
    i64 w = 0;
    for (int i = 0; i < 4; ++i) w += (i64)p[(4 * j + i) * stride] * ((i64)1 << (8 * i));
    t[j] = w;
  }
  return fe_reduce(t);
}

// Canonical fe -> 32 f32 limbs at p[i * stride].
HD void fe_store(float* p, long long stride, const fe& a) {
  for (int i = 0; i < LIMBS8; ++i) {
    p[i * stride] = (float)((a.v[i >> 2] >> (8 * (i & 3))) & 0xffu);
  }
}

HD ge ge_identity() { return ge{fe_zero(), fe_one(), fe_zero()}; }

// --- point operations by product level ----------------------------------------
// RCB15 Algorithm 4 (add) and 6 (double), in the order of
// consensus_tpu/ops/p256.py::add and ::double, cut into their three levels of
// products.  Product k of an operation goes to slot k of its group's slots:
// the add's levels are slots 0-5, 6-7 and 8-13, the double's 0-5, 6-8 and
// 9-12.  A level reads only the slots of the levels before it, and the
// result reads only the last level's, so one barrier after each level orders
// a group through any sequence of operations.

constexpr int G = 8;  // threads of a group (one lane): a power of two, at most 32
constexpr int SLOTS = 14;

// The stages' field multiplication: on the card one out-of-line copy of
// fe_mul, so that the kernel's code stays small (measured faster than
// inlining it in every stage); on the host fe_mul itself.
#ifdef __CUDA_ARCH__
__device__ __noinline__ fe fe_mul_call(fe a, fe b) { return fe_mul(a, b); }
#endif

HD fe mul(const fe& a, const fe& b) {
#ifdef __CUDA_ARCH__
  return fe_mul_call(a, b);
#else
  return fe_mul(a, b);
#endif
}

// w ? a : b, word by word, without a branch.
HD fe fe_sel(bool w, const fe& a, const fe& b) {
  fe r;
  for (int i = 0; i < 8; ++i) r.v[i] = w ? a.v[i] : b.v[i];
  return r;
}

// Coordinate c of p: 0 X, 1 Y, 2 Z.
HD fe ge_coord(const ge& p, int c) { return fe_sel(c == 0, p.X, fe_sel(c == 1, p.Y, p.Z)); }

// Add, level 1, product k (slot k): X1 X2, Y1 Y2, Z1 Z2, (X1 + Y1)(X2 + Y2),
// (Y1 + Z1)(Y2 + Z2), (X1 + Z1)(X2 + Z2).
HD fe add_level1(const ge& p, const ge& q, int k) {
  const int c0 = k < 3 ? k : (k == 4 ? 1 : 0);
  const int c1 = k == 3 ? 1 : 2;
  const fe a = ge_coord(p, c0), b = ge_coord(q, c0);
  return mul(fe_sel(k < 3, a, fe_add(a, ge_coord(p, c1))),
             fe_sel(k < 3, b, fe_add(b, ge_coord(q, c1))));
}

// Add, level 2, product k (slot 6 + k): b t2, b y3 with y3 = x3 - (t0 + t2).
HD fe add_level2(const fe* s, int k) {
  return mul(fe_b(), fe_sel(k == 0, s[2], fe_sub(s[5], fe_add(s[0], s[2]))));
}

// The factors of the add's level 3, from levels 1 and 2.
struct add_terms {
  fe t0, t3, t4, x3, y3, z3;
};

HD add_terms add_level3_terms(const fe* s) {
  add_terms v;
  v.t3 = fe_sub(s[3], fe_add(s[0], s[1]));
  v.t4 = fe_sub(s[4], fe_add(s[1], s[2]));
  fe x3 = fe_sub(fe_sub(s[5], fe_add(s[0], s[2])), s[6]);
  x3 = fe_add(x3, fe_add(x3, x3));
  v.z3 = fe_sub(s[1], x3);
  v.x3 = fe_add(s[1], x3);
  const fe t2 = fe_add(fe_add(s[2], s[2]), s[2]);
  const fe y3 = fe_sub(fe_sub(s[7], t2), s[0]);
  v.y3 = fe_add(fe_add(y3, y3), y3);
  v.t0 = fe_sub(fe_add(fe_add(s[0], s[0]), s[0]), t2);
  return v;
}

// Add, level 3, product k (slot 8 + k): t4 y3, t0 y3, x3 z3, t3 x3, t4 z3,
// t3 t0.
HD fe add_level3(const add_terms& v, int k) {
  const fe a = fe_sel(k == 0 || k == 4, v.t4, fe_sel(k == 1, v.t0, fe_sel(k == 2, v.x3, v.t3)));
  const fe b = fe_sel(k < 2, v.y3, fe_sel(k == 2 || k == 4, v.z3, fe_sel(k == 3, v.x3, v.t0)));
  return mul(a, b);
}

HD ge add_result(const fe* s) {
  return ge{fe_sub(s[11], s[8]), fe_add(s[10], s[9]), fe_add(s[12], s[13])};
}

// Double, level 1, product k (slot k): X^2, Y^2, Z^2, X Y, X Z, Y Z.
HD fe dbl_level1(const ge& p, int k) {
  const int c0 = k < 3 ? k : (k == 5 ? 1 : 0);
  const int c1 = k < 3 ? k : (k == 3 ? 1 : 2);
  return mul(ge_coord(p, c0), ge_coord(p, c1));
}

// Double, level 2, product k (slot 6 + k): b Z^2, b (2 X Z), (2 Y Z) Y^2.
HD fe dbl_level2(const fe* s, int k) {
  return mul(fe_sel(k == 2, fe_add(s[5], s[5]), fe_b()),
             fe_sel(k == 0, s[2], fe_sel(k == 1, fe_add(s[4], s[4]), s[1])));
}

// The factors of the double's level 3, from levels 1 and 2.
struct dbl_terms {
  fe t0, t3, x3, y3, z3, yz2;
};

HD dbl_terms dbl_level3_terms(const fe* s) {
  dbl_terms v;
  v.t3 = fe_add(s[3], s[3]);
  fe y3 = fe_sub(s[6], fe_add(s[4], s[4]));
  y3 = fe_add(fe_add(y3, y3), y3);
  v.x3 = fe_sub(s[1], y3);
  v.y3 = fe_add(s[1], y3);
  const fe t2 = fe_add(fe_add(s[2], s[2]), s[2]);
  const fe z3 = fe_sub(fe_sub(s[7], t2), s[0]);
  v.z3 = fe_add(fe_add(z3, z3), z3);
  v.t0 = fe_sub(fe_add(fe_add(s[0], s[0]), s[0]), t2);
  v.yz2 = fe_add(s[5], s[5]);
  return v;
}

// Double, level 3, product k (slot 9 + k): x3 y3, x3 t3, t0 z3, (2 Y Z) z3.
HD fe dbl_level3(const dbl_terms& v, int k) {
  return mul(fe_sel(k < 2, v.x3, fe_sel(k == 2, v.t0, v.yz2)),
             fe_sel(k == 0, v.y3, fe_sel(k == 1, v.t3, v.z3)));
}

HD ge dbl_result(const fe* s) {
  const fe z3 = fe_add(s[8], s[8]);
  return ge{fe_sub(s[10], s[12]), fe_add(s[9], s[11]), fe_add(z3, z3)};
}

// --- one signature's group ------------------------------------------------------
// A group runs roles [role_lo, role_hi) of G on this thread over the
// group's slots.  On the card each thread is one role, the slots are in
// shared memory and group_sync is __syncwarp over the group's lanes;
// serial_group runs every role in turn on one thread, with no barrier.

struct serial_group {
  fe* slots;
  int role_lo, role_hi;
};

HD void group_sync(const serial_group&) {}

template <class Group>
HD ge group_add(const Group& g, const ge& p, const ge& q) {
  fe* const s = g.slots;
  for (int r = g.role_lo; r < g.role_hi; ++r)
    for (int k = r; k < 6; k += G) s[k] = add_level1(p, q, k);
  group_sync(g);
  for (int r = g.role_lo; r < g.role_hi; ++r)
    for (int k = r; k < 2; k += G) s[6 + k] = add_level2(s, k);
  group_sync(g);
  const add_terms v = add_level3_terms(s);
  for (int r = g.role_lo; r < g.role_hi; ++r)
    for (int k = r; k < 6; k += G) s[8 + k] = add_level3(v, k);
  group_sync(g);
  return add_result(s);
}

template <class Group>
HD ge group_dbl(const Group& g, const ge& p) {
  fe* const s = g.slots;
  for (int r = g.role_lo; r < g.role_hi; ++r)
    for (int k = r; k < 6; k += G) s[k] = dbl_level1(p, k);
  group_sync(g);
  for (int r = g.role_lo; r < g.role_hi; ++r)
    for (int k = r; k < 3; k += G) s[6 + k] = dbl_level2(s, k);
  group_sync(g);
  const dbl_terms v = dbl_level3_terms(s);
  for (int r = g.role_lo; r < g.role_hi; ++r)
    for (int k = r; k < 4; k += G) s[9 + k] = dbl_level3(v, k);
  group_sync(g);
  return dbl_result(s);
}

// The complete add and double on one thread.
HD ge ge_add(const ge& p, const ge& q) {
  fe s[SLOTS];
  return group_add(serial_group{s, 0, G}, p, q);
}

HD ge ge_dbl(const ge& p) {
  fe s[SLOTS];
  return group_dbl(serial_group{s, 0, G}, p);
}

}  // namespace

#ifdef __CUDACC__

static_assert(G <= 32 && 32 % G == 0, "a signature's group lies in one warp");

// One role of a signature's group: the group's slots in shared memory and
// the mask of its G lanes in the warp.
struct warp_group {
  fe* slots;
  int role_lo, role_hi;
  unsigned mask;
};

__host__ __device__ __forceinline__ void group_sync(const warp_group& g) {
#ifdef __CUDA_ARCH__
  __syncwarp(g.mask);
#endif
}

#endif  // __CUDACC__
