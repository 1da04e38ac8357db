// GF(2^255 - 19) and edwards25519 arithmetic shared by the port's Ed25519
// kernels (horner_scan.cu, straus_msm.cu).
//
// Radix 2^51 with 5 uint64 limbs, so every product is one native 64-bit
// multiply pair (a*b and __umul64hi); fe_load/fe_store convert from and to
// the field module's weakly reduced 32 x 8-bit f32 limbs.  The point formulas
// are add-2008-hwcd-3 (with the 2d constant) and dbl-2008-hwcd in the order of
// consensus_tpu_torch/ops/ed25519.py.  Everything is __host__ __device__, so
// a source that includes this header can be compiled as plain C++ for a
// host-side check.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD static inline
#endif

typedef uint64_t u64;

namespace {

constexpr u64 MASK51 = (1ULL << 51) - 1;
constexpr int WINDOWS = 64;
constexpr int TABLE = 9;
constexpr int LIMBS8 = 32;

struct fe {
  u64 v[5];
};

struct ge {
  fe X, Y, Z, T;
};

// Limbs of a "reduced" fe are below 2^51 + 2^16; every operation below takes
// reduced inputs and returns reduced outputs.

HD void mul64(u64 a, u64 b, u64& lo, u64& hi) {
#ifdef __CUDA_ARCH__
  lo = a * b;
  hi = __umul64hi(a, b);
#else
  unsigned __int128 p = (unsigned __int128)a * b;
  lo = (u64)p;
  hi = (u64)(p >> 64);
#endif
}

struct u128 {
  u64 lo, hi;
};

HD void mac(u128& acc, u64 a, u64 b) {
  u64 lo, hi;
  mul64(a, b, lo, hi);
  acc.lo += lo;
  acc.hi += hi + (acc.lo < lo ? 1 : 0);
}

HD void add_small(u128& acc, u64 c) {
  acc.lo += c;
  acc.hi += (acc.lo < c ? 1 : 0);
}

// acc >> 51 for acc < 2^115.
HD u64 shr51(const u128& acc) { return (acc.lo >> 51) | (acc.hi << 13); }

HD fe fe_zero() { return fe{{0, 0, 0, 0, 0}}; }
HD fe fe_one() { return fe{{1, 0, 0, 0, 0}}; }

// One carry pass with the top carry folded back at weight 2^255 = 19, then
// one more step on limb 0.  Inputs below 2^63 leave limbs below 2^51 + 2^13.
HD void fe_carry(fe& h) {
  u64 c;
  c = h.v[0] >> 51; h.v[0] &= MASK51; h.v[1] += c;
  c = h.v[1] >> 51; h.v[1] &= MASK51; h.v[2] += c;
  c = h.v[2] >> 51; h.v[2] &= MASK51; h.v[3] += c;
  c = h.v[3] >> 51; h.v[3] &= MASK51; h.v[4] += c;
  c = h.v[4] >> 51; h.v[4] &= MASK51; h.v[0] += 19 * c;
  c = h.v[0] >> 51; h.v[0] &= MASK51; h.v[1] += c;
}

HD fe fe_add(const fe& f, const fe& g) {
  fe h;
  for (int i = 0; i < 5; ++i) h.v[i] = f.v[i] + g.v[i];
  fe_carry(h);
  return h;
}

// f + 2p - g: every limb of 2p exceeds a reduced g's limb, so no underflow.
HD fe fe_sub(const fe& f, const fe& g) {
  fe h;
  h.v[0] = f.v[0] + 0xfffffffffffdaULL - g.v[0];
  for (int i = 1; i < 5; ++i) h.v[i] = f.v[i] + 0xffffffffffffeULL - g.v[i];
  fe_carry(h);
  return h;
}

HD fe fe_neg(const fe& f) { return fe_sub(fe_zero(), f); }

// Schoolbook product with the columns above 2^255 folded at weight 19.
// Reduced inputs: each term < 2^51.01 * 2^55.3, each column < 2^108.6.
HD fe fe_mul(const fe& f, const fe& g) {
  const u64 f0 = f.v[0], f1 = f.v[1], f2 = f.v[2], f3 = f.v[3], f4 = f.v[4];
  const u64 g0 = g.v[0], g1 = g.v[1], g2 = g.v[2], g3 = g.v[3], g4 = g.v[4];
  const u64 g1_19 = 19 * g1, g2_19 = 19 * g2, g3_19 = 19 * g3, g4_19 = 19 * g4;
  u128 r0 = {0, 0}, r1 = {0, 0}, r2 = {0, 0}, r3 = {0, 0}, r4 = {0, 0};
  mac(r0, f0, g0); mac(r0, f1, g4_19); mac(r0, f2, g3_19); mac(r0, f3, g2_19); mac(r0, f4, g1_19);
  mac(r1, f0, g1); mac(r1, f1, g0); mac(r1, f2, g4_19); mac(r1, f3, g3_19); mac(r1, f4, g2_19);
  mac(r2, f0, g2); mac(r2, f1, g1); mac(r2, f2, g0); mac(r2, f3, g4_19); mac(r2, f4, g3_19);
  mac(r3, f0, g3); mac(r3, f1, g2); mac(r3, f2, g1); mac(r3, f3, g0); mac(r3, f4, g4_19);
  mac(r4, f0, g4); mac(r4, f1, g3); mac(r4, f2, g2); mac(r4, f3, g1); mac(r4, f4, g0);
  fe h;
  u64 c;
  c = shr51(r0); h.v[0] = r0.lo & MASK51; add_small(r1, c);
  c = shr51(r1); h.v[1] = r1.lo & MASK51; add_small(r2, c);
  c = shr51(r2); h.v[2] = r2.lo & MASK51; add_small(r3, c);
  c = shr51(r3); h.v[3] = r3.lo & MASK51; add_small(r4, c);
  c = shr51(r4); h.v[4] = r4.lo & MASK51;
  h.v[0] += 19 * c;  // c < 2^57.6, so 19c < 2^62
  c = h.v[0] >> 51; h.v[0] &= MASK51; h.v[1] += c;
  return h;
}

// 2d, with d = -121665/121666 the edwards25519 constant.
HD fe fe_d2() {
  return fe{{0x69b9426b2f159ULL, 0x35050762add7aULL, 0x3cf44c0038052ULL,
             0x6738cc7407977ULL, 0x2406d9dc56dffULL}};
}

// 32 weakly reduced f32 limbs at p[i * stride] -> reduced fe.  Bias by 2p
// (bytes 218, 255 x 30, 255), then one exact signed carry pass over the
// bytes as in the torch freeze: the weak contract keeps the biased value in
// (0, 2^257), so the final carry is 0 or 1 and folds back at 2^256 = 38.
HD fe fe_load(const float* p, long long stride) {
  int32_t b[LIMBS8];
  int32_t carry = 0;
  for (int i = 0; i < LIMBS8; ++i) {
    int32_t v = (int32_t)p[i * stride] + (i == 0 ? 218 : 255) + carry;
    b[i] = v & 0xff;
    carry = v >> 8;  // arithmetic shift: negative limbs borrow
  }
  u64 w[4];
  for (int j = 0; j < 4; ++j) {
    u64 acc = 0;
    for (int i = 7; i >= 0; --i) acc = (acc << 8) | (u64)b[8 * j + i];
    w[j] = acc;
  }
  fe h;
  h.v[0] = w[0] & MASK51;
  h.v[1] = ((w[0] >> 51) | (w[1] << 13)) & MASK51;
  h.v[2] = ((w[1] >> 38) | (w[2] << 26)) & MASK51;
  h.v[3] = ((w[2] >> 25) | (w[3] << 39)) & MASK51;
  h.v[4] = w[3] >> 12;  // bits 204..255
  h.v[0] += 38 * (u64)carry;
  fe_carry(h);
  return h;
}

// Reduced fe -> canonical value in [0, p) as 32 f32 limbs at p[i * stride].
HD void fe_store(float* p, long long stride, const fe& h) {
  u64 t[5] = {h.v[0], h.v[1], h.v[2], h.v[3], h.v[4]};
  for (int pass = 0; pass < 3; ++pass) {
    t[1] += t[0] >> 51; t[0] &= MASK51;
    t[2] += t[1] >> 51; t[1] &= MASK51;
    t[3] += t[2] >> 51; t[2] &= MASK51;
    t[4] += t[3] >> 51; t[3] &= MASK51;
    t[0] += 19 * (t[4] >> 51); t[4] &= MASK51;
  }
  // Now 0 <= t < 2^255 with every limb below 2^51.  Add 19: a carry out of
  // bit 255 happens exactly when t >= p, and folds back at 19, so the value
  // becomes (t mod p) + 19.  Adding 2^255 - 19 and dropping bit 255 then
  // leaves t mod p.
  t[0] += 19;
  t[1] += t[0] >> 51; t[0] &= MASK51;
  t[2] += t[1] >> 51; t[1] &= MASK51;
  t[3] += t[2] >> 51; t[2] &= MASK51;
  t[4] += t[3] >> 51; t[3] &= MASK51;
  t[0] += 19 * (t[4] >> 51); t[4] &= MASK51;
  t[0] += MASK51 + 1 - 19;
  t[1] += MASK51;
  t[2] += MASK51;
  t[3] += MASK51;
  t[4] += MASK51;
  t[1] += t[0] >> 51; t[0] &= MASK51;
  t[2] += t[1] >> 51; t[1] &= MASK51;
  t[3] += t[2] >> 51; t[2] &= MASK51;
  t[4] += t[3] >> 51; t[3] &= MASK51;
  t[4] &= MASK51;
  u64 w[4];
  w[0] = t[0] | (t[1] << 51);
  w[1] = (t[1] >> 13) | (t[2] << 38);
  w[2] = (t[2] >> 26) | (t[3] << 25);
  w[3] = (t[3] >> 39) | (t[4] << 12);
  for (int i = 0; i < LIMBS8; ++i) {
    p[i * stride] = (float)((w[i >> 3] >> (8 * (i & 7))) & 0xff);
  }
}

HD ge ge_identity() { return ge{fe_zero(), fe_one(), fe_one(), fe_zero()}; }

// add-2008-hwcd-3, in the order of consensus_tpu/ops/ed25519.py::add.
HD ge ge_add(const ge& p, const ge& q) {
  const fe a = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
  const fe b = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
  const fe c = fe_mul(fe_mul(p.T, fe_d2()), q.T);
  const fe d = fe_mul(fe_add(p.Z, p.Z), q.Z);
  const fe e = fe_sub(b, a);
  const fe f = fe_sub(d, c);
  const fe g = fe_add(d, c);
  const fe h = fe_add(b, a);
  return ge{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

// dbl-2008-hwcd, in the order of consensus_tpu/ops/ed25519.py::double.  With
// need_t false the stale input T passes through, as there.
HD ge ge_dbl(const ge& p, bool need_t) {
  const fe a = fe_mul(p.X, p.X);
  const fe b = fe_mul(p.Y, p.Y);
  const fe zz = fe_mul(p.Z, p.Z);
  const fe c = fe_add(zz, zz);
  const fe h = fe_add(a, b);
  const fe xy = fe_add(p.X, p.Y);
  const fe e = fe_sub(h, fe_mul(xy, xy));
  const fe g = fe_sub(a, b);
  const fe f = fe_add(c, g);
  const fe t = need_t ? fe_mul(e, h) : p.T;
  return ge{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), t};
}

}  // namespace
