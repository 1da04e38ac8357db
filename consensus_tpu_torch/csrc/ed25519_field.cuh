// GF(2^255 - 19) and edwards25519 arithmetic shared by the port's Ed25519
// kernels (horner_scan.cu, straus_msm.cu, decompress25519.cu, comb25519.cu).
//
// Radix 2^51 with 5 uint64 limbs, so every product is one native 64-bit
// multiply pair (a*b and __umul64hi); fe_load/fe_store convert from and to
// the field module's weakly reduced 32 x 8-bit f32 limbs.  The point formulas
// are add-2008-hwcd-3 (with the 2d constant) and dbl-2008-hwcd in the order of
// consensus_tpu_torch/ops/ed25519.py, written once, as their two levels of
// four independent products (dbl_stage1/2, add_stage1/2).  B1 and B3's chain
// run a level on a group of four threads, one product each; ge_add and ge_dbl
// run the four roles in turn on one thread.  B1 on that schedule (16
// signatures a block, slots in shared memory, fe_mul inlined) takes
// 0.782-0.785 ms at 8,192 lanes on an NVIDIA H100 80GB HBM3 at 700.00 W,
// where one thread per signature took 3.264-3.273 ms in the same call.
// Everything is __host__ __device__ except the warp exchange, so a source
// that includes this header can be compiled as plain C++ for a host-side
// check.

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

// --- radix 2^25.5 products (kernels D1 and D2) -----------------------------------
// In radix 2^51 every term of a product is a 64x64->128-bit product, several
// dependent 32-bit multiply-adds on this card.  fe25 holds the same value in
// ten limbs of 26 and 25 bits (ref10's representation) in uint32, so that a
// term is one 32x32->64 multiply-add (IMAD.WIDE.U32) into a 64-bit column:
// a multiplication is 100 of them, a squaring 55.  Limb i sits at bit
// ceil(25.5 i); the term f_i g_j lands in column (i + j) mod 10, doubled
// when i and j are both odd (their half bits add up) and times 19 when i + j
// >= 10 (2^255 = 19 mod p).  Limbs of an fe25 from fe25_from or a product
// are below 2^26 (even) and 2^25 + 2^15 (odd): every scaled factor then fits
// 32 bits (at most 38 * 2^26 or 76 (2^25 + 2^15), below 2^31.3) and every
// column 64 (ten terms below 2^57.3).  The values mod p are fe_mul's, so a
// kernel that computes its products here writes the same canonical limbs.

struct fe25 {
  uint32_t v[10];
};

constexpr u64 MASK26 = (1ULL << 26) - 1;
constexpr u64 MASK25 = (1ULL << 25) - 1;

// Reduced fe (limbs below 2^51 + 2^16) -> fe25: each limb's low 26 bits and
// the rest (below 2^25 + 1).
HD fe25 fe25_from(const fe& f) {
  fe25 h;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    h.v[2 * k] = (uint32_t)(f.v[k] & MASK26);
    h.v[2 * k + 1] = (uint32_t)(f.v[k] >> 26);
  }
  return h;
}

// fe25 -> reduced fe.
HD fe fe25_to(const fe25& f) {
  fe h;
#pragma unroll
  for (int k = 0; k < 5; ++k) h.v[k] = (u64)f.v[2 * k] + ((u64)f.v[2 * k + 1] << 26);
  fe_carry(h);
  return h;
}

// Ten columns below 2^61 -> fe25: ref10's carry order, two chains
// interleaved, the top carry folded back at 19.
HD fe25 fe25_carry(u64* h) {
  u64 c;
  c = h[0] >> 26; h[1] += c; h[0] &= MASK26;
  c = h[4] >> 26; h[5] += c; h[4] &= MASK26;
  c = h[1] >> 25; h[2] += c; h[1] &= MASK25;
  c = h[5] >> 25; h[6] += c; h[5] &= MASK25;
  c = h[2] >> 26; h[3] += c; h[2] &= MASK26;
  c = h[6] >> 26; h[7] += c; h[6] &= MASK26;
  c = h[3] >> 25; h[4] += c; h[3] &= MASK25;
  c = h[7] >> 25; h[8] += c; h[7] &= MASK25;
  c = h[4] >> 26; h[5] += c; h[4] &= MASK26;
  c = h[8] >> 26; h[9] += c; h[8] &= MASK26;
  c = h[9] >> 25; h[0] += 19 * c; h[9] &= MASK25;
  c = h[0] >> 26; h[1] += c; h[0] &= MASK26;
  fe25 r;
#pragma unroll
  for (int i = 0; i < 10; ++i) r.v[i] = (uint32_t)h[i];
  return r;
}

HD fe25 fe25_mul(const fe25& f, const fe25& g) {
  u64 h[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 10; ++i)
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      const uint32_t scale = ((i & j & 1) ? 2u : 1u) * (i + j >= 10 ? 19u : 1u);
      h[(i + j) % 10] += (u64)f.v[i] * (uint32_t)(scale * g.v[j]);
    }
  return fe25_carry(h);
}

// f^2: each product f_i f_j with i < j once, doubled.
HD fe25 fe25_sq(const fe25& f) {
  u64 h[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 10; ++i)
#pragma unroll
    for (int j = i; j < 10; ++j) {
      const uint32_t scale =
          ((i & j & 1) ? 2u : 1u) * (i + j >= 10 ? 19u : 1u) * (i == j ? 1u : 2u);
      h[(i + j) % 10] += (u64)f.v[i] * (uint32_t)(scale * f.v[j]);
    }
  return fe25_carry(h);
}

HD ge ge_identity() { return ge{fe_zero(), fe_one(), fe_one(), fe_zero()}; }

// --- the point operations' multiplication ----------------------------------------
// MUL_CALL: on the card one out-of-line copy of fe_mul (about 600
// instructions), so that a kernel's loops fit the SM's instruction cache;
// measured faster for B3's tables, window sums and join, which add with
// ge_add.  MUL_INLINE: fe_mul inlined at every call; measured faster for
// B3's one-warp chain and for B1's split stages.  On the host both are
// fe_mul.  MUL_R25: the product in radix 2^25.5 (fe25 above), inlined, on
// the host too; measured faster for D2's split stages.  MUL_R25_CALL: the
// same through fe25_mul_call, one out-of-line copy of fe25_mul on the card;
// D1's, whose (p-5)/8 power calls that copy too.

enum { MUL_CALL = 0, MUL_INLINE = 1, MUL_R25 = 2, MUL_R25_CALL = 3 };

#ifdef __CUDA_ARCH__
__device__ __noinline__ fe fe_mul_call(fe f, fe g) { return fe_mul(f, g); }
#endif

#ifdef __CUDACC__
__host__ __device__ __noinline__
#else
static
#endif
fe25 fe25_mul_call(fe25 f, fe25 g) {
  return fe25_mul(f, g);
}

template <int K>
HD fe mul(const fe& f, const fe& g) {
#ifdef __CUDA_ARCH__
  if (K == MUL_CALL) return fe_mul_call(f, g);
#endif
  if (K == MUL_R25 || K == MUL_R25_CALL) {
    const fe25 a = fe25_from(f), b = fe25_from(g);
    return fe25_to(K == MUL_R25 ? fe25_mul(a, b) : fe25_mul_call(a, b));
  }
  return fe_mul(f, g);
}

// --- the point operations by product level -------------------------------------
// add-2008-hwcd-3 (with the 2d constant) and dbl-2008-hwcd, in the order of
// consensus_tpu/ops/ed25519.py::add and ::double, cut into their two levels
// of products.  Each level has four independent products; role r of a group
// of four computes product r, and the group hands every role all four
// before the next level.  ge_add and ge_dbl run every role in turn on one
// thread, so these stages are the one copy of each formula.

// a, b, c or d by role 0..3, without a branch.
HD fe fe_pick(int role, const fe& a, const fe& b, const fe& c, const fe& d) {
  fe r;
#pragma unroll
  for (int i = 0; i < 5; ++i)
    r.v[i] = role == 0 ? a.v[i] : role == 1 ? b.v[i] : role == 2 ? c.v[i] : d.v[i];
  return r;
}

// Double, level 1: role r's square of X, Y, Z, X + Y.
template <int K = MUL_CALL>
HD fe dbl_stage1(const ge& p, int role) {
  const fe x = fe_pick(role, p.X, p.Y, p.Z, fe_add(p.X, p.Y));
  return mul<K>(x, x);
}

// Double, level 2, from level 1's products m[0..3]: role r's coordinate of
// 2p.  Role 3 passes p.T through when need_t is false, as the JAX double
// does.
template <int K = MUL_CALL>
HD fe dbl_stage2(const ge& p, const fe* m, int role, bool need_t) {
  const fe c = fe_add(m[2], m[2]);
  const fe h = fe_add(m[0], m[1]);
  const fe e = fe_sub(h, m[3]);
  const fe g = fe_sub(m[0], m[1]);
  const fe f = fe_add(c, g);
  const fe r = mul<K>(fe_pick(role, e, g, f, e), fe_pick(role, f, h, g, h));
  return role == 3 && !need_t ? p.T : r;
}

// Role r's factor of q in the add's level 1: Y2 - X2, Y2 + X2, T2, Z2.
HD fe add_factor(const ge& q, int role) {
  return fe_pick(role, fe_sub(q.Y, q.X), fe_add(q.Y, q.X), q.T, q.Z);
}

// Add, level 1: role r's product of A, B, C = t1 * T2 and D = 2 Z1 * Z2,
// from role r's factor qf of q (add_factor) and t1 = 2d T1.  A caller whose q
// carries 2d T2 in place of T2 gives t1 = T1: C is the same mod p.
template <int K = MUL_CALL>
HD fe add_stage1(const ge& p, const fe& t1, const fe& qf, int role) {
  return mul<K>(fe_pick(role, fe_sub(p.Y, p.X), fe_add(p.Y, p.X), t1, fe_add(p.Z, p.Z)), qf);
}

// Add, level 2, from level 1's products m[0..3]: role r's coordinate of
// p + q.
template <int K = MUL_CALL>
HD fe add_stage2(const fe* m, int role) {
  const fe e = fe_sub(m[1], m[0]);
  const fe f = fe_sub(m[3], m[2]);
  const fe g = fe_add(m[3], m[2]);
  const fe h = fe_add(m[1], m[0]);
  return mul<K>(fe_pick(role, e, g, f, e), fe_pick(role, f, h, g, h));
}

// The complete add and the double on one thread: every role in turn.
HD ge ge_add(const ge& p, const ge& q) {
  const fe t1 = mul<MUL_CALL>(p.T, fe_d2());
  fe m[4], o[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) m[r] = add_stage1(p, t1, add_factor(q, r), r);
#pragma unroll
  for (int r = 0; r < 4; ++r) o[r] = add_stage2(m, r);
  return ge{o[0], o[1], o[2], o[3]};
}

HD ge ge_dbl(const ge& p, bool need_t) {
  fe m[4], o[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) m[r] = dbl_stage1(p, r);
#pragma unroll
  for (int r = 0; r < 4; ++r) o[r] = dbl_stage2(p, m, r, need_t);
  return ge{o[0], o[1], o[2], o[3]};
}

// --- decompression's field operations (kernel D1) --------------------------------

// d and sqrt(-1) = 2^((p-1)/4).
HD fe fe_d() {
  return fe{{0x34dca135978a3ULL, 0x1a8283b156ebdULL, 0x5e7a26001c029ULL,
             0x739c663a03cbbULL, 0x52036cee2b6ffULL}};
}

HD fe fe_sqrtm1() {
  return fe{{0x61b274a0ea0b0ULL, 0xd5a5fc8f189dULL, 0x7ef5e9cbd0c60ULL,
             0x78595a6804c9eULL, 0x2b8324804fc1dULL}};
}

// Reduced fe -> its canonical value in [0, p) as four little-endian 64-bit
// words: the steps of fe_store before its byte split.
HD void fe_canonical(const fe& h, u64 w[4]) {
  u64 t[5] = {h.v[0], h.v[1], h.v[2], h.v[3], h.v[4]};
  for (int pass = 0; pass < 3; ++pass) {
    t[1] += t[0] >> 51; t[0] &= MASK51;
    t[2] += t[1] >> 51; t[1] &= MASK51;
    t[3] += t[2] >> 51; t[2] &= MASK51;
    t[4] += t[3] >> 51; t[3] &= MASK51;
    t[0] += 19 * (t[4] >> 51); t[4] &= MASK51;
  }
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
  w[0] = t[0] | (t[1] << 51);
  w[1] = (t[1] >> 13) | (t[2] << 38);
  w[2] = (t[2] >> 26) | (t[3] << 25);
  w[3] = (t[3] >> 39) | (t[4] << 12);
}

HD bool fe_is_zero(const fe& f) {
  u64 w[4];
  fe_canonical(f, w);
  return (w[0] | w[1] | w[2] | w[3]) == 0;
}

HD bool fe_eq(const fe& f, const fe& g) { return fe_is_zero(fe_sub(f, g)); }

// The low bit of the canonical value: x and p - x differ in it for x != 0.
HD int fe_parity(const fe& f) {
  u64 w[4];
  fe_canonical(f, w);
  return (int)(w[0] & 1);
}

#ifdef __CUDACC__
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ fe fe_shfl(const fe& f, int src) {
  fe r;
#pragma unroll
  for (int i = 0; i < 5; ++i) r.v[i] = __shfl_sync(FULL, (unsigned long long)f.v[i], src);
  return r;
}

// Every lane of the aligned group of four lanes from `base` gets the four
// lanes' values, in lane order.
__device__ __forceinline__ void fe_exchange4(const fe& mine, fe* all, int base) {
#pragma unroll
  for (int k = 0; k < 4; ++k) all[k] = fe_shfl(mine, base + k);
}
#endif

}  // namespace
