// Horner scan [u2]Q on P-256 for the ECDSA batch verifier, for Hopper (sm_90a).
//
// Replaces the TPU kernel consensus_tpu/ops/pallas_scan.py::horner_scan_p256
// (body _scan_kernel_p256): per signature, build the 9-entry table j*Q with
// table[0] = (0 : 1 : 0), table[1] = Q and 7 sequential complete adds, then
// walk 65 signed 4-bit windows MSB first (the first holds the recoding
// carry) -- 4 doubles, table[|d|], Y negated when d < 0, one complete add.
// The formulas are the TPU kernel's (Renes-Costello-Batina 2015, Algorithms
// 4 and 6 for a = -3) in the same sequence, so with exact arithmetic mod p
// this kernel lands on the same projective representative as the plain
// torch version (consensus_tpu_torch/ops/scan_kernels.py::
// horner_scan_p256_reference); it writes that representative as canonical
// 8-bit limbs.  The formulas are polynomials, so off-curve Q (padded or
// rejected lanes) follow the same sequence to the same result.
//
// What bounds it on this card: integer multiplies.  Per lane it does 72
// complete adds (14 multiplications each, 2 of them by b) and 260 doubles
// (10 multiplications and 3 squarings each): 3,608 multiplications at 64
// and 780 squarings at 36 32x32->64-bit products, against ~1.8 MB of memory
// traffic at 2,048 lanes.
//
// What the design does about it, first version: one thread per signature,
// 8 x 32-bit words, so every partial product is one IMAD.WIDE, instead of
// the TPU layout's 32 x 8-bit f32 limbs (which exist only because the TPU's
// vector unit has no integer multiply).  Products reduce by FIPS 186-4
// D.2.3's word assembly (the Solinas matrix of the TPU kernel, word by
// word) with signed 64-bit word sums; every field value between operations
// is canonical, in [0, p).  The table stays in per-thread local memory and
// is read with a direct index on |d|.  Warp-cooperative multiplies,
// shared-memory tables and tensor-core products are later work.
//
// Layout at the C boundary (batch trailing, limbs leading, as in the JAX
// package): qx, qy as (32, batch) float32 limbs under the field module's
// weak contract (|limb| <= 600, |value| < 2^262; the engine passes bytes);
// (65, batch) int32 digits stored as d + 8 with d in [-8, 7] (the carry
// window holds 8 or 9); three (32, batch) float32 outputs holding canonical
// limbs in [0, 255].
//
// The arithmetic is written __host__ __device__ so the same source can be
// compiled as plain C++ for a host-side check; only the kernel and the C entry
// points need nvcc.

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

constexpr int WINDOWS = 65;
constexpr int TABLE = 9;
constexpr int LIMBS8 = 32;
constexpr int DIGIT_MAX = 2 * (TABLE - 1);  // d + 8 with |d| <= 8

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

// RCB15 Algorithm 4, in the order of consensus_tpu/ops/p256.py::add.
HD ge ge_add(const ge& p, const ge& q) {
  const fe b = fe_b();
  fe t0 = fe_mul(p.X, q.X);
  fe t1 = fe_mul(p.Y, q.Y);
  fe t2 = fe_mul(p.Z, q.Z);
  fe t3 = fe_add(p.X, p.Y);
  fe t4 = fe_add(q.X, q.Y);
  t3 = fe_mul(t3, t4);
  t4 = fe_add(t0, t1);
  t3 = fe_sub(t3, t4);
  t4 = fe_add(p.Y, p.Z);
  fe t5 = fe_add(q.Y, q.Z);
  t4 = fe_mul(t4, t5);
  t5 = fe_add(t1, t2);
  t4 = fe_sub(t4, t5);
  fe x3 = fe_add(p.X, p.Z);
  fe y3 = fe_add(q.X, q.Z);
  x3 = fe_mul(x3, y3);
  y3 = fe_add(t0, t2);
  y3 = fe_sub(x3, y3);
  fe z3 = fe_mul(b, t2);
  x3 = fe_sub(y3, z3);
  z3 = fe_add(x3, x3);
  x3 = fe_add(x3, z3);
  z3 = fe_sub(t1, x3);
  x3 = fe_add(t1, x3);
  y3 = fe_mul(b, y3);
  t1 = fe_add(t2, t2);
  t2 = fe_add(t1, t2);
  y3 = fe_sub(y3, t2);
  y3 = fe_sub(y3, t0);
  t1 = fe_add(y3, y3);
  y3 = fe_add(t1, y3);
  t1 = fe_add(t0, t0);
  t0 = fe_add(t1, t0);
  t0 = fe_sub(t0, t2);
  t1 = fe_mul(t4, y3);
  t2 = fe_mul(t0, y3);
  y3 = fe_mul(x3, z3);
  y3 = fe_add(y3, t2);
  x3 = fe_mul(t3, x3);
  x3 = fe_sub(x3, t1);
  z3 = fe_mul(t4, z3);
  t1 = fe_mul(t3, t0);
  z3 = fe_add(z3, t1);
  return ge{x3, y3, z3};
}

// RCB15 Algorithm 6, in the order of consensus_tpu/ops/p256.py::double.
HD ge ge_dbl(const ge& p) {
  const fe b = fe_b();
  fe t0 = fe_sqr(p.X);
  fe t1 = fe_sqr(p.Y);
  fe t2 = fe_sqr(p.Z);
  fe t3 = fe_mul(p.X, p.Y);
  t3 = fe_add(t3, t3);
  fe z3 = fe_mul(p.X, p.Z);
  z3 = fe_add(z3, z3);
  fe y3 = fe_mul(b, t2);
  y3 = fe_sub(y3, z3);
  fe x3 = fe_add(y3, y3);
  y3 = fe_add(x3, y3);
  x3 = fe_sub(t1, y3);
  y3 = fe_add(t1, y3);
  y3 = fe_mul(x3, y3);
  x3 = fe_mul(x3, t3);
  t3 = fe_add(t2, t2);
  t2 = fe_add(t2, t3);
  z3 = fe_mul(b, z3);
  z3 = fe_sub(z3, t2);
  z3 = fe_sub(z3, t0);
  t3 = fe_add(z3, z3);
  z3 = fe_add(z3, t3);
  t3 = fe_add(t0, t0);
  t0 = fe_add(t3, t0);
  t0 = fe_sub(t0, t2);
  t0 = fe_mul(t0, z3);
  y3 = fe_add(y3, t0);
  t0 = fe_mul(p.Y, p.Z);
  t0 = fe_add(t0, t0);
  z3 = fe_mul(t0, z3);
  x3 = fe_sub(x3, z3);
  z3 = fe_mul(t0, t1);
  z3 = fe_add(z3, z3);
  z3 = fe_add(z3, z3);
  return ge{x3, y3, z3};
}

// One lane of the scan.  Coordinates and digits are read at column `lane` of
// their (rows, batch) arrays.
HD void horner_lane_p256(const float* qx, const float* qy, const int32_t* digits,
                         float* ox, float* oy, float* oz, long long batch,
                         long long lane) {
  const ge q = {fe_load(qx + lane, batch), fe_load(qy + lane, batch), fe_one()};
  ge table[TABLE];
  table[0] = ge_identity();
  table[1] = q;
  for (int j = 2; j < TABLE; ++j) table[j] = ge_add(table[j - 1], q);

  ge acc = ge_identity();
  for (int w = 0; w < WINDOWS; ++w) {
    // A digit outside the d + 8 encoding's [0, 16] is not a valid input;
    // the clamp only keeps such a lane from reading outside the table.
    int digit = digits[w * batch + lane];
    digit = digit < 0 ? 0 : (digit > DIGIT_MAX ? DIGIT_MAX : digit);
    const int d = digit - (TABLE - 1);
    acc = ge_dbl(acc);
    acc = ge_dbl(acc);
    acc = ge_dbl(acc);
    acc = ge_dbl(acc);
    ge t = table[d < 0 ? -d : d];
    if (d < 0) t.Y = fe_neg(t.Y);
    acc = ge_add(acc, t);
  }
  fe_store(ox + lane, batch, acc.X);
  fe_store(oy + lane, batch, acc.Y);
  fe_store(oz + lane, batch, acc.Z);
}

}  // namespace

#ifdef __CUDACC__

constexpr int THREADS = 64;

__global__ void __launch_bounds__(THREADS)
horner_scan_p256_kernel(const float* __restrict__ qx, const float* __restrict__ qy,
                        const int32_t* __restrict__ digits, float* __restrict__ ox,
                        float* __restrict__ oy, float* __restrict__ oz, int batch) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;  // the ragged edge
  horner_lane_p256(qx, qy, digits, ox, oy, oz, batch, lane);
}

// Launches on `stream` of CUDA device `device` and returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int horner_scan_p256_launch(const void* qx, const void* qy,
                                       const void* digits, void* ox, void* oy,
                                       void* oz, int batch, int device,
                                       void* stream) {
  if (batch <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (batch + THREADS - 1) / THREADS;
  horner_scan_p256_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)qx, (const float*)qy, (const int32_t*)digits, (float*)ox,
      (float*)oy, (float*)oz, batch);
  return (int)cudaGetLastError();
}

extern "C" const char* horner_scan_p256_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
