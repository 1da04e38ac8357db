// Ed25519 point decompression (RFC 8032 section 5.1.3), for Hopper (sm_90a).
//
// Kernel D1 of the port.  It replaces no TPU kernel: the JAX package
// decompresses on the device with plain XLA
// (consensus_tpu/ops/ed25519.py::decompress), fused into the verifier's jitted
// program.  Run eagerly in torch (consensus_tpu_torch/ops/ed25519.py::
// decompress, the plain version), it is hundreds of small launches a wave.
// This kernel computes the same function, step for step, as values mod p:
//   u = y^2 - 1, v = d y^2 + 1, x = u v^3 (u v^7)^((p-5)/8);
//   root_ok = (v x^2 == u), root_neg = (v x^2 == -u), x *= sqrt(-1) where
//   root_neg, valid = root_ok | root_neg;
//   x = 0 with sign 1 is invalid; x is negated where its parity differs from
//   the sign and x != 0 (on every lane, valid or not, as the plain version);
//   Z = 1, T = x y.
// It writes X, Y, Z and T as canonical limbs, so every output equals the
// plain version's after fe.freeze (Y is y mod p: a y >= p input is reduced),
// and the valid mask as one byte a point.  Its negate option names halves of
// the stack (bit 0 the first m / 2 points, R; bit 1 the rest, A) whose
// points it writes negated, (p - X) mod p and (p - T) mod p: the strict body
// takes -A (bit 1) and the batch bodies -R and -A (both); the plain version
// is ops/ed25519.py::negate after the plain decompression.
//
// What bounds it on this card: latency.  A point is one chain of 275
// dependent field products (255 squarings, 251 of them the (p-5)/8 power,
// and 20 multiplications); at 16,384 points (R and A of an 8,192-lane wave)
// the products over every SM take microseconds and the bytes (~10 MB) a few
// more, but each thread's chain runs one product after another.  In radix
// 2^51 a squaring is 15 64x64->128-bit products, each several dependent
// 32-bit multiply-adds on this card, and one thread per point (64 a block)
// took 0.112-0.115 ms at 16,384 points and as long at 512 (NVIDIA H100 80GB
// HBM3, 700.00 W): some 750 cycles a product.
//
// What the design does about it: every product in radix 2^25.5 (fe25 of
// ed25519_field.cuh: ten limbs of 26 and 25 bits in uint32).  A term is then
// one 32x32->64 multiply-add (IMAD.WIDE.U32) into a 64-bit column, a squaring
// 55 of them and a multiplication 100, with ref10's carry chain.  The
// additions, the comparisons and the canonical store stay in radix 2^51 (fe);
// a product converts its factors in and its result out (a few shifts and
// masks), and the (p-5)/8 power runs in fe25 from end to end.  One thread per
// point, 64 a block; the squaring runs are one out-of-line loop (fe25_sqn)
// and the multiplication one out-of-line copy (fe25_mul_call), so the kernel
// stays in the instruction cache.  The sqrt(-1) product and the negation are
// computed on every lane and selected, without a branch.  In one call on an
// NVIDIA H100 80GB HBM3 at 700.00 W (scripts/d1_d2_trials.py) it took
// 0.069 ms at 16,384 points where one thread in radix 2^51 took 0.105; the
// time is the same at 16 points, so each thread's own instruction stream,
// not the card's width, sets it.  Two other designs were slower at 16,384
// points in that call: the power's products split by column over a group of
// five threads, handing limbs and carries on by __shfl_sync (0.183 ms; 0.064
// at 16 to 2,048 points), and the carries in two parallel rounds in place of
// the chain (0.077 ms).
//
// Layout at the C boundary (batch trailing, limbs leading, as in the JAX
// package): (32, m) float32 y limbs, weakly reduced (bytes 0-255 from the
// host); (m,) int32 sign bits; four (32, m) float32 outputs holding canonical
// limbs in [0, 255]; (m,) uint8 valid mask (0 or 1, a torch.bool tensor);
// the int negate flags (bits 0 and 1; m even where either is set).
//
// Everything above the __CUDACC__ line is __host__ __device__, so the same
// source compiles as plain C++ for the host check
// (tests/test_torch_decompress_comb.py).

#include "ed25519_field.cuh"

namespace {

constexpr int POINTS = 64;  // points (threads) a block

// On the card one out-of-line copy of the squaring loop, as of fe25_mul
// (fe25_mul_call, ed25519_field.cuh), so that the kernel's code fits the
// instruction cache.
#ifdef __CUDACC__
__host__ __device__ __noinline__
#else
static
#endif
fe25 fe25_sqn(fe25 f, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) f = fe25_sq(f);
  return f;
}

// z^((p-5)/8) = z^(2^252 - 3): the chain of ref10's fe_pow22523, 251
// squarings and 11 multiplications.
HD fe25 fe25_pow22523(const fe25& z) {
  const fe25 z2 = fe25_sq(z);
  const fe25 z9 = fe25_mul_call(z, fe25_sqn(z2, 2));
  const fe25 z11 = fe25_mul_call(z2, z9);
  const fe25 z_5_0 = fe25_mul_call(z9, fe25_sq(z11));                   // 2^5 - 1
  const fe25 z_10_0 = fe25_mul_call(fe25_sqn(z_5_0, 5), z_5_0);        // 2^10 - 1
  const fe25 z_20_0 = fe25_mul_call(fe25_sqn(z_10_0, 10), z_10_0);     // 2^20 - 1
  const fe25 z_40_0 = fe25_mul_call(fe25_sqn(z_20_0, 20), z_20_0);     // 2^40 - 1
  const fe25 z_50_0 = fe25_mul_call(fe25_sqn(z_40_0, 10), z_10_0);     // 2^50 - 1
  const fe25 z_100_0 = fe25_mul_call(fe25_sqn(z_50_0, 50), z_50_0);    // 2^100 - 1
  const fe25 z_200_0 = fe25_mul_call(fe25_sqn(z_100_0, 100), z_100_0); // 2^200 - 1
  const fe25 z_250_0 = fe25_mul_call(fe25_sqn(z_200_0, 50), z_50_0);   // 2^250 - 1
  return fe25_mul_call(fe25_sqn(z_250_0, 2), z);                        // 2^252 - 3
}

HD fe sq25(const fe& f) { return fe25_to(fe25_sq(fe25_from(f))); }

HD fe fe_select(bool cond, const fe& a, const fe& b) {
  fe r;
  for (int i = 0; i < 5; ++i) r.v[i] = cond ? a.v[i] : b.v[i];
  return r;
}

// Whether point `lane` of m is written negated under the negate flags.
HD bool point_negated(long long m, long long lane, int negate) {
  return (negate >> (lane < m / 2 ? 0 : 1)) & 1;
}

// Point `lane` of m: reads y's limbs at y[i * m + lane] and the sign at
// sign[lane]; writes X, Y, Z, T (the point's negation where `neg`) the same
// way and the mask at valid[lane].
HD void decompress_point(const float* y_limbs, const int32_t* sign, float* ox, float* oy,
                         float* oz, float* ot, uint8_t* valid, long long m, long long lane,
                         bool neg) {
  const fe y = fe_load(y_limbs + lane, m);
  const fe one = fe_one();
  const fe y2 = sq25(y);
  const fe u = fe_sub(y2, one);
  const fe v = fe_add(mul<MUL_R25_CALL>(fe_d(), y2), one);
  const fe v3 = mul<MUL_R25_CALL>(sq25(v), v);
  const fe v7 = mul<MUL_R25_CALL>(sq25(v3), v);
  const fe pow = fe25_to(fe25_pow22523(fe25_from(mul<MUL_R25_CALL>(u, v7))));
  fe x = mul<MUL_R25_CALL>(mul<MUL_R25_CALL>(u, v3), pow);

  const fe vx2 = mul<MUL_R25_CALL>(v, sq25(x));
  const bool root_ok = fe_eq(vx2, u);
  const bool root_neg = fe_eq(vx2, fe_neg(u));
  x = fe_select(root_neg, mul<MUL_R25_CALL>(x, fe_sqrtm1()), x);
  bool ok = root_ok || root_neg;

  const bool x_zero = fe_is_zero(x);
  const int32_t s = sign[lane];
  ok = ok && !(x_zero && s == 1);  // x = 0 has no negative twin
  x = fe_select(fe_parity(x) != s && !x_zero, fe_neg(x), x);

  const fe t = mul<MUL_R25_CALL>(x, y);
  fe_store(ox + lane, m, fe_select(neg, fe_neg(x), x));
  fe_store(oy + lane, m, y);
  fe_store(oz + lane, m, one);
  fe_store(ot + lane, m, fe_select(neg, fe_neg(t), t));
  valid[lane] = ok ? 1 : 0;
}

}  // namespace

#ifdef __CUDACC__

__global__ void __launch_bounds__(POINTS)
decompress25519_kernel(const float* __restrict__ y_limbs, const int32_t* __restrict__ sign,
                       float* __restrict__ ox, float* __restrict__ oy, float* __restrict__ oz,
                       float* __restrict__ ot, uint8_t* __restrict__ valid, int m,
                       int negate) {
  const long long lane = (long long)blockIdx.x * POINTS + threadIdx.x;
  if (lane >= m) return;
  decompress_point(y_limbs, sign, ox, oy, oz, ot, valid, m, lane,
                   point_negated(m, lane, negate));
}

// Launches on `stream` of CUDA device `device` and returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int decompress25519_launch(const void* y_limbs, const void* sign, void* ox,
                                      void* oy, void* oz, void* ot, void* valid, int m,
                                      int negate, int device, void* stream) {
  if (negate < 0 || negate > 3 || (negate && m % 2)) return (int)cudaErrorInvalidValue;
  if (m <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (m + POINTS - 1) / POINTS;
  decompress25519_kernel<<<blocks, POINTS, 0, (cudaStream_t)stream>>>(
      (const float*)y_limbs, (const int32_t*)sign, (float*)ox, (float*)oy, (float*)oz,
      (float*)ot, (uint8_t*)valid, m, negate);
  return (int)cudaGetLastError();
}

extern "C" const char* decompress25519_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
