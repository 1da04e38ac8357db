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
// and the valid mask as one byte a point.
//
// What bounds it on this card: latency.  A point is one chain of 275
// dependent field products (255 squarings, 251 of them the (p-5)/8 power,
// and 20 multiplications); at 16,384 points (R and A of an 8,192-lane wave)
// the products over every SM take microseconds and the bytes (~10 MB) a few
// more, but each thread's chain runs one product after another.
//
// What the design does about it: one thread per point, 64 threads a block
// (256 blocks at 16,384 points, so every SM holds about 4 warps with none
// idle).  The squaring runs are one out-of-line loop (fe_sqn) and the
// multiplication one out-of-line copy (MUL_CALL), so the kernel is a few
// thousand instructions and stays in the instruction cache.  The sqrt(-1)
// product and the negation are computed on every lane and selected, without
// a branch.
//
// Layout at the C boundary (batch trailing, limbs leading, as in the JAX
// package): (32, m) float32 y limbs, weakly reduced (bytes 0-255 from the
// host); (m,) int32 sign bits; four (32, m) float32 outputs holding canonical
// limbs in [0, 255]; (m,) uint8 valid mask (0 or 1, a torch.bool tensor).
//
// Everything above the __CUDACC__ line is __host__ __device__, so the same
// source compiles as plain C++ for the host check
// (tests/test_torch_decompress_comb.py).

#include "ed25519_field.cuh"

namespace {

constexpr int POINTS = 64;  // points (threads) a block

HD fe fe_select(bool cond, const fe& a, const fe& b) {
  fe r;
  for (int i = 0; i < 5; ++i) r.v[i] = cond ? a.v[i] : b.v[i];
  return r;
}

// Point `lane` of m: reads y's limbs at y[i * m + lane] and the sign at
// sign[lane]; writes X, Y, Z, T the same way and the mask at valid[lane].
HD void decompress_point(const float* y_limbs, const int32_t* sign, float* ox, float* oy,
                         float* oz, float* ot, uint8_t* valid, long long m, long long lane) {
  const fe y = fe_load(y_limbs + lane, m);
  const fe one = fe_one();
  const fe y2 = fe_sq(y);
  const fe u = fe_sub(y2, one);
  const fe v = fe_add(mul<MUL_CALL>(fe_d(), y2), one);
  const fe v3 = mul<MUL_CALL>(fe_sq(v), v);
  const fe v7 = mul<MUL_CALL>(fe_sq(v3), v);
  fe x = mul<MUL_CALL>(mul<MUL_CALL>(u, v3), fe_pow22523(mul<MUL_CALL>(u, v7)));

  const fe vx2 = mul<MUL_CALL>(v, fe_sq(x));
  const bool root_ok = fe_eq(vx2, u);
  const bool root_neg = fe_eq(vx2, fe_neg(u));
  x = fe_select(root_neg, mul<MUL_CALL>(x, fe_sqrtm1()), x);
  bool ok = root_ok || root_neg;

  const bool x_zero = fe_is_zero(x);
  const int32_t s = sign[lane];
  ok = ok && !(x_zero && s == 1);  // x = 0 has no negative twin
  x = fe_select(fe_parity(x) != s && !x_zero, fe_neg(x), x);

  fe_store(ox + lane, m, x);
  fe_store(oy + lane, m, y);
  fe_store(oz + lane, m, one);
  fe_store(ot + lane, m, mul<MUL_CALL>(x, y));
  valid[lane] = ok ? 1 : 0;
}

}  // namespace

#ifdef __CUDACC__

__global__ void __launch_bounds__(POINTS)
decompress25519_kernel(const float* __restrict__ y_limbs, const int32_t* __restrict__ sign,
                       float* __restrict__ ox, float* __restrict__ oy, float* __restrict__ oz,
                       float* __restrict__ ot, uint8_t* __restrict__ valid, int m) {
  const long long lane = (long long)blockIdx.x * POINTS + threadIdx.x;
  if (lane >= m) return;
  decompress_point(y_limbs, sign, ox, oy, oz, ot, valid, m, lane);
}

// Launches on `stream` of CUDA device `device` and returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int decompress25519_launch(const void* y_limbs, const void* sign, void* ox,
                                      void* oy, void* oz, void* ot, void* valid, int m,
                                      int device, void* stream) {
  if (m <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (m + POINTS - 1) / POINTS;
  decompress25519_kernel<<<blocks, POINTS, 0, (cudaStream_t)stream>>>(
      (const float*)y_limbs, (const int32_t*)sign, (float*)ox, (float*)oy, (float*)oz,
      (float*)ot, (uint8_t*)valid, m);
  return (int)cudaGetLastError();
}

extern "C" const char* decompress25519_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
