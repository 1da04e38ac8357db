// Trial alternative to consensus_tpu_torch/csrc/verdict_p256.cu for
// scripts/e1_p1_trials.py: kernel P2's first design, one thread a lane (64 a
// block) through p256_field.cuh's serial complete add, kept to be timed
// beside the redesign in one call.  Its host replay is no longer run by the
// tests; csrc's design is the one they replay.
//
// The P-256 verdict: the last step of the ECDSA wave, for Hopper (sm_90a).
//
// Kernel P2 of the port.  It replaces no TPU kernel: the JAX package runs
// these checks on the device with plain XLA, fused into the verifier's jitted
// program (consensus_tpu/models/ecdsa_p256.py::verify_impl's on-curve check
// and final lines; consensus_tpu/ops/p256.py::on_curve and ::add).  Run
// eagerly in torch (the plain version, ops/scan_kernels.py::
// verdict_p256_reference), they are hundreds of small launches a wave.  Per
// lane this kernel computes, as values mod p:
//   R' = acc + comb (RCB15 Algorithm 4, a = -3: acc is [u2]Q from B2, comb
//   [u1]G from P1);
//   nonzero = Z(R') != 0;
//   match = X(R') == r Z(R'), or has_r2 and X(R') == (r + n) Z(R');
//   on_curve = qy^2 == qx^3 - 3 qx + b;
//   verdict = host_ok and on_curve and nonzero and match;
// and writes the verdict as one byte a lane.  Every comparison is between
// canonical values, so the verdict is the plain version's bit for bit.  The
// on-curve check is this kernel's, the wave's last launch: B2's and P1's
// formulas are polynomials, so an off-curve key runs through them as before
// and its lane is refused here, by the same AND.
//
// What bounds it on this card: bytes.  A lane reads nine (32,) float32 limb
// vectors (acc, comb, qx, qy, r1) and two bytes and writes one (1,155
// bytes), and reads r2 (128 more) only where has_r2 is set; its work is 16
// field multiplications and 2 squarings (the add's 14, r Z and qx^2 qx;
// qy^2 and qx^2), and (r + n) Z where has_r2 is set.  At 2,048 lanes that is
// 2.4 MB against some 2.2 million 32x32->64-bit products.  One thread a lane, 64 a block: the products of
// one lane are one chain, and at the wave's width the card is busy for
// microseconds either way.
//
// Layout at the C boundary (batch trailing, limbs leading): acc X, Y, Z,
// comb X, Y, Z, qx, qy, r1 (r) and r2 (r + n) as (32, n) float32 limbs under
// the field module's weak contract (|limb| <= 600, |value| < 2^262), each
// carried into words by fe_load's exact integer sums; has_r2 and host_ok as
// (n,) bytes (torch.bool); the (n,) byte verdict (0 or 1).
//
// Everything above the __CUDACC__ line is __host__ __device__, so the same
// source compiles as plain C++ for the host check
// (tests/test_torch_verdict_kernels.py).

#include "p256_field.cuh"

namespace {

constexpr int VERDICT_LANES = 64;  // lanes (threads) a block

HD bool fe_equal(const fe& a, const fe& b) {
  bool same = true;
  for (int i = 0; i < 8; ++i) same = same && a.v[i] == b.v[i];
  return same;
}

HD bool fe_is_zero(const fe& a) { return fe_equal(a, fe_zero()); }

// The verdict of the lane at column `lane` of the (32, n) inputs.
HD uint8_t verdict_lane(const float* ax, const float* ay, const float* az, const float* cx,
                        const float* cy, const float* cz, const float* qx, const float* qy,
                        const float* r1, const float* r2, const uint8_t* has_r2,
                        const uint8_t* host_ok, long long n, long long lane) {
  const ge acc = {fe_load(ax + lane, n), fe_load(ay + lane, n), fe_load(az + lane, n)};
  const ge comb = {fe_load(cx + lane, n), fe_load(cy + lane, n), fe_load(cz + lane, n)};
  const ge s = ge_add(acc, comb);
  const bool nonzero = !fe_is_zero(s.Z);
  const bool match1 = fe_equal(s.X, mul(fe_load(r1 + lane, n), s.Z));
  const bool match2 = has_r2[lane] != 0 && fe_equal(s.X, mul(fe_load(r2 + lane, n), s.Z));
  const fe x = fe_load(qx + lane, n), y = fe_load(qy + lane, n);
  const fe x3 = mul(fe_sqr(x), x);
  const fe rhs = fe_add(fe_sub(x3, fe_add(fe_add(x, x), x)), fe_b());
  const bool on_curve = fe_equal(fe_sqr(y), rhs);
  return host_ok[lane] != 0 && on_curve && nonzero && (match1 || match2) ? 1 : 0;
}

}  // namespace

#ifdef __CUDACC__

__global__ void __launch_bounds__(VERDICT_LANES)
verdict_p256_kernel(const float* __restrict__ ax, const float* __restrict__ ay,
                    const float* __restrict__ az, const float* __restrict__ cx,
                    const float* __restrict__ cy, const float* __restrict__ cz,
                    const float* __restrict__ qx, const float* __restrict__ qy,
                    const float* __restrict__ r1, const float* __restrict__ r2,
                    const uint8_t* __restrict__ has_r2, const uint8_t* __restrict__ host_ok,
                    uint8_t* __restrict__ out, int n) {
  const long long lane = (long long)blockIdx.x * VERDICT_LANES + threadIdx.x;
  if (lane >= n) return;
  out[lane] = verdict_lane(ax, ay, az, cx, cy, cz, qx, qy, r1, r2, has_r2, host_ok, n, lane);
}

// Launches on `stream` of CUDA device `device` and returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int verdict_p256_launch(const void* ax, const void* ay, const void* az,
                                   const void* cx, const void* cy, const void* cz,
                                   const void* qx, const void* qy, const void* r1,
                                   const void* r2, const void* has_r2, const void* host_ok,
                                   void* out, int n, int device, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + VERDICT_LANES - 1) / VERDICT_LANES;
  verdict_p256_kernel<<<blocks, VERDICT_LANES, 0, (cudaStream_t)stream>>>(
      (const float*)ax, (const float*)ay, (const float*)az, (const float*)cx, (const float*)cy,
      (const float*)cz, (const float*)qx, (const float*)qy, (const float*)r1, (const float*)r2,
      (const uint8_t*)has_r2, (const uint8_t*)host_ok, (uint8_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" const char* verdict_p256_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
