// The Ed25519 add-and-compare: the last step of every Ed25519 wave, for
// Hopper (sm_90a).
//
// Kernel E1 of the port.  It replaces no TPU kernel: the JAX package runs this
// step on the device with plain XLA, fused into the verifier's jitted
// programs (consensus_tpu/ops/ed25519.py::add, ::equal and ::is_identity, as
// consensus_tpu/models/ed25519.py's strict and randomized bodies call them).
// Run eagerly in torch (the plain versions, ops/scan_kernels.py::
// add_and_equal_reference and ::add_is_identity_reference), it is about a
// hundred small launches a wave.  Per lane this kernel computes, as values
// mod p, S = acc + comb (add-2008-hwcd-3 with the 2d constant, in the order of
// ops/ed25519.py::add) and then, by mode:
//   0 (strict):   host_ok and r_ok and a_ok and S == R projectively
//                 (X_S Z_R == X_R Z_S and Y_S Z_R == Y_R Z_S), with acc =
//                 [k](-A) from B1, comb = [S]B from D2 and R from D1;
//   1 (identity): S is the neutral element (X_S == 0 and Y_S == Z_S), with
//                 acc the randomized check's joined point from B3 and comb
//                 [sum z s]B from D2 (batch 1);
// and writes the verdict as one byte a lane.  Every comparison is between
// canonical values, so the verdict is the plain version's bit for bit.
//
// What bounds it on this card: bytes.  Every lane reads acc and comb (eight
// (32,) float32 limb vectors) and writes one byte; a strict lane also reads
// host_ok (1,026 bytes), r_ok and a_ok only where the masks before them pass,
// and R's X, Y and Z (384 bytes) only where all three pass.  Its work is the
// add's 9 field multiplications (8, and one by 2d), the X comparison's 2 on
// a lane whose masks pass and the Y comparison's 2 where X matches.  On a
// strict wave of 8,192 lanes with 6,825 of them compared that is about
// 11.0 MB against some 7.3 million 32x32->64-bit products.  One thread a
// lane, 64 a block, products in radix 2^51 through the header's one
// out-of-line fe_mul.
//
// Layout at the C boundary (batch trailing, limbs leading): acc X, Y, Z, T and
// comb X, Y, Z, T as (32, n) float32 limbs, R's four coordinates as (32, n)
// float32 limbs with row stride r_ld (D1 writes R and A side by side, so R's
// rows are 2n apart), all under the field module's weak contract, each
// carried into radix 2^51 by fe_load's exact integer pass; host_ok, r_ok and
// a_ok as (n,) bytes (torch.bool); the (n,) byte verdict (0 or 1).  Mode 1
// reads neither R nor the masks (the wrapper passes null pointers).
//
// Everything above the __CUDACC__ line is __host__ __device__, so the same
// source compiles as plain C++ for the host check
// (tests/test_torch_verdict_kernels.py).

#include "ed25519_field.cuh"

namespace {

constexpr int VERDICT_LANES = 64;  // lanes (threads) a block
constexpr int MODE_EQUAL = 0;
constexpr int MODE_IDENTITY = 1;

HD ge load_point(const float* x, const float* y, const float* z, const float* t,
                 long long stride, long long lane) {
  return ge{fe_load(x + lane, stride), fe_load(y + lane, stride), fe_load(z + lane, stride),
            fe_load(t + lane, stride)};
}

// The verdict of the lane at column `lane`: acc's and comb's coordinates at
// a[i] and c[i] (X, Y, Z, T), R's at r[i] with row stride r_ld.
HD uint8_t verdict_lane(const float* const* a, const float* const* c, const float* const* r,
                        const uint8_t* host_ok, const uint8_t* r_ok, const uint8_t* a_ok,
                        int mode, long long n, long long r_ld, long long lane) {
  const ge s = ge_add(load_point(a[0], a[1], a[2], a[3], n, lane),
                      load_point(c[0], c[1], c[2], c[3], n, lane));
  if (mode == MODE_IDENTITY) return fe_is_zero(s.X) && fe_eq(s.Y, s.Z) ? 1 : 0;
  if (!(host_ok[lane] && r_ok[lane] && a_ok[lane])) return 0;
  const fe rx = fe_load(r[0] + lane, r_ld), ry = fe_load(r[1] + lane, r_ld);
  const fe rz = fe_load(r[2] + lane, r_ld);
  const bool same = fe_eq(mul<MUL_CALL>(s.X, rz), mul<MUL_CALL>(rx, s.Z)) &&
                    fe_eq(mul<MUL_CALL>(s.Y, rz), mul<MUL_CALL>(ry, s.Z));
  return same ? 1 : 0;
}

}  // namespace

#ifdef __CUDACC__

struct point_ptrs {
  const float* c[4];
};

__global__ void __launch_bounds__(VERDICT_LANES)
verdict25519_kernel(point_ptrs acc, point_ptrs comb, point_ptrs r,
                    const uint8_t* __restrict__ host_ok, const uint8_t* __restrict__ r_ok,
                    const uint8_t* __restrict__ a_ok, uint8_t* __restrict__ out, int n,
                    int mode, long long r_ld) {
  const long long lane = (long long)blockIdx.x * VERDICT_LANES + threadIdx.x;
  if (lane >= n) return;
  out[lane] = verdict_lane(acc.c, comb.c, r.c, host_ok, r_ok, a_ok, mode, n, r_ld, lane);
}

// Launches on `stream` of CUDA device `device` and returns the launch's
// cudaGetLastError() (0 on success).  Mode 1 takes null R and mask pointers.
extern "C" int verdict25519_launch(const void* ax, const void* ay, const void* az,
                                   const void* at, const void* cx, const void* cy,
                                   const void* cz, const void* ct, const void* rx,
                                   const void* ry, const void* rz, const void* rt,
                                   const void* host_ok, const void* r_ok, const void* a_ok,
                                   void* out, int n, int mode, int r_ld, int device,
                                   void* stream) {
  if (n <= 0) return 0;
  if (mode != MODE_EQUAL && mode != MODE_IDENTITY) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const point_ptrs acc = {{(const float*)ax, (const float*)ay, (const float*)az,
                           (const float*)at}};
  const point_ptrs comb = {{(const float*)cx, (const float*)cy, (const float*)cz,
                            (const float*)ct}};
  const point_ptrs r = {{(const float*)rx, (const float*)ry, (const float*)rz,
                         (const float*)rt}};
  const int blocks = (n + VERDICT_LANES - 1) / VERDICT_LANES;
  verdict25519_kernel<<<blocks, VERDICT_LANES, 0, (cudaStream_t)stream>>>(
      acc, comb, r, (const uint8_t*)host_ok, (const uint8_t*)r_ok, (const uint8_t*)a_ok,
      (uint8_t*)out, n, mode, (long long)r_ld);
  return (int)cudaGetLastError();
}

extern "C" const char* verdict25519_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
