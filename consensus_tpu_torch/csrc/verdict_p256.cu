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
// What bounds it on this card: bytes, and then one lane's latency.  A lane
// reads nine (32,) float32 limb vectors (acc, comb, qx, qy, r1) and two
// bytes and writes one (1,155 bytes), and reads r2 (128 more) only where
// has_r2 is set; its work is 16 field multiplications and 2 squarings (the
// add's 14, r Z and qx^2 qx; qy^2 and qx^2), and (r + n) Z where has_r2 is
// set: 2.4 MB at 2,048 lanes, 0.7 us over the memory, against a few
// microseconds of one lane's products in a row.  The first design, one
// thread a lane (64 a block) through the header's serial add, took 0.023 ms
// at 2,048 lanes replayed from a CUDA graph on an NVIDIA H100 80GB HBM3 at
// 700.00 W, at 124 registers and a 448-byte stack frame (the add's 14 slots
// on the thread's stack): 19 products one after another.
//
// What the design does about it, in the shape of kernels E1 and P1:
// - A group of G = 8 threads a lane (p256_field.cuh's G), 8 lanes a 64-thread
//   block, one product each per level, meeting at __syncwarp on the group's
//   own lanes over slots in shared memory.  The products fall into 4 levels
//   where one thread ran 19:
//     1  the add's level 1 (X1 X2, Y1 Y2, Z1 Z2 and the three sums' products:
//        roles 0-5), qx^2 (role 6) and qy^2 (role 7);
//     2  the add's level 2 (b t2, b y3: roles 0-1) and qx^2 qx (role 2);
//     3  the add's level 3 (roles 0-5);
//     4  r Z (role 0) and, where has_r2, (r + n) Z (role 1).
//   Role 0 then compares and writes the verdict.
// - Coalesced loads: the block first stages its 8 lanes' ten (32,) limb
//   vectors (r2 only where has_r2) in shared memory, each warp reading 4 rows
//   of 8 adjacent lanes, a whole 32-byte sector each; then role r carries
//   vector r (acc X, Y, Z, comb X, Y, Z, qx, qy; roles 0-1 also r1 and r2)
//   into canonical words by fe_load, into the group's slots.
// - No stack frame: the slots are in shared memory, every loop over them
//   unrolled with constant indices.
// The verdict is a template over the group (verdict_group): serial_group runs
// every role in turn on one thread, which is what the host check compiled
// with g++ replays (tests/test_torch_verdict_kernels.py), with the block's
// staging replayed thread by thread (stage_thread).
//
// Layout at the C boundary (batch trailing, limbs leading): acc X, Y, Z,
// comb X, Y, Z, qx, qy, r1 (r) and r2 (r + n) as (32, n) float32 limbs under
// the field module's weak contract (|limb| <= 600, |value| < 2^262), each
// carried into words by fe_load's exact integer sums; has_r2 and host_ok as
// (n,) bytes (torch.bool); the (n,) byte verdict (0 or 1).
//
// Everything above the __CUDACC__ line is __host__ __device__, so the same
// source compiles as plain C++ for the host check.

#include "p256_field.cuh"

namespace {

constexpr int VERDICT_LANES = 8;  // lanes (groups of G threads) a block
constexpr int VERDICT_THREADS = G * VERDICT_LANES;
constexpr int PLANES = 10;  // acc X Y Z, comb X Y Z, qx, qy, r1, r2
constexpr int P_QX = 6, P_QY = 7, P_R1 = 8, P_R2 = 9;
// The block's staged limbs: plane p, limb row i, lane l at
// (p * LIMBS8 + i) * VERDICT_LANES + l.
constexpr int STAGE_FLOATS = PLANES * LIMBS8 * VERDICT_LANES;
constexpr int STAGE_STEPS = STAGE_FLOATS / VERDICT_THREADS;  // loads a thread

// A group's slots: the ten inputs, the add's 14 products (p256_field.cuh's
// slots 0-13), qx^2, qy^2, qx^3, r Z, (r + n) Z.  Each level writes its own
// slots and reads only earlier ones', so one barrier a level orders the group.
constexpr int S_IN = 0, S_ADD = S_IN + PLANES, S_QX2 = S_ADD + SLOTS, S_QY2 = S_QX2 + 1,
              S_QX3 = S_QY2 + 1, S_RZ = S_QX3 + 1, S_R2Z = S_RZ + 1,
              VERDICT_SLOTS = S_R2Z + 1;

static_assert(STAGE_FLOATS % VERDICT_THREADS == 0, "every thread stages as many limbs");
static_assert((LIMBS8 * VERDICT_LANES) % VERDICT_THREADS == 0, "a step stays in one plane");

// The kernel's arguments: the (32, n) limb planes, the masks and the
// verdicts.
struct verdict_args {
  const float* planes[PLANES];
  const uint8_t* has_r2;
  const uint8_t* host_ok;
  uint8_t* out;
  long long n;
};

// planes[p] for a constant p: a kernel parameter indexed at run time would
// be copied to local memory.
HD const float* plane(const verdict_args& v, int p) {
  return p == 0 ? v.planes[0] : p == 1 ? v.planes[1] : p == 2 ? v.planes[2]
       : p == 3 ? v.planes[3] : p == 4 ? v.planes[4] : p == 5 ? v.planes[5]
       : p == 6 ? v.planes[6] : p == 7 ? v.planes[7] : p == 8 ? v.planes[8] : v.planes[9];
}

// Thread t's share of block b's staging: step s loads plane s / 4, limb
// rows 8 (s % 4) + t / 8 of lane t % 8.  A warp's step reads 4 rows of 8
// adjacent lanes; a lane past the batch, and r2 where has_r2 is clear, are
// not read (their staged limbs are never used).
HD void stage_thread(float* stage, const verdict_args& v, long long b, int t) {
  const int l = t % VERDICT_LANES;
  const long long lane = b * VERDICT_LANES + l;
  if (lane >= v.n) return;
  const bool r2 = v.has_r2[lane] != 0;
#pragma unroll
  for (int s = 0; s < STAGE_STEPS; ++s) {
    const int e = s * VERDICT_THREADS + t;
    const int p = s * VERDICT_THREADS / (LIMBS8 * VERDICT_LANES);
    const int row = e / VERDICT_LANES % LIMBS8;
    if (p != P_R2 || r2) stage[e] = plane(v, p)[row * v.n + lane];
  }
}

HD bool fe_equal(const fe& a, const fe& b) {
  bool same = true;
  for (int i = 0; i < 8; ++i) same = same && a.v[i] == b.v[i];
  return same;
}

HD bool fe_is_zero(const fe& a) { return fe_equal(a, fe_zero()); }

// The verdict of the lane at column `lane`, slot `sub` of its block's
// staging, on group g.
template <class Group>
HD void verdict_group(const Group& g, const float* stage, const verdict_args& v,
                      long long lane, int sub) {
  fe* const s = g.slots;
  const bool r2 = v.has_r2[lane] != 0;
  for (int r = g.role_lo; r < g.role_hi; ++r) {
    s[S_IN + r] = fe_load(stage + r * LIMBS8 * VERDICT_LANES + sub, VERDICT_LANES);
    if (r == 0 || (r == 1 && r2))
      s[S_IN + P_R1 + r] = fe_load(stage + (P_R1 + r) * LIMBS8 * VERDICT_LANES + sub,
                                   VERDICT_LANES);
  }
  group_sync(g);
  const ge p = {s[S_IN], s[S_IN + 1], s[S_IN + 2]};
  const ge q = {s[S_IN + 3], s[S_IN + 4], s[S_IN + 5]};
  for (int r = g.role_lo; r < g.role_hi; ++r) {
    if (r < 6) s[S_ADD + r] = add_level1(p, q, r);
    if (r == 6) s[S_QX2] = mul(s[S_IN + P_QX], s[S_IN + P_QX]);
    if (r == 7) s[S_QY2] = mul(s[S_IN + P_QY], s[S_IN + P_QY]);
  }
  group_sync(g);
  for (int r = g.role_lo; r < g.role_hi; ++r) {
    if (r < 2) s[S_ADD + 6 + r] = add_level2(s + S_ADD, r);
    if (r == 2) s[S_QX3] = mul(s[S_QX2], s[S_IN + P_QX]);
  }
  group_sync(g);
  for (int r = g.role_lo; r < g.role_hi; ++r) {
    if (r < 6) {
      const add_terms t = add_level3_terms(s + S_ADD);
      s[S_ADD + 8 + r] = add_level3(t, r);
    }
  }
  group_sync(g);
  const fe z = fe_add(s[S_ADD + 12], s[S_ADD + 13]);  // add_result's Z
  for (int r = g.role_lo; r < g.role_hi; ++r) {
    if (r == 0) s[S_RZ] = mul(s[S_IN + P_R1], z);
    if (r == 1 && r2) s[S_R2Z] = mul(s[S_IN + P_R2], z);
  }
  group_sync(g);
  if (g.role_lo != 0) return;
  const fe x = fe_sub(s[S_ADD + 11], s[S_ADD + 8]);  // add_result's X
  const fe qx = s[S_IN + P_QX];
  const fe rhs = fe_add(fe_sub(s[S_QX3], fe_add(fe_add(qx, qx), qx)), fe_b());
  const bool on_curve = fe_equal(s[S_QY2], rhs);
  const bool match = fe_equal(x, s[S_RZ]) || (r2 && fe_equal(x, s[S_R2Z]));
  v.out[lane] = v.host_ok[lane] != 0 && on_curve && !fe_is_zero(z) && match ? 1 : 0;
}

// The lane that thread t of block b works on.
HD long long verdict_group_lane(long long b, int t) { return b * VERDICT_LANES + t / G; }

}  // namespace

#ifdef __CUDACC__

static_assert(VERDICT_THREADS % 32 == 0, "whole warps, each holding whole groups");

__global__ void __launch_bounds__(VERDICT_THREADS) verdict_p256_kernel(verdict_args v) {
  __shared__ float stage[STAGE_FLOATS];
  __shared__ fe slots[VERDICT_LANES][VERDICT_SLOTS];
  const int t = threadIdx.x, sub = t / G, role = t % G;
  stage_thread(stage, v, blockIdx.x, t);
  __syncthreads();
  const long long lane = verdict_group_lane(blockIdx.x, t);
  if (lane >= v.n) return;  // the ragged edge: the whole group leaves
  const warp_group g = {slots[sub], role, role + 1, ((1u << G) - 1u) << ((t % 32) & ~(G - 1))};
  verdict_group(g, stage, v, lane, sub);
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
  const verdict_args v = {
      {(const float*)ax, (const float*)ay, (const float*)az, (const float*)cx,
       (const float*)cy, (const float*)cz, (const float*)qx, (const float*)qy,
       (const float*)r1, (const float*)r2},
      (const uint8_t*)has_r2, (const uint8_t*)host_ok, (uint8_t*)out, (long long)n};
  const int blocks = (n + VERDICT_LANES - 1) / VERDICT_LANES;
  verdict_p256_kernel<<<blocks, VERDICT_THREADS, 0, (cudaStream_t)stream>>>(v);
  return (int)cudaGetLastError();
}

extern "C" const char* verdict_p256_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
