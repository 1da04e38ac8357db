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
// What bounds it on this card: bytes, and then one lane's latency.  Every
// lane reads acc and comb (eight (32,) float32 limb vectors) and writes one
// byte; a strict lane also reads host_ok (1,026 bytes), r_ok and a_ok only
// where the masks before them pass, and R's X, Y and Z (384 bytes) only where
// all three pass.  Its work is the add's 9 field multiplications (8, and one
// by 2d), the X comparison's 2 on a lane whose masks pass and the Y
// comparison's 2 where X matches.  On a strict wave of 8,192 lanes with 6,825
// of them compared that is about 11.0 MB against some 7.3 million
// 32x32->64-bit products: 3.3 us over the memory, under half a microsecond
// over the multipliers.  One thread a lane running its 9-13 products in a
// row, in radix 2^51 through the header's one out-of-line fe_mul, with 8-11
// strided coordinate loads (the first design, 255 registers), took 0.015
// ms at 8,192 lanes and 0.0094 at one lane on an NVIDIA H100 80GB HBM3 at
// 700.00 W (scripts/e1_p1_trials.py, a launch replayed from a CUDA graph;
// a loop of launches from Python times ~0.016-0.02 ms whatever the
// kernel, the host's issue rate): one thread's chain.
//
// What the design does about it, as kernels B1 and D2 do for their adds:
// - A group of G = 4 threads a lane, in one warp, one product each per
//   level, meeting at __syncwarp on the group's own lanes over slots in
//   shared memory.  The chain is 4 product levels where one thread ran 13:
//     0  t1 = 2d T_acc (role 2 alone: only its level-1 product reads it);
//     1  A, B, C, D (the header's add_stage1);
//     2  X_S, Y_S, Z_S (add_stage2; no verdict reads T_S);
//     3  strict mode, on a lane whose three masks pass (the group skips it
//        together elsewhere): X_S Z_R, X_R Z_S, Y_S Z_R and Y_R Z_S.
//   Role 0 then compares and writes the verdict.
// - The loads spread over the group: role r reads coordinate r (X, Y, Z, T)
//   of acc and of comb and, on a compared lane, coordinate r of R (roles
//   0-2), each carried into radix 2^51 by fe_load, into the slots.
// - Every product in radix 2^25.5 (MUL_R25 of ed25519_field.cuh), inlined,
//   as D1 and D2 take theirs.  The values mod p are fe_mul's.
// - 16 lanes a 64-thread block (512 blocks at 8,192 lanes).  A group past
//   the batch leaves as a whole; the barriers name only the group's lanes.
// In the same calls this took 0.0096-0.0098 ms at 8,192 lanes and 0.0047 at
// one lane, at 90 registers and 14,080 bytes of shared memory, no spills.
// The verdict is a template over the group (verdict_group): serial_group
// runs every role in turn on one thread, which is what the host check
// compiled with g++ replays (tests/test_torch_verdict_kernels.py).
//
// Layout at the C boundary (batch trailing, limbs leading): acc X, Y, Z, T and
// comb X, Y, Z, T as (32, n) float32 limbs, R's four coordinates as (32, n)
// float32 limbs with row stride r_ld (D1 writes R and A side by side, so R's
// rows are 2n apart; R's T is not read), all under the field module's weak
// contract, each carried into radix 2^51 by fe_load's exact integer pass;
// host_ok, r_ok and a_ok as (n,) bytes (torch.bool); the (n,) byte verdict
// (0 or 1).  Mode 1 reads neither R nor the masks (the wrapper passes null
// pointers).
//
// Everything above the __CUDACC__ line is __host__ __device__, so the same
// source compiles as plain C++ for the host check.

#include "ed25519_field.cuh"

namespace {

constexpr int G = 4;  // threads a lane: one product of a level each
constexpr int LANES = 16;  // lanes (groups) a block
constexpr int THREADS = G * LANES;
constexpr int MODE_EQUAL = 0;
constexpr int MODE_IDENTITY = 1;

// A group's slots, by what they hold: acc's X, Y, Z, T; comb's; R's X, Y, Z;
// the products of levels 1, 2 and 3.  Each level writes its own slots and
// reads only earlier ones', so one barrier a level orders the group.
constexpr int S_ACC = 0, S_COMB = 4, S_R = 8, S_L1 = 11, S_L2 = 15, S_L3 = 18, SLOTS = 22;

// The kernel's arguments: the coordinates' (32, n) limb planes (R's with row
// stride r_ld), the masks and the verdicts.
struct verdict_args {
  const float* acc[4];
  const float* comb[4];
  const float* r[4];
  const uint8_t* host_ok;
  const uint8_t* r_ok;
  const uint8_t* a_ok;
  uint8_t* out;
  long long n, r_ld;
  int mode;
};

// p[i] for a role's i, indexed by constants only: a kernel parameter indexed
// at run time would be copied to local memory.
HD const float* plane(const float* const* p, int i) {
  return i == 0 ? p[0] : i == 1 ? p[1] : i == 2 ? p[2] : p[3];
}

// --- the group of one lane -------------------------------------------------------
// A group runs roles [role_lo, role_hi) of G on this thread over its slots.
// serial_group runs every role in turn, with no barrier; on the card
// (warp_group below) each thread is one role.

struct serial_group {
  int role_lo, role_hi;
  fe* slots;
};

HD void group_sync(const serial_group&) {}

// The verdict of the lane at column `lane`, on group g.
template <class Group>
HD void verdict_group(const Group& g, const verdict_args& v, long long lane) {
  fe* const s = g.slots;
  const bool strict = v.mode == MODE_EQUAL;
  // The masks in the plain version's order: r_ok behind host_ok, a_ok behind
  // both.  Every role of the group reads the same bytes.
  const bool compare = strict && v.host_ok[lane] && v.r_ok[lane] && v.a_ok[lane];
  for (int r = g.role_lo; r < g.role_hi; ++r) {
    s[S_ACC + r] = fe_load(plane(v.acc, r) + lane, v.n);
    s[S_COMB + r] = fe_load(plane(v.comb, r) + lane, v.n);
    if (compare && r < 3) s[S_R + r] = fe_load(plane(v.r, r) + lane, v.r_ld);
  }
  group_sync(g);
  const ge p = {s[S_ACC], s[S_ACC + 1], s[S_ACC + 2], s[S_ACC + 3]};
  const ge q = {s[S_COMB], s[S_COMB + 1], s[S_COMB + 2], s[S_COMB + 3]};
  for (int r = g.role_lo; r < g.role_hi; ++r) {
    const fe t1 = r == 2 ? mul<MUL_R25>(p.T, fe_d2()) : p.T;
    s[S_L1 + r] = add_stage1<MUL_R25>(p, t1, add_factor(q, r), r);
  }
  group_sync(g);
  for (int r = g.role_lo; r < g.role_hi; ++r)
    if (r < 3) s[S_L2 + r] = add_stage2<MUL_R25>(s + S_L1, r);
  group_sync(g);
  const fe* const sum = s + S_L2;  // X_S, Y_S, Z_S
  if (compare) {
    for (int r = g.role_lo; r < g.role_hi; ++r)
      s[S_L3 + r] = mul<MUL_R25>(fe_pick(r, sum[0], s[S_R], sum[1], s[S_R + 1]),
                                 fe_pick(r, s[S_R + 2], sum[2], s[S_R + 2], sum[2]));
    group_sync(g);
  }
  if (g.role_lo != 0) return;
  bool verdict = false;
  if (!strict) verdict = fe_is_zero(sum[0]) && fe_eq(sum[1], sum[2]);
  if (compare) verdict = fe_eq(s[S_L3], s[S_L3 + 1]) && fe_eq(s[S_L3 + 2], s[S_L3 + 3]);
  v.out[lane] = verdict ? 1 : 0;
}

// The lane that thread t of block b works on.
HD long long verdict_group_lane(long long b, int t) { return b * LANES + t / G; }

}  // namespace

#ifdef __CUDACC__

static_assert(THREADS % 32 == 0, "whole warps, each holding whole groups");

// One role of a lane's group: its lanes in the warp (named in `mask`) and
// the group's slots in shared memory.
struct warp_group {
  int role_lo, role_hi;
  unsigned mask;
  fe* slots;
};

// The card's group function is __host__ __device__ like the template that
// calls it; its intrinsic exists only in the device pass.
__host__ __device__ __forceinline__ void group_sync(const warp_group& g) {
#ifdef __CUDA_ARCH__
  __syncwarp(g.mask);
#endif
}

__global__ void __launch_bounds__(THREADS) verdict25519_kernel(verdict_args v) {
  __shared__ fe slots[LANES][SLOTS];
  const int t = threadIdx.x, sub = t / G, role = t % G;
  const long long lane = verdict_group_lane(blockIdx.x, t);
  if (lane >= v.n) return;  // the ragged edge: the whole group leaves
  const warp_group g = {role, role + 1, ((1u << G) - 1u) << ((t % 32) & ~(G - 1)), slots[sub]};
  verdict_group(g, v, lane);
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
  const verdict_args v = {
      {(const float*)ax, (const float*)ay, (const float*)az, (const float*)at},
      {(const float*)cx, (const float*)cy, (const float*)cz, (const float*)ct},
      {(const float*)rx, (const float*)ry, (const float*)rz, (const float*)rt},
      (const uint8_t*)host_ok, (const uint8_t*)r_ok, (const uint8_t*)a_ok, (uint8_t*)out,
      (long long)n, (long long)r_ld, mode};
  const int blocks = (n + LANES - 1) / LANES;
  verdict25519_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(v);
  return (int)cudaGetLastError();
}

extern "C" const char* verdict25519_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
