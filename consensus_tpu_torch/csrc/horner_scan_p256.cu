// Horner scan [u2]Q on P-256 for the ECDSA batch verifier, for Hopper (sm_90a).
//
// Replaces the TPU kernel consensus_tpu/ops/pallas_scan.py::horner_scan_p256
// (body _scan_kernel_p256): per signature, build the 9-entry table j*Q with
// table[0] = (0 : 1 : 0), table[1] = Q and 7 sequential complete adds, then
// walk 65 signed 4-bit windows MSB first (the first holds the recoding
// carry) -- 4 doubles, table[|d|], Y negated when d < 0, one complete add.
// The formulas are the TPU kernel's (Renes-Costello-Batina 2015, Algorithms
// 4 and 6 for a = -3), so with exact arithmetic mod p this kernel lands on
// the same projective representative as the plain torch version
// (consensus_tpu_torch/ops/scan_kernels.py::horner_scan_p256_reference); it
// writes that representative as canonical 8-bit limbs.  The formulas are
// polynomials, so off-curve Q (padded or rejected lanes) follow the same
// sequence to the same result.  The first window's 4 doubles act on the
// identity, which Algorithm 6 returns exactly, so they are skipped.
//
// What bounds it on this card: integer products.  Per lane the function
// needs 72 complete adds (14 multiplications each, 2 of them by b) and 260
// doubles (10 multiplications and 3 squarings each): 3,608 multiplications
// at 64 and 780 squarings at 36 32x32->64-bit products, against ~1.8 MB of
// memory traffic at 2,048 lanes.  What holds it back is latency: a point
// operation is a chain of dependent products, and 2,048 signatures are few
// threads for 132 SMs.  The first version ran one thread per signature in
// 64-thread blocks (32 blocks at 2,048 lanes: 100 SMs idle), 4,388 products
// in a row per thread with the 9-entry table in local memory (864-byte
// stack frame), and took 5.985-6.008 ms at 2,048 lanes (NVIDIA H100 80GB
// HBM3, 700.00 W).
//
// What the design does about it:
// - A group of G = 8 threads per signature, in one warp.  RCB's add has
//   three levels of products (6, 2 and 6) and the double too (6, 3 and 4):
//   the products of a level depend only on the operation's inputs and on the
//   levels before it.  In each level role r of the group computes product r
//   (add_level*, dbl_level*), writes it to the group's slots in shared
//   memory, and the group meets at __syncwarp before the next level.  An
//   operation is then 3 multiplication latencies, where one thread ran 13 or
//   14: a window is 15 instead of 66.  Every role forms the field additions
//   of a level itself: the warp issues them once for all its lanes, where
//   additions by role would run one role after another.  Squarings are
//   formed as multiplications, so all roles of a level run the same
//   instructions.  The multiplication is one out-of-line copy of fe_mul.
// - 16 signatures per 128-thread block: 128 blocks at 2,048 lanes for the
//   132 SMs, 16,384 threads, about one warp per scheduler.  A group whose
//   signature lies past the batch leaves as a whole, so the barriers name
//   only the group's own lanes.
// - The table in shared memory (864 bytes per signature), built by the
//   group's split adds and read with an index on |d|.
// - ge_add and ge_dbl are the same stage functions run for every role in
//   turn on one thread (serial_group), and scan_signature is the same code
//   on the host: the host check compiled with g++ runs the card's schedule,
//   with the slots and the table in arrays.
// On the card (chip_smoke.py phase 4, NVIDIA H100 80GB HBM3, 700.00 W) this
// takes 1.160 ms at 2,048 lanes; ptxas: 128 registers, no stack frame, no
// spills, 20,992 bytes of shared memory.  The field additions between the
// levels are now the largest cost after the products (PERF.md).
//
// Layout at the C boundary (batch trailing, limbs leading, as in the JAX
// package): qx, qy as (32, batch) float32 limbs under the field module's
// weak contract (|limb| <= 600, |value| < 2^262; the engine passes bytes);
// (65, batch) int32 digits stored as d + 8 with d in [-8, 7] (the carry
// window holds 8 or 9); three (32, batch) float32 outputs holding canonical
// limbs in [0, 255].
//
// The field and point code is p256_field.cuh, shared with P1 and P2; it is
// __host__ __device__, so the same source can be compiled as plain C++ for a
// host-side check; only the kernel and the C entry points need nvcc.

#include "p256_field.cuh"

namespace {

constexpr int WINDOWS = 65;
constexpr int TABLE = 9;
constexpr int DIGIT_MAX = 2 * (TABLE - 1);  // d + 8 with |d| <= 8

// --- the scan of one signature ----------------------------------------------------

// Coordinate r of dst <- that of p, for each role r < 3 of the group.
template <class Group>
HD void ge_store_by_role(const Group& g, ge& dst, const ge& p) {
  for (int r = g.role_lo; r < g.role_hi; ++r) {
    if (r == 0) dst.X = p.X;
    if (r == 1) dst.Y = p.Y;
    if (r == 2) dst.Z = p.Z;
  }
}

// Signatures per block, and the block's threads: 128 blocks at 2,048 lanes.
constexpr int SIGNATURES = 16;
constexpr int THREADS = G * SIGNATURES;

// The column of the signature that thread t of block b works on.
HD long long group_lane(long long b, int t) { return b * SIGNATURES + t / G; }

// The scan of the signature at column `lane` of the (rows, batch) arrays, on
// group g with its 9-entry table.
template <class Group>
HD void scan_signature(const Group& g, ge* table, const float* qx, const float* qy,
                       const int32_t* digits, float* ox, float* oy, float* oz,
                       long long batch, long long lane) {
  const ge q = {fe_load(qx + lane, batch), fe_load(qy + lane, batch), fe_one()};
  ge_store_by_role(g, table[0], ge_identity());
  ge_store_by_role(g, table[1], q);
  ge cur = q;
#pragma unroll 1
  for (int j = 2; j < TABLE; ++j) {
    cur = group_add(g, cur, q);
    ge_store_by_role(g, table[j], cur);
  }
  group_sync(g);

  ge acc = ge_identity();
#pragma unroll 1
  for (int w = 0; w < WINDOWS; ++w) {
    // A digit outside the d + 8 encoding's [0, 16] is not a valid input;
    // the clamp only keeps such a lane from reading outside the table.
    int digit = digits[w * batch + lane];
    digit = digit < 0 ? 0 : (digit > DIGIT_MAX ? DIGIT_MAX : digit);
    const int d = digit - (TABLE - 1);
    if (w > 0) {  // the first window's doubles would act on the identity
#pragma unroll 1
      for (int i = 0; i < 4; ++i) acc = group_dbl(g, acc);
    }
    ge t = table[d < 0 ? -d : d];
    if (d < 0) t.Y = fe_neg(t.Y);
    acc = group_add(g, acc, t);
  }
  for (int r = g.role_lo; r < g.role_hi; ++r) {
    if (r == 0) fe_store(ox + lane, batch, acc.X);
    if (r == 1) fe_store(oy + lane, batch, acc.Y);
    if (r == 2) fe_store(oz + lane, batch, acc.Z);
  }
}

}  // namespace

#ifdef __CUDACC__

__global__ void __launch_bounds__(THREADS)
horner_scan_p256_kernel(const float* __restrict__ qx, const float* __restrict__ qy,
                        const int32_t* __restrict__ digits, float* __restrict__ ox,
                        float* __restrict__ oy, float* __restrict__ oz, int batch) {
  __shared__ ge tables[SIGNATURES][TABLE];
  __shared__ fe slots[SIGNATURES][SLOTS];
  const int t = threadIdx.x, sig = t / G, role = t % G;
  const long long lane = group_lane(blockIdx.x, t);
  if (lane >= batch) return;  // the ragged edge: the whole group leaves
  const unsigned mask = ((1u << G) - 1u) << ((t % 32) & ~(G - 1));
  const warp_group g = {slots[sig], role, role + 1, mask};
  scan_signature(g, tables[sig], qx, qy, digits, ox, oy, oz, batch, lane);
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
  const int blocks = (batch + SIGNATURES - 1) / SIGNATURES;
  horner_scan_p256_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)qx, (const float*)qy, (const int32_t*)digits, (float*)ox,
      (float*)oy, (float*)oz, batch);
  return (int)cudaGetLastError();
}

extern "C" const char* horner_scan_p256_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
