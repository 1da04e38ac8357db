// Fixed-base comb [u1]G on P-256, for Hopper (sm_90a).
//
// Kernel P1 of the port.  It replaces no TPU kernel: the JAX package runs the
// comb on the device with plain XLA (consensus_tpu/ops/p256.py::
// fixed_base_mul_comb, a one-hot contraction over the 256 entries of each
// window), fused into the verifier's jitted program.  Run eagerly in torch
// (consensus_tpu_torch/ops/p256.py::fixed_base_mul_comb, the plain version,
// an index gather), it is 32 windows of a few hundred small launches.  This
// kernel computes the same function: from the identity (0 : 1 : 0), for
// window j = 0..31 (LSB first) one complete add (RCB15 Algorithm 4, a = -3)
// of table entry [j][digit_j] = digit_j * 2^(8j) * G.  Digit 0 is added too,
// as the entry (0 : 1 : 0), as the plain version does: the complete add
// scales the accumulator's coordinates there, so skipping it would give the
// same point but another projective representative.  With exact arithmetic
// mod p the kernel lands on the plain version's representative and writes it
// as canonical limbs, equal to the plain version's after fp.freeze.
//
// The table is the plain version's (ops/p256.py::_comb_table_np) as affine
// (x, y) in 8 little-endian 32-bit words a coordinate, built once per device
// by ops/scan_kernels.py: 32 x 256 entries of 64 bytes, 524,288 bytes, which
// stay in the 50 MB L2.  Entry d = 0 holds (0, 1); the kernel gives an entry
// Z = 1 for d != 0 and Z = 0 for d = 0, the plain table's Z.
//
// What bounds it on this card: latency.  A lane is one chain of 32 complete
// adds of 14 field multiplications (2 of them by b); at 2,048 lanes the
// products over every SM take microseconds and the bytes (digits, outputs and
// the table's entries read once, under a megabyte) well under that, but each
// lane's adds run one after another, and each waits on a table read from L2
// at an address its digit picks.
//
// What the design does about it, as kernel B2 does for its adds:
// - A group of G = 8 threads per lane, in one warp: each add is cut into its
//   three product levels (p256_field.cuh's add_level1..3), role r of the
//   group computes product r of a level into the group's slots in shared
//   memory, and the group meets at __syncwarp on its own lanes.  An add costs
//   3 multiplication latencies where one thread runs 14.
// - Each thread reads the entry of window j + 1 from L2 while the group adds
//   window j's: the lane's 32 digits are staged in shared memory first.
// - 16 lanes a 128-thread block (128 blocks at 2,048 lanes).  A group past
//   the batch leaves as a whole; the barriers name only the group's own
//   lanes.
// The comb is a template over the group (comb_lane): serial_group runs every
// role in turn on one thread, which is what the host check compiled with g++
// replays (tests/test_torch_verdict_kernels.py).
//
// Layout at the C boundary: the (32, 256, 2, 8) uint32 table; (32, n) int32
// digits, LSB window first, element (j, lane) at j * n + lane (bytes 0-255:
// the kernel reads the low 8 bits); three (32, n) float32 outputs holding
// canonical limbs in [0, 255].
//
// Everything above the __CUDACC__ line is __host__ __device__, so the same
// source compiles as plain C++ for the host check.

#include "p256_field.cuh"

namespace {

constexpr int COMB_WINDOWS = 32;
constexpr int COMB_ENTRIES = 256;
constexpr int ENTRY_WORDS = 16;  // x, y: 8 words each
constexpr int LANES = 16;  // lanes (groups) a block
constexpr int THREADS = G * LANES;

// The lane that thread t of block b works on.
HD long long comb_group_lane(long long b, int t) { return b * LANES + t / G; }

HD u32 load_word(const u32* p) {
#ifdef __CUDA_ARCH__
  return __ldg((const unsigned int*)p);
#else
  return *p;
#endif
}

// Entry [window][digit] as a projective point: (x : y : 1), or the identity
// (0 : 1 : 0) for digit 0, whose (x, y) the table holds as (0, 1).
HD ge comb_point(const u32* table, int window, int digit) {
  const u32* e = table + ((long long)window * COMB_ENTRIES + digit) * ENTRY_WORDS;
  ge q;
  for (int i = 0; i < 8; ++i) {
    q.X.v[i] = load_word(e + i);
    q.Y.v[i] = load_word(e + 8 + i);
  }
  q.Z = digit != 0 ? fe_one() : fe_zero();
  return q;
}

// [u1]G for the lane at column `lane` of the (32, n) digits, on group g with
// its stage of COMB_WINDOWS digits; writes X, Y, Z at o[i * n + lane].
template <class Group>
HD void comb_lane(const Group& g, int32_t* stage, const u32* table, const int32_t* digits,
                  float* ox, float* oy, float* oz, long long n, long long lane) {
  for (int r = g.role_lo; r < g.role_hi; ++r)
    for (int j = r; j < COMB_WINDOWS; j += G) stage[j] = digits[j * n + lane] & (COMB_ENTRIES - 1);
  group_sync(g);
  ge acc = ge_identity();
  ge q = comb_point(table, 0, stage[0]);
#pragma unroll 1
  for (int j = 0; j < COMB_WINDOWS; ++j) {
    const int next = j + 1 < COMB_WINDOWS ? j + 1 : j;
    const ge q_next = comb_point(table, next, stage[next]);
    acc = group_add(g, acc, q);
    q = q_next;
  }
  for (int r = g.role_lo; r < g.role_hi; ++r) {
    if (r == 0) fe_store(ox + lane, n, acc.X);
    if (r == 1) fe_store(oy + lane, n, acc.Y);
    if (r == 2) fe_store(oz + lane, n, acc.Z);
  }
}

}  // namespace

#ifdef __CUDACC__

static_assert(THREADS % 32 == 0, "whole warps, each holding whole groups");

__global__ void __launch_bounds__(THREADS)
comb_p256_kernel(const u32* __restrict__ table, const int32_t* __restrict__ digits,
                 float* __restrict__ ox, float* __restrict__ oy, float* __restrict__ oz,
                 int n) {
  __shared__ fe slots[LANES][SLOTS];
  __shared__ int32_t stages[LANES][COMB_WINDOWS];
  const int t = threadIdx.x, sub = t / G, role = t % G;
  const long long lane = comb_group_lane(blockIdx.x, t);
  if (lane >= n) return;  // the ragged edge: the whole group leaves
  const unsigned mask = ((1u << G) - 1u) << ((t % 32) & ~(G - 1));
  const warp_group g = {slots[sub], role, role + 1, mask};
  comb_lane(g, stages[sub], table, digits, ox, oy, oz, n, lane);
}

// Launches on `stream` of CUDA device `device` and returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int comb_p256_launch(const void* table, const void* digits, void* ox, void* oy,
                                void* oz, int n, int device, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + LANES - 1) / LANES;
  comb_p256_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const u32*)table, (const int32_t*)digits, (float*)ox, (float*)oy, (float*)oz, n);
  return (int)cudaGetLastError();
}

extern "C" const char* comb_p256_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
