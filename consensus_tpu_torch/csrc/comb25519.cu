// Fixed-base comb [S]B on edwards25519, for Hopper (sm_90a).
//
// Kernel D2 of the port.  It replaces no TPU kernel: the JAX package runs the
// comb on the device with plain XLA
// (consensus_tpu/ops/ed25519.py::fixed_base_mul_comb, a one-hot contraction
// over the 256 entries of each window), fused into the verifier's jitted
// program.  Run eagerly in torch (consensus_tpu_torch/ops/ed25519.py::
// fixed_base_mul_comb, the plain version, an index gather), it is 32 windows
// of small launches.  This kernel computes the same function: from the
// identity (0 : 1 : 1 : 0), for window j = 0..31 (LSB first) one mixed add
// (madd-2008-hwcd-3) of table entry [j][digit_j] = digit_j * 2^(8j) * B.
// Digit 0 is added too (the affine identity), as the plain version does: it
// scales (X : Y : Z : T) by 4Z, so skipping it would give the same point but
// another representative.  The output is written as canonical limbs, equal
// to the plain version's after fe.freeze.
//
// The table is the plain version's (ops/ed25519.py::_comb_table_np), held in
// the Niels form (y - x, y + x, 2d x y) as radix-2^51 limbs, built once per
// device by ops/scan_kernels.py: 32 x 256 entries of 120 bytes, 983,040
// bytes, which stay in the 50 MB L2.  C = T1 (2d t2) is T1 2d t2 of the
// plain version's order mod p, so the sum is the same projective point mod p.
//
// What bounds it on this card: latency.  A lane is one chain of 32 adds of 7
// field multiplications; at 8,192 lanes the products over every SM take
// microseconds and the bytes (digits, outputs and the table read once, ~2.2
// MB) under a microsecond, but each lane's adds run one after another, and
// each add waits on a table read from L2 at an address its digit picks.  One
// thread per lane (64 a block) took 0.171-0.172 ms at 8,192 lanes and 0.153
// at one lane (NVIDIA H100 80GB HBM3, 700.00 W).
//
// What the design does about it, as kernel B1 does for its adds:
// - A group of G = 4 threads per lane, in one warp.  The mixed add is two
//   levels of products.  Level 1 is A = (Y1 - X1)(y - x), B = (Y1 + X1)(y + x)
//   and C = T1 (2d x y), which is add_stage1 with t1 = T1 and the entry's
//   coordinate as the factor, and D = 2 Z1, an addition; level 2 is
//   add_stage2 as it is (X3 = EF, Y3 = GH, Z3 = FG, T3 = EH).  Role r
//   computes the value r of each level, writes it to the group's slots in
//   shared memory, and the group meets at __syncwarp on its own lanes.  A
//   window costs 2 multiplication latencies where one thread ran 7, and each
//   role's value is the one-thread formula's, mod p.  Role 3 runs level 1's
//   product too (add_stage1's 2 Z1 times role 2's factor) and drops it for
//   D: the group's four threads run in lockstep, so the product costs role
//   3 no time the other roles do not take, and the code has no branch.
// - Each role reads only its own 5 words of the Niels entry (role 3 reads
//   role 2's, for the dropped product), one window ahead: the lane's 32
//   digits are staged in shared memory first, so window j + 1's read from
//   L2 is in flight during window j's products.
// - 16 lanes a 64-thread block (512 blocks at 8,192 lanes).  A group past the
//   batch leaves as a whole; the barriers name only the group's own lanes.
// - Each product in radix 2^25.5 (MUL_R25 of ed25519_field.cuh: the
//   factors converted to fe25 and the product back), inlined in both levels;
//   the window loop not unrolled.  The values mod p are fe_mul's, so the
//   canonical output is the same.
// In one call on an NVIDIA H100 80GB HBM3 at 700.00 W
// (scripts/d1_d2_trials.py) this took 0.075 ms at 8,192 lanes and 0.049 at
// one lane, where one thread per lane took 0.162 and 0.143; the same groups
// with radix-2^51 products (fe_mul inlined) took 0.076 and 0.048, and 8 or
// 32 lanes a block timed within 1 %.
// The comb is a template over the group (comb_lane, group_factors,
// group_madd): serial_group runs every role in turn on one thread, which is
// what the host check compiled with g++ replays
// (tests/test_torch_decompress_comb.py).
//
// Layout at the C boundary: the (32, 256, 3, 5) uint64 table; (32, n) int32
// digits, LSB window first, element (j, lane) at j * n + lane (bytes 0-255:
// the kernel reads the low 8 bits); four (32, n) float32 outputs holding
// canonical limbs in [0, 255].
//
// Everything above the __CUDACC__ line is __host__ __device__, so the same
// source compiles as plain C++ for the host check.

#include "ed25519_field.cuh"

namespace {

constexpr int COMB_WINDOWS = 32;
constexpr int COMB_ENTRIES = 256;
constexpr int ENTRY_WORDS = 15;  // y - x, y + x, 2d x y; 5 limbs each
constexpr int G = 4;  // threads per lane: one per product of a level
constexpr int LANES = 16;  // lanes (groups) a block
constexpr int THREADS = G * LANES;

// The lane that thread t of block b works on.
HD long long comb_group_lane(long long b, int t) { return b * LANES + t / G; }

HD u64 load_word(const u64* p) {
#ifdef __CUDA_ARCH__
  return __ldg((const unsigned long long*)p);
#else
  return *p;
#endif
}

HD fe load_fe(const u64* p) {
  return fe{{load_word(p), load_word(p + 1), load_word(p + 2), load_word(p + 3),
             load_word(p + 4)}};
}

// Role r's factor of the add's level 1 from the entry at e: y - x, y + x,
// 2d x y for roles 0-2.  Role 3 (D = 2 Z1) needs none and reads role 2's.
HD fe entry_factor(const u64* e, int role) { return load_fe(e + 5 * (role < 2 ? role : 2)); }

HD const u64* comb_entry(const u64* table, int window, int digit) {
  return table + ((long long)window * COMB_ENTRIES + digit) * ENTRY_WORDS;
}

// Level 1 of p + entry: role r's A, B or C (add_stage1 with t1 = T1 against
// an entry that holds 2d x y), or D = 2 Z1 for role 3, which computes
// add_stage1's product as well and drops it.
HD fe madd_stage1(const ge& p, const fe& qf, int role) {
  const fe m = add_stage1<MUL_R25>(p, p.T, qf, role);
  return role == 3 ? fe_add(p.Z, p.Z) : m;
}

// --- the group of one lane -------------------------------------------------------
// A group runs roles [role_lo, role_hi) of G on this thread.  serial_group
// runs every role in turn, with no barrier, over the group's slots as the
// card holds them: level 1's products in slots[0], level 2's in slots[1].
// On the card (warp_group below) each thread is one role.

struct serial_group {
  int role_lo, role_hi;
  fe (*slots)[G];
};

HD void group_sync(const serial_group&) {}

// Every role's factor of one entry.
struct serial_factors {
  fe q[G];
};

HD serial_factors group_factors(const serial_group&, const u64* e) {
  serial_factors f;
  for (int r = 0; r < G; ++r) f.q[r] = entry_factor(e, r);
  return f;
}

HD ge group_madd(const serial_group& g, const ge& p, const serial_factors& f) {
  fe* const s1 = g.slots[0];
  fe* const s2 = g.slots[1];
  for (int r = 0; r < G; ++r) s1[r] = madd_stage1(p, f.q[r], r);
  for (int r = 0; r < G; ++r) s2[r] = add_stage2<MUL_R25>(s1, r);
  return ge{s2[0], s2[1], s2[2], s2[3]};
}

// --- the comb of one lane ---------------------------------------------------------

// [S]B for the lane at column `lane` of the (32, n) digits, on group g with
// its stage of COMB_WINDOWS digits; writes X, Y, Z, T at o[i * n + lane].
template <class Group>
HD void comb_lane(const Group& g, int32_t* stage, const u64* table, const int32_t* digits,
                  float* ox, float* oy, float* oz, float* ot, long long n, long long lane) {
  for (int r = g.role_lo; r < g.role_hi; ++r)
    for (int j = r; j < COMB_WINDOWS; j += G) stage[j] = digits[j * n + lane] & (COMB_ENTRIES - 1);
  group_sync(g);
  ge acc = ge_identity();
  auto q = group_factors(g, comb_entry(table, 0, stage[0]));
#pragma unroll 1
  for (int j = 0; j < COMB_WINDOWS; ++j) {
    const int next = j + 1 < COMB_WINDOWS ? j + 1 : j;
    const auto q_next = group_factors(g, comb_entry(table, next, stage[next]));
    acc = group_madd(g, acc, q);
    q = q_next;
  }
  for (int r = g.role_lo; r < g.role_hi; ++r)
    fe_store((r == 0 ? ox : r == 1 ? oy : r == 2 ? oz : ot) + lane, n,
             fe_pick(r, acc.X, acc.Y, acc.Z, acc.T));
}

}  // namespace

#ifdef __CUDACC__

static_assert(THREADS % 32 == 0, "whole warps, each holding whole groups");

// One role of a lane's group: its lanes in the warp (named in `mask`) and
// the group's slots in shared memory, one set of G for each of the add's two
// levels.
struct warp_group {
  int role_lo, role_hi;
  unsigned mask;
  fe (*slots)[G];
};

// The card's group functions are __host__ __device__ like the template that
// calls them; their intrinsics exist only in the device pass.
#define HDW __host__ __device__ __forceinline__

HDW void group_sync(const warp_group& g) {
#ifdef __CUDA_ARCH__
  __syncwarp(g.mask);
#endif
}

// This role's factor of one entry.
struct warp_factors {
  fe q;
};

HDW warp_factors group_factors(const warp_group& g, const u64* e) {
  return warp_factors{entry_factor(e, g.role_lo)};
}

// Every role of the group gets the G products of one level (0 or 1).
// Slots alternate between the levels, so one barrier a level orders the
// group through the whole chain.
HDW void share(const warp_group& g, const fe& mine, fe* all, int level) {
#ifdef __CUDA_ARCH__
  g.slots[level][g.role_lo] = mine;
  __syncwarp(g.mask);
#pragma unroll
  for (int k = 0; k < G; ++k) all[k] = g.slots[level][k];
#endif
}

HDW ge group_madd(const warp_group& g, const ge& p, const warp_factors& f) {
  const int r = g.role_lo;
  fe m[G], o[G];
  share(g, madd_stage1(p, f.q, r), m, 0);
  share(g, add_stage2<MUL_R25>(m, r), o, 1);
  return ge{o[0], o[1], o[2], o[3]};
}

__global__ void __launch_bounds__(THREADS)
comb25519_kernel(const u64* __restrict__ table, const int32_t* __restrict__ digits,
                 float* __restrict__ ox, float* __restrict__ oy, float* __restrict__ oz,
                 float* __restrict__ ot, int n) {
  __shared__ fe slots[LANES][2][G];
  __shared__ int32_t stages[LANES][COMB_WINDOWS];
  const int t = threadIdx.x, sub = t / G, role = t % G;
  const long long lane = comb_group_lane(blockIdx.x, t);
  if (lane >= n) return;  // the ragged edge: the whole group leaves
  const warp_group g = {role, role + 1, ((1u << G) - 1u) << ((t % 32) & ~(G - 1)), slots[sub]};
  comb_lane(g, stages[sub], table, digits, ox, oy, oz, ot, n, lane);
}

// Launches on `stream` of CUDA device `device` and returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int comb25519_launch(const void* table, const void* digits, void* ox, void* oy,
                                void* oz, void* ot, int n, int device, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + LANES - 1) / LANES;
  comb25519_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const u64*)table, (const int32_t*)digits, (float*)ox, (float*)oy, (float*)oz,
      (float*)ot, n);
  return (int)cudaGetLastError();
}

extern "C" const char* comb25519_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
