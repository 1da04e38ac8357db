// Horner scan [k](-A) for the strict Ed25519 batch verifier, for Hopper (sm_90a).
//
// Replaces the TPU kernel consensus_tpu/ops/pallas_scan.py::horner_scan
// (body _scan_kernel): per signature, build the 9-entry table j*(-A) with 7
// sequential complete adds, then walk 64 signed 4-bit windows MSB first --
// 3 doubles without T, 1 double with T, table[|d|], conditional negate,
// complete add.  The formula sequence is the TPU kernel's (add-2008-hwcd-3
// with the 2d constant, dbl-2008-hwcd), so with exact arithmetic mod p this
// kernel lands on the same projective representative as the plain torch
// version (consensus_tpu_torch/ops/scan_kernels.py::horner_scan_reference);
// it writes that representative as canonical 8-bit limbs.
//
// What bounds it on this card: latency.  The integer products (2,495 field
// multiplications a lane, 25 64x64->128 products each) need 0.074 ms over
// every SM at 8,192 lanes, the bytes (~10 MB) a tenth of that; but a lane's
// multiplications form one chain of dependent products.  The first version
// ran one thread per signature in 64-thread blocks (128 blocks of 2 warps at
// 8,192 lanes), 38 multiplications in a row a window, with the table in
// local memory (254 registers, a 1,456-byte stack frame), and took
// 3.264-3.287 ms at 8,192 lanes (NVIDIA H100 80GB HBM3, 700.00 W).
//
// What the design does about it:
// - A group of G = 4 threads per signature, in one warp.  Every level of
//   the double and of the add has four independent products (the stages of
//   ed25519_field.cuh): role r computes product r, writes it to the group's
//   slots in shared memory, and the group meets at __syncwarp before the
//   next level (2-3 % faster than handing the products round by
//   __shfl_sync).  A window is 10 multiplication latencies where one thread
//   ran 38: 4 doubles of 2 levels and the add's 2.
// - The table in shared memory (9 entries a signature), built by the
//   group's split adds, each role writing its own coordinate.  An entry holds
//   X, Y, Z and 2d T, so the accumulator's add forms C = T1 (2d T2) in one
//   multiplication (6-7 % faster than T in the table): the same value mod p,
//   the same canonical output.  In the add's first level each role reads
//   only the coordinates its product needs.
// - 16 signatures a 64-thread block: 512 blocks at 8,192 lanes, about two
//   warps a scheduler on every SM (8 or 32 signatures a block time within
//   1 %).  A group past the batch leaves as a whole; the barriers name only
//   the group's own lanes.
// - fe_mul inlined in every stage (5 % faster than one out-of-line copy).
// - The first window's doubles act on the identity and are skipped:
//   dbl-2008-hwcd takes (0 : 1 : 1 : 0) to (0 : -1 : -1 : 0), and the add
//   that follows is of degree 2 in the accumulator, so the sum is the same.
// The scan is a template over the group (scan_signature, group_add,
// group_dbl): serial_group runs every role in turn on one thread, which is
// what the host check compiled with g++ replays.
// The percentages above are the alternatives' times on an NVIDIA H100 80GB
// HBM3 at 700.00 W, against this design's.  It takes 0.782-0.785 ms at
// 8,192 lanes and 0.542-0.544 ms at 256 (chip_smoke.py
// phase 2, where the first version took 3.264-3.273 and 3.053-3.062 ms in
// the same call); ptxas: 118 registers, no stack frame, no spills, 28,160
// bytes of shared memory.  A group runs 654 product levels (22 for the
// table, 632 for the windows); a level costs about 2,350 cycles at 8,192
// lanes (two warps a scheduler) and 1,620 at 256 (one), so the warps'
// instruction throughput, not one chain's latency, now sets the time.

// Layout at the C boundary (batch trailing, limbs leading, as in the JAX
// package): four (32, batch) float32 coordinates of -A, weakly reduced
// (|limb| <= 340, value in (-2^250, 2^255 + 2^13)); (64, batch) int32 digits
// stored as d + 8 with d in [-8, 7]; four (32, batch) float32 outputs holding
// canonical limbs in [0, 255].
//
// Everything above the __CUDACC__ line is __host__ __device__, so the same
// source compiles as plain C++ for the host check; only the kernel, the
// warp's exchange and the C entry points need nvcc.

#include "ed25519_field.cuh"

namespace {

constexpr int SIGNATURES = 16;  // signatures a block
constexpr int G = 4;  // threads per signature: one per product of a level
constexpr int THREADS = G * SIGNATURES;
constexpr int DIGIT_MAX = 2 * (TABLE - 1);  // d + 8 with |d| <= 8

// The column of the signature that thread t of block b works on.
HD long long group_lane(long long b, int t) { return b * SIGNATURES + t / G; }

// Role r's factor of the add's level 1 (add_factor) from table entry e (X,
// Y, Z and 2d T), with X and 2d T negated when neg: it reads X and the one
// other coordinate its product needs.
HD fe entry_factor(const fe* e, int role, bool neg) {
  const fe x = neg ? fe_neg(e[0]) : e[0];
  const fe a = e[role <= 1 ? 1 : (role == 2 ? 3 : 2)];
  return fe_pick(role, fe_sub(a, x), fe_add(a, x), neg ? fe_neg(a) : a, a);
}

// What entry j's coordinate r holds for the point p: X, Y, Z, 2d T.
HD fe entry_coordinate(const ge& p, int r) {
  return r == 3 ? mul<MUL_INLINE>(p.T, fe_d2()) : fe_pick(r, p.X, p.Y, p.Z, p.T);
}

// --- the group of one signature --------------------------------------------------
// A group runs roles [role_lo, role_hi) of G on this thread.  serial_group
// runs every role in turn, with no barrier, over the group's slots as the
// card holds them: level 1's products in slots[0], level 2's in slots[1].  On the card (warp_group below) each thread is one role.

struct serial_group {
  int role_lo, role_hi;
  fe (*slots)[G];
};

HD void group_sync(const serial_group&) {}

// p + e (entry e negated when neg), every role in turn.  Against an entry
// that holds 2d T2, the add's left factor of C is T1.
HD ge group_add(const serial_group& g, const ge& p, const fe* e, bool neg) {
  fe* const s1 = g.slots[0];
  fe* const s2 = g.slots[1];
  for (int r = 0; r < G; ++r) s1[r] = add_stage1<MUL_INLINE>(p, p.T, entry_factor(e, r, neg), r);
  for (int r = 0; r < G; ++r) s2[r] = add_stage2<MUL_INLINE>(s1, r);
  return ge{s2[0], s2[1], s2[2], s2[3]};
}

HD ge group_dbl(const serial_group& g, const ge& p, bool need_t) {
  fe* const s1 = g.slots[0];
  fe* const s2 = g.slots[1];
  for (int r = 0; r < G; ++r) s1[r] = dbl_stage1<MUL_INLINE>(p, r);
  for (int r = 0; r < G; ++r) s2[r] = dbl_stage2<MUL_INLINE>(p, s1, r, need_t);
  return ge{s2[0], s2[1], s2[2], s2[3]};
}

// --- the scan of one signature ----------------------------------------------------

// The scan of the signature at column `lane` of the (rows, batch) arrays, on
// group g with its table of TABLE entries of G coordinates.
template <class Group>
HD void scan_signature(const Group& g, fe (*table)[G], const float* ax, const float* ay,
                       const float* az, const float* at, const int32_t* digits, float* ox,
                       float* oy, float* oz, float* ot, long long batch, long long lane) {
  // Entries 0 (the identity) and 1 (-A): role r loads coordinate r.
  for (int r = g.role_lo; r < g.role_hi; ++r) {
    table[0][r] = r == 0 || r == 3 ? fe_zero() : fe_one();
    table[1][r] = fe_load((r == 0 ? ax : r == 1 ? ay : r == 2 ? az : at) + lane, batch);
  }
  group_sync(g);
  const ge neg_a = {table[1][0], table[1][1], table[1][2], table[1][3]};
  group_sync(g);  // every role has read T before role 3 replaces it
  for (int r = g.role_lo; r < g.role_hi; ++r)
    if (r == 3) table[1][3] = entry_coordinate(neg_a, 3);
  group_sync(g);
  ge cur = neg_a;
#pragma unroll 1
  for (int j = 2; j < TABLE; ++j) {
    cur = group_add(g, cur, table[1], false);
    for (int r = g.role_lo; r < g.role_hi; ++r) table[j][r] = entry_coordinate(cur, r);
  }
  group_sync(g);

  ge acc = ge_identity();
#pragma unroll 1
  for (int w = 0; w < WINDOWS; ++w) {
    // A digit outside the d + 8 encoding's [0, 16] is not a valid input;
    // the clamp only keeps such a lane from reading outside the table.
    int code = digits[w * batch + lane];
    code = code < 0 ? 0 : (code > DIGIT_MAX ? DIGIT_MAX : code);
    const int d = code - (TABLE - 1);
    if (w > 0) {  // the first window's doubles would act on the identity
#pragma unroll 1
      for (int i = 0; i < 3; ++i) acc = group_dbl(g, acc, false);
      acc = group_dbl(g, acc, true);
    }
    acc = group_add(g, acc, table[d < 0 ? -d : d], d < 0);
  }
  for (int r = g.role_lo; r < g.role_hi; ++r)
    fe_store((r == 0 ? ox : r == 1 ? oy : r == 2 ? oz : ot) + lane, batch,
             fe_pick(r, acc.X, acc.Y, acc.Z, acc.T));
}

}  // namespace

#ifdef __CUDACC__

static_assert(THREADS % 32 == 0, "whole warps, each holding whole groups");

// One role of a signature's group: its lanes in the warp (named in `mask`)
// and the group's slots in shared memory, one set of G for each of an
// operation's two levels.
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

// Every role of the group gets the G products of one level (0 or 1).
// Slots alternate between the levels, so one barrier a level orders the
// group through any sequence of operations.
HDW void share(const warp_group& g, const fe& mine, fe* all, int level) {
#ifdef __CUDA_ARCH__
  g.slots[level][g.role_lo] = mine;
  __syncwarp(g.mask);
#pragma unroll
  for (int k = 0; k < G; ++k) all[k] = g.slots[level][k];
#endif
}

HDW ge group_add(const warp_group& g, const ge& p, const fe* e, bool neg) {
  const int r = g.role_lo;
  fe m[G], o[G];
  share(g, add_stage1<MUL_INLINE>(p, p.T, entry_factor(e, r, neg), r), m, 0);
  share(g, add_stage2<MUL_INLINE>(m, r), o, 1);
  return ge{o[0], o[1], o[2], o[3]};
}

HDW ge group_dbl(const warp_group& g, const ge& p, bool need_t) {
  const int r = g.role_lo;
  fe m[G], o[G];
  share(g, dbl_stage1<MUL_INLINE>(p, r), m, 0);
  share(g, dbl_stage2<MUL_INLINE>(p, m, r, need_t), o, 1);
  return ge{o[0], o[1], o[2], o[3]};
}

__global__ void __launch_bounds__(THREADS)
horner_scan_kernel(const float* __restrict__ ax, const float* __restrict__ ay,
                   const float* __restrict__ az, const float* __restrict__ at,
                   const int32_t* __restrict__ digits, float* __restrict__ ox,
                   float* __restrict__ oy, float* __restrict__ oz,
                   float* __restrict__ ot, int batch) {
  __shared__ fe tables[SIGNATURES][TABLE][G];
  __shared__ fe slots[SIGNATURES][2][G];
  const int t = threadIdx.x, sig = t / G, role = t % G;
  const long long lane = group_lane(blockIdx.x, t);
  if (lane >= batch) return;  // the ragged edge: the whole group leaves
  const warp_group g = {role, role + 1, ((1u << G) - 1u) << ((t % 32) & ~(G - 1)),
                        slots[sig]};
  scan_signature(g, tables[sig], ax, ay, az, at, digits, ox, oy, oz, ot, batch, lane);
}

// Launches on `stream` of CUDA device `device` and returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int horner_scan_launch(const void* ax, const void* ay, const void* az,
                                  const void* at, const void* digits, void* ox,
                                  void* oy, void* oz, void* ot, int batch,
                                  int device, void* stream) {
  if (batch <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (batch + SIGNATURES - 1) / SIGNATURES;
  horner_scan_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)ax, (const float*)ay, (const float*)az, (const float*)at,
      (const int32_t*)digits, (float*)ox, (float*)oy, (float*)oz, (float*)ot, batch);
  return (int)cudaGetLastError();
}

extern "C" const char* horner_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
