// Trial alternative to consensus_tpu_torch/csrc/comb_p256.cu for
// scripts/e1_p1_trials.py: the same four window groups a lane and the same
// joins, with the general complete add (p256_field.cuh's three product
// levels) for every table entry as well.  It lost to csrc's design, whose
// entry adds take two levels (see the notes there); kept to time again.
//
// Fixed-base comb [u1]G on P-256, for Hopper (sm_90a).
//
// Kernel P1 of the port.  It replaces no TPU kernel: the JAX package runs the
// comb on the device with plain XLA (consensus_tpu/ops/p256.py::
// fixed_base_mul_comb, a one-hot contraction over the 256 entries of each
// window), fused into the verifier's jitted program.  Run eagerly in torch
// (consensus_tpu_torch/ops/p256.py::fixed_base_mul_comb, the plain version,
// an index gather), it is 32 windows of a few hundred small launches.  This
// kernel computes the same point: the sum over windows j = 0..31 (LSB first)
// of table entry [j][digit_j] = digit_j * 2^(8j) * G, by complete adds (RCB15
// Algorithm 4, a = -3), digit 0's entry being the identity (0 : 1 : 0).
//
// The table is the plain version's (ops/p256.py::_comb_table_np) as affine
// (x, y) in 8 little-endian 32-bit words a coordinate, built once per device
// by ops/scan_kernels.py: 32 x 256 entries of 64 bytes, 524,288 bytes, which
// stay in the 50 MB L2.  Entry d = 0 holds (0, 1); the kernel gives an entry
// Z = 1 for d != 0 and Z = 0 for d = 0, the plain table's Z.
//
// What bounds it on this card: latency.  A lane is a sum of 32 table
// entries by complete adds of 14 field multiplications (2 of them by b); at
// 2,048 lanes the products over every SM take microseconds and the bytes
// (digits, outputs and the table's entries read once, under a megabyte) well
// under that, but a chain of adds runs one add after another, and each waits
// on a table read from L2 at an address its digit picks.  The first design ran
// the 32 adds of a lane as one chain (from the identity, window 0 to 31) on
// a group of 8 threads; it took 0.120-0.125 ms at 2,048 lanes and the same at
// one lane on an NVIDIA H100 80GB HBM3 at 700.00 W: about 3.7 us an add, and
// only 512 warps in flight over 132 SMs.
//
// What the design does about it:
// - The windows split over W = 4 window groups, one warp a lane: group w of
//   G = 8 threads sums windows 8w .. 8w + 7, starting from its first entry
//   (not from the identity), so 7 adds.  The four partial sums then join in
//   two levels inside the warp: w0 + w1 and w2 + w3 at once (groups 0 and
//   2), then the two results (group 0).  A lane's chain is 7 + 2 = 9
//   complete adds where it was 32.  The partial sums pass through shared
//   memory between the levels, with __syncwarp over the warp.
// - Each add is cut into its three product levels (p256_field.cuh's
//   add_level1..3): role r of a group computes product r of a level into the
//   group's slots in shared memory, and the group meets at __syncwarp on its
//   own lanes.  An add costs 3 multiplication latencies where one thread
//   runs 14.
// - The complete add (RCB15 Algorithm 4) is kept, so a digit 0 (the entry
//   (0 : 1 : 0)) and a partial sum that is the identity need no branch.
// - Each thread reads the entry of window j + 1 from L2 while its group adds
//   window j's: each group stages its 8 digits in shared memory first.
// - 4 lanes a 128-thread block (512 blocks at 2,048 lanes).  A lane past the
//   batch leaves as a whole warp.
// The sum is not the plain version's chain, so the kernel lands on another
// projective representative of the same point (ROADMAP divergence 26): it
// writes canonical limbs, and Z = 0 exactly where the point is the identity.
// The comb is a template over the lane's warp (comb_lane) and each window
// group (window_sum): serial_warp runs every window group, and serial_group
// every role, in turn on one thread, which is what the host check compiled
// with g++ replays (tests/test_torch_verdict_kernels.py).
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
constexpr int ENTRY_WORDS = 24;  // x, y (and b x, unread): 8 words each
constexpr int W = 4;  // window groups a lane
constexpr int GROUP_WINDOWS = COMB_WINDOWS / W;
constexpr int LANE_THREADS = W * G;  // one warp
constexpr int LANES = 4;  // lanes (warps) a block
constexpr int THREADS = LANE_THREADS * LANES;

// The lane that thread t of block b works on.
HD long long comb_warp_lane(long long b, int t) { return b * LANES + t / LANE_THREADS; }

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

// --- the warp of one lane ---------------------------------------------------------
// A lane's warp runs GROUPS of its W window groups on this thread (group(i)
// is the i-th), and passes their partial sums through sums[W].  serial_warp
// runs every group in turn, each a serial_group over its own slots, with no
// barrier; on the card (lane_warp below) each thread is one role of one
// group.

struct serial_warp {
  static constexpr int GROUPS = W;
  fe (*slots)[SLOTS];  // one set for each window group
  ge* sums;
};

HD int group(const serial_warp&, int i) { return i; }
HD serial_group lane_group(const serial_warp& wp, int w) { return serial_group{wp.slots[w], 0, G}; }
HD void warp_sync(const serial_warp&) {}

// [u1]G for the lane at column `lane` of the (32, n) digits, on warp wp with
// its stage of COMB_WINDOWS digits; writes X, Y, Z at o[i * n + lane].
// Group w starts from entry 8w; steps 1-7 add its windows 8w + 1 .. 8w + 7
// (the next entry read while the group adds the current one); step 8 joins
// w0 + w1 and w2 + w3 on groups 0 and 2, step 9 their sums on group 0,
// whose roles 0-2 store.  One add site for every step.
template <class Warp>
HD void comb_lane(const Warp& wp, int32_t* stage, const u32* table, const int32_t* digits,
                  float* ox, float* oy, float* oz, long long n, long long lane) {
  constexpr int K = Warp::GROUPS;
  ge acc[K], q[K];
  for (int i = 0; i < K; ++i) {
    const int w = group(wp, i), j0 = w * GROUP_WINDOWS;
    const auto g = lane_group(wp, w);
    for (int r = g.role_lo; r < g.role_hi; ++r)
      for (int j = j0 + r; j < j0 + GROUP_WINDOWS; j += G)
        stage[j] = digits[j * n + lane] & (COMB_ENTRIES - 1);
    group_sync(g);
    acc[i] = comb_point(table, j0, stage[j0]);
    q[i] = comb_point(table, j0 + 1, stage[j0 + 1]);
  }
#pragma unroll 1
  for (int step = 1; step < GROUP_WINDOWS + 2; ++step) {
    const int span = 1 << (step - GROUP_WINDOWS);  // a join's distance: 1, then 2
    if (step >= GROUP_WINDOWS) {
      for (int i = 0; i < K; ++i) {
        const int w = group(wp, i);
        if (w % (2 * span) == span && lane_group(wp, w).role_lo == 0) wp.sums[w] = acc[i];
      }
      warp_sync(wp);
      for (int i = 0; i < K; ++i) {
        const int w = group(wp, i);
        if (w % (2 * span) == 0) q[i] = wp.sums[w + span];
      }
    }
    for (int i = 0; i < K; ++i) {
      const int w = group(wp, i), j0 = w * GROUP_WINDOWS;
      if (step >= GROUP_WINDOWS && w % (2 * span) != 0) continue;
      const int next = j0 + (step + 1 < GROUP_WINDOWS ? step + 1 : GROUP_WINDOWS - 1);
      const ge q_next = comb_point(table, next, stage[next]);
      acc[i] = group_add(lane_group(wp, w), acc[i], q[i]);
      q[i] = q_next;
    }
  }
  for (int i = 0; i < K; ++i) {
    if (group(wp, i) != 0) continue;
    const auto g = lane_group(wp, 0);
    for (int r = g.role_lo; r < g.role_hi; ++r) {
      if (r == 0) fe_store(ox + lane, n, acc[i].X);
      if (r == 1) fe_store(oy + lane, n, acc[i].Y);
      if (r == 2) fe_store(oz + lane, n, acc[i].Z);
    }
  }
}

}  // namespace

#ifdef __CUDACC__

static_assert(LANE_THREADS == 32, "a lane is one warp");
static_assert(GROUP_WINDOWS * W == COMB_WINDOWS && W == 4, "two join levels");

// One role of one window group of a lane's warp: the group (its slots and
// the mask of its G lanes) and the warp's partial sums in shared memory.
struct lane_warp {
  static constexpr int GROUPS = 1;
  int w;
  warp_group g;
  ge* sums;
};

// The card's warp functions are __host__ __device__ like the template that
// calls them; their intrinsic exists only in the device pass.
__host__ __device__ __forceinline__ int group(const lane_warp& wp, int) { return wp.w; }

__host__ __device__ __forceinline__ warp_group lane_group(const lane_warp& wp, int) {
  return wp.g;
}

__host__ __device__ __forceinline__ void warp_sync(const lane_warp&) {
#ifdef __CUDA_ARCH__
  __syncwarp();
#endif
}

__global__ void __launch_bounds__(THREADS)
comb_p256_kernel(const u32* __restrict__ table, const int32_t* __restrict__ digits,
                 float* __restrict__ ox, float* __restrict__ oy, float* __restrict__ oz,
                 int n) {
  __shared__ fe slots[LANES][W][SLOTS];
  __shared__ ge sums[LANES][W];
  __shared__ int32_t stages[LANES][COMB_WINDOWS];
  const int t = threadIdx.x, sub = t / LANE_THREADS, w = t % LANE_THREADS / G, role = t % G;
  const long long lane = comb_warp_lane(blockIdx.x, t);
  if (lane >= n) return;  // the ragged edge: the whole warp leaves
  const unsigned mask = ((1u << G) - 1u) << ((t % 32) & ~(G - 1));
  const lane_warp wp = {w, warp_group{slots[sub][w], role, role + 1, mask}, sums[sub]};
  comb_lane(wp, stages[sub], table, digits, ox, oy, oz, n, lane);
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
