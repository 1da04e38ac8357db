// Trial alternative to consensus_tpu_torch/csrc/mxu_limbs.cu for
// scripts/e1_p1_trials.py: kernel M1 on one warpgroup a block of 64 lanes,
// every thread running all 32 k-blocks (one accumulator chain of 32 wgmma a
// plane) and loading its own operands from global memory, each thread
// reducing both of its lanes.  Kept to be timed beside csrc's design, which
// splits the k-blocks over two warpgroups.  Its notes follow.
//
// Tensor-core field products for GF(2^255 - 19) and GF(p256), for Hopper
// (sm_90a).
//
// Kernel M1 of the port.  It replaces no TPU kernel: the JAX package's
// tensor-core lane (consensus_tpu/ops/mxu_limbs.py, selected by
// CTPU_MXU_LIMBS=1) is plain XLA, two integer dot_generals a product inside
// its jitted programs.  This kernel computes what that lane computes, and
// what the port's plain version of it (consensus_tpu_torch/ops/mxu_limbs.py)
// computes, in one launch a product:
// 1. the 32 x 32 outer product of the limbs, P[32i + j] = a_i * b_j (|a_i|,
//    |b_j| <= 680, so |P| <= 462,400 < 2^19);
// 2. the schoolbook columns cols = C P, against the constant (63, 1024) 0/1
//    column-assembly matrix C[c, 32i + j] = [i + j == c] (|col| < 2^24);
// 3. the int32 mirror of the field module's reduction: for Ed25519 the
//    carry-save split, the fold at weight 38, three relax passes and the top
//    fold; for P-256 the carry-save split, the Solinas word assembly and two
//    fold rounds.  Every step is the same integer as the plain version's, so
//    the float32 limbs written are bit-identical to field25519.mul /
//    field_p256.mul, weakly reduced, before any freeze.
//
// The design (the second; the first, 8 lanes a warp on mma.sync with one
// thread a lane reducing, is scripts/e1_p1_trials/mxu_limbs_first.cu):
// - The contraction is turned around: D (lanes x 64) = P (lanes x 1024) C^T
//   on wgmma.mma_async.m64nNk32 with 8-bit operands and int32 accumulators.
//   One warpgroup of 128 threads is a block and takes 64 lanes, wgmma's m:
//   warp w takes lanes 16w..16w+15, thread (g, t) of a warp lanes g and
//   g + 8.  Hopper's integer MMA takes only 8-bit operands, and a product
//   needs 20 bits, so P is cut into three byte planes, P = P0 + 2^8 P1 +
//   2^16 P2 with P0, P1 unsigned bytes and P2 = P >> 16 a signed byte in
//   [-8, 7]; each plane is one accumulator of 32 registers a thread, and the
//   planes' column sums (<= 32 x 255) recombine exactly in int32.
// - The products are operand A, from registers.  K-block i (k = 32 i + j) is
//   limb i of a: a thread's A fragment holds its two lanes' products a_i b_j
//   at j = 4t..4t+3 and 16+4t..16+4t+3, 16 IMAD, packed into the three plane
//   registers by byte permutes (plane 2 is byte 2 of the product read as a
//   signed byte: .s8 for that plane, .u8 for the others).  The operands never
//   go through any byte split.
// - C^T is operand B, in shared memory, K-major with no swizzle.  Its tile
//   for k-block i is 32 x N with byte j of column c = [c == i + j]: every tile
//   is a row shift of one band (row r, byte j = [r == j + 31]; 96 rows of 32
//   bytes), so the block writes the band once (3 KB, nothing loaded) and
//   k-block i's descriptor starts 31 - i rows into it.  With MXU_WINDOW 48
//   (a trial design) a k-block's MMAs cover only the 48 columns around its
//   nonzero ones, i..i+31.
// - The products overlap the MMAs: the A registers are double-buffered; per
//   k-block the thread forms its fragment, fences, issues the three planes'
//   wgmma and commits, then waits until one group is left in flight, so
//   k-block i+1's products are formed while k-block i's MMAs run.  96 wgmma
//   a block of 64 lanes (the first design ran 2,256 mma.sync for 64 lanes).
// - The reduction is split over the four threads of a quad, which hold a
//   lane's columns between them.  The D fragment gives thread t columns
//   8n + 2t and 8n + 2t + 1; the planes are joined there and each warp
//   stages its 16 lanes' 64 columns through shared memory (4 KB a warp), so
//   that thread t takes columns 4m + t (m = 0..15): then every fold of both
//   curves maps a thread's column to its own (the fold at 38 from 32 + k, the
//   Solinas words from 4W + t), and only carries cross threads, one
//   __shfl_sync inside the quad a value (the column below 4m + t is 4m + t - 1
//   on thread t - 1, 4m - 1 on thread 3).  Each thread writes 8 of its lane's
//   32 limbs; the sixteen lanes of a warp write 64-byte runs of each limb.
//
// What bounds it on this card: at the main path's widths (1 to 8,192 lanes)
// the bytes (two 128-byte operand rows and one output row a lane) take under
// a microsecond, and so do the dense MACs the counting shim books (65,536 or
// 67,584 a lane) at 1,979 int8 TOPS.  Up to 8,448 lanes a launch is one
// block an SM, so its time is one block's latency: 96 m64n64k32 wgmma (some
// 32 clocks each at the card's int8 rate) against 32 k-blocks of ~50
// instructions a warp, then the reduction.
//
// Layout at the C boundary: a and b are float32 limb rows, element (i, lane)
// at i * ld + lane * step, where (ld, step) is (n, 1) for a (32, n) operand
// and (1, 0) for a (32, 1) operand broadcast over the lanes; out is (32, n)
// float32.
//
// Everything above the __CUDACC__ line is __host__ __device__, so the same
// source compiles as plain C++ for the host check, which replays a
// warpgroup's fragments through an emulation of wgmma's documented fragment
// layouts and of its shared-memory descriptor, and the quads' shuffles by
// indexing (tests/test_torch_mxu_limbs.py).

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define MXU_HD __host__ __device__ __forceinline__
#define MXU_HD_MEMBER __host__ __device__ __forceinline__
#else
#define MXU_HD static inline
#define MXU_HD_MEMBER inline
#endif

#ifndef MXU_WINDOW
#define MXU_WINDOW 64
#endif

namespace {

constexpr int MXU_LIMBS = 32;
constexpr int MXU_WIDE = 64;        // the columns: 63 and a zero column
constexpr int TILE_LANES = 64;      // lanes a block: wgmma's m
constexpr int THREADS = 128;        // one warpgroup
constexpr int PLANES = 3;
constexpr int K_BLOCKS = 32;        // k-block i is limb i of a
constexpr int A_REGS = 4;           // a thread's A fragment: 4 registers of 4 bytes
constexpr int D_REGS = MXU_WIDE / 2;  // a thread's accumulator of one plane
constexpr int B_VALUES = 8;         // limbs of b a thread's fragment takes, per lane
constexpr int WINDOW = MXU_WINDOW;  // wgmma's n: the columns a k-block's MMAs cover
constexpr int BAND_ROWS = 96;       // rows of the band: 63 + 31 shifts, rounded up
constexpr int BAND_HALF = 16 * BAND_ROWS;  // bytes between the band's two K halves
constexpr int BAND_WORDS = 2 * BAND_HALF / 4;
constexpr int STAGE_STRIDE = 68;    // words between a lane's columns in the staging
constexpr int STAGE_WORDS = 16 * STAGE_STRIDE;  // a warp's 16 lanes
constexpr int ROLE_COLS = MXU_WIDE / 4;   // columns 4m + t of a lane on thread t
constexpr int ROLE_LIMBS = MXU_LIMBS / 4;

static_assert(WINDOW == 64 || WINDOW == 48, "wgmma windows of 64 or 48 columns");

constexpr int CURVE_ED25519 = 0;
constexpr int CURVE_P256 = 1;

// --- the fragments (PTX ISA, "Register Fragments and Shared Memory Matrix
// Layouts" for wgmma .m64nNk32 with 8-bit A and an int32 accumulator) -----------
// For thread (w, g, t) of the warpgroup (warp w, lane id 4 g + t):
// - A (64 x 32, from registers): register r holds row 16 w + g + 8 (r & 1),
//   columns 4 t + 16 (r >> 1) + q in its bytes q = 0..3;
// - D (64 x N): register v holds row 16 w + g + 8 ((v >> 1) & 1), column
//   8 (v >> 2) + 2 t + (v & 1);
// - B (32 x N) is read from shared memory through a descriptor (below).
MXU_HD int a_row(int w, int g, int r) { return 16 * w + g + 8 * (r & 1); }
MXU_HD int a_col(int t, int r, int q) { return 4 * t + 16 * (r >> 1) + q; }
MXU_HD int d_row(int w, int g, int v) { return 16 * w + g + 8 * ((v >> 1) & 1); }
MXU_HD int d_col(int t, int v) { return 8 * (v >> 2) + 2 * t + (v & 1); }

// The limb j of b that value u of a thread's b (one lane) multiplies: byte
// u & 3 of A register 2 (u >> 2) + h, for the lane of half h.
MXU_HD int b_limb(int t, int u) { return a_col(t, 2 * (u >> 2), u & 3); }

// The first column of k-block i's window: its nonzero columns i..i+31 lie in
// [window_col(i), window_col(i) + WINDOW).
MXU_HD constexpr int window_col(int i) {
  return 8 * ((i >> 3) < (MXU_WIDE - WINDOW) / 8 ? (i >> 3) : (MXU_WIDE - WINDOW) / 8);
}

// --- operand B: the band and its descriptors -------------------------------------
// Row r, K byte j of the band is [r == j + 31]; it is stored K-major with no
// swizzle, wgmma's canonical layout: an 8-row x 16-byte core matrix has its
// rows 16 bytes apart, the 8-row groups follow each other (128 bytes apart,
// the descriptor's stride byte offset), the K half j >> 4 lies BAND_HALF
// bytes on (its leading byte offset).  Rows 16 bytes apart throughout make a
// start 16 s bytes in the band's shift by s rows.
MXU_HD int band_offset(int r, int j) { return (j >> 4) * BAND_HALF + 16 * r + (j & 15); }

// Word `index` of the band (4-byte words in address order).
MXU_HD uint32_t band_word(int index) {
  const int half = index / (BAND_HALF / 4), rest = index % (BAND_HALF / 4);
  const int d = rest / 4 - 31 - 16 * half - 4 * (rest % 4);  // the 1's byte in this word
  return (d >= 0 && d < 4) ? (1u << (8 * d)) : 0u;
}

// The descriptor of k-block i's tile: B(j, c) = [c + window_col(i) == i + j]
// = band row c + 31 - i + window_col(i).  Bits 0-13 the start address / 16,
// 16-29 the leading byte offset / 16, 32-45 the stride byte offset / 16;
// base offset and layout type (bits 49-51, 62-63) 0: no swizzle.
MXU_HD uint64_t b_descriptor(uint32_t band_address, int i) {
  const uint32_t start = band_address + 16u * (uint32_t)(31 - i + window_col(i));
  return (uint64_t)((start >> 4) & 0x3FFFu) | ((uint64_t)(BAND_HALF >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// --- operand A: the products' byte planes ----------------------------------------

// Byte permute: byte q of the result is byte (s >> 4q) & 7 of {y, x} (x's
// bytes 0-3, y's 4-7), as PRMT / __byte_perm.
MXU_HD uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, y, s);
#else
  const uint64_t xy = ((uint64_t)y << 32) | x;
  uint32_t out = 0;
  for (int q = 0; q < 4; ++q) out |= (uint32_t)((xy >> (8 * ((s >> (4 * q)) & 7))) & 0xFFu) << (8 * q);
  return out;
#endif
}

// k-block i's A fragment of the three planes, from a_i of the thread's two
// lanes (a pair of int16 in one word, half 0 low) and its b values: register
// r = 2 jg + h holds byte q of the products a_i b_j of the lane of half h,
// j = 4 t + 16 jg + q.  Plane 2 is byte 2 of each product: p >> 16 as a
// signed byte, since |p| < 2^19.
MXU_HD void a_fragment(uint32_t a_pair, const int32_t (&bv)[2][B_VALUES],
                       uint32_t (&frag)[PLANES][A_REGS]) {
  const int32_t a_lane[2] = {(int32_t)(int16_t)(a_pair & 0xFFFFu), (int32_t)a_pair >> 16};
#pragma unroll
  for (int r = 0; r < A_REGS; ++r) {
    const int h = r & 1, jg = r >> 1;
    uint32_t p[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) p[q] = (uint32_t)(a_lane[h] * bv[h][4 * jg + q]);
    const uint32_t lo01 = byte_perm(p[0], p[1], 0x5140), lo23 = byte_perm(p[2], p[3], 0x5140);
    const uint32_t hi01 = byte_perm(p[0], p[1], 0x7362), hi23 = byte_perm(p[2], p[3], 0x7362);
    frag[0][r] = byte_perm(lo01, lo23, 0x5410);
    frag[1][r] = byte_perm(lo01, lo23, 0x7632);
    frag[2][r] = byte_perm(hi01, hi23, 0x5410);
  }
}

// The thread's operands: a_i of both lanes for every i as int16 pairs, and
// the 8 limbs of b its fragments take for each lane.  A lane past the batch
// computes on zeros.
MXU_HD int32_t limb_at(const float* p, long long index) {
#ifdef __CUDA_ARCH__
  return __float2int_rn(__ldg(p + index));
#else
  return (int32_t)p[index];
#endif
}

MXU_HD void load_operands(const float* a, const float* b, long long n, int a_ld, int a_step,
                          int b_ld, int b_step, long long lane0, int t,
                          uint32_t (&a_pairs)[K_BLOCKS], int32_t (&bv)[2][B_VALUES]) {
  const long long lane[2] = {lane0, lane0 + 8};
  const bool live[2] = {lane[0] < n, lane[1] < n};
#pragma unroll
  for (int i = 0; i < K_BLOCKS; ++i) {
    const int32_t lo = live[0] ? limb_at(a, (long long)i * a_ld + lane[0] * a_step) : 0;
    const int32_t hi = live[1] ? limb_at(a, (long long)i * a_ld + lane[1] * a_step) : 0;
    a_pairs[i] = ((uint32_t)lo & 0xFFFFu) | ((uint32_t)hi << 16);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int u = 0; u < B_VALUES; ++u)
      bv[h][u] = live[h] ? limb_at(b, (long long)b_limb(t, u) * b_ld + lane[h] * b_step) : 0;
}

// --- from D to the quads ----------------------------------------------------------

// A column from its three planes' sums.
MXU_HD int32_t join_planes(int32_t s0, int32_t s1, int32_t s2) { return s0 + 256 * s1 + 65536 * s2; }

// Word of column c of the warp's lane row (0..15) in its staging.
MXU_HD int stage_offset(int row, int c) { return row * STAGE_STRIDE + c; }

// The thread's D columns, planes joined, into its warp's staging: register
// pair (v, v + 1) is columns 8 (v >> 2) + 2 t and the one after, of row
// g + 8 ((v >> 1) & 1).
MXU_HD void stage_columns(int32_t* stage, int g, int t, const int32_t (&acc)[PLANES][D_REGS]) {
#pragma unroll
  for (int v = 0; v < D_REGS; v += 2) {
    const int off = stage_offset(d_row(0, g, v), d_col(t, v));
    const int32_t lo = join_planes(acc[0][v], acc[1][v], acc[2][v]);
    const int32_t hi = join_planes(acc[0][v + 1], acc[1][v + 1], acc[2][v + 1]);
#ifdef __CUDA_ARCH__
    *reinterpret_cast<int2*>(stage + off) = make_int2(lo, hi);
#else
    stage[off] = lo;
    stage[off + 1] = hi;
#endif
  }
}

// Role t's columns 4m + t of the lane in staging row `row`.
MXU_HD void gather_columns(const int32_t* stage, int row, int t, int32_t (&x)[ROLE_COLS]) {
#pragma unroll
  for (int m = 0; m < ROLE_COLS; ++m) x[m] = stage[stage_offset(row, 4 * m + t)];
}

// --- the reductions, split over a lane's quad -------------------------------------
// Role t of a lane's quad holds its columns (then limbs) 4m + t.  A quad
// type runs R of the four roles on this thread, role(q) for q < R, with
// per-role values in arrays [R]: serial_quad runs every role (R = 4) and
// exchanges by indexing; on the card (thread_quad below) each thread is one
// role (R = 1) and exchanges by shuffles.

struct serial_quad {
  static constexpr int R = 4;
  MXU_HD_MEMBER int role(int q) const { return q; }
};

// got[q][m] = v[m] of the role below role(q) (role 3 below role 0).
template <int M>
MXU_HD void from_below(const serial_quad&, const int32_t (&v)[4][M], int32_t (&got)[4][M]) {
  for (int q = 0; q < 4; ++q)
    for (int m = 0; m < M; ++m) got[q][m] = v[(q + 3) & 3][m];
}

// One carry pass over a lane's 4M columns: each becomes its low byte plus
// the carry (>> 8) of the column below; column 0 gets none, and wrap[q] is
// the carry out of column 4M - 1 (role 3's m = M - 1, as role 0 receives
// it; the curve folds it).
template <int M, class Quad>
MXU_HD void carry_pass(const Quad& quad, int32_t (&v)[Quad::R][M], int32_t (&wrap)[Quad::R]) {
  int32_t hi[Quad::R][M], got[Quad::R][M];
  for (int q = 0; q < Quad::R; ++q)
#pragma unroll
    for (int m = 0; m < M; ++m) {
      hi[q][m] = v[q][m] >> 8;
      v[q][m] -= 256 * hi[q][m];
    }
  from_below(quad, hi, got);
  for (int q = 0; q < Quad::R; ++q) {
    const bool first = quad.role(q) == 0;
    wrap[q] = got[q][M - 1];
#pragma unroll
    for (int m = 0; m < M; ++m) v[q][m] += first ? (m > 0 ? got[q][m - 1] : 0) : got[q][m];
  }
}

// field25519._reduce_cols: the carry-save split (column 63 is 0, so the 64th
// limb is column 62's carry), columns 32..63 folded at 38 (column 32 + k is
// the same role's m + 8), three relax passes (limb 31's carry to limb 0 at
// 38), the top fold of bit 255 at 19.
template <class Quad>
MXU_HD void reduce25519(const Quad& quad, int32_t (&x)[Quad::R][ROLE_COLS],
                        int32_t (&r)[Quad::R][ROLE_LIMBS]) {
  int32_t wrap[Quad::R];
  carry_pass(quad, x, wrap);
  for (int q = 0; q < Quad::R; ++q)
#pragma unroll
    for (int m = 0; m < ROLE_LIMBS; ++m) r[q][m] = x[q][m] + 38 * x[q][m + ROLE_LIMBS];
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    carry_pass(quad, r, wrap);
    for (int q = 0; q < Quad::R; ++q)
      if (quad.role(q) == 0) r[q][0] += 38 * wrap[q];
  }
  int32_t top[Quad::R][1], got[Quad::R][1];
  for (int q = 0; q < Quad::R; ++q) top[q][0] = r[q][ROLE_LIMBS - 1];
  from_below(quad, top, got);
  for (int q = 0; q < Quad::R; ++q) {
    if (quad.role(q) == 0) r[q][0] += 19 * (got[q][0] >> 7);
    if (quad.role(q) == 3) r[q][ROLE_LIMBS - 1] -= 128 * (r[q][ROLE_LIMBS - 1] >> 7);
  }
}

// field_p256._reduce_wide: the carry-save split, FIPS 186-4 D.2.3's word
// assembly s1 + 2 s2 + 2 s3 + s4 + s5 - s6 - s7 - s8 - s9 over the 16 words
// of 4 limbs (word w of term s_k is input word SOLINAS_WORD[k][w], -1 for
// zero; field_p256._solinas_matrix as words: limb 4w + t of the result takes
// limbs 4W + t, all on role t), then two rounds of a carry pass and the fold
// of the overflow limb through 2^256 = +1 @0, -1 @12, -1 @24, +1 @28 (all on
// role 0: m = 0, 3, 6, 7).
template <class Quad>
MXU_HD void reduce_p256(const Quad& quad, int32_t (&x)[Quad::R][ROLE_COLS],
                        int32_t (&r)[Quad::R][ROLE_LIMBS]) {
  constexpr int8_t SOLINAS_WORD[9][8] = {
      {0, 1, 2, 3, 4, 5, 6, 7},           {-1, -1, -1, 11, 12, 13, 14, 15},
      {-1, -1, -1, 12, 13, 14, 15, -1},   {8, 9, 10, -1, -1, -1, 14, 15},
      {9, 10, 11, 13, 14, 15, 13, 8},     {11, 12, 13, -1, -1, -1, 8, 10},
      {12, 13, 14, 15, -1, -1, 9, 11},    {13, 14, 15, 8, 9, 10, -1, 12},
      {14, 15, -1, 9, 10, 11, -1, 13},
  };
  constexpr int8_t SOLINAS_COEF[9] = {1, 2, 2, 1, 1, -1, -1, -1, -1};
  int32_t wrap[Quad::R];
  carry_pass(quad, x, wrap);
  // Unrolled whole, so the table folds into the code.
  for (int q = 0; q < Quad::R; ++q)
#pragma unroll
    for (int w = 0; w < ROLE_LIMBS; ++w) {
      int32_t acc = 0;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        if (SOLINAS_WORD[k][w] >= 0) acc += SOLINAS_COEF[k] * x[q][SOLINAS_WORD[k][w]];
      }
      r[q][w] = acc;
    }
#pragma unroll
  for (int round = 0; round < 2; ++round) {
    carry_pass(quad, r, wrap);
    for (int q = 0; q < Quad::R; ++q)
      if (quad.role(q) == 0) {
        r[q][0] += wrap[q];
        r[q][3] -= wrap[q];
        r[q][6] -= wrap[q];
        r[q][7] += wrap[q];
      }
  }
}

template <int CURVE, class Quad>
MXU_HD void reduce_columns(const Quad& quad, int32_t (&x)[Quad::R][ROLE_COLS],
                           int32_t (&r)[Quad::R][ROLE_LIMBS]) {
  if (CURVE == CURVE_ED25519) {
    reduce25519(quad, x, r);
  } else {
    reduce_p256(quad, x, r);
  }
}

// Role t's limbs 4m + t of `lane`.
MXU_HD void store_limbs(float* out, long long n, long long lane, int t,
                        const int32_t (&r)[ROLE_LIMBS]) {
  if (lane >= n) return;
#pragma unroll
  for (int m = 0; m < ROLE_LIMBS; ++m) out[(long long)(4 * m + t) * n + lane] = (float)r[m];
}

}  // namespace

#ifdef __CUDACC__

namespace {

// One role of a lane's quad: the thread's place t in its four adjacent
// threads of the warp.
struct thread_quad {
  static constexpr int R = 1;
  int t;
  MXU_HD_MEMBER int role(int) const { return t; }
};

// The card's exchange is __host__ __device__ like the templates that call
// it; its intrinsic exists only in the device pass.  Every thread of the
// warp reaches every shuffle, so the mask is the whole warp.
template <int M>
MXU_HD void from_below(const thread_quad& quad, const int32_t (&v)[1][M], int32_t (&got)[1][M]) {
#ifdef __CUDA_ARCH__
#pragma unroll
  for (int m = 0; m < M; ++m) got[0][m] = __shfl_sync(0xffffffffu, v[0][m], (quad.t + 3) & 3, 4);
#else
  (void)quad;
  for (int m = 0; m < M; ++m) got[0][m] = v[0][m];
#endif
}

// --- wgmma (PTX ISA 8.0, sm_90a) ----------------------------------------------------

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous MMAs (a register "written" here after the last wait).
__device__ __forceinline__ void fence_accumulators(int32_t (&acc)[PLANES][D_REGS]) {
#pragma unroll
  for (int p = 0; p < PLANES; ++p)
#pragma unroll
    for (int v = 0; v < D_REGS; ++v) asm volatile("" : "+r"(acc[p][v])::"memory");
}

#define MXU_D8(o)                                                                           \
  "+r"(d[(o) + 0]), "+r"(d[(o) + 1]), "+r"(d[(o) + 2]), "+r"(d[(o) + 3]), "+r"(d[(o) + 4]), \
      "+r"(d[(o) + 5]), "+r"(d[(o) + 6]), "+r"(d[(o) + 7])

// D[:, OFF/4 * 8 ..] += A B over one k-block: A the plane's bytes from
// registers (signed for plane 2), B the 0/1 tile (unsigned) through `desc`;
// D is the accumulator's registers from OFF (the window's first column / 2).
template <bool SIGNED_A, int OFF>
__device__ __forceinline__ void wgmma_k32(int32_t (&acc)[D_REGS], const uint32_t (&a)[A_REGS],
                                          uint64_t desc) {
  int32_t* d = acc + OFF;
  if constexpr (WINDOW == 64) {
    static_assert(OFF == 0, "a 64-column window is the whole accumulator");
    if constexpr (SIGNED_A) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.u8 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
          "{%32, %33, %34, %35}, %36, p;\n}\n"
          : MXU_D8(0), MXU_D8(8), MXU_D8(16), MXU_D8(24)
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
    } else {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
          "{%32, %33, %34, %35}, %36, p;\n}\n"
          : MXU_D8(0), MXU_D8(8), MXU_D8(16), MXU_D8(24)
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
    }
  } else {
    if constexpr (SIGNED_A) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.u8 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23}, "
          "{%24, %25, %26, %27}, %28, p;\n}\n"
          : MXU_D8(0), MXU_D8(8), MXU_D8(16)
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
    } else {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n48k32.s32.u8.u8 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23}, "
          "{%24, %25, %26, %27}, %28, p;\n}\n"
          : MXU_D8(0), MXU_D8(8), MXU_D8(16)
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
    }
  }
}

#undef MXU_D8

// The three planes' MMAs of k-block i, on the accumulators of its window.
template <int OFF>
__device__ __forceinline__ void planes_k32(int32_t (&acc)[PLANES][D_REGS],
                                           const uint32_t (&frag)[PLANES][A_REGS], uint64_t desc) {
  wgmma_k32<false, OFF>(acc[0], frag[0], desc);
  wgmma_k32<false, OFF>(acc[1], frag[1], desc);
  wgmma_k32<true, OFF>(acc[2], frag[2], desc);
}

}  // namespace

// One kernel a curve (ptxas names them mxu_limbs_kernel<0> and <1>).
template <int CURVE>
__global__ void __launch_bounds__(THREADS, 1)
    mxu_limbs_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ out, int n, int a_ld, int a_step, int b_ld,
                     int b_step) {
  __shared__ __align__(128) uint32_t band[BAND_WORDS];
  __shared__ __align__(16) int32_t stage[THREADS / 32][STAGE_WORDS];
  const int w = threadIdx.x >> 5;
  const int id = threadIdx.x & 31;
  const int g = id >> 2;
  const int t = id & 3;
  const long long lane0 = (long long)blockIdx.x * TILE_LANES + 16 * w + g;

  // The band, written by the block's threads, made visible to the MMAs'
  // (asynchronous) reads.
  for (int k = threadIdx.x; k < BAND_WORDS; k += THREADS) band[k] = band_word(k);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  uint32_t a_pairs[K_BLOCKS];
  int32_t bv[2][B_VALUES];
  load_operands(a, b, n, a_ld, a_step, b_ld, b_step, lane0, t, a_pairs, bv);

  int32_t acc[PLANES][D_REGS];
#pragma unroll
  for (int p = 0; p < PLANES; ++p)
#pragma unroll
    for (int v = 0; v < D_REGS; ++v) acc[p][v] = 0;
  fence_accumulators(acc);
  const uint32_t band_address = (uint32_t)__cvta_generic_to_shared(band);
  uint32_t frag[2][PLANES][A_REGS];
#pragma unroll
  for (int i = 0; i < K_BLOCKS; ++i) {
    // Buffer i & 1 was last read by k-block i - 2's MMAs, complete by the
    // wait at the end of k-block i - 1.
    a_fragment(a_pairs[i], bv, frag[i & 1]);
    wgmma_fence();
    const uint64_t desc = b_descriptor(band_address, i);
    if constexpr (WINDOW == 64) {
      planes_k32<0>(acc, frag[i & 1], desc);
    } else if (window_col(i) == 0) {
      planes_k32<0>(acc, frag[i & 1], desc);
    } else if (window_col(i) == 8) {
      planes_k32<4>(acc, frag[i & 1], desc);
    } else {
      planes_k32<8>(acc, frag[i & 1], desc);
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_accumulators(acc);

  int32_t* st = stage[w];
  stage_columns(st, g, t, acc);
  __syncwarp();
  const thread_quad quad = {t};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int32_t x[1][ROLE_COLS], r[1][ROLE_LIMBS];
    gather_columns(st, g + 8 * h, t, x[0]);
    reduce_columns<CURVE>(quad, x, r);
    store_limbs(out, n, lane0 + 8 * h, t, r[0]);
  }
}

// curve 0 is GF(2^255 - 19), 1 is GF(p256); a_bcast / b_bcast mark a (32, 1)
// operand broadcast over the n lanes.
extern "C" int mxu_limbs_launch(const void* a, const void* b, void* out, int n, int curve,
                                int a_bcast, int b_bcast, int device, void* stream) {
  if (n <= 0) return 0;
  if (curve != CURVE_ED25519 && curve != CURVE_P256) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + TILE_LANES - 1) / TILE_LANES;
  const int a_ld = a_bcast ? 1 : n, a_step = a_bcast ? 0 : 1;
  const int b_ld = b_bcast ? 1 : n, b_step = b_bcast ? 0 : 1;
  if (curve == CURVE_ED25519) {
    mxu_limbs_kernel<CURVE_ED25519><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (float*)out, n, a_ld, a_step, b_ld, b_step);
  } else {
    mxu_limbs_kernel<CURVE_P256><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (float*)out, n, a_ld, a_step, b_ld, b_step);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* mxu_limbs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
