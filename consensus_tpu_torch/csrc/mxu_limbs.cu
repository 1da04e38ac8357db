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
// Where the tensor cores go.  Step 2 runs on them: mma.sync m16n8k32 with
// 8-bit operands and int32 accumulators (IMMA), A = a 16 x 32 tile of C, B =
// a 32 x 8 tile of P (k = 32i + j, 8 field lanes).  Hopper's integer MMA
// takes only 8-bit operands, and a product needs 20 bits, so P is cut into
// three byte planes, P = P0 + 2^8 P1 + 2^16 P2 with P0, P1 unsigned bytes and
// P2 = P >> 16 a signed byte in [-8, 7]; each plane is one MMA pass against
// C, the planes' column sums (<= 32 x 255) recombine exactly in int32.  C's
// fragments are made in registers (a byte is 1 where i + k == row), so C is
// never loaded.  A k-block of 32 is one limb i of a, whose nonzero rows are
// i..i+31: only the 2 or 3 of the 4 row tiles that meet them are issued, 94
// MMAs a plane for 8 lanes instead of 128.  Step 1 is a rank-1 product per
// lane (k = 1): on the tensor cores it would be almost all padding, so it
// runs as IMAD in registers, each product computed once, by the thread whose
// B fragment holds it.  The operands never go through any byte split.
//
// What bounds it on this card: at the main path's widths (1 to 8,192 lanes)
// the bytes (two 128-byte operand rows and one output row a lane) take under
// a microsecond, and so do the dense MACs the counting shim books (65,536 or
// 67,584 a lane) at 1,979 int8 TOPS.  A launch is latency: a warp runs 282
// MMAs (each row tile and plane one accumulator chain), ~1,000 IMADs and the
// byte packing, then one thread a lane runs the serial carry passes.  This
// first design is simple: 8 lanes a warp, 4 warps a block, columns through
// shared memory, a reduction thread per lane (24 of a warp's 32 threads idle
// during it).  ptxas: 190 registers, 8,320 bytes of shared memory, no
// spills; 282 IMMA a kernel in its SASS.  A launch alone took 0.018-0.024
// ms at every width from 1 to 8,192 lanes, where the VPU lane's ~20 eager
// ops took 0.44-0.88 ms (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py
// phase 21).
//
// Layout at the C boundary: a and b are float32 limb rows, element (i, lane)
// at i * ld + lane * step, where (ld, step) is (n, 1) for a (32, n) operand
// and (1, 0) for a (32, 1) operand broadcast over the lanes; out is (32, n)
// float32.
//
// Everything above the __CUDACC__ line is __host__ __device__, so the same
// source compiles as plain C++ for the host check, which replays a warp's
// fragments through an emulation of the MMA's documented fragment layout
// (tests/test_torch_mxu_limbs.py).

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define MXU_HD __host__ __device__ __forceinline__
#else
#define MXU_HD static inline
#endif

namespace {

constexpr int MXU_LIMBS = 32;
constexpr int MXU_COLS = 63;
constexpr int MXU_WIDE = 64;       // the columns after the carry-save split
constexpr int COL_STRIDE = 65;     // a lane's columns in shared memory (odd: no bank conflicts)
constexpr int WARP_LANES = 8;      // field lanes a warp: the MMA's n
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int M_TILES = 4;         // 64 rows of C (63 columns and a zero row), 16 a tile
constexpr int PLANES = 3;
constexpr int B_WORDS = 8;         // products a thread holds for one k-block

constexpr int CURVE_ED25519 = 0;
constexpr int CURVE_P256 = 1;

// --- the column stage's fragments ----------------------------------------------
// mma.sync.m16n8k32 with 8-bit operands (PTX ISA, "Matrix Fragments for
// mma.m16n8k32"), for lane id = 4 g + t of a warp:
// - A (16 x 32, row-major): register r holds row g + 8 (r & 1), columns
//   4 t + 16 (r >> 1) + q in its bytes q = 0..3;
// - B (32 x 8, column-major): register r holds rows 4 t + 16 r + q, column g;
// - D (16 x 8, int32): element e holds row g + 8 (e >> 1), column 2 t + (e & 1).

// Whether row tile mt (rows 16 mt .. 16 mt + 15) of C meets k-block i, whose
// nonzero rows are i .. i + 31.
MXU_HD constexpr bool tile_live(int mt, int i) { return 16 * mt <= i + 31 && 16 * mt + 15 >= i; }

// Register r of thread (g, t)'s A fragment of C's tile (mt, i): byte q is
// C[16 mt + row, 32 i + col] = [i + col == 16 mt + row].
MXU_HD uint32_t assembly_fragment(int mt, int i, int g, int t, int r) {
  const int d = 16 * mt + g + 8 * (r & 1) - i - 4 * t - 16 * (r >> 1);
  return (d >= 0 && d < 4) ? (1u << (8 * d)) : 0u;
}

// The limb j of b that byte q of thread (g, t)'s B register r multiplies.
MXU_HD int b_limb(int t, int r, int q) { return 4 * t + 16 * r + q; }

// Byte plane `plane` of four products, packed as one B register: plane 0 and 1
// are bytes 0 and 1 (unsigned), plane 2 the signed top p >> 16.
MXU_HD uint32_t plane_word(const int32_t p[4], int plane) {
  const int s = 8 * plane;
  return ((uint32_t)(p[0] >> s) & 0xFFu) | (((uint32_t)(p[1] >> s) & 0xFFu) << 8) |
         (((uint32_t)(p[2] >> s) & 0xFFu) << 16) | (((uint32_t)(p[3] >> s) & 0xFFu) << 24);
}

// A column from its three planes' sums.
MXU_HD int32_t join_planes(int32_t s0, int32_t s1, int32_t s2) { return s0 + 256 * s1 + 65536 * s2; }

// --- the reductions: int32 mirrors of the field modules' ---------------------------

// The carry-save split of 63 columns into 64: lo at c, hi one column up.
MXU_HD void carry_save(const int32_t* cols, int32_t x[MXU_WIDE]) {
  int32_t hi_prev = 0;
#pragma unroll
  for (int c = 0; c < MXU_COLS; ++c) {
    const int32_t hi = cols[c] >> 8;
    x[c] = cols[c] - 256 * hi + hi_prev;
    hi_prev = hi;
  }
  x[MXU_COLS] = hi_prev;
}

// One relax pass over 32 limbs: lo + the limb below's hi, limb 31's hi folded
// to limb 0 at weight 2^256 = 38.
MXU_HD void relax25519(int32_t x[MXU_LIMBS]) {
  int32_t hi[MXU_LIMBS];
#pragma unroll
  for (int k = 0; k < MXU_LIMBS; ++k) {
    hi[k] = x[k] >> 8;
    x[k] -= 256 * hi[k];
  }
  x[0] += 38 * hi[MXU_LIMBS - 1];
#pragma unroll
  for (int k = 1; k < MXU_LIMBS; ++k) x[k] += hi[k - 1];
}

// field25519._reduce_cols: columns 32..63 fold at 38, three relax passes, the
// top fold of bit 255 at 19.
MXU_HD void reduce25519(const int32_t* cols, int32_t r[MXU_LIMBS]) {
  int32_t x[MXU_WIDE];
  carry_save(cols, x);
#pragma unroll
  for (int k = 0; k < MXU_LIMBS; ++k) r[k] = x[k] + 38 * x[MXU_LIMBS + k];
  relax25519(r);
  relax25519(r);
  relax25519(r);
  const int32_t high = r[MXU_LIMBS - 1] >> 7;
  r[0] += 19 * high;
  r[MXU_LIMBS - 1] -= 128 * high;
}

// field_p256._reduce_wide: the carry-save split, FIPS 186-4 D.2.3's word
// assembly s1 + 2 s2 + 2 s3 + s4 + s5 - s6 - s7 - s8 - s9 over the 16 words
// of 4 limbs (word w of term s_k is input word SOLINAS_WORD[k][w], -1 for
// zero; field_p256._solinas_matrix as words), then two rounds of a carry-save
// pass and the fold of the overflow limb through 2^256 = +1 @0, -1 @12,
// -1 @24, +1 @28.
MXU_HD void reduce_p256(const int32_t* cols, int32_t r[MXU_LIMBS]) {
  constexpr int8_t SOLINAS_WORD[9][8] = {
      {0, 1, 2, 3, 4, 5, 6, 7},           {-1, -1, -1, 11, 12, 13, 14, 15},
      {-1, -1, -1, 12, 13, 14, 15, -1},   {8, 9, 10, -1, -1, -1, 14, 15},
      {9, 10, 11, 13, 14, 15, 13, 8},     {11, 12, 13, -1, -1, -1, 8, 10},
      {12, 13, 14, 15, -1, -1, 9, 11},    {13, 14, 15, 8, 9, 10, -1, 12},
      {14, 15, -1, 9, 10, 11, -1, 13},
  };
  constexpr int8_t SOLINAS_COEF[9] = {1, 2, 2, 1, 1, -1, -1, -1, -1};
  int32_t x[MXU_WIDE];
  carry_save(cols, x);
  // Unrolled whole, so the table folds into the code.
#pragma unroll
  for (int w = 0; w < 8; ++w) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      int32_t acc = 0;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        if (SOLINAS_WORD[k][w] >= 0) acc += SOLINAS_COEF[k] * x[4 * SOLINAS_WORD[k][w] + b];
      }
      r[4 * w + b] = acc;
    }
  }
#pragma unroll
  for (int round = 0; round < 2; ++round) {
    int32_t hi[MXU_LIMBS];
#pragma unroll
    for (int k = 0; k < MXU_LIMBS; ++k) {
      hi[k] = r[k] >> 8;
      r[k] -= 256 * hi[k];
    }
#pragma unroll
    for (int k = 1; k < MXU_LIMBS; ++k) r[k] += hi[k - 1];
    const int32_t top = hi[MXU_LIMBS - 1];
    r[0] += top;
    r[12] -= top;
    r[24] -= top;
    r[28] += top;
  }
}

template <int CURVE>
MXU_HD void reduce_columns(const int32_t* cols, int32_t r[MXU_LIMBS]) {
  if (CURVE == CURVE_ED25519) {
    reduce25519(cols, r);
  } else {
    reduce_p256(cols, r);
  }
}

}  // namespace

#ifdef __CUDACC__

namespace {

// D += A B over one m16n8k32 tile: A unsigned bytes (C's 0/1), B unsigned
// (planes 0, 1) or signed (plane 2) bytes, int32 accumulators.
template <bool SIGNED_B>
__device__ __forceinline__ void mma_k32(int32_t d[4], const uint32_t a[4], uint32_t b0,
                                        uint32_t b1) {
  if (SIGNED_B) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

template <int CURVE>
__global__ void __launch_bounds__(THREADS)
    mxu_limbs_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ out, int n, int a_ld, int a_step, int b_ld,
                     int b_step) {
  __shared__ int32_t cols[WARPS][WARP_LANES * COL_STRIDE];
  const int warp = threadIdx.x >> 5;
  const int id = threadIdx.x & 31;
  const int g = id >> 2;
  const int t = id & 3;
  const long long base = ((long long)blockIdx.x * WARPS + warp) * WARP_LANES;
  const long long lane = base + g;
  const bool live = lane < n;

  // The thread's operands: every limb of a at its lane, the 8 limbs of b its
  // B fragments hold.  A lane past the batch computes on zeros.
  int32_t av[MXU_LIMBS];
  int32_t bv[B_WORDS];
#pragma unroll
  for (int i = 0; i < MXU_LIMBS; ++i) {
    av[i] = live ? __float2int_rn(__ldg(a + (long long)i * a_ld + lane * a_step)) : 0;
  }
#pragma unroll
  for (int w = 0; w < B_WORDS; ++w) {
    const int j = b_limb(t, w >> 2, w & 3);
    bv[w] = live ? __float2int_rn(__ldg(b + (long long)j * b_ld + lane * b_step)) : 0;
  }

  int32_t acc[M_TILES][PLANES][4];
#pragma unroll
  for (int mt = 0; mt < M_TILES; ++mt)
#pragma unroll
    for (int p = 0; p < PLANES; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][p][e] = 0;

#pragma unroll
  for (int i = 0; i < MXU_LIMBS; ++i) {
    // The outer product's 8 entries of k-block i that this thread feeds.
    int32_t prod[B_WORDS];
#pragma unroll
    for (int w = 0; w < B_WORDS; ++w) prod[w] = av[i] * bv[w];
    uint32_t bf[PLANES][2];
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      bf[p][0] = plane_word(prod, p);
      bf[p][1] = plane_word(prod + 4, p);
    }
#pragma unroll
    for (int mt = 0; mt < M_TILES; ++mt) {
      if (!tile_live(mt, i)) continue;
      uint32_t af[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) af[r] = assembly_fragment(mt, i, g, t, r);
      mma_k32<false>(acc[mt][0], af, bf[0][0], bf[0][1]);
      mma_k32<false>(acc[mt][1], af, bf[1][0], bf[1][1]);
      mma_k32<true>(acc[mt][2], af, bf[2][0], bf[2][1]);
    }
  }

  // The planes joined into columns, each lane's 64 rows to shared memory.
  int32_t* wc = cols[warp];
#pragma unroll
  for (int mt = 0; mt < M_TILES; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * mt + g + 8 * (e >> 1);
      const int col_lane = 2 * t + (e & 1);
      wc[col_lane * COL_STRIDE + row] = join_planes(acc[mt][0][e], acc[mt][1][e], acc[mt][2][e]);
    }
  __syncwarp();

  // One thread a lane reduces its columns and writes the limbs.
  if (id < WARP_LANES) {
    const long long mine = base + id;
    if (mine < n) {
      int32_t r[MXU_LIMBS];
      reduce_columns<CURVE>(wc + id * COL_STRIDE, r);
#pragma unroll
      for (int k = 0; k < MXU_LIMBS; ++k) out[(long long)k * n + mine] = (float)r[k];
    }
  }
}

}  // namespace

// curve 0 is GF(2^255 - 19), 1 is GF(p256); a_bcast / b_bcast mark a (32, 1)
// operand broadcast over the n lanes.
extern "C" int mxu_limbs_launch(const void* a, const void* b, void* out, int n, int curve,
                                int a_bcast, int b_bcast, int device, void* stream) {
  if (n <= 0) return 0;
  if (curve != CURVE_ED25519 && curve != CURVE_P256) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int lanes_a_block = WARPS * WARP_LANES;
  const int blocks = (n + lanes_a_block - 1) / lanes_a_block;
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
