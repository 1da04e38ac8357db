// SHA-512 (FIPS 180-4) of a batch of pre-padded messages, for Hopper (sm_90a).
//
// Kernel S1 of the port.  It replaces no TPU kernel: the JAX package hashes on
// the device with plain XLA (consensus_tpu/ops/sha512.py::sha512_blocks, the
// 80 rounds one lax.scan body on (hi, lo) uint32 word pairs).  Run eagerly in
// torch, that body is some 8,000 launches a block; the transcript root of a
// randomized config-3 wave is one lane of ~3,431 blocks, minutes of launches.
// This kernel computes the same function as sha512_blocks: per lane, the
// state after absorbing the lane's first n_blocks blocks (a lane whose count
// is smaller stops early, as JAX's select keeps its state frozen).
//
// What bounds it on this card: a lane's blocks are a chain (each block's
// compression starts from the state the last one left), and the 80 rounds of
// a block are a chain through a..h.  At a wave's width (thousands of lanes,
// one or two blocks each) the integer instructions over every SM bound it; on
// the transcript root (one lane, thousands of blocks) one thread's chain of
// dependent rounds does, and nothing in the function can be spread.
//
// What the design does about it: one thread per lane, 128 lanes a block, the
// words in native uint64_t (the card's 64-bit adds, rotates by funnel shifts);
// the 80 round constants in __constant__ memory, read uniformly by every
// thread of a warp; the state and a rolling 16-word schedule window in
// registers (the rounds are unrolled, so every window index is a constant).
// Neighbouring lanes read neighbouring words of the (block, word, hi/lo, lane)
// layout.  It writes the final state, (8, 2, batch) uint32: word i's high half
// at [i][0], low half at [i][1], as sha512_blocks returns it.
//
// Everything above the __CUDACC__ line is device code under nvcc and plain
// C++ under a host compiler, so the same source compiles with g++ for the
// host check (tests/test_torch_sha512.py).

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __device__ __forceinline__
#define SHA_CONSTANT __constant__
#else
#define HD static inline
#define SHA_CONSTANT
#endif

namespace {

constexpr int THREADS = 128;  // lanes a block

SHA_CONSTANT const uint64_t K[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL, 0xe9b5dba58189dbbcULL,
    0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL, 0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL,
    0xd807aa98a3030242ULL, 0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL, 0xc19bf174cf692694ULL,
    0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL, 0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL,
    0x2de92c6f592b0275ULL, 0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL, 0xbf597fc7beef0ee4ULL,
    0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL, 0x06ca6351e003826fULL, 0x142929670a0e6e70ULL,
    0x27b70a8546d22ffcULL, 0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL, 0x92722c851482353bULL,
    0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL, 0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL,
    0xd192e819d6ef5218ULL, 0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL, 0x34b0bcb5e19b48a8ULL,
    0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL, 0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL,
    0x748f82ee5defb2fcULL, 0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL, 0xc67178f2e372532bULL,
    0xca273eceea26619cULL, 0xd186b8c721c0c207ULL, 0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL,
    0x06f067aa72176fbaULL, 0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL, 0x431d67c49c100d4cULL,
    0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL, 0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL,
};

// The initial state (FIPS 180-4 5.3.5).
SHA_CONSTANT const uint64_t IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
    0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL, 0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
};

HD uint64_t rotr(uint64_t x, int r) { return (x >> r) | (x << (64 - r)); }
HD uint64_t big_sigma0(uint64_t a) { return rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39); }
HD uint64_t big_sigma1(uint64_t e) { return rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41); }
HD uint64_t small_sigma0(uint64_t x) { return rotr(x, 1) ^ rotr(x, 8) ^ (x >> 7); }
HD uint64_t small_sigma1(uint64_t x) { return rotr(x, 19) ^ rotr(x, 61) ^ (x >> 6); }

// One compression of block (word i's high half at blk[2 i * stride], its low
// half at blk[(2 i + 1) * stride]) into h.  The schedule is a rolling window
// of 16 words: round t >= 16 overwrites w[t % 16] with W_t.
HD void compress(uint64_t h[8], const uint32_t* blk, long long stride) {
  uint64_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    w[i] = (uint64_t(blk[(2 * i) * stride]) << 32) | uint64_t(blk[(2 * i + 1) * stride]);
  }
  uint64_t a = h[0], b = h[1], c = h[2], d = h[3];
  uint64_t e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll
  for (int t = 0; t < 80; ++t) {
    if (t >= 16) {
      w[t & 15] += small_sigma1(w[(t - 2) & 15]) + w[(t - 7) & 15] + small_sigma0(w[(t - 15) & 15]);
    }
    const uint64_t t1 = hh + big_sigma1(e) + ((e & f) ^ (~e & g)) + K[t] + w[t & 15];
    const uint64_t t2 = big_sigma0(a) + ((a & b) ^ (a & c) ^ (b & c));
    hh = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  h[0] += a;
  h[1] += b;
  h[2] += c;
  h[3] += d;
  h[4] += e;
  h[5] += f;
  h[6] += g;
  h[7] += hh;
}

// Lane `lane` of the batch: its first min(n_blocks[lane], block_count) blocks
// absorbed from the IV, the state written as (8, 2, batch) uint32 halves.
HD void hash_lane(const uint32_t* blocks, const int32_t* n_blocks, uint32_t* state,
                  long long batch, int block_count, long long lane) {
  uint64_t h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = IV[i];
  int n = n_blocks[lane];
  if (n > block_count) n = block_count;
  for (int b = 0; b < n; ++b) compress(h, blocks + (long long)b * 32 * batch + lane, batch);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    state[(2 * i) * batch + lane] = uint32_t(h[i] >> 32);
    state[(2 * i + 1) * batch + lane] = uint32_t(h[i]);
  }
}

}  // namespace

// Layout at the C boundary (batch trailing, as in the JAX package): blocks
// (block_count, 16, 2, batch) uint32 big-endian message words, word i of a
// block as its high half [i][0] and low half [i][1]; n_blocks (batch,) int32;
// state (8, 2, batch) uint32 out.

#ifdef __CUDACC__

__global__ void __launch_bounds__(THREADS)
sha512_kernel(const uint32_t* __restrict__ blocks, const int32_t* __restrict__ n_blocks,
              uint32_t* __restrict__ state, long long batch, int block_count) {
  const long long lane = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= batch) return;
  hash_lane(blocks, n_blocks, state, batch, block_count, lane);
}

extern "C" int sha512_launch(const void* blocks, const void* n_blocks, void* state,
                             int batch, int block_count, int device, void* stream) {
  if (batch <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int grid = (batch + THREADS - 1) / THREADS;
  sha512_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)blocks, (const int32_t*)n_blocks, (uint32_t*)state, batch,
      block_count);
  return (int)cudaGetLastError();
}

extern "C" const char* sha512_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
