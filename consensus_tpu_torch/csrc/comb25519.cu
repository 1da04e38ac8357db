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
// each add waits on a table read from L2 at an address its digit picks.
//
// What the design does about it: one thread per lane, 64 lanes a block (128
// blocks at 8,192 lanes); the table read is 15 independent 64-bit loads
// through the read-only path; fe_mul inlined in the add, the window loop
// not unrolled (one copy of the add's code).  A batch of one (the
// randomized check's [sum z_i s_i]B) is one thread.
//
// Layout at the C boundary: the (32, 256, 3, 5) uint64 table; (32, n) int32
// digits, LSB window first, element (j, lane) at j * n + lane (bytes 0-255:
// the kernel reads the low 8 bits); four (32, n) float32 outputs holding
// canonical limbs in [0, 255].
//
// Everything above the __CUDACC__ line is __host__ __device__, so the same
// source compiles as plain C++ for the host check
// (tests/test_torch_decompress_comb.py).

#include "ed25519_field.cuh"

namespace {

constexpr int COMB_WINDOWS = 32;
constexpr int COMB_ENTRIES = 256;
constexpr int ENTRY_WORDS = 15;  // y - x, y + x, 2d x y; 5 limbs each
constexpr int LANES = 64;  // lanes (threads) a block

// p + q for q affine in the Niels form (y - x, y + x, 2d x y):
// madd-2008-hwcd-3 in the order of ops/ed25519.py::add_affine.
HD ge ge_madd(const ge& p, const fe& ymx, const fe& ypx, const fe& xy2d) {
  const fe a = mul<MUL_INLINE>(fe_sub(p.Y, p.X), ymx);
  const fe b = mul<MUL_INLINE>(fe_add(p.Y, p.X), ypx);
  const fe c = mul<MUL_INLINE>(p.T, xy2d);
  const fe d = fe_add(p.Z, p.Z);
  const fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
  return ge{mul<MUL_INLINE>(e, f), mul<MUL_INLINE>(g, h), mul<MUL_INLINE>(f, g),
            mul<MUL_INLINE>(e, h)};
}

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

// Lane `lane` of n: [S]B from its 32 digits at digits[j * n + lane]; writes
// X, Y, Z, T at o[i * n + lane].
HD void comb_lane(const u64* table, const int32_t* digits, float* ox, float* oy, float* oz,
                  float* ot, long long n, long long lane) {
  ge acc = ge_identity();
#pragma unroll 1
  for (int j = 0; j < COMB_WINDOWS; ++j) {
    const int digit = digits[j * n + lane] & (COMB_ENTRIES - 1);
    const u64* e = table + ((long long)j * COMB_ENTRIES + digit) * ENTRY_WORDS;
    acc = ge_madd(acc, load_fe(e), load_fe(e + 5), load_fe(e + 10));
  }
  fe_store(ox + lane, n, acc.X);
  fe_store(oy + lane, n, acc.Y);
  fe_store(oz + lane, n, acc.Z);
  fe_store(ot + lane, n, acc.T);
}

}  // namespace

#ifdef __CUDACC__

__global__ void __launch_bounds__(LANES)
comb25519_kernel(const u64* __restrict__ table, const int32_t* __restrict__ digits,
                 float* __restrict__ ox, float* __restrict__ oy, float* __restrict__ oz,
                 float* __restrict__ ot, int n) {
  const long long lane = (long long)blockIdx.x * LANES + threadIdx.x;
  if (lane >= n) return;
  comb_lane(table, digits, ox, oy, oz, ot, n, lane);
}

// Launches on `stream` of CUDA device `device` and returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int comb25519_launch(const void* table, const void* digits, void* ox, void* oy,
                                void* oz, void* ot, int n, int device, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + LANES - 1) / LANES;
  comb25519_kernel<<<blocks, LANES, 0, (cudaStream_t)stream>>>(
      (const u64*)table, (const int32_t*)digits, (float*)ox, (float*)oy, (float*)oz,
      (float*)ot, n);
  return (int)cudaGetLastError();
}

extern "C" const char* comb25519_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
