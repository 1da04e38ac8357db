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
// What bounds it on this card: integer multiplies.  Per lane it does 2,495
// field multiplications (63 for the table, 38 per window), each 25 64x64->128
// products, against ~10 MB of memory traffic at 8,192 lanes.
//
// What the design does about it, first version: one thread per signature,
// radix 2^51 with 5 uint64 limbs so every product is one native 64-bit
// multiply pair (a*b and __umul64hi) instead of the TPU layout's 32x8-bit f32
// limbs, which exist only because the TPU's vector unit has no integer
// multiply.  The table stays in per-thread local memory and is read with a
// direct index on |d|.  Warp-cooperative multiplies, shared-memory tables and
// fused decompression are later work.
//
// Layout at the C boundary (batch trailing, limbs leading, as in the JAX
// package): four (32, batch) float32 coordinates of -A, weakly reduced
// (|limb| <= 340, value in (-2^250, 2^255 + 2^13)); (64, batch) int32 digits
// stored as d + 8 with d in [-8, 7]; four (32, batch) float32 outputs holding
// canonical limbs in [0, 255].
//
// The field and point arithmetic (ed25519_field.cuh, shared with
// straus_msm.cu) is written __host__ __device__ so the same source can be
// compiled as plain C++ for a host-side check; only the kernel and the C entry
// points need nvcc.

#include "ed25519_field.cuh"

namespace {

// One lane of the scan.  Coordinates and digits are read at column `lane` of
// their (rows, batch) arrays.
HD void horner_lane(const float* ax, const float* ay, const float* az, const float* at,
                    const int32_t* digits, float* ox, float* oy, float* oz, float* ot,
                    long long batch, long long lane) {
  ge neg_a = {fe_load(ax + lane, batch), fe_load(ay + lane, batch),
              fe_load(az + lane, batch), fe_load(at + lane, batch)};
  ge table[TABLE];
  table[0] = ge_identity();
  table[1] = neg_a;
  for (int j = 2; j < TABLE; ++j) table[j] = ge_add(table[j - 1], neg_a);

  ge acc = ge_identity();
  for (int w = 0; w < WINDOWS; ++w) {
    const int d = digits[w * batch + lane] - 8;
    acc = ge_dbl(acc, false);
    acc = ge_dbl(acc, false);
    acc = ge_dbl(acc, false);
    acc = ge_dbl(acc, true);
    // A digit outside the d + 8 encoding's [0, 15] is not a valid input;
    // the clamp only keeps such a lane from reading outside the table.
    int idx = d < 0 ? -d : d;
    idx = idx > TABLE - 1 ? TABLE - 1 : idx;
    ge q = table[idx];
    if (d < 0) {
      q.X = fe_neg(q.X);
      q.T = fe_neg(q.T);
    }
    acc = ge_add(acc, q);
  }
  fe_store(ox + lane, batch, acc.X);
  fe_store(oy + lane, batch, acc.Y);
  fe_store(oz + lane, batch, acc.Z);
  fe_store(ot + lane, batch, acc.T);
}

}  // namespace

#ifdef __CUDACC__

constexpr int THREADS = 64;

__global__ void __launch_bounds__(THREADS)
horner_scan_kernel(const float* __restrict__ ax, const float* __restrict__ ay,
                   const float* __restrict__ az, const float* __restrict__ at,
                   const int32_t* __restrict__ digits, float* __restrict__ ox,
                   float* __restrict__ oy, float* __restrict__ oz,
                   float* __restrict__ ot, int batch) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;  // the ragged edge
  horner_lane(ax, ay, az, at, digits, ox, oy, oz, ot, batch, lane);
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
  const int blocks = (batch + THREADS - 1) / THREADS;
  horner_scan_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)ax, (const float*)ay, (const float*)az, (const float*)at,
      (const int32_t*)digits, (float*)ox, (float*)oy, (float*)oz, (float*)ot, batch);
  return (int)cudaGetLastError();
}

extern "C" const char* horner_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // __CUDACC__
